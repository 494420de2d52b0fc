"""CGS, the serial collapsed Gibbs sampler (scheme `collapsed`): the
correctness oracle.

The port's counterpart of `ldagroupedgibbssampler_tpu/models/cgs.py`.
Reference: topics/SerialCollapsedLDA.java extending MALLET SimpleLDA: a
strictly sequential sweep over every token with the Griffiths & Steyvers
conditional (alpha_k + n_dk^-i)(beta + n_kw^-i)/(V beta + n_k^-i)
(ModifiedSimpleLDA.java:196-203), plus augmented phi ~ Dir(N + beta) and
theta ~ Dir(M + alpha) draws every iteration for diagnostics
(SerialCollapsedLDA.java:217-218, :276); the chain does not condition on
them.

The sweep is `ops/kernels.py::cgs_serial_sweep`, plain PyTorch, one
Python step per token on whatever device the sampler has. On the card that
is a per-token host loop: the oracle that `adlda` is measured against
(chip_smoke.py times it on a small slice), not a path to run a corpus
through. z is kept in canonical token order (`FlatLayoutMixin`).
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.models.base import (FlatLayoutMixin,
                                                          LDAState,
                                                          TorchLDASampler)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.kernels import cgs_serial_sweep


class SerialCollapsedLDA(FlatLayoutMixin, TorchLDASampler):
    nkw_layout = "kv"
    smooth_phi = True
    # the sweep walks the tokens from the host: under scan_chunk its
    # groups run single-stepped, where the JAX package scans them
    _capturable_step = False

    def _initial_theta(self, ndk, alpha):
        return rnd.dirichlet(ndk.to(torch.float32) + alpha, self.generator)

    def _step(self, state: LDAState, doc_mask, type_mask=None):
        """One iteration, replacing the fields of `state` in place.
        Random-scan selection masks unselected documents' tokens out of
        the sweep; the diagnostic phi draw ignores a type mask, as the
        JAX package's does."""
        sel = (self._slot_mask if doc_mask is None
               else self._slot_mask & doc_mask[self._slot_d])
        ndk, nkw, nk, z = cgs_serial_sweep(
            self._slot_w, self._slot_d, sel, state.z, state.ndk, state.nkw,
            state.nk, state.alpha, state.beta, generator=self.generator)
        state.z, state.ndk, state.nkw, state.nk = z, ndk, nkw, nk
        state.phi = rnd.dirichlet(nkw.to(torch.float32) + state.beta,
                                  self.generator)
        state.theta = rnd.dirichlet(ndk.to(torch.float32) + state.alpha,
                                    self.generator)
        state.iteration += 1
