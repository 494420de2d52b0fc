"""GGS — the Grouped Gibbs Sampler (scheme `ggs`), on PyTorch + CUDA.

Reference: topics/LDAGroupedGibbsSampler.java (210 LoC) on top of
UncollapsedParallelLDA. Per iteration:

  1. theta_d ~ Dir(n_d + alpha) for every document (:66-72);
  2. each token scores theta_d[k] * phi[k][w] (:96-101) and draws z by
     inverse-CDF (:107-113);
  3. phi_k ~ Dir(beta + n_k) per topic row (:182-209).

The port keeps the JAX package's two-layout design
(`ldagroupedgibbssampler_tpu/models/ggs.py`):

  - z stays flat over the layout-A cell-block slots (tokens sorted into
    (w-window, d-window) cells, `corpus/ragged.py::build_cell_blocks`);
  - the z-draw and N_kw come out of one CUDA kernel on layout A
    (`ops/cuda_zdraw.py`, csrc/zdraw.cu);
  - n_dk is rebuilt by a chunk-granular regroup `z.view(-1, chunk)
    [src_chunks]` into the d-window-major layout B, then the count kernel
    (`ops/cuda_counts.py`, csrc/label_counts.cu);
  - theta and phi are whole-matrix Marsaglia-Tsang Gamma draws
    (`ops/random.py`), plain PyTorch elementwise code on the device.

On a CPU device the same code runs the kernels' plain versions. State is
kept type-major: nkw and phi are [V, K] (`nkw_layout = "vk"`).
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.models.base import (LDAState,
                                                          TorchLDASampler)
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.cuda_counts import (
    blocked_label_counts)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_zdraw import fused_zdraw_nkw


class LDAGroupedGibbsSampler(TorchLDASampler):
    nkw_layout = "vk"

    # ------------------------------------------------------------------
    def _prepare_device_data(self, corpus):
        cfg = self.config
        blocks = corpus.cell_blocks(block=cfg.token_block,
                                    vspan=cfg.vocab_span, dspan=cfg.doc_span)
        self._blocks = blocks
        nb = blocks.w_local.shape[0]
        self._shape3 = (nb, blocks.w_local.shape[1] // blocks.chunk,
                        blocks.chunk)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        # layout A (w-window-major): the z-draw and the N_kw count
        self.wb = dev(blocks.w_local)          # sentinel vspan on pads
        self.dla = dev(blocks.d_local_a)       # sentinel dspan on pads
        self.mf = dev(blocks.mask.reshape(-1))
        self.winb = dev(blocks.win_w)
        self.firstb = dev(blocks.first_w)
        self.windc = dev(blocks.win_d_chunks)
        # layout B (d-window-major): the n_dk count after the regroup
        self.srcb = dev(blocks.src_chunks.astype(np.int64))
        self.dlb = dev(blocks.d_local)         # sentinel dspan on pads
        self.windb = dev(blocks.win_d)
        self.firstdb = dev(blocks.first_d)

    def _count_nkw(self, z):
        nkw = blocked_label_counts(
            self.wb, z.view(self.wb.shape), self.winb, self.firstb,
            nwin=self._blocks.nwin_w, vspan=self.config.vocab_span,
            num_labels=self.config.topics)
        return nkw[: self.corpus.num_types]

    def _count_ndk(self, z):
        # regroup z d-window-major with one chunk-granular row gather, then
        # the same count kernel produces n_dk — no scatter by doc id
        z_b = z.view(-1, self._blocks.chunk)[self.srcb].view(self.dlb.shape)
        ndk = blocked_label_counts(
            self.dlb, z_b, self.windb, self.firstdb,
            nwin=self._blocks.nwin_d, vspan=self.config.doc_span,
            num_labels=self.config.topics)
        return ndk[: self.corpus.num_docs]

    def _init_state(self) -> LDAState:
        cfg = self.config
        z = torch.randint(0, cfg.topics, self.mf.shape,
                          generator=self.generator, device=self.device,
                          dtype=torch.int32)
        z = torch.where(self.mf, z, 0)
        nkw = self._count_nkw(z)
        ndk = self._count_ndk(z)
        alpha = torch.full((cfg.topics,), cfg.alpha, dtype=torch.float32,
                           device=self.device)
        beta = float(cfg.beta)
        phi = self._sample_phi(nkw, beta)
        theta = rnd.dirichlet(ndk.to(torch.float32) + alpha, self.generator)
        return LDAState(z=z, ndk=ndk, nkw=nkw,
                        nk=nkw.sum(dim=0, dtype=torch.int32), phi=phi,
                        theta=theta, alpha=alpha, beta=beta, iteration=0)

    # ------------------------------------------------------------------
    def _sample_phi(self, nkw_vk, beta):
        """phi in [V, K] orientation: Gamma draw + column normalisation."""
        g = rnd.gamma(nkw_vk.to(torch.float32) + beta, self.generator)
        g = g.clamp_min(rnd.DIRICHLET_FLOOR)
        return g / g.sum(dim=0, keepdim=True)

    def _theta_update(self, state, doc_mask):
        theta_new = rnd.dirichlet(state.ndk.to(torch.float32) + state.alpha,
                                  self.generator)
        if doc_mask is None:       # full sweep: no per-doc select needed
            return theta_new
        return torch.where(doc_mask[:, None], theta_new, state.theta)

    def _step(self, state: LDAState, doc_mask):
        """One GGS iteration, replacing the fields of `state` in place."""
        cfg = self.config
        blocks = self._blocks
        # (1) theta draws — unselected docs keep their previous row.
        theta = self._theta_update(state, doc_mask)
        # (2)+(3a) z-draw + N_kw in one kernel. Doc selection = zeroed theta
        # rows (those tokens keep z and still count).
        theta_m = (theta if doc_mask is None
                   else torch.where(doc_mask[:, None], theta, 0.0))
        seed = torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                             device=self.device, dtype=torch.int64)
        z3, nkw = fused_zdraw_nkw(
            self.wb.view(self._shape3), self.dla.view(self._shape3),
            state.z.view(self._shape3), theta_m, state.phi, seed,
            self.winb, self.firstb, self.windc,
            nwin_w=blocks.nwin_w, nwin_d=blocks.nwin_d,
            vspan=cfg.vocab_span, dspan=blocks.dspan,
            num_topics=cfg.topics, precise=cfg.zdraw_precise)
        z = z3.view(-1)
        nkw = nkw[: self.corpus.num_types]
        # (3b) n_dk rebuild on the d-window-major layout.
        ndk = self._count_ndk(z)
        # (4) phi draws.
        phi = self._sample_phi(nkw, state.beta)
        state.z, state.ndk, state.nkw, state.phi, state.theta = (
            z, ndk, nkw, phi, theta)
        state.nk = nkw.sum(dim=0, dtype=torch.int32)
        state.iteration += 1

    # ------------------------------------------------------------------
    # layout-aware accessors
    # ------------------------------------------------------------------
    def set_phi(self, phi, vocab=None, labels=None):
        """setPhi with alphabet verification; `phi` is [K, V]."""
        if vocab is not None and list(vocab) != list(self.corpus.vocab):
            raise ValueError("vocabulary mismatch in set_phi")
        phi = torch.as_tensor(np.asarray(phi, np.float32), device=self.device)
        if phi.shape != self.state.phi.T.shape:
            raise ValueError(f"phi must be [K, V] = "
                             f"{tuple(self.state.phi.T.shape)}")
        self.state.phi = phi.T.contiguous()

    def get_z_indicators(self) -> np.ndarray:
        z = self.state.z.cpu().numpy().reshape(-1)
        idx = self._blocks.flat_index.reshape(-1)
        out = np.zeros(self.corpus.num_tokens, np.int32)
        valid = idx >= 0
        out[idx[valid]] = z[valid]
        return out

    def _z_from_flat(self, z_flat: np.ndarray) -> np.ndarray:
        z_flat = np.asarray(z_flat, np.int32)
        if z_flat.shape != (self.corpus.num_tokens,):
            raise ValueError(f"z must hold one topic per token "
                             f"({self.corpus.num_tokens}), got "
                             f"{z_flat.shape}")
        z = np.zeros(self._blocks.flat_index.shape, np.int32)
        valid = self._blocks.flat_index >= 0
        z[valid] = z_flat[self._blocks.flat_index[valid]]
        return z.reshape(-1)  # GGS keeps z flat over block slots

    def set_z_indicators(self, z_flat):
        """Rebuild counts from imported z and resample phi
        (setZIndicators, UncollapsedParallelLDA.java:1797-1843)."""
        st = self.state
        z = torch.as_tensor(self._z_from_flat(z_flat), device=self.device)
        nkw = self._count_nkw(z)
        st.z, st.nkw, st.ndk = z, nkw, self._count_ndk(z)
        st.nk = nkw.sum(dim=0, dtype=torch.int32)
        st.phi = self._sample_phi(nkw, st.beta)


class LDAGroupedGibbsSamplerTest(LDAGroupedGibbsSampler):
    """Deliberately *invalid* GGS variant kept for experiment parity.

    Reference: topics/LDAGroupedGibbsSamplerTest.java ("This is not a valid
    sampler", :2) — same structure as GGS but theta is NOT redrawn each
    iteration (token draws use the previous iteration's theta), breaking
    detailed balance exactly as the reference variant does.
    """

    def _theta_update(self, state, doc_mask):
        return state.theta
