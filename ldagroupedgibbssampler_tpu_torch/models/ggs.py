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
  - theta and phi are whole-matrix Marsaglia-Tsang Dirichlet draws
    (`ops/random.py`): on the card one launch of the Dirichlet kernel for
    theta and two for phi (`ops/cuda_gamma.py`, csrc/gamma.cu).

On a CPU device the same code runs the kernels' plain versions. State is
kept type-major: nkw and phi are [V, K] (`nkw_layout = "vk"`).

`sample_chunked(iterations, chunk)` runs full sweeps as replays of one
CUDA graph of `chunk` steps, captured once per (model, chunk) and kept
across calls (`_multi_step_fn`, `models/fusion.py`), as the JAX GGS runs
one compiled scan (`bench.py` times it).
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import real_slot_list
from ldagroupedgibbssampler_tpu_torch.models.base import (LDAState,
                                                          TorchLDASampler)
from ldagroupedgibbssampler_tpu_torch.models.fusion import FusedSteps
from ldagroupedgibbssampler_tpu_torch.ops import random as rnd
from ldagroupedgibbssampler_tpu_torch.ops.cuda_counts import (
    blocked_label_counts)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_zdraw import fused_zdraw_nkw


class LDAGroupedGibbsSampler(TorchLDASampler):
    nkw_layout = "vk"
    # the z-draw kernel draws z and N_kw; a subclass that draws z another
    # way sets this False and uploads none of the z-draw's own arrays
    _use_fused_zdraw = True
    # theta is drawn with the chain's own generator; a sharded scheme that
    # replicates theta on every rank draws it with the shared one
    _replicated_theta = False
    # the kept full sweeps of _multi_step_fn, made at its first call
    chunked_steps = None

    # ------------------------------------------------------------------
    def _prepare_device_data(self, corpus):
        cfg = self.config
        self._upload_blocks(corpus.cell_blocks(
            block=cfg.token_block, vspan=cfg.vocab_span, dspan=cfg.doc_span))

    def _upload_blocks(self, blocks):
        """The cell blocks on the device; z lives on their layout A."""
        # a kept graph reads the arrays it was captured with
        self.release_chunked()
        self._blocks = blocks
        nb = blocks.w_local.shape[0]
        self._shape3 = (nb, blocks.w_local.shape[1] // blocks.chunk,
                        blocks.chunk)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        # layout A (w-window-major): the z-draw and the N_kw count
        self.wb = dev(blocks.w_local)          # sentinel vspan on pads
        self.mf = dev(blocks.mask.reshape(-1))
        # z stays flat over the layout-A slots
        self._slot_mask = self.mf
        self._flat_index = blocks.flat_index.reshape(-1)
        self.winb = dev(blocks.win_w)
        self.firstb = dev(blocks.first_w)
        if self._use_fused_zdraw:
            self.dla = dev(blocks.d_local_a)   # sentinel dspan on pads
            # the z-draw kernel walks the real slots only
            self._real_slots = dev(real_slot_list(blocks.mask))
            self.windc = dev(blocks.win_d_chunks)
        # layout B (d-window-major): the n_dk count after the regroup
        self.srcb = dev(blocks.src_chunks.astype(np.int64))
        self.dlb = dev(blocks.d_local)         # sentinel dspan on pads
        self.windb = dev(blocks.win_d)
        self.firstdb = dev(blocks.first_d)

    def _count_nkw(self, z):
        return self._type_rows(blocked_label_counts(
            self.wb, z.view(self.wb.shape), self.winb, self.firstb,
            nwin=self._blocks.nwin_w, vspan=self.config.vocab_span,
            num_labels=self.config.topics))

    def _type_rows(self, nkw_rows):
        """N_kw [V, K] of the corpus's types from a count over the
        layout's w-window rows."""
        return nkw_rows[: self.corpus.num_types]

    def _zdraw_phi(self, phi_vk):
        """The phi rows of the layout's w-windows, as the z-draw reads
        them."""
        return phi_vk

    def _count_ndk(self, z):
        # regroup z d-window-major with one chunk-granular row gather, then
        # the same count kernel produces n_dk — no scatter by doc id
        z_b = z.view(-1, self._blocks.chunk)[self.srcb].view(self.dlb.shape)
        ndk = blocked_label_counts(
            self.dlb, z_b, self.windb, self.firstdb,
            nwin=self._blocks.nwin_d, vspan=self.config.doc_span,
            num_labels=self.config.topics)
        return ndk[: self.corpus.num_docs]

    # ------------------------------------------------------------------
    def _sample_phi(self, nkw_vk, beta, type_mask=None, prev_phi_vk=None):
        """phi in [V, K] orientation: a Dirichlet draw normalised over V
        (axis 0); with a type mask, the conditional Dirichlet redraw of the
        masked types of every topic row."""
        if type_mask is None:
            return rnd.dirichlet(nkw_vk, self.shared_generator, dim=0,
                                 prior=beta)
        conc = nkw_vk.to(torch.float32) + beta
        return rnd.conditional_dirichlet(prev_phi_vk.T, conc.T, type_mask,
                                         self.shared_generator
                                         ).T.contiguous()

    def _initial_phi(self, nkw_vk, beta):
        return self._sample_phi(nkw_vk, beta)

    def _theta_generator(self) -> torch.Generator:
        return (self.shared_generator if self._replicated_theta
                else self.generator)

    def _initial_theta(self, ndk, alpha):
        return rnd.dirichlet(ndk, self._theta_generator(), prior=alpha)

    def _theta_update(self, state, doc_mask):
        theta_new = rnd.dirichlet(state.ndk, self._theta_generator(),
                                  prior=state.alpha)
        if doc_mask is None:       # full sweep: no per-doc select needed
            return theta_new
        return torch.where(doc_mask[:, None], theta_new, state.theta)

    def _step(self, state: LDAState, doc_mask, type_mask=None):
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
            state.z.view(self._shape3), theta_m, self._zdraw_phi(state.phi),
            seed,
            self.winb, self.firstb, self.windc,
            nwin_w=blocks.nwin_w, nwin_d=blocks.nwin_d,
            vspan=cfg.vocab_span, dspan=blocks.dspan,
            num_topics=cfg.topics, precise=cfg.zdraw_precise,
            real_slots=self._real_slots)
        z = z3.view(-1)
        nkw = self._merge_nkw(self._type_rows(nkw))
        # (3b) n_dk rebuild on the d-window-major layout.
        ndk = self._merge_ndk(self._count_ndk(z))
        # (4) phi draws.
        phi = self._sample_phi(nkw, state.beta, type_mask, state.phi)
        state.z, state.ndk, state.nkw, state.phi, state.theta = (
            z, ndk, nkw, phi, theta)
        state.nk = nkw.sum(dim=0, dtype=torch.int32)
        state.iteration += 1

    # ------------------------------------------------------------------
    # multi-iteration path (bench / large runs): full sweeps, no random
    # scan, hooks, listeners, logging, abort or deadline check
    # ------------------------------------------------------------------
    def _multi_step_fn(self, n: int):
        """A callable that advances the chain by n full sweeps of
        `_step(state, None, None)`: on the card one replay of a CUDA graph
        of the n steps, captured at its first call and kept with the
        model for every later callable of the same n
        (`chunked_steps.captures` counts the captures); on the CPU, and
        for a step that cannot be captured, the n steps one by one. The
        state's fields are read before every call, so a `sample()`,
        `set_z_indicators`, `set_phi` or `load_checkpoint` in between is
        honoured. The kept graphs hold the step's temporaries ([D, K] and
        [V, K] at least) in their memory pool until `release_chunked()`,
        a new layout, or the model goes."""
        if self.state is None:
            raise RuntimeError("call add_instances first")
        if self.chunked_steps is None:
            self.chunked_steps = FusedSteps(self)
        steps, sweeps = self.chunked_steps, [None] * int(n)
        return lambda: steps.run(sweeps)

    def sample_chunked(self, iterations: int, chunk: int = 10):
        """`iterations` rounded up to whole chunks (as the JAX GGS does:
        25 with chunk 10 runs 30), each chunk one call of
        `_multi_step_fn(chunk)`; ends with the device synchronised."""
        run = self._multi_step_fn(chunk)
        for _ in range(-(-int(iterations) // int(chunk))):
            run()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return self

    def release_chunked(self):
        """Drop the kept graphs of `_multi_step_fn` and their memory
        pools; the next call captures again."""
        if self.chunked_steps is not None:
            self.chunked_steps.close()
            self.chunked_steps = None

    # ------------------------------------------------------------------
    # fold-in on this sampler's own cell blocks: its z comes back in this
    # layout, with the z-draw's N_kw
    # ------------------------------------------------------------------
    def _fold_in_blocks(self):
        return self._blocks

    def _adopt_fold_in(self, res):
        st = self.state
        st.z, st.ndk, st.nkw = res.z, res.ndk, res.nkw_vk
        st.nk = res.nkw_vk.sum(dim=0, dtype=torch.int32)


class LDAGroupedGibbsSamplerTest(LDAGroupedGibbsSampler):
    """Deliberately *invalid* GGS variant kept for experiment parity.

    Reference: topics/LDAGroupedGibbsSamplerTest.java ("This is not a valid
    sampler", :2) — same structure as GGS but theta is NOT redrawn each
    iteration (token draws use the previous iteration's theta), breaking
    detailed balance exactly as the reference variant does.
    """

    def _theta_update(self, state, doc_mask):
        return state.theta
