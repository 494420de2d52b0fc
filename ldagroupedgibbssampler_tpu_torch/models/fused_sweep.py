"""Shared machinery of the samplers whose z-step is a document-sequential
sweep with immediate n_dk updates: the PCGS conditional (n_dk + alpha_k) *
phi[k][w] (UncollapsedParallelLDA.java:1509-1513; the PCGS family of
models/pcgs.py, spalias, polyaurn), its collapsed live-count mode
(models/adlda.py) and the LightLDA MH steps (models/lightlda.py).

The port's counterpart of `ldagroupedgibbssampler_tpu/models/fused_sweep.py`.
The sweep is the CUDA kernel of `ops/cuda_pcgs.py` or `ops/cuda_lightlda.py`
(the plain version on a CPU device) over sequential-safe blocks, the
resident layout (`corpus/ragged.py::build_cell_blocks_seq`) or the streamed
one (`build_stream_blocks`); z lives in that block layout. The JAX package's
XLA doc-sequential sweep is its off-TPU fallback; the port has no such
fallback: every configuration runs the kernel.

Mixed into a TorchLDASampler subclass before the base in the MRO. The
concrete class keeps `_step`; the mixin provides the layout choice, the
block preparation and recounts, and the sweep core.
"""

from __future__ import annotations

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
    build_stream_blocks, doc_visit_order, longest_first)
from ldagroupedgibbssampler_tpu_torch.ops.counts import (
    doc_topic_counts, topic_word_counts)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_lightlda import (
    fused_lightlda_sweep, fused_lightlda_sweep_streamed)
from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import (
    FLAG_ROWS, fused_pcgs_sweep, fused_pcgs_sweep_streamed, kpad_of)

# ---------------------------------------------------------------------------
# The layout rule, copied from the JAX package (ops/pallas_pcgs.py:403-489,
# models/fused_sweep.py:33-121). These are the TPU's VMEM estimates and
# budgets: here they only choose the layout (resident or streamed) and its
# vocabulary span and block, so that every configuration visits each
# document's tokens in the JAX package's order. They say nothing about the
# H100, whose kernel has no such limits.
# ---------------------------------------------------------------------------
_FUSED_PCGS_VMEM_BUDGET = 10 * 2 ** 20
_STREAMED_VMEM_BUDGET = 14 * 2 ** 20
# the sequential-safe layout requires dspan <= chunk (= 128)
_SEQ_DSPAN = 128
NBUF = 3
KTILE_MIN = 2048


def fused_pcgs_vmem_bytes(num_docs, num_topics, dspan, collapsed=False,
                          vspan=128):
    """The JAX package's residency estimate for the resident layout: the
    n_dk table (plus the collapsed mode's per-window operands) and a
    7 * kpad * 128 * 4 allowance for per-chunk temporaries."""
    kpad = kpad_of(num_topics)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)
    table = (kpad + FLAG_ROWS) * nwin_d * dspan * 4
    if collapsed:
        table += max(128, vspan) * kpad * 4 + kpad * 128 * 4
    return table + 7 * kpad * 128 * 4


def fused_pcgs_streamed_vmem_bytes(num_topics, vspan, dspan, block,
                                   collapsed=False, num_word_tables=1,
                                   u24=False):
    """The JAX package's scratch estimate for the streamed layout: window
    buffers of the word table and N_kw, the table slice, the per-block
    operands and the per-chunk temporaries (smaller in the K-tiled body
    at kpad >= KTILE_MIN)."""
    kpad = kpad_of(num_topics)
    tiled = kpad >= KTILE_MIN and num_word_tables == 1
    nbuf = 2 if tiled else NBUF
    if collapsed and num_word_tables == 1:
        ph_buf = 0
    else:
        ph_buf = nbuf * kpad * vspan * 2 * num_word_tables
    tb_buf = (kpad + FLAG_ROWS) * dspan * 4
    nkw_buf = nbuf * vspan * kpad * 4
    nkc = kpad * 128 * 4 if collapsed else 0
    blocks = (4 + (1 if u24 else 0)) * block * 4
    tril = 128 * 128 * 2
    if tiled:
        temps = kpad * 128 * 2 + 12 * 128 * 128 * 4
    else:
        temps = 7 * kpad * 128 * 4
    return tb_buf + ph_buf + nkw_buf + nkc + blocks + tril + temps


class FusedPCGSSweepMixin:
    """Layout choice + block layout + recounts + sweep core."""

    # True for schemes whose conditional is positive for every topic
    # (floored-Dirichlet phi, alpha > 0): the draw clamps to K - 1 instead
    # of the last nonzero topic. Must stay False for zero-support phi
    # (Polya-Urn).
    fused_positive_support = False
    # word tables the JAX package's streamed kernel buffers: 1 for the PCGS
    # sweep (phi), 2 for the LightLDA sweep (target + proposal). As in the
    # JAX package, 2 narrows the streamed vspan and lifts the K-tiled
    # block cap
    _streamed_word_tables = 1
    # True for the collapsed (ADLDA) conditional: as in the JAX package,
    # the gate then counts the live-count operands instead of a phi stream
    _streamed_collapsed = False
    # Oracle checks only: launch the sweep as one block of one warp, the
    # sequential chain (the plain versions are sequential already)
    _serial_sweep = False

    # -- layout choice (the JAX package's gate) ---------------------------
    def _kpad(self) -> int:
        return kpad_of(self.config.topics)

    def _streamed_block(self) -> int:
        """Token block of the streamed layout: capped at 1024 where the
        JAX package's K-tiled body engages (kpad >= KTILE_MIN, one word
        table: the MH kernel is untiled at every K)."""
        blk = self.config.token_block
        tiled = self._kpad() >= KTILE_MIN and self._streamed_word_tables == 1
        return min(blk, 1024) if tiled else blk

    def _streamed_vspan(self) -> int:
        """Largest vspan (the config's, halved down to 128) whose streamed
        scratch fits the JAX package's budget; 0 if even 128 does not."""
        vspan = max(128, self.config.vocab_span)
        while vspan >= 128:
            need = fused_pcgs_streamed_vmem_bytes(
                self.config.topics, vspan, _SEQ_DSPAN,
                self._streamed_block(),
                collapsed=self._streamed_collapsed,
                num_word_tables=self._streamed_word_tables)
            if need <= _STREAMED_VMEM_BUDGET:
                return vspan
            if vspan == 128:
                return 0
            vspan = max(128, vspan // 2)
        return 0

    def _fused_mode(self) -> str:
        """"resident" | "streamed". Where the JAX package falls back to its
        XLA sweep (no streamed vspan fits: kpad beyond ~4096 for the PCGS
        sweep, ~2000 for the MH sweep), the port takes the streamed layout
        at vspan 128."""
        fits = fused_pcgs_vmem_bytes(self.corpus.num_docs,
                                     self.config.topics, _SEQ_DSPAN,
                                     collapsed=self._streamed_collapsed,
                                     vspan=self.config.vocab_span) \
            <= _FUSED_PCGS_VMEM_BUDGET
        return "resident" if fits else "streamed"

    # -- device data -------------------------------------------------------
    def _prepare_device_data(self, corpus):
        cfg = self.config
        mode = self._fused_mode()
        if mode == "resident":
            b = corpus.cell_blocks_seq(block=cfg.token_block,
                                       vspan=cfg.vocab_span,
                                       dspan=_SEQ_DSPAN)
            d_local, vspan = b.d_local_a, cfg.vocab_span
            win_of_chunk = np.repeat(b.win_w, b.w_local.shape[1] // b.chunk)
        else:
            vspan = self._streamed_vspan() or 128
            b = build_stream_blocks(
                corpus.tokens, corpus.token_doc_ids(), corpus.num_types,
                corpus.num_docs, block=self._streamed_block(), vspan=vspan,
                dspan=_SEQ_DSPAN)
            d_local, win_of_chunk = b.d_local, b.win_w_chunks
        self._mode, self._vspan, self._sblocks = mode, vspan, b
        nb = b.w_local.shape[0]
        self._sshape3 = (nb, b.w_local.shape[1] // b.chunk, b.chunk)
        offsets, slots = doc_visit_order(d_local, b.win_d_chunks,
                                         dspan=_SEQ_DSPAN, chunk=b.chunk,
                                         num_docs=corpus.num_docs)

        def dev(a):
            return torch.as_tensor(a, device=self.device)

        self.swb = dev(b.w_local.reshape(self._sshape3))
        self.sdla = dev(d_local.reshape(self._sshape3))
        if mode == "resident":
            self.swinb, self.sfirstb = dev(b.win_w), dev(b.first_w)
        else:
            self.swwc = dev(b.win_w_chunks)
        self.swindc = dev(b.win_d_chunks)
        self.doc_slot_offsets, self.doc_slots = dev(offsets), dev(slots)
        self.doc_order = dev(longest_first(offsets))
        # global type and doc of every slot, for the recounts
        mask = b.mask.reshape(self._sshape3)
        w_glob = (win_of_chunk.astype(np.int64)[:, None] * vspan
                  + b.w_local.reshape(-1, b.chunk))
        d_glob = (b.win_d_chunks.astype(np.int64)[:, None] * _SEQ_DSPAN
                  + d_local.reshape(-1, b.chunk))
        self._slot_mask = dev(mask)
        self._slot_w = dev(np.where(mask, w_glob.reshape(self._sshape3), 0))
        self._slot_d = dev(np.where(mask, d_glob.reshape(self._sshape3), 0))
        self._flat_index = b.flat_index.reshape(-1)

    def _count_nkw(self, z):
        return topic_word_counts(z, self._slot_w, self._slot_mask,
                                 self.config.topics, self.corpus.num_types)

    def _count_ndk(self, z):
        return doc_topic_counts(z, self._slot_d, self._slot_mask,
                                self.corpus.num_docs, self.config.topics)

    # -- sweep core --------------------------------------------------------
    def _ndk_table(self, ndk, alpha, doc_mask):
        """(n_dk + alpha).T padded to [kpad + FLAG_ROWS, Dpad]; row kpad
        carries the random-scan doc-selection flag."""
        kpad = self._kpad()
        dpad = self._sblocks.nwin_d * _SEQ_DSPAN
        d = self.corpus.num_docs
        table = torch.zeros((kpad + FLAG_ROWS, dpad), dtype=torch.float32,
                            device=self.device)
        table[: self.config.topics, :d] = (ndk.to(torch.float32)
                                           + alpha[None, :]).T
        table[kpad, :d] = 1.0 if doc_mask is None else doc_mask.to(
            torch.float32)
        return table

    def _fused_extract(self, nkw_vk, table_out, alpha):
        """Kernel outputs -> (ndk int32 [D, K], nkw int32 [K, V])."""
        nkw = nkw_vk[: self.corpus.num_types].T.contiguous()
        ndk = torch.round(
            table_out[: self.config.topics, : self.corpus.num_docs].T
            - alpha[None, :]).to(torch.int32)
        return ndk, nkw

    def _sweep_call(self, z_blocks, table, word_vk, seed, u24=None,
                    proposal_vk=None, nk_plus=None, beta=None):
        """The sweep wrapper of this model's layout with its positional
        operands and keywords: `fn(*args, **kw)` runs one sweep. With a
        `proposal_vk` it is the LightLDA MH sweep (`word_vk` its target
        table), else the PCGS sweep, collapsed with `nk_plus` and
        `beta`."""
        b = self._sblocks
        kw = dict(nwin_w=b.nwin_w, nwin_d=b.nwin_d, vspan=self._vspan,
                  dspan=_SEQ_DSPAN, num_topics=self.config.topics)
        if proposal_vk is None:
            kw.update(nk_plus=nk_plus, beta=beta, serial=self._serial_sweep,
                      positive_support=self.fused_positive_support)
            if nk_plus is None:      # the collapsed mode walks index order
                kw.update(doc_order=self.doc_order)
            words = (word_vk,)
            resident, streamed = fused_pcgs_sweep, fused_pcgs_sweep_streamed
        else:
            kw.update(doc_order=self.doc_order)
            words = (word_vk, proposal_vk)
            resident, streamed = (fused_lightlda_sweep,
                                  fused_lightlda_sweep_streamed)
        if self._mode == "streamed":
            return (streamed,
                    (self.swb, self.sdla, z_blocks, table, *words, seed,
                     self.swwc, self.swindc, self.doc_slot_offsets,
                     self.doc_slots, u24), kw)
        return (resident,
                (self.swb, self.sdla, z_blocks, table, *words, seed,
                 self.swinb, self.sfirstb, self.swindc,
                 self.doc_slot_offsets, self.doc_slots, u24), kw)

    def _fused_zsweep(self, z_blocks, ndk, alpha, word_vk, doc_mask,
                      proposal_vk=None, nk_plus=None, beta=None):
        """One sweep. Returns (z_blocks', ndk' int32 [D, K], nkw' int32
        [K, V]): n_dk rides the kernel's table and N_kw is counted (or kept
        live) in the kernel, so no recount is needed. `word_vk` is phi as
        [V, K], with `proposal_vk` the MH sweep's word target (both
        [V, K]), or with `nk_plus` (f32 [K], V beta + n_k) and `beta` the
        sweep-entry N_kw.T counts of the collapsed conditional."""
        seed = torch.randint(0, 2 ** 62, (1,), generator=self.generator,
                             device=self.device, dtype=torch.int64)
        table = self._ndk_table(ndk, alpha, doc_mask)
        fn, args, kw = self._sweep_call(z_blocks, table, word_vk, seed,
                                        proposal_vk=proposal_vk,
                                        nk_plus=nk_plus, beta=beta)
        z, nkw_vk, table_out = fn(*args, **kw)
        ndk_out, nkw = self._fused_extract(nkw_vk, table_out, alpha)
        return z, ndk_out, nkw
