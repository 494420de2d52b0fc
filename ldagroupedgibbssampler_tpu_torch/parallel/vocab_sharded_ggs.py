"""Sharded GGS by vocabulary window (scheme `vocab_sharded_ggs`).

The port's counterpart of `ldagroupedgibbssampler_tpu/parallel/
vocab_sharded_ggs.py`. Types are relabelled so that each w-window carries
about the same token mass (`interleave_permutation`), and each rank owns a
contiguous range of w-windows balanced by tokens (`partition_windows`),
and with it

  - the tokens of those types, in the single-device GGS cell blocks of
    its windows (window-local type ids, global document ids);
  - its rows of phi and N_kw, the z-draw kernel's natural layout.

Per iteration, on every rank:

  1. theta ~ Dir(n_dk + alpha) for every document, drawn identically on
     every rank (shared generator) from the merged n_dk;
  2. the z-draw kernel (`ops/cuda_zdraw.py`, csrc/zdraw.cu) on the rank's
     windows with its phi rows draws its tokens' z and counts its rows of
     N_kw, which are placed at their types' rows and all-reduced;
  3. the count kernel (`ops/cuda_counts.py`, csrc/label_counts.cu) on the
     rank's d-window-major layout gives its n_dk partial (a document's
     tokens span ranks), and the partials are all-reduced;
  4. phi ~ Dir(beta + n_k) from the merged N_kw, identically on every
     rank.

The n_dk all-reduce runs in int16's bytes (half of int32's) on NCCL when
every document is shorter than 2^15, as the JAX package decides; the
int16 counts travel in pairs as int32 words (`parallel/mesh.py::
psum_counts`), since neither backend has an int16 all-reduce. Over gloo it
runs in int32. The counts are bit-equal either way.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.corpus.ragged import (
    CellBlocks, Corpus, build_cell_blocks)
from ldagroupedgibbssampler_tpu_torch.models.base import TorchLDASampler
from ldagroupedgibbssampler_tpu_torch.models.ggs import (
    LDAGroupedGibbsSampler)
from ldagroupedgibbssampler_tpu_torch.parallel.mesh import (
    count_reduce_dtype, psum_counts)
from ldagroupedgibbssampler_tpu_torch.parallel.sharded import ShardedMixin

_CHUNK = 128
_SUMMARY_SLICE = 1 << 26     # tokens a pass of vocab_shard_summary's count


def interleave_permutation(type_counts: np.ndarray, vspan: int):
    """Frequency-interleaved type relabeling: perm[old_id] = new_id.

    Types sorted by descending frequency are dealt round-robin across the
    w-windows, so each window holds every nwin-th rank of the Zipf curve
    and carries ~equal token mass. Without this, contiguous-id windows
    concentrate the Zipf head in window 0 and no contiguous-window shard
    partition can balance (measured 4.1x max/mean imbalance on a
    PubMed-stats corpus, benchmarks/pubmed_rehearsal.py). The model works
    in permuted space internally; phi/N_kw are permuted at the step
    boundary so external state keeps original type ids."""
    v = len(type_counts)
    nwin = max(1, -(-v // vspan))
    caps = np.full(nwin, vspan, np.int64)
    caps[-1] = v - (nwin - 1) * vspan
    order = np.argsort(-np.asarray(type_counts), kind="stable")
    perm = np.empty(v, np.int64)
    fill = np.zeros(nwin, np.int64)
    w = 0
    for i in range(v):
        while fill[w] >= caps[w]:
            w = (w + 1) % nwin
        perm[order[i]] = w * vspan + fill[w]
        fill[w] += 1
        w = (w + 1) % nwin
    inv = np.empty(v, np.int64)
    inv[perm] = np.arange(v)
    return perm.astype(np.int32), inv.astype(np.int32)


def partition_windows(type_counts: np.ndarray, vspan: int, num_shards: int):
    """Contiguous w-window ranges with balanced token counts.

    Returns window bounds [S+1] (each shard gets >= 1 window)."""
    nwin = max(1, -(-len(type_counts) // vspan))
    if num_shards > nwin:
        raise ValueError(
            f"{num_shards} shards need >= {num_shards} vocab windows; "
            f"V={len(type_counts)} vspan={vspan} gives {nwin}")
    per_win = np.zeros(nwin, np.int64)
    np.add.at(per_win, np.arange(len(type_counts)) // vspan, type_counts)
    cum = np.concatenate([[0], np.cumsum(per_win)])
    bounds = [0]
    for s in range(1, num_shards):
        t = cum[-1] * s / num_shards
        b = int(np.searchsorted(cum, t))
        bounds.append(min(max(b, bounds[-1] + 1), nwin - (num_shards - s)))
    bounds.append(nwin)
    return np.asarray(bounds)


@dataclasses.dataclass
class VocabShardSummary:
    """The whole vocabulary-sharded partition of a corpus, for every rank:
    the JAX model's shard bookkeeping (`shard_token_counts`,
    `shard_pad_slots`) beside the type permutation and the window bounds
    that every rank's layout starts from."""
    perm: np.ndarray         # int32 [V] original type -> permuted id
    inv: np.ndarray          # int32 [V] permuted id -> original type
    win_bounds: np.ndarray   # [S+1] w-window bounds of the ranks
    shard_token_counts: list   # tokens of each rank
    shard_pad_slots: list      # layout-A slots of each rank (w_local.size)


def vocab_shard_summary(corpus: Corpus, *, block: int, vspan: int,
                        dspan: int, num_ranks: int,
                        chunk: int = _CHUNK) -> VocabShardSummary:
    """The partition of `corpus` over `num_ranks` ranks, computed once on
    the host with no process group: each rank's token count, and the slot
    count of the cell blocks `build_cell_blocks` would give it (each
    (w-window, d-window) cell padded to whole chunks, each window's chunks
    to whole blocks, one chunk block for an empty window, and one
    all-padding tail block), without building them."""
    tf = corpus.type_frequencies()
    perm, inv = interleave_permutation(tf, vspan)
    wb = partition_windows(tf[inv], vspan, num_ranks)
    nwin_w = max(1, -(-len(tf) // vspan))
    nwin_d = max(1, -(-corpus.num_docs // dspan))
    # tokens of each (w-window, d-window) cell, a slice of tokens at a time
    cells = np.zeros(nwin_w * nwin_d, np.int64)
    docs = corpus.token_doc_ids()
    for a in range(0, corpus.num_tokens, _SUMMARY_SLICE):
        sl = slice(a, a + _SUMMARY_SLICE)
        cells += np.bincount(
            (perm[corpus.tokens[sl]] // vspan).astype(np.int64) * nwin_d
            + docs[sl] // dspan, minlength=nwin_w * nwin_d)
    bpc = block // chunk
    win_real = (-(-cells // chunk)).reshape(nwin_w, nwin_d).sum(axis=1)
    win_rows = np.where(win_real == 0, bpc, -(-win_real // bpc) * bpc)
    shard_tokens = np.add.reduceat(tf[inv], wb[:-1] * vspan)
    return VocabShardSummary(
        perm=perm, inv=inv, win_bounds=wb,
        shard_token_counts=[int(t) for t in shard_tokens],
        shard_pad_slots=[int(win_rows[wb[s]: wb[s + 1]].sum() + bpc) * chunk
                         for s in range(num_ranks)])


@dataclasses.dataclass
class VocabRankLayout:
    """One rank's part of the vocabulary-sharded layout."""
    blocks: CellBlocks       # its windows' cell blocks; flat_index global
    inv: np.ndarray          # int32 [V] permuted id -> original type
    row0: int                # first permuted row of its windows


def vocab_rank_layout(corpus: Corpus, *, block: int, vspan: int, dspan: int,
                      num_ranks: int, rank: int,
                      summary: VocabShardSummary | None = None
                      ) -> VocabRankLayout:
    """Rank `rank`'s cell blocks of a `num_ranks`-rank vocabulary-sharded
    layout: the JAX package's per-shard arrays of shard `rank`
    (`VocabShardedGGS._prepare_device_data`) without the padding to the
    largest shard's block count, and with the flat index in corpus token
    order. `summary`, the corpus's `vocab_shard_summary` at these spans,
    saves computing the permutation again."""
    if summary is None:
        summary = vocab_shard_summary(corpus, block=block, vspan=vspan,
                                      dspan=dspan, num_ranks=num_ranks)
    wb = summary.win_bounds
    ptokens = summary.perm[corpus.tokens]
    ww = ptokens // vspan
    idx = np.nonzero((ww >= wb[rank]) & (ww < wb[rank + 1]))[0]
    nwin = int(wb[rank + 1] - wb[rank])
    b = build_cell_blocks(
        ptokens[idx] - wb[rank] * vspan, corpus.token_doc_ids()[idx],
        num_types=nwin * vspan, num_docs=corpus.num_docs, block=block,
        vspan=vspan, dspan=dspan, chunk=_CHUNK)
    fi = b.flat_index.copy()
    valid = fi >= 0
    fi[valid] = idx[fi[valid]]            # rank-local -> corpus order
    return VocabRankLayout(blocks=dataclasses.replace(b, flat_index=fi),
                           inv=summary.inv, row0=int(wb[rank] * vspan))


class VocabShardedGGS(ShardedMixin, LDAGroupedGibbsSampler):
    """GGS sharded by vocabulary window over `mesh` (the z-draw and count
    kernels per rank). State is the single-device GGS's: nkw / phi
    [V, K] and ndk / theta [D, K], all replicated; z lives in the rank's
    cell blocks."""

    _replicated_theta = True
    # the JAX scheme writes the single-device GGS orientation, [V, K]
    _file_nkw_layout = "vk"

    def add_instances(self, corpus: Corpus):
        self.full_corpus = corpus
        return super().add_instances(corpus)

    def _prepare_device_data(self, corpus: Corpus):
        cfg = self.config
        spans = dict(block=cfg.token_block, vspan=cfg.vocab_span,
                     dspan=cfg.doc_span, num_ranks=self.mesh.size)
        summary = vocab_shard_summary(corpus, **spans)
        # the JAX model's shard bookkeeping, the same on every rank
        self.shard_token_counts = summary.shard_token_counts
        self.shard_pad_slots = summary.shard_pad_slots
        lay = vocab_rank_layout(corpus, **spans, rank=self.mesh.rank,
                                summary=summary)
        self._upload_blocks(lay.blocks)
        # the original type of each of its rows that is a type (the last
        # window of the permuted space may end before its span)
        rows = lay.blocks.nwin_w * cfg.vocab_span
        n = min(rows, corpus.num_types - lay.row0)
        self._rows = rows
        self._own_types = torch.as_tensor(
            lay.inv[lay.row0: lay.row0 + n].astype(np.int64),
            device=self.device)
        # the n_dk partials and their sums are bounded by the document
        # lengths: in int16 over NCCL when those fit
        self._ndk_bound = int(np.max(corpus.doc_lengths(), initial=0))
        # the JAX model's int16 decision (every document below 2^15); the
        # dtype on the wire is count_reduce_dtype's, int32 over gloo
        self._ndk_i16 = self._ndk_bound < 2 ** 15
        self._ndk_dtype = count_reduce_dtype(self.mesh, self._ndk_bound)

    def _zdraw_phi(self, phi_vk):
        out = torch.zeros((self._rows, phi_vk.shape[1]), dtype=phi_vk.dtype,
                          device=phi_vk.device)
        out[: self._own_types.numel()] = phi_vk.index_select(
            0, self._own_types)
        return out

    def _type_rows(self, nkw_rows):
        out = torch.zeros((self.corpus.num_types, nkw_rows.shape[1]),
                          dtype=nkw_rows.dtype, device=nkw_rows.device)
        out.index_copy_(0, self._own_types,
                        nkw_rows[: self._own_types.numel()])
        return out

    def _merge_ndk(self, ndk):
        return psum_counts(ndk, self.mesh, self._ndk_bound)

    def _local_z(self):
        valid = self._flat_index >= 0
        return (self._flat_index[valid],
                self.state.z.cpu().numpy().reshape(-1)[valid])

    def _replicated(self) -> dict:
        st = self.state
        return {**super()._replicated(), "theta": st.theta, "ndk": st.ndk}

    # fold-in: every rank folds in the whole corpus alike (the shared
    # generator, cell blocks of the whole corpus), then keeps its windows'
    # tokens and merges the counts
    def _fold_in_part(self):
        return self.corpus, self.shared_generator, None

    def _adopt_fold_in(self, res):
        TorchLDASampler._adopt_fold_in(self, res)
