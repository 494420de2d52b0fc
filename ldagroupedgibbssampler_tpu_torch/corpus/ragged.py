"""The on-device corpus representation.

Replaces MALLET `InstanceList`/`FeatureSequence`/`Alphabet` with flat NumPy
ragged arrays (SURVEY.md §7 step 1):

    tokens[N]        int32   token type ids, documents concatenated
    doc_offsets[D+1] int64   doc d spans tokens[doc_offsets[d]:doc_offsets[d+1]]
    vocab[V]         str     id -> surface form  (the data alphabet)
    labels[D], doc_ids[D]    per-document metadata (the target alphabet)

The GGS sampler consumes the two-layout cell blocks (`CellBlocks`): tokens
sorted into (w-window, d-window) cells, padded per `chunk`. The PCGS family
consumes the sequential-safe variants: `build_cell_blocks_seq` (w-window
major) and `build_stream_blocks_seq` (d-window major, `StreamBlocks`), in
which no chunk holds two tokens of one document. Host-side NumPy only; the
sampler copies the arrays to its device once.

This is the port's own copy of the JAX package's `corpus/ragged.py` (the
subset the ported schemes use): every builder here is bit-identical to that
package's. The JAX package adds native C++ builders above 1M tokens, whose
output is bit-identical too; the port has only the NumPy paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class CellBlocks:
    """Two-layout cell-sorted token blocks (see Corpus.cell_blocks).

    Tokens are sorted into (w-window, d-window) cells, each padded to a
    multiple of `chunk` slots. Layout A (storage) orders cells w-window-
    major: the fused z-draw and the N_kw count kernel run on it directly.
    Layout B orders the same padded cells d-window-major; it is never
    materialised for static data — only z is regrouped at runtime by one
    row gather of `chunk`-sized rows (`src_chunks`), after which the same
    count kernel produces n_dk. This removes the last scatter from the GGS
    hot path.
    """
    # layout A (w-window-major storage)
    w_local: np.ndarray    # [NBa, B] type id minus win_w*vspan; vspan = pad
    doc_ids: np.ndarray    # [NBa, B] global doc id (0 on pads)
    mask: np.ndarray       # [NBa, B] validity
    win_w: np.ndarray      # [NBa] w-window id (nondecreasing)
    first_w: np.ndarray    # [NBa] 1 on the first block of each w-window
    flat_index: np.ndarray  # [NBa, B] original corpus token index (-1 = pad)
    d_local_a: np.ndarray  # [NBa, B] doc id minus win_d*dspan; dspan = pad
    win_d_chunks: np.ndarray  # [NBa*B/chunk] d-window id of each A chunk
    # layout B (d-window-major view of the same padded cells)
    src_chunks: np.ndarray  # [NBb*B/chunk] row index into A viewed [-1,chunk]
    d_local: np.ndarray    # [NBb, B] doc id minus win_d*dspan; dspan = pad
    win_d: np.ndarray      # [NBb]
    first_d: np.ndarray    # [NBb]
    vspan: int
    dspan: int
    nwin_w: int
    nwin_d: int
    chunk: int


@dataclass
class Corpus:
    tokens: np.ndarray                 # int32 [N]
    doc_offsets: np.ndarray            # int64 [D+1]
    vocab: list[str]
    labels: list[str] = field(default_factory=list)
    doc_ids: list[str] = field(default_factory=list)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        self.doc_offsets = np.asarray(self.doc_offsets, np.int64)
        assert self.doc_offsets[0] == 0
        assert self.doc_offsets[-1] == len(self.tokens)

    # ---- sizes ---------------------------------------------------------
    @property
    def num_docs(self) -> int:
        return len(self.doc_offsets) - 1

    @property
    def num_types(self) -> int:
        return len(self.vocab)

    @property
    def num_tokens(self) -> int:
        return int(len(self.tokens))

    def doc_lengths(self) -> np.ndarray:
        return np.diff(self.doc_offsets).astype(np.int32)

    # ---- device layouts ------------------------------------------------
    def token_doc_ids(self) -> np.ndarray:
        """doc id of every token, int32 [N]."""
        return np.repeat(np.arange(self.num_docs, dtype=np.int32),
                         self.doc_lengths())

    def type_frequencies(self) -> np.ndarray:
        """Corpus frequency of each type."""
        return np.bincount(self.tokens, minlength=self.num_types
                           ).astype(np.int64)

    def cell_blocks(self, block: int = 4096, vspan: int = 512,
                    dspan: int = 512, chunk: int = 128) -> "CellBlocks":
        """Build the two-layout cell block structure (see CellBlocks)."""
        return build_cell_blocks(self.tokens, self.token_doc_ids(),
                                 self.num_types, self.num_docs,
                                 block=block, vspan=vspan, dspan=dspan,
                                 chunk=chunk)

    def cell_blocks_seq(self, block: int = 4096, vspan: int = 128,
                        dspan: int = 128, chunk: int = 128) -> "CellBlocks":
        """Sequential-safe cell blocks (see build_cell_blocks_seq): no two
        tokens of one document share a chunk — the resident layout of the
        PCGS sweep."""
        return build_cell_blocks_seq(self.tokens, self.token_doc_ids(),
                                     self.num_types, self.num_docs,
                                     block=block, vspan=vspan, dspan=dspan,
                                     chunk=chunk)

    @staticmethod
    def from_token_lists(doc_tokens: list[list[int]], vocab: list[str],
                         labels=None, doc_ids=None) -> "Corpus":
        lengths = [len(d) for d in doc_tokens]
        offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int64)
        flat = (np.concatenate([np.asarray(d, np.int32) for d in doc_tokens])
                if sum(lengths) else np.zeros(0, np.int32))
        return Corpus(tokens=flat, doc_offsets=offsets, vocab=list(vocab),
                      labels=list(labels or []), doc_ids=list(doc_ids or []))


def build_cell_blocks_reference(tokens, doc_ids_all, num_types, num_docs, *,
                                block: int = 4096, vspan: int = 512,
                                dspan: int = 512,
                                chunk: int = 128) -> "CellBlocks":
    """Loop-form cell block builder — the readable specification.

    `build_cell_blocks` below is the vectorised production implementation
    (same output bit-for-bit, ~20x faster at NYTimes scale); this form is
    kept as the equality oracle for the tests.
    """
    assert block % chunk == 0
    tokens = np.asarray(tokens, np.int32)
    d_all = np.asarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    nwin_w = max(1, (num_types + vspan - 1) // vspan)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)
    ww = tokens // vspan
    dw = d_all // dspan
    order = np.lexsort((dw, ww))           # w-window major, d-window minor
    w_s, d_s = tokens[order], d_all[order]
    ww_s, dw_s = ww[order], dw[order]

    # cells in A order; each padded to a multiple of `chunk`
    keys = ww_s.astype(np.int64) * nwin_d + dw_s
    cell_key, cell_start = np.unique(keys, return_index=True)
    cell_end = np.append(cell_start[1:], n)
    cell_pad = ((cell_end - cell_start + chunk - 1) // chunk) * chunk

    bpc = block // chunk                   # chunks per block
    # ---- layout A: windows padded to whole blocks, + 1 all-pad block
    win_chunks: list[list[int]] = [[] for _ in range(nwin_w)]
    cell_chunk0 = np.zeros(len(cell_key), np.int64)
    a_rows: list[tuple] = []               # (cell_idx, tok_s, tok_e) per chunk
    for ci in range(len(cell_key)):
        win = int(cell_key[ci] // nwin_d)
        cell_chunk0[ci] = len(a_rows)
        s, e = int(cell_start[ci]), int(cell_end[ci])
        for c0 in range(0, int(cell_pad[ci]), chunk):
            win_chunks[win].append(len(a_rows))
            a_rows.append((ci, s + c0, min(e, s + c0 + chunk)))
    # pad each window to a block multiple with all-pad chunks
    win_blocks: list[tuple] = []           # (win, [chunk rows])
    for win in range(nwin_w):
        rows = list(win_chunks[win])
        while len(rows) % bpc:
            rows.append(-1)                # -1 = all-pad chunk
        if not rows:
            rows = [-1] * bpc
        for b0 in range(0, len(rows), bpc):
            win_blocks.append((win, rows[b0: b0 + bpc]))
    # one extra all-pad block at the tail (guaranteed pad chunk source)
    win_blocks.append((nwin_w - 1, [-1] * bpc))

    nba = len(win_blocks)
    total_chunks = nba * bpc
    pad_chunk_row = total_chunks - 1       # any chunk of the tail block
    w_local = np.full((total_chunks, chunk), vspan, np.int32)
    doc_ids = np.zeros((total_chunks, chunk), np.int32)
    d_loc_a = np.full((total_chunks, chunk), dspan, np.int32)
    win_d_chunks = np.zeros(total_chunks, np.int32)
    mask = np.zeros((total_chunks, chunk), bool)
    flat_index = np.full((total_chunks, chunk), -1, np.int64)
    win_w_arr = np.zeros(nba, np.int32)
    first_w = np.zeros(nba, np.int32)
    row_of = np.full(len(a_rows), -1, np.int64)   # a_rows idx -> chunk row
    prev = -1
    r = 0
    for bi, (win, rows) in enumerate(win_blocks):
        win_w_arr[bi] = win
        if win != prev:
            first_w[bi] = 1
            prev = win
        for cr in rows:
            if cr >= 0:
                ci, s, e = a_rows[cr]
                m = e - s
                win_d_chunks[r] = int(cell_key[ci] % nwin_d)
                if m > 0:
                    w_local[r, :m] = w_s[s:e] - win * vspan
                    doc_ids[r, :m] = d_s[s:e]
                    d_loc_a[r, :m] = d_s[s:e] - int(
                        cell_key[ci] % nwin_d) * dspan
                    mask[r, :m] = True
                    flat_index[r, :m] = order[s:e]
                row_of[cr] = r
            r += 1

    # ---- layout B: same chunks regrouped d-window-major
    dwin_chunks: list[list[int]] = [[] for _ in range(nwin_d)]
    for ci in range(len(cell_key)):
        dwi = int(cell_key[ci] % nwin_d)
        for k in range(int(cell_pad[ci]) // chunk):
            dwin_chunks[dwi].append(int(row_of[cell_chunk0[ci] + k]))
    src: list[int] = []
    win_d_list: list[int] = []
    first_d_list: list[int] = []
    for win in range(nwin_d):
        rows = list(dwin_chunks[win])
        while len(rows) % bpc:
            rows.append(pad_chunk_row)
        if not rows:
            rows = [pad_chunk_row] * bpc
        for b0 in range(0, len(rows), bpc):
            win_d_list.append(win)
            first_d_list.append(1 if b0 == 0 else 0)
        src.extend(rows)
    src_chunks = np.asarray(src, np.int32)
    d_local = d_loc_a[src_chunks]          # [NBb*bpc, chunk]
    nbb = len(win_d_list)

    return CellBlocks(
        w_local=w_local.reshape(nba, block),
        doc_ids=doc_ids.reshape(nba, block),
        mask=mask.reshape(nba, block),
        win_w=win_w_arr, first_w=first_w,
        flat_index=flat_index.reshape(nba, block),
        d_local_a=d_loc_a.reshape(nba, block),
        win_d_chunks=win_d_chunks,
        src_chunks=src_chunks,
        d_local=d_local.reshape(nbb, block),
        win_d=np.asarray(win_d_list, np.int32),
        first_d=np.asarray(first_d_list, np.int32),
        vspan=vspan, dspan=dspan, nwin_w=nwin_w, nwin_d=nwin_d,
        chunk=chunk)


def build_cell_blocks(tokens, doc_ids_all, num_types, num_docs, *,
                      block: int = 4096, vspan: int = 512, dspan: int = 512,
                      chunk: int = 128) -> "CellBlocks":
    """Two-layout cell block structure from flat (type, doc) token arrays.

    Vectorised implementation (cumsum/searchsorted rank arithmetic instead
    of per-cell Python loops): bit-identical to
    `build_cell_blocks_reference`. The JAX package adds a native C++
    builder for large corpora; the port has only this NumPy path.
    """
    assert block % chunk == 0
    tokens = np.asarray(tokens, np.int32)
    d_all = np.asarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    nwin_w = max(1, (num_types + vspan - 1) // vspan)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)
    ww = tokens // vspan
    dw = d_all // dspan
    order = np.lexsort((dw, ww))           # w-window major, d-window minor
    w_s, d_s = tokens[order], d_all[order]
    ww_s, dw_s = ww[order], dw[order]
    bpc = block // chunk

    # ---- cells (sorted unique keys) and their chunk decomposition
    keys = ww_s.astype(np.int64) * nwin_d + dw_s
    cell_key, cell_start = np.unique(keys, return_index=True)
    cell_end = np.append(cell_start[1:], n)
    sizes = cell_end - cell_start
    cpc = (sizes + chunk - 1) // chunk      # chunks per cell (>= 1)
    ncell = len(cell_key)

    total_real = int(cpc.sum())
    cell_first_chunk = np.concatenate([[0], np.cumsum(cpc)[:-1]])
    cell_of_chunk = np.repeat(np.arange(ncell), cpc)
    win_of_chunk = (cell_key[cell_of_chunk] // nwin_d).astype(np.int64)
    dwin_of_chunk = (cell_key[cell_of_chunk] % nwin_d).astype(np.int64)

    # ---- layout A row placement: per window, real chunks then pad chunks
    # up to a block multiple (empty windows get one all-pad block)
    win_real = np.bincount(win_of_chunk, minlength=nwin_w)
    win_rows = np.where(win_real == 0, bpc,
                        ((win_real + bpc - 1) // bpc) * bpc)
    row_off = np.concatenate([[0], np.cumsum(win_rows)])
    total_rows = int(row_off[-1]) + bpc     # + guaranteed all-pad tail block
    # rank within window (win_of_chunk is nondecreasing in cell order)
    first_idx = np.searchsorted(win_of_chunk, np.arange(nwin_w))
    rank = np.arange(total_real) - first_idx[win_of_chunk]
    row_of_chunk = (row_off[win_of_chunk] + rank).astype(np.int64)

    nba = total_rows // bpc
    win_w_arr = np.concatenate([
        np.repeat(np.arange(nwin_w, dtype=np.int32),
                  (win_rows // bpc).astype(np.int64)),
        np.asarray([nwin_w - 1], np.int32)])
    first_w = np.zeros(nba, np.int32)
    first_w[0] = 1
    first_w[1:] = (win_w_arr[1:] != win_w_arr[:-1]).astype(np.int32)

    # ---- token scatter into the padded chunk rows
    w_local = np.full(total_rows * chunk, vspan, np.int32)
    doc_ids = np.zeros(total_rows * chunk, np.int32)
    d_loc_a = np.full(total_rows * chunk, dspan, np.int32)
    mask = np.zeros(total_rows * chunk, bool)
    flat_index = np.full(total_rows * chunk, -1, np.int64)
    cell_of_token = np.repeat(np.arange(ncell), sizes)
    pos_in_cell = np.arange(n) - cell_start[cell_of_token]
    chunk_of_token = cell_first_chunk[cell_of_token] + pos_in_cell // chunk
    dest = row_of_chunk[chunk_of_token] * chunk + pos_in_cell % chunk
    w_local[dest] = w_s - (ww_s * vspan).astype(np.int32)
    doc_ids[dest] = d_s
    d_loc_a[dest] = d_s - (dw_s * dspan).astype(np.int32)
    mask[dest] = True
    flat_index[dest] = order
    win_d_chunks = np.zeros(total_rows, np.int32)
    win_d_chunks[row_of_chunk] = dwin_of_chunk

    # ---- layout B: the same chunk rows regrouped d-window-major (within a
    # d-window, cell order == w-window-major order, as the loop form builds)
    pad_chunk_row = total_rows - 1
    order_b = np.argsort(dwin_of_chunk, kind="stable")
    dwin_sorted = dwin_of_chunk[order_b]
    d_real = np.bincount(dwin_of_chunk, minlength=nwin_d)
    d_rows = np.where(d_real == 0, bpc, ((d_real + bpc - 1) // bpc) * bpc)
    d_off = np.concatenate([[0], np.cumsum(d_rows)])
    total_b = int(d_off[-1])
    src_chunks = np.full(total_b, pad_chunk_row, np.int32)
    first_idx_d = np.searchsorted(dwin_sorted, np.arange(nwin_d))
    rank_d = np.arange(total_real) - first_idx_d[dwin_sorted]
    src_chunks[d_off[dwin_sorted] + rank_d] = row_of_chunk[order_b]
    nbb = total_b // bpc
    win_d_arr = np.repeat(np.arange(nwin_d, dtype=np.int32),
                          (d_rows // bpc).astype(np.int64))
    first_d = np.zeros(nbb, np.int32)
    first_d[(d_off[:-1] // bpc).astype(np.int64)] = 1
    d_local = d_loc_a.reshape(-1, chunk)[src_chunks]

    return CellBlocks(
        w_local=w_local.reshape(nba, block),
        doc_ids=doc_ids.reshape(nba, block),
        mask=mask.reshape(nba, block),
        win_w=win_w_arr, first_w=first_w,
        flat_index=flat_index.reshape(nba, block),
        d_local_a=d_loc_a.reshape(nba, block),
        win_d_chunks=win_d_chunks,
        src_chunks=src_chunks,
        d_local=d_local.reshape(nbb, block),
        win_d=win_d_arr,
        first_d=first_d,
        vspan=vspan, dspan=dspan, nwin_w=nwin_w, nwin_d=nwin_d,
        chunk=chunk)


def build_cell_blocks_seq(tokens, doc_ids_all, num_types, num_docs, *,
                          block: int = 4096, vspan: int = 128,
                          dspan: int = 128,
                          chunk: int = 128) -> "CellBlocks":
    """Cell blocks with a SEQUENTIAL-SAFE chunk schedule: no two tokens of
    the same document share a 128-token chunk.

    The PCGS conditional (n_dk + alpha_k) * phi[k][w]
    (UncollapsedParallelLDA.java:1509-1513) updates n_dk immediately per
    token, so the tokens of one document are drawn in sequence. A Gibbs
    sweep may visit tokens in any fixed order; this layout fixes the order
    (w-window, d-window, occurrence-rank, doc): each (cell, rank)
    pseudo-cell holds at most one token per document. The slot order of
    this layout is the order in which the sweep visits each document's
    tokens (`doc_visit_order`).

    Same construction as `build_cell_blocks` with cells split by rank;
    layout B fields are built identically (valid, though the PCGS sweep
    does not use them).
    """
    assert block % chunk == 0
    assert dspan <= chunk, "a rank group must fit one chunk per d-window"
    tokens = np.asarray(tokens, np.int32)
    d_all = np.asarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    nwin_w = max(1, (num_types + vspan - 1) // vspan)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)
    ww = tokens // vspan
    dw = d_all // dspan

    # occurrence rank of each token within its (cell, doc) group
    ord0 = np.lexsort((d_all, dw, ww))
    key0 = ((ww[ord0].astype(np.int64) * nwin_d + dw[ord0]) * num_docs
            + d_all[ord0])
    newgrp = np.concatenate([[True], key0[1:] != key0[:-1]]) if n else \
        np.zeros(0, bool)
    starts = np.flatnonzero(newgrp)
    grp_id = np.cumsum(newgrp) - 1 if n else np.zeros(0, np.int64)
    rank = np.empty(n, np.int64)
    rank[ord0] = np.arange(n) - (starts[grp_id] if n else 0)
    nrank = int(rank.max()) + 1 if n else 1

    order = np.lexsort((d_all, rank, dw, ww))
    w_s, d_s = tokens[order], d_all[order]
    ww_s, dw_s = ww[order], dw[order]
    rank_s = rank[order]
    bpc = block // chunk

    # ---- pseudo-cells: (w-window, d-window, rank), sorted unique keys
    keys = (ww_s.astype(np.int64) * nwin_d + dw_s) * nrank + rank_s
    cell_key, cell_start = np.unique(keys, return_index=True)
    cell_end = np.append(cell_start[1:], n)
    sizes = cell_end - cell_start
    cpc = (sizes + chunk - 1) // chunk      # 1 when dspan <= chunk
    ncell = len(cell_key)

    total_real = int(cpc.sum())
    cell_first_chunk = np.concatenate([[0], np.cumsum(cpc)[:-1]])
    cell_of_chunk = np.repeat(np.arange(ncell), cpc)
    win_of_chunk = (cell_key[cell_of_chunk] // (nwin_d * nrank)
                    ).astype(np.int64)
    dwin_of_chunk = (cell_key[cell_of_chunk] // nrank % nwin_d
                     ).astype(np.int64)

    win_real = np.bincount(win_of_chunk, minlength=nwin_w)
    win_rows = np.where(win_real == 0, bpc,
                        ((win_real + bpc - 1) // bpc) * bpc)
    row_off = np.concatenate([[0], np.cumsum(win_rows)])
    total_rows = int(row_off[-1]) + bpc     # + guaranteed all-pad tail block
    first_idx = np.searchsorted(win_of_chunk, np.arange(nwin_w))
    rnk = np.arange(total_real) - first_idx[win_of_chunk]
    row_of_chunk = (row_off[win_of_chunk] + rnk).astype(np.int64)

    nba = total_rows // bpc
    win_w_arr = np.concatenate([
        np.repeat(np.arange(nwin_w, dtype=np.int32),
                  (win_rows // bpc).astype(np.int64)),
        np.asarray([nwin_w - 1], np.int32)])
    first_w = np.zeros(nba, np.int32)
    first_w[0] = 1
    first_w[1:] = (win_w_arr[1:] != win_w_arr[:-1]).astype(np.int32)

    w_local = np.full(total_rows * chunk, vspan, np.int32)
    doc_ids = np.zeros(total_rows * chunk, np.int32)
    d_loc_a = np.full(total_rows * chunk, dspan, np.int32)
    mask = np.zeros(total_rows * chunk, bool)
    flat_index = np.full(total_rows * chunk, -1, np.int64)
    cell_of_token = np.repeat(np.arange(ncell), sizes)
    pos_in_cell = np.arange(n) - cell_start[cell_of_token]
    chunk_of_token = cell_first_chunk[cell_of_token] + pos_in_cell // chunk
    dest = row_of_chunk[chunk_of_token] * chunk + pos_in_cell % chunk
    w_local[dest] = w_s - (ww_s * vspan).astype(np.int32)
    doc_ids[dest] = d_s
    d_loc_a[dest] = d_s - (dw_s * dspan).astype(np.int32)
    mask[dest] = True
    flat_index[dest] = order
    win_d_chunks = np.zeros(total_rows, np.int32)
    win_d_chunks[row_of_chunk] = dwin_of_chunk

    pad_chunk_row = total_rows - 1
    order_b = np.argsort(dwin_of_chunk, kind="stable")
    dwin_sorted = dwin_of_chunk[order_b]
    d_real = np.bincount(dwin_of_chunk, minlength=nwin_d)
    d_rows = np.where(d_real == 0, bpc, ((d_real + bpc - 1) // bpc) * bpc)
    d_off = np.concatenate([[0], np.cumsum(d_rows)])
    total_b = int(d_off[-1])
    src_chunks = np.full(total_b, pad_chunk_row, np.int32)
    first_idx_d = np.searchsorted(dwin_sorted, np.arange(nwin_d))
    rank_d = np.arange(total_real) - first_idx_d[dwin_sorted]
    src_chunks[d_off[dwin_sorted] + rank_d] = row_of_chunk[order_b]
    nbb = total_b // bpc
    win_d_arr = np.repeat(np.arange(nwin_d, dtype=np.int32),
                          (d_rows // bpc).astype(np.int64))
    first_d = np.zeros(nbb, np.int32)
    first_d[(d_off[:-1] // bpc).astype(np.int64)] = 1
    d_local = d_loc_a.reshape(-1, chunk)[src_chunks]

    return CellBlocks(
        w_local=w_local.reshape(nba, block),
        doc_ids=doc_ids.reshape(nba, block),
        mask=mask.reshape(nba, block),
        win_w=win_w_arr, first_w=first_w,
        flat_index=flat_index.reshape(nba, block),
        d_local_a=d_loc_a.reshape(nba, block),
        win_d_chunks=win_d_chunks,
        src_chunks=src_chunks,
        d_local=d_local.reshape(nbb, block),
        win_d=win_d_arr,
        first_d=first_d,
        vspan=vspan, dspan=dspan, nwin_w=nwin_w, nwin_d=nwin_d,
        chunk=chunk)


@dataclass
class StreamBlocks:
    """Sequential-safe d-window-major token blocks, the streamed layout of
    the PCGS sweep: tokens sorted by (d-window, w-window, occurrence-rank,
    doc), cells padded per chunk only (no per-window block alignment). Each
    d-window's chunks are contiguous; the w-window of a chunk is
    `win_w_chunks`.
    """
    w_local: np.ndarray       # [NB, B] type id minus win_w*vspan; vspan=pad
    d_local: np.ndarray       # [NB, B] doc id minus win_d*dspan; dspan=pad
    mask: np.ndarray          # [NB, B]
    flat_index: np.ndarray    # [NB, B] corpus token index (-1 = pad)
    win_w_chunks: np.ndarray  # [NB*B/chunk] w-window id per chunk
    win_d_chunks: np.ndarray  # [NB*B/chunk] d-window id per chunk
    vspan: int
    dspan: int
    nwin_w: int
    nwin_d: int
    chunk: int


def build_stream_blocks_seq(tokens, doc_ids_all, num_types, num_docs, *,
                            block: int = 4096, vspan: int = 128,
                            dspan: int = 128,
                            chunk: int = 128) -> "StreamBlocks":
    """d-window-major sequential-safe blocks (see StreamBlocks)."""
    assert block % chunk == 0
    assert dspan <= chunk, "a rank group must fit one chunk per d-window"
    tokens = np.asarray(tokens, np.int32)
    d_all = np.asarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    nwin_w = max(1, (num_types + vspan - 1) // vspan)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)
    ww = tokens // vspan
    dw = d_all // dspan

    # occurrence rank of each token within its (dw, ww, doc) group
    ord0 = np.lexsort((d_all, ww, dw))
    key0 = ((dw[ord0].astype(np.int64) * nwin_w + ww[ord0]) * num_docs
            + d_all[ord0])
    newgrp = np.concatenate([[True], key0[1:] != key0[:-1]]) if n else \
        np.zeros(0, bool)
    starts = np.flatnonzero(newgrp)
    grp_id = np.cumsum(newgrp) - 1 if n else np.zeros(0, np.int64)
    rank = np.empty(n, np.int64)
    rank[ord0] = np.arange(n) - (starts[grp_id] if n else 0)
    nrank = int(rank.max()) + 1 if n else 1

    order = np.lexsort((d_all, rank, ww, dw))
    w_s, d_s = tokens[order], d_all[order]
    ww_s, dw_s = ww[order], dw[order]
    rank_s = rank[order]

    # pseudo-cells (dw, ww, rank), sorted; each spans ceil(size/chunk)
    # consecutive chunks (== 1 when dspan <= chunk)
    keys = (dw_s.astype(np.int64) * nwin_w + ww_s) * nrank + rank_s
    cell_key, cell_start = np.unique(keys, return_index=True)
    cell_end = np.append(cell_start[1:], n)
    sizes = cell_end - cell_start
    cpc = (sizes + chunk - 1) // chunk
    ncell = len(cell_key)
    total_real = int(cpc.sum())
    bpc = block // chunk
    # pad to a block multiple, with at least one (all-pad) block
    total_chunks = max(bpc, -(-total_real // bpc) * bpc)
    nb = total_chunks // bpc

    cell_first_chunk = np.concatenate([[0], np.cumsum(cpc)[:-1]])
    cell_of_chunk = np.repeat(np.arange(ncell), cpc)
    dw_of_chunk = (cell_key[cell_of_chunk] // (nwin_w * nrank)
                   ).astype(np.int32)
    ww_of_chunk = (cell_key[cell_of_chunk] // nrank % nwin_w
                   ).astype(np.int32)
    win_d_chunks = np.zeros(total_chunks, np.int32)
    win_w_chunks = np.zeros(total_chunks, np.int32)
    win_d_chunks[:total_real] = dw_of_chunk
    win_w_chunks[:total_real] = ww_of_chunk
    if total_real:
        # pad chunks keep the last windows
        win_d_chunks[total_real:] = dw_of_chunk[-1]
        win_w_chunks[total_real:] = ww_of_chunk[-1]

    w_local = np.full(total_chunks * chunk, vspan, np.int32)
    d_local = np.full(total_chunks * chunk, dspan, np.int32)
    mask = np.zeros(total_chunks * chunk, bool)
    flat_index = np.full(total_chunks * chunk, -1, np.int64)
    cell_of_token = np.repeat(np.arange(ncell), sizes)
    pos_in_cell = np.arange(n) - cell_start[cell_of_token]
    chunk_of_token = cell_first_chunk[cell_of_token] + pos_in_cell // chunk
    dest = chunk_of_token * chunk + pos_in_cell % chunk
    w_local[dest] = w_s - (ww_s * vspan).astype(np.int32)
    d_local[dest] = d_s - (dw_s * dspan).astype(np.int32)
    mask[dest] = True
    flat_index[dest] = order

    return StreamBlocks(
        w_local=w_local.reshape(nb, block),
        d_local=d_local.reshape(nb, block),
        mask=mask.reshape(nb, block),
        flat_index=flat_index.reshape(nb, block),
        win_w_chunks=win_w_chunks, win_d_chunks=win_d_chunks,
        vspan=vspan, dspan=dspan, nwin_w=nwin_w, nwin_d=nwin_d,
        chunk=chunk)


def build_stream_blocks(tokens, doc_ids_all, num_types, num_docs, *,
                        block: int = 4096, vspan: int = 128,
                        dspan: int = 128, chunk: int = 128
                        ) -> "StreamBlocks":
    """StreamBlocks for any corpus size. The JAX package switches to a
    native C++ builder at 1M tokens, bit-identical to the NumPy one; the
    port always takes the NumPy builder."""
    return build_stream_blocks_seq(tokens, doc_ids_all, num_types,
                                   num_docs, block=block, vspan=vspan,
                                   dspan=dspan, chunk=chunk)


def doc_visit_order(d_local, win_d_chunks, *, dspan: int, chunk: int,
                    num_docs: int):
    """Per-document slot lists of a sequential-safe layout, in CSR form.

    d_local: [NB, B] (or flat) doc id minus win_d*dspan, sentinel dspan on
    padding; win_d_chunks: [NB*B/chunk] d-window of each chunk. Real slots
    are sorted stably by global document, so each document's slots stay
    in slot order, which is the order the chunk-sequential sweep visits
    them. Returns (offsets int32 [D+1], slots int32 [N]): document d's
    slots are slots[offsets[d]:offsets[d+1]].
    """
    d_local = np.asarray(d_local).reshape(-1)
    assert d_local.size < 2 ** 31, "slot indices must fit int32"
    real = np.flatnonzero(d_local < dspan)
    doc = (np.asarray(win_d_chunks, np.int64)[real // chunk] * dspan
           + d_local[real])
    order = np.argsort(doc, kind="stable")
    counts = np.bincount(doc, minlength=num_docs)
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    return offsets, real[order].astype(np.int32)
