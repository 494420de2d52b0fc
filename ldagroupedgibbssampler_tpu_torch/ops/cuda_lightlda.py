"""LightLDA Metropolis-Hastings sweep (word and doc proposals, n_dk updated
in the sweep): the CUDA kernel and its plain versions.

Counterpart of `ldagroupedgibbssampler_tpu/ops/pallas_lightlda.py`:
`fused_lightlda_sweep` (resident layout, Pallas kernel `_mh_kernel`) and
`fused_lightlda_sweep_streamed` (streamed layout, `_mh_stream_kernel`).
Both launch the two kernels of `csrc/lightlda.cu`: a pre-pass that tables
the tiled cdf of every word proposal row (`word_cdf_table`), then the
sweep (one warp per document, which draws each token's word proposal from
that table before the token's serial step; the source's header says what
it computes and what bounds it on the H100). The public functions keep
the JAX signatures and shapes, with these changes:

  - two extra operands, `doc_slot_offsets` int32 [D+1] and `doc_slots`
    int32 [N], each document's real slots in visit order, as in
    `ops/cuda_pcgs.py`, and the keyword `doc_order` int32 [D], the order
    in which the kernel's warps take the documents (longest first, from
    `corpus/ragged.py::longest_first`); no draw depends on it, so the
    plain versions take none;
  - `seed` is an int64 [1] tensor keying the in-kernel Philox4x32-10: a
    token's four uniforms (word draw, accept 1, doc draw, accept 2) are
    the four words of its slot, `ops/philox.py::philox_u24x4`;
  - the optional `u24` keeps the JAX layout [NB, 4 * chunks, chunk]: slot
    (b, c, l) takes `u24[b, 4c + j, l]` for j = 0..3, so one array feeds
    both packages; `interpret` is a TPU-only switch and is gone.

The wrapper rounds the word tables `tw_vk` / `qw_vk` to bf16 once per
sweep and keeps them [V, K], so each token reads one contiguous row of
each.

For CUDA tensors the wrappers launch the kernels (or raise); for CPU
tensors they run the plain versions `fused_lightlda_sweep_reference` /
`fused_lightlda_sweep_streamed_reference`, which work on any device: a
document-sequential sweep over the visit order, padded to [D, Lmax] and
stepped position by position with all documents at once, rounding where
the kernel rounds (the f32 table with +-1 updates, bf16 tables, bf16(nd)
for the doc proposal, f32 products in the kernel's association), with
both proposals drawn by the 128-topic tiled cdf of `cuda_pcgs.cdf_draw`,
independently of the kernel's tabled search. `word_cdf_table_reference`
and `tabled_draw_reference` are the plain versions of that search, which
the tests hold to `cdf_draw`.
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.cuda_pcgs import (
    FLAG_ROWS, _bf16, cdf_draw, check_sweep_operands, kpad_of)
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24x4

_INV24 = 2.0 ** -24


def _slot_uniforms(u24, shape3):
    """The JAX layout [NB, 4 * chunks, chunk] of injected uniforms as one
    row of four per slot: int32 [NB * chunks * chunk, 4]."""
    nb, chunks, chunk = shape3
    return u24.reshape(nb, chunks, 4, chunk).permute(0, 1, 3, 2).reshape(-1, 4)


def word_cdf_table_reference(qw_vk, kpad):
    """Plain version of the sweep's pre-pass (`word_cdf_table`): for every
    row of bf16(qw_vk) f32 [V, K], its f32 prefix sums inside 128-topic
    tiles (padded with zeros to kpad), its total (the tile totals summed in
    tile order) and its last topic with qw > 0 (-1 for an all-zero row).
    Returns (cdf f32 [V, kpad], total f32 [V], lastnz int32 [V])."""
    num_types, K = qw_vk.shape
    q = _bf16(qw_vk)
    padded = torch.zeros((num_types, kpad), dtype=torch.float32,
                         device=q.device)
    padded[:, :K] = q
    cdf = padded.view(num_types, kpad // 128, 128).cumsum(dim=2)
    total = torch.zeros(num_types, dtype=torch.float32, device=q.device)
    for t in range(kpad // 128):
        total = total + cdf[:, t, 127]
    nz = q > 0
    topics = torch.arange(K, device=q.device)
    lastnz = torch.where(nz.any(dim=1), (topics * nz).max(dim=1).values, -1)
    return cdf.view(num_types, kpad), total, lastnz.to(torch.int32)


def tabled_draw_reference(cdf, total, lastnz, rows, u24):
    """The word proposal draw from the pre-pass's table, as the sweep's
    prefetch makes it: for token i, with r = rows[i], u = u24[i] * 2^-24 *
    total[r], k = sum over tiles t of #{cdf[r, tile t] <= u - off_t} by an
    upper-bound search (off_t the totals of the tiles before t), clamped to
    lastnz[r]; k = 0 where total[r] is 0. Equal to `cuda_pcgs.cdf_draw`
    over the same rows wherever each tile's cdf does not decrease (the
    tests check it; the plain sweep draws with `cdf_draw`). Returns
    (k int64 [n], total f32 [n])."""
    n = rows.numel()
    ntile = cdf.shape[1] // 128
    c = cdf[rows].view(n, ntile, 128)
    tot = total[rows]
    u = u24.to(torch.float32) * _INV24 * tot
    cnt = torch.zeros(n, dtype=torch.int64, device=cdf.device)
    off = torch.zeros(n, dtype=torch.float32, device=cdf.device)
    for t in range(ntile):
        tile = c[:, t].contiguous()
        cnt += torch.searchsorted(tile, (u - off)[:, None], right=True)[:, 0]
        off = off + tile[:, 127]
    k = torch.minimum(cnt, lastnz[rows].to(torch.int64))
    return torch.where(tot > 0, k, 0), tot


def word_cdf_table(qw16, kpad):
    """The sweep's pre-pass on bf16 qw16 [V, K]: csrc/lightlda.cu
    `word_cdf_kernel` for a CUDA tensor (one warp per row, the sweep's warp
    scan), `word_cdf_table_reference` for a CPU one. Returns (cdf f32
    [V, kpad], total f32 [V], lastnz int32 [V])."""
    if qw16.device.type == "cpu":
        return word_cdf_table_reference(qw16.to(torch.float32), kpad)
    dev = qw16.device
    num_types, K = qw16.shape
    _build.check_tensor("qw16", qw16, (num_types, K), torch.bfloat16, dev)
    cdf = torch.empty((num_types, kpad), dtype=torch.float32, device=dev)
    total = torch.empty(num_types, dtype=torch.float32, device=dev)
    lastnz = torch.empty(num_types, dtype=torch.int32, device=dev)
    err = _build.library().lda_lightlda_word_cdf(
        qw16.data_ptr(), cdf.data_ptr(), total.data_ptr(), lastnz.data_ptr(),
        num_types, K, kpad, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lda_lightlda_word_cdf")
    return cdf, total, lastnz


def launch_shape(num_topics):
    """(warps per block, dynamic shared memory bytes per block) with which
    csrc/lightlda.cu launches the sweep at `num_topics`, from its own rule
    (needs the built library)."""
    out = torch.zeros(2, dtype=torch.int64)
    _build.check(_build.library().lda_lightlda_launch_shape(
        kpad_of(num_topics), out.data_ptr()), "lda_lightlda_launch_shape")
    return int(out[0]), int(out[1])


def _mh_reference(w3, z_old, ndk_table, tw_vk, qw_vk, seed, win_of_slot,
                  doc_slot_offsets, doc_slots, u24, *, nwin_w, vspan,
                  num_topics):
    """The MH sweep on any device; `win_of_slot` is the int64 w-window of
    every slot. Returns (z [like w3], nkw [nwin_w * vspan, K], table)."""
    dev = w3.device
    K = num_topics
    kpad = ndk_table.shape[0] - FLAG_ROWS
    num_docs = doc_slot_offsets.numel() - 1
    off = doc_slot_offsets.to(torch.int64)
    slots = doc_slots.to(torch.int64)
    wrow_all = win_of_slot * vspan + w3.reshape(-1).to(torch.int64)
    zo_all = z_old.reshape(-1)
    u_all = (philox_u24x4(seed, w3.numel()) if u24 is None
             else _slot_uniforms(u24, tuple(w3.shape)))
    tw_all, qw_all = _bf16(tw_vk), _bf16(qw_vk)
    col = ndk_table[:K, :num_docs].T.clone()          # [D, K] n_dk + alpha
    flag = ndk_table[kpad, :num_docs]
    lengths = off[1:] - off[:-1]
    lmax = int(lengths.max()) if num_docs else 0
    docs = torch.arange(num_docs, device=dev)
    z_flat = zo_all.clone()
    for t in range(lmax):
        act = (lengths > t) & (flag > 0.5)
        r = docs[act]
        if r.numel() == 0:
            continue
        s = slots[off[r] + t]
        zo = zo_all[s].to(torch.int64)
        rows = torch.arange(r.numel(), device=dev)
        nd = col[r]
        nd[rows, zo] -= flag[r]                        # own token out
        tw, qw, u = tw_all[wrow_all[s]], qw_all[wrow_all[s]], u_all[s]
        # MH step 1: word proposal k1 ~ qw
        k1, totq = cdf_draw(qw, u[:, 0], kpad)
        nd_z, nd_1 = nd[rows, zo], nd[rows, k1]
        tw_z, tw_1 = tw[rows, zo], tw[rows, k1]
        u1 = u[:, 1].to(torch.float32) * _INV24
        take1 = ((u1 * (nd_z * tw_z * qw[rows, k1])
                  < nd_1 * tw_1 * qw[rows, zo]) & (totq > 0))
        z1 = torch.where(take1, k1, zo)
        tw_z1 = torch.where(take1, tw_1, tw_z)
        nd_z1 = torch.where(take1, nd_1, nd_z)
        # MH step 2: doc proposal k2 ~ bf16(nd), corrected with the same ndq
        ndq = _bf16(nd)
        k2, totd = cdf_draw(ndq, u[:, 2], kpad)
        nd_2, tw_2 = nd[rows, k2], tw[rows, k2]
        u2 = u[:, 3].to(torch.float32) * _INV24
        take2 = ((u2 * (nd_z1 * tw_z1 * ndq[rows, k2])
                  < nd_2 * tw_2 * _bf16(nd_z1)) & (totd > 0))
        z = torch.where(take2, k2, z1)
        z_flat[s] = z.to(torch.int32)
        ch = z != zo
        rc = r[ch]
        col[rc, zo[ch]] -= 1.0
        col[rc, z[ch]] += 1.0
    nkw = torch.zeros((nwin_w * vspan, K), dtype=torch.int32, device=dev)
    nkw.index_put_((wrow_all[slots], z_flat[slots].to(torch.int64)),
                   torch.ones_like(slots, dtype=torch.int32),
                   accumulate=True)
    table = ndk_table.clone()
    table[:K, :num_docs] = col.T
    return z_flat.view(w3.shape), nkw, table


def fused_lightlda_sweep_reference(w3, d3, z_old, ndk_table, tw_vk, qw_vk,
                                   seed, win_w, first_w, win_d_chunks,
                                   doc_slot_offsets, doc_slots, u24=None, *,
                                   nwin_w, nwin_d, vspan, dspan, num_topics):
    """Plain PyTorch version of `fused_lightlda_sweep` (resident layout)."""
    block = w3.shape[1] * w3.shape[2]
    win = win_w.to(torch.int64).repeat_interleave(block)
    return _mh_reference(w3, z_old, ndk_table, tw_vk, qw_vk, seed, win,
                         doc_slot_offsets, doc_slots, u24, nwin_w=nwin_w,
                         vspan=vspan, num_topics=num_topics)


def fused_lightlda_sweep_streamed_reference(w3, d3, z_old, ndk_table, tw_vk,
                                            qw_vk, seed, ww_chunks,
                                            wd_chunks, doc_slot_offsets,
                                            doc_slots, u24=None, *, nwin_w,
                                            nwin_d, vspan, dspan,
                                            num_topics):
    """Plain PyTorch version of `fused_lightlda_sweep_streamed`."""
    win = ww_chunks.to(torch.int64).repeat_interleave(w3.shape[2])
    return _mh_reference(w3, z_old, ndk_table, tw_vk, qw_vk, seed, win,
                         doc_slot_offsets, doc_slots, u24, nwin_w=nwin_w,
                         vspan=vspan, num_topics=num_topics)


def _launch(w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, win, win_len,
            win_div, doc_slot_offsets, doc_slots, u24, *, nwin_w, vspan,
            num_topics, doc_order):
    """Check the operands, launch csrc/lightlda.cu (the pre-pass, then the
    sweep), return its outputs."""
    dev = w3.device
    K = num_topics
    kpad, num_docs, dpad = check_sweep_operands(
        w3, d3, z_old, ndk_table, seed, win, win_len, doc_slot_offsets,
        doc_slots, K)
    nb, chunks, chunk = w3.shape
    num_types = tw_vk.shape[0]
    for name, t in (("tw_vk", tw_vk), ("qw_vk", qw_vk)):
        _build.check_tensor(name, t, (num_types, K), torch.float32, dev)
    if u24 is not None:
        _build.check_tensor("u24", u24, (nb, 4 * chunks, chunk), device=dev)
    _build.check_tensor("doc_order", doc_order, (num_docs,), device=dev)
    tw16 = tw_vk.to(torch.bfloat16)
    qw16 = tw16 if qw_vk is tw_vk else qw_vk.to(torch.bfloat16)
    qcdf, qtot, qlast = word_cdf_table(qw16, kpad)
    z = z_old.clone()
    nkw = torch.zeros((nwin_w * vspan, K), dtype=torch.int32, device=dev)
    table = ndk_table.clone()
    err = _build.library().lda_lightlda_sweep(
        w3.data_ptr(), z_old.data_ptr(), win.data_ptr(),
        doc_slot_offsets.data_ptr(), doc_slots.data_ptr(),
        doc_order.data_ptr(), tw16.data_ptr(),
        qw16.data_ptr(), qcdf.data_ptr(), qtot.data_ptr(), qlast.data_ptr(),
        None if u24 is None else u24.data_ptr(), seed.data_ptr(),
        table.data_ptr(), z.data_ptr(), nkw.data_ptr(), num_docs, dpad, kpad,
        K, vspan, win_div, chunk, chunks, dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lda_lightlda_sweep")
    return z, nkw, table


def fused_lightlda_sweep(w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, win_w,
                         first_w, win_d_chunks, doc_slot_offsets, doc_slots,
                         u24=None, *, nwin_w, nwin_d, vspan, dspan,
                         num_topics, doc_order):
    """One LightLDA MH sweep over the resident (w-window-major,
    sequential-safe) layout: two MH steps per token with immediate n_dk
    updates, N_kw counted, the updated n_dk table returned.

    w3 / d3 / z_old: int32 [NB, chunks, chunk] (window-local ids; sentinel
        vspan / dspan on padding slots).
    ndk_table: f32 [kpad + FLAG_ROWS, Dpad], (n_dk + alpha_k).T padded; row
        kpad = doc-mask flag (1.0 selected / 0.0 not). Not modified: the
        updated table is returned.
    tw_vk / qw_vk: f32 [V, K] linear-space word target / proposal tables,
        fixed for the whole sweep (rounded to bf16 here). Passing the same
        tensor twice rounds it once.
    seed: int64 [1], the Philox key (ignored when u24 is given).
    win_w / first_w: int32 [NB] (first_w unused: N_kw starts zeroed).
    win_d_chunks: int32 [NB * chunks] (unused by the kernel: the slot
        lists carry the documents).
    doc_slot_offsets / doc_slots: int32 [D + 1] / [N], the visit order.
    u24: optional int32 [NB, 4 * chunks, chunk] of 24-bit uniforms in
        [0, 2^24), four per token, replacing the in-kernel Philox draw.
    doc_order: int32 [D], a permutation of the documents, the order in
        which the kernel's warps take them (`corpus/ragged.py::
        longest_first`); no draw depends on it, and the CPU path ignores
        it.

    Returns (z int32 [NB, chunks, chunk], nkw int32 [nwin_w * vspan, K],
             table f32 [kpad + FLAG_ROWS, Dpad]).
    """
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics)
    if w3.device.type == "cpu":
        return fused_lightlda_sweep_reference(
            w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, win_w, first_w,
            win_d_chunks, doc_slot_offsets, doc_slots, u24, nwin_d=nwin_d,
            dspan=dspan, **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, win_w, nb,
                  chunks * chunk, doc_slot_offsets, doc_slots, u24,
                  doc_order=doc_order, **kw)
    fused_lightlda_sweep.launches += 1
    return out


def fused_lightlda_sweep_streamed(w3, d3, z_old, ndk_table, tw_vk, qw_vk,
                                  seed, ww_chunks, wd_chunks,
                                  doc_slot_offsets, doc_slots, u24=None, *,
                                  nwin_w, nwin_d, vspan, dspan, num_topics,
                                  doc_order):
    """One LightLDA MH sweep over the streamed (d-window-major
    `StreamBlocks`) layout; `ww_chunks` / `wd_chunks` are int32
    [NB * chunks], the w- and d-window of every chunk. Operands and results
    otherwise as `fused_lightlda_sweep`."""
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics)
    if w3.device.type == "cpu":
        return fused_lightlda_sweep_streamed_reference(
            w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, ww_chunks,
            wd_chunks, doc_slot_offsets, doc_slots, u24, nwin_d=nwin_d,
            dspan=dspan, **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, tw_vk, qw_vk, seed, ww_chunks,
                  nb * chunks, chunk, doc_slot_offsets, doc_slots, u24,
                  doc_order=doc_order, **kw)
    fused_lightlda_sweep_streamed.launches += 1
    return out


# launches of the kernels (pre-pass and sweep) through each wrapper (added
# where it launches them, nowhere else); chip_smoke.py reads them to show
# that the main path ran the kernels
fused_lightlda_sweep.launches = 0
fused_lightlda_sweep_streamed.launches = 0
