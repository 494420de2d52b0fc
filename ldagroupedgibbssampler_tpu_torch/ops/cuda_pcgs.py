"""PCGS sweep (phi fixed, n_dk updated in the sweep) and its collapsed
(ADLDA) mode: the CUDA kernel and its plain versions.

Counterpart of `ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py`:
`fused_pcgs_sweep` (resident layout, Pallas kernel `_pcgs_kernel`) and
`fused_pcgs_sweep_streamed` (streamed layout, `_pcgs_stream_kernel`), in
both modes. Both launch the kernels of `csrc/pcgs.cu`, whose header says
what they compute, the collapsed mode's staleness contract and what bounds
each on the H100. The PCGS mode at K <= 256 runs two kernels: a pre-pass
that writes bf16(phi) as [V, kpad] once a sweep (`phi_bf16_table`), then
the sweep, in which warps take the documents longest first (two documents
a warp, one a half, at K <= 128), each lane owns 8 contiguous topics of a
128-topic tile and keeps their n_dk + alpha in registers, and each token
costs one 16-byte row load a lane, one scan of the lane totals and one
count reduction. The collapsed mode, and the PCGS mode above K = 256, run
one warp per document over a shared-memory column in index order. The
public functions keep the JAX signatures and shapes, with these changes:

  - two extra operands, `doc_slot_offsets` int32 [D+1] and `doc_slots`
    int32 [N]: each document's real slots in the order the chunk-
    sequential sweep visits them (`corpus/ragged.py::doc_visit_order`,
    built once on the host from the layout);
  - `seed` is an int64 [1] tensor keying the in-kernel Philox4x32-10 (the
    kernel's uniforms are `ops/philox.py::philox_u24` words); `interpret`
    and the streamed kernel's `force_ktile` are TPU-only switches and are
    gone;
  - `serial=True` launches one block of one warp, which walks the
    documents in turn (in the collapsed mode in index order: the
    sequential chain, which the oracle checks use), and `nk_out`, an
    optional f32 [K] tensor, receives the collapsed mode's live
    V beta + n_k at the end of the sweep;
  - the keyword `doc_order` int32 [D], required in the PCGS mode and
    refused in the collapsed mode: the order in which the PCGS kernel's
    warps take the documents (longest first, from `corpus/ragged.py::
    longest_first`). No draw depends on it, so the plain versions take
    none.

With `nk_plus` (f32 [K], V beta + n_k) and `beta` the sweep is the
collapsed conditional (n_dk + alpha)(beta + N_kw - own)/(V beta + n_k -
own): `phi_vk` then holds the sweep-entry N_kw counts, and the returned
nkw is entry + hist(z) - hist(z_old). The kernel keeps N_kw live in global
memory (read at draw time, updated by atomics at once) and V beta + n_k
warp-local: each warp flushes its net moves and reloads its view at the
start of every batch of at most 32 of a document's tokens, so a draw's n_k
misses only the other warps' moves since its batch began, never its own.
The TPU kernel's chunk schedule is not replayed (csrc/pcgs.cu). The
one-warp launch is the sequential chain.

For CUDA tensors the wrappers launch the kernel (or raise); for CPU tensors
they run the plain versions `fused_pcgs_sweep_reference` /
`fused_pcgs_sweep_streamed_reference`, which work on any device. PCGS
mode: a document-sequential sweep over the visit order, padded to
[D, Lmax] and stepped position by position with all documents at once,
rounding where the kernel rounds (the f32 table with +-1 updates, bf16
phi, a bf16 product, a 128-topic tiled f32 cdf with running tile offsets).
Collapsed mode: the sequential schedule, token by token (`_collapsed_
reference`), which the one-warp launch computes on any input and the TPU
kernel whenever one document is selected.
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24

FLAG_ROWS = 8  # extra table rows; row kpad = doc-mask flag, rest zero
# largest K whose per-warp rows fit one block's shared memory (227 KB): the
# n_dk column and cdf (8 bytes a topic), and in the collapsed mode also the
# view of V beta + n_k and the unflushed moves (16 bytes a topic)
MAX_TOPICS = (227 * 1024 // 8) // 128 * 128
MAX_TOPICS_COLLAPSED = (227 * 1024 // 16) // 128 * 128
# largest kpad of the PCGS mode's lane-owned kernel (registers, no shared
# memory), which reads the bf16 word table; above it the PCGS mode runs the
# shared-memory kernel on phi in f32
LANE_KPAD = 256


def kpad_of(num_topics: int) -> int:
    """Rows of topic data in the n_dk table: K rounded up to 128."""
    return max(128, ((num_topics + 127) // 128) * 128)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def cdf_draw(probs, u24, kpad, lastnz=None):
    """The sweeps' inverse-CDF draw, rounded as the kernels round
    (`pallas_pcgs.py::cdf_draw`): f32 prefix sums inside 128-topic tiles of
    probs f32 [n, K] padded with zeros to kpad, running tile offsets,
    u = float(u24) * 2^-24 * total, k = sum_t #{cdf <= u - off_t} clamped
    to the last topic with probs > 0 (to `lastnz` when given). Returns
    (k int64 [n], total f32 [n])."""
    n, K = probs.shape
    ntile = kpad // 128
    padded = torch.zeros((n, kpad), dtype=torch.float32, device=probs.device)
    padded[:, :K] = probs
    cdf = padded.view(n, ntile, 128).cumsum(dim=2)       # tile-local cdfs
    total = torch.zeros(n, dtype=torch.float32, device=probs.device)
    offs = []
    for tt in range(ntile):
        offs.append(total)
        total = total + cdf[:, tt, 127]
    u = u24.to(torch.float32) * (2.0 ** -24) * total
    cnt = sum((cdf[:, tt, :] <= (u - offs[tt])[:, None]).sum(dim=1)
              for tt in range(ntile))
    if lastnz is not None:
        return cnt.clamp(max=lastnz), total
    topics = torch.arange(K, device=probs.device)
    return torch.minimum(cnt, (topics * (probs > 0)).max(dim=1).values), total


def phi_bf16_table_reference(phi_vk, kpad):
    """Plain version of the PCGS sweep's pre-pass (`phi_bf16_table`):
    bf16(phi_vk) [V, K] zero-padded to bf16 [V, kpad]."""
    num_types, K = phi_vk.shape
    out = torch.zeros((num_types, kpad), dtype=torch.bfloat16,
                      device=phi_vk.device)
    out[:, :K] = phi_vk.to(torch.bfloat16)
    return out


def phi_bf16_table(phi_vk, kpad):
    """The PCGS sweep's pre-pass on f32 phi_vk [V, K]: csrc/pcgs.cu
    `phi_bf16_kernel` for a CUDA tensor (one thread per entry),
    `phi_bf16_table_reference` for a CPU one. Returns bf16 [V, kpad]."""
    if phi_vk.device.type == "cpu":
        return phi_bf16_table_reference(phi_vk, kpad)
    dev = phi_vk.device
    num_types, K = phi_vk.shape
    _build.check_tensor("phi_vk", phi_vk, (num_types, K), torch.float32, dev)
    out = torch.empty((num_types, kpad), dtype=torch.bfloat16, device=dev)
    _build.check(_build.library().lda_pcgs_phi_bf16(
        phi_vk.data_ptr(), out.data_ptr(), num_types, K, kpad, dev.index,
        torch.cuda.current_stream(dev).cuda_stream), "lda_pcgs_phi_bf16")
    return out


def _sweep_reference(w3, z_old, ndk_table, phi_vk, seed, win_of_slot,
                     doc_slot_offsets, doc_slots, u24, *, nwin_w, vspan,
                     num_topics, positive_support):
    """The PCGS sweep on any device; `win_of_slot` is the int64 w-window of
    every slot. Returns (z [like w3], nkw [nwin_w * vspan, K], table)."""
    dev = w3.device
    K = num_topics
    kpad = ndk_table.shape[0] - FLAG_ROWS
    num_docs = doc_slot_offsets.numel() - 1
    off = doc_slot_offsets.to(torch.int64)
    slots = doc_slots.to(torch.int64)
    wrow_all = win_of_slot * vspan + w3.reshape(-1).to(torch.int64)
    zo_all = z_old.reshape(-1)
    if u24 is None:
        u24 = philox_u24(seed, w3.numel())
    u_all = u24.reshape(-1)
    ph_all = _bf16(phi_vk)
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
        n = r.numel()
        nd = col[r]
        nd[torch.arange(n, device=dev), zo] -= flag[r]   # own token out
        k, total = cdf_draw(_bf16(nd * ph_all[wrow_all[s]]), u_all[s], kpad,
                            K - 1 if positive_support else None)
        z = torch.where(total > 0, k, zo)
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


def _collapsed_reference(w3, z_old, ndk_table, counts_vk, seed, win_of_slot,
                         doc_slot_offsets, doc_slots, u24, nk_plus, beta, *,
                         nwin_w, vspan, num_topics, positive_support,
                         nk_out=None):
    """The collapsed (ADLDA) sweep on the sequential schedule: documents in
    index order, each document's slots in visit order, and the n_dk column,
    N_kw and V beta + n_k updated after every token. Per token in the
    kernel's arithmetic, c = flag at z_old:
    p_k = bf16((n_dk + alpha - c) * (((f32(N_kw) + beta) - c)
    / (nkp - c))), drawn with `cdf_draw`. One Python step per token: meant
    for test sizes. It runs on the host and returns on the input's device.
    Returns (z [like w3], nkw [nwin_w * vspan, K], table)."""
    dev, host = w3.device, torch.device("cpu")
    K = num_topics
    kpad = ndk_table.shape[0] - FLAG_ROWS
    num_docs = doc_slot_offsets.numel() - 1
    off = doc_slot_offsets.tolist()
    slots = doc_slots.to(host, torch.int64)
    wrow_all = (win_of_slot.to(host) * vspan
                + w3.reshape(-1).to(host, torch.int64))
    zo_all = z_old.reshape(-1).to(host)
    if u24 is None:
        u24 = philox_u24(seed, w3.numel())
    u_all = u24.reshape(-1).to(host)
    col = ndk_table[:K, :num_docs].T.to(host).clone()  # [D, K] n_dk + alpha
    flag = ndk_table[kpad, :num_docs].to(host)
    # the live counts; N_kw in f32 (integers below 2^24, so exact)
    nkw = torch.zeros((nwin_w * vspan, K), dtype=torch.float32)
    nkw[: counts_vk.shape[0]] = counts_vk.to(host, torch.float32)
    nkp = nk_plus.to(host, torch.float32).clone()
    beta32 = torch.tensor(beta, dtype=torch.float32)
    own = torch.eye(K, dtype=torch.float32)     # one-hot rows
    lastnz = K - 1 if positive_support else None
    z_flat = zo_all.clone()
    for d in torch.nonzero(flag > 0.5).flatten().tolist():
        c = float(flag[d])
        nd_d = col[d]
        sl = slots[off[d]:off[d + 1]]
        for s, zo, wr in zip(sl.tolist(), zo_all[sl].tolist(),
                             wrow_all[sl].tolist()):
            e = own[zo] * c                            # own token out
            p = _bf16((nd_d - e) * (((nkw[wr] + beta32) - e) / (nkp - e)))
            k, total = cdf_draw(p[None], u_all[s:s + 1], kpad, lastnz)
            z = int(k) if float(total) > 0 else zo
            if z != zo:
                z_flat[s] = z
                move = own[z] - own[zo]
                nd_d += move
                nkw[wr] += move
                nkp += move
    if nk_out is not None:
        nk_out.copy_(nkp)
    table = ndk_table.clone()
    table[:K, :num_docs] = col.T.to(dev)
    return (z_flat.view(w3.shape).to(dev), nkw.to(dev, torch.int32),
            table)


def _plain(w3, z_old, ndk_table, phi_vk, seed, win, doc_slot_offsets,
           doc_slots, u24, nk_plus, beta, *, nwin_w, vspan, num_topics,
           positive_support, nk_out):
    """The plain version of either mode for `win`, the w-window of every
    slot."""
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics,
              positive_support=positive_support)
    if _collapsed(nk_plus, beta):
        return _collapsed_reference(w3, z_old, ndk_table, phi_vk, seed, win,
                                    doc_slot_offsets, doc_slots, u24,
                                    nk_plus, beta, nk_out=nk_out, **kw)
    return _sweep_reference(w3, z_old, ndk_table, phi_vk, seed, win,
                            doc_slot_offsets, doc_slots, u24, **kw)


def _collapsed(nk_plus, beta) -> bool:
    if (nk_plus is None) != (beta is None):
        raise ValueError("the collapsed mode needs both nk_plus and beta")
    return nk_plus is not None


def _check_order(doc_order, collapsed, doc_slot_offsets, device):
    """The PCGS mode needs `doc_order`, an int32 [D] tensor on the sweep's
    device; the collapsed mode walks the documents in index order and
    takes none."""
    if collapsed:
        if doc_order is not None:
            raise ValueError("the collapsed mode walks the documents in "
                             "index order and takes no doc_order")
        return
    if doc_order is None:
        raise ValueError("the PCGS mode needs doc_order, the order in which "
                         "the kernel's warps take the documents "
                         "(corpus/ragged.py::longest_first)")
    num_docs = doc_slot_offsets.numel() - 1
    if (not isinstance(doc_order, torch.Tensor)
            or doc_order.dtype != torch.int32
            or tuple(doc_order.shape) != (num_docs,)
            or doc_order.device != device or not doc_order.is_contiguous()):
        raise ValueError(f"doc_order: expected an int32 [{num_docs}] "
                         f"contiguous tensor on {device}")


def fused_pcgs_sweep_reference(w3, d3, z_old, ndk_table, phi_vk, seed,
                               win_w, first_w, win_d_chunks,
                               doc_slot_offsets, doc_slots, u24=None,
                               nk_plus=None, beta=None, *, nwin_w, nwin_d,
                               vspan, dspan, num_topics,
                               positive_support=False, serial=False,
                               nk_out=None):
    """Plain PyTorch version of `fused_pcgs_sweep` (resident layout).
    `serial` changes nothing: the plain versions are sequential already."""
    block = w3.shape[1] * w3.shape[2]
    win = win_w.to(torch.int64).repeat_interleave(block)
    return _plain(w3, z_old, ndk_table, phi_vk, seed, win, doc_slot_offsets,
                  doc_slots, u24, nk_plus, beta, nwin_w=nwin_w, vspan=vspan,
                  num_topics=num_topics, positive_support=positive_support,
                  nk_out=nk_out)


def fused_pcgs_sweep_streamed_reference(w3, d3, z_old, ndk_table, phi_vk,
                                        seed, ww_chunks, wd_chunks,
                                        doc_slot_offsets, doc_slots,
                                        u24=None, nk_plus=None, beta=None,
                                        *, nwin_w, nwin_d, vspan, dspan,
                                        num_topics, positive_support=False,
                                        serial=False, nk_out=None):
    """Plain PyTorch version of `fused_pcgs_sweep_streamed`."""
    win = ww_chunks.to(torch.int64).repeat_interleave(w3.shape[2])
    return _plain(w3, z_old, ndk_table, phi_vk, seed, win, doc_slot_offsets,
                  doc_slots, u24, nk_plus, beta, nwin_w=nwin_w, vspan=vspan,
                  num_topics=num_topics, positive_support=positive_support,
                  nk_out=nk_out)


def check_sweep_operands(w3, d3, z_old, ndk_table, seed, win, win_len,
                         doc_slot_offsets, doc_slots, num_topics,
                         collapsed=False):
    """Check the operands a document-sequential sweep kernel shares (this
    module's and `cuda_lightlda`'s), the topic count first (against the
    collapsed mode's smaller limit when `collapsed`); returns (kpad,
    num_docs, dpad)."""
    dev = w3.device
    K = num_topics
    limit = MAX_TOPICS_COLLAPSED if collapsed else MAX_TOPICS
    if not 0 < K <= limit:
        raise ValueError(f"num_topics={K} outside the kernel's range "
                         f"(1..{limit}: the per-warp rows must fit one "
                         "block's shared memory)")
    kpad = kpad_of(K)
    for name, t in (("w3", w3), ("d3", d3), ("z_old", z_old)):
        _build.check_tensor(name, t, tuple(w3.shape), device=dev)
    num_docs = doc_slot_offsets.numel() - 1
    dpad = ndk_table.shape[1]
    if not 0 <= num_docs <= dpad:
        raise ValueError(f"{num_docs} documents do not fit a table of "
                         f"{dpad} columns")
    _build.check_tensor("ndk_table", ndk_table, (kpad + FLAG_ROWS, dpad),
                        torch.float32, dev)
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)
    _build.check_tensor("win", win, (win_len,), device=dev)
    _build.check_tensor("doc_slot_offsets", doc_slot_offsets,
                        (num_docs + 1,), device=dev)
    _build.check_tensor("doc_slots", doc_slots, (doc_slots.numel(),),
                        device=dev)
    return kpad, num_docs, dpad


def launch_shape(num_topics, collapsed, serial=False):
    """(warps per block, dynamic shared memory bytes per block, topics a
    lane, documents a warp) with which csrc/pcgs.cu launches either mode
    at `num_topics`, from its own rule (needs the built library)."""
    out = torch.zeros(4, dtype=torch.int64)
    _build.check(_build.library().lda_pcgs_launch_shape(
        kpad_of(num_topics), int(collapsed), int(serial), out.data_ptr()),
        "lda_pcgs_launch_shape")
    return tuple(int(x) for x in out)


def _launch(w3, d3, z_old, ndk_table, phi_vk, seed, win, win_len, win_div,
            doc_slot_offsets, doc_slots, u24, nk_plus, beta, *, nwin_w,
            vspan, num_topics, positive_support, serial, nk_out, doc_order):
    """Check the operands, launch csrc/pcgs.cu in the mode the operands
    ask for (the PCGS mode at kpad <= LANE_KPAD: the pre-pass, then the
    sweep), return its outputs."""
    dev = w3.device
    K = num_topics
    collapsed = _collapsed(nk_plus, beta)
    kpad, num_docs, dpad = check_sweep_operands(
        w3, d3, z_old, ndk_table, seed, win, win_len, doc_slot_offsets,
        doc_slots, K, collapsed)
    vpad = nwin_w * vspan
    if not phi_vk.shape[0] <= vpad:
        raise ValueError(f"word table of {phi_vk.shape[0]} rows does not fit "
                         f"{nwin_w} windows of {vspan}")
    _build.check_tensor("phi_vk", phi_vk, (phi_vk.shape[0], K),
                        torch.float32, dev)
    if u24 is not None:
        _build.check_tensor("u24", u24, tuple(w3.shape), device=dev)
    z = z_old.clone()
    nkw = torch.zeros((vpad, K), dtype=torch.int32, device=dev)
    table = ndk_table.clone()
    ptrs = (w3.data_ptr(), z_old.data_ptr(), win.data_ptr(),
            doc_slot_offsets.data_ptr(), doc_slots.data_ptr())
    u24_ptr = None if u24 is None else u24.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    sizes = (num_docs, dpad, kpad, K, vspan, win_div, int(positive_support),
             int(serial), dev.index, stream)
    if not collapsed:
        phi16 = phi_bf16_table(phi_vk, kpad) if kpad <= LANE_KPAD else None
        err = _build.library().lda_pcgs_sweep(
            *ptrs, doc_order.data_ptr(), phi_vk.data_ptr(),
            None if phi16 is None else phi16.data_ptr(), u24_ptr,
            seed.data_ptr(), table.data_ptr(), z.data_ptr(), nkw.data_ptr(),
            *sizes)
        _build.check(err, "lda_pcgs_sweep")
        return z, nkw, table
    # the live counts: N_kw seeded with the entry counts (phi_vk), nkp with
    # V beta + n_k; the kernel updates both in place
    _build.check_tensor("nk_plus", nk_plus, (K,), torch.float32, dev)
    nkw[: phi_vk.shape[0]] = phi_vk.to(torch.int32)
    nkp = nk_plus.clone()
    err = _build.library().lda_pcgs_collapsed_sweep(
        *ptrs, u24_ptr, seed.data_ptr(), table.data_ptr(), z.data_ptr(),
        nkw.data_ptr(), nkp.data_ptr(), float(beta), *sizes)
    _build.check(err, "lda_pcgs_collapsed_sweep")
    if nk_out is not None:
        nk_out.copy_(nkp)
    return z, nkw, table


def fused_pcgs_sweep(w3, d3, z_old, ndk_table, phi_vk, seed, win_w, first_w,
                     win_d_chunks, doc_slot_offsets, doc_slots, u24=None,
                     nk_plus=None, beta=None, *, nwin_w, nwin_d, vspan, dspan,
                     num_topics, positive_support=False, serial=False,
                     nk_out=None, doc_order=None):
    """One PCGS Gibbs sweep over the resident (w-window-major,
    sequential-safe) layout: draw z for every token with immediate n_dk
    updates, count N_kw, and return the updated n_dk table.

    w3 / d3 / z_old: int32 [NB, chunks, chunk] (window-local ids; sentinel
        vspan / dspan on padding slots).
    ndk_table: f32 [kpad + FLAG_ROWS, Dpad], (n_dk + alpha_k).T padded; row
        kpad = doc-mask flag (1.0 selected / 0.0 not). Not modified: the
        updated table is returned.
    phi_vk: f32 [V, K]: phi, fixed for the whole sweep, or in the collapsed
        mode the sweep-entry N_kw counts (integers), which the sweep keeps
        live.
    seed: int64 [1], the Philox key (ignored when u24 is given).
    win_w / first_w: int32 [NB] (first_w unused: N_kw starts from zero or
        from the entry counts).
    win_d_chunks: int32 [NB * chunks] (unused by the kernel: the slot
        lists carry the documents).
    doc_slot_offsets / doc_slots: int32 [D + 1] / [N], the visit order.
    u24: optional int32 [NB, chunks, chunk] of 24-bit uniforms in [0, 2^24)
        replacing the in-kernel Philox draw.
    nk_plus / beta: f32 [K] of V beta + n_k at sweep entry (consistent with
        the counts) and beta: the collapsed (ADLDA) conditional
        (n_dk + alpha_k)(beta + N_kw - own)/(V beta + n_k - own), N_kw and
        n_k live; the returned nkw is entry + hist(z) - hist(z_old).
    positive_support: the conditional is positive for every topic (floored
        Dirichlet phi, or the collapsed conditional), so the draw clamps to
        K - 1 instead of the last nonzero topic.
    serial: launch one block of one warp, which walks the documents in
        turn (in the collapsed mode in index order: the sequential chain).
    nk_out: optional f32 [K], set to the live V beta + n_k at sweep end.
    doc_order: int32 [D], a permutation of the documents, the order in
        which the PCGS kernel's warps take them (`corpus/ragged.py::
        longest_first`): required in the PCGS mode, refused in the
        collapsed mode. No draw depends on it; the CPU path checks it and
        does not read it.

    Returns (z int32 [NB, chunks, chunk], nkw int32 [nwin_w * vspan, K],
             table f32 [kpad + FLAG_ROWS, Dpad]).
    """
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics,
              positive_support=positive_support, serial=serial,
              nk_out=nk_out)
    _check_order(doc_order, _collapsed(nk_plus, beta), doc_slot_offsets,
                 w3.device)
    if w3.device.type == "cpu":
        return fused_pcgs_sweep_reference(
            w3, d3, z_old, ndk_table, phi_vk, seed, win_w, first_w,
            win_d_chunks, doc_slot_offsets, doc_slots, u24, nk_plus, beta,
            nwin_d=nwin_d, dspan=dspan, **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, phi_vk, seed, win_w, nb,
                  chunks * chunk, doc_slot_offsets, doc_slots, u24, nk_plus,
                  beta, doc_order=doc_order, **kw)
    if nk_plus is None:
        fused_pcgs_sweep.launches += 1
    else:
        fused_pcgs_sweep.collapsed_launches += 1
    return out


def fused_pcgs_sweep_streamed(w3, d3, z_old, ndk_table, phi_vk, seed,
                              ww_chunks, wd_chunks, doc_slot_offsets,
                              doc_slots, u24=None, nk_plus=None, beta=None,
                              *, nwin_w, nwin_d, vspan, dspan, num_topics,
                              positive_support=False, serial=False,
                              nk_out=None, doc_order=None):
    """One PCGS Gibbs sweep over the streamed (d-window-major `StreamBlocks`)
    layout; `ww_chunks` / `wd_chunks` are int32 [NB * chunks], the w- and
    d-window of every chunk. Operands, modes and results otherwise as
    `fused_pcgs_sweep`."""
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics,
              positive_support=positive_support, serial=serial,
              nk_out=nk_out)
    _check_order(doc_order, _collapsed(nk_plus, beta), doc_slot_offsets,
                 w3.device)
    if w3.device.type == "cpu":
        return fused_pcgs_sweep_streamed_reference(
            w3, d3, z_old, ndk_table, phi_vk, seed, ww_chunks, wd_chunks,
            doc_slot_offsets, doc_slots, u24, nk_plus, beta, nwin_d=nwin_d,
            dspan=dspan, **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, phi_vk, seed, ww_chunks,
                  nb * chunks, chunk, doc_slot_offsets, doc_slots, u24,
                  nk_plus, beta, doc_order=doc_order, **kw)
    if nk_plus is None:
        fused_pcgs_sweep_streamed.launches += 1
    else:
        fused_pcgs_sweep_streamed.collapsed_launches += 1
    return out


# launches of the kernel through each wrapper, PCGS mode (`launches`) and
# collapsed mode (`collapsed_launches`), added where it launches and
# nowhere else; chip_smoke.py reads them to show that the main path ran
# the kernel
fused_pcgs_sweep.launches = 0
fused_pcgs_sweep.collapsed_launches = 0
fused_pcgs_sweep_streamed.launches = 0
fused_pcgs_sweep_streamed.collapsed_launches = 0
