"""PCGS sweep (phi fixed, n_dk updated in the sweep): the CUDA kernel and
its plain versions.

Counterpart of `ldagroupedgibbssampler_tpu/ops/pallas_pcgs.py`:
`fused_pcgs_sweep` (resident layout, Pallas kernel `_pcgs_kernel`) and
`fused_pcgs_sweep_streamed` (streamed layout, `_pcgs_stream_kernel`), in
their PCGS mode. Both launch the one kernel of `csrc/pcgs.cu` (one warp per
document; its header says what it computes and what bounds it on the
H100). The public functions keep the JAX signatures and shapes, with two
changes:

  - two extra operands, `doc_slot_offsets` int32 [D+1] and `doc_slots`
    int32 [N]: each document's real slots in the order the chunk-
    sequential sweep visits them (`corpus/ragged.py::doc_visit_order`,
    built once on the host from the layout);
  - `seed` is an int64 [1] tensor keying the in-kernel Philox4x32-10 (the
    kernel's uniforms are `ops/philox.py::philox_u24` words); `interpret`
    and the streamed kernel's `force_ktile` are TPU-only switches and are
    gone.

The collapsed (ADLDA) mode of the JAX functions (`nk_plus`, `beta`) keeps
N_kw / n_k live from one chunk to the next, which couples documents through
the chunk schedule; it is not ported here and raises NotImplementedError.

For CUDA tensors the wrappers launch the kernel (or raise); for CPU tensors
they run the plain versions `fused_pcgs_sweep_reference` /
`fused_pcgs_sweep_streamed_reference`, which work on any device: a
document-sequential sweep over the visit order, padded to [D, Lmax] and
stepped position by position with all documents at once, rounding where
the kernel rounds (the f32 table with +-1 updates, bf16 phi, a bf16
product, a 128-topic tiled f32 cdf with running tile offsets).
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox_u24

FLAG_ROWS = 8  # extra table rows; row kpad = doc-mask flag, rest zero
# largest K whose per-warp column + cdf rows (2 * kpad f32) fit one block's
# shared memory
MAX_TOPICS = (227 * 1024 // 8) // 128 * 128

_COLLAPSED = ("the collapsed (ADLDA) mode of the PCGS sweep (nk_plus / "
              "beta) is not ported yet: ROADMAP queue A, the ADLDA slice")


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


def fused_pcgs_sweep_reference(w3, d3, z_old, ndk_table, phi_vk, seed,
                               win_w, first_w, win_d_chunks,
                               doc_slot_offsets, doc_slots, u24=None, *,
                               nwin_w, nwin_d, vspan, dspan, num_topics,
                               positive_support=False):
    """Plain PyTorch version of `fused_pcgs_sweep` (resident layout)."""
    block = w3.shape[1] * w3.shape[2]
    win = win_w.to(torch.int64).repeat_interleave(block)
    return _sweep_reference(w3, z_old, ndk_table, phi_vk, seed, win,
                            doc_slot_offsets, doc_slots, u24,
                            nwin_w=nwin_w, vspan=vspan,
                            num_topics=num_topics,
                            positive_support=positive_support)


def fused_pcgs_sweep_streamed_reference(w3, d3, z_old, ndk_table, phi_vk,
                                        seed, ww_chunks, wd_chunks,
                                        doc_slot_offsets, doc_slots,
                                        u24=None, *, nwin_w, nwin_d, vspan,
                                        dspan, num_topics,
                                        positive_support=False):
    """Plain PyTorch version of `fused_pcgs_sweep_streamed`."""
    win = ww_chunks.to(torch.int64).repeat_interleave(w3.shape[2])
    return _sweep_reference(w3, z_old, ndk_table, phi_vk, seed, win,
                            doc_slot_offsets, doc_slots, u24,
                            nwin_w=nwin_w, vspan=vspan,
                            num_topics=num_topics,
                            positive_support=positive_support)


def check_sweep_operands(w3, d3, z_old, ndk_table, seed, win, win_len,
                         doc_slot_offsets, doc_slots, num_topics):
    """Check the operands a document-sequential sweep kernel shares (this
    module's and `cuda_lightlda`'s); returns (kpad, num_docs, dpad)."""
    dev = w3.device
    K = num_topics
    if not 0 < K <= MAX_TOPICS:
        raise ValueError(f"num_topics={K} outside the kernel's range "
                         f"(1..{MAX_TOPICS}: the per-warp n_dk column and "
                         "cdf must fit one block's shared memory)")
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


def _launch(w3, d3, z_old, ndk_table, phi_vk, seed, win, win_len, win_div,
            doc_slot_offsets, doc_slots, u24, *, nwin_w, vspan, num_topics,
            positive_support):
    """Check the operands, launch csrc/pcgs.cu, return its outputs."""
    dev = w3.device
    K = num_topics
    kpad, num_docs, dpad = check_sweep_operands(
        w3, d3, z_old, ndk_table, seed, win, win_len, doc_slot_offsets,
        doc_slots, K)
    _build.check_tensor("phi_vk", phi_vk, (phi_vk.shape[0], K),
                        torch.float32, dev)
    if u24 is not None:
        _build.check_tensor("u24", u24, tuple(w3.shape), device=dev)
    z = z_old.clone()
    nkw = torch.zeros((nwin_w * vspan, K), dtype=torch.int32, device=dev)
    table = ndk_table.clone()
    err = _build.library().lda_pcgs_sweep(
        w3.data_ptr(), z_old.data_ptr(), win.data_ptr(),
        doc_slot_offsets.data_ptr(), doc_slots.data_ptr(), phi_vk.data_ptr(),
        None if u24 is None else u24.data_ptr(), seed.data_ptr(),
        table.data_ptr(), z.data_ptr(), nkw.data_ptr(), num_docs, dpad,
        kpad, K, vspan, win_div, int(positive_support), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lda_pcgs_sweep")
    return z, nkw, table


def fused_pcgs_sweep(w3, d3, z_old, ndk_table, phi_vk, seed, win_w, first_w,
                     win_d_chunks, doc_slot_offsets, doc_slots, u24=None,
                     nk_plus=None, beta=None, *, nwin_w, nwin_d, vspan, dspan,
                     num_topics, positive_support=False):
    """One PCGS Gibbs sweep over the resident (w-window-major,
    sequential-safe) layout: draw z for every token with immediate n_dk
    updates, count N_kw, and return the updated n_dk table.

    w3 / d3 / z_old: int32 [NB, chunks, chunk] (window-local ids; sentinel
        vspan / dspan on padding slots).
    ndk_table: f32 [kpad + FLAG_ROWS, Dpad], (n_dk + alpha_k).T padded; row
        kpad = doc-mask flag (1.0 selected / 0.0 not). Not modified: the
        updated table is returned.
    phi_vk: f32 [V, K], fixed for the whole sweep.
    seed: int64 [1], the Philox key (ignored when u24 is given).
    win_w / first_w: int32 [NB] (first_w unused: N_kw starts zeroed).
    win_d_chunks: int32 [NB * chunks] (unused by the kernel: the slot
        lists carry the documents).
    doc_slot_offsets / doc_slots: int32 [D + 1] / [N], the visit order.
    u24: optional int32 [NB, chunks, chunk] of 24-bit uniforms in [0, 2^24)
        replacing the in-kernel Philox draw.
    positive_support: the conditional is positive for every topic (floored
        Dirichlet phi), so the draw clamps to K - 1 instead of the last
        nonzero topic.

    Returns (z int32 [NB, chunks, chunk], nkw int32 [nwin_w * vspan, K],
             table f32 [kpad + FLAG_ROWS, Dpad]).
    """
    if nk_plus is not None or beta is not None:
        raise NotImplementedError(_COLLAPSED)
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics,
              positive_support=positive_support)
    if w3.device.type == "cpu":
        return fused_pcgs_sweep_reference(
            w3, d3, z_old, ndk_table, phi_vk, seed, win_w, first_w,
            win_d_chunks, doc_slot_offsets, doc_slots, u24, nwin_d=nwin_d,
            dspan=dspan, **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, phi_vk, seed, win_w, nb,
                  chunks * chunk, doc_slot_offsets, doc_slots, u24, **kw)
    fused_pcgs_sweep.launches += 1
    return out


def fused_pcgs_sweep_streamed(w3, d3, z_old, ndk_table, phi_vk, seed,
                              ww_chunks, wd_chunks, doc_slot_offsets,
                              doc_slots, u24=None, nk_plus=None, beta=None,
                              *, nwin_w, nwin_d, vspan, dspan, num_topics,
                              positive_support=False):
    """One PCGS Gibbs sweep over the streamed (d-window-major `StreamBlocks`)
    layout; `ww_chunks` / `wd_chunks` are int32 [NB * chunks], the w- and
    d-window of every chunk. Operands and results otherwise as
    `fused_pcgs_sweep`."""
    if nk_plus is not None or beta is not None:
        raise NotImplementedError(_COLLAPSED)
    kw = dict(nwin_w=nwin_w, vspan=vspan, num_topics=num_topics,
              positive_support=positive_support)
    if w3.device.type == "cpu":
        return fused_pcgs_sweep_streamed_reference(
            w3, d3, z_old, ndk_table, phi_vk, seed, ww_chunks, wd_chunks,
            doc_slot_offsets, doc_slots, u24, nwin_d=nwin_d, dspan=dspan,
            **kw)
    nb, chunks, chunk = w3.shape
    out = _launch(w3, d3, z_old, ndk_table, phi_vk, seed, ww_chunks,
                  nb * chunks, chunk, doc_slot_offsets, doc_slots, u24, **kw)
    fused_pcgs_sweep_streamed.launches += 1
    return out


# launches of the kernel through each wrapper (added where it launches,
# nowhere else); chip_smoke.py reads them to show that the main path ran
# the kernel
fused_pcgs_sweep.launches = 0
fused_pcgs_sweep_streamed.launches = 0
