"""Fused GGS z-draw + N_kw: the CUDA kernel and its plain version.

Counterpart of `ldagroupedgibbssampler_tpu/ops/pallas_zdraw.py`
(`fused_zdraw_nkw`, Pallas kernel `_zdraw_kernel`). The kernel is
`csrc/zdraw.cu` (one warp per slot, direct row gathers, warp scan and
ballot count; its header says what bounds it on the H100). The public
function keeps the JAX function's signature and layout-A block shapes;
the TPU-only `stream_theta` and `interpret` switches are gone, and `seed`
is an int64 [1] tensor on the device (drawn from the sampler's
`torch.Generator`) that keys the in-kernel Philox4x32-10.

Per slot: p_k = theta[d, k] * phi[w, k]; z = min(#{k : cdf_k <= u}, K-1)
with u = u24 * 2^-24 * total; z_old is kept when total == 0 (padding
slots, and tokens of documents whose theta row the caller zeroed); N_kw of
the output z is counted for every slot with w_local < vspan.

`fused_zdraw_nkw` launches the kernel for CUDA tensors and runs the plain
version, `fused_zdraw_nkw_reference`, for CPU tensors. The plain version
draws the same Philox words as the kernel, so the two agree slot for slot
except where a cdf summed in another order crosses u (a tie at a float
boundary).
"""

from __future__ import annotations

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build

_MASK32 = 0xFFFFFFFF
_PHILOX_M0, _PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
_PHILOX_W0, _PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
# largest K whose per-warp cdf row fits the kernel's shared memory
MAX_TOPICS = 227 * 1024 // 4


def _mulhilo32(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for uint32 values held in int64:
    the 64-bit product is split through 16-bit halves of m so nothing
    overflows int64."""
    lo = (x * m) & _MASK32              # int64 wraps mod 2^64: low bits hold
    hi = (x * (m >> 16) + ((x * (m & 0xFFFF)) >> 16)) >> 16
    return hi & _MASK32, lo


def philox4x32_10(counter_lo: torch.Tensor, counter_hi: torch.Tensor,
                  key_lo: torch.Tensor, key_hi: torch.Tensor):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    words; counter (counter_lo, counter_hi, 0, 0), key (key_lo, key_hi).
    Returns the four output words. Matches `philox_word0` in csrc/zdraw.cu
    for the first word."""
    c0, c1 = counter_lo & _MASK32, counter_hi & _MASK32
    c2 = torch.zeros_like(c0)
    c3 = torch.zeros_like(c0)
    k0, k1 = key_lo & _MASK32, key_hi & _MASK32
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W0) & _MASK32
            k1 = (k1 + _PHILOX_W1) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M0, c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_u24(seed: torch.Tensor, num: int) -> torch.Tensor:
    """The kernel's in-kernel uniforms: top 24 bits of the first Philox word
    at counter = slot index, key = the 64-bit seed. int32 [num]."""
    s = seed.reshape(1).to(torch.int64)
    slot = torch.arange(num, dtype=torch.int64, device=seed.device)
    w0, _, _, _ = philox4x32_10(slot, slot >> 32, s & _MASK32,
                                (s >> 32) & _MASK32)
    return (w0 >> 8).to(torch.int32)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _table(x: torch.Tensor, precise: bool) -> torch.Tensor:
    """The table values the kernel multiplies: bf16 (round to nearest
    even), or bf16 hi + bf16 lo rebuilt in f32 in precise mode."""
    x = x.to(torch.float32)
    hi = _bf16(x)
    return hi + _bf16(x - hi) if precise else hi


def fused_zdraw_nkw_reference(w3, d3, z_old, theta_dk, phi_vk, seed, win_w,
                              first_w, win_d_chunks, u24=None, *, nwin_w,
                              nwin_d, vspan, dspan, num_topics,
                              precise=False):
    """Plain PyTorch version of the kernel on any device: gathers the
    [slots, K] score rows, cumsum, and counts cdf <= u. Memory is
    O(slots * K); it is the reference, not a fast path."""
    nb, chunks, chunk = w3.shape
    dev = w3.device
    num_docs, num_types = theta_dk.shape[0], phi_vk.shape[0]
    w = w3.reshape(-1).to(torch.int64)
    d = d3.reshape(-1).to(torch.int64)
    zo = z_old.reshape(-1)
    wrow = win_w.to(torch.int64).repeat_interleave(chunks * chunk) * vspan + w
    drow = (win_d_chunks.to(torch.int64).repeat_interleave(chunk) * dspan
            + d)
    w_ok = (w >= 0) & (w < vspan)
    valid = (w_ok & (d >= 0) & (d < dspan) & (wrow < num_types)
             & (drow < num_docs))
    th = _table(theta_dk, precise)[drow.clamp(0, num_docs - 1)]
    ph = _table(phi_vk, precise)[wrow.clamp(0, num_types - 1)]
    probs = th * ph
    if not precise:
        probs = _bf16(probs)
    probs = torch.where(valid[:, None], probs, 0.0)
    cdf = torch.cumsum(probs, dim=1)
    total = cdf[:, -1]
    if u24 is None:
        u24 = philox_u24(seed, w.numel())
    u = u24.reshape(-1).to(torch.float32) * (2.0 ** -24) * total
    cnt = (cdf <= u[:, None]).sum(dim=1)
    z_new = cnt.clamp(max=num_topics - 1).to(torch.int32)
    z = torch.where(total > 0, z_new, zo)
    nkw = torch.zeros((nwin_w * vspan, num_topics), dtype=torch.int32,
                      device=dev)
    r = wrow[w_ok]
    nkw.index_put_((r, z[w_ok].to(torch.int64)),
                   torch.ones_like(r, dtype=torch.int32), accumulate=True)
    return z.reshape(nb, chunks, chunk), nkw


def fused_zdraw_nkw(w3, d3, z_old, theta_dk, phi_vk, seed, win_w, first_w,
                    win_d_chunks, u24=None, *, nwin_w, nwin_d, vspan, dspan,
                    num_topics, precise=False):
    """Draw z for every token slot and count N_kw in one pass.

    w3 / d3 / z_old: int32 [NB, chunks, chunk] layout-A token rows
        (window-local ids; sentinel vspan / dspan on padding slots).
    theta_dk: f32 [D, K] — rows of unselected docs must be pre-zeroed.
    phi_vk:   f32 [V, K].
    seed: int64 [1], the Philox key (ignored when u24 is given).
    win_w / first_w: int32 [NB] (first_w unused: N_kw starts zeroed).
    win_d_chunks: int32 [NB * chunks].
    u24: optional int32 [NB, chunks, chunk] of 24-bit uniforms in
        [0, 2^24) replacing the in-kernel Philox draw (the tests' path).

    Returns (z int32 [NB, chunks, chunk], nkw int32 [nwin_w * vspan, K]).
    """
    if w3.device.type == "cpu":
        return fused_zdraw_nkw_reference(
            w3, d3, z_old, theta_dk, phi_vk, seed, win_w, first_w,
            win_d_chunks, u24, nwin_w=nwin_w, nwin_d=nwin_d, vspan=vspan,
            dspan=dspan, num_topics=num_topics, precise=precise)
    nb, chunks, chunk = w3.shape
    dev = w3.device
    num_docs, num_types = theta_dk.shape[0], phi_vk.shape[0]
    if not 0 < num_topics <= MAX_TOPICS:
        raise ValueError(f"num_topics={num_topics} outside the kernel's "
                         f"range (1..{MAX_TOPICS})")
    shape3 = (nb, chunks, chunk)
    for name, t in (("w3", w3), ("d3", d3), ("z_old", z_old)):
        _build.check_tensor(name, t, shape3, device=dev)
    _build.check_tensor("theta_dk", theta_dk, (num_docs, num_topics),
                        torch.float32, dev)
    _build.check_tensor("phi_vk", phi_vk, (num_types, num_topics),
                        torch.float32, dev)
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)
    _build.check_tensor("win_w", win_w, (nb,), device=dev)
    _build.check_tensor("win_d_chunks", win_d_chunks, (nb * chunks,),
                        device=dev)
    if u24 is not None:
        _build.check_tensor("u24", u24, shape3, device=dev)
    z = torch.empty(shape3, dtype=torch.int32, device=dev)
    nkw = torch.zeros((nwin_w * vspan, num_topics), dtype=torch.int32,
                      device=dev)
    err = _build.library().lda_zdraw_nkw(
        w3.data_ptr(), d3.data_ptr(), z_old.data_ptr(), theta_dk.data_ptr(),
        phi_vk.data_ptr(), win_w.data_ptr(), win_d_chunks.data_ptr(),
        None if u24 is None else u24.data_ptr(), seed.data_ptr(),
        z.data_ptr(), nkw.data_ptr(), nb * chunks * chunk, chunks * chunk,
        chunk, vspan, dspan, num_topics, num_docs, num_types, int(precise),
        dev.index, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lda_zdraw_nkw")
    fused_zdraw_nkw.launches += 1
    return z, nkw


# launches of the kernel (added where it launches, nowhere else);
# chip_smoke.py reads it to show that the main path ran the kernel
fused_zdraw_nkw.launches = 0
