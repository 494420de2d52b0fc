"""The left-to-right held-out estimator: the CUDA kernel and its plain
version.

Counterpart of the XLA program of the JAX package's
`ldagroupedgibbssampler_tpu/evaluation/marginal.py::
left_to_right_from_word_prob` (one `lax.scan` over token positions). The
kernel is `csrc/left_to_right.cu` (its header gives the arithmetic, the
draw, what bounds it on the H100 and the design): the position loop runs
inside it, the dense prefix of alpha_k wp[w, k] computed once a position
for all particles, each particle's nonzero counts a sorted list in shared
memory searched in topic order; a second launch sums the particles'
probabilities into the total.

The draw is an inverse CDF from one 24-bit Philox uniform per (position t,
particle r, document d), keyed by `seed` (an int64 [1] tensor on the
device) at counter d * 2^40 + t * 2^20 + r. `left_to_right_reference`
draws the same words through `ops/philox.py` over [R, D, K] tensors, so the
kernel agrees with it on every z but where u T lies on a cdf value summed
in another order (a tie), and on the total to float rounding. Both move a
draw whose product is 0 (a rounding tie) to the last topic below it whose
product is not. The wrapper
runs it for CPU tensors; on a CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

_EPS = 1e-30
_MASK32 = 0xFFFFFFFF
# the counter's fields: d * 2^40 + t * 2^20 + r
MAX_DOCS, MAX_POSITIONS, MAX_PARTICLES = 1 << 23, 1 << 20, 1 << 20
# dynamic shared memory a block of the kernel may take (two blocks an SM)
SHARED_BUDGET = 112 * 1024
SHARED_LIMIT = 232_448
MIN_WARPS, MAX_WARPS = 4, 16
STEP = 4                    # list entries a run (kStep)
TOPICS_A_WARP = 512         # the dense prefix: at most 16 chunks a warp
_TOTALS = 2 * 32            # the kernel's warp totals and warp sums


class LaunchShape(NamedTuple):
    groups: int        # G: blocks a document
    particles: int     # Rb: particles a block
    warps: int         # W: warps a block
    row_buffers: int   # word-row buffers: 2 (the next row prefetched), 1
    capacity: int      # list entries a particle: min(K, L)
    shared_bytes: int  # dynamic shared memory a block
    wide_entries: bool  # (topic, count) in 32 + 32 bits (else 16 + 16)


def launch_shape(num_topics: int, num_particles: int,
                 length: int) -> LaunchShape:
    """The kernel's launch for K topics, R particles and documents padded
    to `length` positions: two word-row buffers and the dense prefix (K
    floats each) beside each particle's list of min(K, length) (topic,
    count) entries, the list's running sum after every STEP-th entry and
    its length; one word-row buffer where two and one particle's list do
    not fit the card's shared memory; as many particles a block as fit
    SHARED_BUDGET, spread evenly over the groups; a thread a particle, at
    least MIN_WARPS warps and one a TOPICS_A_WARP topics, up to
    MAX_WARPS."""
    kp = -(-num_topics // 4) * 4
    wide = num_topics > 1 << 16 or length >= 1 << 16
    entry = 8 if wide else 4
    cap = max(1, min(num_topics, length))
    per_particle = cap * entry + 4 * (cap // STEP) + 4
    for bufs in (2, 1):
        fixed = 4 * ((bufs + 1) * kp + _TOTALS)
        fit = max(1, (SHARED_BUDGET - fixed) // per_particle)
        groups = -(-num_particles // fit)
        rb = -(-num_particles // groups)
        groups = -(-num_particles // rb)
        smem = (fixed + 4 * (-(-rb // 4) * 4)
                + rb * (cap * entry + 4 * (cap // STEP)))
        if smem <= SHARED_LIMIT:
            break
    else:
        raise ValueError(f"K={num_topics}: a word row and one particle's "
                         f"list need {smem} B of shared memory, above "
                         f"{SHARED_LIMIT}")
    warps = min(MAX_WARPS, max(MIN_WARPS, -(-rb // 32),
                               -(-num_topics // TOPICS_A_WARP)))
    return LaunchShape(groups, rb, warps, bufs, cap, smem, wide)


def _u24(seed: torch.Tensor, t: int, num_particles: int,
         num_docs: int) -> torch.Tensor:
    """The kernel's uniforms of position t: int64 [R, D] of 24 bits."""
    dev = seed.device
    r = torch.arange(num_particles, dtype=torch.int64, device=dev)[:, None]
    d = torch.arange(num_docs, dtype=torch.int64, device=dev)[None, :]
    ctr = (d << 40) | (t << 20) | r
    s = seed.reshape(1).to(torch.int64)
    return philox4x32_10(ctr, ctr >> 32, s & _MASK32,
                         (s >> 32) & _MASK32)[0] >> 8


def _off_zero(z, counts, alpha, wrow):
    """The kernel's repair of a draw whose s_z = (c_z + alpha_z) wp[w, z]
    is 0 (where u T rounds up to T, or, in the kernel, where the dense
    prefix's rounding puts u T between two equal cdf values): z moves to
    the last topic at or below it with s > 0. z [R, D], counts [R, D, K],
    wrow [D, K]."""
    d = torch.arange(z.shape[1], device=z.device)[None, :].expand_as(z)
    sz = (counts.gather(-1, z[..., None])[..., 0] + alpha[z]) * wrow[d, z]
    zero = sz == 0
    if not bool(zero.any()):
        return z
    r, d = zero.nonzero(as_tuple=True)
    s = (counts[r, d] + alpha) * wrow[d]                          # [n, K]
    k = torch.arange(s.shape[1], device=z.device)
    cand = torch.where((s > 0) & (k <= z[r, d][:, None]), k, -1).amax(-1)
    z = z.clone()
    z[r, d] = torch.where(cand >= 0, cand, z[r, d])
    return z


def left_to_right_reference(w_pad, mask_pad, word_prob, alpha,
                            num_particles: int, seed: torch.Tensor,
                            return_z: bool = False):
    """Plain PyTorch version of the kernel on word_prob's device: w_pad /
    mask_pad [D, L], word_prob [K, V], alpha [K] (or a float), seed int64
    [1]. Returns the total held-out LL (0-d float32) and, with `return_z`,
    the draws as int32 [L, R, D] (-1 at positions that are not real)."""
    dev = word_prob.device
    w_pad = torch.as_tensor(w_pad, device=dev).to(torch.int64)
    mask_pad = torch.as_tensor(mask_pad, device=dev).to(torch.bool)
    seed = seed.to(dev)
    num_docs, length = w_pad.shape
    num_topics = word_prob.shape[0]
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    alpha = alpha.expand(num_topics).contiguous()
    alpha_sum = alpha.sum()
    wpt = word_prob.to(torch.float32).T.contiguous()           # [V, K]
    counts = torch.zeros((num_particles, num_docs, num_topics),
                         dtype=torch.float32, device=dev)
    n = torch.zeros(num_docs, dtype=torch.float32, device=dev)
    ll = torch.zeros(num_docs, dtype=torch.float32, device=dev)
    zs = []
    for t in range(length):
        wt, mt = w_pad[:, t], mask_pad[:, t]
        cdf = torch.cumsum((counts + alpha) * wpt[wt][None, :, :], dim=-1)
        total = cdf[..., -1]                                     # [R, D]
        p = total / (n + alpha_sum)
        ll = ll + torch.where(mt, torch.log(p.mean(dim=0) + _EPS), 0.0)
        u = (_u24(seed, t, num_particles, num_docs).to(torch.float32)
             * 2.0 ** -24 * total)
        z = (cdf <= u[..., None]).sum(dim=-1).clamp(max=num_topics - 1)
        del cdf
        z = _off_zero(z, counts, alpha, wpt[wt])
        counts.scatter_add_(-1, z[..., None],
                            mt[None, :, None].expand(num_particles, -1, 1)
                            .to(torch.float32))
        n = n + mt.to(torch.float32)
        if return_z:
            zs.append(torch.where(mt[None, :], z, -1).to(torch.int32))
    total = ll.sum()
    if not return_z:
        return total
    z_all = (torch.stack(zs) if zs else torch.zeros(
        (0, num_particles, num_docs), dtype=torch.int32, device=dev))
    return total, z_all


def left_to_right(w_pad, mask_pad, word_prob, alpha, num_particles: int,
                  seed: torch.Tensor, z_out: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """Total held-out LL (0-d float32 tensor) of the padded test documents
    w_pad / mask_pad [D, L] under word_prob [K, V], with `num_particles`
    particles, on word_prob's device. seed: int64 [1] on that device.
    `z_out`: optional int32 [L, R, D] that receives every draw (checks
    only; positions that are not real keep their value)."""
    dev = word_prob.device
    if dev.type == "cpu":
        if z_out is None:
            return left_to_right_reference(w_pad, mask_pad, word_prob, alpha,
                                           num_particles, seed)
        total, z = left_to_right_reference(w_pad, mask_pad, word_prob, alpha,
                                           num_particles, seed, True)
        z_out.copy_(torch.where(z >= 0, z, z_out))
        return total
    return _left_to_right_kernel(w_pad, mask_pad, word_prob, alpha,
                                 num_particles, seed, z_out)


def _left_to_right_kernel(w_pad, mask_pad, word_prob, alpha, num_particles,
                          seed, z_out):
    lib = _build.library()
    dev = word_prob.device
    w_pad = torch.as_tensor(w_pad, device=dev).to(torch.int32).contiguous()
    mask_pad = torch.as_tensor(mask_pad, device=dev).to(
        torch.bool).contiguous()
    num_docs, length = w_pad.shape
    num_topics = word_prob.shape[0]
    if not (num_docs < MAX_DOCS and length < MAX_POSITIONS
            and 0 < num_particles < MAX_PARTICLES):
        raise ValueError(f"D={num_docs}, L={length}, R={num_particles}: the "
                         f"draw counter takes D < {MAX_DOCS}, L < "
                         f"{MAX_POSITIONS}, 0 < R < {MAX_PARTICLES}")
    shape = launch_shape(num_topics, num_particles, length)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=dev)
    alpha = alpha.expand(num_topics).contiguous()
    wpt = word_prob.to(torch.float32).T.contiguous()             # [V, K]
    _build.check_tensor("mask_pad", mask_pad, (num_docs, length),
                        torch.bool, dev)
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)
    if z_out is not None:
        _build.check_tensor("z_out", z_out,
                            (length, num_particles, num_docs), torch.int32,
                            dev)
    psum = torch.empty((num_docs, length, shape.groups), dtype=torch.float32,
                       device=dev)
    total = torch.empty((1,), dtype=torch.float32, device=dev)
    err = lib.lda_left_to_right(
        w_pad.data_ptr(), mask_pad.data_ptr(), wpt.data_ptr(),
        alpha.data_ptr(), seed.data_ptr(), psum.data_ptr(),
        None if z_out is None else z_out.data_ptr(), total.data_ptr(),
        num_docs, length, num_topics, num_particles, shape.groups,
        shape.particles, shape.warps, shape.row_buffers, shape.shared_bytes,
        int(shape.wide_entries), dev.index, _build.stream(dev))
    _build.check(err, "lda_left_to_right")
    left_to_right.launches += 2
    return total[0]


# launches of the kernels (two a call: the particles, then the total),
# added where they launch and nowhere else; chip_smoke.py reads them
left_to_right.launches = 0
