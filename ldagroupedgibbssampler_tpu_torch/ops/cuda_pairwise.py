"""The elementwise pairwise metrics and the KS merge: the CUDA kernels and
their plain versions.

Counterpart of the XLA programs that the JAX package's
`ldagroupedgibbssampler_tpu/similarity/distances.py` fuses from an (M, N,
K) broadcast: `js`, `manhattan`, `chebychev`, `canberra`, `jaccard`, the
elementwise parts of `uber`, and the pairwise part of `ks`. The kernels
are `csrc/pairwise.cu` (its header gives each metric's arithmetic, what
bounds it on the H100 and the design):

  - `pairwise_elementwise(metric, X, Y, parts=None)`: one launch of a
    64 x 64 tile of pairs a block for `canberra` or `js` (a block whose
    values are all tame takes canberra's scaled division or js's closed
    form, any other the general terms), of a 128 x 64 tile for
    `manhattan`, `chebychev` or `jaccard` (`minmax_launch_shape`; a NaN
    reaches the result as in the plain versions, through max.NaN and
    min.NaN for the last two; a jaccard block of finite values in [0,
    2^32] sums only the minima and takes the union from its rows' sums),
    or of a 64 x 32 tile for
    `uber`, whose `parts` are the exact products' (M, N) matrices
    (cosine, euclidean, kl): the
    launch adds them to its four elementwise parts in the plain version's
    order and divides by 7;
  - `pairwise_ks(X, Y)`: X's and Y's rows sorted along K by `torch.sort`,
    then one launch of the merge walk, one thread a pair, ties taken in
    pairs, which ends once a row is exhausted;
  - `division_check(X, Y)`: not on any path; the terms on which the
    division of uber's and canberra's scaled blocks (csrc/pairwise.cu
    `div_rn_scaled`) would differ from an IEEE division, counted, for
    chip_smoke.py to hold it bit-equal.

Both take X [M, K] and Y [N, K], float32, contiguous, on one device, and
return float32 [M, N]; an empty M or N gives an empty [M, N] with no
launch. The plain versions: for the elementwise metrics the tiled blocks
of `similarity/distances.py` (`elementwise_reference`, the CPU's own
path), for `ks` `ks_merge_reference`, which repeats the kernel's merge on
sorted rows in PyTorch, a step for all pairs at a time, every pair for
all 2K steps; for `division_check` `division_check_reference`, the
division's arithmetic in float32, each fused multiply-add rounded once.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version. `similarity/distances.py` calls the
wrappers only for tensors off the CPU. Nothing here syncs with the host.
"""

from __future__ import annotations

import ctypes

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build

# csrc/pairwise.cu's Metric
METRICS = {"manhattan": 0, "chebychev": 1, "canberra": 2, "jaccard": 3,
           "js": 4, "uber": 5}
# uber's parts in the plain version's order (similarity/distances.py)
UBER_PARTS = ("canberra", "chebychev", "cosine", "euclidean", "jaccard",
              "kl", "manhattan")
UBER_PRODUCTS = ("cosine", "euclidean", "kl")


def _shapes(X, Y) -> tuple[int, int, int]:
    if X.dim() != 2 or Y.dim() != 2 or X.shape[1] != Y.shape[1]:
        raise ValueError(f"pairwise metrics take (M, K) and (N, K), got "
                         f"{tuple(X.shape)} and {tuple(Y.shape)}")
    if X.shape[1] == 0:
        raise ValueError("pairwise metrics need K >= 1")
    return X.shape[0], Y.shape[0], X.shape[1]


def _check(X, Y, M, N, K, parts=()):
    dev = X.device
    _build.check_tensor("X", X, (M, K), torch.float32, dev)
    _build.check_tensor("Y", Y, (N, K), torch.float32, dev)
    for name, p in zip(UBER_PRODUCTS, parts):
        _build.check_tensor(name, p, (M, N), torch.float32, dev)


def elementwise_reference(metric: str, X, Y, parts=None) -> torch.Tensor:
    """Plain version of the elementwise kernel: the metric's tiled blocks
    of `similarity/distances.py` on X's device; for `uber` with `parts`
    (the products' matrices) the seven parts summed in order, / 7."""
    from ldagroupedgibbssampler_tpu_torch.similarity import distances
    if metric != "uber" or parts is None:
        return distances.DISTANCES[metric].tiled(X, Y)
    given = dict(zip(UBER_PRODUCTS, parts))
    total = 0
    for name in UBER_PARTS:
        total = total + (given[name] if name in given
                         else distances.DISTANCES[name].tiled(X, Y))
    return total / float(len(UBER_PARTS))


def pairwise_elementwise(metric: str, X: torch.Tensor, Y: torch.Tensor,
                         parts=None) -> torch.Tensor:
    """`metric` of every pair of rows, float32 [M, N]; `parts` (uber only):
    its cosine, euclidean and kl [M, N] matrices."""
    if metric not in METRICS:
        raise ValueError(f"no elementwise kernel for {metric!r}; "
                         f"known: {sorted(METRICS)}")
    if (metric == "uber") != (parts is not None):
        raise ValueError("uber takes its three product matrices as parts; "
                         "no other metric takes parts")
    M, N, K = _shapes(X, Y)
    if X.device.type == "cpu":
        return elementwise_reference(metric, X, Y, parts)
    lib = _build.library()
    parts = tuple(parts or ())
    _check(X, Y, M, N, K, parts)
    dev = X.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    cos, euc, kl = (p.data_ptr() for p in parts) if parts else (None,) * 3
    err = lib.lda_pairwise_elementwise(
        X.data_ptr(), Y.data_ptr(), cos, euc, kl, out.data_ptr(), M, N, K,
        METRICS[metric], dev.index, _build.stream(dev))
    _build.check(err, "lda_pairwise_elementwise")
    pairwise_elementwise.launches += 1
    return out


def ks_merge_reference(X, Y) -> torch.Tensor:
    """Plain version of the KS kernel: the rows sorted, then the merge walk
    of csrc/pairwise.cu for every pair at once. Each of the 2K steps takes
    the smaller head (x on a tie); where the next head is larger than the
    value taken, the gap |i - j| counts. The largest gap / K, float32."""
    xs = torch.sort(torch.as_tensor(X, dtype=torch.float32), dim=-1).values
    ys = torch.sort(torch.as_tensor(Y, dtype=torch.float32, device=xs.device),
                    dim=-1).values
    m, k = xs.shape
    n = ys.shape[0]
    inf = torch.full((1,), float("inf"), device=xs.device)
    xs = torch.cat([xs, inf.expand(m, 1)], dim=1)             # [m, k + 1]
    ysT = torch.cat([ys, inf.expand(n, 1)], dim=1).T          # [k + 1, n]
    i = torch.zeros((m, n), dtype=torch.int64, device=xs.device)
    j = torch.zeros_like(i)
    xi, yj = xs.gather(1, i), ysT.gather(0, j)
    best = torch.zeros_like(i)
    for _ in range(2 * k):
        take = xi <= yj
        v = torch.where(take, xi, yj)
        i = i + take
        j = j + ~take
        xi = torch.where(take, xs.gather(1, i), xi)
        yj = torch.where(take, yj, ysT.gather(0, j))
        best = torch.where(torch.minimum(xi, yj) != v,
                           torch.maximum(best, (i - j).abs()), best)
    return best.to(torch.float32) / k


def pairwise_ks(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The two-sample KS statistic of every pair of rows, float32 [M, N]:
    the rows sorted once along K (torch.sort), then one launch of the
    merge."""
    M, N, K = _shapes(X, Y)
    if X.device.type == "cpu":
        return ks_merge_reference(X, Y)
    lib = _build.library()
    _check(X, Y, M, N, K)
    dev = X.device
    out = torch.empty((M, N), dtype=torch.float32, device=dev)
    if M == 0 or N == 0:
        return out
    xs = torch.sort(X, dim=1).values
    ys = torch.sort(Y, dim=1).values
    err = lib.lda_pairwise_ks(xs.data_ptr(), ys.data_ptr(), out.data_ptr(),
                              M, N, K, dev.index, _build.stream(dev))
    _build.check(err, "lda_pairwise_ks")
    pairwise_ks.launches += 1
    return out


# uber's scaled path (csrc/pairwise.cu): values within TAME_MAX are
# multiplied by UBER_SCALE, and |x| + |y| is raised to DEN_FLOOR
UBER_SCALE = 2.0 ** 64
TAME_MAX = 2.0 ** 32
DEN_FLOOR = 2.0 ** -100


def fma_f32(a, b, c) -> torch.Tensor:
    """a * b + c of float32 tensors rounded once to float32: the product
    exact in float64, the sum's rounding error by TwoSum, and a float64
    sum that falls exactly midway between two float32 values settled by
    that error's sign."""
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    r = s.float()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(s > r.double(), inf, -inf))
    tie = (s == (r.double() + nb.double()) / 2) & (err != 0)
    return torch.where(tie, torch.where(err > 0, torch.maximum(r, nb),
                                        torch.minimum(r, nb)), r)


def division_reference(a, b, seed=None) -> torch.Tensor:
    """csrc/pairwise.cu's `div_rn_scaled(a, b)` in float32: the reciprocal
    `seed` (default 1 / b rounded to nearest; the card's approximate
    reciprocal is within an ulp of it), one Newton step, the quotient,
    its remainder and one correction."""
    r = (1.0 / b.double()).float() if seed is None else seed
    r = fma_f32(r, fma_f32(-b, r, torch.ones_like(b)), r)
    q = (a.double() * r.double()).float()
    return fma_f32(r, fma_f32(-b, q, a), q)


def division_check_reference(X, Y) -> torch.Tensor:
    """Plain version of `division_check`: int64 [2], the (pair,
    coordinate) terms with both values within TAME_MAX, and those on which
    `division_reference` of uber's scaled operands differs in any bit from
    the IEEE quotient of the values (0 where |x| + |y| == 0)."""
    x = torch.as_tensor(X, dtype=torch.float32)[:, None, :]
    y = torch.as_tensor(Y, dtype=torch.float32, device=x.device)[None]
    tame = (x.abs() <= TAME_MAX) & (y.abs() <= TAME_MAX)
    den = x.abs() + y.abs()
    want = torch.where(den == 0, 0.0, (x - y).abs() / den)
    xs, ys = x * UBER_SCALE, y * UBER_SCALE
    got = division_reference((xs - ys).abs(),
                             (xs.abs() + ys.abs()).clamp_min(DEN_FLOOR))
    differ = tame & (got.view(torch.int32) != want.view(torch.int32))
    return torch.stack([tame.sum(), differ.sum()]).to(torch.int64)


def division_check(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """int64 [2]: the terms of X [M, K] and Y [N, K] with both values
    within TAME_MAX, and those on which uber's division differs from an
    IEEE division (both 0 for an empty M or N)."""
    M, N, K = _shapes(X, Y)
    if X.device.type == "cpu":
        return division_check_reference(X, Y)
    lib = _build.library()
    _check(X, Y, M, N, K)
    dev = X.device
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    if M == 0 or N == 0:
        return counts
    err = lib.lda_pairwise_division_check(
        X.data_ptr(), Y.data_ptr(), counts.data_ptr(), M, N, K, dev.index,
        _build.stream(dev))
    _build.check(err, "lda_pairwise_division_check")
    division_check.launches += 1
    return counts


def blocks_per_sm(K: int, device) -> tuple[int, int, int, int, int]:
    """(uber's kernel, the shared-memory KS kernel at this K, 0 above its
    largest K, the chebychev, the jaccard and the manhattan kernel): the
    blocks an SM of `device` can hold, from the CUDA occupancy
    calculator."""
    dev = torch.device(device)
    out = (ctypes.c_int * 5)()
    err = _build.library().lda_pairwise_blocks_per_sm(
        int(K), dev.index or 0, ctypes.addressof(out))
    _build.check(err, "lda_pairwise_blocks_per_sm")
    return tuple(out)


# csrc/pairwise.cu's minmax_kernel (manhattan, chebychev, jaccard): 16 x
# 16 threads, MINMAX_TM x rows and MINMAX_TN y rows a thread, a ring of
# MINMAX_STAGES chunks of MINMAX_CHUNK coordinates (rows MINMAX_LD floats
# apart); where the tiles fill at most half the SMs, a cluster of up to
# MINMAX_MAX_SPLIT blocks (as many as fit one wave) splits each tile's
# chunks
MINMAX_TM, MINMAX_TN = 8, 4
MINMAX_CHUNK = 32
MINMAX_LD = MINMAX_CHUNK + 4
MINMAX_STAGES = 3
MINMAX_MAX_SPLIT = 4
H100_SMS = 132


def minmax_thread_rows(t: int, n: int) -> list[int]:
    """The n rows of the block's tile that thread coordinate t (its ty for
    its MINMAX_TM x rows, its tx for its MINMAX_TN y rows) takes: t, t +
    16, t + 32, ..."""
    return [t + 16 * i for i in range(n)]


def minmax_launch_shape(M: int, N: int, K: int, sms: int = H100_SMS
                        ) -> dict:
    """The manhattan, chebychev and jaccard kernel's launch at (M, N, K)
    on a card of `sms` SMs: its grid (blocks along N, along M, and the K
    split along z, one cluster a tile), threads, x and y rows a thread,
    the block's tile of pairs, the lengths of its chunks (the last one
    runs to K), each split's chunks [c0, c1) in rank order, and its
    dynamic shared memory (the ring of chunks of the block's rows)."""
    tm, tn = MINMAX_TM, MINMAX_TN
    rows_m, rows_n = 16 * tm, 16 * tn
    gx, gy = -(-N // rows_n), -(-M // rows_m)
    chunks = [min(MINMAX_CHUNK, K - k0) for k0 in range(0, K, MINMAX_CHUNK)]
    splits = min(max(sms // (gx * gy), 1), MINMAX_MAX_SPLIT, len(chunks))
    n = len(chunks)
    return {"grid": (gx, gy, splits), "threads": 256,
            "thread_rows": (tm, tn), "tile": (rows_m, rows_n),
            "chunks": chunks,
            "split_chunks": [(q * n // splits, (q + 1) * n // splits)
                             for q in range(splits)],
            "shared_bytes": MINMAX_STAGES * (rows_m + rows_n) * MINMAX_LD
            * 4}


# launches of the kernels (added where they launch, nowhere else);
# chip_smoke.py reads them to show that the apps ran the kernels
pairwise_elementwise.launches = 0
pairwise_ks.launches = 0
division_check.launches = 0
