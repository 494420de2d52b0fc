"""The elementwise pairwise metrics and the KS merge: the CUDA kernels and
their plain versions.

Counterpart of the XLA programs that the JAX package's
`ldagroupedgibbssampler_tpu/similarity/distances.py` fuses from an (M, N,
K) broadcast: `js`, `manhattan`, `chebychev`, `canberra`, `jaccard`, the
elementwise parts of `uber`, and the pairwise part of `ks`. The kernels
are `csrc/pairwise.cu` (its header gives each metric's arithmetic, what
bounds it on the H100 and the design):

  - `pairwise_elementwise(metric, X, Y, parts=None)`: one launch of a
    64 x 64 tile of pairs a block for `manhattan`, `chebychev`,
    `canberra`, `jaccard`, `js` or `uber`; for `uber`, `parts` are the
    exact products' (M, N) matrices (cosine, euclidean, kl), and the
    launch adds them to its four elementwise parts in the plain version's
    order and divides by 7;
  - `pairwise_ks(X, Y)`: X's and Y's rows sorted along K by `torch.sort`,
    then one launch of the merge walk, one thread a pair.

Both take X [M, K] and Y [N, K], float32, contiguous, on one device, and
return float32 [M, N]; an empty M or N gives an empty [M, N] with no
launch. The plain versions: for the elementwise metrics the tiled blocks
of `similarity/distances.py` (`elementwise_reference`, the CPU's own
path), for `ks` `ks_merge_reference`, which repeats the kernel's merge on
sorted rows in PyTorch, a step for all pairs at a time.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain version. `similarity/distances.py` calls the
wrappers only for tensors off the CPU. Nothing here syncs with the host.
"""

from __future__ import annotations

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


# launches of the kernels (added where they launch, nowhere else);
# chip_smoke.py reads them to show that the apps ran the kernels
pairwise_elementwise.launches = 0
pairwise_ks.launches = 0
