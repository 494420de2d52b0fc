"""Distance metrics over topic/probability vectors, on torch tensors.

The port's counterpart of `ldagroupedgibbssampler_tpu/similarity/
distances.py`, a redesign of the reference's ``cc.mallet.similarity``
package (similarity/Distance.java:3-5 and the 15 sibling metric files),
whose ``double calculate(double[] v1, double[] v2)`` scores one pair at a
time. Every metric here maps ``(M, K) × (N, K) -> (M, N)`` float32; the
scalar `calculate` is the (1, K)×(1, K) case.

Semantics (the reference's, quirks included, as in the JAX package):
  - `kl` is the *symmetrised* KL of MALLET `Maths.klDivergence` in log base
    2, with zero-coordinate terms dropped (p_i == 0 or q_i == 0 contributes
    nothing) — similarity/KLDistance.java:4-10.
  - `js` is built from that symmetrised KL against the average
    (JensenShannonDistance.java:6-13).
  - `cosine` returns 1 - cos_sim (similarity/CosineDistance.java).
  - `hellinger` is the reference's *squared* Hellinger-style sum without
    the 1/2 factor (similarity/HellingerDistance.java).
  - `bhattacharyya` is the Gaussian-approximation Bhattacharyya distance of
    similarity/BhattacharyyaDistance.java (moments of the coordinates, not
    the BC coefficient, with its var2/var2 == 1 term).
  - `jaccard` returns 0 when the intersection is empty (reference quirk,
    similarity/JaccardDistance.java:13-17).
  - `statistical` is 1 - Pearson correlation (similarity/StatisticalDistance.java).
  - `ks` is the two-sample Kolmogorov-Smirnov statistic on the coordinate
    *samples* (commons-math semantics), `t` Welch's two-sample t statistic.
  - `uber` averages canberra/chebychev/cosine/euclidean/jaccard/kl/manhattan
    (similarity/UberDistance.java:5-13).
Variances are written with an explicit `correction=` (ddof): 0 in
`bhattacharyya` and `statistical`, 1 in `t`, as `jnp.var` and commons-math
compute them (`torch.var` defaults to 1).

Memory. The JAX package writes the elementwise metrics as (M, N, K)
broadcasts that XLA fuses away; eager PyTorch would materialise them, and
at 5,635 × 5,634 × 100 one float32 intermediate is 12.7 GB. On a tensor
off the CPU the seven elementwise metrics (js, manhattan, chebychev,
canberra, jaccard, ks and uber's elementwise parts) are hand-written
kernels (`ops/cuda_pairwise.py`, `csrc/pairwise.cu`): one launch for the
whole (M, N) result, no tile and no (m, n, K) intermediate. On the CPU
each runs over tiles of X's rows × Y's rows whose (m, n, K)
intermediates stay within `WORKING_SET_BYTES`; an output entry depends
only on its own pair of rows, so the tiles give the untiled result, and
the tiles are the kernels' plain version (`metric.tiled`). `kl` needs no
tile: it is two matrix products,

    D(P || Q) = ((P · log'P) @ [Q > 0]ᵀ − P @ log'Qᵀ) / ln 2,
    log'x = log x for x > 0, else 0,

which drop exactly the terms with p_k = 0 or q_k = 0.

Products (hellinger, euclidean, cosine, statistical, kl) run with TF32 off
whatever the process's `torch.backends.cuda.matmul.allow_tf32` is, and the
flag is put back after: hellinger and euclidean cancel |x|² + |y|² − 2x·y,
which a 10-bit mantissa leaves ~1e-3 wrong for near-equal vectors.

The metric functions run on the device of their first argument;
`Distance` and `pairwise` move their inputs to the device they are given
(default "cuda", an error without a CUDA device).
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.ops import cuda_pairwise
from ldagroupedgibbssampler_tpu_torch.utils.device import resolve_device

_LOG2 = float(np.log(2.0))

# The most bytes of (m, n, K) float32 intermediates one tile of a metric
# holds at once on the CPU (a metric declares how many such intermediates
# it keeps alive); the card's kernels make none. 1 GiB keeps the
# 20NG-scale test × train matrix (5,635 × 5,634, K=100) at ~60 rows a tile
# for `js`.
WORKING_SET_BYTES = 1 << 30


def _as2d(v, device=None) -> torch.Tensor:
    v = torch.as_tensor(v, dtype=torch.float32, device=device)
    return v[None, :] if v.ndim == 1 else v


@contextlib.contextmanager
def exact_matmul():
    """float32 matrix products at full precision inside the block (TF32
    off); the caller's setting is restored on exit."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dot(a, b):
    """a @ bᵀ in full float32."""
    with exact_matmul():
        return a @ b.T


def _tiled(temps: int, kernel=None):
    """Make `block(x [m, K], y [n, K]) -> [m, n]` a metric over whole
    inputs, run over tiles whose `temps` (m, n, K) float32 intermediates
    fit WORKING_SET_BYTES (`temps` 0: one call, no intermediate of that
    shape). The block stays reachable as `metric.block`, the tiled
    evaluation of two 2-D tensors on one device as `metric.tiled`. With a
    `kernel`, a tensor off the CPU goes to it instead
    (`ops/cuda_pairwise.py`: one launch, no tile, no (m, n, K)
    intermediate); the tiles are the CPU's path and the kernel's plain
    version."""
    def wrap(block):
        def tiled(X, Y):
            if temps == 0:
                return metric.block(X, Y)
            M, N, K = X.shape[0], Y.shape[0], X.shape[1]
            per_pair = temps * 4 * max(K, 1)
            n = max(1, min(N, WORKING_SET_BYTES // per_pair))
            m = max(1, min(M, WORKING_SET_BYTES // (per_pair * n)))
            out = torch.empty((M, N), dtype=torch.float32, device=X.device)
            for i in range(0, M, m):
                for j in range(0, N, n):
                    out[i:i + m, j:j + n] = metric.block(X[i:i + m],
                                                         Y[j:j + n])
            return out

        @functools.wraps(block)
        def metric(X, Y):
            X = _as2d(X)
            Y = _as2d(Y, X.device)
            if kernel is not None and X.device.type != "cpu":
                return kernel(X.contiguous(), Y.contiguous())
            return tiled(X, Y)
        metric.block = block
        metric.temps = temps
        metric.tiled = tiled
        return metric
    return wrap


def _on_card(name: str):
    """The elementwise kernel of metric `name` (csrc/pairwise.cu)."""
    return lambda X, Y: cuda_pairwise.pairwise_elementwise(name, X, Y)


def _log0(v):
    """log v where v > 0, else 0."""
    return torch.where(v > 0, v, 1.0).log()


# ---------------------------------------------------------------------------
# pairwise metrics: X (M, K), Y (N, K) -> (M, N)
# ---------------------------------------------------------------------------

@_tiled(temps=0)
def kl_divergence_pairwise(X, Y):
    """Asymmetric MALLET-style KL (base 2, zero terms dropped): D(X_i || Y_j),
    as two products (module docstring)."""
    px = torch.where(X > 0, X, 0.0)
    return (_dot(px * _log0(X), (Y > 0).to(torch.float32))
            - _dot(px, _log0(Y))) / _LOG2


@_tiled(temps=0)
def kl(X, Y):
    """Symmetrised KL: (D(x||y) + D(y||x)) / 2 (KLDistance.java:6-9)."""
    return (kl_divergence_pairwise(X, Y)
            + kl_divergence_pairwise(Y, X).T) / 2.0


@_tiled(temps=6, kernel=_on_card("js"))
def js(X, Y):
    """Jensen-Shannon built from the symmetrised KL against the average a,
    exactly as JensenShannonDistance.java:6-13: (skl(p, a) + skl(q, a)) / 2,
    where skl(p, a) = sum over p_k, a_k > 0 of (p - a)(log p - log a)
    / (2 ln 2)."""
    x, y = X[:, None, :], Y[None, :, :]
    a = (x + y) / 2.0
    la = _log0(a)

    def skl(p):
        ok = (p > 0) & (a > 0)
        return torch.where(ok, (p - a) * (_log0(p) - la), 0.0).sum(-1)
    return (skl(x) + skl(y)) / (4.0 * _LOG2)


@_tiled(temps=0)
def hellinger(X, Y):
    # sum (sqrt(x)-sqrt(y))^2 = |sx|^2 + |sy|^2 - 2 sx.sy
    return (X.sum(-1)[:, None] + Y.sum(-1)[None, :]
            - 2.0 * _dot(X.sqrt(), Y.sqrt()))


@_tiled(temps=0)
def euclidean(X, Y):
    sq = ((X * X).sum(-1)[:, None] + (Y * Y).sum(-1)[None, :]
          - 2.0 * _dot(X, Y))
    return sq.clamp_min(0.0).sqrt()


@_tiled(temps=2, kernel=_on_card("manhattan"))
def manhattan(X, Y):
    return (X[:, None, :] - Y[None, :, :]).abs().sum(-1)


@_tiled(temps=2, kernel=_on_card("chebychev"))
def chebychev(X, Y):
    return (X[:, None, :] - Y[None, :, :]).abs().amax(-1)


@_tiled(temps=5, kernel=_on_card("canberra"))
def canberra(X, Y):
    num = (X[:, None, :] - Y[None, :, :]).abs()
    den = X.abs()[:, None, :] + Y.abs()[None, :, :]
    return torch.where(den == 0.0, 0.0, num / den).sum(-1)


@_tiled(temps=0)
def cosine(X, Y):
    nx = (X * X).sum(-1).sqrt()[:, None]
    ny = (Y * Y).sum(-1).sqrt()[None, :]
    return 1.0 - _dot(X, Y) / (nx * ny)


@_tiled(temps=3, kernel=_on_card("jaccard"))
def jaccard(X, Y):
    inter = torch.minimum(X[:, None, :], Y[None, :, :]).sum(-1)
    union = torch.maximum(X[:, None, :], Y[None, :, :]).sum(-1)
    return torch.where(inter > 0.0, 1.0 - inter / union, 0.0)


@_tiled(temps=0)
def bhattacharyya(X, Y):
    m1, m2 = X.mean(-1)[:, None], Y.mean(-1)[None, :]
    v1 = X.var(-1, correction=0)[:, None]
    v2 = Y.var(-1, correction=0)[None, :]
    # reference formula incl. its var2/var2 == 1 term
    # (BhattacharyyaDistance.java:8-14)
    t1 = torch.log(0.25 * (v1 / v2 + 1.0 + 2.0))
    t2 = (m1 - m2) ** 2 / (v1 + v2)
    return 0.25 * t1 + 0.25 * t2


@_tiled(temps=0)
def statistical(X, Y):
    """-(corr - 1) = 1 - Pearson correlation (StatisticalDistance.java:5-8)."""
    Xc = X - X.mean(-1, keepdim=True)
    Yc = Y - Y.mean(-1, keepdim=True)
    cov = _dot(Xc, Yc) / X.shape[-1]
    sx = (Xc * Xc).mean(-1).sqrt()[:, None]
    sy = (Yc * Yc).mean(-1).sqrt()[None, :]
    return 1.0 - cov / (sx * sy)


@_tiled(temps=12,
        kernel=lambda X, Y: cuda_pairwise.pairwise_ks(X, Y))
def ks(X, Y):
    """Two-sample KS statistic treating coordinates as samples
    (KolmogorovSmirnovDistance.java via commons-math): the largest
    |F_x(g) - F_y(g)| over the pooled sample g. Each pair's 2K values are
    sorted with +1 for x and -1 for y; the running sum at the last of each
    run of equal values is (#x <= g) - (#y <= g)."""
    m, n, k = X.shape[0], Y.shape[0], X.shape[1]
    v = torch.cat([X[:, None, :].expand(m, n, k),
                   Y[None, :, :].expand(m, n, k)], -1)
    v, order = v.sort(-1)
    step = torch.cat([torch.ones(k, dtype=torch.int32, device=X.device),
                      -torch.ones(k, dtype=torch.int32, device=X.device)])
    gap = step[order].cumsum(-1, dtype=torch.int32).abs()
    last = torch.ones_like(v, dtype=torch.bool)
    last[..., :-1] = v[..., 1:] != v[..., :-1]
    return torch.where(last, gap, 0).amax(-1).to(torch.float32) / k


@_tiled(temps=0)
def t_statistic(X, Y):
    """Unpaired two-sample t statistic with unequal variances
    (TDistance.java via commons-math TTest.t)."""
    k = X.shape[-1]
    m1, m2 = X.mean(-1)[:, None], Y.mean(-1)[None, :]
    # commons-math uses the bias-corrected sample variance
    v1 = X.var(-1, correction=1)[:, None]
    v2 = Y.var(-1, correction=1)[None, :]
    return (m1 - m2) / torch.sqrt(v1 / k + v2 / k)


_UBER_PARTS = (canberra, chebychev, cosine, euclidean, jaccard, kl,
               manhattan)


def _uber_on_card(X, Y):
    """uber off the CPU: cosine, euclidean and kl as the exact products,
    then one launch for the four elementwise parts and the mean."""
    return cuda_pairwise.pairwise_elementwise(
        "uber", X, Y, parts=(cosine(X, Y), euclidean(X, Y), kl(X, Y)))


@_tiled(temps=max(p.temps for p in _UBER_PARTS), kernel=_uber_on_card)
def uber(X, Y):
    """Mean of 7 metrics (UberDistance.java:5-19)."""
    parts = [p.block(X, Y) for p in _UBER_PARTS]
    return sum(parts) / float(len(parts))


DISTANCES = {
    "kl": kl,
    "js": js,
    "hellinger": hellinger,
    "euclidean": euclidean,
    "manhattan": manhattan,
    "chebychev": chebychev,
    "canberra": canberra,
    "cosine": cosine,
    "jaccard": jaccard,
    "bhattacharyya": bhattacharyya,
    "statistical": statistical,
    "ks": ks,
    "t": t_statistic,
    "uber": uber,
}


class Distance:
    """Parity shim for the Java ``Distance`` interface
    (similarity/Distance.java:3-5): scalar `calculate` plus the batched
    `pairwise`, on `device` (default "cuda")."""

    def __init__(self, name: str, device="cuda"):
        if name not in DISTANCES:
            raise ValueError(f"unknown distance {name!r}; "
                             f"known: {sorted(DISTANCES)}")
        self.name = name
        self.device = resolve_device(device)
        self._fn = DISTANCES[name]

    def calculate(self, v1, v2) -> float:
        return float(self._fn(_as2d(v1, self.device),
                              _as2d(v2, self.device))[0, 0])

    def pairwise(self, X, Y) -> np.ndarray:
        return self._fn(_as2d(X, self.device),
                        _as2d(Y, self.device)).cpu().numpy()


def pairwise(name: str, X, Y, device="cuda") -> torch.Tensor:
    """DISTANCES[name] over (M, K) × (N, K) -> (M, N), on `device`."""
    dev = resolve_device(device)
    return DISTANCES[name](_as2d(X, dev), _as2d(Y, dev))
