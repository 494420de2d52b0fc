"""Fused Marsaglia-Tsang Gamma and Dirichlet draws: the CUDA kernels and
their plain versions.

Counterpart of the XLA program that the JAX package's
`ldagroupedgibbssampler_tpu/ops/random.py` fuses from `_gamma_marsaglia`
(6 unrolled rejection rounds, then the u^(1/a) boost for a < 1) and
`dirichlet` (the floor at DIRICHLET_FLOOR and the normalisation). The
kernels are `csrc/gamma.cu` (its header gives the arithmetic, what bounds
it on the H100 and the design): `gamma` draws Gamma(a, 1) elementwise in
one launch; `dirichlet` draws, floors and normalises over the last axis in
one launch, a block a tile of whole rows (`row_tile`; two launches where
fewer than LONG_ROWS_BELOW rows of at least LONG_CHUNK values, or rows
longer than ROW_MAX, are split across blocks), or over axis 0 of a matrix
in two, a block a tile of rows and columns (`col_tile`). Every kernel
draws round 0 for each element of its tile and the later rounds over a
queue of the rejected ones.

The random words are Philox4x32-10 blocks keyed by `seed`, an int64 [1]
tensor on the device (drawn by the caller from its torch.Generator, so a
captured CUDA graph replays new draws), at counter 8 i + r for element i
(flat index) and round r = 0..5, the boost at 8 i + 6. `gamma_reference`
and `dirichlet_reference` draw the same words through `ops/philox.py` and
repeat the kernel's f32 arithmetic op for op, so the kernel can be held to
them element for element: they differ only by the math library's last
bits, and where a round's accept test is that close to a tie, by the
round. They are slow (7 Philox blocks an element) and serve as the plain
versions: the wrappers run them for CPU tensors. The port's draws on the
CPU (`ops/random.py`) keep their generator path and never call them.

On a CUDA tensor each wrapper launches its kernel or raises: a failed
build, a failed launch and an operand the kernel does not take all raise.
Nothing here syncs with the host, so the draws can be captured.

`vs_dirichlet` (csrc/vs_dirichlet.cu) is the variable-selection Dirichlet
of `nzvsspalias` on the same draws: element i's Gamma at gamma.cu's
counters and its inclusion uniform from the block 8 i + 7 that the Gamma
leaves, one launch, a row split over a thread-block cluster of up to
VS_CLUSTER_MAX blocks (`vs_launch_shape`); `vs_dirichlet_reference` is its
plain version.
"""

from __future__ import annotations

import math

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build
from ldagroupedgibbssampler_tpu_torch.ops.philox import philox4x32_10

ROUNDS = 6                  # fixed rejection rounds
BLOCKS_PER_ELEMENT = 8      # Philox counters an element: rounds, boost
TILE = 1024                 # elements a block of the elementwise Gamma
ROW_TILE = 1024             # elements of whole rows a block draws (at least
ROW_MAX = 4096              # one row, of at most ROW_MAX)
LONG_CHUNK = 2048           # elements a block of a split long row
# a last-axis Dirichlet with fewer rows splits its rows across blocks
LONG_ROWS_BELOW = 4096
COL_TILE_COLS = 128         # axis 0: columns of a block's tile (all of a
                            # row up to this, else this: kColTileCols), its
COL_TILE = (2048, 4096)     # elements, the row count set so that there are
COL_TILES = 1024            # at most COL_TILES tiles down the rows if it can
DIRICHLET_FLOOR = 1e-30     # ops/random.py's (kFloor in csrc/gamma.cu)
VS_CLUSTER_MAX = 8          # blocks a row of the VS kernel (a cluster)
VS_SLICE_MIN = 2048         # values a block of it takes at least
VS_CHUNK = 2560             # its slice's draws at most a chunk at a time
VS_SMEM = 200 * 1024        # dynamic shared memory a block may take
_TWO_PI = 2.0 * math.pi
_MASK32 = 0xFFFFFFFF


def _unit23(word: torch.Tensor) -> torch.Tensor:
    """(top 23 bits + 1/2) * 2^-23 of uint32 words held in int64: in (0, 1)
    and exact in f32."""
    return ((word >> 9).to(torch.float32) + 0.5) * 2.0 ** -23


def _words(seed: torch.Tensor, counter: torch.Tensor):
    """Philox words at `counter` under `seed`: one key, or keys broadcast
    against the counters (a batch of rows, each its own draw)."""
    s = seed.to(torch.int64)
    s = s.reshape(1) if s.numel() == 1 else s
    return philox4x32_10(counter, counter >> 32, s & _MASK32,
                         (s >> 32) & _MASK32)


def mt_round(d, c, seed, counter):
    """One Marsaglia-Tsang round of the draws with (d, c) from the Philox
    blocks at `counter` (int64, per element): (accepted, d v)."""
    w = _words(seed, counter)
    x = (torch.sqrt(-2.0 * torch.log(_unit23(w[0])))
         * torch.cos(_TWO_PI * _unit23(w[1])))
    v1 = 1.0 + c * x
    v = v1 * v1 * v1
    ok = (v > 0) & (torch.log(_unit23(w[2])) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.where(v > 0, v, 1.0)))
    return ok, d * v


def mt_setup(a):
    """(d, c) of shapes a (float32)."""
    d = torch.where(a < 1.0, a + 1.0, a) - (1.0 / 3.0)
    return d, torch.rsqrt(9.0 * d)


def mt_boost(a, g, seed, base):
    """g times the a < 1 boost exp(log(ub) / a), ub from the Philox block
    at base + ROUNDS; g where a >= 1."""
    ub = _unit23(_words(seed, base + ROUNDS)[0])
    tiny = torch.finfo(torch.float32).tiny
    return g * torch.where(a < 1.0, torch.exp(torch.log(ub)
                                             / a.clamp_min(tiny)), 1.0)


def gamma_reference(a, seed, return_rounds: bool = False):
    """Plain PyTorch version of the Gamma kernel on a's device: Gamma(a, 1)
    float32 of a's shape from the kernel's Philox words. With
    `return_rounds`, also each element's accepted round (int32; ROUNDS
    where every round rejected and the mode d was kept)."""
    a = torch.as_tensor(a).to(torch.float32)
    flat = a.reshape(-1)
    dev = flat.device
    seed = seed.to(dev)
    base = torch.arange(flat.numel(), dtype=torch.int64,
                        device=dev) * BLOCKS_PER_ELEMENT
    d, c = mt_setup(flat)
    out = d.clone()
    rounds = torch.full(flat.shape, ROUNDS, dtype=torch.int32, device=dev)
    for r in range(ROUNDS):
        ok, g = mt_round(d, c, seed, base + r)
        new = ok & (rounds == ROUNDS)
        out = torch.where(new, g, out)
        rounds = torch.where(new, r, rounds)
    out = mt_boost(flat, out, seed, base).reshape(a.shape)
    return (out, rounds.reshape(a.shape)) if return_rounds else out


def _shapes(x, prior) -> torch.Tensor:
    """The Gamma shapes: x itself, or x (counts) as float32 + prior."""
    x = torch.as_tensor(x)
    return x.to(torch.float32) if prior is None else x.to(torch.float32) + prior


def dirichlet_reference(x, seed, dim: int = -1, prior=None) -> torch.Tensor:
    """Plain PyTorch version of the Dirichlet kernels: gamma_reference of
    the shapes (x, or x as float32 + prior), floored at DIRICHLET_FLOOR and
    normalised over `dim`."""
    g = gamma_reference(_shapes(x, prior), seed).clamp_min(DIRICHLET_FLOOR)
    return g / g.sum(dim=dim, keepdim=True)


def row_tile(num_cols: int) -> int:
    """Rows a block of the one-launch last-axis Dirichlet draws."""
    return max(1, ROW_TILE // num_cols)


def col_tile(num_rows: int, num_cols: int) -> tuple[int, int]:
    """(rows, columns) of a block's tile in the axis-0 Dirichlet's first
    launch: COL_TILE_COLS columns at most, between COL_TILE[0] and
    COL_TILE[1] elements, enough rows that the column sums of at most
    COL_TILES tiles meet in the second launch where that fits."""
    tc = min(num_cols, COL_TILE_COLS)
    lo, hi = (max(1, n // tc) for n in COL_TILE)
    return min(max(-(-num_rows // COL_TILES), lo), hi), tc


def _check_seed(seed, dev):
    _build.check_tensor("seed", seed, (1,), torch.int64, dev)


def gamma(a: torch.Tensor, seed: torch.Tensor,
          rounds: torch.Tensor | None = None) -> torch.Tensor:
    """Gamma(a, 1) draws, float32 of a's shape. a: float tensor; seed:
    int64 [1] on a's device. `rounds`: optional int32 tensor of a's shape
    that receives each element's accepted round (checks only)."""
    if a.device.type == "cpu":
        out, r = gamma_reference(a, seed, return_rounds=True)
        if rounds is not None:
            rounds.copy_(r)
        return out
    return _gamma_kernel(a, seed, rounds)


def _gamma_kernel(a, seed, rounds):
    lib = _build.library()
    dev = a.device
    a = a.to(torch.float32).contiguous()
    _check_seed(seed, dev)
    if rounds is not None:
        _build.check_tensor("rounds", rounds, a.shape, torch.int32, dev)
    out = torch.empty_like(a)
    if a.numel() == 0:
        return out
    err = lib.lda_gamma(a.data_ptr(), seed.data_ptr(), out.data_ptr(),
                        None if rounds is None else rounds.data_ptr(),
                        a.numel(), dev.index, _build.stream(dev))
    _build.check(err, "lda_gamma")
    gamma.launches += 1
    return out


def dirichlet(x: torch.Tensor, seed: torch.Tensor, dim: int = -1,
              prior=None) -> torch.Tensor:
    """Dirichlet draws normalised over `dim`: the last axis, or axis 0 of a
    matrix. The shapes are x (float concentrations) or, with `prior`, x
    (integer counts) as float32 + prior, where prior is a float or a
    tensor of x.shape[-1] values along the last axis. seed: int64 [1] on
    x's device. Returns float32 of x's shape, every coordinate floored at
    DIRICHLET_FLOOR before the normalisation."""
    if x.device.type == "cpu":
        return dirichlet_reference(x, seed, dim, prior)
    return _dirichlet_kernel(x, seed, dim, prior)


def _dirichlet_kernel(x, seed, dim, prior):
    lib = _build.library()
    dev = x.device
    nd = x.dim()
    dim = dim % max(nd, 1)
    if nd == 0 or not (dim == nd - 1 or (nd == 2 and dim == 0)):
        raise ValueError(f"the Dirichlet kernel normalises the last axis or "
                         f"axis 0 of a matrix, not axis {dim} of {nd}")
    _check_seed(seed, dev)
    last = x.shape[-1]
    counts, prior_vec, prior_val = 0, None, 0.0
    if prior is not None and (x.dtype.is_floating_point
                              or x.dtype == torch.bool):
        x, prior = _shapes(x, prior), None
    if prior is None:
        x = x.to(torch.float32).contiguous()
    else:
        counts = 1
        x = x.to(torch.int32).contiguous()
        if isinstance(prior, torch.Tensor):
            prior_vec = (prior.to(device=dev, dtype=torch.float32)
                         .expand(last).contiguous())
        else:
            prior_val = float(prior)
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    if x.numel() == 0:
        return out
    pv = None if prior_vec is None else prior_vec.data_ptr()
    stream = _build.stream(dev)
    rows = x.numel() // last
    if dim == nd - 1 and (last > ROW_MAX or (rows < LONG_ROWS_BELOW
                                             and last >= LONG_CHUNK)):
        partial = torch.empty((rows, -(-last // LONG_CHUNK)),
                              dtype=torch.float32, device=dev)
        err = lib.lda_dirichlet_long_rows(
            x.data_ptr(), counts, pv, prior_val, seed.data_ptr(),
            out.data_ptr(), partial.data_ptr(), rows, last, dev.index,
            stream)
        _build.check(err, "lda_dirichlet_long_rows")
        dirichlet.launches += 2
        return out
    if dim == nd - 1:
        err = lib.lda_dirichlet_rows(
            x.data_ptr(), counts, pv, prior_val, seed.data_ptr(),
            out.data_ptr(), rows, last, row_tile(last), dev.index, stream)
        _build.check(err, "lda_dirichlet_rows")
        dirichlet.launches += 1
        return out
    rows = x.shape[0]
    tr, tc = col_tile(rows, last)
    partial = torch.empty((-(-rows // tr), last), dtype=torch.float32,
                          device=dev)
    err = lib.lda_dirichlet_cols(
        x.data_ptr(), counts, pv, prior_val, seed.data_ptr(), out.data_ptr(),
        partial.data_ptr(), rows, last, tr, tc, dev.index, stream)
    _build.check(err, "lda_dirichlet_cols")
    dirichlet.launches += 2
    return out


def vs_launch_shape(num_cols: int) -> tuple:
    """The VS kernel's geometry for rows of num_cols values: (blocks a
    cluster, slice length, values drawn together, values of a slice kept
    in shared memory, bytes of dynamic shared memory a block). A row goes
    to one cluster, a block a slice of at least VS_SLICE_MIN values (fewer
    blocks for short rows, at most VS_CLUSTER_MAX); rank r takes [r
    slice, min((r + 1) slice, L)), drawn a chunk of at most VS_CHUNK
    values at a time (the whole slice where it fits: fewer barriers).
    Beside the kept values a block holds a chunk's reject queue, draws
    (int32, f32) and list of included values (uint16). A slice longer than
    the shared memory holds keeps its first whole chunks there and the
    rest in the output, read back for the division."""
    cluster = max(1, min(VS_CLUSTER_MAX, -(-num_cols // VS_SLICE_MIN)))
    slice_len = -(-num_cols // cluster)
    chunk = min(slice_len, VS_CHUNK)
    resident = min(slice_len, (VS_SMEM - 10 * chunk) // 4)
    if resident < slice_len:
        resident = resident // chunk * chunk
    return cluster, slice_len, chunk, resident, 4 * resident + 10 * chunk


def vs_uniforms(shape, seed, device=None) -> torch.Tensor:
    """The VS-Dirichlet's inclusion uniforms: element i's is unit23 of
    word x of Philox block 8 i + 7, the one its Gamma draw leaves."""
    n = math.prod(shape)
    base = torch.arange(n, dtype=torch.int64, device=device)
    return _unit23(_words(seed.to(device), base * BLOCKS_PER_ELEMENT
                          + ROUNDS + 1)[0]).reshape(shape)


def vs_dirichlet_reference(counts, beta: float, vs_prior: float, seed,
                           previous_phi=None, zero_mask: bool = False):
    """Plain PyTorch version of the VS-Dirichlet kernel: per row, n_k
    (summed in f64) and zeroPhi (the exact zeros of `previous_phi`, none
    without it) give p = ops/random.py::vs_inclusion_prob; element i draws
    g = gamma_reference's Gamma(count + beta), floored, and is kept where
    count > 0 or its uniform (`vs_uniforms`) is at most p; the kept ones
    are divided by max(their f64 sum, DIRICHLET_FLOOR). Returns (phi, the
    mask of excluded coordinates, or None)."""
    from ldagroupedgibbssampler_tpu_torch.ops.random import vs_inclusion_prob
    counts = torch.as_tensor(counts).to(torch.float32)
    dev = counts.device
    n_k = counts.double().sum(dim=-1, keepdim=True).to(torch.float32)
    if previous_phi is None:
        zero_phi = torch.zeros_like(n_k)
    else:
        zero_phi = (torch.as_tensor(previous_phi).to(dev) == 0.0).sum(
            dim=-1, keepdim=True).to(torch.float32)
    p = vs_inclusion_prob(zero_phi, n_k, beta, vs_prior)
    g = gamma_reference(counts + beta, seed).clamp_min(DIRICHLET_FLOOR)
    include = (counts > 0) | (vs_uniforms(counts.shape, seed, dev) <= p)
    g = torch.where(include, g, 0.0)
    total = g.double().sum(dim=-1, keepdim=True).to(torch.float32)
    return (g / total.clamp_min(DIRICHLET_FLOOR),
            ~include if zero_mask else None)


def vs_dirichlet(counts: torch.Tensor, beta: float, vs_prior: float,
                 seed: torch.Tensor, previous_phi: torch.Tensor | None = None,
                 zero_mask: bool = False):
    """VS-Dirichlet rows over the last axis of counts (int32 counts, or
    floats): the vectorised form of ops/random.py::vs_dirichlet, zeroPhi
    from `previous_phi` (f32 of counts' shape; None: no zeros). One
    launch, a row a cluster of blocks (`vs_launch_shape`). Returns (phi
    f32 of counts' shape, the bool mask of excluded coordinates where
    `zero_mask`, else None)."""
    if counts.device.type == "cpu":
        return vs_dirichlet_reference(counts, beta, vs_prior, seed,
                                      previous_phi, zero_mask)
    lib = _build.library()
    dev = counts.device
    if counts.dim() == 0:
        raise ValueError("vs_dirichlet draws rows: counts needs an axis")
    ints = not counts.dtype.is_floating_point
    x = (counts.to(torch.int32) if ints
         else counts.to(torch.float32)).contiguous()
    _check_seed(seed, dev)
    if previous_phi is not None:
        previous_phi = previous_phi.to(torch.float32).contiguous()
        _build.check_tensor("previous_phi", previous_phi, x.shape,
                            torch.float32, dev)
    last = x.shape[-1]
    out = torch.empty(x.shape, dtype=torch.float32, device=dev)
    zero = (torch.empty(x.shape, dtype=torch.bool, device=dev)
            if zero_mask else None)
    if x.numel() == 0:
        return out, zero
    log_odds = float(torch.tensor(math.log(vs_prior) - math.log1p(-vs_prior),
                                  dtype=torch.float32))
    err = lib.lda_vs_dirichlet(
        x.data_ptr(), int(ints), float(beta),
        None if previous_phi is None else previous_phi.data_ptr(),
        seed.data_ptr(), out.data_ptr(),
        None if zero is None else zero.data_ptr(), x.numel() // last, last,
        *vs_launch_shape(last), float(vs_prior), log_odds, dev.index,
        _build.stream(dev))
    _build.check(err, "lda_vs_dirichlet")
    vs_dirichlet.launches += 1
    return out, zero


# launches of the kernels (added where they launch, nowhere else; the
# axis-0 Dirichlet is two launches); chip_smoke.py reads them to show that
# the main path ran the kernels
gamma.launches = 0
dirichlet.launches = 0
vs_dirichlet.launches = 0
