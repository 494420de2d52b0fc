"""Process group, mesh and collectives of the sharded schemes.

The port's counterpart of `ldagroupedgibbssampler_tpu/parallel/mesh.py`.
The JAX package runs a sharded scheme as one program over a `jax.sharding
.Mesh` of devices, with `psum` for the merges. The PyTorch idiom is one
process per rank under `torch.distributed`, with `all_reduce` for the
merges:

  - `distributed_initialize` starts the process group, from explicit
    arguments or from the `torchrun` environment; it is a no-op for one
    process, as in the JAX package. The backend is chosen, not
    configured: `nccl` when the device is CUDA and every rank of the node
    has a card of its own, else `gloo` (always on the CPU, and for two
    ranks sharing one card, which NCCL refuses).
  - `make_mesh` returns a `Mesh`: the group, this process's rank, the
    world size, the axis name and the backend. Without a process group it
    is the 1-rank mesh with no group, which is what the JAX default mesh is
    on one chip.
  - `psum` is an in-place all-reduce (sum); with no group it is the
    identity. A mesh with a group always runs the collective, so a 1-rank
    NCCL world goes through NCCL. `gather_rows` is an all-gather of rows.
    Both are counted in `collectives`.
  - `psum_counts` sums count tensors: in int16's bytes over NCCL where the
    totals fit (the JAX package's int16 n_dk psum), else in int32.
"""

from __future__ import annotations

import contextlib
import datetime
import math
import os
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

# how long a rank waits in init and in a collective before it raises, so
# that a peer that died never leaves it blocked for good
DEFAULT_TIMEOUT_S = 300.0


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks. `group` is None for the 1-rank mesh without a
    process group; `backend` is then None too."""
    group: Optional[Any]
    rank: int
    size: int
    axis_name: str
    backend: Optional[str]


def choose_backend(device: str, local_world_size: int) -> str:
    """"nccl" when `device` is CUDA and each of the node's
    `local_world_size` ranks has a card of its own, else "gloo"."""
    if (torch.device(device).type == "cuda" and torch.cuda.is_available()
            and local_world_size <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def distributed_initialize(coordinator_address=None, num_processes=None,
                           process_id=None, device: str = "cuda",
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group: at `coordinator_address` ("host:port")
    with `num_processes` ranks when they are given, else from the torchrun
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT). A no-op for
    one process (a 1-rank group is started with `dist.init_process_group`
    and `choose_backend` directly), or when the group is already up. On
    CUDA it makes `cuda:{LOCAL_RANK % device_count}` (LOCAL_RANK, else the
    rank) this process's device. Returns whether it started a group."""
    if dist.is_initialized():
        return False
    if num_processes is not None:
        world = int(num_processes)
        rank = int(process_id or 0)
        local_world = world
        init = f"tcp://{coordinator_address}"
    else:
        world = int(os.environ.get("WORLD_SIZE", 1))
        rank = int(os.environ.get("RANK", 0))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
        init = "env://"
    if world <= 1:
        return False
    if torch.device(device).type == "cuda" and torch.cuda.is_available():
        lr = (int(os.environ["LOCAL_RANK"]) if "LOCAL_RANK" in os.environ
              else rank)
        torch.cuda.set_device(lr % torch.cuda.device_count())
    dist.init_process_group(
        backend=choose_backend(device, local_world), init_method=init,
        world_size=world, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_mesh(shape=None, axis_names=("data",)) -> Mesh:
    """The 1-D mesh over every rank of the process group (the 1-rank mesh
    with no group when none is up). `shape` must multiply to the world
    size: the JAX package accepts any mesh up to the device count, but a
    rank here is a process, so the mesh is the world."""
    if dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        group, backend = dist.group.WORLD, dist.get_backend()
    else:
        size, rank, group, backend = 1, 0, None, None
    shape = tuple(int(s) for s in (shape or (size,)))
    if len(shape) != 1:
        raise ValueError(f"mesh shape {shape}: the sharded schemes run on "
                         "a 1-D mesh")
    if math.prod(shape) != size:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, the world has {size}")
    return Mesh(group=group, rank=rank, size=size,
                axis_name=tuple(axis_names)[0], backend=backend)


class CollectiveCounters:
    """What the collectives of this module moved: `calls` and `bytes`
    (each rank's own tensor, padded for a gather), and, inside `timed()`,
    a pair of CUDA events around each collective on a CUDA tensor. Set to
    0 and read like the kernels' launch counters (`models/fusion.py::
    launch_counters`), through `collective_counters()`."""

    def __init__(self):
        self.calls = 0
        self.bytes = 0
        self.events = None

    @contextlib.contextmanager
    def timed(self):
        """Collect CUDA event pairs, one around each collective run in the
        block; yields their list."""
        self.events = []
        try:
            yield self.events
        finally:
            self.events = None

    def run(self, op, t: torch.Tensor, group, out=None):
        """The collective `op` on `t` over `group`, counted: `op(t)`, or
        `op(out, t)` for a gather into the list `out`."""
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        args = (t,) if out is None else (out, t)
        if self.events is None or not t.is_cuda:
            op(*args, group=group)
            return
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        op(*args, group=group)
        b.record()
        self.events.append((a, b))


collectives = CollectiveCounters()


def collective_counters() -> list:
    """(object, attribute) of every collective counter, as
    `launch_counters` lists the kernels'."""
    return [(collectives, "calls"), (collectives, "bytes")]


def psum(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum `t` over the mesh, in place; returns `t`. gloo has no int16
    all-reduce and PyTorch's NCCL binding maps no int16 type, so an int16
    tensor is refused (`psum_counts` carries int16 counts). Counted in
    `collectives`."""
    if mesh.group is None:
        return t
    if t.dtype == torch.int16:
        raise TypeError(f"int16 all-reduce over {mesh.backend}: use "
                        "psum_counts")
    collectives.run(dist.all_reduce, t, mesh.group)
    return t


def count_reduce_dtype(mesh: Mesh, max_value: int) -> torch.dtype:
    """The dtype in which counts whose totals are at most `max_value` are
    summed over the mesh: int16 on NCCL when they fit (half the bytes, as
    the JAX package's n_dk psum), else int32 — always int32 over gloo."""
    if mesh.backend == "nccl" and max_value < 2 ** 15:
        return torch.int16
    return torch.int32


def psum_counts(t: torch.Tensor, mesh: Mesh, max_value: int) -> torch.Tensor:
    """The int32 sum over the mesh of the non-negative int32 counts `t`,
    whose totals are at most `max_value`, in `count_reduce_dtype`'s
    dtype. In int16 the counts travel in pairs, each pair as one int32
    (low half + 2^16 high half): every total is below 2^15, so no carry
    crosses from one half into the other and the sum of the pairs is the
    pair of the sums, at int16's bytes."""
    if count_reduce_dtype(mesh, max_value) == torch.int32:
        return psum(t, mesh)
    flat = t.reshape(-1).to(torch.int16)
    pairs = torch.zeros(flat.numel() + flat.numel() % 2, dtype=torch.int16,
                        device=t.device)
    pairs[: flat.numel()] = flat
    summed = psum(pairs.view(torch.int32), mesh).view(torch.int16)
    return summed[: flat.numel()].reshape(t.shape).to(torch.int32)


def gather_rows(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The ranks' `t` ([n_r, ...], n_r may differ) concatenated in rank
    order, on every rank: an all-gather of the sizes, then one of `t`
    padded to the largest. Counted in `collectives`."""
    if mesh.group is None:
        return t
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=t.device)
    sizes = [torch.empty_like(n) for _ in range(mesh.size)]
    collectives.run(dist.all_gather, n, mesh.group, sizes)
    sizes = [int(s) for s in sizes]
    pad = t.new_zeros((max(sizes), *t.shape[1:]))
    pad[: t.shape[0]] = t
    parts = [torch.empty_like(pad) for _ in range(mesh.size)]
    collectives.run(dist.all_gather, pad, mesh.group, parts)
    return torch.cat([p[:k] for p, k in zip(parts, sizes)])


def checksum(t: torch.Tensor) -> torch.Tensor:
    """Two int64 sums of `t`'s bit patterns (plain and position-weighted),
    int64 [2]: equal on two ranks when their tensors are bit-equal, except
    with negligible probability."""
    bits = t.contiguous().reshape(-1)
    if bits.element_size() == 4:
        bits = bits.view(torch.int32)
    bits = bits.to(torch.int64)
    weights = torch.arange(bits.numel(), device=bits.device) % 65521 + 1
    return torch.stack([bits.sum(), (bits * weights).sum()])


def replicated_mismatches(tensors: dict, mesh: Mesh) -> list:
    """Names of the tensors that are not bit-equal on every rank (compared
    by `checksum`). Empty on a 1-rank mesh."""
    if mesh.group is None or not tensors:
        return []
    names = sorted(tensors)
    sums = torch.stack([checksum(tensors[n]) for n in names])
    every = gather_rows(sums.reshape(1, -1), mesh).cpu().numpy()
    return [n for i, n in enumerate(names)
            if not np.all(every[:, 2 * i: 2 * i + 2] == every[0, 2 * i:
                                                              2 * i + 2])]
