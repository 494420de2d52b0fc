"""Windowed (id, label) count histogram: the CUDA kernel and its plain
version.

Counterpart of `ldagroupedgibbssampler_tpu/ops/pallas_counts.py`
(`blocked_label_counts`, Pallas kernel `_count_kernel`). The kernel is
`csrc/label_counts.cu` (its header says what bounds it on the H100 and
why it has two instances). The signature and block layout are the JAX
function's, so the two compare like with like:

    N[win[b] * vspan + w_local[b, j], labels[b, j]] += 1  for w_local < vspan

`blocked_label_counts` launches the kernel for CUDA tensors and runs the
plain version, `blocked_label_counts_reference`, for CPU tensors. There is
no fallback on a CUDA tensor: a tensor the kernel does not take raises.
`count_instance` picks the kernel's instance from the shapes alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ldagroupedgibbssampler_tpu_torch.ops import _build

# opt-in shared memory of one H100 thread block (bytes); the kernel's
# launch refuses a histogram above the card's own limit
SHARED_LIMIT = 232_448
# the largest count a 16-bit shared counter holds
COUNTER_MAX = 0xFFFF
# most layout blocks one CTA of the shared instance takes
RUN_BLOCKS = 2


class CountInstance(NamedTuple):
    kind: str          # "shared" or "global"
    shared_bytes: int  # dynamic shared memory a CTA (0 for "global")
    run_blocks: int    # layout blocks a CTA (0 for "global")


def count_instance(vspan: int, num_labels: int, block: int) -> CountInstance:
    """The instance of csrc/label_counts.cu for these shapes: "shared" (a
    window's [vspan, num_labels] histogram in shared memory, two 16-bit
    counters a word) where it fits the opt-in shared memory and a block
    fits a 16-bit counter, else "global" (one global atomic a slot). A
    CTA's run of blocks is cut so that no counter can pass COUNTER_MAX
    between two flushes."""
    smem = 4 * ((vspan * num_labels + 1) // 2)
    if smem > SHARED_LIMIT or block > COUNTER_MAX:
        return CountInstance("global", 0, 0)
    return CountInstance("shared", smem,
                         max(1, min(RUN_BLOCKS, COUNTER_MAX // block)))


def launch_shape(vspan: int, num_labels: int, block: int):
    """(instance, threads a CTA, dynamic shared bytes a CTA, CTAs resident
    on one SM) of the kernel's launch at these shapes (needs the built
    library)."""
    inst = count_instance(vspan, num_labels, block)
    out = torch.zeros(2, dtype=torch.int64)
    _build.check(_build.library().lda_label_counts_launch_shape(
        inst.run_blocks, inst.shared_bytes, out.data_ptr()),
        "lda_label_counts_launch_shape")
    return inst.kind, int(out[0]), inst.shared_bytes, int(out[1])


def blocked_label_counts_reference(w_local, labels, win, first=None, *,
                                   nwin, vspan, num_labels):
    """Plain PyTorch histogram (index_put_ with accumulation) on any
    device. `first` is accepted for signature parity and not needed: the
    output starts zeroed."""
    rows = win.to(torch.int64)[:, None] * vspan + w_local.to(torch.int64)
    valid = w_local < vspan
    out = torch.zeros((nwin * vspan, num_labels), dtype=torch.int32,
                      device=w_local.device)
    r = rows[valid]
    out.index_put_((r, labels[valid].to(torch.int64)),
                   torch.ones_like(r, dtype=torch.int32), accumulate=True)
    return out


def blocked_label_counts(w_local, labels, win, first, *, nwin, vspan,
                         num_labels):
    """Histogram over (global id, label) from aligned sorted blocks.

    w_local [NB, B] int32: window-local ids in [0, vspan), sentinel `vspan`
        on padding slots (never counted).
    labels  [NB, B] int32 in [0, num_labels).
    win     [NB] int32: window id of each block, nondecreasing.
    first   [NB] int32: 1 on the first block of each window (unused here).

    Returns int32 [nwin * vspan, num_labels]; slice to the real id count.
    """
    if w_local.device.type == "cpu":
        return blocked_label_counts_reference(
            w_local, labels, win, first, nwin=nwin, vspan=vspan,
            num_labels=num_labels)
    nb, block = w_local.shape
    dev = w_local.device
    _build.check_int32_extent(slots=nb * block,
                              counts=nwin * vspan * num_labels)
    _build.check_tensor("w_local", w_local, (nb, block), device=dev)
    _build.check_tensor("labels", labels, (nb, block), device=dev)
    _build.check_tensor("win", win, (nb,), device=dev)
    inst = count_instance(vspan, num_labels, block)
    out = torch.zeros((nwin * vspan, num_labels), dtype=torch.int32,
                      device=dev)
    err = _build.library().lda_label_counts(
        w_local.data_ptr(), labels.data_ptr(), win.data_ptr(),
        nb * block, block, vspan, num_labels, inst.run_blocks,
        inst.shared_bytes, out.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "lda_label_counts")
    blocked_label_counts.launches += 1
    return out


# launches of the kernel (added where it launches, nowhere else);
# chip_smoke.py reads it to show that the main path ran the kernel
blocked_label_counts.launches = 0
