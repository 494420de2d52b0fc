"""Iteration fusion (config key `scan_chunk`): a group of event-free
iterations of a sampler's `_step`, captured once as a CUDA graph on the
card and replayed for every later group of the same size.

The port's counterpart of the JAX base's `_get_fused_steps_jit`
(`ldagroupedgibbssampler_tpu/models/base.py:323-335`), which runs a group
as one `lax.scan` over the jitted step. The base's `sample()` decides which
iterations form a group (`_fusable_chunk`, `_fusable_span`, copied from the
JAX base); this module runs a group. A replay launches the whole group's
kernels from one host call, so the host no longer dispatches the hundreds
of small launches of each iteration. The chain is bit-equal to
single-stepping:

  - Static buffers. Each `_step` assigns fresh tensors to the state's
    fields (z, ndk, nkw, nk, phi, theta). The captured region reads them
    from static buffers and ends by copying its outputs into the same
    buffers; between replays the state's fields are those buffers. Before
    a group, whatever an unfused iteration replaced is copied in.
  - Random bits. Every draw of a step, the kernels' Philox seeds included,
    comes from the chain's `torch.Generator`, which is registered with
    each graph: a replay takes the generator's offset as it stands and
    advances it by the captured draws, so a replay draws what the same
    iterations draw single-stepped.
  - Warm-up. Before a capture, one eager step on a copy of the state loads
    every kernel; the generator's state and the launch counters are put
    back, and the state's tensors are never written, so the warm-up
    leaves no trace in the chain.
  - Values frozen at capture. `state.beta` (a Python float handed to the
    kernels) and the `state.alpha` tensor are baked into a graph; the
    graphs are dropped when either changes, and one `FusedSteps` lives for
    one `sample()` call only.
  - Launch counters. No Python runs under a replay, so the counts that a
    capture added (`launch_counters`) are taken back and added again at
    every replay: they equal a single-stepped run's.
  - Document masks. A group whose builder's masks all select every
    document replays a graph captured with `doc_mask = None`; any other
    group replays one that reads a static bool [n, D] mask buffer, filled
    before the replay (an all-True row draws as `None` does).

On a CPU device, and for a scheme whose step runs host code per token
(`_capturable_step = False`: the serial oracle `collapsed`), the group's
iterations run one by one through the same `_step`. On `cuda` a failed
capture or replay raises: nothing falls back to single-stepping.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ldagroupedgibbssampler_tpu_torch.ops import (cuda_counts, cuda_lightlda,
                                                  cuda_pcgs, cuda_zdraw)

# the state's fields that a step replaces
FIELDS = ("z", "ndk", "nkw", "nk", "phi", "theta")


def launch_counters() -> list:
    """(wrapper, attribute) of every kernel launch counter of the port."""
    return [(cuda_counts.blocked_label_counts, "launches"),
            (cuda_zdraw.fused_zdraw_nkw, "launches"),
            (cuda_lightlda.fused_lightlda_sweep, "launches"),
            (cuda_lightlda.fused_lightlda_sweep_streamed, "launches")] + [
        (fn, attr) for fn in (cuda_pcgs.fused_pcgs_sweep,
                              cuda_pcgs.fused_pcgs_sweep_streamed)
        for attr in ("launches", "collapsed_launches")]


def _read_counters() -> list:
    return [getattr(fn, attr) for fn, attr in launch_counters()]


def _write_counters(values) -> None:
    for (fn, attr), v in zip(launch_counters(), values):
        setattr(fn, attr, v)


class FusedSteps:
    """The fused groups of one sampler during one `sample()` call."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.graphs: dict = {}    # (n, masked) -> (graph, launches added)
        self.buffers: dict = {}   # field -> static tensor
        self.masks = None         # bool [n, D] static doc masks
        self.frozen = None        # (beta, alpha) of the cached graphs
        self.groups = 0           # groups run
        self.captures = 0
        self.capture_s = 0.0      # warm-ups and captures, host seconds

    def run(self, doc_masks) -> None:
        """Advance the chain by one group: `doc_masks[i]` is the document
        builder's numpy bool [D] mask of the group's i-th iteration."""
        s = self.sampler
        self.groups += 1
        if s.device.type != "cuda" or not s._capturable_step:
            for m in doc_masks:
                s._step(s.state, s._doc_mask(m), None)
            return
        st = s.state
        n = len(doc_masks)
        masked = not all(m.all() for m in doc_masks)
        if (self.frozen is None or self.frozen[0] != st.beta
                or self.frozen[1] is not st.alpha):
            self.graphs.clear()
            self.frozen = (st.beta, st.alpha)
        self._adopt_state()
        if masked:
            if self.masks is None or self.masks.shape[0] != n:
                self.masks = torch.empty((n, len(doc_masks[0])),
                                         dtype=torch.bool, device=s.device)
            self.masks.copy_(torch.from_numpy(np.stack(doc_masks)))
        key = (n, masked)
        if key not in self.graphs:
            self.graphs[key] = self._capture(n, masked)
        graph, added = self.graphs[key]
        graph.replay()
        _write_counters([c + a for c, a in zip(_read_counters(), added)])
        st.iteration += n

    def close(self) -> None:
        """Drop the graphs and their memory pools; the state keeps the
        buffers as its tensors."""
        self.graphs.clear()
        self.masks = None

    def _adopt_state(self) -> None:
        """Make the state's fields the static buffers, copying in the
        tensors that an unfused iteration (or any other caller) put
        there."""
        st = self.sampler.state
        for f in FIELDS:
            t = getattr(st, f)
            if t is None:
                continue
            buf = self.buffers.get(f)
            if buf is None:
                self.buffers[f] = t.clone()
            elif t is not buf:
                buf.copy_(t)
            setattr(st, f, self.buffers[f])

    def _capture(self, n: int, masked: bool):
        """Warm up, then capture n steps reading and writing the buffers.
        Returns (graph, launches the n steps add to each counter)."""
        s = self.sampler
        t0 = time.perf_counter()
        masks = [self.masks[i] if masked else None for i in range(n)]
        rng, counts = s.generator.get_state(), _read_counters()
        s._step(dataclasses.replace(s.state), masks[0], None)
        s.generator.set_state(rng)
        _write_counters(counts)
        torch.cuda.synchronize(s.device)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(s.generator)
        cap = dataclasses.replace(s.state)
        with torch.cuda.graph(graph):
            for m in masks:
                s._step(cap, m, None)
            for f, buf in self.buffers.items():
                buf.copy_(getattr(cap, f))
        del cap
        added = [b - a for a, b in zip(counts, _read_counters())]
        _write_counters(counts)
        self.captures += 1
        self.capture_s += time.perf_counter() - t0
        return graph, added
