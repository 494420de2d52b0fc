"""Per-phase timing, per-iteration stats rows and host memory: the port's
copy of `ldagroupedgibbssampler_tpu/utils/timing.py` (replaces
util/Stats.java, util/Timing.java and the JMX resource logging of
UncollapsedParallelLDA.java:1972-2048 — host RSS stands in for JVM heap).
`Timing` reads the host clock: around device work, synchronise inside the
timed block."""

from __future__ import annotations

import time
from dataclasses import dataclass, field


@dataclass
class Timing:
    """Named event timer (util/Timing.java): `with timing.time(name):`
    appends (name, milliseconds) to `events`."""
    events: list = field(default_factory=list)

    def time(self, name: str):
        return _TimeCtx(self, name)


class _TimeCtx:
    def __init__(self, timing: Timing, name: str):
        self.timing, self.name = timing, name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.timing.events.append(
            (self.name, (time.perf_counter() - self.t0) * 1000.0))


@dataclass
class IterationStats:
    """One row of the per-iteration stats series (util/Stats.java:3-41)."""
    iteration: int
    total_ms: float = 0.0
    z_ms: float = 0.0
    count_ms: float = 0.0
    phi_ms: float = 0.0
    density_nkw: float = -1.0
    density_ndk: float = -1.0
    density_phi: float = -1.0

    def as_row(self) -> dict:
        return {
            "iteration": self.iteration,
            "absoluteTime_ms": f"{self.total_ms:.3f}",
            "zSamplingTokenUpdateTime_ms": f"{self.z_ms:.3f}",
            "countUpdateTime_ms": f"{self.count_ms:.3f}",
            "phiSamplingTime_ms": f"{self.phi_ms:.3f}",
            "typeTopicDensity": self.density_nkw,
            "documentDensity": self.density_ndk,
            "phiDensity": self.density_phi,
        }


def host_memory_mb() -> float:
    """Resident set size in MB (stands in for the JMX heap metric,
    UncollapsedParallelLDA.java:1984-2028); -1 where /proc is absent."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return -1.0
