"""Per-iteration stats rows and host memory: the port's copy of
`IterationStats` and `host_memory_mb` from
`ldagroupedgibbssampler_tpu/utils/timing.py` (replaces util/Stats.java and
the JMX resource logging of UncollapsedParallelLDA.java:1972-2048 — host
RSS stands in for JVM heap)."""

from __future__ import annotations

from dataclasses import dataclass


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
