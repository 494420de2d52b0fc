"""Run-directory management and per-iteration series files.

Mirrors cc/mallet/util/LoggingUtils.java + the LDAUtils log writers:
  - `RunLogger.create_run_suite` — timestamped `RunSuite<ts>/Run<ts>` dirs
    (LoggingUtils.checkAndCreateCurrentLogDir:48-110).
  - series writers with the reference's exact filenames so downstream
    analysis scripts keep working: `likelihood.txt` (iteration<TAB>ll,
    LDAUtils.logLikelihoodToFile:942-979), `log_posterior.txt` (:955-969),
    `test_held_out_log_likelihood.txt` (:928-940), `stats.txt`
    (logStatsToFile:981-1036), `tokens_per_topic.csv`
    (UncollapsedParallelLDA.java:876-878), z snapshots `z_<iter>.csv`
    (:945-968), `timings.txt`, `log-detail-metrics.txt` and the
    min-distance CSVs.
  - run metadata summary incl. git commit (LoggingUtils.dynamicLogRun:155,
    getCommitHash:171-202).
The port's copy of the JAX package's RunLogger, with the same file names
and line formats.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
from typing import Iterable

import numpy as np
import torch


def _timestamp() -> str:
    return datetime.datetime.now().strftime("%Y-%m-%d--%H_%M_%S")


def git_commit_info(cwd: str = ".") -> dict:
    """Best-effort current commit hash/comment (LoggingUtils.java:171-237)."""
    try:
        h = subprocess.run(["git", "rev-parse", "HEAD"], cwd=cwd,
                           capture_output=True, text=True, timeout=5
                           ).stdout.strip()
        msg = subprocess.run(["git", "log", "-1", "--pretty=%s"], cwd=cwd,
                             capture_output=True, text=True, timeout=5
                             ).stdout.strip()
        return {"commit": h, "comment": msg}
    except (OSError, subprocess.SubprocessError):
        return {"commit": "unknown", "comment": ""}


def device_memory_stats(device) -> dict:
    """The device's memory statistics under the JAX package's key names
    (`Device.memory_stats()`): torch.cuda.memory_stats' current and peak
    allocated bytes and allocation count, and the card's total memory.
    Empty on the CPU, which has none of them."""
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    st = torch.cuda.memory_stats(device)
    return {"bytes_in_use": st.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": st.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(
                device).total_memory,
            "num_allocs": st.get("allocation.all.allocated", 0)}


class RunLogger:
    """One run directory + lazily opened append-mode series files."""

    def __init__(self, run_dir: str):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._files: dict = {}

    # -- construction ----------------------------------------------------
    @classmethod
    def create_run_suite(cls, base_dir: str, subconfig: str = "") -> "RunLogger":
        ts = _timestamp()
        path = os.path.join(base_dir, f"RunSuite{ts}",
                            f"Run{subconfig + '-' if subconfig else ''}{ts}")
        return cls(path)

    def sub_logger(self, name: str) -> "RunLogger":
        """A logger writing into the subdirectory `name` of this run's
        directory (the cross-validation folds' `fold-<n>`)."""
        return RunLogger(os.path.join(self.run_dir, name))

    def _append(self, filename: str, line: str):
        f = self._files.get(filename)
        if f is None:
            f = open(os.path.join(self.run_dir, filename), "a",
                     encoding="utf-8")
            self._files[filename] = f
        f.write(line + "\n")
        f.flush()

    def log_likelihood(self, iteration: int, ll: float):
        self._append("likelihood.txt", f"{iteration}\t{ll}")

    def log_posterior(self, iteration: int, lp: float):
        self._append("log_posterior.txt", f"{iteration}\t{lp}")

    def log_held_out_ll(self, iteration: int, ll: float):
        self._append("test_held_out_log_likelihood.txt", f"{iteration}\t{ll}")

    def log_perplexity(self, iteration: int, p: float):
        self._append("test_perplexity.txt", f"{iteration}\t{p}")

    def log_stats_row(self, row: dict):
        """stats file: header on first write, tab-separated values after
        (LDAUtils.logStatsToFile:981-1036)."""
        fn = "stats.txt"
        if fn not in self._files:
            self._append(fn, "\t".join(row.keys()))
        self._append(fn, "\t".join(str(v) for v in row.values()))

    def log_tokens_per_topic(self, counts: Iterable[int]):
        self._append("tokens_per_topic.csv",
                     ",".join(str(int(c)) for c in counts))

    def log_timing(self, event: str, ms: float):
        self._append("timings.txt", f"{event}\t{ms:.3f}")

    # -- snapshots -------------------------------------------------------
    def save_matrix_csv(self, filename: str, mat, fmt: str = "%.6g"):
        np.savetxt(os.path.join(self.run_dir, filename), np.asarray(mat),
                   delimiter=",", fmt=fmt)

    def save_matrix_binary(self, filename: str, mat):
        """Row-major float64 binary dump (LDAUtils binary writers
        :1037-1174)."""
        np.asarray(mat, np.float64).tofile(
            os.path.join(self.run_dir, filename))

    def save_z(self, iteration: int, z):
        self.save_matrix_csv(f"z_{iteration}.csv",
                             np.asarray(z).reshape(1, -1), fmt="%d")

    def log_device_metrics(self, iteration: int, mem_stats: dict):
        """Device memory metrics — the JMX resource log equivalent
        (`log-detail-metrics.txt`, UncollapsedParallelLDA.java:1984-2028).
        `mem_stats` uses the JAX package's key names
        (`device_memory_stats` maps torch's onto them); a missing key
        writes `-`."""
        keys = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit",
                "num_allocs")
        row = "\t".join(f"{k}={mem_stats.get(k, '-')}" for k in keys)
        self._append("log-detail-metrics.txt", f"{iteration}\t{row}")

    def log_min_distances(self, filename: str, iteration: int, dists):
        """Append one `iteration,v1,v2,...` row (min_doc_distances.csv /
        min_topic_distances.csv, UncollapsedParallelLDA.java:746-752)."""
        vals = ",".join(f"{v:.6g}" for v in dists)
        self._append(filename, f"{iteration},{vals}")

    def save_lines(self, filename: str, lines: Iterable[str]):
        with open(os.path.join(self.run_dir, filename), "w",
                  encoding="utf-8") as f:
            for line in lines:
                f.write(str(line) + "\n")

    def save_metadata(self, config, extra: dict | None = None):
        """Run summary (LoggingUtils.dynamicLogRun:155)."""
        meta = {"timestamp": _timestamp(), **git_commit_info(),
                "config": dataclasses.asdict(config)}
        if extra:
            meta.update(extra)
        with open(os.path.join(self.run_dir, "run_metadata.json"), "w",
                  encoding="utf-8") as f:
            json.dump(meta, f, indent=2, default=str)

    def close(self):
        for f in self._files.values():
            f.close()
        self._files.clear()


class NullRunLogger(RunLogger):
    """The logger of a rank that writes nothing: the ranks of a sharded
    scheme run the same logging code (whose accessors are collectives),
    and rank 0 alone writes the run directory. `run_dir` is None."""

    def __init__(self):
        self.run_dir = None
        self._files = {}

    def sub_logger(self, name: str) -> "RunLogger":
        return self

    def _append(self, filename: str, line: str):
        pass

    def save_matrix_csv(self, filename: str, mat, fmt: str = "%.6g"):
        pass

    def save_matrix_binary(self, filename: str, mat):
        pass

    def save_lines(self, filename: str, lines: Iterable[str]):
        pass

    def save_metadata(self, config, extra: dict | None = None):
        pass
