"""Run-directory management and per-iteration series files.

Mirrors cc/mallet/util/LoggingUtils.java + the LDAUtils log writers:
  - `RunLogger.create_run_suite` — timestamped `RunSuite<ts>/Run<ts>` dirs
    (LoggingUtils.checkAndCreateCurrentLogDir:48-110).
  - series writers with the reference's exact filenames so downstream
    analysis scripts keep working: `likelihood.txt` (iteration<TAB>ll,
    LDAUtils.logLikelihoodToFile:942-979), `log_posterior.txt` (:955-969),
    `tokens_per_topic.csv` (UncollapsedParallelLDA.java:876-878).
  - run metadata summary incl. git commit (LoggingUtils.dynamicLogRun:155,
    getCommitHash:171-202).
The port's copy of the JAX package's RunLogger, with the writers the
ported samplers use.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
import subprocess
from typing import Iterable

import numpy as np


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

    def log_tokens_per_topic(self, counts: Iterable[int]):
        self._append("tokens_per_topic.csv",
                     ",".join(str(int(c)) for c in counts))

    def save_matrix_csv(self, filename: str, mat, fmt: str = "%.6g"):
        np.savetxt(os.path.join(self.run_dir, filename), np.asarray(mat),
                   delimiter=",", fmt=fmt)

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
