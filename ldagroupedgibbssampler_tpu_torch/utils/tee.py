"""Console capture.

Replaces util/TeeStream.java:1-19 + the stdout/stderr capture in
tui/ParallelLDA.java:152-157: everything printed during a run is also
appended to the run directory's console log.
"""

from __future__ import annotations

import sys


class TeeStream:
    def __init__(self, stream, path: str):
        self.stream = stream
        self.file = open(path, "a", encoding="utf-8")

    def write(self, data):
        self.stream.write(data)
        self.file.write(data)
        self.file.flush()
        return len(data)

    def flush(self):
        self.stream.flush()
        self.file.flush()

    def close(self):
        self.file.close()

    def isatty(self):
        return getattr(self.stream, "isatty", lambda: False)()


class tee_console:
    """Context manager: tee stdout+stderr into `path`."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        self._out, self._err = sys.stdout, sys.stderr
        sys.stdout = TeeStream(self._out, self.path)
        sys.stderr = TeeStream(self._err, self.path)
        return self

    def __exit__(self, *exc):
        sys.stdout.close()
        sys.stderr.close()
        sys.stdout, sys.stderr = self._out, self._err
        return False
