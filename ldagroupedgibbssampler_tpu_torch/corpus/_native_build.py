"""Build and load the port's native (C++) corpus builders.

The sources are the port's own copies in `native/` of this package:
`fast_tokenizer.cpp` (corpus/native_loader.py), `cell_blocks.cpp` and
`stream_blocks.cpp` (corpus/native_blocks.py). At first use, a source is
compiled by the host's C++ compiler into a shared library with a plain C
interface:

    g++ -O3 -std=c++17 -shared -fPIC native/<name>.cpp \
        -o build/torch_native/lib<name>-<hash>.so

under `build/torch_native/` at the repository root (listed in
`.gitignore`), named by a hash of the source and the flags, so an edited
source rebuilds and an unchanged one is reused. The compiler writes a
temporary file in that directory, which `os.replace` then renames: builders
running at once (pytest workers) each see either no library or a whole
one. The library is loaded with `ctypes`.

With no `g++` on PATH, `compiler_available()` is False and the callers
take the Python / NumPy path, whose output is bit-identical: only time
changes. A compiler that is present but fails raises RuntimeError with its
stderr; nothing falls back then.

`calls` counts the calls that ran native code, by entry point
(`tokenize_corpus_native`, `build_cell_blocks_native`,
`build_stream_blocks_native`), so a run can show which path it took.

Nothing here runs at import time.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
NATIVE_DIR = _PKG / "native"
BUILD_DIR = _PKG.parent / "build" / "torch_native"
CXX = "g++"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

calls: collections.Counter = collections.Counter()


def compiler_available() -> bool:
    return shutil.which(CXX) is not None


def library_path(name: str) -> Path:
    """build/torch_native/lib<name>-<hash of source and flags>.so"""
    h = hashlib.sha256((NATIVE_DIR / f"{name}.cpp").read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile native/<name>.cpp unless its library exists; its path."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=f".lib{name}-", suffix=".so",
                               dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [CXX, *CXX_FLAGS, str(NATIVE_DIR / f"{name}.cpp"), "-o", tmp],
            capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"{CXX} failed to build native/{name}.cpp "
                               f"(exit {proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


@functools.cache
def library(name: str, signatures: tuple) -> ctypes.CDLL:
    """native/<name>.cpp built and loaded, its entry points typed from
    `signatures`: ((symbol, restype, (argtypes...)), ...)."""
    lib = ctypes.CDLL(str(build(name)))
    for symbol, restype, argtypes in signatures:
        fn = getattr(lib, symbol)
        fn.restype = restype
        fn.argtypes = list(argtypes)
    return lib
