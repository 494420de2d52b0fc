"""Matrix snapshot IO in the reference's binary format: the port's copy of
the binary writers and readers of `ldagroupedgibbssampler_tpu/utils/
matrix_io.py`, byte for byte the same files.

Replaces the LDAUtils binary matrix writers/readers (util/LDAUtils.java:
1129-1174): raw big-endian float64 / int32 values, row-major, NO header;
filename pattern ``{filename}_{rows}_{cols}_{iteration:05d}.BINARY``. The
reference maps the file to 8*rows*cols bytes even for int matrices (an
oversized mmap, :1058), leaving a zero tail — reproduced so file sizes
match byte-for-byte. The writers take NumPy arrays.
"""

from __future__ import annotations

import os

import numpy as np


def _binary_name(filename: str, rows: int, cols: int, iteration: int) -> str:
    return f"{filename}_{rows}_{cols}_{iteration:05d}.BINARY"


def _write_raw(fn: str, arr: np.ndarray, pad_to: int | None = None):
    data = arr.tobytes()
    with open(fn, "wb") as f:
        f.write(data)
        if pad_to is not None and pad_to > len(data):
            f.truncate(pad_to)


def write_binary_double_matrix(matrix, iteration: int, filename: str) -> str:
    m = np.ascontiguousarray(np.asarray(matrix, np.float64))
    fn = _binary_name(filename, m.shape[0], m.shape[1], iteration)
    _write_raw(fn, m.astype(">f8"))
    return fn


def write_binary_int_matrix(matrix, iteration: int, filename: str) -> str:
    m = np.ascontiguousarray(np.asarray(matrix, np.int32))
    fn = _binary_name(filename, m.shape[0], m.shape[1], iteration)
    # int files are still 8 bytes/cell long in the reference (:1166-1171)
    _write_raw(fn, m.astype(">i4"), pad_to=8 * m.shape[0] * m.shape[1])
    return fn


def read_binary_double_matrix(fn: str, rows: int, cols: int) -> np.ndarray:
    with open(fn, "rb") as f:
        data = np.frombuffer(f.read(8 * rows * cols), ">f8")
    return data.reshape(rows, cols).astype(np.float64)


def read_binary_int_matrix(fn: str, rows: int, cols: int) -> np.ndarray:
    with open(fn, "rb") as f:
        data = np.frombuffer(f.read(4 * rows * cols), ">i4")
    return data.reshape(rows, cols).astype(np.int32)
