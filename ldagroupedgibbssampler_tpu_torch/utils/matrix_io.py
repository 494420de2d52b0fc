"""Matrix snapshot IO in the reference's on-disk formats: the port's copy
of `ldagroupedgibbssampler_tpu/utils/matrix_io.py`, byte for byte the same
files.

Replaces the LDAUtils matrix writers/readers (util/LDAUtils.java:1037-1343):

  - Binary: raw big-endian float64 / int32 values, row-major, NO header;
    filename pattern ``{filename}_{rows}_{cols}_{iteration:05d}.BINARY``
    (writeBinaryDoubleMatrix :1129-1152, writeBinaryIntMatrix :1154-1174).
    The reference maps the file to 8*rows*cols bytes even for int matrices
    (an oversized mmap, :1058), leaving a zero tail — reproduced so file
    sizes match byte-for-byte.
  - ASCII: `sep`-joined values, one row per line (writeASCIIDoubleMatrix
    :1175-1225, readASCIIDoubleMatrix :1227-1290).

Row/column-subset variants mirror writeBinaryDoubleMatrixRows/Cols
(:1037-1124). The writers take NumPy arrays.
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


def write_binary_double_matrix_rows(matrix, iteration: int, filename: str,
                                    row_indices) -> str:
    m = np.asarray(matrix, np.float64)
    rows = np.asarray(row_indices, np.int64)
    fn = _binary_name(filename, m.shape[0], m.shape[1], iteration)
    # reference sizes the file by the FULL matrix but writes only the
    # selected rows (writeBinaryDoubleMatrixRows :1037-1051)
    _write_raw(fn, m[rows].astype(">f8"),
               pad_to=8 * m.shape[0] * m.shape[1])
    return fn


def write_binary_double_matrix_cols(matrix, iteration: int, filename: str,
                                    col_indices) -> str:
    m = np.asarray(matrix, np.float64)
    cols = np.asarray(col_indices, np.int64)
    fn = _binary_name(filename, m.shape[0], m.shape[1], iteration)
    _write_raw(fn, np.ascontiguousarray(m[:, cols]).astype(">f8"),
               pad_to=8 * m.shape[0] * m.shape[1])
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


def write_ascii_double_matrix(matrix, fn: str, sep: str = ",") -> str:
    m = np.asarray(matrix, np.float64)
    os.makedirs(os.path.dirname(fn) or ".", exist_ok=True)
    with open(fn, "w") as f:
        for row in m:
            f.write(sep.join(repr(float(v)) for v in row) + "\n")
    return fn


def write_ascii_int_matrix(matrix, fn: str, sep: str = ",") -> str:
    m = np.asarray(matrix, np.int64)
    os.makedirs(os.path.dirname(fn) or ".", exist_ok=True)
    with open(fn, "w") as f:
        for row in m:
            f.write(sep.join(str(int(v)) for v in row) + "\n")
    return fn


def read_ascii_double_matrix(fn: str, sep: str = ",") -> np.ndarray:
    rows = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([float(v) for v in line.split(sep)])
    return np.asarray(rows, np.float64)


def read_ascii_int_matrix(fn: str, sep: str = ",") -> np.ndarray:
    rows = []
    with open(fn) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append([int(v) for v in line.split(sep)])
    return np.asarray(rows, np.int64)
