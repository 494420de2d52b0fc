"""ctypes bindings for the native block builders (native/cell_blocks.cpp and
native/stream_blocks.cpp of this package).

The port's own copy of the JAX package's `corpus/native_blocks.py`, with
the same signatures and output. The shared libraries are built at first
use by `corpus/_native_build.py`; when no C++ compiler is present the
builders return None and callers take the vectorised NumPy builders in
corpus/ragged.py. All of them produce BIT-IDENTICAL output to the
loop-form specification (`build_cell_blocks_reference`), asserted by
tests/test_torch_native.py.
"""

from __future__ import annotations

import ctypes

import numpy as np

from ldagroupedgibbssampler_tpu_torch.corpus import _native_build

_I64 = ctypes.c_int64
_PI64 = ctypes.POINTER(_I64)
_P32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_P64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_PU8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_SIZES = (_I64,) * 7     # n, num_types, num_docs, block, vspan, dspan, chunk

_CB_SIGNATURES = (
    ("cb_size", ctypes.c_int, (_P32, _P32, *_SIZES, _PI64, _PI64)),
    ("cb_build", ctypes.c_int,
     (_P32, _P32, *_SIZES, _P32, _P32, _P32, _PU8, _P64, _P32, _P32, _P32,
      _P32, _P32, _P32)),
)
_SB_SIGNATURES = (
    ("sb_size", ctypes.c_int, (_P32, _P32, *_SIZES, _PI64)),
    ("sb_build", ctypes.c_int,
     (_P32, _P32, *_SIZES, _I64, _P32, _P32, _PU8, _P64, _P32, _P32)),
)


def native_available() -> bool:
    """Whether the native cell-block builder can run: a C++ compiler is
    present (the library builds at the first call)."""
    return _native_build.compiler_available()


def stream_native_available() -> bool:
    """Whether the native stream-block builder can run (as above)."""
    return _native_build.compiler_available()


def build_cell_blocks_native(tokens, doc_ids_all, num_types, num_docs, *,
                             block, vspan, dspan, chunk):
    """CellBlocks via the C++ builder, or None when unavailable."""
    if not native_available():
        return None
    lib = _native_build.library("cell_blocks", _CB_SIGNATURES)
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import CellBlocks

    tokens = np.ascontiguousarray(tokens, np.int32)
    docs = np.ascontiguousarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    sizes = (n, num_types, num_docs, block, vspan, dspan, chunk)
    tr, tb = _I64(0), _I64(0)
    if lib.cb_size(tokens, docs, *sizes, ctypes.byref(tr),
                   ctypes.byref(tb)) != 0:
        return None
    total_rows, total_b = tr.value, tb.value
    bpc = block // chunk
    nba, nbb = total_rows // bpc, total_b // bpc
    nwin_w = max(1, (num_types + vspan - 1) // vspan)
    nwin_d = max(1, (num_docs + dspan - 1) // dspan)

    w_local = np.empty(total_rows * chunk, np.int32)
    doc_ids = np.empty(total_rows * chunk, np.int32)
    d_local_a = np.empty(total_rows * chunk, np.int32)
    mask = np.empty(total_rows * chunk, np.uint8)
    flat_index = np.empty(total_rows * chunk, np.int64)
    win_d_chunks = np.empty(total_rows, np.int32)
    win_w = np.empty(nba, np.int32)
    first_w = np.empty(nba, np.int32)
    src_chunks = np.empty(total_b, np.int32)
    win_d = np.empty(nbb, np.int32)
    first_d = np.empty(nbb, np.int32)
    if lib.cb_build(tokens, docs, *sizes, w_local, doc_ids, d_local_a, mask,
                    flat_index, win_d_chunks, win_w, first_w, src_chunks,
                    win_d, first_d) != 0:
        return None
    d_local = d_local_a.reshape(-1, chunk)[src_chunks]
    _native_build.calls["build_cell_blocks_native"] += 1
    return CellBlocks(
        w_local=w_local.reshape(nba, block),
        doc_ids=doc_ids.reshape(nba, block),
        mask=mask.view(bool).reshape(nba, block),
        win_w=win_w, first_w=first_w,
        flat_index=flat_index.reshape(nba, block),
        d_local_a=d_local_a.reshape(nba, block),
        win_d_chunks=win_d_chunks,
        src_chunks=src_chunks,
        d_local=d_local.reshape(nbb, block),
        win_d=win_d, first_d=first_d,
        vspan=vspan, dspan=dspan, nwin_w=nwin_w, nwin_d=nwin_d,
        chunk=chunk)


def build_stream_blocks_native(tokens, doc_ids_all, num_types, num_docs, *,
                               block, vspan, dspan, chunk):
    """StreamBlocks via the C++ builder, or None when unavailable."""
    if not stream_native_available():
        return None
    lib = _native_build.library("stream_blocks", _SB_SIGNATURES)
    from ldagroupedgibbssampler_tpu_torch.corpus.ragged import StreamBlocks

    tokens = np.ascontiguousarray(tokens, np.int32)
    docs = np.ascontiguousarray(doc_ids_all, np.int32)
    n = tokens.shape[0]
    sizes = (n, num_types, num_docs, block, vspan, dspan, chunk)
    tc = _I64(0)
    if lib.sb_size(tokens, docs, *sizes, ctypes.byref(tc)) != 0:
        return None
    total = tc.value
    nb = total // (block // chunk)
    w_local = np.empty(total * chunk, np.int32)
    d_local = np.empty(total * chunk, np.int32)
    mask = np.empty(total * chunk, np.uint8)
    flat_index = np.empty(total * chunk, np.int64)
    ww = np.empty(total, np.int32)
    wd = np.empty(total, np.int32)
    if lib.sb_build(tokens, docs, *sizes, total, w_local, d_local, mask,
                    flat_index, ww, wd) != 0:
        return None
    _native_build.calls["build_stream_blocks_native"] += 1
    return StreamBlocks(
        w_local=w_local.reshape(nb, block),
        d_local=d_local.reshape(nb, block),
        mask=mask.view(bool).reshape(nb, block),
        flat_index=flat_index.reshape(nb, block),
        win_w_chunks=ww, win_d_chunks=wd,
        vspan=vspan, dspan=dspan,
        nwin_w=max(1, (num_types + vspan - 1) // vspan),
        nwin_d=max(1, (num_docs + dspan - 1) // dspan), chunk=chunk)
