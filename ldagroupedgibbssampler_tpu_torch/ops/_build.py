"""Build and load the port's CUDA kernels.

At first use, every `csrc/*.cu` of this package is compiled by `nvcc` for
Hopper (`sm_90a`), one `nvcc` per source, all started together, and the
objects are linked into ONE shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \
         -Xcompiler -fPIC -c -o <obj>.o csrc/<name>.cu      (each source)
    nvcc -shared -o build/torch_kernels/libldakernels-<hash>.so *.o

The output lives under `build/torch_kernels/` at the repository root (listed
in `.gitignore`), named by a hash of the sources and flags, so an edited
source rebuilds and an unchanged one is reused. The library is loaded with
`ctypes`: each C entry point takes device pointers and the CUDA stream as
`c_void_p`, sizes as `c_int`/`c_longlong`, and returns `cudaGetLastError()`
after its launch, which the Python wrapper turns into an exception.

Nothing here runs at import time: the CPU tests import every module of the
package on a machine without `nvcc`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_c_ptr = ctypes.c_void_p
_c_int = ctypes.c_int
_c_i64 = ctypes.c_longlong
_c_f32 = ctypes.c_float

# C signatures of the entry points in csrc/*.cu (all return cudaError_t)
_SIGNATURES = {
    # label_counts.cu
    "lda_label_counts": [_c_ptr, _c_ptr, _c_ptr, _c_i64, _c_int, _c_int,
                         _c_int, _c_int, _c_int, _c_ptr, _c_int, _c_ptr],
    "lda_label_counts_launch_shape": [_c_int, _c_int, _c_ptr],
    # zdraw.cu
    "lda_zdraw_nkw": [_c_ptr] * 11 + [_c_i64] + [_c_int] * 9 + [_c_ptr],
    "lda_zdraw_launch_shape": [_c_int, _c_ptr, _c_ptr, _c_ptr],
    # pcgs.cu
    "lda_pcgs_phi_bf16": [_c_ptr, _c_ptr] + [_c_int] * 4 + [_c_ptr],
    "lda_pcgs_sweep": [_c_ptr] * 13 + [_c_int, _c_i64, _c_int, _c_int,
                                       _c_int, _c_int, _c_int, _c_int,
                                       _c_int, _c_ptr],
    "lda_pcgs_collapsed_sweep": [_c_ptr] * 11 + [
        ctypes.c_float, _c_int, _c_i64, _c_int, _c_int, _c_int, _c_int,
        _c_int, _c_int, _c_int, _c_ptr],
    "lda_pcgs_launch_shape": [_c_int, _c_int, _c_int, _c_ptr],
    # lightlda.cu
    "lda_lightlda_word_cdf": [_c_ptr] * 4 + [_c_int] * 4 + [_c_ptr],
    "lda_lightlda_sweep": [_c_ptr] * 16 + [_c_int, _c_i64, _c_int, _c_int,
                                           _c_int, _c_int, _c_int, _c_int,
                                           _c_int, _c_ptr],
    "lda_lightlda_launch_shape": [_c_int, _c_ptr],
    # gamma.cu
    "lda_gamma": [_c_ptr] * 4 + [_c_i64, _c_int, _c_ptr],
    "lda_dirichlet_rows": [_c_ptr, _c_int, _c_ptr, ctypes.c_float, _c_ptr,
                           _c_ptr, _c_i64, _c_int, _c_int, _c_int, _c_ptr],
    "lda_dirichlet_cols": [_c_ptr, _c_int, _c_ptr, ctypes.c_float, _c_ptr,
                           _c_ptr, _c_ptr, _c_i64, _c_int, _c_int, _c_int,
                           _c_int, _c_ptr],
    "lda_dirichlet_long_rows": [_c_ptr, _c_int, _c_ptr, ctypes.c_float,
                                _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_int,
                                _c_int, _c_ptr],
    # left_to_right.cu
    "lda_left_to_right": [_c_ptr] * 8 + [_c_int] * 11 + [_c_ptr],
    # alias_mh.cu
    "lda_alias_mh_entry": [_c_ptr] * 6 + [_c_i64, _c_i64, _c_int, _c_ptr],
    "lda_alias_mh_rounds": [_c_ptr] * 16 + [ctypes.c_float] * 2
    + [_c_ptr] * 3 + [_c_i64] + [_c_int] * 4 + [_c_ptr],
    "lda_alias_mh_pack": [_c_ptr, _c_ptr, ctypes.c_float, _c_ptr, _c_i64,
                          _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_i64, _c_int,
                          _c_ptr],
    # hdp.cu
    "lda_binomial": [_c_ptr] * 4 + [_c_i64, _c_int, _c_ptr],
    "lda_hdp_hist_shared": [_c_int, _c_int, _c_int],
    "lda_hdp_hist_blocks_per_sm": [_c_int] * 4 + [_c_ptr],
    "lda_hdp_table_counts": [_c_ptr, _c_ptr, _c_f32] + [_c_ptr] * 4
    + [_c_i64, _c_int, _c_int, _c_int, _c_int, _c_ptr],
    "lda_hdp_psi": [_c_ptr] * 8 + [_c_int, _c_int, _c_int, _c_f32, _c_int,
                                   _c_int, _c_f32, _c_f32, _c_int, _c_int,
                                   _c_ptr],
    # pairwise.cu
    "lda_pairwise_elementwise": [_c_ptr] * 6 + [_c_i64, _c_i64, _c_int,
                                                _c_int, _c_int, _c_ptr],
    "lda_pairwise_ks": [_c_ptr] * 3 + [_c_i64, _c_i64, _c_int, _c_int,
                                       _c_ptr],
    "lda_pairwise_division_check": [_c_ptr] * 3 + [_c_i64, _c_i64, _c_int,
                                                   _c_int, _c_ptr],
    "lda_pairwise_blocks_per_sm": [_c_int, _c_int, _c_ptr],
    # polya_urn.cu
    "lda_poisson": [_c_ptr] * 3 + [_c_i64, _c_int, _c_ptr],
    "lda_polya_urn_geometry": [_c_i64, _c_int, _c_int, _c_ptr],
    "lda_polya_urn": [_c_ptr, _c_int, _c_f32] + [_c_ptr] * 5
    + [_c_i64, _c_int, _c_int, _c_ptr],
    # vs_dirichlet.cu
    "lda_vs_dirichlet": [_c_ptr, _c_int, _c_f32] + [_c_ptr] * 4
    + [_c_i64] + [_c_int] * 6 + [_c_f32, _c_f32, _c_int, _c_ptr],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of "
                           "ldagroupedgibbssampler_tpu_torch need the CUDA "
                           "toolkit to build")
    return nvcc


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libldakernels-{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels if the library for these sources is missing.
    Returns (path, seconds spent compiling; 0.0 when it was already built).
    The compiler's output (registers, spills) goes to `<lib>.log`."""
    out = library_path()
    if out.exists():
        return out, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o",
                 os.path.join(tmp, src.stem + ".o"), str(src)]
                for src in _sources()]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, "-shared", "-o", os.path.join(tmp, "lib.so"),
                *(c[-2] for c in cmds)]
        log = out.with_suffix(".log")
        text = "".join(" ".join(c) + "\n" + o for c, o in zip(cmds, outs))
        failed = [c[-1] for c, p in zip(cmds, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            text += " ".join(link) + "\n" + proc.stdout + proc.stderr
            if proc.returncode != 0:
                failed = ["link"]
        log.write_text(text)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n{text[-4000:]}")
        # atomic: concurrent builders agree
        os.replace(os.path.join(tmp, "lib.so"), out)
    return out, time.perf_counter() - t0


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_int32_extent(**counts):
    """Raise unless every count (a layout's slots, a table's elements) is
    below 2^31, the extent of the kernels' int32 indexes: a larger operand
    would wrap them, so it is refused by name."""
    for name, n in counts.items():
        if n >= 2 ** 31:
            raise ValueError(f"{name}: {n} elements reach 2^31 = {2 ** 31}, "
                             "the limit of the kernels' int32 indexes")


def check_tensor(name, t, shape, dtype=torch.int32, device=None):
    """Validate a kernel operand: a contiguous CUDA tensor of the expected
    dtype and shape, on `device` when given."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or (device is not None and t.device != device):
        raise ValueError(f"{name}: expected a tensor on {device or 'cuda'}, "
                         f"got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current CUDA stream on `device`, as an entry
    point takes it."""
    return torch.cuda.current_stream(device).cuda_stream


def check(err: int, name: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")
