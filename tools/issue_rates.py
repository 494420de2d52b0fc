#!/usr/bin/env python3
"""Issue rates of single f32 instructions on the card: how many clocks a
warp instruction of each kind takes on one SM sub-partition (scheduler),
with 1, 2 and 4 warps a scheduler.

Run from the repository root on a machine with one CUDA card and nvcc:

    python3 tools/issue_rates.py [--json build/issue_rates.json]

Each case is one kernel whose threads run 32 independent chains of one
PTX instruction (volatile inline asm, so none is folded or merged) for a
fixed count, one block of 4 x warps warps on every SM at once (so every
scheduler holds that many warps), after ~0.3 s of the same work to bring
the clocks up: `add` (add.f32: FADD), `max` (max.f32:
FMNMX), `max.NaN` (max.NaN.f32), `min.NaN`, `absmax` (add.f32 into a
second chain, then max.NaN.f32 of its absolute value: the chebychev
term's FADD and FMNMX), `minadd` (the same add, then min.NaN.f32 of it
into an add.f32 sum: the jaccard term's FMNMX and FADD beside one more
FADD), `absadd` (the same add, then add.f32 of its absolute value into
a sum: the manhattan term's two FADDs), `imax` (max.s32) and `ffma`
(fma.rn.f32). The chains' inputs
change every step, so that the assembler can hoist nothing out of the
loop. Clocks come from clock64() around the loop (the SM's
own clock), and the SM clock rate from those clocks over the launch's
time by CUDA events. Prints one JSON object: for each case and warps a
scheduler, clocks a warp instruction (the chains' instructions, 32 a
loop step and chain pair counted once each) and the clock in GHz; and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPS = {"add": 0, "max": 1, "max.NaN": 2, "min.NaN": 3, "absmax": 4,
       "minadd": 5, "imax": 6, "ffma": 7, "absadd": 8}
# PTX instructions a chain step of each case issues
PER_STEP = {"absmax": 2, "minadd": 3, "absadd": 2}
SOURCE = r"""
#include <cuda_runtime.h>

template <int kOp>
__global__ void chains(float* out, long long* clocks, int steps) {
  float a[32], b[32], c[8];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    a[i] = out[(threadIdx.x + i) % 64];
    b[i] = out[(threadIdx.x + 5 * i) % 64];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = out[64 + (threadIdx.x + 3 * i) % 64];
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      if constexpr (kOp == 0)
        asm volatile("add.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(c[i % 8]));
      if constexpr (kOp == 1)
        asm volatile("max.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(c[i % 8]));
      if constexpr (kOp == 2)
        asm volatile("max.NaN.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(c[i % 8]));
      if constexpr (kOp == 3)
        asm volatile("min.NaN.f32 %0, %0, %1;" : "+f"(a[i]) : "f"(c[i % 8]));
      if constexpr (kOp == 4)
        asm volatile("{.reg .f32 d;\n\tadd.f32 %1, %1, %2;\n\t"
                     "abs.f32 d, %1;\n\tmax.NaN.f32 %0, %0, d;}"
                     : "+f"(a[i]), "+f"(b[i]) : "f"(c[i % 8]));
      if constexpr (kOp == 5)
        asm volatile("{.reg .f32 m;\n\tadd.f32 %1, %1, %2;\n\t"
                     "min.NaN.f32 m, %1, %3;\n\tadd.f32 %0, %0, m;}"
                     : "+f"(a[i]), "+f"(b[i])
                     : "f"(c[i % 8]), "f"(c[(i + 1) % 8]));
      if constexpr (kOp == 6) {
        int v = __float_as_int(a[i]);
        asm volatile("max.s32 %0, %0, %1;" : "+r"(v)
                     : "r"(__float_as_int(c[i % 8])));
        a[i] = __int_as_float(v);
      }
      if constexpr (kOp == 7)
        asm volatile("fma.rn.f32 %0, %0, %1, %1;" : "+f"(a[i])
                     : "f"(c[i % 8]));
      if constexpr (kOp == 8)
        asm volatile("{.reg .f32 d;\n\tadd.f32 %1, %1, %2;\n\t"
                     "abs.f32 d, %1;\n\tadd.f32 %0, %0, d;}"
                     : "+f"(a[i]), "+f"(b[i]) : "f"(c[i % 8]));
    }
  }
  const long long t1 = clock64();
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sum += a[i] + b[i];
  out[128 + blockIdx.x * blockDim.x + threadIdx.x] = sum;
  if (threadIdx.x == 0) clocks[blockIdx.x] = t1 - t0;
}

template <int kOp>
int run(float* out, long long* clocks, int blocks, int threads, int steps) {
  chains<kOp><<<blocks, threads>>>(out, clocks, steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int issue_rates_run(int op, void* out, void* clocks, int blocks,
                               int threads, int steps) {
  auto* o = static_cast<float*>(out);
  auto* c = static_cast<long long*>(clocks);
  switch (op) {
    case 0: return run<0>(o, c, blocks, threads, steps);
    case 1: return run<1>(o, c, blocks, threads, steps);
    case 2: return run<2>(o, c, blocks, threads, steps);
    case 3: return run<3>(o, c, blocks, threads, steps);
    case 4: return run<4>(o, c, blocks, threads, steps);
    case 5: return run<5>(o, c, blocks, threads, steps);
    case 6: return run<6>(o, c, blocks, threads, steps);
    case 7: return run<7>(o, c, blocks, threads, steps);
    default: return run<8>(o, c, blocks, threads, steps);
  }
}
"""


def build(out_dir: str) -> ctypes.CDLL:
    """nvcc SOURCE with the port's flags into out_dir; loads it."""
    from ldagroupedgibbssampler_tpu_torch.ops import _build
    src = os.path.join(out_dir, "issue_rates.cu")
    lib = os.path.join(out_dir, "libissue_rates.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(proc.stdout + proc.stderr)
    dll = ctypes.CDLL(lib)
    dll.issue_rates_run.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_void_p] + [ctypes.c_int] * 3
    dll.issue_rates_run.restype = ctypes.c_int
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=16384)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("issue_rates: needs a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        results = {}
        for name, op in OPS.items():
            for warps in (1, 2, 4):              # a scheduler
                threads = 32 * 4 * warps         # one block an SM
                blocks = sms
                out = torch.rand(128 + blocks * threads, device="cuda")
                clocks = torch.zeros(blocks, dtype=torch.int64,
                                     device="cuda")
                call = (lambda: lib.issue_rates_run(
                    op, out.data_ptr(), clocks.data_ptr(), blocks, threads,
                    args.steps))
                t0 = time.perf_counter()
                while time.perf_counter() - t0 < 0.3:
                    assert call() == 0
                    torch.cuda.synchronize()
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
                assert call() == 0
                b.record()
                b.synchronize()
                ms = a.elapsed_time(b)
                cyc = float(np.median(clocks.cpu().numpy()))
                instr = 32 * args.steps * PER_STEP.get(name, 1)
                # warp instructions of one scheduler: its warps' streams
                results[f"{name} {warps} warps"] = {
                    "clocks_a_warp_instruction": cyc / (instr * warps),
                    "ghz": cyc / (ms * 1e6)}
    print(json.dumps({"card": smi, "sms": sms, "steps": args.steps,
                      "results": results}), flush=True)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as f:
            json.dump({"card": smi, "results": results}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
