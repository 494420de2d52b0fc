// Programmatic dependent launch (sm_90): a kernel launched with
// `launch_dependent` right after another on the same stream is scheduled
// while that one runs, once each of its blocks has called
// `allow_dependent_launch` (or left), and its threads wait in
// `wait_for_prerequisite` until it has finished and its writes are
// visible. Without the attribute the wait returns at once. Included by
// csrc/hdp.cu (the table counts' second launch; psi) and csrc/
// polya_urn.cu (its second launch).

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void allow_dependent_launch() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launch `kernel` on `blocks` blocks of `threads` threads in clusters of
// `cluster` blocks (1: none), with `smem` bytes of dynamic shared memory;
// with `dependent`, as a programmatic dependent of the stream's previous
// launch. Returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_ex(void (*kernel)(Params...), unsigned blocks,
                      unsigned threads, unsigned cluster, int smem,
                      bool dependent, cudaStream_t stream, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  unsigned n = 0;
  if (dependent) {
    attr[n].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[n++].val.programmaticStreamSerializationAllowed = 1;
  }
  if (cluster > 1) {
    attr[n].id = cudaLaunchAttributeClusterDimension;
    attr[n].val.clusterDim.x = cluster;
    attr[n].val.clusterDim.y = 1;
    attr[n++].val.clusterDim.z = 1;
  }
  cfg.attrs = attr;
  cfg.numAttrs = n;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<Args&&>(args)...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Launch `kernel` on `blocks` blocks of `threads` threads, no dynamic
// shared memory, as a programmatic dependent of the stream's previous
// launch; returns the launch's error.
template <typename... Params, typename... Args>
cudaError_t launch_dependent(void (*kernel)(Params...), unsigned blocks,
                             unsigned threads, cudaStream_t stream,
                             Args&&... args) {
  return launch_ex(kernel, blocks, threads, 1, 0, true, stream,
                   static_cast<Args&&>(args)...);
}

}  // namespace
