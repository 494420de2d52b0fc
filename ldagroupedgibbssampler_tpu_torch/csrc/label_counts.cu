// Windowed (id, label) count histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// ldagroupedgibbssampler_tpu/ops/pallas_counts.py:_count_kernel
// (blocked_label_counts). It computes
//
//   out[win[b] * vspan + ids[b, j], labels[b, j]] += 1
//
// over every slot (b, j) of the aligned block layout whose id is below the
// sentinel `vspan`; padding slots carry id == vspan and are never counted.
// The GGS sampler runs it on layout A (N_kw: ids are window-local word ids)
// and on the d-window-major layout B (n_dk: ids are window-local doc ids).
//
// What bounds it on the H100: bytes. Each slot reads 8 bytes (id, label)
// and makes at most one 4-byte atomic add; the table is written once by
// the wrapper's zero fill. At 20NG scale that is ~25 MB of slot arrays,
// i.e. single-digit microseconds at 3.35 TB/s, while the atomics all land
// in L2 (the [rows, K] tables are a few MB). The TPU kernel built one-hot
// operands for its matrix unit because the TPU has no cheap scatter; on
// Hopper one thread per slot with a global atomicAdd is the direct form.
// Contention is bounded by the data: the hottest (word, topic) cell of a
// Zipf corpus receives a few thousand adds per call.
//
// The output is int32 and exact. The wrapper allocates it zeroed, so the
// TPU kernel's `first` flags (zero a window on its first block) are not
// needed here.

#include <cuda_runtime.h>

namespace {

__global__ void label_counts_kernel(const int* __restrict__ ids,
                                    const int* __restrict__ labels,
                                    const int* __restrict__ win,
                                    long long n, int block, int vspan,
                                    int num_labels, int* __restrict__ out) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
                      + threadIdx.x;
  if (i >= n) return;
  const int id = ids[i];
  if (id < 0 || id >= vspan) return;          // sentinel: padding slot
  const int label = labels[i];
  if (label < 0 || label >= num_labels) return;
  const long long row = static_cast<long long>(win[i / block]) * vspan + id;
  atomicAdd(out + row * num_labels + label, 1);
}

}  // namespace

// ids, labels: int32 [n] (= [NB, block] flattened); win: int32 [NB];
// out: int32 [nwin * vspan, num_labels], zeroed by the caller.
extern "C" int lda_label_counts(const void* ids, const void* labels,
                                const void* win, long long n, int block,
                                int vspan, int num_labels, void* out,
                                int device, void* stream) {
  cudaSetDevice(device);
  if (n > 0) {
    const int threads = 256;
    const long long blocks = (n + threads - 1) / threads;
    label_counts_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(ids), static_cast<const int*>(labels),
        static_cast<const int*>(win), n, block, vspan, num_labels,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
