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
// The GGS samplers run it on layout A (N_kw: ids are window-local word ids)
// and on the d-window-major layout B (n_dk: ids are window-local doc ids).
// The output is int32 and exact. The wrapper allocates it zeroed, so the
// TPU kernel's `first` flags (zero a window on its first block) are not
// needed here.
//
// What bounds it on the H100: bytes (every slot's id, the labels of the
// real slots, the window ids, the table written once: about 7.6 us for
// 20NG's layout A at 3.35 TB/s). What held
// the first design, one global atomicAdd per slot, at 0.129 ms on layout A
// (an H100 80GB HBM3 at 700 W, as every time here) is the Zipf head: its
// first 128-word window holds 64% of the tokens, and the most frequent
// word alone 15%, so some 200k atomics a call land on the few L2 lines of
// one N_kw row, where they serialise (with each slot's row hashed apart it
// took 0.029 ms; plain stores to the same lines did not help). A chain
// past burn-in puts a head word's tokens on a few topics, so they land on
// fewer lines still (0.160 ms). PERF.md §6 has these and the variants
// below.
//
// So there are two instances, chosen by the wrapper from the shapes alone
// (`ops/cuda_counts.py::count_instance`):
//
//  - shared: a CTA takes a run of `run_blocks` consecutive layout blocks.
//    The layout puts each block in one window and the blocks in window
//    order, so a run covers one window or a few neighbours. The CTA builds
//    the current window's [vspan, num_labels] histogram in shared memory,
//    two 16-bit counters a 32-bit word, with shared atomics. When the
//    window changes, and at the end of the run, it adds each non-zero cell
//    to global memory with one atomic and clears it. A counter sees at most
//    run_blocks * block <= 65,535 slots between flushes, so it never
//    carries into its neighbour. Head-word atomics on global memory drop
//    from one a slot to one a cell a run. Each thread reads 4 ids and 4
//    labels with two 16-byte loads, neither waiting on the other: with one
//    4-byte load each and the label read only for a real id, the kernel
//    waited on memory and lost to the global instance on layout B. Tried
//    and dropped: aggregating a warp's equal cells with __match_any_sync
//    (it cost more than the shared-memory conflicts it saved), 256 or 1024
//    threads, 1, 4 or 8 blocks a CTA (within a few percent, or slower).
//  - global: one thread a slot and one global atomicAdd, where the
//    histogram does not fit the opt-in shared memory (large K) or a block
//    is too long for 16-bit counters.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;          // threads of a shared-instance CTA
constexpr int kGlobalThreads = 256;

__global__ void label_counts_global_kernel(const int* __restrict__ ids,
                                           const int* __restrict__ labels,
                                           const int* __restrict__ win,
                                           long long n, int block, int vspan,
                                           int num_labels,
                                           int* __restrict__ out) {
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

// Adds the window's non-zero cells to `dst` (its [vspan, num_labels] rows of
// the output) and clears them.
__device__ __forceinline__ void flush_window(unsigned int* hist, int cells,
                                             int* __restrict__ dst) {
  const int words = (cells + 1) >> 1;
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const unsigned int v = hist[i];
    if (v == 0u) continue;
    hist[i] = 0u;
    if (v & 0xFFFFu) atomicAdd(dst + 2 * i, static_cast<int>(v & 0xFFFFu));
    if (v >> 16) atomicAdd(dst + 2 * i + 1, static_cast<int>(v >> 16));
  }
}

// Counts one slot into the window's histogram (two 16-bit counters a word).
__device__ __forceinline__ void count_slot(unsigned int* hist, int id,
                                           int label, int vspan,
                                           int num_labels) {
  if (id >= 0 && id < vspan && label >= 0 && label < num_labels) {
    const int cell = id * num_labels + label;
    atomicAdd(hist + (cell >> 1), 1u << ((cell & 1) << 4));
  }
}

__global__ void label_counts_shared_kernel(const int* __restrict__ ids,
                                           const int* __restrict__ labels,
                                           const int* __restrict__ win,
                                           int nb, int block, int vspan,
                                           int num_labels, int run_blocks,
                                           int* __restrict__ out) {
  extern __shared__ unsigned int hist[];
  const int cells = vspan * num_labels;
  for (int i = threadIdx.x; i < (cells + 1) >> 1; i += blockDim.x)
    hist[i] = 0u;
  const long long b0 = static_cast<long long>(blockIdx.x) * run_blocks;
  const long long b1 = min(b0 + run_blocks, static_cast<long long>(nb));
  // 16-byte loads of ids and labels where every block starts aligned
  const bool vec = block % 4 == 0
      && (reinterpret_cast<size_t>(ids) | reinterpret_cast<size_t>(labels))
             % 16 == 0;
  int cur = win[b0];
  __syncthreads();
  for (long long b = b0; b < b1; ++b) {
    const int w = win[b];                 // the same in every thread
    if (w != cur) {
      __syncthreads();
      flush_window(hist, cells, out + static_cast<long long>(cur) * cells);
      __syncthreads();
      cur = w;
    }
    const int* bid = ids + b * block;
    const int* blb = labels + b * block;
    if (vec) {
      const int4* bid4 = reinterpret_cast<const int4*>(bid);
      const int4* blb4 = reinterpret_cast<const int4*>(blb);
#pragma unroll 4
      for (int j = threadIdx.x; j < block / 4; j += blockDim.x) {
        // both loads unconditional: a padding slot's label is read and
        // not counted, so no load waits on another
        const int4 i4 = bid4[j];
        const int4 l4 = blb4[j];
        count_slot(hist, i4.x, l4.x, vspan, num_labels);
        count_slot(hist, i4.y, l4.y, vspan, num_labels);
        count_slot(hist, i4.z, l4.z, vspan, num_labels);
        count_slot(hist, i4.w, l4.w, vspan, num_labels);
      }
    } else {
      for (int j = threadIdx.x; j < block; j += blockDim.x)
        count_slot(hist, bid[j], blb[j], vspan, num_labels);
    }
  }
  __syncthreads();
  flush_window(hist, cells, out + static_cast<long long>(cur) * cells);
}

// Lets the shared instance take `smem` bytes of dynamic shared memory a
// CTA. The wrapper's shape rule (`count_instance`) picks `smem`; a size
// above the card's opt-in limit fails here with the CUDA error.
inline cudaError_t allow_shared(int smem) {
  static int allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      label_counts_shared_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

}  // namespace

// ids, labels: int32 [n] (= [NB, block] flattened); win: int32 [NB];
// out: int32 [nwin * vspan, num_labels], zeroed by the caller.
// run_blocks > 0 launches the shared instance with that many blocks a CTA
// and `smem` bytes of shared memory a CTA (at least the window's 16-bit
// histogram, vspan * num_labels counters); a run longer than 65,535 slots
// could carry a counter into its neighbour and is refused. run_blocks == 0
// launches the global instance.
extern "C" int lda_label_counts(const void* ids, const void* labels,
                                const void* win, long long n, int block,
                                int vspan, int num_labels, int run_blocks,
                                int smem, void* out, int device,
                                void* stream) {
  cudaSetDevice(device);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (run_blocks > 0) {
    if (static_cast<long long>(run_blocks) * block > 0xFFFF
        || smem < 2LL * vspan * num_labels)
      return static_cast<int>(cudaErrorInvalidValue);
    const cudaError_t err = allow_shared(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int nb = static_cast<int>(n / block);
    const int grid = (nb + run_blocks - 1) / run_blocks;
    label_counts_shared_kernel<<<grid, kThreads, smem, st>>>(
        static_cast<const int*>(ids), static_cast<const int*>(labels),
        static_cast<const int*>(win), nb, block, vspan, num_labels,
        run_blocks, static_cast<int*>(out));
  } else {
    const long long blocks = (n + kGlobalThreads - 1) / kGlobalThreads;
    label_counts_global_kernel<<<static_cast<unsigned>(blocks),
                                 kGlobalThreads, 0, st>>>(
        static_cast<const int*>(ids), static_cast<const int*>(labels),
        static_cast<const int*>(win), n, block, vspan, num_labels,
        static_cast<int*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// out: int64 [2] = threads a CTA and CTAs resident on one SM, of the
// instance that run_blocks selects, with `smem` bytes of shared memory a
// CTA for the shared one.
extern "C" int lda_label_counts_launch_shape(int run_blocks, int smem,
                                             void* out) {
  long long* o = static_cast<long long*>(out);
  int per_sm = 0;
  cudaError_t err;
  if (run_blocks > 0) {
    err = allow_shared(smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, label_counts_shared_kernel, kThreads, smem);
    o[0] = kThreads;
  } else {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, label_counts_global_kernel, kGlobalThreads, 0);
    o[0] = kGlobalThreads;
  }
  o[1] = per_sm;
  return static_cast<int>(err);
}
