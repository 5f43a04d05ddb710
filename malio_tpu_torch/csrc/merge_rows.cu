// Row merge: out = tab with out[idx[j]] = rec[j] for every j whose idx[j]
// lies in [0, T); other entries are skipped. The valid indices must be
// unique; they need not be sorted.
//
// Replaces the TPU kernel benchmarks/micro_r4b.py:pallas_merge
// (merge_kernel :72, pallas_call :93), written there to replace the map
// insert's scatter (malio_tpu/map/voxel_hash.py:292-294). On the TPU every
// row of a 2^14-row tile ran a 14-step binary search over the sorted
// updates, because a TPU has no cheap scatter. A Hopper thread writes its
// row directly, so the kernel is two passes in stream order:
//   1. merge_rows_copy: the table copied as 16-byte vectors by a
//      grid-stride loop (a tail of 4-byte words if the size or the
//      pointers are not 16-byte multiples);
//   2. merge_rows_scatter: one thread per (update, word) writes the valid
//      records over the copy.
// Rows are W 4-byte words (5 for an f32 row of [fp, x, y, z, cov], 10 for
// f64), so one build serves both dtypes. Offsets are 64-bit.
//
// Bound: bytes. The table is read and written once (2 x 41.9 MB at 2^21
// rows of 5 f32), the updates read once; no arithmetic. The copy streams at
// full width; the scatter touches N rows at random (N << T).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COPY_THREADS = 256;
constexpr int SCATTER_THREADS = 256;
constexpr int64_t MAX_COPY_BLOCKS = 132 * 16;  // 16 blocks per SM of an H100

__global__ void merge_rows_copy(const uint4* __restrict__ src, uint4* __restrict__ dst,
                                int64_t n_vec, const uint32_t* __restrict__ src_w,
                                uint32_t* __restrict__ dst_w, int64_t w_begin, int64_t w_end) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  for (int64_t i = tid; i < n_vec; i += stride) dst[i] = src[i];
  for (int64_t i = w_begin + tid; i < w_end; i += stride) dst_w[i] = src_w[i];
}

__global__ void merge_rows_scatter(uint32_t* __restrict__ out, const int64_t* __restrict__ idx,
                                   const uint32_t* __restrict__ rec, int64_t T, int64_t N,
                                   int W) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= N * W) return;
  const int64_t j = k / W;
  const int64_t w = k - j * W;
  const int64_t row = idx[j];
  if (row < 0 || row >= T) return;
  out[row * W + w] = rec[k];
}

}  // namespace

// tab, out: (T, W) words; idx: (N,) int64; rec: (N, W) words. Returns the
// CUDA error of the launches (0 on success).
extern "C" int merge_rows_launch(const void* tab, void* out, const int64_t* idx, const void* rec,
                                 int64_t T, int64_t N, int W, cudaStream_t stream) {
  const int64_t words = T * W;
  const bool aligned = ((reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int64_t n_vec = aligned ? words / 4 : 0;
  const int64_t w_begin = n_vec * 4;
  const int64_t work = n_vec > words - w_begin ? n_vec : words - w_begin;
  if (work > 0) {
    int64_t blocks = (work + COPY_THREADS - 1) / COPY_THREADS;
    if (blocks > MAX_COPY_BLOCKS) blocks = MAX_COPY_BLOCKS;
    merge_rows_copy<<<(unsigned)blocks, COPY_THREADS, 0, stream>>>(
        static_cast<const uint4*>(tab), static_cast<uint4*>(out), n_vec,
        static_cast<const uint32_t*>(tab), static_cast<uint32_t*>(out), w_begin, words);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t n_threads = N * W;
  if (n_threads > 0) {
    const int64_t blocks = (n_threads + SCATTER_THREADS - 1) / SCATTER_THREADS;
    merge_rows_scatter<<<(unsigned)blocks, SCATTER_THREADS, 0, stream>>>(
        static_cast<uint32_t*>(out), idx, static_cast<const uint32_t*>(rec), T, N, W);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
