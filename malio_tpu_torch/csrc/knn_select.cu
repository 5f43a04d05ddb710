// k-NN candidate select/compact for Hopper (sm_90a).
//
// Replaces the TPU kernel malio_tpu/ops/knn_pallas.py:topk_candidates
// (body _kernel): per query row, K rounds of running-min over a
// precomputed masked squared-distance row d2 (Q, C). Ties go to the lowest
// lane; each selected lane is knocked out with FLT_MAX, the same sentinel
// the caller uses for invalid lanes, so an exhausted or all-invalid row
// keeps returning lane 0 exactly like the plain argmin version. Emits the
// selected lanes' xyz, stored cov and d2 in ascending order.
//
// Bound: the bytes it reads. Every input is read once — Q*C*(4 B d2 +
// 12 B xyz + 4 B cov) — about 51 MB for the base window (Q = 9984,
// C = 256), ~15 us at 3.35 TB/s; the K rounds of selection run out of
// shared memory.
//
// Design: one warp per query row. The warp copies its d2 row into shared
// memory once (coalesced), then each round every thread scans its
// lanes (lane = tid + 32 i, increasing, so a strict < keeps the lowest
// lane) and a 5-step shuffle reduction on the pair (d2, lane) finds the
// winner. Lane 0 writes the winner's record, read straight from the
// (Q, C, 3) layout (no plane transpose as on the TPU), and knocks the
// lane out. Warps per block shrink with C so the rows fit 48 KB of
// shared memory (8 warps at C = 256, 1 warp at C = 6656).
#include <cuda_runtime.h>
#include <cfloat>

__device__ __forceinline__ void pick(float& v, int& l, float v2, int l2) {
  if (v2 < v || (v2 == v && l2 < l)) {
    v = v2;
    l = l2;
  }
}

__global__ void knn_select_kernel(const float* __restrict__ d2,
                                  const float* __restrict__ pts,
                                  const float* __restrict__ covs, int Q, int C,
                                  int K, float* __restrict__ out_pts,
                                  float* __restrict__ out_covs,
                                  float* __restrict__ out_d2) {
  extern __shared__ float rows[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long q = (long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (q >= Q) return;  // whole warp leaves together
  float* row = rows + (long)warp * C;
  const float* src = d2 + q * C;
  for (int c = lane; c < C; c += 32) row[c] = src[c];
  __syncwarp();

  for (int k = 0; k < K; ++k) {
    float bv = INFINITY;
    int bl = C;
    for (int c = lane; c < C; c += 32) {
      const float v = row[c];
      if (v < bv) {
        bv = v;
        bl = c;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float v2 = __shfl_xor_sync(0xffffffffu, bv, off);
      const int l2 = __shfl_xor_sync(0xffffffffu, bl, off);
      pick(bv, bl, v2, l2);
    }
    if (bl >= C) bl = 0;  // only for a row of NaNs
    if (lane == 0) {
      const long o = q * K + k;
      const long s = q * C + bl;
      out_pts[o * 3 + 0] = pts[s * 3 + 0];
      out_pts[o * 3 + 1] = pts[s * 3 + 1];
      out_pts[o * 3 + 2] = pts[s * 3 + 2];
      out_covs[o] = covs[s];
      out_d2[o] = bv;
      row[bl] = FLT_MAX;
    }
    __syncwarp();
  }
}

extern "C" int knn_select_launch(const float* d2, const float* pts,
                                 const float* covs, int Q, int C, int K,
                                 float* out_pts, float* out_covs,
                                 float* out_d2, void* stream) {
  if (Q <= 0) return 0;
  int warps = (48 * 1024) / (C * (int)sizeof(float));
  if (warps > 8) warps = 8;
  if (warps < 1) warps = 1;
  const size_t smem = (size_t)warps * C * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        knn_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int blocks = (Q + warps - 1) / warps;
  knn_select_kernel<<<blocks, warps * 32, smem, (cudaStream_t)stream>>>(
      d2, pts, covs, Q, C, K, out_pts, out_covs, out_d2);
  return (int)cudaGetLastError();
}
