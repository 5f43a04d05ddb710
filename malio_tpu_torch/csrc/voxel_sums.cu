// The voxel downsample's segment sums for Hopper (sm_90a).
//
// Replaces no TPU kernel: it stands for the three scatter-adds of the JAX
// package's voxel_downsample (malio_tpu/preprocess.py:50-60), which the
// port ran as three torch.segment_reduce sums over the sorted rows
// (preprocess.voxel_sums_plain). The sort orders each group's P raw slots
// by voxel hash; a group's masked slots all carry one key that sorts
// last, so they form its last segment, ~50k-60k rows at the City and
// UrbanNav widths. segment_reduce gives each (segment, column) one thread
// that adds the segment's rows one after another, so that masked segment
// alone was one thread walking ~60k dependent loads, three times a round
// (~5.5 ms on an H100), for a sum that is multiplied by zero.
//
// What bounds it. The kept segments (index < out_cap, of valid rows) hold
// at most a group's valid points: at City's widths ~28k rows of 3 + A
// numbers, an index and a segment id, ~1 MB read once, ~0.3 us at
// 3.35 TB/s. The rows of a segment are added in row order (the plain
// version's bits), so the time is the longest segment's chain of loads.
//
// Design, against that (chip_smoke.py's voxel_sums rows time it):
// - One launch over max(G P, G out_cap) threads. As row r, a thread that
//   holds the first row of a kept segment j of its group adds the
//   segment's rows from its first, in row order, each sum rounded on its
//   own (__fadd_rn / __dadd_rn), from 0: the sequential sum that
//   segment_reduce(initial=0) takes, so the count, the sums and the
//   divisions by the count are bit-equal to the plain version's. As slot
//   (g, j), a thread writes 0 and valid = false where group g has no j-th
//   segment. Every output element is written once; nothing is zeroed
//   before the launch.
// - The rows are read through the sort's order, eight a step: the eight
//   segment ids and indices load together, then the eight rows' numbers,
//   then the adds, so a step waits for two loads and not for sixteen. A
//   walk sums 4 columns (xyz and the first aux column); more aux columns
//   walk the segment again.
// - The masked rows are never walked. The sort keys them past every
//   hash (preprocess.voxel_sort), so they form the group's last segment
//   and share it with no valid row, even one whose hash is 0xFFFFFFFF. A
//   segment whose first row is masked is that segment: its slot is 0 with
//   valid = false, as the plain version writes it for finite inputs, read
//   from one mask byte. Segments past out_cap (the plain version's dump)
//   are never walked either.
// - No atomics and no tree: both would change the bits, atomics from run
//   to run.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int THREADS = 256;
constexpr int STEP = 8;  // rows loaded together in a walk
constexpr int COLS = 4;  // columns summed a walk

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double dv(double a, double b) { return __ddiv_rn(a, b); }

// column c of row o: xyz, then the aux columns
template <typename T>
__device__ __forceinline__ T value(const T* pts, const T* aux, int A, int64_t o, int c) {
  return c < 3 ? pts[3 * o + c] : aux[(int64_t)A * o + (c - 3)];
}

template <typename T>
__global__ void __launch_bounds__(THREADS) voxel_sums_kernel(
    const T* __restrict__ pts, const T* __restrict__ aux,
    const unsigned char* __restrict__ mask, const int64_t* __restrict__ order,
    const int64_t* __restrict__ seg, int64_t G, int64_t P, int64_t C, int A,
    T* __restrict__ out, T* __restrict__ aux_out, unsigned char* __restrict__ valid) {
  const int64_t t = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int W = 3 + A;
  if (t < G * C) {  // slot (g, j): empty where the group has no j-th segment
    const int64_t g = t / C, j = t - g * C;
    if (P == 0 || j > seg[g * P + P - 1]) {
      for (int c = 0; c < 3; ++c) out[3 * t + c] = T(0);
      for (int c = 0; c < A; ++c) aux_out[(int64_t)A * t + c] = T(0);
      valid[t] = 0;
    }
  }
  if (t >= G * P) return;
  const int64_t g = t / P, i = t - g * P, j = seg[t];
  if (j >= C || (i > 0 && seg[t - 1] == j)) return;  // not a kept segment's first row
  const int64_t end = (g + 1) * P, slot = g * C + j;
  if (!mask[order[t]]) {  // the masked rows' segment
    for (int c = 0; c < 3; ++c) out[3 * slot + c] = T(0);
    for (int c = 0; c < A; ++c) aux_out[(int64_t)A * slot + c] = T(0);
    valid[slot] = 0;
    return;
  }
  for (int c0 = 0; c0 < W; c0 += COLS) {
    T n = T(0), sum[COLS];
#pragma unroll
    for (int k = 0; k < COLS; ++k) sum[k] = T(0);
    for (int64_t r0 = t;; r0 += STEP) {
      bool in[STEP];
      int64_t o[STEP];
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        const int64_t r = r0 + u;
        in[u] = r < end && seg[r] == j;
        o[u] = r < end ? order[r] : 0;
      }
      T v[STEP][COLS];
#pragma unroll
      for (int u = 0; u < STEP; ++u)
#pragma unroll
        for (int k = 0; k < COLS; ++k)
          v[u][k] = in[u] && c0 + k < W ? value(pts, aux, A, o[u], c0 + k) : T(0);
#pragma unroll
      for (int u = 0; u < STEP; ++u) {
        if (!in[u]) continue;
        n = add(n, T(1));
#pragma unroll
        for (int k = 0; k < COLS; ++k) sum[k] = add(sum[k], v[u][k]);
      }
      const int64_t last = r0 + STEP - 1;
      if (last >= end || seg[last] != j) break;
    }
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int c = c0 + k;
      if (c < 3)
        out[3 * slot + c] = dv(sum[k], n);
      else if (c < W)
        aux_out[(int64_t)A * slot + (c - 3)] = dv(sum[k], n);
    }
  }
  valid[slot] = 1;
}

template <typename T>
static int launch(const void* pts, const void* aux, const unsigned char* mask,
                  const int64_t* order, const int64_t* seg, int64_t G, int64_t P, int64_t C,
                  int A, void* out, void* aux_out, unsigned char* valid, void* stream) {
  const int64_t n = G * (P > C ? P : C);
  if (n == 0) return 0;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  voxel_sums_kernel<T><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)pts, (const T*)aux, mask, order, seg, G, P, C, A, (T*)out, (T*)aux_out,
      valid);
  return (int)cudaGetLastError();
}

// G groups of P sorted rows: pts (G, P, 3), aux (G, P, A) of one type
// (double = 1: f64, else f32), mask (G, P) bytes, order (G P) the sort's
// row indices into the flat (G P) rows, seg (G, P) each sorted row's
// segment within its group (0 at its first row, +1 at each new key), the
// masked rows in the group's last segment alone; out (G, C, 3), aux_out
// (G, C, A), valid (G, C) bytes. All contiguous on the card (the wrapper
// checks them). Returns the CUDA error of the launch.
extern "C" int voxel_sums_launch(const void* pts, const void* aux, const unsigned char* mask,
                                 const int64_t* order, const int64_t* seg, int64_t G,
                                 int64_t P, int64_t C, int A, int double_, void* out,
                                 void* aux_out, unsigned char* valid, void* stream) {
  return double_ ? launch<double>(pts, aux, mask, order, seg, G, P, C, A, out, aux_out, valid,
                                  stream)
                 : launch<float>(pts, aux, mask, order, seg, G, P, C, A, out, aux_out, valid,
                                 stream);
}
