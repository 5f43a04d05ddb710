// Fused k-NN window search for Hopper (sm_90a): hash-table rows to the
// sorted top-K in one launch.
//
// Replaces the TPU kernel malio_tpu/ops/knn_pallas.py:topk_candidates
// together with the stage that feeds it in malio_tpu/map/voxel_hash.py
// (_topk_extract, :464-497, and the window gather and mask of knn_cached
// and _knn_window, :539-543 and :758-763). The plain version is
// ops/knn.py:knn_window_plain; the two are bit-equal.
//
// Per query q, lane l = v * 32 + s of the window reads tab[rows[q, v], s]
// = [fp, x, y, z, cov]. The lane is valid if fp != 0 and alive[q, v]; its
// masked d2 is ((dx*dx + dy*dy) + dz*dz) with dx = x - qx, rounded op by op
// (no FMA contraction, the order of the plain _sqdist), or FLT_MAX if the
// lane is invalid; its masked cov is cov, or 0. The output is the K lanes
// of least (d2, lane) among those with d2 < FLT_MAX, ascending, as xyz,
// masked cov and d2. Slots past the last such lane repeat lane 0 with
// d2 = FLT_MAX, which is what K rounds of argmin with knock-out to FLT_MAX
// return once the row is exhausted (ops/knn.py:topk_min). A NaN distance
// is never selected; a window where no lane has d2 <= FLT_MAX (a NaN
// query) puts +inf into slot 0, as the select-only kernel this replaces
// did.
//
// Bound: bytes. The kernel reads each distinct table row its inputs name
// (640 B; the rows of dead (q, v) pairs are skipped, lane 0's row is read
// for the fill), the queries, rows and alive, and writes 20 B per output
// slot: 12.5 MB at the flagship's base window (Q = 9984, V = 8, 13,252
// distinct rows), about 4 us at 3.35 TB/s; the rows repeat across
// neighbouring queries and the 42 MB table sits in the 50 MB L2. On an
// H100 the kernel takes 8-20x that bound: what limits it is the
// instructions it issues (list inserts and the merge's dependent
// shuffles), not memory (PERF.md).
//
// Design. Each thread owns slot s = its lane in the warp of every row its
// warp visits, so a warp reads a row's fp, x, y, z as four 4-byte loads
// that stay within the row's five 128 B lines (L1 serves the repeats; no
// staging in shared memory is needed; cov is read only for the K winners),
// and the row loop is unrolled by ROW_BATCH so that many rows' loads are
// in flight at once. Selection is one pass: a candidate is one 64-bit key
// (d2 bits, lane), so ordering by (d2, lane) is one integer compare; every
// thread keeps a sorted register list of the best keys it has seen
// (inserted by a min/max chain, no branches); a warp then merges its 32
// lists by K rounds of a shuffle min over the list heads, where only the
// winning thread pops, and thread k keeps winner k so the output writes
// spread over the warp. The kernel issues instructions rather than waits
// on memory, so a list is the shortest that stays exact: 8 keys where a
// thread sees 8 lanes, else KMAX. Geometry comes from V: windows of up to
// 8 rows (the base window) take one warp per query and four queries per
// block; wider ones (V = 208 at radius 5) take eight warps per query, rows
// split across the warps, and warp 0 merges the eight sorted lists from
// shared memory, so Q = 256 queries fill the card with 256 blocks.
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int SLOTS = 32;
constexpr int REC = 5;
constexpr int KMAX = 16;
constexpr int ROW_BATCH = 8;
constexpr int WIDE_WARPS = 8;
constexpr int SMALL_QUERIES_PER_BLOCK = 4;
constexpr int SMALL_V_MAX = 8;  // rows a one-warp query takes; its list length

// A candidate (d2, lane) as one 64-bit key: d2 >= 0, so its bits order as
// its value, and the lane below breaks ties toward the lowest lane.
typedef unsigned long long Key;
constexpr Key EMPTY = ~0ull;                          // after every candidate
constexpr Key NO_CANDIDATE = (Key)0x7f7fffffu << 32;  // FLT_MAX, lane 0

__device__ __forceinline__ Key make_key(float d, int lane) {
  return ((Key)__float_as_uint(d) << 32) | (unsigned)lane;
}

template <int N>
__device__ __forceinline__ void clear(Key (&t)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) t[i] = EMPTY;
}

// Insert into an ascending list of N keys; the largest falls off.
template <int N>
__device__ __forceinline__ void insert(Key (&t)[N], Key k) {
  if (k >= t[N - 1]) return;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const Key lo = min(t[i], k);
    k = max(t[i], k);
    t[i] = lo;
  }
}

// K rounds of argmin over the 32 list heads of a warp. Thread k ends with
// winner k in `out` (EMPTY past the count). Returns the count of winners,
// the same on every thread. Keys are distinct across threads (each lane
// belongs to one thread), so exactly one thread pops each round.
template <int N>
__device__ __forceinline__ int warp_merge(Key (&t)[N], int K, int tid, Key& out) {
  out = EMPTY;
  int n = 0;
  for (int k = 0; k < K; ++k) {
    Key w = t[0];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) w = min(w, __shfl_xor_sync(0xffffffffu, w, off));
    if (w >= NO_CANDIDATE) break;
    if (t[0] == w) {
#pragma unroll
      for (int i = 0; i < N - 1; ++i) t[i] = t[i + 1];
      t[N - 1] = EMPTY;
    }
    if (tid == k) out = w;
    ++n;
  }
  return n;
}

// One warp's scan of the rows v = v0, v0 + step, ... of query q.
// Returns whether some lane had a masked d2 <= FLT_MAX.
template <int N>
__device__ __forceinline__ bool scan_rows(
    Key (&t)[N], const float* __restrict__ tab, const long long* __restrict__ rows,
    const unsigned char* __restrict__ alive, long q, int V, int v0, int step,
    int tid, float qx, float qy, float qz) {
  bool seen = false;
  const long long* qrows = rows + q * V;
  const unsigned char* qalive = alive + q * V;
  for (int vb = v0; vb < V; vb += step * ROW_BATCH) {
    float fp[ROW_BATCH], px[ROW_BATCH], py[ROW_BATCH], pz[ROW_BATCH];
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) {
      const int v = vb + u * step;
      fp[u] = 0.f;
      px[u] = py[u] = pz[u] = 0.f;
      if (v < V && qalive[v]) {
        const float* rec = tab + ((size_t)qrows[v] * SLOTS + tid) * REC;
        fp[u] = __ldg(rec + 0);
        px[u] = __ldg(rec + 1);
        py[u] = __ldg(rec + 2);
        pz[u] = __ldg(rec + 3);
      }
    }
#pragma unroll
    for (int u = 0; u < ROW_BATCH; ++u) {
      const int v = vb + u * step;
      if (v >= V) break;
      if (fp[u] == 0.f) {  // empty slot or dead row: d2 = FLT_MAX
        seen = true;
        continue;
      }
      const float dx = __fsub_rn(px[u], qx);
      const float dy = __fsub_rn(py[u], qy);
      const float dz = __fsub_rn(pz[u], qz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      if (d <= FLT_MAX) seen = true;
      if (d < FLT_MAX) insert(t, make_key(d, v * SLOTS + tid));
    }
  }
  return seen;
}

// Thread k < K writes output slot k: winner k, or lane 0 past the count.
__device__ __forceinline__ void write_slot(
    const float* __restrict__ tab, const long long* __restrict__ rows,
    const unsigned char* __restrict__ alive, long q, int V, int K, int k,
    int n, bool seen, Key w, float* __restrict__ out_pts,
    float* __restrict__ out_covs, float* __restrict__ out_d2) {
  const bool won = k < n;
  const int l = won ? (int)(w & 0xffffffffu) : 0;
  const float d = won ? __uint_as_float((unsigned)(w >> 32))
                      : ((k == 0 && !seen) ? INFINITY : FLT_MAX);
  const int v = l / SLOTS;
  const int s = l % SLOTS;
  const float* rec = tab + ((size_t)rows[q * V + v] * SLOTS + s) * REC;
  float cov = rec[4];
  if (!won && !(rec[0] != 0.f && alive[q * V])) cov = 0.f;
  const long o = q * K + k;
  out_pts[o * 3 + 0] = rec[1];
  out_pts[o * 3 + 1] = rec[2];
  out_pts[o * 3 + 2] = rec[3];
  out_covs[o] = cov;
  out_d2[o] = d;
}

// Small windows: one warp per query, SMALL_QUERIES_PER_BLOCK per block.
// A thread sees one lane of each of the V <= SMALL_V_MAX rows, so a list
// of SMALL_V_MAX keys holds them all.
__global__ void knn_window_small(const float* __restrict__ tab,
                                 const float* __restrict__ queries,
                                 const long long* __restrict__ rows,
                                 const unsigned char* __restrict__ alive,
                                 int Q, int V, int K,
                                 float* __restrict__ out_pts,
                                 float* __restrict__ out_covs,
                                 float* __restrict__ out_d2) {
  const int tid = threadIdx.x & 31;
  const long q = (long)blockIdx.x * SMALL_QUERIES_PER_BLOCK + (threadIdx.x >> 5);
  if (q >= Q) return;  // the whole warp leaves together
  Key t[SMALL_V_MAX];
  clear(t);
  const bool seen = __any_sync(
      0xffffffffu, scan_rows(t, tab, rows, alive, q, V, 0, 1, tid,
                             queries[q * 3 + 0], queries[q * 3 + 1],
                             queries[q * 3 + 2]));
  Key w;
  const int n = warp_merge(t, K, tid, w);
  if (tid < K)
    write_slot(tab, rows, alive, q, V, K, tid, n, seen, w, out_pts, out_covs,
               out_d2);
}

// Wide windows: one block of WIDE_WARPS warps per query; warp w scans rows
// v = w, w + WIDE_WARPS, ...; warp 0 merges the warps' sorted lists.
__global__ void __launch_bounds__(WIDE_WARPS * 32)
    knn_window_wide(const float* __restrict__ tab,
                    const float* __restrict__ queries,
                    const long long* __restrict__ rows,
                    const unsigned char* __restrict__ alive, int Q, int V,
                    int K, float* __restrict__ out_pts,
                    float* __restrict__ out_covs,
                    float* __restrict__ out_d2) {
  __shared__ Key best[WIDE_WARPS][KMAX];
  const int tid = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long q = blockIdx.x;  // grid is Q blocks: no ragged edge
  Key t[KMAX];
  clear(t);
  const bool mine = scan_rows(t, tab, rows, alive, q, V, warp, WIDE_WARPS,
                              tid, queries[q * 3 + 0], queries[q * 3 + 1],
                              queries[q * 3 + 2]);
  Key w;
  warp_merge(t, K, tid, w);
  if (tid < KMAX) best[warp][tid] = w;
  const bool seen = __syncthreads_or(mine);
  if (warp != 0) return;
  clear(t);
  if (tid < WIDE_WARPS) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) t[i] = best[tid][i];
  }
  const int n = warp_merge(t, K, tid, w);
  if (tid < K)
    write_slot(tab, rows, alive, q, V, K, tid, n, seen, w, out_pts, out_covs,
               out_d2);
}

}  // namespace

extern "C" int knn_window_launch(const float* tab, const float* queries,
                                 const long long* rows,
                                 const unsigned char* alive, int Q, int V,
                                 int K, float* out_pts, float* out_covs,
                                 float* out_d2, void* stream) {
  if (Q <= 0) return 0;
  if (K < 1 || K > KMAX || V < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (V <= SMALL_V_MAX) {
    const int blocks = (Q + SMALL_QUERIES_PER_BLOCK - 1) / SMALL_QUERIES_PER_BLOCK;
    knn_window_small<<<blocks, SMALL_QUERIES_PER_BLOCK * 32, 0, s>>>(
        tab, queries, rows, alive, Q, V, K, out_pts, out_covs, out_d2);
  } else {
    knn_window_wide<<<Q, WIDE_WARPS * 32, 0, s>>>(
        tab, queries, rows, alive, Q, V, K, out_pts, out_covs, out_d2);
  }
  return (int)cudaGetLastError();
}
