// Row merge: out = tab with out[idx[j]] = rec[j] for every j whose idx[j]
// lies in [0, T); other entries are skipped. The valid indices must be
// unique; they need not be sorted.
//
// Replaces the TPU kernel benchmarks/micro_r4b.py:pallas_merge
// (merge_kernel :72, pallas_call :93), written there to replace the map
// insert's scatter (malio_tpu/map/voxel_hash.py:292-294). On the TPU every
// row of a 2^14-row tile ran a 14-step binary search over the sorted
// updates, because a TPU has no cheap scatter. A Hopper thread writes its
// row directly, so what is left to design for is the copy.
//
// Bound: bytes. The table read once and written once, idx read once (8 B
// an entry), the valid records read once; no arithmetic. At 3.35 TB/s:
// 0.0251 ms for the main path's insert (2^21 rows of 5 f32, N = 9984),
// 0.0300 ms for a correction's re-insert (N = T = 2^21), 0.401 ms for the
// batched insert (16 x 2^21 rows).
//
// Design: one launch of a persistent grid, at most two 512-thread blocks
// an SM (from the occupancy query).
//   - Copy. A block copies its first 32 KB tile (tile blockIdx.x), then
//     tiles by an atomic ticket until they run out. A thread keeps four
//     independent 16-byte loads in flight before their stores: 64 KB in
//     flight an SM, more than the ~25 KB that 3.35 TB/s at ~1 us of
//     latency needs, and chip_smoke.py's no-update row times it beside
//     tab.clone() on the same table. So the register copy was taken over
//     TMA bulk copies, which move the same bytes through shared memory and
//     an mbarrier ring and buy nothing where registers already hold enough
//     bytes in flight. A size or a pointer that is not a 16-byte multiple
//     keeps a tail of 4-byte words (the whole copy in words if tab and out
//     are not both aligned).
//   - Ordering: per-tile "copied" flags, not a grid barrier. Thread 0 sets
//     a tile's flag after the tile's block barrier and a fence, once the
//     loads of the block's next tile are in flight, so the fence's wait for
//     the stores overlaps them. An update waits only for the one or two
//     tiles its row lies in, not for the whole grid as it would behind a
//     cooperative launch's grid barrier.
//   - Updates, one thread an entry. After its copy a block reads its
//     chunks of idx (chunk c to block c mod the grid) and lists the live
//     entries in shared memory, prefetching their records into L2; a dead
//     entry is dropped at once and takes no room. Then a thread polls the
//     flags of its listed rows (with a backoff) and writes each row's W
//     words with the widest stores its address allows; chunks that do not
//     fit in the list follow a list at a time. The copy loop carries no
//     update work: a block's tiles stream as in a plain copy.
//   - Every block of the grid is resident at once (the grid is sized by the
//     occupancy query), and a block copies its tiles without waiting on
//     anything, so every flag a thread waits for gets set.
//   - The flags hold the call's stamp, which lives in device scratch (the
//     wrapper's, zeroed once per device) and advances inside the kernel:
//     every block reads it first, and the last block done with its copy
//     publishes the call's stamp at its end and resets the ticket. The
//     next call, or the next replay of a CUDA graph that captured this
//     launch, so finds every flag stale. Calls sharing the scratch must run
//     in stream order.
// Rows are W 4-byte words (5 for an f32 row of [fp, x, y, z, cov], 10 for
// f64), so one build serves both dtypes. Offsets are 64-bit.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int MAX_BLOCKS_PER_SM = 2;
constexpr int VEC_PER_THREAD = 4;                                // 16-byte loads in flight
constexpr int64_t TILE_VEC = (int64_t)THREADS * VEC_PER_THREAD;  // 32 KB
constexpr int64_t TILE_WORDS = TILE_VEC * 4;
constexpr int LIST = 2048;                               // live updates a block lists
constexpr int MAX_UPDATES_PER_THREAD = LIST / THREADS;   // a chunk fits the empty list
constexpr int MAX_DEVICES = 64;
// scratch words (64-bit) before the flags: the stamp of the last call, the
// tile ticket, the blocks done with their copy
constexpr int STAMP = 0, TILE_TICKET = 1, COPIED = 2, HEADER = 4;

typedef unsigned long long u64;

__device__ __forceinline__ void fence_acq_rel() { asm volatile("fence.acq_rel.gpu;" ::: "memory"); }

__device__ __forceinline__ u64 load_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// a copied tile's flag, from thread 0 after the block barrier that follows
// every thread's stores of the tile: the fence makes them visible
// card-wide first
__device__ __forceinline__ void set_flag(u64* flag, u64 stamp) {
  fence_acq_rel();
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(flag), "l"(stamp) : "memory");
}

// words [w0, w1) of src into dst (w0 a multiple of 4), thread 0 setting
// the flag `prev` (if any) once the first loads are in flight
__device__ __forceinline__ void copy_tile(const uint32_t* __restrict__ src,
                                          uint32_t* __restrict__ dst, int64_t w0, int64_t w1,
                                          bool vec, u64* prev, u64 stamp) {
  if (vec) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    const int64_t v1 = w1 >> 2;
    for (int64_t base = w0 >> 2; base < v1; base += TILE_VEC) {
      const int64_t i = base + threadIdx.x;
      if (base + TILE_VEC <= v1) {
        uint4 r[VEC_PER_THREAD];
#pragma unroll
        for (int k = 0; k < VEC_PER_THREAD; ++k) r[k] = s[i + k * THREADS];
        if (prev && threadIdx.x == 0) set_flag(prev, stamp);
        prev = nullptr;
#pragma unroll
        for (int k = 0; k < VEC_PER_THREAD; ++k) d[i + k * THREADS] = r[k];
      } else {
#pragma unroll
        for (int k = 0; k < VEC_PER_THREAD; ++k)
          if (i + k * THREADS < v1) d[i + k * THREADS] = s[i + k * THREADS];
      }
    }
    w0 = v1 << 2;
  }
  if (prev && threadIdx.x == 0) set_flag(prev, stamp);
#pragma unroll 4
  for (int64_t i = w0 + threadIdx.x; i < w1; i += THREADS) dst[i] = src[i];
}

// W words from src to dst, each store as wide as dst's address allows
__device__ __forceinline__ void write_row(uint32_t* dst, const uint32_t* __restrict__ src, int W) {
  int w = 0;
  while (w < W) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(dst + w);
    if ((a & 15) == 0 && W - w >= 4) {
      *reinterpret_cast<uint4*>(dst + w) = make_uint4(src[w], src[w + 1], src[w + 2], src[w + 3]);
      w += 4;
    } else if ((a & 7) == 0 && W - w >= 2) {
      *reinterpret_cast<uint2*>(dst + w) = make_uint2(src[w], src[w + 1]);
      w += 2;
    } else {
      dst[w] = src[w];
      w += 1;
    }
  }
}

// this thread's entries of chunk [jc, jc + THREADS x upt) (-1 past N)
__device__ __forceinline__ void load_chunk(const int64_t* __restrict__ idx, int64_t jc,
                                           int64_t N, int upt,
                                           int64_t (&row)[MAX_UPDATES_PER_THREAD]) {
#pragma unroll
  for (int k = 0; k < MAX_UPDATES_PER_THREAD; ++k) {
    const int64_t j = jc + k * THREADS + threadIdx.x;
    row[k] = k < upt && j < N ? idx[j] : -1;
  }
}

// the live entries of row[] (chunk jc) appended to the block's list as far
// as it has room, their records prefetched into L2. What finds no room
// stays in row[] (the rest is set to -1); returns whether anything did.
__device__ __forceinline__ bool append(const uint32_t* __restrict__ rec, int64_t jc, int64_t T,
                                       int W, int64_t* s_row, int64_t* s_j, int* s_n,
                                       int64_t (&row)[MAX_UPDATES_PER_THREAD]) {
  bool over = false;
#pragma unroll
  for (int k = 0; k < MAX_UPDATES_PER_THREAD; ++k) {
    if (row[k] < 0 || row[k] >= T) {
      row[k] = -1;
      continue;
    }
    const int64_t j = jc + k * THREADS + threadIdx.x;
    asm volatile("prefetch.global.L2 [%0];" ::"l"(rec + j * W));
    asm volatile("prefetch.global.L2 [%0];" ::"l"(rec + j * W + W - 1));
    const int e = atomicAdd(s_n, 1);
    if (e < LIST) {
      s_row[e] = row[k];
      s_j[e] = j;
      row[k] = -1;
    } else {
      over = true;
    }
  }
  return over;
}

// the block's n listed updates and a thread's unlisted ones (pend[], of
// chunk jp) written, each once the one or two tiles its row lies in are
// copied
__device__ __forceinline__ void flush(uint32_t* out, const uint32_t* __restrict__ rec,
                                      const u64* flags, u64 stamp, int tile_shift, int W,
                                      const int64_t* s_row, const int64_t* s_j, int n,
                                      const int64_t (&pend)[MAX_UPDATES_PER_THREAD], int64_t jp) {
  constexpr int PER_THREAD = LIST / THREADS, M = PER_THREAD + MAX_UPDATES_PER_THREAD;
  int64_t row[M], j[M];
  bool any = false;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    if (i < PER_THREAD) {
      const int e = threadIdx.x + i * THREADS;
      row[i] = e < n ? s_row[e] : -1;
      j[i] = e < n ? s_j[e] : 0;
    } else {
      row[i] = pend[i - PER_THREAD];
      j[i] = jp + (i - PER_THREAD) * THREADS + threadIdx.x;
    }
    any |= row[i] >= 0;
  }
  if (!any) return;
  for (unsigned ns = 32;; ns = ns < 1024 ? 2 * ns : ns) {  // all of a thread's polls in flight
    bool ready = true;
#pragma unroll
    for (int i = 0; i < M; ++i) {
      if (row[i] < 0) continue;
      const int64_t a = row[i] * W;
      const bool lo = load_relaxed(flags + (a >> tile_shift)) == stamp;
      const bool hi = load_relaxed(flags + ((a + W - 1) >> tile_shift)) == stamp;
      ready &= lo & hi;
    }
    if (ready) break;
    __nanosleep(ns);
  }
  fence_acq_rel();  // with the polls that saw the flags: an acquire
#pragma unroll
  for (int i = 0; i < M; ++i)
    if (row[i] >= 0) write_row(out + row[i] * W, rec + j[i] * W, W);
}

__global__ void __launch_bounds__(THREADS, MAX_BLOCKS_PER_SM)
merge_rows_kernel(const uint32_t* __restrict__ tab, uint32_t* __restrict__ out,
                  const int64_t* __restrict__ idx, const uint32_t* __restrict__ rec, int64_t T,
                  int64_t N, int W, int upt, int64_t words, int tile_shift, int64_t n_tiles,
                  bool vec, u64* state) {
  __shared__ u64 s_tile[2];
  __shared__ int64_t s_row[LIST], s_j[LIST];
  __shared__ int s_n;
  u64* flags = state + HEADER;
  const u64 stamp = *reinterpret_cast<volatile u64*>(state + STAMP) + 1;
  if (threadIdx.x == 0) s_n = 0;
  __syncthreads();  // after every thread's read of the stamp

  // copy: tile blockIdx.x first, then tiles by ticket until they run out.
  // Thread 0 takes the next ticket while a tile copies and publishes it at
  // the tile's one barrier (s_tile double-buffered: slot it & 1 is written
  // again only after every thread has passed the next barrier). A tile's
  // flag is set during the next tile's copy, the last one's after it.
  const int64_t tile_words = (int64_t)1 << tile_shift;
  int64_t t = blockIdx.x;
  u64* prev = nullptr;
  for (int it = 0; t < n_tiles; ++it) {
    u64 next = 0;
    if (threadIdx.x == 0) next = gridDim.x + atomicAdd(state + TILE_TICKET, 1ULL);
    const int64_t w0 = t * tile_words;
    copy_tile(tab, out, w0, w0 + tile_words < words ? w0 + tile_words : words, vec, prev, stamp);
    if (threadIdx.x == 0) s_tile[(it + 1) & 1] = next;
    __syncthreads();  // every thread's stores of tile t issued
    prev = flags + t;
    t = (int64_t)s_tile[(it + 1) & 1];
  }
  // the block is done with the ticket and the stamp; the count's value is
  // read at the end
  u64 copied = 0;
  if (threadIdx.x == 0) copied = atomicAdd(state + COPIED, 1ULL);

  // updates: this block's chunks of THREADS x upt entries (chunk c to
  // block c mod the grid) gathered into the list until it is full, then
  // the list and row[] (the unlisted entries of chunk jp) written; again
  // until the chunks end. By now most tiles are copied, so most polls
  // succeed at once. The list's count is read after a barrier and before
  // the next reset. The flag of the block's last tile is set once the
  // first index loads are in flight.
  const int64_t stride = gridDim.x * (int64_t)THREADS * upt;
  int64_t jc = blockIdx.x * (int64_t)THREADS * upt, jp = 0;
  int64_t row[MAX_UPDATES_PER_THREAD];
  while (jc < N) {
    bool full = false;
    while (jc < N && !full) {
      load_chunk(idx, jc, N, upt, row);
      if (prev && threadIdx.x == 0) set_flag(prev, stamp);
      prev = nullptr;
      full = __syncthreads_or(append(rec, jc, T, W, s_row, s_j, &s_n, row));
      jp = jc;
      jc += stride;
    }
    flush(out, rec, flags, stamp, tile_shift, W, s_row, s_j, s_n < LIST ? s_n : LIST, row, jp);
    __syncthreads();  // every thread done with the list
    if (threadIdx.x == 0) s_n = 0;
    __syncthreads();
  }
  if (prev && threadIdx.x == 0) set_flag(prev, stamp);

  // the last block done with its copy resets the ticket and publishes the
  // stamp (every block has read it); the next launch on the stream sees both
  if (threadIdx.x == 0 && copied == gridDim.x - 1) {
    state[TILE_TICKET] = 0;
    state[COPIED] = 0;
    state[STAMP] = stamp;
  }
}

// blocks of the persistent grid on the current device: SMs x blocks an SM
int grid_cap(int* cap) {
  static int caps[MAX_DEVICES] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < MAX_DEVICES && caps[dev] > 0) {
    *cap = caps[dev];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, merge_rows_kernel, THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *cap = sms * (per_sm < MAX_BLOCKS_PER_SM ? per_sm : MAX_BLOCKS_PER_SM);
  if (dev < MAX_DEVICES) caps[dev] = *cap;
  return 0;
}

int tile_shift_for(int64_t words, int64_t n_flags) {
  int shift = 0;
  while (((int64_t)1 << shift) < TILE_WORDS) ++shift;
  while ((words + ((int64_t)1 << shift) - 1) >> shift > n_flags) ++shift;
  return shift;
}

}  // namespace

// Words in a tile of the copy for a table of `words` words with `n_flags`
// tile flags in the scratch: 32 KB, or 32 KB times the least power of two
// that leaves at most n_flags tiles.
extern "C" int64_t merge_rows_tile_words(int64_t words, int64_t n_flags) {
  return (int64_t)1 << tile_shift_for(words, n_flags);
}

// tab, out: (T, W) words; idx: (N,) int64; rec: (N, W) words; state: 4 +
// n_flags 64-bit words of scratch, zeroed before its first use and kept
// between calls. Returns the CUDA error of the launch (0 on success).
extern "C" int merge_rows_launch(const void* tab, void* out, const int64_t* idx, const void* rec,
                                 int64_t T, int64_t N, int W, void* state, int64_t n_flags,
                                 cudaStream_t stream) {
  int cap = 0;
  const int err = grid_cap(&cap);
  if (err != 0) return err;
  const int64_t words = T * W;
  const int shift = tile_shift_for(words, n_flags);
  const int64_t n_tiles = (words + ((int64_t)1 << shift) - 1) >> shift;
  // entries a thread: one, or as many as spread N over the whole grid
  int64_t upt = (N + (int64_t)cap * THREADS - 1) / ((int64_t)cap * THREADS);
  upt = upt < 1 ? 1 : (upt > MAX_UPDATES_PER_THREAD ? MAX_UPDATES_PER_THREAD : upt);
  const int64_t n_chunks = (N + THREADS * upt - 1) / (THREADS * upt);
  int64_t blocks = n_tiles > n_chunks ? n_tiles : n_chunks;
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  const bool vec =
      ((reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  // rows of no words: no update writes anything
  merge_rows_kernel<<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const uint32_t*>(tab), static_cast<uint32_t*>(out), idx,
      static_cast<const uint32_t*>(rec), W > 0 ? T : 0, N, W, (int)upt, words, shift, n_tiles,
      vec, static_cast<u64*>(state));
  return (int)cudaGetLastError();
}
