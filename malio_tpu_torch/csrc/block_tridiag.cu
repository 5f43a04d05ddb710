// Block-tridiagonal SPD solve T Y = RHS by block cyclic reduction, in
// f64: D (K, 6, 6) the diagonal blocks, Boff (K-1, 6, 6) with T[i, i+1] =
// Boff[i] (and T[i+1, i] = Boff[i]^T), RHS and Y (K, 6, r), all contiguous.
//
// Not a port of a TPU kernel: it replaces the two lax.scans of the JAX
// package's posegraph._block_tridiag_solve (malio_tpu/posegraph.py:243,
// :251), the odometry chain's exact solve inside optimize_sparse. The
// port's plain version (ops/block_tridiag.py: block_tridiag_solve_plain)
// keeps the reference's block Thomas; this kernel computes the same Y in
// another order of elimination.
//
// Bound: neither bytes nor operations. D, Boff and RHS read once and Y
// written once (77 MB at K = 2048, r = 385: 0.023 ms at 3.35 TB/s). What
// limits a solve is the length of its chain of dependent steps: Thomas
// has 2K of them (each a 6x6 factorisation); cyclic reduction has
// 2 ceil(log2 K) + 1 levels, each one launch whose rows are independent.
//
// Design. Level l holds the rows that are multiples of s = 2^l (n of
// them, row j of the level being row j s of T), with its own diagonal
// blocks D_j and couplings B_j (level 0: the inputs). Its odd rows are
// eliminated and its even rows kept: with L_j the Cholesky factor of an
// eliminated neighbour's D_j, symmetrised (rank-1 downdates, the pivot
// floored at 1e-30, its reciprocal square root kept on L's diagonal, as
// the plain version's _chol6 computes L), Wl = L_{j-1}^-1 B_{j-1} and
// Wr = L_{j+1}^-1 B_j^T,
//     D'_j = sym(D_j - Wl^T Wl - Wr^T Wr)   (a Schur complement: SPD),
//     B'_j = -Wr^T (L_{j+1}^-1 B_{j+1}),
//     R'_j = R_j - Wl^T (L_{j-1}^-1 R_{j-1}) - Wr^T (L_{j+1}^-1 R_{j+1}).
// Once one row is left, y_0 = D^-1 R_0 (the top). The up-sweep then
// solves each level's odd rows from their own equations, in reverse:
//     y_o = L_o^-T L_o^-1 (R_o - B_{o-1}^T y_{o-1} - B_o y_{o+1}).
// Every D^-1 is applied by two triangular solves with L, never as an
// explicit inverse: on 300 seeded 1e8-gauge systems of optimize_sparse's
// structure a CPU mirror of this order left residuals up to 4.7x the
// plain version's with explicit inverses, at most 2.0x with the
// triangular solves (tests/test_torch_block_tridiag.py, its sweep).
//   - A launch a level: block_tridiag_down (grid: kept rows x column
//     blocks), block_tridiag_top, block_tridiag_up (eliminated rows x
//     column blocks), all plain launches on the caller's stream, so that a
//     CUDA graph captures them. Within a block, warps 0 and 1 factorise
//     the two neighbours in shared memory, a lane an entry, and form Wl,
//     Wr, a lane a column; then a thread carries one of the block's
//     COLUMNS columns in registers (loaded while the warps factorise).
//     The matrices are the same for every column block; the first one
//     writes D', B' and L of the eliminated right neighbour to the
//     level's scratch (about 3 K x 36 doubles in all: 1.8 MB at K =
//     2048), which the up-sweep reads back.
//   - The RHS is worked in place in Y: level 0 reads RHS and writes its
//     kept rows to Y; later levels and the up-sweep read and write Y. A
//     row's slot holds its level's R until the up-sweep writes its y.
//   - Every sum runs in a fixed order and nothing is atomic: two solves
//     on the same inputs are bit-equal, and so are a graph's replays.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLUMNS = 128;  // threads (columns) a block
static_assert(COLUMNS >= 64 && COLUMNS % 32 == 0, "two warps factorise a level's neighbours");
constexpr int MAX_LEVELS = 32;
constexpr int REFUSED = (int)cudaErrorInvalidValue;

// The warp's lanes own the entries lane and, for lanes 0-3, lane + 32 of
// a 6x6 block (loops over the two run to 2, predicated, so they stay in
// registers).
struct Entries {
  int a[2], b[2];
  bool two;
  __device__ explicit Entries(int lane) : two(lane < 4) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int e = (lane + 32 * n) % 36;
      a[n] = e / 6;
      b[n] = e % 6;
    }
  }
};

// Cholesky of the SPD block in sM (destroyed) by one warp: rank-1
// downdates, column j of L is M[:, j] / pivot from the diagonal down, then
// M -= col col^T. sL gets L below the diagonal, the pivot's reciprocal
// square root (floored at 1e-30) on it and zeros above.
__device__ void chol6_warp(double* sM, double* sL, int lane, const Entries& en) {
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const double ipiv = rsqrt(fmax(sM[j * 6 + j], 1e-30));
    double upd[2];
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int a = en.a[n], b = en.b[n];
      const double ca = a >= j ? sM[a * 6 + j] * ipiv : 0.0;
      const double cb = b >= j ? sM[b * 6 + j] * ipiv : 0.0;
      upd[n] = ca * cb;
    }
    const double lc = (lane < 6 && lane > j) ? sM[lane * 6 + j] * ipiv : 0.0;
    __syncwarp();
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n == 1 && !en.two) break;
      sM[en.a[n] * 6 + en.b[n]] -= upd[n];
    }
    if (lane < 6) sL[lane * 6 + j] = lane == j ? ipiv : lc;
    __syncwarp();
  }
}

// x <- L^-1 x (forward substitution; L's diagonal holds 1 / pivot)
__device__ __forceinline__ void lower_solve(const double* sL, double* x) {
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    double s = 0.0;
#pragma unroll
    for (int k = 0; k < a; ++k) s += sL[a * 6 + k] * x[k];
    x[a] = (x[a] - s) * sL[a * 6 + a];
  }
}

// x <- L^-T x (back substitution)
__device__ __forceinline__ void upper_solve(const double* sL, double* x) {
#pragma unroll
  for (int a = 5; a >= 0; --a) {
    double s = 0.0;
#pragma unroll
    for (int k = 5; k > a; --k) s += sL[k * 6 + a] * x[k];
    x[a] = (x[a] - s) * sL[a * 6 + a];
  }
}

// column c of sX (6x6, row-major) through L^-1 into column c of sW
__device__ __forceinline__ void lower_solve_column(const double* sL, const double* sX, double* sW,
                                                   int c) {
  double x[6];
#pragma unroll
  for (int a = 0; a < 6; ++a) x[a] = sX[a * 6 + c];
  lower_solve(sL, x);
#pragma unroll
  for (int a = 0; a < 6; ++a) sW[a * 6 + c] = x[a];
}

__device__ __forceinline__ size_t at(int row, int a, int r, int col) {
  return ((size_t)row * 6 + a) * r + col;
}

// One level's elimination: block (k, y) keeps row j = 2k of the level.
// D, B the level's blocks; Dn, Bn the next level's; Lodd[k] gets the
// factor of row j + 1. R the level's right-hand sides (RHS at level 0,
// else Y), Y the output; row j of the level is row j s of both.
__global__ void __launch_bounds__(COLUMNS)
block_tridiag_down(const double* __restrict__ D, const double* __restrict__ B,
                   double* __restrict__ Dn, double* __restrict__ Bn, double* __restrict__ Lodd,
                   const double* R, double* Y, int n, int s, int r) {
  __shared__ double sD[36], sM[2][36], sL[2][36], sX[2][36], sW[2][36], sZ[36], sV[36];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k = blockIdx.x, j = 2 * k;
  const bool has[2] = {j >= 1, j + 1 < n};
  const bool hasB = j + 2 < n;
  const int col = blockIdx.y * COLUMNS + tid;
  const bool live = col < r;

  // this column's R_{j-1}, R_j, R_{j+1}, in flight while the warps factorise
  double rl[6], rc[6], rr[6];
  if (live) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      rc[a] = R[at(j * s, a, r, col)];
      rl[a] = has[0] ? R[at((j - 1) * s, a, r, col)] : 0.0;
      rr[a] = has[1] ? R[at((j + 1) * s, a, r, col)] : 0.0;
    }
  }
  if (warp < 2) {
    const int side = warp;  // 0: row j - 1, 1: row j + 1
    const Entries en(lane);
    if (side == 0)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !en.two) break;
        sD[lane + 32 * m] = D[(size_t)j * 36 + lane + 32 * m];
      }
    if (has[side]) {
      const int nb = side == 0 ? j - 1 : j + 1;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !en.two) break;
        const int e = lane + 32 * m, a = en.a[m], b = en.b[m];
        sM[side][e] = 0.5 * (D[(size_t)nb * 36 + e] + D[(size_t)nb * 36 + b * 6 + a]);
        // Wl = L^-1 B_{j-1}, Wr = L^-1 B_j^T
        sX[side][e] = side == 0 ? B[(size_t)(j - 1) * 36 + e] : B[(size_t)j * 36 + b * 6 + a];
        if (side == 1 && hasB) sZ[e] = B[(size_t)(j + 1) * 36 + e];
      }
      __syncwarp();
      chol6_warp(sM[side], sL[side], lane, en);
      if (lane < 6) lower_solve_column(sL[side], sX[side], sW[side], lane);
      if (side == 1 && hasB && lane >= 6 && lane < 12) lower_solve_column(sL[1], sZ, sV, lane - 6);
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !en.two) break;
        sW[side][lane + 32 * m] = 0.0;
      }
    }
  }
  __syncthreads();

  if (blockIdx.y == 0 && warp < 2) {
    const Entries en(lane);
    if (warp == 0) {
      // D' = sym(D_j - Wl^T Wl - Wr^T Wr); each sum is the same bits for
      // (a, b) and (b, a)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !en.two) break;
        const int a = en.a[m], b = en.b[m];
        double sl = 0.0, sr = 0.0;
#pragma unroll
        for (int q = 0; q < 6; ++q) {
          sl += sW[0][q * 6 + a] * sW[0][q * 6 + b];
          sr += sW[1][q * 6 + a] * sW[1][q * 6 + b];
        }
        const double mab = (sD[a * 6 + b] - sl) - sr, mba = (sD[b * 6 + a] - sl) - sr;
        Dn[(size_t)k * 36 + a * 6 + b] = 0.5 * (mab + mba);
      }
    } else if (has[1]) {
      // B' = -Wr^T (L^-1 B_{j+1}); L of row j + 1 for the up-sweep
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        if (m == 1 && !en.two) break;
        const int e = lane + 32 * m, a = en.a[m], b = en.b[m];
        if (hasB) {
          double acc = 0.0;
#pragma unroll
          for (int q = 0; q < 6; ++q) acc += sW[1][q * 6 + a] * sV[q * 6 + b];
          Bn[(size_t)k * 36 + e] = -acc;
        }
        Lodd[(size_t)k * 36 + e] = sL[1][e];
      }
    }
  }

  if (live) {
    // R'_j = R_j - Wl^T (L^-1 R_{j-1}) - Wr^T (L^-1 R_{j+1})
    if (has[0]) lower_solve(sL[0], rl);
    if (has[1]) lower_solve(sL[1], rr);
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      double sl = 0.0, sr = 0.0;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        sl += sW[0][q * 6 + a] * rl[q];
        sr += sW[1][q * 6 + a] * rr[q];
      }
      Y[at(j * s, a, r, col)] = (rc[a] - sl) - sr;
    }
  }
}

// The last row left: y_0 = L^-T L^-1 R_0, D its diagonal block.
__global__ void __launch_bounds__(COLUMNS)
block_tridiag_top(const double* __restrict__ D, const double* R, double* Y, int r) {
  __shared__ double sM[36], sL[36];
  const int tid = threadIdx.x, lane = tid & 31;
  const int col = blockIdx.y * COLUMNS + tid;
  const bool live = col < r;
  double x[6];
  if (live)
#pragma unroll
    for (int a = 0; a < 6; ++a) x[a] = R[at(0, a, r, col)];
  if (tid < 32) {
    const Entries en(lane);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      if (m == 1 && !en.two) break;
      sM[lane + 32 * m] = 0.5 * (D[lane + 32 * m] + D[en.b[m] * 6 + en.a[m]]);
    }
    __syncwarp();
    chol6_warp(sM, sL, lane, en);
  }
  __syncthreads();
  if (live) {
    lower_solve(sL, x);
    upper_solve(sL, x);
#pragma unroll
    for (int a = 0; a < 6; ++a) Y[at(0, a, r, col)] = x[a];
  }
}

// One level's up-sweep: block (k, y) solves row o = 2k + 1 of the level
// from its own equation, its neighbours' y already in Y.
__global__ void __launch_bounds__(COLUMNS)
block_tridiag_up(const double* __restrict__ B, const double* __restrict__ Lodd, const double* R,
                 double* Y, int n, int s, int r) {
  __shared__ double sL[36], sBl[36], sBr[36];
  const int tid = threadIdx.x;
  const int k = blockIdx.x, o = 2 * k + 1;
  const bool hasR = o + 1 < n;
  const int col = blockIdx.y * COLUMNS + tid;
  const bool live = col < r;
  double v[6], yl[6], yr[6];
  if (live) {
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      v[a] = R[at(o * s, a, r, col)];
      yl[a] = Y[at((o - 1) * s, a, r, col)];
      yr[a] = hasR ? Y[at((o + 1) * s, a, r, col)] : 0.0;
    }
  }
  for (int e = tid; e < 108; e += COLUMNS) {
    if (e < 36) {
      sL[e] = Lodd[(size_t)k * 36 + e];
    } else if (e < 72) {
      sBl[e - 36] = B[(size_t)(o - 1) * 36 + e - 36];
    } else {
      sBr[e - 72] = hasR ? B[(size_t)o * 36 + e - 72] : 0.0;
    }
  }
  __syncthreads();
  if (live) {
    // v = R_o - B_{o-1}^T y_{o-1} - B_o y_{o+1}
#pragma unroll
    for (int a = 0; a < 6; ++a) {
      double sl = 0.0, sr = 0.0;
#pragma unroll
      for (int q = 0; q < 6; ++q) {
        sl += sBl[q * 6 + a] * yl[q];
        sr += sBr[a * 6 + q] * yr[q];
      }
      v[a] = (v[a] - sl) - sr;
    }
    lower_solve(sL, v);
    upper_solve(sL, v);
#pragma unroll
    for (int a = 0; a < 6; ++a) Y[at(o * s, a, r, col)] = v[a];
  }
}

// The levels of a solve of K rows: `count` levels with more than one row,
// n[l] rows at level l, and offsets (in doubles) into the scratch of each
// level's factors of its eliminated rows and, from level 1 on, its D and
// B; `total` doubles in all.
struct Levels {
  int count;
  int n[MAX_LEVELS + 1];
  int64_t lodd[MAX_LEVELS], d[MAX_LEVELS + 1], b[MAX_LEVELS + 1];
  int64_t total;
  explicit Levels(int K) : count(0), total(0) {
    n[0] = K;
    while (n[count] > 1) {
      const int m = n[count], next = (m + 1) / 2;
      lodd[count] = total;
      total += (int64_t)(m / 2) * 36;
      d[count + 1] = total;
      total += (int64_t)next * 36;
      b[count + 1] = total;
      total += (int64_t)(next - 1) * 36;
      n[++count] = next;
    }
  }
};

}  // namespace

// Doubles of scratch a solve of K rows needs, whatever its columns.
extern "C" int64_t block_tridiag_scratch(int K) { return K < 1 ? 0 : Levels(K).total; }

extern "C" int block_tridiag_launch(const double* D, const double* Boff, const double* RHS,
                                    double* Y, double* scratch, int K, int r, void* stream) {
  if (K < 1 || r < 0) return REFUSED;
  if (r == 0) return 0;
  const Levels lv(K);
  const cudaStream_t st = (cudaStream_t)stream;
  const int cb = (r + COLUMNS - 1) / COLUMNS;
  const double* Dl[MAX_LEVELS + 1];
  const double* Bl[MAX_LEVELS + 1];
  Dl[0] = D;
  Bl[0] = Boff;
  for (int l = 1; l <= lv.count; ++l) {
    Dl[l] = scratch + lv.d[l];
    Bl[l] = scratch + lv.b[l];
  }
  int s = 1;
  for (int l = 0; l < lv.count; ++l, s *= 2) {
    const int n = lv.n[l];
    block_tridiag_down<<<dim3((n + 1) / 2, cb), COLUMNS, 0, st>>>(
        Dl[l], Bl[l], scratch + lv.d[l + 1], scratch + lv.b[l + 1], scratch + lv.lodd[l],
        l == 0 ? RHS : Y, Y, n, s, r);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  block_tridiag_top<<<dim3(1, cb), COLUMNS, 0, st>>>(Dl[lv.count], lv.count == 0 ? RHS : Y, Y,
                                                     r);
  int err = (int)cudaGetLastError();
  if (err) return err;
  for (int l = lv.count - 1; l >= 0; --l) {
    s /= 2;
    const int n = lv.n[l];
    block_tridiag_up<<<dim3(n / 2, cb), COLUMNS, 0, st>>>(Bl[l], scratch + lv.lodd[l],
                                                          l == 0 ? RHS : Y, Y, n, s, r);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  return 0;
}
