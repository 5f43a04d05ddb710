// Block-tridiagonal SPD solve T Y = RHS by block Thomas, in f64:
// D (K, 6, 6) the diagonal blocks, Boff (K-1, 6, 6) with T[i, i+1] =
// Boff[i] (and T[i+1, i] = Boff[i]^T), RHS and Y (K, 6, r), all contiguous.
//
// Not a port of a TPU kernel: it replaces the two lax.scans of the JAX
// package's posegraph._block_tridiag_solve (malio_tpu/posegraph.py:243,
// :251), the odometry chain's exact solve inside optimize_sparse. The
// port's plain version (ops/block_tridiag.py: block_tridiag_solve_plain)
// runs the same recursion op by op, ~90 launches a step.
//
// Bound: neither bytes nor operations. D, Boff and RHS read once and Y
// written once (77 MB at K = 2048, r = 385: 0.023 ms at 3.35 TB/s); 216
// f64 operations a column a step (0.005 ms at 34 TFLOP/s). What limits it
// is the recursion: K dependent steps of a 6x6 factorisation in the
// forward sweep, K dependent 6-vector updates in the back substitution.
//
// Design: the algorithm of the plain version, unrolled as the JAX package
// keeps it (rank-1 downdates with the pivot floored at 1e-30, forward
// substitution for V = L^-1, Sinv = V^T V, S symmetrised first), each
// product summed in a fixed k order. Where the plain version divides by a
// pivot or by L's diagonal (which is the pivot), the kernel multiplies by
// the pivot's reciprocal square root: no division on the chain.
//   - Columns are independent chains: W_i = Sinv_i (R_i - B_{i-1}^T W_{i-1})
//     forward, Y_i = W_i - C_i Y_{i+1} back. One thread a column carries
//     its 6-vector in registers; blocks of COLUMNS threads split the r
//     columns.
//   - The 6x6 chain (S_i = D_i - B_{i-1}^T C_{i-1}, Sinv_i, C_i =
//     Sinv_i B_i) depends only on D and Boff. Warp 0 of every block
//     computes it in shared memory, a lane an entry, while the block
//     waits at the step's barrier; then every thread takes its column's
//     step with that Sinv_i. Each block recomputes the chain: its steps
//     cost the same in every block, run in parallel, and need no
//     communication between blocks, so the solve is one launch. Warp 0
//     loads the next step's blocks while it factorises this one's.
//   - W_i goes to Y, C_i to the block's slice of a scratch buffer
//     (blocks x K x 36 doubles, the wrapper's); the back substitution
//     reads both (a step ahead) and overwrites Y in place.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int COLUMNS = 128;  // threads (columns) a block
constexpr int REFUSED = (int)cudaErrorInvalidValue;

__global__ void __launch_bounds__(COLUMNS)
block_tridiag_kernel(const double* __restrict__ D, const double* __restrict__ Boff,
                     const double* __restrict__ RHS, double* Y, double* Cs, int K, int r) {
  __shared__ double sBp[36], sBc[36], sC[36], sM[36], sL[36], sV[36], sSinv[36], sIpiv[6];
  const int tid = threadIdx.x, lane = tid & 31;
  const bool chain = tid < 32;
  const int col = blockIdx.x * COLUMNS + tid;
  const bool live = col < r;
  double* Cb = Cs + (size_t)blockIdx.x * K * 36;
  // the entries of a 6x6 block a lane owns: lane, and lane + 32 for lanes
  // 0-3 (loops over them run to 2, predicated, so they stay in registers)
  const bool two = lane < 4;
  int ea[2], eb[2];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    const int e = (lane + 32 * n) % 36;
    ea[n] = e / 6;
    eb[n] = e % 6;
  }

  // warp 0's next blocks: D_i, Boff[i-1], Boff[i] at step i
  double nD[2] = {0.0, 0.0}, nBp[2] = {0.0, 0.0}, nBc[2] = {0.0, 0.0};
  if (chain) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      if (n == 1 && !two) break;
      const int e = lane + 32 * n;
      nD[n] = D[e];
      nBc[n] = K > 1 ? Boff[e] : 0.0;
      sC[e] = 0.0;
    }
  }
  double w[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};  // W_{i-1} of this column
  double nR[6];
  if (live)
#pragma unroll
    for (int a = 0; a < 6; ++a) nR[a] = RHS[(size_t)a * r + col];

  for (int i = 0; i < K; ++i) {
    if (chain) {
      double Di[2], Dt[2];
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
        const int e = lane + 32 * n;
        sBp[e] = nBp[n];
        sBc[e] = nBc[n];
        Di[n] = nD[n];
        sM[e] = nD[n];  // D_i, whose (b, a) entry the lane of (a, b) reads below
      }
      if (i + 1 < K) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n == 1 && !two) break;
          const int e = lane + 32 * n;
          nD[n] = D[(size_t)(i + 1) * 36 + e];
          nBp[n] = Boff[(size_t)i * 36 + e];
          nBc[n] = i + 1 < K - 1 ? Boff[(size_t)(i + 1) * 36 + e] : 0.0;
        }
      }
      __syncwarp();
      // S = D_i - B_{i-1}^T C_{i-1}; M = (S + S^T) / 2
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
        const int a = ea[n], b = eb[n];
        Dt[n] = sM[b * 6 + a];
        double sab = 0.0, sba = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          sab += sBp[k * 6 + a] * sC[k * 6 + b];
          sba += sBp[k * 6 + b] * sC[k * 6 + a];
        }
        Di[n] = 0.5 * ((Di[n] - sab) + (Dt[n] - sba));
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
        sM[ea[n] * 6 + eb[n]] = Di[n];
      }
      __syncwarp();
      // Cholesky by rank-1 downdates: column j of L is M[:, j] / pivot from
      // the diagonal down, then M -= col col^T. The pivot's reciprocal
      // (rsqrt) multiplies; it is also 1 / L[j, j], which V takes below.
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const double ipiv = rsqrt(fmax(sM[j * 6 + j], 1e-30));
        double upd[2];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int a = ea[n], b = eb[n];
          const double ca = a >= j ? sM[a * 6 + j] * ipiv : 0.0;
          const double cb = b >= j ? sM[b * 6 + j] * ipiv : 0.0;
          upd[n] = ca * cb;
        }
        const double lc = (lane < 6 && lane >= j) ? sM[lane * 6 + j] * ipiv : 0.0;
        __syncwarp();
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          if (n == 1 && !two) break;
          sM[ea[n] * 6 + eb[n]] -= upd[n];
        }
        if (lane < 6) sL[lane * 6 + j] = lc;
        if (lane == 0) sIpiv[j] = ipiv;
        __syncwarp();
      }
      // V = L^-1 by forward substitution, a row at a time
#pragma unroll
      for (int ii = 0; ii < 6; ++ii) {
        if (lane < 6) {
          double s = 0.0;
#pragma unroll
          for (int k = 0; k < ii; ++k) s += sL[ii * 6 + k] * sV[k * 6 + lane];
          sV[ii * 6 + lane] = ((ii == lane ? 1.0 : 0.0) - s) * sIpiv[ii];
        }
        __syncwarp();
      }
      // Sinv = V^T V, then C_i = Sinv B_i
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
        const int a = ea[n], b = eb[n];
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += sV[k * 6 + a] * sV[k * 6 + b];
        sSinv[a * 6 + b] = s;
      }
      __syncwarp();
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        if (n == 1 && !two) break;
        const int a = ea[n], b = eb[n];
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += sSinv[a * 6 + k] * sBc[k * 6 + b];
        sC[a * 6 + b] = s;
        Cb[(size_t)i * 36 + a * 6 + b] = s;
      }
    }
    __syncthreads();
    if (live) {
      double rhs[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += sBp[k * 6 + a] * w[k];
        rhs[a] = nR[a] - s;
      }
      if (i + 1 < K)
#pragma unroll
        for (int a = 0; a < 6; ++a) nR[a] = RHS[((size_t)(i + 1) * 6 + a) * r + col];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += sSinv[a * 6 + k] * rhs[k];
        w[a] = s;
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) Y[((size_t)i * 6 + a) * r + col] = w[a];
    }
    __syncthreads();
  }

  // back substitution: Y_i = W_i - C_i Y_{i+1}, step i - 1's C and W
  // loaded while step i computes
  if (live) {
    double y[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0};
    double c[36], wi[6];
#pragma unroll
    for (int e = 0; e < 36; ++e) c[e] = Cb[(size_t)(K - 1) * 36 + e];
#pragma unroll
    for (int a = 0; a < 6; ++a) wi[a] = Y[((size_t)(K - 1) * 6 + a) * r + col];
    for (int i = K - 1; i >= 0; --i) {
      double yn[6];
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        double s = 0.0;
#pragma unroll
        for (int k = 0; k < 6; ++k) s += c[a * 6 + k] * y[k];
        yn[a] = wi[a] - s;
      }
      if (i > 0) {
#pragma unroll
        for (int e = 0; e < 36; ++e) c[e] = Cb[(size_t)(i - 1) * 36 + e];
#pragma unroll
        for (int a = 0; a < 6; ++a) wi[a] = Y[((size_t)(i - 1) * 6 + a) * r + col];
      }
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        y[a] = yn[a];
        Y[((size_t)i * 6 + a) * r + col] = yn[a];
      }
    }
  }
}

}  // namespace

// Doubles of scratch a solve of K steps and r columns needs.
extern "C" int64_t block_tridiag_scratch(int K, int r) {
  return (int64_t)((r + COLUMNS - 1) / COLUMNS) * K * 36;
}

extern "C" int block_tridiag_launch(const double* D, const double* Boff, const double* RHS,
                                    double* Y, double* scratch, int K, int r, void* stream) {
  if (K < 1 || r < 0) return REFUSED;
  if (r == 0) return 0;
  const int blocks = (r + COLUMNS - 1) / COLUMNS;
  block_tridiag_kernel<<<blocks, COLUMNS, 0, (cudaStream_t)stream>>>(D, Boff, RHS, Y, scratch,
                                                                     K, r);
  return (int)cudaGetLastError();
}
