// Spline deskew for Hopper (sm_90a).
//
// Replaces the TPU kernel malio_tpu/ops/deskew_pallas.py:deskew_points
// (body _kernel). For each point p with time t: the uniform cubic SE(3)
// B-spline pose at t, j = floor((t - t0) / dt) with 1 <= j <= num_valid - 3
// (else the point is outside the window), three SE(3) exps of the interval
// logs composed onto control pose j - 1; then
//   p' = ext^T (lt^T (R(t) (ext p + t_ext) + t(t) - t_lt) - t_ext)
// Returns (x, y, z, ok); a point outside the spline window is unchanged.
// The interval index DIVIDES by dt like spline.get_pose (the TPU kernel
// multiplied by 1/dt), with __fdiv_rn / __fsub_rn so nvcc contracts
// nothing there: the ok flags equal the plain version's exactly.
//
// What bounds it. A launch moves 32 B per point (0.4 MB at the flagship
// path's 3 x 4096 points, 6.3 MB at the Config default of 3 x 65,536)
// and does ~560 f32 operations per point inside the window. At the
// path's size both are a fraction of a microsecond, under what a launch
// costs on its own: the time is the launch, two dependent memory round
// trips (the point, then its interval's spline rows) and one point's
// chain of three exps (each a square root, a sine / cosine and three
// divisions) and three dependent 3x3 compositions. At the default
// capacity there are enough points to hide that latency, and the
// instructions per point set the time (one lane per point there stays
// ~5x above the byte bound).
//
// Design, against each of those (chip_smoke.py times both layouts):
// - Three lanes per point (LANES = 3) while the points are few: lane s
//   of a point computes exp(b_s d_{j-1+s}) in parallel; lane 0 receives
//   A1 and A2 by __shfl_sync and composes P_{j-1} A0 A1 A2 left to right
//   in the order of the one-lane layout. The two layouts still give some
//   points other last bits, so a slice of a larger point set (a rank's
//   share) is launched in the whole set's layout
//   (ops/deskew.deskew_points, `layout_points`; the card tests check it).
//   A warp holds 10 points in lanes 0-29; lanes 30-31
//   hold none. Every lane of the warp reaches the shuffles (full mask):
//   lanes of a point outside the window, of the ragged end and lanes
//   30-31 compute nothing and send values no lane reads. A warp may hold
//   points of two LiDARs; each lane reads its own LiDAR's frame. 40
//   points per 128-thread block put the path's 12,288 points in 308
//   blocks over all 132 SMs (one lane per point: 96 blocks). The spline
//   is read through the read-only cache: staging it costs each block a
//   prologue that a few points do not win back.
// - One lane per point (LANES = 1) when the points alone fill the card,
//   as at the default capacity: there instruction slots are the limit,
//   and lanes 1-2 of a three-lane point would idle through its
//   composition. Each block first stages the spline tables (C x 16
//   control poses, C x 6 logs) in shared memory, which saves the L1
//   misses of random intervals. The wrapper picks the layout from the
//   point count.
// - Per-LiDAR frames once per block: the quaternion-to-matrix conversions
//   of the extrinsic and the scan-end pose (as so3.quat_to_mat), the
//   translations, t0 and num_valid go to shared memory at block start
//   instead of being rebuilt for every point; the point's load goes out
//   first, so the two round trips overlap.
// - A batch of B independent sequences (each its own points, spline and
//   frames) runs in one launch: block row blockIdx.y = b works on
//   sequence b alone, so a block's frames and staged spline are one
//   sequence's and no warp or block straddles two sequences.
// - The launcher refuses more than MAX_LIDARS LiDARs, MAX_CONTROL_POINTS
//   control points or MAX_SEQUENCES sequences (returns REFUSED, which the
//   wrapper raises as a ValueError) before it launches anything.
// - The translation is composed relative to the scan-end pose: the two
//   world positions, tens of metres from the origin on a run, cancel
//   first, and no sum rounds at the ulp of a world coordinate.
// - sincosf: one range reduction for both, where separate sinf and cosf
//   each did their own. Not __sinf / __cosf / __fdividef: at |n| ~ 1e-3
//   their absolute error becomes a relative one of ~1e-4 in sin(n)/n, and
//   (1 - cos n) / n^2 cancels. Its Payne-Hanek slow path (|n| > ~1e5,
//   never taken: n <= pi) keeps a 32-byte stack frame in the build.
// - The small-angle series 1 - n2/6, 1/2 - n2/24, 1/6 - n2/120 round to
//   1, 1/2 and 1/6 in f32 for n2 < 1e-12, so they are those constants.
#include <cuda_runtime.h>

constexpr int MAX_LIDARS = 32;
constexpr int THREADS = 128;
constexpr int POINTS_PER_WARP3 = 10;  // LANES = 3: lanes 0-29
// LANES = 1 stages the spline (22 floats a control point) in dynamic
// shared memory beside the 3 KB of frames, under the 48 KB a block gets
// without an opt-in
constexpr int MAX_CONTROL_POINTS = 44 * 1024 / (22 * 4);
constexpr int MAX_SEQUENCES = 65535;  // gridDim.y
constexpr int REFUSED = -1;
constexpr unsigned FULL = 0xffffffffu;

struct M3 {
  float a[9];
};

struct Frame {  // one LiDAR's extrinsic and scan-end pose
  M3 eR;
  float et[3];
  M3 lR;
  float lt[3];
};

template <bool SH>
__device__ __forceinline__ float ld(const float* p) {
  if constexpr (SH) {
    return *p;
  } else {
    return __ldg(p);
  }
}

__device__ __forceinline__ M3 mul(const M3& x, const M3& y) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.a[3 * i + j] = x.a[3 * i] * y.a[j] + x.a[3 * i + 1] * y.a[3 + j] +
                       x.a[3 * i + 2] * y.a[6 + j];
  return r;
}

__device__ __forceinline__ void mv(const M3& m, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = m.a[3 * i] * v[0] + m.a[3 * i + 1] * v[1] + m.a[3 * i + 2] * v[2];
}

__device__ __forceinline__ void mtv(const M3& m, const float* v, float* o) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = m.a[i] * v[0] + m.a[3 + i] * v[1] + m.a[6 + i] * v[2];
}

// rotation matrix of a unit quaternion [w, x, y, z] (so3.quat_to_mat)
__device__ __forceinline__ M3 quat_mat(const float* __restrict__ q) {
  const float w = __ldg(q), x = __ldg(q + 1), y = __ldg(q + 2),
              z = __ldg(q + 3);
  const float xx = x * x, yy = y * y, zz = z * z;
  const float wx = w * x, wy = w * y, wz = w * z;
  const float xy = x * y, xz = x * z, yz = y * z;
  M3 R;
  R.a[0] = 1.0f - 2.0f * (yy + zz);
  R.a[1] = 2.0f * (xy - wz);
  R.a[2] = 2.0f * (xz + wy);
  R.a[3] = 2.0f * (xy + wz);
  R.a[4] = 1.0f - 2.0f * (xx + zz);
  R.a[5] = 2.0f * (yz - wx);
  R.a[6] = 2.0f * (xz - wy);
  R.a[7] = 2.0f * (yz + wx);
  R.a[8] = 1.0f - 2.0f * (xx + yy);
  return R;
}

// cubic B-spline basis weight b_s at fraction u
__device__ __forceinline__ float basis(int s, float u) {
  if (s == 0) return (5.0f + 3.0f * u - 3.0f * u * u + u * u * u) / 6.0f;
  if (s == 1) return (1.0f + 3.0f * u + 3.0f * u * u - 2.0f * u * u * u) / 6.0f;
  return (u * u * u) / 6.0f;
}

// exp of the twist b * d (d = [w(3), u(3)]): rotation R and translation V u.
template <bool SH>
__device__ __forceinline__ void exp_se3(float b, const float* d, M3& R,
                                        float* t) {
  const float w0 = b * ld<SH>(d + 0), w1 = b * ld<SH>(d + 1),
              w2 = b * ld<SH>(d + 2);
  const float u0 = b * ld<SH>(d + 3), u1 = b * ld<SH>(d + 4),
              u2 = b * ld<SH>(d + 5);
  const float n2 = w0 * w0 + w1 * w1 + w2 * w2;
  float A, B, C;
  if (n2 < 1e-12f) {
    A = 1.0f;
    B = 0.5f;
    C = 1.0f / 6.0f;
  } else {
    const float n = sqrtf(n2);
    float sn, cs;
    sincosf(n, &sn, &cs);
    A = sn / n;
    B = (1.0f - cs) / n2;
    C = (1.0f - A) / n2;
  }
  // R = I + A hat(w) + B hat(w)^2
  R.a[0] = 1.0f - B * (w1 * w1 + w2 * w2);
  R.a[1] = -A * w2 + B * (w0 * w1);
  R.a[2] = A * w1 + B * (w0 * w2);
  R.a[3] = A * w2 + B * (w0 * w1);
  R.a[4] = 1.0f - B * (w0 * w0 + w2 * w2);
  R.a[5] = -A * w0 + B * (w1 * w2);
  R.a[6] = -A * w1 + B * (w0 * w2);
  R.a[7] = A * w0 + B * (w1 * w2);
  R.a[8] = 1.0f - B * (w0 * w0 + w1 * w1);
  // t = (I + B hat(w) + C hat(w)^2) u
  const float x0 = w1 * u2 - w2 * u1, x1 = w2 * u0 - w0 * u2,
              x2 = w0 * u1 - w1 * u0;
  const float y0 = w1 * x2 - w2 * x1, y1 = w2 * x0 - w0 * x2,
              y2 = w0 * x1 - w1 * x0;
  t[0] = u0 + B * x0 + C * y0;
  t[1] = u1 + B * x1 + C * y1;
  t[2] = u2 + B * x2 + C * y2;
}

// [P | Pt] <- [P | Pt] [A | At]
__device__ __forceinline__ void compose(M3& P, float* Pt, const M3& A,
                                        const float* At) {
  float o[3];
  mv(P, At, o);
  Pt[0] += o[0];
  Pt[1] += o[1];
  Pt[2] += o[2];
  P = mul(P, A);
}

// pose(t) = P_{j-1} A0 A1 A2 (row-major 4x4 control pose c), then the
// point from its LiDAR's frame into that LiDAR's scan-end frame
template <bool SH>
__device__ __forceinline__ float4 deskew_one(float4 p, const float* c,
                                             const M3& A0, const float* t0,
                                             const M3& A1, const float* t1,
                                             const M3& A2, const float* t2,
                                             const Frame& f) {
  M3 P;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) P.a[3 * r + k] = ld<SH>(c + 4 * r + k);
  // translation relative to the scan-end position (see the note above)
  float Pt[3] = {ld<SH>(c + 3) - f.lt[0], ld<SH>(c + 7) - f.lt[1],
                 ld<SH>(c + 11) - f.lt[2]};
  compose(P, Pt, A0, t0);
  compose(P, Pt, A1, t1);
  compose(P, Pt, A2, t2);

  const float v[3] = {p.x, p.y, p.z};
  float pe[3], pw[3], pl[3], pb[3];
  mv(f.eR, v, pe);
  pe[0] += f.et[0];
  pe[1] += f.et[1];
  pe[2] += f.et[2];
  mv(P, pe, pw);
  pw[0] += Pt[0];
  pw[1] += Pt[1];
  pw[2] += Pt[2];
  mtv(f.lR, pw, pl);
  pl[0] -= f.et[0];
  pl[1] -= f.et[1];
  pl[2] -= f.et[2];
  mtv(f.eR, pl, pb);
  return make_float4(pb[0], pb[1], pb[2], 1.0f);
}

template <int LANES>
__global__ void __launch_bounds__(THREADS)
    deskew_kernel(const float* __restrict__ pts, int L, int N,
                  const float* __restrict__ cps,
                  const float* __restrict__ logs, int C,
                  const float* __restrict__ t0p, const int* __restrict__ nvp,
                  const float* __restrict__ ext_q,
                  const float* __restrict__ ext_t,
                  const float* __restrict__ lt_q,
                  const float* __restrict__ lt_t, float dt,
                  float* __restrict__ out) {
  // pts, out: (B, L, N, 4); cps (B, C, 16); logs (B, C, 6); t0p, nvp (B);
  // ext_q, lt_q (B, L, 4); ext_t, lt_t (B, L, 3)
  constexpr bool SH = LANES == 1;  // the spline staged in shared memory
  __shared__ Frame fr[MAX_LIDARS];
  __shared__ float s_t0;
  __shared__ int s_nv;
  extern __shared__ float tab[];  // SH: C x 16 control poses, C x 6 logs
  // this block's sequence: its points, spline and frames
  const long b = blockIdx.y;
  pts += b * L * N * 4;
  out += b * L * N * 4;
  cps += b * C * 16;
  logs += b * C * 6;
  t0p += b;
  nvp += b;
  ext_q += b * L * 4;
  ext_t += b * L * 3;
  lt_q += b * L * 4;
  lt_t += b * L * 3;
  const int lane = threadIdx.x & 31;
  const int s = LANES == 1 ? 0 : lane % 3;  // this lane's exp
  const long tid = (long)blockIdx.x * THREADS + threadIdx.x;
  const long i =
      LANES == 1 ? tid : (tid >> 5) * POINTS_PER_WARP3 + lane / 3;
  const bool live = (LANES == 1 || lane < 3 * POINTS_PER_WARP3) &&
                    i < (long)L * N;
  // the point's load goes out before the block's frames are built, so
  // the two memory round trips overlap
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (live) p = reinterpret_cast<const float4*>(pts)[i];

  for (int l = threadIdx.x; l < L; l += THREADS) {
    fr[l].eR = quat_mat(ext_q + 4 * l);
    fr[l].lR = quat_mat(lt_q + 4 * l);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      fr[l].et[k] = __ldg(ext_t + 3 * l + k);
      fr[l].lt[k] = __ldg(lt_t + 3 * l + k);
    }
  }
  if (threadIdx.x == 0) {
    s_t0 = __ldg(t0p);
    s_nv = __ldg(nvp);
  }
  if constexpr (SH) {
#pragma unroll 4
    for (int k = threadIdx.x; k < C * 16; k += THREADS) tab[k] = __ldg(cps + k);
#pragma unroll 4
    for (int k = threadIdx.x; k < C * 6; k += THREADS)
      tab[C * 16 + k] = __ldg(logs + k);
  }
  __syncthreads();
  const float* cp = SH ? tab : cps;
  const float* lg = SH ? tab + C * 16 : logs;

  const float rel = __fdiv_rn(__fsub_rn(p.w, s_t0), dt);
  const float jf = floorf(rel);
  const bool ok = live && (jf >= 1.0f) && (jf + 2.0f <= (float)(s_nv - 1));
  const int j = ok ? (int)jf : 1;  // ok implies 1 <= j <= nv - 3
  const float u = __fsub_rn(rel, jf);

  M3 A[3];
  float At[3][3];
  if constexpr (LANES == 1) {
    if (ok) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        exp_se3<SH>(basis(k, u), lg + (long)(j - 1 + k) * 6, A[k], At[k]);
    }
  } else {
    M3 Am = {};
    float Atm[3] = {0.0f, 0.0f, 0.0f};
    if (ok) exp_se3<SH>(basis(s, u), lg + (long)(j - 1 + s) * 6, Am, Atm);
    // every lane takes part; only lane 0 of a point reads what it gets
    const int src = lane - s;
#pragma unroll
    for (int k = 0; k < 9; ++k) {
      A[0].a[k] = Am.a[k];
      A[1].a[k] = __shfl_sync(FULL, Am.a[k], src + 1);
      A[2].a[k] = __shfl_sync(FULL, Am.a[k], src + 2);
    }
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      At[0][k] = Atm[k];
      At[1][k] = __shfl_sync(FULL, Atm[k], src + 1);
      At[2][k] = __shfl_sync(FULL, Atm[k], src + 2);
    }
    if (s != 0) return;
  }
  if (!live) return;
  float4* o = reinterpret_cast<float4*>(out) + i;
  if (!ok) {
    *o = make_float4(p.x, p.y, p.z, 0.0f);
    return;
  }
  const int l = (int)(i / N);
  *o = deskew_one<SH>(p, cp + (long)(j - 1) * 16, A[0], At[0], A[1], At[1],
                      A[2], At[2], fr[l]);
}

template <int LANES>
static void launch(int B, long total, cudaStream_t st, const float* pts,
                   int L, int N, const float* cps, const float* logs, int C,
                   const float* t0, const int* nv, const float* ext_q,
                   const float* ext_t, const float* lt_q, const float* lt_t,
                   float dt, float* out) {
  const long per_block = LANES == 1 ? THREADS : THREADS / 32 * POINTS_PER_WARP3;
  const dim3 grid((unsigned)((total + per_block - 1) / per_block), (unsigned)B);
  const size_t smem = LANES == 1 ? (size_t)C * 22 * sizeof(float) : 0;
  deskew_kernel<LANES><<<grid, THREADS, smem, st>>>(
      pts, L, N, cps, logs, C, t0, nv, ext_q, ext_t, lt_q, lt_t, dt, out);
}

// B sequences of L LiDARs x N points; lanes: 1 or 3 per point, as the
// wrapper picks them from B * L * N. Returns REFUSED for what the kernel
// does not take, else the CUDA error of the launch.
extern "C" int deskew_launch(const float* pts, int B, int L, int N,
                             const float* cps, const float* logs, int C,
                             const float* t0, const int* num_valid,
                             const float* ext_q, const float* ext_t,
                             const float* lt_q, const float* lt_t, float dt,
                             int lanes, float* out, void* stream) {
  if (B < 0 || B > MAX_SEQUENCES || L < 1 || L > MAX_LIDARS || N < 0 ||
      C < 1 || C > MAX_CONTROL_POINTS || (lanes != 1 && lanes != 3))
    return REFUSED;
  const long total = (long)L * N;  // points of one sequence
  if (total == 0 || B == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (lanes == 3)
    launch<3>(B, total, st, pts, L, N, cps, logs, C, t0, num_valid, ext_q,
              ext_t, lt_q, lt_t, dt, out);
  else
    launch<1>(B, total, st, pts, L, N, cps, logs, C, t0, num_valid, ext_q,
              ext_t, lt_q, lt_t, dt, out);
  return (int)cudaGetLastError();
}
