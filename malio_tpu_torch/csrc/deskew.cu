// Spline deskew for Hopper (sm_90a).
//
// Replaces the TPU kernel malio_tpu/ops/deskew_pallas.py:deskew_points
// (body _kernel). For each point p with time t: the uniform cubic SE(3)
// B-spline pose at t, j = floor((t - t0) / dt) clamped to
// [1, num_valid - 3], three SE(3) exps of the interval logs composed onto
// control pose j - 1; then
//   p' = ext^T (lt^T (R(t) (ext p + t_ext) + t(t) - t_lt) - t_ext)
// Returns (x, y, z, ok); a point outside the spline window is unchanged.
// The interval index DIVIDES by dt like spline.get_pose (the TPU kernel
// multiplied by 1/dt), so the ok flags equal the plain version's exactly.
//
// Bound: neither memory nor arithmetic at the path's size. It reads 16 B
// and writes 16 B per point (12288 points per round: 0.4 MB, ~0.12 us at
// 3.35 TB/s) and does ~500 f32 operations per point inside the window
// (~0.1 us at 67 TFLOP/s), so a launch costs its fixed overhead. The
// design therefore keeps every other operation off the launch: the
// kernel reads the spline's (C, 4, 4) control poses and the per-LiDAR
// extrinsic / scan-end quaternions as the path holds them, so the wrapper
// launches no conversion kernels of its own.
//
// Design: one thread per point, all LiDARs in one launch (LiDAR l = point
// index / N). The control tables are read by plain indexed loads through
// the read-only cache; the TPU's one-hot matmul gather is not needed.
#include <cuda_runtime.h>

struct M3 {
  float a[9];
};

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

// exp of the twist b * d (d = [w(3), u(3)]): rotation R and translation V u.
__device__ void exp_se3(float b, const float* __restrict__ d, M3& R,
                        float* t) {
  const float w0 = b * __ldg(d + 0), w1 = b * __ldg(d + 1),
              w2 = b * __ldg(d + 2);
  const float u0 = b * __ldg(d + 3), u1 = b * __ldg(d + 4),
              u2 = b * __ldg(d + 5);
  const float n2 = w0 * w0 + w1 * w1 + w2 * w2;
  const bool small = n2 < 1e-12f;
  const float n = sqrtf(small ? 1.0f : n2);
  const float n2s = small ? 1.0f : n2;
  const float A = small ? 1.0f - n2 / 6.0f : sinf(n) / n;
  const float B = small ? 0.5f - n2 / 24.0f : (1.0f - cosf(n)) / n2s;
  const float C = small ? 1.0f / 6.0f - n2 / 120.0f : (1.0f - A) / n2s;
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

__global__ void deskew_kernel(const float* __restrict__ pts, int L, int N,
                              const float* __restrict__ cps,
                              const float* __restrict__ logs,
                              const float* __restrict__ t0p,
                              const int* __restrict__ nvp,
                              const float* __restrict__ ext_q,
                              const float* __restrict__ ext_t,
                              const float* __restrict__ lt_q,
                              const float* __restrict__ lt_t, float dt,
                              float* __restrict__ out) {
  const long i = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long)L * N) return;
  const int l = (int)(i / N);
  const float4 p = reinterpret_cast<const float4*>(pts)[i];
  const float t0 = __ldg(t0p);
  const int nv = __ldg(nvp);

  const float rel = __fdiv_rn(__fsub_rn(p.w, t0), dt);
  const float jf = floorf(rel);
  const bool ok = (jf >= 1.0f) && (jf + 2.0f <= (float)(nv - 1));
  if (!ok) {
    reinterpret_cast<float4*>(out)[i] = make_float4(p.x, p.y, p.z, 0.0f);
    return;
  }
  const int j = (int)jf;  // ok implies 1 <= j <= nv - 3: no clamp needed
  const float u = __fsub_rn(rel, jf);
  const float b0 = (5.0f + 3.0f * u - 3.0f * u * u + u * u * u) / 6.0f;
  const float b1 = (1.0f + 3.0f * u + 3.0f * u * u - 2.0f * u * u * u) / 6.0f;
  const float b2 = (u * u * u) / 6.0f;

  // control pose j - 1: rows of a 4x4 [R t; 0 1]
  const float* c = cps + (long)(j - 1) * 16;
  M3 P;
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int k = 0; k < 3; ++k) P.a[3 * r + k] = __ldg(c + 4 * r + k);
  float Pt[3] = {__ldg(c + 3), __ldg(c + 7), __ldg(c + 11)};
  const float bs[3] = {b0, b1, b2};
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    M3 A;
    float At[3], o[3];
    exp_se3(bs[s], logs + (long)(j - 1 + s) * 6, A, At);
    mv(P, At, o);
    Pt[0] += o[0];
    Pt[1] += o[1];
    Pt[2] += o[2];
    P = mul(P, A);
  }

  const M3 eR = quat_mat(ext_q + 4 * l);
  const M3 lR = quat_mat(lt_q + 4 * l);
  const float et[3] = {__ldg(ext_t + 3 * l), __ldg(ext_t + 3 * l + 1),
                       __ldg(ext_t + 3 * l + 2)};
  const float v[3] = {p.x, p.y, p.z};
  float pe[3], pw[3], pl[3], pb[3];
  mv(eR, v, pe);
  pe[0] += et[0];
  pe[1] += et[1];
  pe[2] += et[2];
  mv(P, pe, pw);
  pw[0] += Pt[0] - __ldg(lt_t + 3 * l);
  pw[1] += Pt[1] - __ldg(lt_t + 3 * l + 1);
  pw[2] += Pt[2] - __ldg(lt_t + 3 * l + 2);
  mtv(lR, pw, pl);
  pl[0] -= et[0];
  pl[1] -= et[1];
  pl[2] -= et[2];
  mtv(eR, pl, pb);
  reinterpret_cast<float4*>(out)[i] = make_float4(pb[0], pb[1], pb[2], 1.0f);
}

extern "C" int deskew_launch(const float* pts, int L, int N, const float* cps,
                             const float* logs, const float* t0,
                             const int* num_valid, const float* ext_q,
                             const float* ext_t, const float* lt_q,
                             const float* lt_t, float dt, float* out,
                             void* stream) {
  const long total = (long)L * N;
  if (total <= 0) return 0;
  const int threads = 256;
  const int blocks = (int)((total + threads - 1) / threads);
  deskew_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, L, N, cps, logs, t0, num_valid, ext_q, ext_t, lt_q, lt_t, dt, out);
  return (int)cudaGetLastError();
}
