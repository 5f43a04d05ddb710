// The IMU mean propagation chain for Hopper (sm_90a).
//
// Replaces no TPU kernel: it stands for the mean half of the JAX package's
// propagation lax.scan (malio_tpu/propagate.py:136-142), which XLA compiles
// into one loop and the port ran as a Python loop of K small steps
// (propagate._mean_chain_plain: ~104 graph nodes a step, 206 steps a City
// round in three passes, 398 in UrbanNav). One launch runs a whole pass of
// K Euler steps of B sequences, as dynamics.step_mean:
//   omega = gyro - bg, acc_b = acc - ba, a_world = R(rot) acc_b + grav,
//   pos += vel dt, rot = normalize(rot (x) exp_so3(omega dt)), vel += a_world dt
// and a step whose valid flag is 0 leaves the state as it is. Only pos, rot
// and vel change (bg, ba and grav are constant through the chain), so a
// sequence carries 10 floats; the launch writes the K + 1 states s_0 .. s_K
// as one (B, K + 1, 10) tensor [pos 3, rot 4, vel 3].
//
// What bounds it. A step reads 8 numbers, writes 10 and does ~125 f32
// operations a sequence: at K = 255, B = 16 that is 0.2 MB and 0.5 MFLOP,
// well under a microsecond of the card's bandwidth or rate. The steps of a
// sequence depend on each other, so the time is K times the latency of one
// step's dependent chain, plus the launch.
//
// Design, against that (chip_smoke.py's imu_propagate rows time it):
// - One thread runs one sequence's whole chain in registers, K dependent
//   steps, reading its step's inputs and writing its state row as it goes;
//   up to SEQ = 16 sequences share a block (ceil(B / 16) blocks for more).
//   The chain is serial, so there is nothing to tile. On an H100 a loop
//   step takes ~0.3 us at B = 1, 0.04 ms a City pass: about a tenth of a
//   percent of the round. Staging each step's input-only half (the exp and
//   acc_b) in shared memory cuts a step to ~0.24 us, which the round
//   cannot feel, for twice the code.
// - The arithmetic is the plain version's, in its order, with each product
//   and sum rounded on its own (__fmul_rn / __fadd_rn: nvcc contracts
//   nothing into an FMA where PyTorch's element-wise kernels round twice),
//   the precise sqrt, division and sincosf (no fast-math intrinsics), and
//   so3.exp_so3's small-angle branch at the same threshold. The rotation
//   times acc_b is a chain of FMAs, as a matrix product computes it. Only
//   rounding separates the kernel from the plain chain.
#include <cuda_runtime.h>

constexpr int SEQ = 16;    // sequences a block
constexpr int WIDTH = 10;  // floats of a state row: pos 3, rot 4, vel 3

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// so3.exp_so3(omega dt) into e[4]
__device__ __forceinline__ void exp_step(const float* om, float dt, float* e) {
  const float d[3] = {mul(om[0], dt), mul(om[1], dt), mul(om[2], dt)};
  const float n2 = add(add(mul(d[0], d[0]), mul(d[1], d[1])), mul(d[2], d[2]));
  const bool small = n2 < 1e-12f;  // so3._SMALL2
  const float n = __fsqrt_rn(small ? 1.0f : n2);
  float sn, cn;
  sincosf(mul(0.5f, n), &sn, &cn);
  const float k = small ? sub(0.5f, dv(n2, 48.0f)) : dv(sn, n);
  e[0] = small ? add(sub(1.0f, dv(n2, 8.0f)), dv(mul(n2, n2), 384.0f)) : cn;
  e[1] = mul(k, d[0]);
  e[2] = mul(k, d[1]);
  e[3] = mul(k, d[2]);
}

// The state's part of a step of (p, q, v), given e = exp(omega dt),
// acc_b and dt
__device__ __forceinline__ void step(float* p, float* q, float* v, const float* e,
                                     const float* ab, const float* gr, float dt) {
  // so3.quat_to_mat(q)
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float R[9] = {
      sub(1.0f, mul(2.0f, add(yy, zz))), mul(2.0f, sub(xy, wz)), mul(2.0f, add(xz, wy)),
      mul(2.0f, add(xy, wz)), sub(1.0f, mul(2.0f, add(xx, zz))), mul(2.0f, sub(yz, wx)),
      mul(2.0f, sub(xz, wy)), mul(2.0f, add(yz, wx)), sub(1.0f, mul(2.0f, add(xx, yy)))};
  // so3.quat_mul(q, e), then so3.quat_normalize
  const float r0 = sub(sub(sub(mul(w, e[0]), mul(x, e[1])), mul(y, e[2])), mul(z, e[3]));
  const float r1 = sub(add(add(mul(w, e[1]), mul(x, e[0])), mul(y, e[3])), mul(z, e[2]));
  const float r2 = add(add(sub(mul(w, e[2]), mul(x, e[3])), mul(y, e[0])), mul(z, e[1]));
  const float r3 = add(sub(add(mul(w, e[3]), mul(x, e[2])), mul(y, e[1])), mul(z, e[0]));
  const float nq = __fsqrt_rn(
      add(add(add(mul(r0, r0), mul(r1, r1)), mul(r2, r2)), mul(r3, r3)));
  // pos += vel dt and vel += (R acc_b + grav) dt, both from the old state
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float aw = add(__fmaf_rn(R[3 * i + 2], ab[2], __fmaf_rn(R[3 * i + 1], ab[1],
                                                                  mul(R[3 * i], ab[0]))),
                         gr[i]);
    p[i] = add(p[i], mul(v[i], dt));
    v[i] = add(v[i], mul(aw, dt));
  }
  q[0] = dv(r0, nq);
  q[1] = dv(r1, nq);
  q[2] = dv(r2, nq);
  q[3] = dv(r3, nq);
}

__global__ void __launch_bounds__(SEQ) imu_mean_chain_kernel(
    const float* __restrict__ pos, const float* __restrict__ rot,
    const float* __restrict__ vel, const float* __restrict__ bg,
    const float* __restrict__ ba, const float* __restrict__ grav,
    const float* __restrict__ gyro, const float* __restrict__ acc,
    const float* __restrict__ dts, const unsigned char* __restrict__ valid, int B,
    int K, float* __restrict__ out) {
  const long b = (long)blockIdx.x * SEQ + threadIdx.x;
  if (b >= B) return;
  float p[3], q[4], v[3], bgb[3], bab[3], gr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p[i] = pos[3 * b + i];
    v[i] = vel[3 * b + i];
    bgb[i] = bg[3 * b + i];
    bab[i] = ba[3 * b + i];
    gr[i] = grav[3 * b + i];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = rot[4 * b + i];
  float* o = out + b * (K + 1) * WIDTH;
  for (int k = 0;; ++k) {  // s_k, then step k
    o[0] = p[0], o[1] = p[1], o[2] = p[2];
    o[3] = q[0], o[4] = q[1], o[5] = q[2], o[6] = q[3];
    o[7] = v[0], o[8] = v[1], o[9] = v[2];
    if (k == K) break;
    o += WIDTH;
    const long g = b * K + k;
    if (!valid[g]) continue;
    const float dt = dts[g];
    const float om[3] = {sub(gyro[3 * g], bgb[0]), sub(gyro[3 * g + 1], bgb[1]),
                         sub(gyro[3 * g + 2], bgb[2])};
    const float ab[3] = {sub(acc[3 * g], bab[0]), sub(acc[3 * g + 1], bab[1]),
                         sub(acc[3 * g + 2], bab[2])};
    float e[4];
    exp_step(om, dt, e);
    step(p, q, v, e, ab, gr, dt);
  }
}

// B sequences of K steps: x0's pos, rot, vel, bg, ba, grav (B, 3 / 4),
// gyro and acc (B, K, 3), dt (B, K), valid (B, K) bytes, out (B, K + 1, 10),
// all contiguous f32 but valid (the wrapper checks them). Returns the CUDA
// error of the launch.
extern "C" int imu_propagate_launch(const float* pos, const float* rot, const float* vel,
                                    const float* bg, const float* ba, const float* grav,
                                    const float* gyro, const float* acc, const float* dt,
                                    const unsigned char* valid, int B, int K, float* out,
                                    void* stream) {
  if (B == 0) return 0;
  const unsigned blocks = (unsigned)((B + SEQ - 1) / SEQ);
  imu_mean_chain_kernel<<<blocks, SEQ, 0, (cudaStream_t)stream>>>(
      pos, rot, vel, bg, ba, grav, gyro, acc, dt, valid, B, K, out);
  return (int)cudaGetLastError();
}
