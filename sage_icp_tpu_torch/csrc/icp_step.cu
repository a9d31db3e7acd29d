// The body of the ICP loop after the Gauss-Newton sums, on the device:
// normal equations from the 18 sums, the damped 6x6 Cholesky solve, the
// SE(3) exponential of the increment, the pose update, the convergence
// and drift tests, and the loop's status word. One thread of one block;
// the ICP loop launches it after every fused GN iteration
// (csrc/gn_iteration.cu), so the loop's state and its control stay on the
// card and the host reads the status once per block of iterations
// (ops/registration.py). Its reference mode (icp_ref_step_kernel) is the
// body of the reference-shaped loop after the search and the normal
// equations: the same solve, pose update and exit test, without the drift
// (registration.RefLoop).
//
// It has no TPU kernel to replace: in the JAX package this is plain jnp
// inside the lax.while_loops of sage_icp_tpu/ops/registration.py
// (register_frame's body_f, :270-289, and the reference body, :315-333):
// assemble_normal_equations (ops/pallas_nn.py:369), solve_increment,
// se3_exp, the compose, the norm and anchor_drift.
//
// What bounds it: neither bytes (72 B of sums or 168 B of normal
// equations, ~230 B of state) nor operations (~700 scalar flops): it is a
// serial chain of dependent float32 operations on one thread, a few
// microseconds, and the launch latency is the floor. That is why it is
// one launch of one thread, with no reduction and nothing to share.
//
// Its arithmetic is written out once, in the order of its plain version
// (ops/icp_kernel.py::icp_step_plain, icp_ref_step_plain): every sum left
// to right from 0, products and compositions expanded, sin, cos and acos
// taken in double and rounded to float (ops/geometry.py), the maximum and
// clamp passing NaN through as numpy and torch do. With --fmad=false
// (ops/cuda_lib.py) each operation rounds once, as it does in PyTorch, so
// the kernel equals its plain version bit for bit.
//
// State (ops/icp_kernel.py holds the same layout):
//   f[0:16]  anchor pose, row-major 4x4     f[32] max_corr   f[35] drift
//   f[16:32] T_icp, increment since anchor  f[33] kernel     f[36] r_scan
//                                           f[34] |x| of the last step
//   f[40:56] est, the reference mode's last increment exp(x)
//   s[0] iterations  s[1] correspondences of the last step  s[2] status
//   s[3] live rows of the current rows (counted at each row build)
//   s[4] live rows summed over the running steps (the GN rows the loop ran)
// Status: 0 running, 1 done (converged or at max_iterations), 2 re-anchor
// needed before the next iteration. A launch with a status other than 0
// changes nothing (the reference mode sets est to the identity).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "launch_count.cuh"

namespace {

constexpr int kRunning = 0;
constexpr int kDone = 1;
constexpr int kReanchor = 2;
constexpr float kThreshold = 1e-4f;  // icp_kernel.ESTIMATION_THRESHOLD

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }
// float32 of the double-precision function, as ops/geometry.py takes it
__device__ __forceinline__ float sin64(float x) { return (float)sin((double)x); }
__device__ __forceinline__ float cos64(float x) { return (float)cos((double)x); }
__device__ __forceinline__ float acos64(float x) { return (float)acos((double)x); }

// (A) x = b by Cholesky and the two triangular solves, every sum from 0
// in order; a non-finite x becomes 0 and |x| is clamped to 10. Returns
// |x| after both.
__device__ __forceinline__ float solve6(const float (&A)[6][6], const float (&b)[6], float (&x)[6]) {
  float L[6][6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j <= i; ++j) {
      float acc = 0.f;
      for (int k = 0; k < j; ++k) acc = add(acc, mul(L[i][k], L[j][k]));
      const float v = sub(A[i][j], acc);
      if (i == j) {
        L[i][i] = __fsqrt_rn(1e-30f > v ? 1e-30f : v);  // NaN stays NaN
      } else {
        L[i][j] = dvd(v, L[j][j]);
      }
    }
  }
  float y[6];
  for (int i = 0; i < 6; ++i) {
    float acc = 0.f;
    for (int k = 0; k < i; ++k) acc = add(acc, mul(L[i][k], y[k]));
    y[i] = dvd(sub(b[i], acc), L[i][i]);
  }
  for (int i = 5; i >= 0; --i) {
    float acc = 0.f;
    for (int k = i + 1; k < 6; ++k) acc = add(acc, mul(L[k][i], x[k]));
    x[i] = dvd(sub(y[i], acc), L[i][i]);
  }
  bool finite = true;
  for (int i = 0; i < 6; ++i) finite = finite && isfinite(x[i]);
  float n2 = 0.f;
  for (int i = 0; i < 6; ++i) {
    if (!finite) x[i] = 0.f;
    n2 = add(n2, mul(x[i], x[i]));
  }
  const float n = __fsqrt_rn(n2);
  if (n > 10.f) {
    const float c = dvd(10.f, n > 1e-30f ? n : 1e-30f);
    for (int i = 0; i < 6; ++i) x[i] = mul(x[i], c);
  }
  float norm2 = 0.f;
  for (int i = 0; i < 6; ++i) norm2 = add(norm2, mul(x[i], x[i]));
  return __fsqrt_rn(norm2);
}

// E = se3_exp(x), x = [rho, phi]
__device__ __forceinline__ void se3_exp(const float (&x)[6], float (&E)[4][4]) {
  const float p0 = x[3], p1 = x[4], p2 = x[5];
  const float theta2 = add(add(mul(p0, p0), mul(p1, p1)), mul(p2, p2));
  const float theta = __fsqrt_rn(add(theta2, (float)(1e-8 * 1e-8)));
  const bool small = theta < 1e-4f;
  const float sin_t = sin64(theta), cos_t = cos64(theta);
  const float ca = small ? sub(1.f, dvd(theta2, 6.f)) : dvd(sin_t, theta);
  const float cb = small ? sub(0.5f, dvd(theta2, 24.f)) : dvd(sub(1.f, cos_t), theta2);
  const float cc = small ? sub((float)(1.0 / 6.0), dvd(theta2, 120.f))
                         : dvd(sub(theta, sin_t), mul(theta2, theta));
  const float K[3][3] = {{0.f, -p2, p1}, {p2, 0.f, -p0}, {-p1, p0, 0.f}};
  float V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      const float kk = add(add(mul(K[i][0], K[0][j]), mul(K[i][1], K[1][j])), mul(K[i][2], K[2][j]));
      const float eye = i == j ? 1.f : 0.f;
      E[i][j] = add(add(eye, mul(ca, K[i][j])), mul(cb, kk));
      V[i][j] = add(add(eye, mul(cb, K[i][j])), mul(cc, kk));
    }
  }
  for (int i = 0; i < 3; ++i) {
    E[i][3] = add(add(mul(V[i][0], x[0]), mul(V[i][1], x[1])), mul(V[i][2], x[2]));
  }
  E[3][0] = E[3][1] = E[3][2] = 0.f;
  E[3][3] = 1.f;
}

// Tn = E T (T row-major at t), the 4x4 product written out
__device__ __forceinline__ void compose(const float (&E)[4][4], const float* t, float (&Tn)[4][4]) {
  float T[4][4];
  for (int k = 0; k < 16; ++k) T[k / 4][k % 4] = t[k];
  for (int i = 0; i < 4; ++i) {
    for (int j = 0; j < 4; ++j) {
      Tn[i][j] = add(add(add(mul(E[i][0], T[0][j]), mul(E[i][1], T[1][j])), mul(E[i][2], T[2][j])),
                     mul(E[i][3], T[3][j]));
    }
  }
}

__global__ void icp_step_kernel(const float* __restrict__ sums, float* __restrict__ f,
                                int32_t* __restrict__ st, int max_iterations, float drift_lim,
                                unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  if (st[2] != kRunning) return;
  float s[18];
  for (int k = 0; k < 18; ++k) s[k] = sums[k];

  // normal equations (assemble_normal_equations), damped by 1e-8 I
  const float w = s[0], wsx = s[1], wsy = s[2], wsz = s[3];
  const float sxx = s[4], syy = s[5], szz = s[6], sxy = s[7], sxz = s[8], syz = s[9];
  const float tr = add(add(sxx, syy), szz);
  const float J[6][6] = {
      {mul(w, 1.f), mul(w, 0.f), mul(w, 0.f), 0.f, wsz, -wsy},
      {mul(w, 0.f), mul(w, 1.f), mul(w, 0.f), -wsz, 0.f, wsx},
      {mul(w, 0.f), mul(w, 0.f), mul(w, 1.f), wsy, -wsx, 0.f},
      {0.f, -wsz, wsy, sub(tr, sxx), -sxy, -sxz},
      {wsz, 0.f, -wsx, -sxy, sub(tr, syy), -syz},
      {-wsy, wsx, 0.f, -sxz, -syz, sub(tr, szz)},
  };
  float A[6][6], b[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] = add(J[i][j], i == j ? 1e-8f : 0.f);
    b[i] = -s[10 + i];
  }
  const int ncorr = (int)s[16];

  float x[6], E[4][4], Tn[4][4];
  const float norm = solve6(A, b, x);
  se3_exp(x, E);
  compose(E, f + 16, Tn);  // T_icp <- exp(x) T_icp

  // anchor_drift: the anchor position's displacement plus the rotation
  // arc at the scan radius
  const float a[3] = {f[3], f[7], f[11]};
  float m2 = 0.f;
  for (int i = 0; i < 3; ++i) {
    const float mv = sub(add(add(add(mul(Tn[i][0], a[0]), mul(Tn[i][1], a[1])), mul(Tn[i][2], a[2])),
                             Tn[i][3]),
                         a[i]);
    m2 = add(m2, mul(mv, mv));
  }
  float ct = mul(sub(add(add(Tn[0][0], Tn[1][1]), Tn[2][2]), 1.f), 0.5f);
  ct = ct < -1.f ? -1.f : ct > 1.f ? 1.f : ct;  // NaN stays NaN
  const float drift = add(__fsqrt_rn(m2), mul(acos64(ct), f[36]));

  const int it = st[0] + 1;
  const bool more = it < max_iterations && norm >= kThreshold;
  for (int k = 0; k < 16; ++k) f[16 + k] = Tn[k / 4][k % 4];
  f[34] = norm;
  f[35] = drift;
  st[0] = it;
  st[1] = ncorr;
  st[2] = !more ? kDone : drift >= drift_lim ? kReanchor : kRunning;
  st[4] += st[3];
}

// The reference-shaped loop's step (registration.RefLoop), after the
// search and build_normal_equations: the same damped solve from JTJ and
// JTr, T_icp <- exp(x) T_icp, the count and the exit test; no drift and
// no re-anchor. It writes exp(x) to f[40:56] for the source update
// (source <- est . source) and, on a stopped loop, the identity there,
// so a stopped loop's source stays as it is.
__global__ void icp_ref_step_kernel(const float* __restrict__ jtj, const float* __restrict__ jtr,
                                    const int32_t* __restrict__ ncorr, float* __restrict__ f,
                                    int32_t* __restrict__ st, int max_iterations,
                                    unsigned long long* __restrict__ launches) {
  sage::count_launch(launches);
  float* est = f + 40;
  if (st[2] != kRunning) {
    for (int k = 0; k < 16; ++k) est[k] = k % 5 == 0 ? 1.f : 0.f;
    return;
  }
  float A[6][6], b[6];
  for (int i = 0; i < 6; ++i) {
    for (int j = 0; j < 6; ++j) A[i][j] = add(jtj[6 * i + j], i == j ? 1e-8f : 0.f);
    b[i] = -jtr[i];
  }
  float x[6], E[4][4], Tn[4][4];
  const float norm = solve6(A, b, x);
  se3_exp(x, E);
  compose(E, f + 16, Tn);

  const int it = st[0] + 1;
  const bool more = it < max_iterations && norm >= kThreshold;
  for (int k = 0; k < 16; ++k) {
    f[16 + k] = Tn[k / 4][k % 4];
    est[k] = E[k / 4][k % 4];
  }
  f[34] = norm;
  st[0] = it;
  st[1] = *ncorr;
  st[2] = more ? kRunning : kDone;
}

}  // namespace

// sums: the 18 GN sums; f: 56 floats, s: 5 int32 of loop state (above),
// all device pointers; updated in place; launches: the kernel's launch
// counter (launch_count.cuh). One launch of one thread.
extern "C" int sage_icp_step(const void* sums, void* f, void* s, int max_iterations,
                             float drift_lim, void* launches, void* stream) {
  icp_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)sums, (float*)f, (int32_t*)s, max_iterations, drift_lim,
      (unsigned long long*)launches);
  return (int)cudaGetLastError();
}

// jtj (36 floats, row-major), jtr (6), ncorr (one int32): the reference
// loop's normal equations and correspondence count; f: 56 floats, s: 5
// int32 of loop state (above), updated in place. One launch of one
// thread.
extern "C" int sage_icp_ref_step(const void* jtj, const void* jtr, const void* ncorr, void* f, void* s,
                                 int max_iterations, void* launches, void* stream) {
  icp_ref_step_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const float*)jtj, (const float*)jtr, (const int32_t*)ncorr, (float*)f, (int32_t*)s, max_iterations,
      (unsigned long long*)launches);
  return (int)cudaGetLastError();
}
