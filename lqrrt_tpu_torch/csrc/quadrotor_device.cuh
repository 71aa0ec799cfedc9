// The quadrotor's callbacks as device functions for kernel D
// (steer_rollout.cu): lqrrt_tpu_torch/models/quadrotor.py, state (p (3),
// roll/pitch/yaw, v (3), body rates w (3)), control (thrust deviation from
// hover, three torques), yaw wrapped by the erf.
//
// Written in the order of the PyTorch expressions (_rpy_to_R, _cross, f),
// each operation rounded on its own (boat_device.cuh's add/sub/mul), with
// the precise sincosf (no --use_fast_math).  Only the third column of R
// is read (R[..., 2]).  `T / MASS` divides by a Python float, which
// PyTorch's CUDA division takes as a multiply by the float reciprocal: 1
// for MASS = 1, so T itself.  The tensor divisions, sin(p) / cp, sr / cp,
// cr / cp and (tau - cross) / inertia, are IEEE divisions in PyTorch and
// div_rn here.
#pragma once

#include "boat_device.cuh"

namespace quadrotor {

using boat::add;
using boat::clamp;
using boat::div_rn;
using boat::mul;
using boat::sub;

constexpr int kN = 12;
constexpr int kM = 4;
constexpr int kWrap = 5;          // yaw (angle_dims)
// The quadrotor's numbers, in the order of quadrotor_params() in
// ops/kernels/steer_kernel.py: HOVER_T, T_MAX, TAU_MAX, G, the pitch
// cosine's floor (0.2), INERTIA (3), U_MIN (4), U_MAX (4), all float32.
enum { kHover, kTMax, kTauMax, kG, kCosMin, kInertia, kUMin = kInertia + 3,
       kUMax = kUMin + kM, kParams = kUMax + kM };

// quadrotor.f
__device__ __forceinline__ void f(const float* p, const float* x,
                                  const float* u, float* xd) {
  const float T = clamp(add(u[0], p[kHover]), 0.f, p[kTMax]);
  float tau[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) tau[i] = clamp(u[1 + i], -p[kTauMax], p[kTauMax]);
  float sr, cr, sp, cp, sy, cy;
  sincosf(x[3], &sr, &cr);   // the bits of sinf and cosf
  sincosf(x[4], &sp, &cp);
  sincosf(x[5], &sy, &cy);
  // R[..., 2]: (cy sp cr + sy sr, sy sp cr - cy sr, cp cr)
  const float r02 = add(mul(mul(cy, sp), cr), mul(sy, sr));
  const float r12 = sub(mul(mul(sy, sp), cr), mul(cy, sr));
  const float r22 = mul(cp, cr);
  // Euler-angle rates from body rates
  const float cpc = boat::clamp_min(cp, p[kCosMin]);
  const float tp = div_rn(sp, cpc);
  const float w0 = x[9], w1 = x[10], w2 = x[11];
#pragma unroll
  for (int i = 0; i < 3; ++i) xd[i] = x[6 + i];
  xd[3] = add(add(w0, mul(mul(sr, tp), w1)), mul(mul(cr, tp), w2));
  xd[4] = sub(mul(cr, w1), mul(sr, w2));
  xd[5] = add(mul(div_rn(sr, cpc), w1), mul(div_rn(cr, cpc), w2));
  // R @ (0, 0, T) / MASS - (0, 0, G)
  xd[6] = mul(r02, T);
  xd[7] = mul(r12, T);
  xd[8] = sub(mul(r22, T), p[kG]);
  // (tau - w x (inertia w)) / inertia
  const float* in = p + kInertia;
  const float iw[3] = {mul(in[0], w0), mul(in[1], w1), mul(in[2], w2)};
  const float cross[3] = {sub(mul(w1, iw[2]), mul(w2, iw[1])),
                          sub(mul(w2, iw[0]), mul(w0, iw[2])),
                          sub(mul(w0, iw[1]), mul(w1, iw[0]))};
#pragma unroll
  for (int i = 0; i < 3; ++i) xd[9 + i] = div_rn(sub(tau[i], cross[i]), in[i]);
}

// quadrotor.saturate: u clamped to [U_MIN, U_MAX]
__device__ __forceinline__ void saturate(const float* p, float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) u[i] = clamp(u[i], p[kUMin + i], p[kUMax + i]);
}

}  // namespace quadrotor
