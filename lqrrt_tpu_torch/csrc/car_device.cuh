// The car's callbacks as device functions for kernel D (steer_rollout.cu):
// the kinematic bicycle of lqrrt_tpu_torch/models/car.py, state (px, py,
// theta, v), control (a, delta), theta wrapped by the erf.
//
// Written in the order of the PyTorch expressions, each operation rounded
// on its own (boat_device.cuh's add/sub/mul), with the precise sincosf and
// tanf (no --use_fast_math).  `v * tan(delta) / WHEELBASE` divides a tensor
// by a Python float, which PyTorch's CUDA division takes as a multiply by
// the float reciprocal 1 / WHEELBASE (BinaryDivTrueKernel.cu), so the
// kernel multiplies by that reciprocal, rounded once in float32.
#pragma once

#include "boat_device.cuh"

namespace car {

using boat::clamp;
using boat::mul;

constexpr int kN = 4;
constexpr int kM = 2;
constexpr int kWrap = 2;          // the erf's wrapped dim (angle_dims)
// The car's numbers, in the order of car_params() in
// ops/kernels/steer_kernel.py: A_MAX, DELTA_MAX, 1 / WHEELBASE (float32),
// U_MIN (2), U_MAX (2).
enum { kAMax, kDeltaMax, kInvBase, kUMin, kUMax = kUMin + kM,
       kParams = kUMax + kM };

// car.f
__device__ __forceinline__ void f(const float* p, const float* x,
                                  const float* u, float* xd) {
  const float a = clamp(u[0], -p[kAMax], p[kAMax]);
  const float delta = clamp(u[1], -p[kDeltaMax], p[kDeltaMax]);
  float s, c;
  sincosf(x[2], &s, &c);   // the bits of sinf and cosf
  xd[0] = mul(x[3], c);
  xd[1] = mul(x[3], s);
  xd[2] = mul(mul(x[3], tanf(delta)), p[kInvBase]);
  xd[3] = a;
}

// car.saturate: u clamped to [U_MIN, U_MAX]
__device__ __forceinline__ void saturate(const float* p, float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) u[i] = clamp(u[i], p[kUMin + i], p[kUMax + i]);
}

}  // namespace car
