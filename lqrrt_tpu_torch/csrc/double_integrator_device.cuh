// The double integrator's callbacks as device functions for kernel D
// (steer_rollout.cu): lqrrt_tpu_torch/models/double_integrator.py, state
// (px, py, vx, vy), control (fx, fy), no wrapped dim (the erf is
// torch.subtract).  f has no arithmetic of its own: xdot = (vx, vy, fx,
// fy).
#pragma once

#include "boat_device.cuh"

namespace double_integrator {

constexpr int kN = 4;
constexpr int kM = 2;
constexpr int kWrap = -1;         // no wrapped dim
// double_integrator_params() in ops/kernels/steer_kernel.py: U_MAX
enum { kUMax, kParams };

// double_integrator.f
__device__ __forceinline__ void f(const float* p, const float* x,
                                  const float* u, float* xd) {
  (void)p;
  xd[0] = x[2];
  xd[1] = x[3];
  xd[2] = u[0];
  xd[3] = u[1];
}

// double_integrator.saturate: u clamped to +-U_MAX
__device__ __forceinline__ void saturate(const float* p, float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) u[i] = boat::clamp(u[i], -p[kUMax], p[kUMax]);
}

}  // namespace double_integrator
