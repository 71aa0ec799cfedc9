// The boat's callbacks as device functions, shared by kernel D
// (steer_rollout.cu) and the stage scaffold (steer_stages.cu).
//
// Each is written in the order of the PyTorch expression it stands for
// (lqrrt_tpu_torch/models/boat.py, ops/angles.py, ops/integrate.py), and
// every operation rounds on its own: add/sub/mul below are never contracted
// into FMAs, and sinf, cosf, fmodf and sqrtf are the precise ones (no
// --use_fast_math).  So on the card a kernel built from them reproduces the
// plain PyTorch version's arithmetic bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace boat {

constexpr int kN = 6;             // boat state: px, py, psi, vx, vy, w
constexpr int kM = 3;             // boat wrench: Fx, Fy, Mz
constexpr int kPsi = 2;           // the erf's wrapped dim (angle_dims)
// The boat's numbers, in the order of boat_params() in
// ops/kernels/steer_kernel.py: M_MASS, M_SWAY, 1 / (M_MASS, M_SWAY, I_YAW),
// D_LIN, D_QUAD, WRENCH_MAX.
enum { kMass, kSway, kMinv, kDLin = kMinv + 3, kDQuad = kDLin + 3,
       kWMax = kDQuad + 3, kParams = kWMax + 3 };

// One rounding an operation, as each PyTorch op of the plain version
// rounds: these intrinsics are never contracted into FMAs.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.clamp(v, lo, hi): NaN stays NaN.  fminf/fmaxf return the operand
// that is not NaN, so alone they would turn a NaN into a bound.
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}

// a[0] + ... + a[5] in the order of PyTorch's CUDA sum over a contiguous
// last dim of 6 (ATen/native/cuda/Reduce.cuh): 4 lanes, lane l adds a[l] and
// a[l + 4], then a shuffle tree by offsets 2 and 1
__device__ __forceinline__ float sum6(const float* a) {
  return add(add(add(a[0], a[4]), a[2]), add(add(a[1], a[5]), a[3]));
}

// a[0] + ... + a[5] in the order of PyTorch's CUDA sum over dim 0 of a
// contiguous (6, B) tensor (Reduce.cuh, an outer reduction): one thread an
// output, four accumulators over the 6 rows (rows 0-3, then 4 and 5 onto
// the first two), combined in order
__device__ __forceinline__ float sum6_rows(const float* a) {
  return add(add(add(add(a[0], a[4]), add(a[1], a[5])), a[2]), a[3]);
}

// a - 2pi floor((a + pi) / 2pi), in [-pi, pi), as torch.remainder computes
// the floor-mod: fmodf, then the divisor's sign (fmodf alone keeps the
// dividend's sign and is wrong here)
__device__ __forceinline__ float wrap_angle(float a) {
  const float two_pi = 2.0f * CUDART_PI_F;
  float r = fmodf(add(a, CUDART_PI_F), two_pi);
  if (r < 0.f) r = add(r, two_pi);
  return sub(r, CUDART_PI_F);
}

// wrap_angle's value with fmodf only where |a + pi| >= 4 pi: below that,
// fmodf(a + pi, 2 pi) is a + pi itself or a + pi -+ 2 pi, and that
// subtraction is exact (Sterbenz), so the result has wrap_angle's bits.
// NaN and inf take fmodf.  (fmodf is a loop; this is a compare.)
__device__ __forceinline__ float wrap_angle_fast(float a) {
  const float two_pi = 2.0f * CUDART_PI_F;
  const float s = add(a, CUDART_PI_F), m = fabsf(s);
  float r = m < two_pi                ? s
            : m < 2.0f * two_pi       ? sub(s, copysignf(two_pi, s))
                                      : fmodf(s, two_pi);
  if (r < 0.f) r = add(r, two_pi);
  return sub(r, CUDART_PI_F);
}

// erf with wrap_angle_fast: the same values
__device__ __forceinline__ void erf_fast(const float* xgoal, const float* x,
                                         float* e) {
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = sub(xgoal[i], x[i]);
  e[kPsi] = wrap_angle_fast(e[kPsi]);
}

// the boat's erf: e = xgoal - x, psi wrapped
__device__ __forceinline__ void erf(const float* xgoal, const float* x,
                                    float* e) {
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = sub(xgoal[i], x[i]);
  e[kPsi] = wrap_angle(e[kPsi]);
}

// boat.f: 3-DOF vessel, body-frame velocities
__device__ __forceinline__ void f(const float* p, const float* x,
                                  const float* u, float* xd) {
  const float c = cosf(x[2]), s = sinf(x[2]);
  const float vx = x[3], vy = x[4], w = x[5];
  xd[0] = sub(mul(c, vx), mul(s, vy));
  xd[1] = add(mul(s, vx), mul(c, vy));
  xd[2] = w;
  const float cor[kM] = {mul(mul(p[kSway], vy), w),
                         mul(mul(-p[kMass], vx), w),
                         mul(mul(sub(p[kMass], p[kSway]), vx), vy)};
#pragma unroll
  for (int k = 0; k < kM; ++k) {
    const float nu = x[3 + k];
    const float drag = add(mul(p[kDLin + k], nu),
                           mul(mul(p[kDQuad + k], nu), fabsf(nu)));
    xd[3 + k] = mul(p[kMinv + k], sub(add(u[k], cor[k]), drag));
  }
}

// boat.f split in two for the rollout (steer_rollout.cu), which takes the
// four RK4 stages' trig after their velocity rows: f_vel gives rows 3-5 (no
// trig), f_pos rows 0 and 1 from the cosine and sine of psi.  Together they
// are f's operations in f's order; row 2 is w.
__device__ __forceinline__ void f_vel(const float* p, const float* v,
                                      const float* u, float* vd) {
  const float vx = v[0], vy = v[1], w = v[2];
  const float cor[kM] = {mul(mul(p[kSway], vy), w),
                         mul(mul(-p[kMass], vx), w),
                         mul(mul(sub(p[kMass], p[kSway]), vx), vy)};
#pragma unroll
  for (int k = 0; k < kM; ++k) {
    const float nu = v[k];
    const float drag = add(mul(p[kDLin + k], nu),
                           mul(mul(p[kDQuad + k], nu), fabsf(nu)));
    vd[k] = mul(p[kMinv + k], sub(add(u[k], cor[k]), drag));
  }
}

__device__ __forceinline__ void f_pos(float c, float s, float vx, float vy,
                                      float* pd) {
  pd[0] = sub(mul(c, vx), mul(s, vy));
  pd[1] = add(mul(s, vx), mul(c, vy));
}

// circles_free's test over circles first, ..., ncirc - 1: each circle's
// distance is independent of the others' and the booleans are ANDed (the
// same result as circles_free's chain)
__device__ __forceinline__ bool circles_clear(const float* cs, int first,
                                              int ncirc, float px, float py) {
  bool ok = true;
#pragma unroll 4
  for (int k = first; k < ncirc; ++k) {
    const float dx = sub(cs[3 * k], px), dy = sub(cs[3 * k + 1], py);
    ok &= add(mul(dx, dx), mul(dy, dy)) > cs[3 * k + 2];
  }
  return ok;
}

// boat.saturate: u clamped to +-WRENCH_MAX
__device__ __forceinline__ void saturate(const float* p, float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) u[i] = clamp(u[i], -p[kWMax + i], p[kWMax + i]);
}

// ops/integrate.py rk4_step of any F(x, u, xdot), u held over the step;
// hh = dt / 2, h6 = dt / 6
template <class F>
__device__ __forceinline__ void rk4(F fn, const float* x, const float* u,
                                    float hh, float h, float h6, float* xn) {
  float k1[kN], k2[kN], k3[kN], k4[kN], t[kN];
  fn(x, u, k1);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(hh, k1[i]));
  fn(t, u, k2);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(hh, k2[i]));
  fn(t, u, k3);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(h, k3[i]));
  fn(t, u, k4);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    xn[i] = add(x[i], mul(h6, add(add(add(k1[i], mul(2.0f, k2[i])),
                                      mul(2.0f, k3[i])), k4[i])));
}

// boat.dynamics: the RK4 of boat.f (f_saturated's clamp of an already
// saturated u changes nothing)
__device__ __forceinline__ void rk4_f(const float* p, const float* x,
                                      const float* u, float hh, float h,
                                      float h6, float* xn) {
  rk4([p](const float* a, const float* v, float* d) { f(p, a, v, d); },
      x, u, hh, h, h6, xn);
}

// collision.circles_free on (px, py): outside every circle, each circle
// (cx, cy, (r + margin)^2)
__device__ __forceinline__ bool circles_free(const float* cs, int ncirc,
                                             const float* x) {
  bool feas = true;
  for (int k = 0; k < ncirc; ++k) {
    const float dx = sub(cs[3 * k], x[0]), dy = sub(cs[3 * k + 1], x[1]);
    feas = feas && add(mul(dx, dx), mul(dy, dy)) > cs[3 * k + 2];
  }
  return feas;
}

}  // namespace boat
