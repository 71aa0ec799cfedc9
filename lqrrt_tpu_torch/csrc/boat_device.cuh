// The boat's callbacks as device functions, shared by kernel D
// (steer_rollout.cu) and the stage scaffold (steer_stages.cu): one form of
// each.  The arithmetic that is not the boat's own (add/sub/mul, clamp,
// wrap_angle_fast, torch_sum, div_rn, rk4, the circles test) is shared
// too, by the other models' headers (car_device.cuh, quadrotor_device.cuh,
// double_integrator_device.cuh).
//
// Each is written in the order of the PyTorch expression it stands for
// (lqrrt_tpu_torch/models/boat.py, ops/angles.py, ops/integrate.py), and
// every operation rounds on its own: add/sub/mul below are never contracted
// into FMAs, and sincosf (whose sine and cosine have the bits of sinf and
// cosf), the fmodf that wrap_angle_fast takes where |a + pi| >= 8 pi, and
// sqrtf are the precise ones (no --use_fast_math).  So on the card a kernel
// built from them reproduces the plain PyTorch version's arithmetic bit for
// bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace boat {

constexpr int kN = 6;             // boat state: px, py, psi, vx, vy, w
constexpr int kM = 3;             // boat wrench: Fx, Fy, Mz
constexpr int kPsi = 2;           // the erf's wrapped dim (angle_dims)
constexpr int kStages = 4;        // RK4
constexpr int kRegCircles = 8;    // circles a kernel keeps in registers
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

// torch.clamp(v, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

__host__ __device__ constexpr int last_pow2(int n) {
  return n < 2 ? 1 : 2 * last_pow2(n / 2);
}

// a[0] + ... + a[N - 1] in the order of PyTorch's CUDA sum over a
// contiguous last dim of N <= 32 (ATen/native/cuda/Reduce.cuh): W =
// last_pow2(N) lanes, lane l adds a[l] and a[l + W] (where l + W < N), then
// a shuffle tree by offsets W / 2, ..., 1.  N = 6: ((a0 + a4) + a2) +
// ((a1 + a5) + a3); N = 4: (a0 + a2) + (a1 + a3); N = 2: a0 + a1.
template <int N>
__device__ __forceinline__ float torch_sum(const float* a) {
  constexpr int W = last_pow2(N);
  static_assert(N >= 1 && N <= 32, "torch_sum: 1 <= N <= 32");
  float v[W];
#pragma unroll
  for (int l = 0; l < W; ++l) v[l] = l + W < N ? add(a[l], a[l + W]) : a[l];
#pragma unroll
  for (int off = W / 2; off > 0; off /= 2)
#pragma unroll
    for (int l = 0; l < off; ++l) v[l] = add(v[l], v[l + off]);
  return v[0];
}

// a / b rounded to nearest even, as IEEE division (torch's `/` of two
// tensors on the card), without the slow-path call of the compiler's
// division, which ptxas reports as spills.  For finite nonzero a and b the
// quotient is taken in fp64: a reciprocal of b (rcp.approx and three
// Newton steps, each fma), q = a y, and one correction q + (a - b q) y,
// all within ~2^-53 of a / b; a float's midpoint lies at least 2^-49 (in
// relative terms) from any a / b that is not that midpoint, so the
// rounding of q to float is a / b's (subnormal results included).  A zero,
// infinite or NaN operand takes a times a stand-in for 1 / b (inf for a
// zero b, a zero for an infinite b, b itself otherwise), which gives
// IEEE's zero, infinity or NaN with its sign.
__device__ __forceinline__ float div_rn(float a, float b) {
  const double ad = a, bd = b;
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(bd));
#pragma unroll
  for (int i = 0; i < 3; ++i) y = __fma_rn(y, __fma_rn(-bd, y, 1.0), y);
  double q = __dmul_rn(ad, y);
  q = __fma_rn(__fma_rn(-bd, q, ad), y, q);
  const bool general = isfinite(a) && isfinite(b) && a != 0.f && b != 0.f;
  const float rb = isinf(b) ? copysignf(0.f, b)
                   : b == 0.f ? copysignf(CUDART_INF_F, b) : b;
  return general ? __double2float_rn(q) : mul(a, rb);
}

// a[0] + ... + a[5] in the order of PyTorch's CUDA sum over dim 0 of a
// contiguous (6, B) tensor (Reduce.cuh, an outer reduction): one thread an
// output, four accumulators over the 6 rows (rows 0-3, then 4 and 5 onto
// the first two), combined in order
__device__ __forceinline__ float sum6_rows(const float* a) {
  return add(add(add(add(a[0], a[4]), add(a[1], a[5])), a[2]), a[3]);
}

// a - 2pi floor((a + pi) / 2pi), in [-pi, pi), as torch.remainder computes
// the floor-mod (ops/angles.py wrap_angle: fmod, then the divisor's sign;
// fmod keeps the dividend's), with fmodf only where |a + pi| >= 8 pi.
// Below that, fmodf(s, 2 pi) is s - n 2 pi with n < 4, which two selects
// reach without a branch: s -+ 4 pi where |s| >= 4 pi, then -+ 2 pi where
// what is left is >= 2 pi.  Each subtracts y (the float 2 pi times a power
// of two, exact) from an r with y <= |r| < 2 y, so each is exact
// (Sterbenz), and the result has fmodf's bits; a zero may lose fmodf's
// sign, which the sign step and the final subtraction make the same -pi.
// NaN and inf take fmodf.  (fmodf is a loop, and a branch that some lanes
// of a warp take; these are selects.)
__device__ __forceinline__ float wrap_angle_fast(float a) {
  const float two_pi = 2.0f * CUDART_PI_F, four_pi = 2.0f * two_pi;
  const float s = add(a, CUDART_PI_F);
  float r = fabsf(s) >= four_pi ? sub(s, copysignf(four_pi, s)) : s;
  r = fabsf(r) >= two_pi ? sub(r, copysignf(two_pi, r)) : r;
  if (!(fabsf(s) < 2.0f * four_pi)) r = fmodf(s, two_pi);
  if (r < 0.f) r = add(r, two_pi);
  return sub(r, CUDART_PI_F);
}

// the boat's erf: e = xgoal - x, psi wrapped
__device__ __forceinline__ void erf_fast(const float* xgoal, const float* x,
                                         float* e) {
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = sub(xgoal[i], x[i]);
  e[kPsi] = wrap_angle_fast(e[kPsi]);
}

// boat.f (3-DOF vessel, body-frame velocities) in two parts, so that a
// caller can take the trig after the velocity rows: f_vel gives rows 3-5
// (no trig) from v = (vx, vy, w), f_pos rows 0 and 1 from the cosine and
// sine of psi.  Together they are boat.f's operations in its order; row 2
// is w.
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

// circles_free's test (collision.circles_free on (px, py): outside every
// circle (cx, cy, (r + margin)^2)) over circles first, ..., ncirc - 1 in
// memory: each circle's distance is independent of the others' and the
// booleans are ANDed
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

// the first kRegCircles circles of cs (ncirc of them) into registers cr;
// a slot past ncirc is never read as a circle
__device__ __forceinline__ void load_circles(const float* cs, int ncirc,
                                             float (*cr)[3]) {
#pragma unroll
  for (int k = 0; k < kRegCircles; ++k)
#pragma unroll
    for (int j = 0; j < 3; ++j) cr[k][j] = k < ncirc ? cs[3 * k + j] : 0.f;
}

// circles_free's boolean on (px, py): the first kRegCircles circles from
// the registers of load_circles, each tested on its own and ANDed (a slot
// past ncirc passes whatever (px, py) is, NaN included, as no circle does),
// the rest from memory (circles_clear)
__device__ __forceinline__ bool circles_ok(const float (*cr)[3],
                                           const float* cs, int ncirc,
                                           float px, float py) {
  bool ok = circles_clear(cs, kRegCircles, ncirc, px, py);
#pragma unroll
  for (int k = 0; k < kRegCircles; ++k) {
    const float dx = sub(cr[k][0], px), dy = sub(cr[k][1], py);
    ok &= k >= ncirc || add(mul(dx, dx), mul(dy, dy)) > cr[k][2];
  }
  return ok;
}

// boat.saturate: u clamped to +-WRENCH_MAX
__device__ __forceinline__ void saturate(const float* p, float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) u[i] = clamp(u[i], -p[kWMax + i], p[kWMax + i]);
}

// ops/integrate.py rk4_step of any F(x, u, xdot) on N states, u held over
// the step; hh = dt / 2, h6 = dt / 6.  The sum ((k1 + 2 k2) + 2 k3) + k4 is
// folded as each k is made, in that order, so that only one k is live.
template <int N = kN, class F>
__device__ __forceinline__ void rk4(F fn, const float* x, const float* u,
                                    float hh, float h, float h6, float* xn) {
  float k[N], t[N], acc[N];
  fn(x, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = k[i];
    t[i] = add(x[i], mul(hh, k[i]));
  }
  fn(t, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = add(acc[i], mul(2.0f, k[i]));
    t[i] = add(x[i], mul(hh, k[i]));
  }
  fn(t, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    acc[i] = add(acc[i], mul(2.0f, k[i]));
    t[i] = add(x[i], mul(h, k[i]));
  }
  fn(t, u, k);
#pragma unroll
  for (int i = 0; i < N; ++i) xn[i] = add(x[i], mul(h6, add(acc[i], k[i])));
}

// boat.dynamics, the RK4 of boat.f (f_saturated's clamp of an already
// saturated u changes nothing; rk4_step(boat.f, ...) is the same RK4), as
// rk4 computes it with the rows reordered: the velocity rows and psi of the
// four stages first (each stage state x + step * k, step 0, hh, hh, h, as
// rk4's t; k[2] is the stage's w), then the four stages' sincosf, which
// depend on the velocity chain alone and not on each other, and their
// position rows, then xn as rk4's last line.  The position rows of a stage
// state are never read (f takes none).
__device__ __forceinline__ void rk4_split(const float* p, const float* x,
                                          const float* u, float hh, float h,
                                          float h6, float* xn) {
  float v[kStages][kM], kv[kStages][kM], psi[kStages], kp[kStages][2];
  const float step[kStages] = {0.f, hh, hh, h};
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    if (s == 0) {
#pragma unroll
      for (int i = 0; i < kM; ++i) v[s][i] = x[3 + i];
      psi[s] = x[2];
    } else {
#pragma unroll
      for (int i = 0; i < kM; ++i)
        v[s][i] = add(x[3 + i], mul(step[s], kv[s - 1][i]));
      psi[s] = add(x[2], mul(step[s], v[s - 1][2]));
    }
    f_vel(p, v[s], u, kv[s]);
  }
#pragma unroll
  for (int s = 0; s < kStages; ++s) {
    float c, sn;
    sincosf(psi[s], &sn, &c);   // the bits of sinf and cosf
    f_pos(c, sn, v[s][0], v[s][1], kp[s]);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    float k[kStages];
#pragma unroll
    for (int s = 0; s < kStages; ++s)
      k[s] = i < 2 ? kp[s][i] : i == 2 ? v[s][2] : kv[s][i - 3];
    xn[i] = add(x[i], mul(h6, add(add(add(k[0], mul(2.0f, k[1])),
                                      mul(2.0f, k[2])), k[3])));
  }
}

}  // namespace boat
