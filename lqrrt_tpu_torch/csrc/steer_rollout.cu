// Kernel D: the fused closed-loop LQR steer rollout of the boat, with an
// optional parent gather.
//
// Replaces: tools/steer_kernel_experimental.py, make_steer_pallas (:72) and
// make_steer_pallas_tree (:340).  The Pallas kernels traced the user's
// callbacks (dynamics, erf, is_feasible, saturate) into the kernel through
// jax.vmap.  A CUDA kernel cannot, so the boat's callbacks
// (lqrrt_tpu_torch/models/boat.py) are written out below as device
// functions, its numbers arrive as a kernel argument, and the wrapper
// (ops/kernels/steer_kernel.py) refuses a model that has none.
//
// For each candidate b, H steps of exactly core/steer.py's step, in its
// order: e = erf(xtar, x) with psi wrapped; the converged test (scalar
// 2-norm or per-dim tol); u = K e clamped to +-WRENCH_MAX; RK4 of the boat
// on u; the circles test on xn; commit (x = xn, length += 1) unless done,
// arrived or infeasible; with a goal box, stop after the first committed
// in-goal step.  x and u are stored at every step, done or not: a finished
// rollout holds its state, and its u is that of the held state, as in the
// scan.  Once done, a thread skips only what cannot change the outputs (the
// RK4, the circles, the goal test).  After the loop: length, xnew, reached
// (the converged test on the final x) and in_goal.  Commits are a prefix, so
// the wrapper derives the mask from length.
//
// Tree variant: with pids non-null, thread b reads its start state and gain
// from rows pids[b] of the tree buffers directly.  (The Pallas kernel
// gathered them with a one-hot matmul over node blocks, since Mosaic has no
// dynamic lane index.)
//
// Bound on the H100: bytes.  At B = 8192, H = 100 the outputs, (H, 6 + 3, B)
// f32, are 29.5 MB and the inputs ~1 MB: ~9 us at 3.35 TB/s, against ~350
// fp32 flops a candidate step, ~2.9e8 in all, ~4 us at 67 TFLOP/s.  Design:
// one thread per candidate; the state, gain (3 x 6), target, goal, goal box
// and tolerance in registers; the model's numbers and the circles (<= 64)
// in shared memory, loaded once a block; xs[h, i, b] with b the fastest
// index, so each store is coalesced across a warp.  What the simple design
// leaves on the table is occupancy: 8192 threads are 256 warps, about two an
// SM, each a serial chain of 100 RK4 steps with nothing to hide its
// latency, so the kernel is latency-bound far above its byte bound.
// Splitting a candidate's work across threads, or running more candidates a
// launch, is later work; wgmma, TMA and CUDA-graph capture do not apply to
// one launch of scalar chains.
//
// Rounding: every operation rounds on its own, in the plain version's order
// (add/sub/mul below are never contracted into FMAs; sums of 6 follow
// PyTorch's CUDA reduction), with precise sinf, cosf, fmodf and sqrtf (no
// --use_fast_math), so that on the card the kernel reproduces the plain
// steer's arithmetic: a rollout amplifies one ulp of x into ~1e-3 of u
// through the gain K.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kN = 6;             // boat state: px, py, psi, vx, vy, w
constexpr int kM = 3;             // boat wrench: Fx, Fy, Mz
constexpr int kPsi = 2;           // the erf's wrapped dim (angle_dims)
constexpr int kMaxCircles = 64;   // MAX_CIRCLES in ops/kernels/steer_kernel.py
// The boat's numbers, in the order of boat_params() in steer_kernel.py:
// M_MASS, M_SWAY, 1 / (M_MASS, M_SWAY, I_YAW), D_LIN, D_QUAD, WRENCH_MAX.
enum { kMass, kSway, kMinv, kDLin = kMinv + 3, kDQuad = kDLin + 3,
       kWMax = kDQuad + 3, kParams = kWMax + 3 };

// One rounding an operation, as each PyTorch op of the plain version
// (core/steer.py) rounds: these intrinsics are never contracted into FMAs.
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// a[0] + ... + a[5] in the order of PyTorch's CUDA sum over a contiguous
// last dim of 6 (ATen/native/cuda/Reduce.cuh): 4 lanes, lane l adds a[l] and
// a[l + 4], then a shuffle tree by offsets 2 and 1
__device__ __forceinline__ float sum6(const float* a) {
  return add(add(add(a[0], a[4]), a[2]), add(add(a[1], a[5]), a[3]));
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

// the boat's erf: e = xgoal - x, psi wrapped
__device__ __forceinline__ void boat_erf(const float* xgoal, const float* x,
                                         float* e) {
#pragma unroll
  for (int i = 0; i < kN; ++i) e[i] = sub(xgoal[i], x[i]);
  e[kPsi] = wrap_angle(e[kPsi]);
}

// boat.f: 3-DOF vessel, body-frame velocities, in the order of the PyTorch
// expression
__device__ __forceinline__ void boat_f(const float* p, const float* x,
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

// ops/integrate.py rk4_step, u held over the step; hh = dt / 2, h6 = dt / 6
__device__ __forceinline__ void boat_rk4(const float* p, const float* x,
                                         const float* u, float hh, float h,
                                         float h6, float* xn) {
  float k1[kN], k2[kN], k3[kN], k4[kN], t[kN];
  boat_f(p, x, u, k1);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(hh, k1[i]));
  boat_f(p, t, u, k2);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(hh, k2[i]));
  boat_f(p, t, u, k3);
#pragma unroll
  for (int i = 0; i < kN; ++i) t[i] = add(x[i], mul(h, k3[i]));
  boat_f(p, t, u, k4);
#pragma unroll
  for (int i = 0; i < kN; ++i)
    xn[i] = add(x[i], mul(h6, add(add(add(k1[i], mul(2.0f, k2[i])),
                                      mul(2.0f, k3[i])), k4[i])));
}

// |e| <= tol: the 2-norm against a scalar (the scan's test, not the Pallas
// kernel's sum <= tol^2), or every dim against its own
__device__ __forceinline__ bool converged(const float* e, const float* tol,
                                          bool per_dim) {
  if (per_dim) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < kN; ++i) ok = ok && fabsf(e[i]) <= tol[i];
    return ok;
  }
  float sq[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sq[i] = mul(e[i], e[i]);
  return sqrtf(sum6(sq)) <= tol[0];
}

__global__ void steer_rollout_kernel(
    const float* __restrict__ rows, const float* __restrict__ gains,
    const int* __restrict__ pids, int R, const float* __restrict__ xtar,
    const float* __restrict__ goal, const float* __restrict__ params,
    const float* __restrict__ tol, const float* __restrict__ gbuf,
    const float* __restrict__ circles, int ncirc, float* __restrict__ xs,
    float* __restrict__ us, int* __restrict__ length,
    float* __restrict__ xnew, bool* __restrict__ reached,
    bool* __restrict__ in_goal, int B, int H, int per_dim, float hh, float h,
    float h6) {
  __shared__ float p[kParams];
  __shared__ float cs[3 * kMaxCircles];   // (cx, cy, (r + margin)^2) each
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) p[i] = params[i];
  for (int i = threadIdx.x; i < 3 * ncirc; i += blockDim.x) cs[i] = circles[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  // the start row: b itself, or the parent pids[b]; a parent out of range
  // gives NaN (an empty, unreached rollout), never a fault
  const int r = pids != nullptr ? pids[b] : b;
  const bool valid = r >= 0 && r < R;
  const bool has_goal = gbuf != nullptr;
  float x[kN], tar[kN], g[kN], gb[kN], tl[kN], K[kM][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = valid ? rows[(size_t)r * kN + i] : CUDART_NAN_F;
    tar[i] = xtar[(size_t)b * kN + i];
    g[i] = has_goal ? goal[i] : 0.f;
    gb[i] = has_goal ? gbuf[i] : 0.f;
    tl[i] = tol[per_dim ? i : 0];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j)
      K[i][j] = valid ? gains[((size_t)r * kM + i) * kN + j] : CUDART_NAN_F;

  bool done = false, hit = false;
  int len = 0;
  for (int step = 0; step < H; ++step) {
    float e[kN], u[kM];
    boat_erf(tar, x, e);
    const bool arrived = converged(e, tl, per_dim);
#pragma unroll
    for (int i = 0; i < kM; ++i) {
      float prod[kN];
#pragma unroll
      for (int j = 0; j < kN; ++j) prod[j] = mul(K[i][j], e[j]);
      // saturate
      u[i] = fminf(fmaxf(sum6(prod), -p[kWMax + i]), p[kWMax + i]);
    }
    if (!done) {
      float xn[kN];
      boat_rk4(p, x, u, hh, h, h6, xn);
      bool feas = true;
      for (int k = 0; k < ncirc; ++k) {
        const float dx = sub(cs[3 * k], xn[0]), dy = sub(cs[3 * k + 1], xn[1]);
        feas = feas && add(mul(dx, dx), mul(dy, dy)) > cs[3 * k + 2];
      }
      const bool commit = !arrived && feas;
      done = arrived || !feas;
      if (commit) {
#pragma unroll
        for (int i = 0; i < kN; ++i) x[i] = xn[i];
        ++len;
        if (has_goal) {   // the first committed in-goal step ends it
          float eg[kN];
          boat_erf(g, xn, eg);
          bool in = true;
#pragma unroll
          for (int i = 0; i < kN; ++i) in = in && fabsf(eg[i]) <= gb[i];
          hit = hit || in;
          done = done || in;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) xs[((size_t)step * kN + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < kM; ++i) us[((size_t)step * kM + i) * B + b] = u[i];
  }
  float e[kN];
  boat_erf(tar, x, e);
  length[b] = len;
#pragma unroll
  for (int i = 0; i < kN; ++i) xnew[(size_t)b * kN + i] = x[i];
  reached[b] = converged(e, tl, per_dim);
  in_goal[b] = hit;
}

}  // namespace

// rows (R, 6) and gains (R, 3, 6): the candidates' own x0 and K (pids null,
// R = B) or the tree's states and K (pids (B,) parent rows).  goal and gbuf
// are both null without a goal box.  tol is (6,) with per_dim, else (1,).
// circles (ncirc, 3).  Outputs: xs (H, 6, B), us (H, 3, B), length, xnew
// (B, 6), reached and in_goal (B,) bool.  threads: candidates a block.
extern "C" int lqrrt_steer_rollout(
    const float* rows, const float* gains, const int* pids, int R,
    const float* xtar, const float* goal, const float* params,
    const float* tol, const float* gbuf, const float* circles, int ncirc,
    float* xs, float* us, int* length, float* xnew, bool* reached,
    bool* in_goal, int B, int H, int per_dim, float hh, float h, float h6,
    int threads, void* stream) {
  if (ncirc < 0 || ncirc > kMaxCircles || threads < 32 ||
      threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + threads - 1) / threads);
  steer_rollout_kernel<<<grid, threads, 0, s>>>(
      rows, gains, pids, R, xtar, goal, params, tol, gbuf, circles, ncirc, xs,
      us, length, xnew, reached, in_goal, B, H, per_dim, hh, h, h6);
  return static_cast<int>(cudaGetLastError());
}
