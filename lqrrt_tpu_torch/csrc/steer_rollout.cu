// Kernel D: the fused closed-loop LQR steer rollout of the boat, with an
// optional parent gather.
//
// Replaces: tools/steer_kernel_experimental.py, make_steer_pallas (:72) and
// make_steer_pallas_tree (:340), and, launched by F1's factory
// (make_steer_kernel_dv) into (H, n, 1, B) buffers, the same memory as
// (H, n, B), tools/exp_steer_dv_v5.py, make_steer_pallas_dv (:29), whose
// double vmap only kept Mosaic's values 2-D.  The Pallas kernels traced the
// user's callbacks (dynamics, erf, is_feasible, saturate) into the kernel
// through jax.vmap.  A CUDA kernel cannot, so the boat's callbacks
// (lqrrt_tpu_torch/models/boat.py) are device functions
// (boat_device.cuh), its numbers arrive as a kernel argument, and the
// wrapper (ops/kernels/steer_kernel.py) refuses a model that has none.
//
// For each candidate b, H steps of exactly core/steer.py's step, in its
// order: e = erf(xtar, x) with psi wrapped; the converged test (scalar
// 2-norm or per-dim tol); u = K e clamped to +-WRENCH_MAX; RK4 of the boat
// on u; the circles test on xn; commit (x = xn, length += 1) unless done,
// arrived or infeasible; with a goal box, stop after the first committed
// in-goal step.  x and u are stored at every step, done or not: a finished
// rollout holds its state, and its u is that of the held state, as in the
// scan.  After the loop: length, xnew, reached (the converged test on the
// final x) and in_goal.  Commits are a prefix, so the wrapper derives the
// mask from length.
//
// Tree variant: with pids non-null, candidate b reads its start state and
// gain from rows pids[b] of the tree buffers directly.  (The Pallas kernel
// gathered them with a one-hot matmul over node blocks, since Mosaic has no
// dynamic lane index.)
//
// Bound on the H100: bytes.  At B = 8192, H = 100 the outputs, (H, 6 + 3, B)
// f32, are 29.5 MB and the inputs ~1 MB: ~9 us at 3.35 TB/s, against ~2e8
// fp32 flops for the boat's data, ~3 us at 67 TFLOP/s.  What holds a
// rollout back is latency: each candidate is a serial chain of H steps, one
// thread each, and a warp's 32 chains take as long at B = 1024 as at 8192
// (one warp a scheduler at most), so the time is one warp's chain of ~500
// instructions a step.  The design shortens that chain; the geometry
// (threads a block, from B and the SM count: rollout_geometry in
// ops/kernels/steer_kernel.py, not the Pallas tile) spreads the warps over
// every SM.  A step's chain:
// - the RK4's velocity rows take no trig and psi of each stage depends only
//   on them, so the four stages' sincosf (one range reduction for both, the
//   bits of sinf and cosf) depend on the velocity chain alone, not on each
//   other;
// - the erf's wrap is two selects, with fmodf (a loop, and a branch some
//   lanes take) only where |e + pi| >= 8 pi (wrap_angle_fast: the same
//   bits; tools/exp_wrap_forms.py times it against the other forms);
// - the scalar converged test compares the sum of squares with the largest
//   float whose rounded sqrt is <= tol (the wrapper's sqrt_threshold: the
//   same boolean as sqrt(sum) <= tol, without the sqrt);
// - the first 8 circles sit in registers and are tested independently and
//   ANDed (the same boolean as collision.circles_free; a slot past ncirc
//   passes, as no circle does for a NaN xn); the rest are read from shared
//   memory (one loop over shared memory for all was slower at 7, 10 and 64
//   circles: tools/exp_rollout_circles.py);
// - the next step's erf, converged test and u are computed from xn beside
//   the circles and the goal test, and taken if the step commits; a rollout
//   that is done keeps its x and u and only stores them (once done, x never
//   changes, so neither does u).
// Spreading a candidate over 2 or 4 lanes (each stage's trig and the
// circles on its own lane, joined by shuffles and a vote) was measured
// slower at B = 1024-8192: every lane still runs the control and the
// velocity chain.  wgmma, TMA and CUDA-graph capture do not apply to one
// launch of scalar chains.
//
// Rounding: every operation rounds on its own, in the plain version's order
// (the device functions of boat_device.cuh, which the stage scaffold
// steer_stages.cu shares; sums of 6 follow PyTorch's CUDA reduction), with
// precise sincosf, fmodf and sqrtf-equivalent tests (no
// --use_fast_math), so that on the card the kernel reproduces the plain
// steer's arithmetic: a rollout amplifies one ulp of x into ~1e-3 of u
// through the gain K.  The saturation propagates NaN as torch.clamp does,
// so a NaN start row (a parent out of range, a NaN row of the tree) gives
// the plain version's NaN x and u, bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "boat_device.cuh"

namespace {

using boat::kM;
using boat::kN;
using boat::kParams;
using boat::mul;
using boat::sum6;

constexpr int kMaxCircles = 64;   // MAX_CIRCLES in ops/kernels/steer_kernel.py
constexpr int kMaxThreads = 128;  // MAX_THREADS there

// |e| <= tol: the 2-norm against a scalar (the scan's test, not the Pallas
// kernel's sum <= tol^2) as sum(e^2) <= tol's sqrt threshold, or every dim
// against its own
__device__ __forceinline__ bool converged(const float* e, const float* tol,
                                          bool per_dim) {
  if (per_dim) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < kN; ++i) ok &= fabsf(e[i]) <= tol[i];
    return ok;
  }
  float sq[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sq[i] = mul(e[i], e[i]);
  return sum6(sq) <= tol[0];
}

// the control of state x: u = K erf(xtar, x) saturated; returns the
// converged test on the same e
__device__ __forceinline__ bool control(const float* p, const float* tar,
                                        const float* x,
                                        const float (*K)[kN],
                                        const float* tol, bool per_dim,
                                        float* u) {
  float e[kN];
  boat::erf_fast(tar, x, e);
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    float prod[kN];
#pragma unroll
    for (int j = 0; j < kN; ++j) prod[j] = mul(K[i][j], e[j]);
    u[i] = sum6(prod);
  }
  boat::saturate(p, u);
  return converged(e, tol, per_dim);
}

__global__ void __launch_bounds__(kMaxThreads, 1) steer_rollout_kernel(
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
  // gives a NaN start and gain (with circles, an empty, unreached rollout of
  // NaN x and u, as the plain version on the wrapper's NaN rows), never a
  // fault
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
  // the first kRegCircles circles in registers, the rest read from shared
  // memory each step
  float cr[boat::kRegCircles][3];
  boat::load_circles(cs, ncirc, cr);

  // u and arrived always belong to the current x
  float u[kM];
  bool arrived = control(p, tar, x, K, tl, per_dim, u);
  bool done = false, hit = false;
  int len = 0;
  for (int step = 0; step < H; ++step) {
    float ustep[kM];   // u of the state this step starts from: stored
#pragma unroll
    for (int i = 0; i < kM; ++i) ustep[i] = u[i];
    if (!done) {
      if (arrived) {
        done = true;
      } else {
        float xn[kN], un[kM];
        boat::rk4_split(p, x, u, hh, h, h6, xn);
        const bool feas = boat::circles_ok(cr, cs, ncirc, xn[0], xn[1]);
        // the next step's control, taken if this step commits
        const bool arrived_n = control(p, tar, xn, K, tl, per_dim, un);
        bool in = has_goal;
        if (has_goal) {   // the first committed in-goal step ends it
          float eg[kN];
          boat::erf_fast(g, xn, eg);
#pragma unroll
          for (int i = 0; i < kN; ++i) in &= fabsf(eg[i]) <= gb[i];
        }
        if (feas) {
#pragma unroll
          for (int i = 0; i < kN; ++i) x[i] = xn[i];
#pragma unroll
          for (int i = 0; i < kM; ++i) u[i] = un[i];
          arrived = arrived_n;
          ++len;
          hit = in;
          done = in;
        } else {
          done = true;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) xs[((size_t)step * kN + i) * B + b] = x[i];
#pragma unroll
    for (int i = 0; i < kM; ++i)
      us[((size_t)step * kM + i) * B + b] = ustep[i];
  }
  length[b] = len;
#pragma unroll
  for (int i = 0; i < kN; ++i) xnew[(size_t)b * kN + i] = x[i];
  reached[b] = arrived;
  in_goal[b] = hit;
}

}  // namespace

// rows (R, 6) and gains (R, 3, 6): the candidates' own x0 and K (pids null,
// R = B) or the tree's states and K (pids (B,) parent rows).  goal and gbuf
// are both null without a goal box.  tol is (6,) with per_dim, else (1,):
// the largest sum of squares whose rounded sqrt is <= error_tol.  circles
// (ncirc, 3).  Outputs: xs (H, 6, B), us (H, 3, B), length, xnew (B, 6),
// reached and in_goal (B,) bool.  Geometry (rollout_geometry in
// ops/kernels/steer_kernel.py): threads (a multiple of 32, at most 128) a
// block, blocks covering B, one thread a candidate.
extern "C" int lqrrt_steer_rollout(
    const float* rows, const float* gains, const int* pids, int R,
    const float* xtar, const float* goal, const float* params,
    const float* tol, const float* gbuf, const float* circles, int ncirc,
    float* xs, float* us, int* length, float* xnew, bool* reached,
    bool* in_goal, int B, int H, int per_dim, float hh, float h, float h6,
    int threads, int blocks, void* stream) {
  if (ncirc < 0 || ncirc > kMaxCircles || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (long long)blocks * threads < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  steer_rollout_kernel<<<blocks, threads, 0, s>>>(
      rows, gains, pids, R, xtar, goal, params, tol, gbuf, circles, ncirc, xs,
      us, length, xnew, reached, in_goal, B, H, per_dim, hh, h, h6);
  return static_cast<int>(cudaGetLastError());
}
