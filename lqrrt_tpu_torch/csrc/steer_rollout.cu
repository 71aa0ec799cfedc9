// Kernel D: the fused closed-loop LQR steer rollout of the boat, the car,
// the quadrotor or the double integrator, with an optional parent gather.
//
// Replaces: tools/steer_kernel_experimental.py, make_steer_pallas (:72) and
// make_steer_pallas_tree (:340), and, launched by F1's factory
// (make_steer_kernel_dv) into (H, n, 1, B) buffers, the same memory as
// (H, n, B), tools/exp_steer_dv_v5.py, make_steer_pallas_dv (:29), whose
// double vmap only kept Mosaic's values 2-D.  The Pallas kernels traced the
// user's callbacks (dynamics, erf, is_feasible, saturate) into the kernel
// through jax.vmap.  A CUDA kernel cannot, so each model's callbacks
// (lqrrt_tpu_torch/models/) are device functions (boat_device.cuh,
// car_device.cuh, quadrotor_device.cuh, double_integrator_device.cuh), the
// kernel is a template on a model trait (Boat, Car, Quadrotor,
// DoubleIntegrator below: one instance each, chosen by the model id), the
// model's numbers arrive as a kernel argument, and the wrapper
// (ops/kernels/steer_kernel.py) refuses a model that has none.  The
// predicate is collision.circles_free's test on (x0, x1), control_limits'
// box on u, OccupancyGrid.feasibility()'s raster on (x0, x1), or an all_of
// of those: the circles as an argument (ncirc may be 0), the box as a
// pointer (null without one), and the raster as a pointer to its bits
// (null without one) with its shape and cell transform.  The raster is a
// compile-time flag of the model trait (Raster<M>: an instance with it and
// one without for each model, chosen by the launch from the pointer), so
// the instances without a raster run the code they ran before it was added
// (the same registers; the module's dynamic shared memory rounds their
// static arrays up to 16 B).
//
// For each candidate b, H steps of exactly core/steer.py's step, in its
// order: e = erf(xtar, x) with the model's angle wrapped (none for the
// double integrator); the converged test (scalar 2-norm or per-dim tol);
// u = K e saturated by the model's saturate; RK4 of the model's f on u;
// the predicate on (xn, u); commit (x = xn, length += 1) unless done,
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
// Bound on the H100: bytes.  At B = 8192, H = 100 the boat's outputs,
// (H, 6 + 3, B) f32, are 29.5 MB and the inputs ~1 MB: ~9 us at 3.35 TB/s,
// against ~2e8 fp32 flops for the boat's data, ~3 us at 67 TFLOP/s (the
// other models: kernel_times.steer_bound).  What holds a
// rollout back is latency: each candidate is a serial chain of H steps, one
// thread each, and a warp's 32 chains take as long at B = 1024 as at 8192
// (one warp a scheduler at most), so the time is one warp's chain of ~500
// instructions a step.  The design shortens that chain; the geometry
// (threads a block, from B and the SM count: rollout_geometry in
// ops/kernels/steer_kernel.py, not the Pallas tile) spreads the warps over
// every SM.  A step's chain:
// - the boat's RK4: its velocity rows take no trig and psi of each stage
//   depends only on them, so the four stages' sincosf (one range reduction
//   for both, the bits of sinf and cosf) depend on the velocity chain
//   alone, not on each other (rk4_split); the other models take rk4 as
//   written, its sum folded as each stage is made;
// - the erf's wrap is two selects, with fmodf (a loop, and a branch some
//   lanes take) only where |e + pi| >= 8 pi (wrap_angle_fast: the same
//   bits; tools/exp_wrap_forms.py times it against the other forms);
// - the scalar converged test compares the sum of squares with the largest
//   float whose rounded sqrt is <= tol (the wrapper's sqrt_threshold: the
//   same boolean as sqrt(sum) <= tol, without the sqrt);
// - the raster (Raster<M> instances only): each block stages its bits, one
//   a cell in row-major uint32 words (ops/kernels/steer_kernel.py
//   pack_grid; 2,400 B for the grid boat's 96 x 200 cells, at most
//   kMaxGridWords), in dynamic shared memory, and a step's test is the
//   cell's arithmetic and one shared-memory read (grid_free);
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
// (the device functions of the model headers; boat_device.cuh's the stage
// scaffold steer_stages.cu shares; sums over the last dim follow PyTorch's
// CUDA reduction, torch_sum; the quadrotor's divisions are IEEE's, div_rn),
// with precise sincosf, tanf, fmodf and sqrtf-equivalent tests (no
// --use_fast_math), so that on the card the kernel reproduces the plain
// steer's arithmetic: a rollout amplifies one ulp of x into ~1e-3 of u
// through the gain K.  The saturation propagates NaN as torch.clamp does,
// so a NaN start row (a parent out of range, a NaN row of the tree) gives
// the plain version's NaN x and u, bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#include "boat_device.cuh"
#include "car_device.cuh"
#include "double_integrator_device.cuh"
#include "quadrotor_device.cuh"

namespace {

using boat::mul;
using boat::sub;

constexpr int kMaxCircles = 64;   // MAX_CIRCLES in ops/kernels/steer_kernel.py
constexpr int kMaxThreads = 128;  // MAX_THREADS there
// MAX_GRID_WORDS there: 46 KiB, which with the static arrays (under 1 KiB)
// stays inside the 48 KiB a block takes without an opt-in
constexpr int kMaxGridWords = 11776;

// The model traits: sizes, the erf's wrapped dim (-1: none), the number of
// model numbers, whether the predicate holds a raster (Raster<M> below),
// one RK4 step and the saturation.  The ids are the wrapper's (_MODELS in
// ops/kernels/steer_kernel.py).
struct Boat {
  static constexpr int kId = 0, kN = boat::kN, kM = boat::kM,
                       kWrap = boat::kPsi, kParams = boat::kParams;
  static constexpr bool kGrid = false;
  static __device__ __forceinline__ void step(const float* p, const float* x,
                                              const float* u, float hh,
                                              float h, float h6, float* xn) {
    boat::rk4_split(p, x, u, hh, h, h6, xn);
  }
  static __device__ __forceinline__ void saturate(const float* p, float* u) {
    boat::saturate(p, u);
  }
};

#define LQRRT_RK4_MODEL(Trait, ns, id)                                       \
  struct Trait {                                                             \
    static constexpr int kId = id, kN = ns::kN, kM = ns::kM,                 \
                         kWrap = ns::kWrap, kParams = ns::kParams;           \
    static constexpr bool kGrid = false;                                     \
    static __device__ __forceinline__ void step(                             \
        const float* p, const float* x, const float* u, float hh, float h,  \
        float h6, float* xn) {                                               \
      boat::rk4<kN>([p](const float* a, const float* v, float* d) {          \
        ns::f(p, a, v, d);                                                   \
      }, x, u, hh, h, h6, xn);                                               \
    }                                                                        \
    static __device__ __forceinline__ void saturate(const float* p,          \
                                                    float* u) {              \
      ns::saturate(p, u);                                                    \
    }                                                                        \
  };
LQRRT_RK4_MODEL(Car, car, 1)
LQRRT_RK4_MODEL(Quadrotor, quadrotor, 2)
LQRRT_RK4_MODEL(DoubleIntegrator, double_integrator, 3)
#undef LQRRT_RK4_MODEL

// model M with a raster in its predicate
template <class M>
struct Raster : M {
  static constexpr bool kGrid = true;
};

// e = xgoal - x, the model's angle wrapped
template <class M>
__device__ __forceinline__ void erf(const float* xgoal, const float* x,
                                    float* e) {
#pragma unroll
  for (int i = 0; i < M::kN; ++i) e[i] = sub(xgoal[i], x[i]);
  if constexpr (M::kWrap >= 0) e[M::kWrap] = boat::wrap_angle_fast(e[M::kWrap]);
}

// |e| <= tol: the 2-norm against a scalar (the scan's test, not the Pallas
// kernel's sum <= tol^2) as sum(e^2) <= tol's sqrt threshold, or every dim
// against its own
template <int N>
__device__ __forceinline__ bool converged(const float* e, const float* tol,
                                          bool per_dim) {
  if (per_dim) {
    bool ok = true;
#pragma unroll
    for (int i = 0; i < N; ++i) ok &= fabsf(e[i]) <= tol[i];
    return ok;
  }
  float sq[N];
#pragma unroll
  for (int i = 0; i < N; ++i) sq[i] = mul(e[i], e[i]);
  return boat::torch_sum<N>(sq) <= tol[0];
}

// the control of state x: u = K erf(xtar, x) saturated; returns the
// converged test on the same e
template <class M>
__device__ __forceinline__ bool control(const float* p, const float* tar,
                                        const float* x,
                                        const float (*K)[M::kN],
                                        const float* tol, bool per_dim,
                                        float* u) {
  float e[M::kN];
  erf<M>(tar, x, e);
#pragma unroll
  for (int i = 0; i < M::kM; ++i) {
    float prod[M::kN];
#pragma unroll
    for (int j = 0; j < M::kN; ++j) prod[j] = mul(K[i][j], e[j]);
    u[i] = boat::torch_sum<M::kN>(prod);
  }
  M::saturate(p, u);
  return converged<M::kN>(e, tol, per_dim);
}

// control_limits' test: lo <= u <= hi in every dim (false for NaN)
template <int M>
__device__ __forceinline__ bool in_limits(const float* lim, const float* u) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < M; ++i) ok &= u[i] >= lim[i] && u[i] <= lim[M + i];
  return ok;
}

// OccupancyGrid.feasibility()'s test on (px, py) as the plain predicate
// computes it on the card (ops/collision.py _grid_cells): the cell
// floor((p - origin) * inv), inv the float32 reciprocal of the resolution
// (PyTorch's CUDA division by a Python float multiplies by it), in bounds
// on the float cell (false for NaN) before the cast, flat index cy W + cx;
// free iff in bounds and its bit in the words is clear
__device__ __forceinline__ bool grid_free(const unsigned* words, int gw,
                                          int gh, float gx0, float gy0,
                                          float ginv, float px, float py) {
  const float cx = floorf(mul(sub(px, gx0), ginv));
  const float cy = floorf(mul(sub(py, gy0), ginv));
  const bool inb = cx >= 0.f && cx < static_cast<float>(gw) && cy >= 0.f &&
                   cy < static_cast<float>(gh);
  const int i = inb ? static_cast<int>(cy) * gw + static_cast<int>(cx) : 0;
  return inb && ((words[i >> 5] >> (i & 31)) & 1u) == 0u;
}

template <class M>
__global__ void __launch_bounds__(kMaxThreads, 1) steer_rollout_kernel(
    const float* __restrict__ rows, const float* __restrict__ gains,
    const int* __restrict__ pids, int R, const float* __restrict__ xtar,
    const float* __restrict__ goal, const float* __restrict__ params,
    const float* __restrict__ tol, const float* __restrict__ gbuf,
    const float* __restrict__ circles, int ncirc,
    const float* __restrict__ ulim, const unsigned* __restrict__ grid,
    int gw, int gh, float gx0, float gy0, float ginv, float* __restrict__ xs,
    float* __restrict__ us, int* __restrict__ length,
    float* __restrict__ xnew, bool* __restrict__ reached,
    bool* __restrict__ in_goal, int B, int H, int per_dim, float hh, float h,
    float h6) {
  constexpr int kN = M::kN, kM = M::kM;
  __shared__ float p[M::kParams];
  __shared__ float cs[3 * kMaxCircles];   // (cx, cy, (r + margin)^2) each
  __shared__ float lim[2 * kM];           // control_limits' (lo, hi)
  extern __shared__ unsigned gbits[];     // the raster's words (Raster<M>)
  for (int i = threadIdx.x; i < M::kParams; i += blockDim.x) p[i] = params[i];
  for (int i = threadIdx.x; i < 3 * ncirc; i += blockDim.x) cs[i] = circles[i];
  const bool has_lim = ulim != nullptr;
  if (has_lim)
    for (int i = threadIdx.x; i < 2 * kM; i += blockDim.x) lim[i] = ulim[i];
  if constexpr (M::kGrid)
    for (int i = threadIdx.x; i < (gw * gh + 31) >> 5; i += blockDim.x)
      gbits[i] = grid[i];
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
  bool arrived = control<M>(p, tar, x, K, tl, per_dim, u);
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
        M::step(p, x, u, hh, h, h6, xn);
        const bool feas = boat::circles_ok(cr, cs, ncirc, xn[0], xn[1]);
        // all_of(control_limits, circles_free, the raster): the box on the
        // step's u, the raster's cell of xn
        bool ok = feas && (!has_lim || in_limits<kM>(lim, u));
        if constexpr (M::kGrid)
          ok &= grid_free(gbits, gw, gh, gx0, gy0, ginv, xn[0], xn[1]);
        // the next step's control, taken if this step commits
        const bool arrived_n = control<M>(p, tar, xn, K, tl, per_dim, un);
        bool in = has_goal;
        if (has_goal) {   // the first committed in-goal step ends it
          float eg[kN];
          erf<M>(g, xn, eg);
#pragma unroll
          for (int i = 0; i < kN; ++i) in &= fabsf(eg[i]) <= gb[i];
        }
        if (ok) {
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

// the instance of model M without a raster, or Raster<M> with the raster's
// words in dynamic shared memory
template <class M>
cudaError_t launch(const float* rows, const float* gains, const int* pids,
                   int R, const float* xtar, const float* goal,
                   const float* params, const float* tol, const float* gbuf,
                   const float* circles, int ncirc, const float* ulim,
                   const unsigned* grid, int gw, int gh, float gx0, float gy0,
                   float ginv, float* xs, float* us, int* length, float* xnew,
                   bool* reached, bool* in_goal, int B, int H, int per_dim,
                   float hh, float h, float h6, int threads, int blocks,
                   cudaStream_t s) {
  if (grid == nullptr) {
    steer_rollout_kernel<M><<<blocks, threads, 0, s>>>(
        rows, gains, pids, R, xtar, goal, params, tol, gbuf, circles, ncirc,
        ulim, nullptr, 0, 0, 0.f, 0.f, 0.f, xs, us, length, xnew, reached,
        in_goal, B, H, per_dim, hh, h, h6);
  } else {
    const size_t smem = sizeof(unsigned) * ((gw * gh + 31) >> 5);
    steer_rollout_kernel<Raster<M>><<<blocks, threads, smem, s>>>(
        rows, gains, pids, R, xtar, goal, params, tol, gbuf, circles, ncirc,
        ulim, grid, gw, gh, gx0, gy0, ginv, xs, us, length, xnew, reached,
        in_goal, B, H, per_dim, hh, h, h6);
  }
  return cudaGetLastError();
}

// the card's tanf and div_rn, elementwise, for the check that they are
// torch.tan's and torch's `/`'s bits
__global__ void math_probe_kernel(int op, const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = op == 0 ? tanf(a[i]) : boat::div_rn(a[i], b[i]);
}

}  // namespace

// rows (R, n) and gains (R, m, n): the candidates' own x0 and
// K (pids null, R = B) or the tree's states and K (pids (B,) parent rows).
// goal and gbuf are both null without a goal box.  tol is (n,) with
// per_dim, else (1,): the largest sum of squares whose rounded sqrt is <=
// error_tol.  circles (ncirc, 3); ulim (2, m), control_limits' lo and hi,
// or null; grid, the raster's (gh, gw) cells as bits in row-major words
// (cell i in bit i & 31 of word i >> 5, set where occupied), or null, with
// the world position (gx0, gy0) of cell (0, 0) and ginv cells a metre.
// Outputs: xs (H, n, B), us (H, m, B), length, xnew (B, n),
// reached and in_goal (B,) bool.  Geometry (rollout_geometry in
// ops/kernels/steer_kernel.py): threads (a multiple of 32, at most 128) a
// block, blocks covering B, one thread a candidate.  model (n states, m
// controls): 0 boat, 1 car, 2 quadrotor, 3 double integrator.
extern "C" int lqrrt_steer_rollout(
    const float* rows, const float* gains, const int* pids, int R,
    const float* xtar, const float* goal, const float* params,
    const float* tol, const float* gbuf, const float* circles, int ncirc,
    const float* ulim, const unsigned* grid, int gw, int gh, float gx0,
    float gy0, float ginv, float* xs, float* us, int* length, float* xnew,
    bool* reached, bool* in_goal, int B, int H, int per_dim, float hh,
    float h, float h6, int model, int threads, int blocks, void* stream) {
  if (ncirc < 0 || ncirc > kMaxCircles || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (long long)blocks * threads < B ||
      (grid != nullptr &&
       (gw < 1 || gh < 1 || (long long)gw * gh > 32LL * kMaxGridWords)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LQRRT_LAUNCH(Trait)                                                  \
  launch<Trait>(rows, gains, pids, R, xtar, goal, params, tol, gbuf,         \
                circles, ncirc, ulim, grid, gw, gh, gx0, gy0, ginv, xs, us,  \
                length, xnew, reached, in_goal, B, H, per_dim, hh, h, h6,    \
                threads, blocks, s)
  cudaError_t err;
  switch (model) {
    case Boat::kId: err = LQRRT_LAUNCH(Boat); break;
    case Car::kId: err = LQRRT_LAUNCH(Car); break;
    case Quadrotor::kId: err = LQRRT_LAUNCH(Quadrotor); break;
    case DoubleIntegrator::kId: err = LQRRT_LAUNCH(DoubleIntegrator); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LQRRT_LAUNCH
  return static_cast<int>(err);
}

// op 0: out = tanf(a); op 1: out = div_rn(a, b); n elements
extern "C" int lqrrt_math_probe(const float* a, const float* b, float* out,
                                int n, int op, void* stream) {
  if (op < 0 || op > 1 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  math_probe_kernel<<<(n + 255) / 256, 256, 0,
                      static_cast<cudaStream_t>(stream)>>>(op, a, b, out, n);
  return static_cast<int>(cudaGetLastError());
}
