// The rollout stage scaffold: kernel D's loop with a chosen step body, to
// find where D's time goes.
//
// Replaces: tools/exp_steer_stages_v5.py, build (:54) with its twelve
// configurations (the bodies at :156-202 and :216-275; ``identity_nostore``
// is build(s_identity, store=False)), and tools/dbg_steer_kernel.py,
// run_stage (:40) with its six stages (:98-144).  The Pallas scaffolds
// traced a jnp body into an H-step fori_loop over (n, Bt) tiles; here each
// body is a device function and the scaffold one kernel, templated on the
// body and on whether x is stored every step; u is stored unless us is
// null (F3's stages have no us).
//
// For each candidate b, H steps of: (x_out, u, inc) = body(x, K, tar);
// store x_out to xs[h] and u to us[h] (unless off); x = x_out; length +=
// inc.  F2's bodies count every step (inc = 1); F3's feasibility and full
// stages count the steps whose select took xn.  Without per-step stores
// (identity_nostore) the final x goes to xs[0] and x[:3] * 0 to us[0], as
// the tool does.  Inputs are the tool's batch-trailing layout: x0 and tar
// (6, B), K (3, 6, B); outputs xs (H, 6, B), us (H, 3, B), length (B,).
//
// Each body is written in the JAX body's own expression order (the
// sequential u = u + K[:, j] e[j] matvec, 0.001 * e, _f_lin's and fb's row
// forms, the 3-row sum of F3's matvec, a literal 0.0025 threshold on
// sum(e * e) over the state rows) with kernel D's forms of the boat's
// device functions (boat_device.cuh), so that the stage times split D's
// time:
// - the erf's wrap is two selects, with fmodf only where |e + pi| >= 8 pi
//   (erf_fast);
// - boat.f's trig is one sincosf (the bits of sinf and cosf), and the RK4
//   of boat.f (dynamics, full, rk4_trig_rows, F3's dynamics, feasibility
//   and full) takes the four stages' sincosf after their velocity rows
//   (rk4_split), so that they depend on the velocity chain alone;
// - the first 8 circles sit in registers, each tested on its own, the rest
//   in shared memory (circles_ok);
// - full, dbg_feasibility and dbg_full carry their control, as D does: the
//   next step's e, arrived test and u are computed from xn beside the
//   circles and goal-box tests and taken if the step commits.  A step that
//   fails keeps x, so every later step repeats it and fails the same way:
//   from there the body only stores the held x and u (and adds 1 to F2's
//   length, 0 to F3's), as D does once done.  The stored x, u and length
//   are the plain version's bit for bit, but such a stage's time is that of
//   its rollouts up to their first failed step, not of H full steps.
// ``full`` is not D's step: it has no converged test on the scan's norm
// and no goal stop; F3's ``full`` adds the goal box, with no stop either.
// Every operation rounds alone, so on the card each stage equals its plain
// PyTorch version (ops/kernels/steer_stages.py) bit for bit where the plain
// version's reductions take the order written here (sum6_rows: torch.sum
// over dim 0 of a (6, B) tensor; the 3-row sum of F3's matvec).
//
// Bound on the H100: bytes, for every stage: the (H, 9, B) f32 outputs are
// 29.5 MB at B = 8192, H = 100 (~9 us at 3.35 TB/s); identity_nostore moves
// ~1.3 MB (~0.4 us).  What holds a stage back is D's limit, latency: one
// thread a candidate runs a serial chain of H steps (x, K and tar in
// registers, the boat's numbers and circles in shared memory, b the fastest
// index of every store), so the time is one warp's chain.  The geometry is
// D's (rollout_geometry in ops/kernels/steer_kernel.py: 32-128 threads a
// block from B and the SM count, so that the warps spread over every SM;
// __launch_bounds__(128, 1), without which ptxas spilled in D).  wgmma and
// TMA do not apply: there is no matrix product (the matvec is 18 products
// on one thread's registers) and no tile to stage (a thread reads its 30
// input floats once); a CUDA graph saves only host dispatch, and a call is
// one launch.
#include <cuda_runtime.h>

#include "boat_device.cuh"

namespace {

using boat::add;
using boat::kM;
using boat::kN;
using boat::kParams;
using boat::mul;
using boat::sub;

constexpr int kMaxCircles = 64;   // MAX_CIRCLES in ops/kernels/steer_kernel.py
constexpr int kMaxThreads = 128;  // MAX_THREADS there

// the step bodies; the stage ids of lqrrt_steer_stage map onto them
enum {
  kIdentity, kErf, kMatvec, kSat, kDyn, kFull, kSin, kSinCos8, kRk4Lin,
  kEuler, kRk4Trig, kDbgMatvec, kDbgFeas, kDbgFull
};

// the bodies that keep x on a failed step, and so carry their control
template <int kBody>
constexpr bool kHolds = kBody == kFull || kBody == kDbgFeas ||
                        kBody == kDbgFull;

struct Ctx {
  const float* p;         // the boat's numbers (shared memory)
  float hh, h, h6;        // rk4_step's dt / 2, dt, dt / 6
};

// u = K[:, 0] e[0], then u = u + K[:, j] e[j], j = 1..5
__device__ __forceinline__ void matvec(const float (*K)[kN], const float* e,
                                       float* u) {
#pragma unroll
  for (int i = 0; i < kM; ++i) {
    u[i] = mul(K[i][0], e[0]);
#pragma unroll
    for (int j = 1; j < kN; ++j) u[i] = add(u[i], mul(K[i][j], e[j]));
  }
}

// sum(e * e) over the state rows <= 0.0025 (s_full :194, s6 :134)
__device__ __forceinline__ bool arrived(const float* e) {
  float sq[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) sq[i] = mul(e[i], e[i]);
  return boat::sum6_rows(sq) <= 0.0025f;
}

// _f_lin (:227): the kinematics with an identity rotation, linear drag
__device__ __forceinline__ void f_lin(const float* p, const float* xb,
                                      const float* ub, float* d) {
#pragma unroll
  for (int k = 0; k < kM; ++k) {
    d[k] = xb[3 + k];
    d[3 + k] = mul(p[boat::kMinv + k],
                   sub(ub[k], mul(p[boat::kDLin + k], xb[3 + k])));
  }
}

// x + 0.001 * e, the erf bodies' x_out
__device__ __forceinline__ void nudge(const float* x, const float* e,
                                      float* xo) {
#pragma unroll
  for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, e[i]));
}

// the control of state x in the bodies that hold: u = K erf(tar, x)
// saturated (the sequential matvec); returns the arrived test on the same
// e where the body has one (full, dbg_full)
template <int kBody>
__device__ __forceinline__ bool control(const float* p, const float* tar,
                                        const float (*K)[kN], const float* x,
                                        float* u) {
  float e[kN];
  boat::erf_fast(tar, x, e);
  matvec(K, e, u);
  boat::saturate(p, u);
  return kBody != kDbgFeas && arrived(e);
}

// one step of a body that never holds (each counts every step): x_out into
// xo, the stored effort into u
template <int kBody>
__device__ __forceinline__ void body(const Ctx& c, const float* x,
                                     const float (*K)[kN], const float* tar,
                                     float* xo, float* u) {
  static_assert(!kHolds<kBody>, "a body that holds runs in stage_kernel");
  if constexpr (kBody == kIdentity || kBody == kSin || kBody == kSinCos8) {
#pragma unroll
    for (int i = 0; i < kM; ++i) u[i] = mul(x[i], 0.5f);
    if constexpr (kBody == kIdentity) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = mul(x[i], 1.000001f);
    } else if constexpr (kBody == kSin) {   // no cosine: sinf a row
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, sinf(x[i])));
    } else {
      // acc = acc + 0.001 sin(acc[2]) + 0.001 cos(acc[2]), four times
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = x[i];
      for (int r = 0; r < 4; ++r) {
        float sn, cs;
        sincosf(xo[2], &sn, &cs);
        sn = mul(0.001f, sn);
        cs = mul(0.001f, cs);
#pragma unroll
        for (int i = 0; i < kN; ++i) xo[i] = add(add(xo[i], sn), cs);
      }
    }
  } else if constexpr (kBody == kRk4Lin || kBody == kEuler ||
                       kBody == kRk4Trig) {
#pragma unroll
    for (int i = 0; i < kM; ++i) u[i] = mul(x[i], 0.1f);
    if constexpr (kBody == kRk4Lin) {       // no trig: rk4 of _f_lin
      const float* p = c.p;
      boat::rk4([p](const float* a, const float* v, float* d) {
        f_lin(p, a, v, d);
      }, x, u, c.hh, c.h, c.h6, xo);
    } else if constexpr (kBody == kEuler) {   // x + 0.05 boat.f(x, u)
      float xd[kN], cs, sn;
      boat::f_vel(c.p, x + 3, u, xd + 3);
      sincosf(x[2], &sn, &cs);
      boat::f_pos(cs, sn, x[3], x[4], xd);
      xd[2] = x[5];
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.05f, xd[i]));
    } else {                                  // fb's rows are boat.f's
      boat::rk4_split(c.p, x, u, c.hh, c.h, c.h6, xo);
    }
  } else {
    // the bodies that start from the erf
    float e[kN];
    boat::erf_fast(tar, x, e);
    if constexpr (kBody == kErf) {
#pragma unroll
      for (int i = 0; i < kM; ++i) u[i] = e[i];
      nudge(x, e, xo);
      return;
    }
    matvec(K, e, u);
    if constexpr (kBody == kDbgMatvec) {
      // x + 0.001 * u.sum(axis=0): the 3-row sum in PyTorch's order
      const float su = add(add(u[0], u[1]), u[2]);
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, su));
      return;
    }
    if constexpr (kBody == kMatvec) {
      nudge(x, e, xo);
      return;
    }
    boat::saturate(c.p, u);
    if constexpr (kBody == kSat) {
      nudge(x, e, xo);
    } else {                                  // kDyn
      boat::rk4_split(c.p, x, u, c.hh, c.h, c.h6, xo);
    }
  }
}

template <int kBody, bool kStore>
__global__ void __launch_bounds__(kMaxThreads, 1) stage_kernel(
    const float* __restrict__ x0, const float* __restrict__ Kt,
    const float* __restrict__ tart, const float* __restrict__ params,
    const float* __restrict__ circles, int ncirc,
    const float* __restrict__ goal, const float* __restrict__ gbuf,
    float* __restrict__ xs, float* __restrict__ us, int* __restrict__ length,
    int B, int H, float hh, float h, float h6) {
  __shared__ float p[kParams];
  __shared__ float cs[3 * kMaxCircles];   // (cx, cy, (r + margin)^2) each
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) p[i] = params[i];
  for (int i = threadIdx.x; i < 3 * ncirc; i += blockDim.x) cs[i] = circles[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x[kN], tar[kN], K[kM][kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = x0[(size_t)i * B + b];
    tar[i] = tart[(size_t)i * B + b];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) K[i][j] = Kt[((size_t)i * kN + j) * B + b];
  // xs[step] = xo and, unless us is null, us[step] = u
  auto store = [&](int step, const float* xo, const float* u) {
#pragma unroll
    for (int i = 0; i < kN; ++i) xs[((size_t)step * kN + i) * B + b] = xo[i];
    if (us != nullptr) {
#pragma unroll
      for (int i = 0; i < kM; ++i) us[((size_t)step * kM + i) * B + b] = u[i];
    }
  };
  int len = 0;
  if constexpr (kHolds<kBody>) {
    float cr[boat::kRegCircles][3];
    boat::load_circles(cs, ncirc, cr);
    [[maybe_unused]] float g[kN], gb[kN];   // the goal box (dbg_full)
    if constexpr (kBody == kDbgFull) {
#pragma unroll
      for (int i = 0; i < kN; ++i) {
        g[i] = goal[i];
        gb[i] = gbuf[i];
      }
    }
    // u and arr always belong to the current x
    float u[kM];
    bool arr = control<kBody>(p, tar, K, x, u), held = false;
    for (int step = 0; step < H; ++step) {
      float ustep[kM];   // u of the state this step starts from: stored
#pragma unroll
      for (int i = 0; i < kM; ++i) ustep[i] = u[i];
      bool ok = false;
      if (!held && arr) {
        held = true;     // arrived: the select keeps x, now and after
      } else if (!held) {
        float xn[kN], un[kM];
        boat::rk4_split(p, x, u, hh, h, h6, xn);
        ok = boat::circles_ok(cr, cs, ncirc, xn[0], xn[1]);
        // the next step's control, taken if this step commits
        const bool arr_n = control<kBody>(p, tar, K, xn, un);
        if constexpr (kBody == kDbgFull) {   // and not in the goal box
          float eg[kN];
          boat::erf_fast(g, xn, eg);
          bool hit = true;
#pragma unroll
          for (int i = 0; i < kN; ++i) hit &= fabsf(eg[i]) <= gb[i];
          ok &= !hit;
        }
        if (ok) {
#pragma unroll
          for (int i = 0; i < kN; ++i) x[i] = xn[i];
#pragma unroll
          for (int i = 0; i < kM; ++i) u[i] = un[i];
          arr = arr_n;
        } else {
          held = true;
        }
      }
      store(step, x, ustep);
      len += kBody == kFull ? 1 : ok;   // F2 counts every step
    }
  } else {
    const Ctx c{p, hh, h, h6};
    for (int step = 0; step < H; ++step) {
      float xo[kN], u[kM];
      body<kBody>(c, x, K, tar, xo, u);
      if (kStore) store(step, xo, u);
#pragma unroll
      for (int i = 0; i < kN; ++i) x[i] = xo[i];
    }
    len = H;
    if (!kStore) {
      float u0[kM];
#pragma unroll
      for (int i = 0; i < kM; ++i) u0[i] = mul(x[i], 0.0f);
      store(0, x, u0);
    }
  }
  length[b] = len;
}

}  // namespace

// stage: 0-11 the tool's configurations in the order of STAGES in
// ops/kernels/steer_stages.py (identity, identity_nostore, erf, matvec,
// saturate, dynamics, full, sin_whole, sincos8_row, rk4_lin_rows,
// euler_full, rk4_trig_rows), 12-17 dbg_steer_kernel's (identity, erf,
// matvec, dynamics, feasibility, full).  us is null for F3's stages,
// which store no u.  params: boat_params(); circles (ncirc, 3); goal and
// gbuf (6,).  Geometry (rollout_geometry in ops/kernels/steer_kernel.py):
// threads (a multiple of 32, at most 128) a block, blocks covering B, one
// thread a candidate.
extern "C" int lqrrt_steer_stage(
    const float* x0, const float* K, const float* tar, int stage,
    const float* params, const float* circles, int ncirc, const float* goal,
    const float* gbuf, float* xs, float* us, int* length, int B, int H,
    float hh, float h, float h6, int threads, int blocks, void* stream) {
  if (ncirc < 0 || ncirc > kMaxCircles || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0 ||
      (long long)blocks * threads < B)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LQRRT_STAGE(ID, BODY, STORE)                                        \
  case ID:                                                                   \
    stage_kernel<BODY, STORE><<<blocks, threads, 0, s>>>(                    \
        x0, K, tar, params, circles, ncirc, goal, gbuf, xs, us, length, B,   \
        H, hh, h, h6);                                                       \
    break;
  switch (stage) {
    LQRRT_STAGE(0, kIdentity, true)
    LQRRT_STAGE(1, kIdentity, false)
    LQRRT_STAGE(2, kErf, true)
    LQRRT_STAGE(3, kMatvec, true)
    LQRRT_STAGE(4, kSat, true)
    LQRRT_STAGE(5, kDyn, true)
    LQRRT_STAGE(6, kFull, true)
    LQRRT_STAGE(7, kSin, true)
    LQRRT_STAGE(8, kSinCos8, true)
    LQRRT_STAGE(9, kRk4Lin, true)
    LQRRT_STAGE(10, kEuler, true)
    LQRRT_STAGE(11, kRk4Trig, true)
    LQRRT_STAGE(12, kIdentity, true)
    LQRRT_STAGE(13, kErf, true)
    LQRRT_STAGE(14, kDbgMatvec, true)
    LQRRT_STAGE(15, kDyn, true)
    LQRRT_STAGE(16, kDbgFeas, true)
    LQRRT_STAGE(17, kDbgFull, true)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef LQRRT_STAGE
  return static_cast<int>(cudaGetLastError());
}
