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
// forms) with the boat's device functions (boat_device.cuh) wherever the
// body calls the boat's erf, f, saturate or RK4.  ``full`` is not D's step:
// it has a literal 0.0025 threshold on sum(e * e) over the state rows, no
// done carry and no goal stop; F3's ``full`` adds the goal box, still with
// no done carry.  Every operation rounds alone, so on the card each stage
// equals its plain PyTorch version (ops/kernels/steer_stages.py) bit for
// bit where the plain version's reductions take the order written here
// (sum6_rows: torch.sum over dim 0 of a (6, B) tensor; the 3-row sum of
// F3's matvec).
//
// Bound on the H100: bytes for every stage that stores (the (H, 9, B) f32
// outputs, 29.5 MB at B = 8192, H = 100: ~9 us), operations for
// identity_nostore; the design is D's (one thread a candidate, x, K and tar
// in registers, the boat's numbers and circles in shared memory, b the
// fastest index of every store), and so is its limit: one serial chain a
// thread, two warps an SM at B = 8192.  Timing the bodies in turn splits
// D's latency into its parts.
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

// the step bodies; the stage ids of lqrrt_steer_stage map onto them
enum {
  kIdentity, kErf, kMatvec, kSat, kDyn, kFull, kSin, kSinCos8, kRk4Lin,
  kEuler, kRk4Trig, kDbgMatvec, kDbgFeas, kDbgFull
};

struct Ctx {
  const float* p;         // the boat's numbers (shared memory)
  const float* cs;        // circles (cx, cy, (r + margin)^2) (shared)
  int ncirc;
  const float* goal;      // goal and goal box (F3's full)
  const float* gbuf;
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

// one step of stage kBody: x_out into xo, the stored effort into u; returns
// inc, what the step adds to the length
template <int kBody>
__device__ __forceinline__ int body(const Ctx& c, const float* x,
                                    const float (*K)[kN], const float* tar,
                                    float* xo, float* u) {
  if constexpr (kBody == kIdentity || kBody == kSin || kBody == kSinCos8) {
#pragma unroll
    for (int i = 0; i < kM; ++i) u[i] = mul(x[i], 0.5f);
    if constexpr (kBody == kIdentity) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = mul(x[i], 1.000001f);
    } else if constexpr (kBody == kSin) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, sinf(x[i])));
    } else {
      // acc = acc + 0.001 sin(acc[2]) + 0.001 cos(acc[2]), four times
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = x[i];
      for (int r = 0; r < 4; ++r) {
        const float sn = mul(0.001f, sinf(xo[2]));
        const float cs = mul(0.001f, cosf(xo[2]));
#pragma unroll
        for (int i = 0; i < kN; ++i) xo[i] = add(add(xo[i], sn), cs);
      }
    }
    return 1;
  } else if constexpr (kBody == kRk4Lin || kBody == kEuler ||
                       kBody == kRk4Trig) {
#pragma unroll
    for (int i = 0; i < kM; ++i) u[i] = mul(x[i], 0.1f);
    if constexpr (kBody == kRk4Lin) {
      const float* p = c.p;
      boat::rk4([p](const float* a, const float* v, float* d) {
        f_lin(p, a, v, d);
      }, x, u, c.hh, c.h, c.h6, xo);
    } else if constexpr (kBody == kEuler) {   // x + 0.05 boat.f(x, u)
      float xd[kN];
      boat::f(c.p, x, u, xd);
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.05f, xd[i]));
    } else {                                  // fb's rows are boat.f's
      boat::rk4_f(c.p, x, u, c.hh, c.h, c.h6, xo);
    }
    return 1;
  } else {
    // the bodies that start from the erf
    float e[kN];
    boat::erf(tar, x, e);
    if constexpr (kBody == kErf) {
#pragma unroll
      for (int i = 0; i < kM; ++i) u[i] = e[i];
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, e[i]));
      return 1;
    }
    const bool arr = (kBody == kFull || kBody == kDbgFull) && arrived(e);
    matvec(K, e, u);
    if constexpr (kBody == kDbgMatvec) {
      // x + 0.001 * u.sum(axis=0): the 3-row sum in PyTorch's order
      const float su = add(add(u[0], u[1]), u[2]);
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, su));
      return 1;
    }
    if constexpr (kBody == kMatvec) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, e[i]));
      return 1;
    }
    boat::saturate(c.p, u);
    if constexpr (kBody == kSat) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xo[i] = add(x[i], mul(0.001f, e[i]));
      return 1;
    }
    float xn[kN];
    boat::rk4_f(c.p, x, u, c.hh, c.h, c.h6, xn);
    bool ok = true;
    if constexpr (kBody != kDyn) {
      ok = boat::circles_free(c.cs, c.ncirc, xn) && !arr;
      if constexpr (kBody == kDbgFull) {    // and not in the goal box
        float eg[kN];
        boat::erf(c.goal, xn, eg);
        bool hit = true;
#pragma unroll
        for (int i = 0; i < kN; ++i) hit = hit && fabsf(eg[i]) <= c.gbuf[i];
        ok = ok && !hit;
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) xo[i] = ok ? xn[i] : x[i];
    return kBody == kFull ? 1 : ok;   // F2 counts every step
  }
}

template <int kBody, bool kStore>
__global__ void stage_kernel(const float* __restrict__ x0,
                             const float* __restrict__ Kt,
                             const float* __restrict__ tart,
                             const float* __restrict__ params,
                             const float* __restrict__ circles, int ncirc,
                             const float* __restrict__ goal,
                             const float* __restrict__ gbuf,
                             float* __restrict__ xs, float* __restrict__ us,
                             int* __restrict__ length, int B, int H,
                             float hh, float h, float h6) {
  __shared__ float p[kParams];
  __shared__ float cs[3 * kMaxCircles];
  for (int i = threadIdx.x; i < kParams; i += blockDim.x) p[i] = params[i];
  for (int i = threadIdx.x; i < 3 * ncirc; i += blockDim.x) cs[i] = circles[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float x[kN], tar[kN], K[kM][kN], g[kN], gb[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    x[i] = x0[(size_t)i * B + b];
    tar[i] = tart[(size_t)i * B + b];
    g[i] = goal[i];
    gb[i] = gbuf[i];
  }
#pragma unroll
  for (int i = 0; i < kM; ++i)
#pragma unroll
    for (int j = 0; j < kN; ++j) K[i][j] = Kt[((size_t)i * kN + j) * B + b];
  const Ctx c{p, cs, ncirc, g, gb, hh, h, h6};
  int len = 0;
  for (int step = 0; step < H; ++step) {
    float xo[kN], u[kM];
    const int inc = body<kBody>(c, x, K, tar, xo, u);
    if (kStore) {
#pragma unroll
      for (int i = 0; i < kN; ++i) xs[((size_t)step * kN + i) * B + b] = xo[i];
      if (us != nullptr) {
#pragma unroll
        for (int i = 0; i < kM; ++i)
          us[((size_t)step * kM + i) * B + b] = u[i];
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) x[i] = xo[i];
    len += inc;
  }
  if (!kStore) {
#pragma unroll
    for (int i = 0; i < kN; ++i) xs[(size_t)i * B + b] = x[i];
    if (us != nullptr) {
#pragma unroll
      for (int i = 0; i < kM; ++i) us[(size_t)i * B + b] = mul(x[i], 0.0f);
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
// which store no u.  params: boat_params();
// circles (ncirc, 3); goal and gbuf (6,).  threads: candidates a block,
// at most 512 (the largest body takes 96 registers a thread).
extern "C" int lqrrt_steer_stage(
    const float* x0, const float* K, const float* tar, int stage,
    const float* params, const float* circles, int ncirc, const float* goal,
    const float* gbuf, float* xs, float* us, int* length, int B, int H,
    float hh, float h, float h6, int threads, void* stream) {
  if (ncirc < 0 || ncirc > kMaxCircles || threads < 32 || threads > 512 ||
      threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + threads - 1) / threads);
#define LQRRT_STAGE(ID, BODY, STORE)                                        \
  case ID:                                                                   \
    stage_kernel<BODY, STORE><<<grid, threads, 0, s>>>(                      \
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
