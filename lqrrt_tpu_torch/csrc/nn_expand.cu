// Expanded-form constant-metric nearest neighbour (kernel E): for each
// candidate b, the argmin over live rows j < size of
//
//   c_bj = psi_b . phi_j + k (P_j + Q_b) + 4pi^2 S_aa k^2,
//   k = rint(x'_a,j - r'_a,b),   x'_a = x_a / 2pi,  r'_a = r_a / 2pi,
//
// the constant-S metric of kernel A less the per-candidate |w_b|^2, which
// is added back when the keys are unpacked.  The depth-8 features
// phi_j = [|z_j|^2, -2 z_j, 0...] and psi_b = [1, w_b, 0...] come from the
// tool's prep: L = cholesky(S + 1e-9 I), centring on the candidate mean (the
// wrapped dim a uncentred), z = x_c L, w = r_c L; P_j = -4pi (S x_c,j)_a and
// Q_b = +4pi (S r_c,b)_a.  The kernel builds them itself (below), and
// ops/kernels/nn_hybrid.py ``expand_prep`` builds the same in plain PyTorch.
//
// Replaces: tools/exp_nn_hybrid_v5.py, nearest_const_hybrid (:82, body
// _hybrid_kernel :46), nearest_const_exp (:214, body _exp_kernel :178) and
// nearest_const_split3 (:341, body _split3_kernel :296).  They differ only
// in how the cross term psi . phi is taken, which is this kernel's MODE:
//   kFma    fp32 FMAs on the CUDA cores (exp, and hybrid "highest": a
//           3xTF32 pass would cost three tensor-core products plus the
//           splits of both operands to approach what 8 FMAs give exactly,
//           so "highest" stays on FMAs);
//   kBf16   one mma.sync m16n8k16 bf16 pass, fp32 accumulators (hybrid
//           "default"): both operands rounded to bf16, depth 8 padded to 16;
//   kBf16x3 the hi/lo split of both operands (hi as the tool's split, lo
//           rounded to bf16) as two m16n8k16 passes, [psi_h | psi_l] times
//           [phi_l ; phi_h] (hl + lh) and times [phi_h ; 0] (hh), summed
//           hh + (hl + lh) (split3, and hybrid "high").
//
// Bound: B * size pairs -- 2.7e8 at B = 8192, size = 32768 -- each needing
// the cross term (8 FMAs, or a 1/16 share of an m16n8k16 product) and an
// epilogue of about 10 fp32 instructions (the turn, the wrap term, the
// index mask, the running minimum), against ~1 MB of states.  So it is
// bound by fp32 instruction issue on the CUDA cores, not by memory; the
// tensor cores can remove at most the cross term's 8 FMAs a pair.  Design:
// - a block holds 128 candidates, 16 a warp (the mma's M); a warp's psi
//   rows stay in registers (the mma's A fragment, or 16 floats for kFma)
//   for the whole scan;
// - grid (candidate tiles) x (node partitions), one wave of blocks, each
//   scanning its slice of [0, size) (derived from ``*size`` on the device)
//   in tiles of kTileRows rows: a ring of raw state tiles filled by 1-D
//   bulk copies (cp.async.bulk) on mbarriers, each tile turned once by the
//   block into the mode's features (bf16 hi/lo words, or fp32 rows padded
//   to 12 floats for conflict-free float4 reads) in one of two buffers, so
//   copies and feature building overlap the scan; one __syncthreads a tile;
// - the prep is in the block: warp 0 factors S (n <= 7), each thread builds
//   its candidates' psi, Q and r'_a, and each tile's rows get phi, P, x'_a
//   as they are staged; the wrapper launches only the candidate mean, the
//   fill of the keys and this kernel;
// - the scan walks a tile in n8 steps: each thread owns rows (g, g+8) and
//   columns (2t, 2t+1) of a 16x8 tile, the mma's accumulator layout, so the
//   epilogue is the same in every mode;
// - ties and the merge: each thread scans its columns in increasing j with
//   a strict '<'; the four lanes of a row and then the blocks merge on
//   pack_key's (c, j) keys (a shuffle minimum, then one 64-bit atomicMin a
//   candidate), so the lowest index wins a tie as in the sequential scan
//   (the root-pad rows copy row 0 and must lose to it); the block that
//   finishes last unpacks the keys and adds |w_b|^2, which the blocks of
//   the first node partition left in ``cost`` as they whitened their
//   candidates, so there are no partial buffers and no second launch;
// - dead rows are masked by index (j < size, read from device memory), and
//   a non-finite cost never wins and drops only its own row.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "nn_common.cuh"

namespace {

using namespace lqrrt_nn;

constexpr int kDepth = 8;              // |z|^2 and at most 7 coordinates
constexpr int kMaxN = kDepth - 1;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCands = kWarps * 16;    // candidates per block
constexpr int kTileRows = 256;         // rows a tile; a multiple of 8
constexpr int kStages = 2;             // raw tiles in flight
constexpr int kFmaStride = 12;         // floats per staged fp32 row
constexpr float kFourPiSq = 39.47841760435743f;
constexpr float kFourPi = 12.566370614359172f;

enum Mode { kFma = 0, kBf16 = 1, kBf16x3 = 2 };

// bf16 bits of a, rounded to nearest even: the tool's split (its hi)
__device__ __forceinline__ uint32_t bf16_bits(float a) {
  const uint32_t u = __float_as_uint(a);
  return ((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u) >> 16;
}

// a's hi and lo bf16 halves: hi = split(a), lo = bf16(a - hi)
__device__ __forceinline__ void split(float a, uint32_t& hi, uint32_t& lo) {
  hi = bf16_bits(a);
  lo = bf16_bits(a - __uint_as_float(hi << 16));
}

// two bf16 values in one register, the lower k index in the low half
__device__ __forceinline__ uint32_t pack(uint32_t k0, uint32_t k1) {
  return k0 | (k1 << 16);
}

// d += A (16x16 bf16, row) * B (16x8 bf16, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// sum_i xc_i sa_i, in order of i (sa zero past n)
__device__ __forceinline__ float dot_a(const float (&xc)[kMaxN],
                                       const float* __restrict__ sa) {
  float s = xc[0] * sa[0];
#pragma unroll
  for (int i = 1; i < kMaxN; ++i) s = fmaf(xc[i], sa[i], s);
  return s;
}

// |z|^2 in fp64, rounded once, as the plain version's
__device__ __forceinline__ float norm2(const float (&z)[kMaxN]) {
  double s = static_cast<double>(z[0]) * z[0];
#pragma unroll
  for (int k = 1; k < kMaxN; ++k)
    s = fma(static_cast<double>(z[k]), static_cast<double>(z[k]), s);
  return static_cast<float>(s);
}

// two blocks an SM: without the bound, ptxas keeps the bf16x3 unwrapped
// instance at 80 registers and spills 8 bytes
template <int MODE, bool WRAP>
__global__ void __launch_bounds__(kThreads, 2)
nn_expand_kernel(const float* __restrict__ states,  // (N, n)
                 const float* __restrict__ xr,      // (B, n)
                 const float* __restrict__ S,       // (n, n)
                 const float* __restrict__ center,  // (n,) candidate mean
                 const int* __restrict__ size_ptr,
                 long long* __restrict__ keys,      // (B + 1,) kEmptyKey
                 int* __restrict__ ids, float* __restrict__ cost, int N,
                 int B, int n, int a) {
  constexpr bool kMma = MODE != kFma;
  constexpr int kBuf = 2;              // feature tiles: built / scanned
  __shared__ __align__(128) float raw_s[kStages][kTileRows * kMaxN];
  // fp32 rows for kFma; bf16 hi / lo words (pairs of depth entries) else
  __shared__ __align__(16)
      float fma_s[kMma ? 4 : kBuf * kTileRows * kFmaStride];
  __shared__ __align__(16) uint32_t hi_s[kMma ? kBuf * kTileRows * 4 : 4];
  __shared__ __align__(16) uint32_t lo_s[MODE == kBf16x3 ? kBuf * kTileRows * 4
                                                         : 4];
  __shared__ __align__(8) float xa_s[WRAP ? kBuf * kTileRows : 2];
  __shared__ __align__(8) float p_s[WRAP ? kBuf * kTileRows : 2];
  __shared__ double W_s[kDepth * kDepth];
  __shared__ float L_s[kDepth * kDepth];
  __shared__ float ctr_s[kDepth], sa_s[kDepth];
  __shared__ __align__(8) uint64_t full[kStages];
  if (!WRAP) a = -1;

  int lo, hi;
  block_rows(size_ptr, N, lo, hi);
  const int n_tiles = lo < hi ? (hi - lo + kTileRows - 1) / kTileRows : 0;

  auto fetch = [&](int t) {
    const int r0 = lo + t * kTileRows;
    const int nr = min(kTileRows, hi - r0);
    const uint32_t bytes = static_cast<uint32_t>(nr * n * 4) & ~15u;
    uint64_t* bar = full + t % kStages;
    mbar_expect_tx(bar, bytes);
    if (bytes > 0)
      bulk_load(raw_s[t % kStages], states + static_cast<size_t>(r0) * n,
                bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  if (threadIdx.x < 32) {
    warp_cholesky(S, n, -1, W_s, L_s, kDepth);
  } else if (threadIdx.x < 32 + kDepth) {
    const int k = threadIdx.x - 32;   // angles stay uncentred
    ctr_s[k] = k < n && k != a ? center[k] : 0.f;
    sa_s[k] = WRAP && k < n ? __ldg(S + a * n + k) : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kStages && t < n_tiles; ++t) fetch(t);

  // this thread's candidate rows g and g + 8 of its warp's 16
  const int lane_id = threadIdx.x & 31;
  const int g = lane_id >> 2, t4 = lane_id & 3;
  const int row0 = (int)(blockIdx.x * kCands + (threadIdx.x >> 5) * 16) + g;
  const int row[2] = {row0, row0 + 8};
  float pf[2][kDepth];                 // kFma: psi rows
  uint32_t af[4] = {0u, 0u, 0u, 0u};   // mma A: hi of rows g, g+8; lo of both
  float ra[2] = {0.f, 0.f}, qb[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = row[i] < B;
    const float* r = xr + static_cast<size_t>(valid ? row[i] : 0) * n;
    float xc[kMaxN], w[kMaxN];
    whiten<kMaxN, kDepth>([&](int p) { return valid ? __ldg(r + p) : 0.f; },
                          n, L_s, ctr_s, -1, xc, w);
    pf[i][0] = valid ? 1.f : 0.f;
#pragma unroll
    for (int d = 1; d < kDepth; ++d) pf[i][d] = w[d - 1];
    // |w_b|^2 into cost, once a candidate (the tile's first node
    // partition), for the last block to add to the merged c
    if (valid && blockIdx.y == 0 && t4 == 0) cost[row[i]] = norm2(w);
    if constexpr (kMma) {
      uint32_t h0, l0, h1, l1;
      float e0 = pf[i][0], e1 = pf[i][1];
#pragma unroll
      for (int q = 1; q < 4; ++q)     // the pair (2 t4, 2 t4 + 1), unrolled
        if (t4 == q) e0 = pf[i][2 * q], e1 = pf[i][2 * q + 1];
      split(e0, h0, l0);
      split(e1, h1, l1);
      af[i] = pack(h0, h1);
      if constexpr (MODE == kBf16x3) af[2 + i] = pack(l0, l1);
    }
    if constexpr (WRAP) {
      if (valid) {
        ra[i] = __ldg(r + a) * kInvTwoPi;
        qb[i] = kFourPi * dot_a(xc, sa_s);
      }
    }
  }
  const float saa4 = WRAP ? kFourPiSq * sa_s[a] : 0.f;

  float best[2] = {CUDART_INF_F, CUDART_INF_F};
  int best_id[2] = {0, 0};
  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % kStages;
    mbar_wait(full + slot, (t / kStages) & 1);
    const int r0 = lo + t * kTileRows;
    const int nr = min(kTileRows, hi - r0);
    const int buf = t & 1;
    const float* rt = raw_s[slot];
    const int in_smem = (nr * n) & ~3;   // floats the bulk copy moved
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      const float* gr = states + static_cast<size_t>(r0 + r) * n;
      auto at = [&](int p) {
        return r * n + p < in_smem ? rt[r * n + p] : __ldg(gr + p);
      };
      float xc[kMaxN], z[kMaxN];
      whiten<kMaxN, kDepth>(at, n, L_s, ctr_s, -1, xc, z);
      const float f[kDepth] = {norm2(z),   -2.f * z[0], -2.f * z[1],
                               -2.f * z[2], -2.f * z[3], -2.f * z[4],
                               -2.f * z[5], -2.f * z[6]};
      const int at_row = buf * kTileRows + r;
      if constexpr (kMma) {
        uint32_t h[kDepth], l[kDepth];
#pragma unroll
        for (int d = 0; d < kDepth; ++d) split(f[d], h[d], l[d]);
        reinterpret_cast<uint4*>(hi_s)[at_row] =
            make_uint4(pack(h[0], h[1]), pack(h[2], h[3]), pack(h[4], h[5]),
                       pack(h[6], h[7]));
        if constexpr (MODE == kBf16x3)
          reinterpret_cast<uint4*>(lo_s)[at_row] =
              make_uint4(pack(l[0], l[1]), pack(l[2], l[3]),
                         pack(l[4], l[5]), pack(l[6], l[7]));
      } else {
        float4* dst = reinterpret_cast<float4*>(fma_s + at_row * kFmaStride);
        dst[0] = make_float4(f[0], f[1], f[2], f[3]);
        dst[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
      if constexpr (WRAP) {
        xa_s[at_row] = at(a) * kInvTwoPi;
        p_s[at_row] = -kFourPi * dot_a(xc, sa_s);
      }
    }
    __syncthreads();   // the tile's features are built; slot is free
    if (threadIdx.x == 0 && t + kStages < n_tiles) {
      fence_proxy_async();
      fetch(t + kStages);
    }

    const int ntiles8 = (nr + 7) / 8;
    for (int tile = 0; tile < ntiles8; ++tile) {
      const int base = tile * 8;
      const int brow = buf * kTileRows + base;
      float c[2][2];                   // [row g, g+8][column 2t, 2t+1]
      if constexpr (kMma) {
        const uint32_t bh = hi_s[(brow + g) * 4 + t4];  // node base+g, k 2t..
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        if constexpr (MODE == kBf16) {
          mma_bf16(d, af, bh, 0u);
        } else {
          const uint32_t bl = lo_s[(brow + g) * 4 + t4];
          float x[4] = {0.f, 0.f, 0.f, 0.f};
          mma_bf16(x, af, bl, bh);      // hl + lh
          mma_bf16(d, af, bh, 0u);      // hh
#pragma unroll
          for (int q = 0; q < 4; ++q) d[q] += x[q];
        }
        c[0][0] = d[0];
        c[0][1] = d[1];
        c[1][0] = d[2];
        c[1][1] = d[3];
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float4* f = reinterpret_cast<const float4*>(
              fma_s + (brow + 2 * t4 + e) * kFmaStride);
          const float4 u = f[0], v = f[1];
          const float ph[kDepth] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            float acc = pf[i][0] * ph[0];
#pragma unroll
            for (int d = 1; d < kDepth; ++d) acc = fmaf(pf[i][d], ph[d], acc);
            c[i][e] = acc;
          }
        }
      }
      float xa[2] = {0.f, 0.f}, pj[2] = {0.f, 0.f};
      if constexpr (WRAP) {
        const int col = brow + 2 * t4;
        const float2 x2 = *reinterpret_cast<const float2*>(xa_s + col);
        const float2 p2 = *reinterpret_cast<const float2*>(p_s + col);
        xa[0] = x2.x;
        xa[1] = x2.y;
        pj[0] = p2.x;
        pj[1] = p2.y;
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int jl = base + 2 * t4 + e;
        if (jl >= nr) continue;        // past the tile's rows
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = c[i][e];
          if constexpr (WRAP) {
            const float k = (xa[e] - ra[i] + kRound) - kRound;
            v = v + k * (pj[e] + qb[i]) + saa4 * (k * k);
          }
          // NaN and -inf fail one of the two tests: never win
          if (v < best[i] && v > -CUDART_INF_F) {
            best[i] = v;
            best_id[i] = r0 + jl;
          }
        }
      }
    }
  }

  // the four lanes of a row hold columns 2t, 2t+1 of every tile: merge
  // their keys, then the blocks'
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    long long key = best[i] < CUDART_INF_F ? pack_key(best[i], best_id[i])
                                           : static_cast<long long>(kEmptyKey);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const long long o = __shfl_xor_sync(0xffffffffu, key, off);
      key = o < key ? o : key;
    }
    if (t4 == 0 && row[i] < B && key != static_cast<long long>(kEmptyKey))
      atomicMin(keys + row[i], key);
  }
  if (last_block(keys + B)) {
    for (int b = threadIdx.x; b < B; b += kThreads) {
      int id;
      float c;
      unpack_key(__ldcg(keys + b), id, c);
      ids[b] = id;
      cost[b] = c + __ldcg(cost + b);
    }
  }
}

template <int MODE, bool WRAP>
int launch(const float* states, const float* xr, const float* S,
           const float* center, const int* size, long long* keys, int* ids,
           float* cost, int N, int B, int n, int a, cudaStream_t s) {
  static int cache[64] = {};
  const int cand_tiles = (B + kCands - 1) / kCands;
  const int parts = node_parts(
      resident_blocks(nn_expand_kernel<MODE, WRAP>, kThreads, 0, cache),
      cand_tiles, N, kTileRows);
  const dim3 grid(cand_tiles, parts);
  nn_expand_kernel<MODE, WRAP><<<grid, kThreads, 0, s>>>(
      states, xr, S, center, size, keys, ids, cost, N, B, n, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LQRRT_NN_EXPAND_CASE(MODE, WRAP)                                    \
  return launch<MODE, WRAP>(states, xr, S, center, size, keys, ids, cost, \
                            N, B, n, a, s)

// states (N, n) and xr (B, n) raw, 16-byte aligned, n <= 7; S (n, n);
// center (n,) the candidates' mean; keys (B + 1,) filled with
// pack_key(+inf, 0); ids, cost (B,) written by the launch; a the wrapped
// dim or -1
extern "C" int lqrrt_nn_expand(const float* states, const float* xr,
                               const float* S, const float* center,
                               const int* size, long long* keys, int* ids,
                               float* cost, int N, int B, int n, int mode,
                               int a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || B < 1 || n < 1 || n > kMaxN || a >= n || mode < kFma ||
      mode > kBf16x3)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (mode * 2 + (a >= 0 ? 1 : 0)) {
    case 0: LQRRT_NN_EXPAND_CASE(kFma, false);
    case 1: LQRRT_NN_EXPAND_CASE(kFma, true);
    case 2: LQRRT_NN_EXPAND_CASE(kBf16, false);
    case 3: LQRRT_NN_EXPAND_CASE(kBf16, true);
    case 4: LQRRT_NN_EXPAND_CASE(kBf16x3, false);
    default: LQRRT_NN_EXPAND_CASE(kBf16x3, true);
  }
}
