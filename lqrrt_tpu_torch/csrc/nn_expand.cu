// Expanded-form constant-metric nearest neighbour (kernel E): for each
// candidate b, the argmin over live rows j < size of
//
//   c_bj = psi_b . phi_j + k (P_j + Q_b) + 4pi^2 S_aa k^2,
//   k = rint((x_a,j - r_a,b) / 2pi),
//
// the constant-S metric of kernel A less the per-candidate |w_b|^2, which
// the merge pass adds back.  The depth-8 features phi_j = [|z_j|^2, -2 z_j,
// 0...] and psi_b = [1, w_b, 0...], and x_a, P, r_a, Q, S_aa, are prepared by
// the wrapper (ops/kernels/nn_hybrid.py), as the JAX side prepares them
// outside the pallas_call.
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
// epilogue of about 10 fp32 instructions (the wrap term, the index mask,
// the running minimum), against ~1.6 MB of features.  So it is bound by
// fp32 instruction issue on the CUDA cores, not by memory; the tensor cores
// can remove at most the cross term's 8 FMAs a pair.  Design:
// - a block holds 128 candidates, 16 a warp (the mma's M); a warp's psi
//   rows stay in registers (the mma's A fragment, or 16 floats for kFma)
//   for the whole scan;
// - the block stages one chunk of kChunk node rows in shared memory (bf16
//   hi/lo words, or fp32 rows padded to 12 floats for conflict-free float4
//   reads), then walks it in n8 tiles: each thread owns rows (g, g+8) and
//   columns (2t, 2t+1) of a 16x8 tile, the mma's accumulator layout, so the
//   epilogue is the same in every mode;
// - occupancy: 8192 candidates are only 64 blocks, so grid.y splits N into
//   chunks (80 at N = 40960, 4096 live blocks at size 32768); each block
//   writes one (cost, index) a candidate and chunk, and nn_expand_merge
//   folds the chunks in increasing order;
// - ties: each thread scans its columns in increasing j with a strict '<',
//   the four lanes of a row merge by (cost, index) and the chunks merge in
//   order with '<', so the lowest index wins (the root-pad rows copy row 0
//   and must lose to it);
// - dead rows are masked by index (j < size, read from device memory), and
//   a non-finite cost never wins and drops only its own row.
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 8;              // |z|^2 and at most 7 coordinates
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCands = kWarps * 16;    // candidates per block
constexpr int kChunk = 512;            // node rows per block; CHUNK in nn_hybrid.py
constexpr int kFmaStride = 12;         // floats per staged fp32 row
constexpr int kMergeThreads = 256;
constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kFourPiSq = 39.47841760435743f;

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

__device__ __forceinline__ int clamp_size(const int* size_ptr, int N) {
  const int size = *size_ptr;
  return size < 0 ? 0 : (size > N ? N : size);
}

template <int MODE, bool WRAP>
__global__ void __launch_bounds__(kThreads)
nn_expand_kernel(const float* __restrict__ phi,    // (N, 8)
                 const float* __restrict__ nodew,  // (N, 2): x_a, P
                 const float* __restrict__ psi,    // (B, 8)
                 const float* __restrict__ candw,  // (B, 2): r_a, Q
                 const float* __restrict__ saa_ptr,
                 const int* __restrict__ size_ptr,
                 float* __restrict__ part_cost,    // (gridDim.y, B)
                 int* __restrict__ part_id,
                 int N, int B) {
  constexpr bool kMma = MODE != kFma;
  // fp32 rows for kFma; bf16 hi / lo words (pairs of depth entries) else
  __shared__ __align__(16) float fma_s[kMma ? 4 : kChunk * kFmaStride];
  __shared__ __align__(16) uint32_t hi_s[kMma ? kChunk * 4 : 4];
  __shared__ __align__(16) uint32_t lo_s[MODE == kBf16x3 ? kChunk * 4 : 4];
  __shared__ __align__(8) float xa_s[WRAP ? kChunk : 2];
  __shared__ __align__(8) float p_s[WRAP ? kChunk : 2];

  const int size = clamp_size(size_ptr, N);
  const int j0 = blockIdx.y * kChunk;
  if (j0 >= size) return;              // the whole block: a dead chunk
  const int rows = min(kChunk, size - j0);

  // stage the chunk; rows past size are zeros (masked by index below)
  for (int r = threadIdx.x; r < kChunk; r += kThreads) {
    float4 u = make_float4(0.f, 0.f, 0.f, 0.f), v = u;
    if (r < rows) {
      const float4* src = reinterpret_cast<const float4*>(phi) +
                          (size_t)(j0 + r) * 2;
      u = src[0];
      v = src[1];
    }
    if constexpr (kMma) {
      const float f[kDepth] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
      uint32_t h[kDepth], l[kDepth];
#pragma unroll
      for (int d = 0; d < kDepth; ++d) split(f[d], h[d], l[d]);
      reinterpret_cast<uint4*>(hi_s)[r] =
          make_uint4(pack(h[0], h[1]), pack(h[2], h[3]), pack(h[4], h[5]),
                     pack(h[6], h[7]));
      if constexpr (MODE == kBf16x3)
        reinterpret_cast<uint4*>(lo_s)[r] =
            make_uint4(pack(l[0], l[1]), pack(l[2], l[3]), pack(l[4], l[5]),
                       pack(l[6], l[7]));
    } else {
      float4* dst = reinterpret_cast<float4*>(fma_s + r * kFmaStride);
      dst[0] = u;
      dst[1] = v;
    }
    if constexpr (WRAP) {
      float2 xw = make_float2(0.f, 0.f);
      if (r < rows)
        xw = reinterpret_cast<const float2*>(nodew)[j0 + r];
      xa_s[r] = xw.x;
      p_s[r] = xw.y;
    }
  }

  // this thread's candidate rows g and g + 8 of its warp's 16
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = (int)(blockIdx.x * kCands + (threadIdx.x >> 5) * 16) + g;
  const int row[2] = {row0, row0 + 8};
  float pf[2][kDepth];                 // kFma: psi rows
  uint32_t a[4] = {0u, 0u, 0u, 0u};    // mma A: hi of rows g, g+8; lo of both
  float ra[2] = {0.f, 0.f}, qb[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool valid = row[i] < B;
    const float* src = psi + (size_t)(valid ? row[i] : 0) * kDepth;
#pragma unroll
    for (int d = 0; d < kDepth; ++d) pf[i][d] = valid ? src[d] : 0.f;
    if constexpr (kMma) {
      uint32_t h0, l0, h1, l1;
      split(pf[i][2 * t], h0, l0);
      split(pf[i][2 * t + 1], h1, l1);
      a[i] = pack(h0, h1);
      if constexpr (MODE == kBf16x3) a[2 + i] = pack(l0, l1);
    }
    if constexpr (WRAP) {
      if (valid) {
        ra[i] = candw[(size_t)row[i] * 2];
        qb[i] = candw[(size_t)row[i] * 2 + 1];
      }
    }
  }
  const float saa4 = WRAP ? kFourPiSq * *saa_ptr : 0.f;
  __syncthreads();

  float best[2] = {CUDART_INF_F, CUDART_INF_F};
  int best_id[2] = {0, 0};
  const int ntiles = (rows + 7) / 8;
  for (int tile = 0; tile < ntiles; ++tile) {
    const int base = tile * 8;
    float c[2][2];                     // [row g, g+8][column 2t, 2t+1]
    if constexpr (kMma) {
      const uint32_t bh = hi_s[(base + g) * 4 + t];   // node base+g, k 2t..
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      if constexpr (MODE == kBf16) {
        mma_bf16(d, a, bh, 0u);
      } else {
        const uint32_t bl = lo_s[(base + g) * 4 + t];
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(x, a, bl, bh);        // hl + lh
        mma_bf16(d, a, bh, 0u);        // hh
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
            fma_s + (base + 2 * t + e) * kFmaStride);
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
      const float2 x2 = *reinterpret_cast<const float2*>(xa_s + base + 2 * t);
      const float2 p2 = *reinterpret_cast<const float2*>(p_s + base + 2 * t);
      xa[0] = x2.x;
      xa[1] = x2.y;
      pj[0] = p2.x;
      pj[1] = p2.y;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int jl = base + 2 * t + e;
      if (jl >= rows) continue;        // past size
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float v = c[i][e];
        if constexpr (WRAP) {
          const float k = rintf((xa[e] - ra[i]) * kInvTwoPi);
          v = v + k * (pj[e] + qb[i]) + saa4 * (k * k);
        }
        // NaN and -inf fail one of the two tests: never win
        if (v < best[i] && v > -CUDART_INF_F) {
          best[i] = v;
          best_id[i] = j0 + jl;
        }
      }
    }
  }

  // the four lanes of a row hold columns 2t, 2t+1 of every tile: merge by
  // (cost, index)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float oc = __shfl_xor_sync(0xffffffffu, best[i], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_id[i], off);
      if (oc < best[i] || (oc == best[i] && oi < best_id[i])) {
        best[i] = oc;
        best_id[i] = oi;
      }
    }
    if (t == 0 && row[i] < B) {
      part_cost[(size_t)blockIdx.y * B + row[i]] = best[i];
      part_id[(size_t)blockIdx.y * B + row[i]] = best_id[i];
    }
  }
}

// fold the live chunks' minima in chunk order ('<': the lower index wins a
// tie) and add |w_b|^2
__global__ void nn_expand_merge(const float* __restrict__ part_cost,
                                const int* __restrict__ part_id,
                                const int* __restrict__ size_ptr,
                                const float* __restrict__ w2,
                                int* __restrict__ ids,
                                float* __restrict__ cost, int N, int B) {
  const int b = blockIdx.x * kMergeThreads + threadIdx.x;
  if (b >= B) return;
  const int live = (clamp_size(size_ptr, N) + kChunk - 1) / kChunk;
  float best = CUDART_INF_F;
  int best_id = 0;
  for (int s = 0; s < live; ++s) {
    const float c = part_cost[(size_t)s * B + b];
    if (c < best) {
      best = c;
      best_id = part_id[(size_t)s * B + b];
    }
  }
  ids[b] = best_id;
  cost[b] = best + w2[b];
}

}  // namespace

#define LQRRT_NN_EXPAND_CASE(MODE, WRAP)                                     \
  nn_expand_kernel<MODE, WRAP><<<grid, kThreads, 0, s>>>(                    \
      phi, nodew, psi, candw, saa, size, part_cost, part_id, N, B)

extern "C" int lqrrt_nn_expand(const float* phi, const float* nodew,
                               const float* psi, const float* candw,
                               const float* saa, const int* size,
                               const float* w2, float* part_cost,
                               int* part_id, int* ids, float* cost, int N,
                               int B, int mode, int wrapped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 0 || B <= 0 || mode < kFma || mode > kBf16x3)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N > 0) {
    const dim3 grid((B + kCands - 1) / kCands, (N + kChunk - 1) / kChunk);
    switch (mode * 2 + (wrapped ? 1 : 0)) {
      case 0: LQRRT_NN_EXPAND_CASE(kFma, false); break;
      case 1: LQRRT_NN_EXPAND_CASE(kFma, true); break;
      case 2: LQRRT_NN_EXPAND_CASE(kBf16, false); break;
      case 3: LQRRT_NN_EXPAND_CASE(kBf16, true); break;
      case 4: LQRRT_NN_EXPAND_CASE(kBf16x3, false); break;
      default: LQRRT_NN_EXPAND_CASE(kBf16x3, true); break;
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  nn_expand_merge<<<(B + kMergeThreads - 1) / kMergeThreads, kMergeThreads, 0,
                    s>>>(part_cost, part_id, size, w2, ids, cost, N, B);
  return static_cast<int>(cudaGetLastError());
}
