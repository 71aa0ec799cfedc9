// Device helpers shared by the nearest-neighbour kernels (nn_const.cu,
// nn_expand.cu, nn_general.cu): compile-time unrolling, the mbarrier and
// 1-D bulk-copy (cp.async.bulk) primitives of their staging rings, the
// 64-bit (cost, row) merge key, the block's row range, the in-block
// Cholesky and whitening of the constant-metric kernels (A, E), and the
// last-block
// hand-off that turns the merged keys into (ids, cost) inside the launch.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <utility>

namespace lqrrt_nn {

constexpr float kInvTwoPi = 0.15915494309189535f;
constexpr float kTwoPi = 6.283185307179586f;
// 1.5 * 2^23: (v + kRound) - kRound is v rounded to the nearest integer
// (ties to even) for |v| < 2^22, in two fp32 adds instead of the
// quarter-rate FRND; ops/kernels/nn_kernel.py ``_rint`` is the same
constexpr float kRound = 12582912.0f;
// pack_key(+inf, 0): no live row yet; EMPTY_KEY in nn_kernel.py
constexpr unsigned long long kEmptyKey = 0x7F80000000000000ull;

template <class Fn, int... Fs>
__device__ __forceinline__ void unroll_seq(Fn& fn,
                                           std::integer_sequence<int, Fs...>) {
  (fn(std::integral_constant<int, Fs>{}), ...);
}

// fn(std::integral_constant<int, f>) for f = 0 .. N-1, in order
template <int N, class Fn>
__device__ __forceinline__ void unroll(Fn&& fn) {
  unroll_seq(fn, std::make_integer_sequence<int, N>{});
}

template <int K>
__device__ __forceinline__ float lane(const float4& v) {
  if constexpr (K == 0) return v.x;
  else if constexpr (K == 1) return v.y;
  else if constexpr (K == 2) return v.z;
  else return v.w;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

// one 1-D bulk copy global -> shared, completing on ``bar``; bytes and
// both addresses are multiples of 16
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// order the threads' reads of a slot (generic proxy) before the bulk copy
// (async proxy) that overwrites it
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// (order-preserving int32 of cost + 0.0f) << 32 | id: signed 64-bit order
// is (cost, id) order; -0.0 and +0.0 tie, as floats do
__device__ __forceinline__ long long pack_key(float cost, int id) {
  const int bits = __float_as_int(__fadd_rn(cost, 0.0f));
  const int ord = bits ^ ((bits >> 31) & 0x7fffffff);
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<uint32_t>(ord)) << 32) |
      static_cast<uint32_t>(id));
}

// the inverse of pack_key: (id, cost)
__device__ __forceinline__ void unpack_key(long long key, int& id,
                                           float& cost) {
  id = static_cast<int>(static_cast<uint32_t>(key));
  const int ord = static_cast<int>(key >> 32);
  cost = __int_as_float(ord ^ ((ord >> 31) & 0x7fffffff));
}

// state dim of whitened coordinate i: the wrapped dim a first when a >= 0
// (then c = 2pi L[0, :] has its one nonzero at 0), else the identity
__device__ __forceinline__ int perm_dim(int i, int a) {
  return a < 0 ? i : (i == 0 ? a : (i <= a ? i - 1 : i));
}

// whitened z = xc L of one raw state row, read through ``at(p)`` for
// state dims p < n: xc_i = x[p_i] - ctr[p_i] with p_i = perm_dim(i, a)
// (zero for i >= n), z_k = sum_{i >= k} xc_i L[i][k], L lower and
// row-major with leading dim LD (zero past n); the centring in fp32, the
// sum in fp64 and rounded once, as the plain versions' (so that kernel E
// rounds the same fp32 features to bf16 as its prep)
template <int NS, int LD, class At>
__device__ __forceinline__ void whiten(At at, int n,
                                       const float* __restrict__ L,
                                       const float* __restrict__ ctr, int a,
                                       float (&xc)[NS], float (&z)[NS]) {
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int p = perm_dim(i, a);
    xc[i] = i < n ? at(p) - ctr[p] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    double s = static_cast<double>(xc[k]) * L[k * LD + k];
#pragma unroll
    for (int i = k + 1; i < NS; ++i)
      s = fma(static_cast<double>(xc[i]), static_cast<double>(L[i * LD + k]),
              s);
    z[k] = static_cast<float>(s);
  }
}

// 1 / sqrt(s) in fp64: the fp32 estimate and two Newton steps, so no call
// to the slow path of IEEE division or square root (ptxas counts such a
// call's saved registers as spills); NaN for s <= 0
__device__ __forceinline__ double rsqrt64(double s) {
  double r = rsqrtf(static_cast<float>(s));
  r = r * (1.5 - 0.5 * s * r * r);
  return r * (1.5 - 0.5 * s * r * r);
}

// L = cholesky(S[p][:, p] + 1e-9 I) (p = perm_dim(., a); the jitter added
// in fp32), factored in fp64 in ``W`` and rounded once to fp32 into ``L``:
// both lower, row-major with leading dim ld >= n, zero elsewhere in their
// ld x ld; called by one whole warp (n <= ld <= 32).  Lane i owns row i;
// column j takes j FMAs, a shuffle and one rsqrt64.  The fp64 factor
// agrees with LAPACK's to a few fp64 ulps, so the rounded L is the plain
// version's (``whitening`` in ops/kernels/nn_kernel.py) but where an entry
// lies within those ulps of an fp32 rounding boundary.  A matrix that is
// not positive definite gives NaN rows, and then NaN costs, which never
// win.
__device__ __forceinline__ void warp_cholesky(const float* __restrict__ S,
                                              int n, int a, double* W,
                                              float* L, int ld) {
  const int i = threadIdx.x & 31;
  if (i < ld)
    for (int k = 0; k < ld; ++k) W[i * ld + k] = 0.0;
  __syncwarp();
  const int pi = i < n ? perm_dim(i, a) : 0;
  for (int j = 0; j < n; ++j) {
    double s = 0.0;
    if (i >= j && i < n) {
      float sij = __ldg(S + pi * n + perm_dim(j, a));
      if (i == j) sij += 1e-9f;
      s = sij;
      for (int k = 0; k < j; ++k) s = fma(-W[i * ld + k], W[j * ld + k], s);
    }
    // s_ij / sqrt(s_jj); sqrt(s_jj) itself on the diagonal
    const double r = rsqrt64(__shfl_sync(0xffffffffu, s, j));
    if (i >= j && i < n) W[i * ld + j] = s * r;
    __syncwarp();
  }
  if (i < ld)
    for (int k = 0; k < ld; ++k)
      L[i * ld + k] = static_cast<float>(W[i * ld + k]);
}

// true in the one block of the grid that finishes last, after every block
// has merged its keys: then all atomicMin merges into keys are visible to
// it.  ``counter`` is the keys buffer's slot past the last candidate,
// filled with kEmptyKey by the wrapper with the keys, and counted up once
// a block.  Every thread of every block calls it.
__device__ __forceinline__ bool last_block(long long* counter) {
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long total =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    const unsigned long long old = atomicAdd(
        reinterpret_cast<unsigned long long*>(counter), 1ull);
    s_last = old == kEmptyKey + total - 1;
  }
  __syncthreads();
  if (s_last) __threadfence();
  return s_last;
}

// SMs x resident blocks of ``kernel`` on the current device, asked of the
// runtime once a device (the launch is on the planner's hot path)
template <class Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, int (&cache)[64]) {
  int device = 0;
  cudaGetDevice(&device);
  const bool keep = device >= 0 && device < 64;
  if (keep && cache[device] > 0) return cache[device];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (keep) cache[device] = blocks;
  return blocks;
}

// node partitions of a (candidate tiles) x (partitions) grid: as many as
// fill the SMs in one wave, at most one a tile of rows
__host__ __forceinline__ int node_parts(int resident, int cand_tiles, int N,
                                        int tile_rows) {
  int parts = resident / cand_tiles;
  const int max_parts = (N + tile_rows - 1) / tile_rows;
  parts = parts < 1 ? 1 : (parts > max_parts ? max_parts : parts);
  return parts > 65535 ? 65535 : parts;
}

// [lo, hi): this block's slice of the live rows [0, size), in steps of 4
// rows (16-byte aligned bulk copies of fp32 rows)
__device__ __forceinline__ void block_rows(const int* size_ptr, int N,
                                           int& lo, int& hi) {
  int size = __ldg(size_ptr);
  size = size < 0 ? 0 : (size > N ? N : size);
  const int parts = gridDim.y;
  const int per = ((size + parts - 1) / parts + 3) / 4 * 4;
  lo = blockIdx.y * per;
  hi = min(lo + per, size);
}

}  // namespace lqrrt_nn
