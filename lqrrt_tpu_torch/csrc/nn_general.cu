// General-metric nearest neighbour: for each candidate b, the argmin over
// live rows j < size of e' S_j e, e = x_j - r_b, with a per-node S_j.
//
// Replaces: lqrrt_tpu/ops/pallas/nn_kernel.py, nearest_pallas and its body
// _nn_kernel.  The Pallas kernel expanded e' S_j e into bilinear features
// (1 + n + n^2 lanes) so that the (B x N) cost matrix became one MXU matmul;
// the expansion cancels for near nodes (hence Precision.HIGHEST and the
// centring) and its wrap correction assumed a symmetric S.  This kernel
// evaluates the metric directly in fp32 FMAs on the CUDA cores: TF32 would
// lose the argmin.
//
// Input, folded by the wrapper in plain PyTorch (``nn_general_fold``), as
// the JAX kernel builds its node features outside the pallas_call: one
// packed row a node, [x_j (n), U_j (n(n+1)/2), zero pad to a multiple of 4
// floats], with U_j the upper triangle of S_j's symmetric part (U_ii = S_ii,
// U_ik = S_ik + S_ki for i < k, row-major) and the state dims permuted so
// that the wrapped dim comes first.  Then e' S_j e = sum_i e_i t_i with
// t_i = sum_{k >= i} U_ik e_k: exact algebra for any S, n(n+1)/2 + n FMAs a
// pair (90 at n = 12) against n^2 + n for the full S_j.
//
// Bound: B * size pairs of 196 fp32 flops at n = 12 (n sub, the wrap, the
// folded form counted as in chip_smoke.py): 0.785 ms at B = 8192, size
// 32768 on the H100's 67 TFLOP/s (data sheet, 700 W).  It is bound by the
// instruction rate: every FMA, every shared load and every compare takes
// one of the SM's four instruction slots a cycle.  Design:
// - Grid (candidate tiles) x (node partitions), sized so that the blocks
//   fill the SMs in one wave; each block derives its row range, a slice of
//   [0, size), from ``*size`` on the device.
// - Register blocking: a thread holds kCands candidates (r, e, t in
//   registers), so each broadcast 16-byte shared load of a packed row feeds
//   4 * kCands FMAs.
// - Asynchronous staging: a ring of kStages tiles in dynamic shared memory,
//   each filled by one 1-D bulk copy (cp.async.bulk, the TMA's linear form:
//   a partition's packed rows are contiguous) that completes on an
//   mbarrier, so the next tiles land while this one is scanned.
// - The merge: each thread keeps a running (min, argmin) with a strict '<'
//   over increasing j and merges it with one 64-bit atomicMin on the key
//   (order-preserving int32 of cost + 0.0f) << 32 | j, so the lowest cost
//   wins and a tie goes to the lowest index, as in a sequential scan (the
//   root-pad rows 1..root_pad-1 copy row 0 and must lose to it).  The
//   wrapper fills the keys with (+inf, 0) before the launch and unpacks
//   them after it; no host sync.  A non-finite cost (NaN, +-inf) never
//   enters the merge and drops only its own row; dead rows (j >= size) are
//   never read.
// - Every index into the register arrays is a compile-time constant (the
//   row's layout is unrolled from an integer sequence), so nothing spills.
// - n is a template argument up to kMaxStates (20, the constant-metric
//   kernel's limit).  Past it, as the reference's kernel has no limit on n,
//   one instance takes n at run time (nn_general_any_kernel): a thread a
//   candidate, its r and e in shared memory (a column a thread), the packed
//   rows read as broadcast loads from device memory; simple and right, not
//   tuned, for models no package ships (n <= kMaxAnyStates).
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>
#include <utility>

#include "nn_common.cuh"

namespace {

using namespace lqrrt_nn;

constexpr int kThreads = 128;
constexpr int kStages = 3;
constexpr int kTileBytesTarget = 12 * 1024;
// n is a template argument up to kMaxStates, a run-time argument of
// nn_general_any_kernel up to kMaxAnyStates (its shared memory, 2 n
// kAnyThreads floats, within the H100's 227 KB a block)
constexpr int kMaxStates = 20;
constexpr int kAnyThreads = 64;
constexpr int kMaxAnyStates = 256;

template <int NS>
struct Cfg {
  static constexpr int kCands = NS <= 8 ? 4 : 2;       // candidates a thread
  static constexpr int kTri = NS * (NS + 1) / 2;
  static constexpr int kRow = (NS + kTri + 3) / 4 * 4; // floats a packed row
  static constexpr int kTileRows = kTileBytesTarget / (4 * kRow) / 4 * 4;
  static constexpr int kTileBytes = kTileRows * kRow * 4;
  static constexpr int kBlockCands = kThreads * kCands;
  static constexpr int kSmem = kStages * kTileBytes + kStages * 8;
  // past 16 states ptxas, left to itself, caps the registers at 64 or 96
  // and spills; one resident block a SM as the floor lifts the cap
  static constexpr int kMinBlocks = NS > 16 ? 1 : 0;
};

// (row, column) of the p-th entry of the row-major upper triangle of n x n
__host__ __device__ constexpr int tri_row(int p, int n) {
  int i = 0;
  while (p >= n - i) p -= n - i++;
  return i;
}
__host__ __device__ constexpr int tri_col(int p, int n) {
  int i = 0;
  while (p >= n - i) p -= n - i++;
  return i + p;
}

// acc[c] = e' S_j e for the kC candidates r[c] against one packed row
template <int NS, bool WRAP, int kC>
__device__ __forceinline__ void row_costs(const float4* __restrict__ row,
                                          const float (&r)[kC][NS],
                                          float (&acc)[kC]) {
  using C = Cfg<NS>;
  const float two_pi = 2.0f * CUDART_PI_F;
  const float inv_two_pi = 1.0f / two_pi;
  float e[kC][NS];
  float t[kC];
  float4 v;
  unroll<C::kRow>([&](auto fc) {
    constexpr int f = decltype(fc)::value;
    if constexpr (f % 4 == 0) v = row[f / 4];
    const float w = lane<f % 4>(v);
    if constexpr (f < NS) {            // x_j, f: e = x_j - r_b
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        float d = w - r[c][f];
        if constexpr (WRAP && f == 0)  // the wrapped dim comes first
          d -= two_pi * rintf(d * inv_two_pi);
        e[c][f] = d;
      }
    } else if constexpr (f < NS + C::kTri) {   // U_ik, row-major
      constexpr int i = tri_row(f - NS, NS);
      constexpr int k = tri_col(f - NS, NS);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if constexpr (k == i) t[c] = w * e[c][k];
        else t[c] = fmaf(w, e[c][k], t[c]);
        if constexpr (k == NS - 1) {
          if constexpr (i == 0) acc[c] = e[c][0] * t[c];
          else acc[c] = fmaf(e[c][i], t[c], acc[c]);
        }
      }
    }
  });
}

template <int NS, bool WRAP>
__global__ void __launch_bounds__(kThreads, Cfg<NS>::kMinBlocks)
nn_general_kernel(const float* __restrict__ rows,  // (N, kRow) packed
                  const float* __restrict__ xr,    // (B, NS), wrap dim first
                  const int* __restrict__ size_ptr,
                  long long* __restrict__ keys, int N, int B) {
  using C = Cfg<NS>;
  constexpr int kC = C::kCands;
  static_assert(NS >= 1 && NS <= kMaxStates, "state dimension out of range");
  static_assert(C::kTileRows >= 4, "a tile holds too few rows");
  extern __shared__ __align__(128) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + kStages * C::kTileBytes);

  // this block's slice of the live rows, from the device-side size
  int size = __ldg(size_ptr);
  size = size < 0 ? 0 : (size > N ? N : size);
  const int parts = gridDim.y;
  const int per = ((size + parts - 1) / parts + 3) / 4 * 4;
  const int lo = blockIdx.y * per;
  const int hi = min(lo + per, size);
  if (lo >= hi) return;   // the whole block: no live row in its slice
  const int n_tiles = (hi - lo + C::kTileRows - 1) / C::kTileRows;

  auto fetch = [&](int t) {
    const int r0 = lo + t * C::kTileRows;
    const int nr = min(C::kTileRows, hi - r0);
    const uint32_t bytes = static_cast<uint32_t>(nr) * C::kRow * 4;
    uint64_t* bar = full + t % kStages;
    mbar_expect_tx(bar, bytes);
    bulk_load(tiles + (t % kStages) * C::kTileRows * C::kRow,
              rows + static_cast<size_t>(r0) * C::kRow, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kStages && t < n_tiles; ++t) fetch(t);

  const int b0 = blockIdx.x * C::kBlockCands + threadIdx.x;
  float r[kC][NS];
  float best[kC];
  int best_id[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int b = b0 + c * kThreads;
#pragma unroll
    for (int k = 0; k < NS; ++k)
      r[c][k] = b < B ? xr[static_cast<size_t>(b) * NS + k] : 0.f;
    best[c] = CUDART_INF_F;
    best_id[c] = 0;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % kStages;
    mbar_wait(full + slot, (t / kStages) & 1);
    const float4* tile = reinterpret_cast<const float4*>(
        tiles + slot * C::kTileRows * C::kRow);
    const int r0 = lo + t * C::kTileRows;
    const int nr = min(C::kTileRows, hi - r0);
    for (int j = 0; j < nr; ++j) {
      float acc[kC];
      row_costs<NS, WRAP>(tile + j * (C::kRow / 4), r, acc);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        // NaN and -inf fail one of the two tests: never a winner
        if (acc[c] < best[c] && acc[c] > -CUDART_INF_F) {
          best[c] = acc[c];
          best_id[c] = r0 + j;
        }
      }
    }
    __syncthreads();   // every thread is done reading this slot
    if (threadIdx.x == 0 && t + kStages < n_tiles) {
      fence_proxy_async();
      fetch(t + kStages);
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int b = b0 + c * kThreads;
    if (b < B && best[c] < CUDART_INF_F)
      atomicMin(keys + b, pack_key(best[c], best_id[c]));
  }
}

// SMs x resident blocks of the instance on the current device, asked of the
// runtime once a device (the launch is on the planner's hot path)
template <int NS, bool WRAP>
int resident_blocks() {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  const bool keep = device >= 0 && device < kDevices;
  if (keep && cached[device] > 0) return cached[device];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, nn_general_kernel<NS, WRAP>, kThreads, Cfg<NS>::kSmem);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (keep) cached[device] = blocks;
  return blocks;
}

template <int NS, bool WRAP>
int launch(const float* rows, const float* xr, const int* size,
           long long* keys, int N, int B, cudaStream_t s) {
  using C = Cfg<NS>;
  // the ring fits the 48 KB a launch gets without cudaFuncSetAttribute
  static_assert(C::kSmem <= 48 * 1024, "the tile ring is too large");
  // as many node partitions as fill the SMs in one wave, and no more than
  // the buffer has tiles of rows
  const int cand_tiles = (B + C::kBlockCands - 1) / C::kBlockCands;
  int parts = resident_blocks<NS, WRAP>() / cand_tiles;
  const int max_parts = (N + C::kTileRows - 1) / C::kTileRows;
  parts = parts < 1 ? 1 : (parts > max_parts ? max_parts : parts);
  parts = parts > 65535 ? 65535 : parts;
  const dim3 grid(cand_tiles, parts);
  nn_general_kernel<NS, WRAP><<<grid, kThreads, C::kSmem, s>>>(
      rows, xr, size, keys, N, B);
  return static_cast<int>(cudaGetLastError());
}

// nn_general_kernel for n > kMaxStates, n at run time: thread b's r_b and
// e = x_j - r_b in shared memory columns (rs, es: [n][kAnyThreads]), and the
// same sums in the same order as row_costs
template <bool WRAP>
__global__ void __launch_bounds__(kAnyThreads)
nn_general_any_kernel(const float* __restrict__ rows,  // (N, row_len)
                      const float* __restrict__ xr,    // (B, n)
                      const int* __restrict__ size_ptr,
                      long long* __restrict__ keys, int N, int B, int n,
                      int row_len) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* rs = reinterpret_cast<float*>(smem) + threadIdx.x;
  float* es = rs + n * kAnyThreads;
  const float two_pi = 2.0f * CUDART_PI_F;
  const float inv_two_pi = 1.0f / two_pi;

  int size = __ldg(size_ptr);
  size = size < 0 ? 0 : (size > N ? N : size);
  const int per = (size + gridDim.y - 1) / gridDim.y;
  const int lo = blockIdx.y * per;
  const int hi = min(lo + per, size);
  const int b = blockIdx.x * kAnyThreads + threadIdx.x;
  if (lo >= hi || b >= B) return;   // no barrier below: a thread alone
  for (int k = 0; k < n; ++k)
    rs[k * kAnyThreads] = __ldg(xr + static_cast<size_t>(b) * n + k);

  float best = CUDART_INF_F;
  int best_id = 0;
  for (int j = lo; j < hi; ++j) {
    const float* row = rows + static_cast<size_t>(j) * row_len;
    for (int k = 0; k < n; ++k) {
      float d = __ldg(row + k) - rs[k * kAnyThreads];
      if (WRAP && k == 0) d -= two_pi * rintf(d * inv_two_pi);
      es[k * kAnyThreads] = d;
    }
    const float* u = row + n;   // U_ik, row-major upper triangle
    float acc = 0.f;
    for (int i = 0; i < n; ++i) {
      float t = __ldg(u++) * es[i * kAnyThreads];
      for (int k = i + 1; k < n; ++k)
        t = fmaf(__ldg(u++), es[k * kAnyThreads], t);
      acc = i == 0 ? es[0] * t : fmaf(es[i * kAnyThreads], t, acc);
    }
    // NaN and -inf fail one of the two tests: never a winner
    if (acc < best && acc > -CUDART_INF_F) {
      best = acc;
      best_id = j;
    }
  }
  if (best < CUDART_INF_F) atomicMin(keys + b, pack_key(best, best_id));
}

template <bool WRAP>
int launch_any(const float* rows, const float* xr, const int* size,
               long long* keys, int N, int B, int n, cudaStream_t s) {
  if (n > kMaxAnyStates) return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = nn_general_any_kernel<WRAP>;
  const int smem = 2 * n * kAnyThreads * 4;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kAnyThreads,
                                                smem);
  const int cand_tiles = (B + kAnyThreads - 1) / kAnyThreads;
  // at least 32 rows a partition
  const int parts = node_parts((sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1),
                               cand_tiles, N, 32);
  const int tri = n * (n + 1) / 2;
  const int row_len = (n + tri + 3) / 4 * 4;
  kernel<<<dim3(cand_tiles, parts), kAnyThreads, smem, s>>>(
      rows, xr, size, keys, N, B, n, row_len);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LQRRT_NN_GENERAL_CASE(NS)                                         \
  case NS:                                                                \
    return wrap ? launch<NS, true>(rows, xr, size, keys, N, B, s)         \
                : launch<NS, false>(rows, xr, size, keys, N, B, s);

// rows (N, kRow) from nn_general_fold, xr (B, n) permuted as rows' x_j,
// keys (B,) filled with the key of (+inf, 0); wrap: the first dim is an
// angle
extern "C" int lqrrt_nn_general(const float* rows, const float* xr,
                                const int* size, long long* keys, int N,
                                int B, int n, int wrap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N < 1 || B < 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    LQRRT_NN_GENERAL_CASE(1) LQRRT_NN_GENERAL_CASE(2)
    LQRRT_NN_GENERAL_CASE(3) LQRRT_NN_GENERAL_CASE(4)
    LQRRT_NN_GENERAL_CASE(5) LQRRT_NN_GENERAL_CASE(6)
    LQRRT_NN_GENERAL_CASE(7) LQRRT_NN_GENERAL_CASE(8)
    LQRRT_NN_GENERAL_CASE(9) LQRRT_NN_GENERAL_CASE(10)
    LQRRT_NN_GENERAL_CASE(11) LQRRT_NN_GENERAL_CASE(12)
    LQRRT_NN_GENERAL_CASE(13) LQRRT_NN_GENERAL_CASE(14)
    LQRRT_NN_GENERAL_CASE(15) LQRRT_NN_GENERAL_CASE(16)
    LQRRT_NN_GENERAL_CASE(17) LQRRT_NN_GENERAL_CASE(18)
    LQRRT_NN_GENERAL_CASE(19) LQRRT_NN_GENERAL_CASE(20)
    default:   // n > kMaxStates
      return wrap ? launch_any<true>(rows, xr, size, keys, N, B, n, s)
                  : launch_any<false>(rows, xr, size, keys, N, B, n, s);
  }
}
