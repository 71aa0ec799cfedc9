// Constant-metric nearest neighbour: for each candidate b, the argmin over
// live rows j < size of (x_j - r_b)' S (x_j - r_b) for one shared S.
//
// Replaces: lqrrt_tpu/ops/pallas/nn_kernel.py, nearest_const_pallas and its
// body _nn_const_kernel.  The Pallas kernel expanded the quadratic into
// |z|^2 - 2 w.z and ran it on the MXU with a three-way bf16 split; on Hopper
// the contraction depth is n = 6, far too small for tensor cores, so this
// kernel forms the whitened difference directly and sums its squares in
// fp32 FMAs on the CUDA cores (no cancellation, no split).
//
// The arithmetic (ops/kernels/nn_kernel.py ``nn_const_prep`` and
// ``nn_const_dist`` are the same in plain PyTorch): the state dims are
// permuted so that the wrapped dim a comes first, L = cholesky(S_p + 1e-9 I)
// of the permuted S, rows and candidates are centred on the candidate mean
// (dim a uncentred) and whitened, z = x_c L, w = r_c L.  L is lower
// triangular, so one turn of dim a shifts z by c = 2pi L[0, :] =
// (c0, 0, ..., 0): with x'_a = x_a / 2pi, r'_a = r_a / 2pi and k =
// rint(x'_a - r'_a), the cost is (z_0 - w_0 - k c0)^2 + sum_{i>0} (z_i -
// w_i)^2.  The wrap costs three adds and one FMA a pair, not n FMAs and a
// quarter-rate FRND.
//
// Bound: B * size pairs of 3n + 3 fp32 flops, wrapped (n subs z_i - w_i,
// the squares summed in n - 1 FMAs and a mul, and the turn: a sub, a rint
// and the FMA of k c0 into z_0 - w_0; 3n - 1 unwrapped; tools/kernel_times.py
// ``const_flops``): 0.0841 ms at n = 6, B = 8192, size 32768 on the H100's
// 67 TFLOP/s (data sheet, 700 W), against ~1 MB of node data:
// compute-bound.  What the card issues is 2n + 7 instructions a pair at
// n = 6 wrapped (the turn: a sub and two adds; z_0: a sub, an FMA, a mul;
// 5 x (sub, FMA); compare and two selects), 19, each one of the SM's four
// issue slots a cycle, so the issue bound is about 0.15-0.17 ms.  Design:
// - Grid (candidate tiles) x (node partitions), sized so that the blocks
//   fill the SMs in one wave; each block derives its row range, a slice of
//   [0, size), from ``*size`` on the device.
// - Register blocking: a thread holds kC candidates (w, r'_a, the running
//   minimum), so each broadcast 16-byte shared load of a row feeds 4 kC
//   pairs' work.
// - The prep is in the block: warp 0 factors S (n <= 20, ~1-3 us, while the
//   first tiles land), each thread whitens its candidates, and each tile of
//   raw state rows is whitened once by the block into a packed tile
//   [x'_a, z, 0 pad] before the scan.  So the wrapper launches only the
//   candidate mean, the fill of the keys and this kernel.
// - Asynchronous staging: a ring of kStages raw tiles in dynamic shared
//   memory, each filled by one 1-D bulk copy (cp.async.bulk) that completes
//   on an mbarrier, and two packed tiles, so that the copies of the next
//   tiles and the whitening of the next tile overlap the scan; one
//   __syncthreads a tile.  A tile's last rows, past the 16-byte multiple
//   that a bulk copy moves, are read from device memory.
// - The merge: each thread keeps a running (min, argmin) with a strict '<'
//   over increasing j and merges it with one 64-bit atomicMin on
//   pack_key's (cost, j) key, so the lowest cost wins and a tie goes to
//   the lowest index, as in a sequential scan (the root-pad rows
//   1..root_pad-1 copy row 0 and must lose to it).  The block that finishes
//   last (a counter in the keys buffer) unpacks the keys into (ids, cost),
//   so the call needs no host sync and no unpacking ops.  A NaN cost never
//   enters the merge and drops only its own row (squares are never
//   negative); dead rows (j >= size) are never read; size 0 gives (0, inf).
// - Every index into the register arrays is a compile-time constant, so
//   nothing spills.
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "nn_common.cuh"

namespace {

using namespace lqrrt_nn;

constexpr int kThreads = 128;
constexpr int kStages = 3;
// n is a template argument (w lives in registers); 20 is the reference's
// limit for its constant-metric kernel (6(1 + n) + 2 <= 128 lanes)
constexpr int kMaxStates = 20;

template <int NS, bool WRAP>
struct Cfg {
  // candidates a thread; one past 16 states, where w and the whitening's
  // sums would not fit the registers with two
  static constexpr int kCands = NS <= 8 ? 4 : (NS <= 16 ? 2 : 1);
  // rows a tile, a multiple of 4; past 16 states the ring of 128-row tiles
  // would not fit the 48 KB
  static constexpr int kTileRows = NS <= 16 ? 128 : 64;
  static constexpr int kOff = WRAP ? 1 : 0;             // x'_a leads a row
  static constexpr int kRow = (NS + kOff + 3) / 4 * 4;  // floats a packed row
  static constexpr int kRaw = kTileRows * NS;           // floats a raw tile
  static constexpr int kPacked = kTileRows * kRow;      // floats a packed tile
  static constexpr int kBlockCands = kThreads * kCands;
  // raw ring, two packed tiles, the ring's barriers, the fp64 factor, L,
  // the centre
  static constexpr int kSmem = 4 * (kStages * kRaw + 2 * kPacked) +
                               8 * (kStages + NS * NS) + 4 * (NS * NS + NS);
};

template <int NS, bool WRAP>
__global__ void __launch_bounds__(kThreads)
nn_const_kernel(const float* __restrict__ states,  // (N, NS)
                const float* __restrict__ xr,      // (B, NS)
                const float* __restrict__ S,       // (NS, NS)
                const float* __restrict__ center,  // (NS,) candidate mean
                const int* __restrict__ size_ptr,
                long long* __restrict__ keys,      // (B + 1,) kEmptyKey
                int* __restrict__ ids, float* __restrict__ cost, int N,
                int B, int a) {
  using C = Cfg<NS, WRAP>;
  constexpr int kC = C::kCands;
  static_assert(NS >= 1 && NS <= kMaxStates, "state dimension out of range");
  extern __shared__ __align__(128) unsigned char smem[];
  float* raw = reinterpret_cast<float*>(smem);
  float* packed = raw + kStages * C::kRaw;
  uint64_t* full = reinterpret_cast<uint64_t*>(packed + 2 * C::kPacked);
  double* Ws = reinterpret_cast<double*>(full + kStages);
  float* Ls = reinterpret_cast<float*>(Ws + NS * NS);
  float* ctr = Ls + NS * NS;
  if (!WRAP) a = -1;

  int lo, hi;
  block_rows(size_ptr, N, lo, hi);
  const int n_tiles =
      lo < hi ? (hi - lo + C::kTileRows - 1) / C::kTileRows : 0;

  auto fetch = [&](int t) {
    const int r0 = lo + t * C::kTileRows;
    const int nr = min(C::kTileRows, hi - r0);
    const uint32_t bytes = static_cast<uint32_t>(nr * NS * 4) & ~15u;
    uint64_t* bar = full + t % kStages;
    mbar_expect_tx(bar, bytes);
    if (bytes > 0)
      bulk_load(raw + (t % kStages) * C::kRaw,
                states + static_cast<size_t>(r0) * NS, bytes, bar);
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  if (threadIdx.x < 32) {
    warp_cholesky(S, NS, a, Ws, Ls, NS);
  } else if (threadIdx.x < 32 + NS) {
    const int k = threadIdx.x - 32;   // angles stay uncentred
    ctr[k] = k == a ? 0.f : center[k];
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int t = 0; t < kStages && t < n_tiles; ++t) fetch(t);

  const float c0 = WRAP ? kTwoPi * Ls[0] : 0.f;
  const int b0 = blockIdx.x * C::kBlockCands + threadIdx.x;
  float w[kC][NS], rp[kC], best[kC];
  int best_id[kC];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int b = b0 + c * kThreads;
    const float* r = xr + static_cast<size_t>(b < B ? b : 0) * NS;
    float xc[NS];
    whiten<NS, NS>([&](int p) { return b < B ? __ldg(r + p) : 0.f; }, NS,
                   Ls, ctr, a, xc, w[c]);
    rp[c] = WRAP && b < B ? __ldg(r + a) * kInvTwoPi : 0.f;
    best[c] = CUDART_INF_F;
    best_id[c] = 0;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int slot = t % kStages;
    mbar_wait(full + slot, (t / kStages) & 1);
    const int r0 = lo + t * C::kTileRows;
    const int nr = min(C::kTileRows, hi - r0);
    const float* rt = raw + slot * C::kRaw;
    float* pt = packed + (t & 1) * C::kPacked;
    const int in_smem = (nr * NS) & ~3;   // floats the bulk copy moved
    for (int r = threadIdx.x; r < nr; r += kThreads) {
      const float* g = states + static_cast<size_t>(r0 + r) * NS;
      auto at = [&](int p) {
        return r * NS + p < in_smem ? rt[r * NS + p] : __ldg(g + p);
      };
      // past 16 states L is read afresh each tile: held in registers
      // across the tile loop, its n(n + 1) / 2 entries spill
      const float* Lt = Ls;
      if constexpr (NS > 16) asm volatile("" : "+l"(Lt));
      float xc[NS], z[NS];
      whiten<NS, NS>(at, NS, Lt, ctr, a, xc, z);
      float* row = pt + r * C::kRow;
      if constexpr (WRAP) row[0] = at(a) * kInvTwoPi;
#pragma unroll
      for (int k = 0; k < NS; ++k) row[C::kOff + k] = z[k];
    }
    __syncthreads();   // the tile is packed; every thread is done with slot
    if (threadIdx.x == 0 && t + kStages < n_tiles) {
      fence_proxy_async();
      fetch(t + kStages);
    }
    for (int j = 0; j < nr; ++j) {
      const float4* row = reinterpret_cast<const float4*>(pt + j * C::kRow);
      float acc[kC], turn[kC];
      float4 v;
      unroll<C::kOff + NS>([&](auto fc) {
        constexpr int f = decltype(fc)::value;
        if constexpr (f % 4 == 0) v = row[f / 4];
        const float x = lane<f % 4>(v);
        if constexpr (WRAP && f == 0) {          // k = rint(x'_a - r'_a)
#pragma unroll
          for (int c = 0; c < kC; ++c) turn[c] = (x - rp[c] + kRound) - kRound;
        } else {
          constexpr int k = f - C::kOff;
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            float d = x - w[c][k];
            if constexpr (WRAP && k == 0) d = fmaf(-turn[c], c0, d);
            if constexpr (k == 0) acc[c] = d * d;
            else acc[c] = fmaf(d, d, acc[c]);
          }
        }
      });
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        if (acc[c] < best[c]) {   // NaN fails: never a winner
          best[c] = acc[c];
          best_id[c] = r0 + j;
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const int b = b0 + c * kThreads;
    if (b < B && best[c] < CUDART_INF_F)
      atomicMin(keys + b, pack_key(best[c], best_id[c]));
  }
  if (last_block(keys + B)) {
    for (int b = threadIdx.x; b < B; b += kThreads)
      unpack_key(__ldcg(keys + b), ids[b], cost[b]);
  }
}

template <int NS, bool WRAP>
int launch(const float* states, const float* xr, const float* S,
           const float* center, const int* size, long long* keys, int* ids,
           float* cost, int N, int B, int a, cudaStream_t s) {
  using C = Cfg<NS, WRAP>;
  // the ring fits the 48 KB a launch gets without cudaFuncSetAttribute
  static_assert(C::kSmem <= 48 * 1024, "the tile ring is too large");
  static int cache[64] = {};
  const int cand_tiles = (B + C::kBlockCands - 1) / C::kBlockCands;
  const int parts = node_parts(
      resident_blocks(nn_const_kernel<NS, WRAP>, kThreads, C::kSmem, cache),
      cand_tiles, N, C::kTileRows);
  const dim3 grid(cand_tiles, parts);
  nn_const_kernel<NS, WRAP><<<grid, kThreads, C::kSmem, s>>>(
      states, xr, S, center, size, keys, ids, cost, N, B, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LQRRT_NN_CONST_CASE(NS)                                             \
  case NS:                                                                  \
    return wrap ? launch<NS, true>(states, xr, S, center, size, keys, ids,  \
                                   cost, N, B, a, s)                        \
                : launch<NS, false>(states, xr, S, center, size, keys, ids, \
                                    cost, N, B, a, s);

// states (N, n) and xr (B, n) raw, 16-byte aligned; S (n, n); center (n,)
// the candidates' mean; keys (B + 1,) filled with pack_key(+inf, 0); ids,
// cost (B,) written by the launch; a the wrapped dim or -1
extern "C" int lqrrt_nn_const(const float* states, const float* xr,
                              const float* S, const float* center,
                              const int* size, long long* keys, int* ids,
                              float* cost, int N, int B, int n, int a,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wrap = a >= 0;
  if (N < 1 || B < 1 || a >= n) return static_cast<int>(cudaErrorInvalidValue);
  switch (n) {
    LQRRT_NN_CONST_CASE(1) LQRRT_NN_CONST_CASE(2) LQRRT_NN_CONST_CASE(3)
    LQRRT_NN_CONST_CASE(4) LQRRT_NN_CONST_CASE(5) LQRRT_NN_CONST_CASE(6)
    LQRRT_NN_CONST_CASE(7) LQRRT_NN_CONST_CASE(8) LQRRT_NN_CONST_CASE(9)
    LQRRT_NN_CONST_CASE(10) LQRRT_NN_CONST_CASE(11) LQRRT_NN_CONST_CASE(12)
    LQRRT_NN_CONST_CASE(13) LQRRT_NN_CONST_CASE(14) LQRRT_NN_CONST_CASE(15)
    LQRRT_NN_CONST_CASE(16) LQRRT_NN_CONST_CASE(17) LQRRT_NN_CONST_CASE(18)
    LQRRT_NN_CONST_CASE(19) LQRRT_NN_CONST_CASE(20)
    default:
      return static_cast<int>(cudaErrorInvalidValue);  // n > kMaxStates
  }
}
