// General-metric nearest neighbour: for each candidate b, the argmin over
// live rows j < size of e' S_j e, e = x_j - r_b, with a per-node S_j.
//
// Replaces: lqrrt_tpu/ops/pallas/nn_kernel.py, nearest_pallas and its body
// _nn_kernel.  The Pallas kernel expanded e' S_j e into bilinear features
// (1 + n + n^2 lanes) so that the (B x N) cost matrix became one MXU matmul;
// the expansion cancels for near nodes (hence Precision.HIGHEST and the
// centring) and its wrap correction assumed a symmetric S.  This kernel
// evaluates the metric directly: e_k = x_jk - r_bk, the wrapped dim a
// shifted by -2pi rint(e_a / 2pi), q = S_j e, cost = e . q, in fp32 FMAs
// with the full S_j -- exact for any S, like the plain scan.  No tensor
// cores: TF32 would lose the argmin.
//
// Bound: about B * size * (n^2 + 2n) FMAs -- 45 G at the quadrotor's n = 12
// with B = 8192 and size = 32768, 6 G for the car's n = 4 -- against
// size * (n^2 + n) * 4 bytes of node data (20 MB at n = 12), which every
// block re-reads from L2.  So it is compute-bound on the fp32 CUDA cores
// and on the shared-memory loads that feed them.  Design: a block owns 32
// candidates (r_b in registers, one per lane) and kGroups warps.  It stages
// a tile of node rows (S_j, x_j) in shared memory, and warp w scans the
// tile's rows j = w, w + kGroups, ...: all lanes of a warp read the same
// row, so every shared load is a broadcast, and S_j is read as float4.  The
// kGroups warps give the SMs kGroups times the warps that one thread per
// candidate alone would (B = 8192 is 256 warps for 132 SMs).  Each warp keeps
// a running (min, argmin) with a strict '<' over increasing j; the groups
// merge at the end by (cost, index), so the lowest index wins ties as in a
// sequential scan -- the root-pad rows 1..root_pad-1 copy row 0 and must
// lose to it.  Dead rows are skipped by index (j < size, read from device
// memory).  A non-finite cost never wins and drops only its own row.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kLanes = 32;            // candidates per block
constexpr int kGroups = 4;            // warps per block, one row group each
constexpr int kThreads = kLanes * kGroups;
constexpr int kTileBytes = 40 * 1024; // static shared memory for the tile
// n is a template argument (r_b, e and q live in registers); 16 covers
// every model of the package (boat 6, car 4, quadrotor 12)
constexpr int kMaxStates = 16;

template <int NS>
struct Layout {
  static constexpr int kSP = (NS * NS + 3) / 4 * 4;  // S_j floats, float4-padded
  static constexpr int kXP = (NS + 3) / 4 * 4;       // x_j floats, float4-padded
  static constexpr int kRow = kSP + kXP;             // floats per staged row
  static constexpr int kFit = kTileBytes / (4 * kRow);
  static constexpr int kRows = (kFit > 256 ? 256 : kFit) / kGroups * kGroups;
};

template <int NS>
__global__ void __launch_bounds__(kThreads)
nn_general_kernel(const float* __restrict__ states,  // (N, NS)
                  const float* __restrict__ S,       // (N, NS, NS)
                  const float* __restrict__ xrand,   // (B, NS)
                  const int* __restrict__ size_ptr,
                  int* __restrict__ ids, float* __restrict__ cost,
                  int N, int B, int wrap) {
  using L = Layout<NS>;
  static_assert(NS >= 1 && NS <= kMaxStates, "state dimension out of range");
  static_assert(L::kRows >= kGroups, "tile holds too few rows");
  __shared__ __align__(16) float tile[L::kRows * L::kRow];
  __shared__ float group_cost[kGroups][kLanes];
  __shared__ int group_id[kGroups][kLanes];

  const int lane = threadIdx.x % kLanes;
  const int group = threadIdx.x / kLanes;
  const int b = blockIdx.x * kLanes + lane;
  const bool active = b < B;
  int size = *size_ptr;
  size = size < 0 ? 0 : (size > N ? N : size);

  float r[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) r[k] = active ? xrand[(size_t)b * NS + k] : 0.f;
  const float two_pi = 2.0f * CUDART_PI_F;
  const float inv_two_pi = 1.0f / two_pi;

  float best = CUDART_INF_F;
  int best_id = 0;
  for (int t0 = 0; t0 < size; t0 += L::kRows) {
    const int rows = min(L::kRows, size - t0);
    __syncthreads();   // the previous tile is no longer being read
    for (int i = threadIdx.x; i < rows * NS * NS; i += kThreads) {
      const int row = i / (NS * NS);
      tile[row * L::kRow + (i - row * NS * NS)] = S[(size_t)t0 * NS * NS + i];
    }
    for (int i = threadIdx.x; i < rows * NS; i += kThreads) {
      const int row = i / NS;
      tile[row * L::kRow + L::kSP + (i - row * NS)] = states[(size_t)t0 * NS + i];
    }
    __syncthreads();
    if (!active) continue;
    for (int j = group; j < rows; j += kGroups) {
      const float4* row = reinterpret_cast<const float4*>(tile + j * L::kRow);
      float e[NS], q[NS];
#pragma unroll
      for (int c = 0; c < L::kXP / 4; ++c) {
        const float4 v = row[L::kSP / 4 + c];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
          if (4 * c + t < NS) e[4 * c + t] = w[t] - r[4 * c + t];
      }
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (k == wrap) e[k] -= two_pi * rintf(e[k] * inv_two_pi);
        q[k] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < L::kSP / 4; ++c) {
        const float4 v = row[c];
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int f = 4 * c + t;   // flat index into S_j, row-major
          if (f < NS * NS) q[f / NS] = fmaf(w[t], e[f % NS], q[f / NS]);
        }
      }
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) acc = fmaf(e[k], q[k], acc);
      // NaN and -inf fail one of the two tests: a non-finite cost never wins
      if (acc < best && acc > -CUDART_INF_F) {
        best = acc;
        best_id = t0 + j;
      }
    }
  }
  group_cost[group][lane] = best;
  group_id[group][lane] = best_id;
  __syncthreads();
  if (group == 0 && active) {
#pragma unroll
    for (int g = 1; g < kGroups; ++g) {
      const float c = group_cost[g][lane];
      const int id = group_id[g][lane];
      if (c < best || (c == best && id < best_id)) {
        best = c;
        best_id = id;
      }
    }
    ids[b] = best_id;
    cost[b] = best;
  }
}

}  // namespace

#define LQRRT_NN_GENERAL_CASE(NS)                                          \
  case NS:                                                                 \
    nn_general_kernel<NS><<<grid, kThreads, 0, s>>>(states, S, xrand, size, \
                                                    ids, cost, N, B, wrap); \
    break;

extern "C" int lqrrt_nn_general(const float* states, const float* S,
                                const float* xrand, const int* size, int* ids,
                                float* cost, int N, int B, int n, int wrap,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kLanes - 1) / kLanes);
  switch (n) {
    LQRRT_NN_GENERAL_CASE(1) LQRRT_NN_GENERAL_CASE(2)
    LQRRT_NN_GENERAL_CASE(3) LQRRT_NN_GENERAL_CASE(4)
    LQRRT_NN_GENERAL_CASE(5) LQRRT_NN_GENERAL_CASE(6)
    LQRRT_NN_GENERAL_CASE(7) LQRRT_NN_GENERAL_CASE(8)
    LQRRT_NN_GENERAL_CASE(9) LQRRT_NN_GENERAL_CASE(10)
    LQRRT_NN_GENERAL_CASE(11) LQRRT_NN_GENERAL_CASE(12)
    LQRRT_NN_GENERAL_CASE(13) LQRRT_NN_GENERAL_CASE(14)
    LQRRT_NN_GENERAL_CASE(15) LQRRT_NN_GENERAL_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);  // n > kMaxStates
  }
  return static_cast<int>(cudaGetLastError());
}
