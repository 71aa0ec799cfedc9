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
// Inputs are prepared by the wrapper (ops/kernels/nn_kernel.py), as the JAX
// side prepares them outside the pallas_call: S = L L' (Cholesky), states and
// candidates centred on the candidate mean (the wrap dim left uncentred) and
// whitened, z = statesc @ L (N, n), w = xrandc @ L (B, n).  With one wrapped
// angle dim a, k = rint((x_a - r_a) / 2pi) turns, and the whitened shift of
// one turn is c = 2pi L[a, :], so the distance is |z_j - w_b - k c|^2.
//
// Bound: about B * size * (3n + 6) flops -- 6 GFLOP at B = 8192, size =
// 32768 -- against ~1 MB of node data, so it is compute-bound on fp32 CUDA
// cores.  Design: one thread per candidate keeps w_b in registers; a block
// stages tiles of z (and x_a) in shared memory, which every thread of the
// block then reads as a broadcast.  Rows are scanned in increasing j with a
// strict '<', so the lowest index wins ties, as in the Pallas kernel -- the
// root-pad rows 1..root_pad-1 are copies of row 0 and must lose to it.  Dead
// rows are skipped by index (j < size, read from device memory), never by
// poisoning their values.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 64;   // candidates per block: 128 blocks at B = 8192
constexpr int kTile = 256;     // node rows staged in shared memory per pass
// n is a template argument (w_b lives in registers); 16 covers every model
// of the package (boat 6, car 4, quadrotor 12)
constexpr int kMaxStates = 16;

template <int NS>
__global__ void nn_const_kernel(const float* __restrict__ z,
                                const float* __restrict__ xa,
                                const float* __restrict__ w,
                                const float* __restrict__ ra,
                                const float* __restrict__ c,
                                const int* __restrict__ size_ptr,
                                int* __restrict__ ids,
                                float* __restrict__ cost,
                                int N, int B, int wrapped) {
  static_assert(NS >= 1 && NS <= kMaxStates, "state dimension out of range");
  __shared__ float zs[kTile * NS];
  __shared__ float xas[kTile];
  const int b = blockIdx.x * kThreads + threadIdx.x;
  const bool active = b < B;
  int size = *size_ptr;
  size = size < 0 ? 0 : (size > N ? N : size);

  float wb[NS], cb[NS];
  float rb = 0.f;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    wb[k] = active ? w[(size_t)b * NS + k] : 0.f;
    cb[k] = c[k];
  }
  if (active && wrapped) rb = ra[b];
  const float inv_two_pi = 1.0f / (2.0f * CUDART_PI_F);

  float best = CUDART_INF_F;
  int best_id = 0;
  for (int t0 = 0; t0 < size; t0 += kTile) {
    const int rows = min(kTile, size - t0);
    __syncthreads();   // the previous tile is no longer being read
    for (int i = threadIdx.x; i < rows * NS; i += kThreads)
      zs[i] = z[(size_t)t0 * NS + i];
    if (wrapped)
      for (int i = threadIdx.x; i < rows; i += kThreads) xas[i] = xa[t0 + i];
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < rows; ++j) {
      float turns = 0.f;
      if (wrapped) turns = rintf((xas[j] - rb) * inv_two_pi);
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const float d = zs[j * NS + k] - wb[k] - turns * cb[k];
        acc = fmaf(d, d, acc);
      }
      if (acc < best) {
        best = acc;
        best_id = t0 + j;
      }
    }
  }
  if (active) {
    ids[b] = best_id;
    cost[b] = best;
  }
}

}  // namespace

#define LQRRT_NN_CASE(NS)                                                   \
  case NS:                                                                  \
    nn_const_kernel<NS><<<grid, kThreads, 0, s>>>(z, xa, w, ra, c, size,    \
                                                  ids, cost, N, B, wrapped); \
    break;

extern "C" int lqrrt_nn_const(const float* z, const float* xa, const float* w,
                              const float* ra, const float* c, const int* size,
                              int* ids, float* cost, int N, int B, int n,
                              int wrapped, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + kThreads - 1) / kThreads);
  switch (n) {
    LQRRT_NN_CASE(1) LQRRT_NN_CASE(2) LQRRT_NN_CASE(3) LQRRT_NN_CASE(4)
    LQRRT_NN_CASE(5) LQRRT_NN_CASE(6) LQRRT_NN_CASE(7) LQRRT_NN_CASE(8)
    LQRRT_NN_CASE(9) LQRRT_NN_CASE(10) LQRRT_NN_CASE(11) LQRRT_NN_CASE(12)
    LQRRT_NN_CASE(13) LQRRT_NN_CASE(14) LQRRT_NN_CASE(15) LQRRT_NN_CASE(16)
    default:
      return static_cast<int>(cudaErrorInvalidValue);  // n > kMaxStates
  }
  return static_cast<int>(cudaGetLastError());
}
