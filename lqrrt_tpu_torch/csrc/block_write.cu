// In-place block-column write: dst[:, :, start:start+B] = src on a
// time-major (A, C, N) edge buffer, every other column keeping its bytes.
//
// Replaces: lqrrt_tpu/ops/pallas/write_kernel.py, block_column_write (the
// aliased Pallas writer that spared the TPU a full-buffer copy of the
// dynamic-update-slice).  In PyTorch the buffer is mutated in place anyway;
// what the kernel adds is that ``start`` is read from DEVICE memory (the
// commit offset min(tree.size, limit) lives on the card), so the host never
// synchronises to learn it and the chunk stays capturable as a CUDA graph.
//
// Bound: pure bandwidth, 2 * (A*C) * B * 4 bytes -- 59 MB per round for the
// boat's two edge buffers (A = 100, C = 6 and 3, B = 8192).  Design: one
// block row per (a, c) row of the buffer and consecutive threads on
// consecutive columns, so loads and stores are coalesced; any ``start`` is
// taken, columns at or past N are masked (no 512 alignment, no truncation).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void block_write_kernel(float* __restrict__ dst,
                                   const float* __restrict__ src,
                                   const int* __restrict__ start_ptr,
                                   int N, int B) {
  const int row = blockIdx.y;
  const int start = *start_ptr;
  const float* s = src + (size_t)row * B;
  float* d = dst + (size_t)row * N;
  for (int col = blockIdx.x * kThreads + threadIdx.x; col < B;
       col += gridDim.x * kThreads) {
    const long long to = (long long)start + col;
    if (to >= 0 && to < N) d[to] = s[col];
  }
}

}  // namespace

extern "C" int lqrrt_block_write(float* dst, const float* src,
                                 const int* start, int rows, int N, int B,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int gx = (B + kThreads - 1) / kThreads;
  if (gx > 64) gx = 64;
  const dim3 grid(gx, rows);
  block_write_kernel<<<grid, kThreads, 0, s>>>(dst, src, start, N, B);
  return static_cast<int>(cudaGetLastError());
}
