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
// Bound: pure bandwidth, 2 * (A*C) * B * 4 bytes -- 39.3 MB for the boat's
// (100, 6) buffer at B = 8192, 0.0117 ms at the H100's 3.35 TB/s (data
// sheet, 700 W).  A kernel this short is held back by too few bytes in
// flight and by its tail, not by arithmetic.  Design:
// - 16-byte accesses: when ``start`` is a multiple of 4 (the planner's are
//   multiples of 512) and the host saw B, N and both base pointers 16-byte
//   aligned, every thread moves float4s; a float4 of dst then lies wholly
//   inside or wholly outside [0, N).  Otherwise one float at a time.  The
//   path is chosen from the device-side ``start``, once per launch and the
//   same for every thread, so ``start`` never goes to the host.
// - kUnroll = 8 independent loads per thread, all started before the first
//   store, so each thread keeps 128 bytes (vector path) in flight.
// - A grid sized to the card: at most as many blocks as fit on the SMs at
//   once, each walking over (row, column-chunk) tiles of kThreads*kUnroll
//   elements.  At the planner's shapes a tile is a whole row of float4s, so
//   the 600 (C = 6) or 300 (C = 3) tiles run as one wave, with no tail.
// - Streaming cache hints (__ldcs on src, __stcs on dst): src is dead after
//   the write and the edge buffers are read again only by the plan's
//   extraction.
// Columns outside [0, N) are masked for any start, negative ones included.
// No bulk-copy (TMA) path: a 1-D cp.async.bulk global -> shared -> global
// variant, and this kernel with 4 loads a thread, were timed beside this
// one on an H100 80GB HBM3 at 700 W and were no faster with L2 cold; what
// is left to the bound is a launch's fixed cost, which every variant pays
// (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

// Copy row tiles of T elements (float4 or float): src row r, element c goes
// to dst row r, element c + off, kept where 0 <= c + off < n_dst.
template <typename T, typename Load, typename Store>
__device__ __forceinline__ void copy_tiles(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           long long off, int rows,
                                           int n_dst, int n_src,
                                           Load load, Store store) {
  constexpr int kTile = kThreads * kUnroll;
  const int tiles_per_row = (n_src + kTile - 1) / kTile;
  const int n_tiles = rows * tiles_per_row;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row = tile / tiles_per_row;
    const int c0 = (tile - row * tiles_per_row) * kTile + threadIdx.x;
    const T* s = src + (size_t)row * n_src;
    T* d = dst + (size_t)row * n_dst;
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      if (c < n_src) v[u] = load(s + c);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = c0 + u * kThreads;
      const long long to = off + c;
      if (c < n_src && to >= 0 && to < n_dst) store(d + to, v[u]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
block_write_kernel(float* __restrict__ dst, const float* __restrict__ src,
                   const int* __restrict__ start_ptr, int rows, int N, int B,
                   int vec_ok) {
  const int start = __ldg(start_ptr);
  if (vec_ok && (start & 3) == 0) {
    copy_tiles(reinterpret_cast<float4*>(dst),
               reinterpret_cast<const float4*>(src), start / 4, rows, N / 4,
               B / 4, [](const float4* p) { return __ldcs(p); },
               [](float4* p, float4 v) { __stcs(p, v); });
  } else {
    copy_tiles(dst, src, start, rows, N, B,
               [](const float* p) { return __ldcs(p); },
               [](float* p, float v) { __stcs(p, v); });
  }
}

// SMs x resident blocks of the kernel on the current device, asked of the
// runtime once a device (the launch is on the host's hot path)
int resident_blocks() {
  constexpr int kDevices = 64;
  static int cached[kDevices] = {};
  int device = 0;
  cudaGetDevice(&device);
  const bool keep = device >= 0 && device < kDevices;
  if (keep && cached[device] > 0) return cached[device];
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, block_write_kernel,
                                                kThreads, 0);
  const int blocks = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1);
  if (keep) cached[device] = blocks;
  return blocks;
}

}  // namespace

extern "C" int lqrrt_block_write(float* dst, const float* src,
                                 const int* start, int rows, int N, int B,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec_ok = B % 4 == 0 && N % 4 == 0 &&
                      reinterpret_cast<size_t>(dst) % 16 == 0 &&
                      reinterpret_cast<size_t>(src) % 16 == 0;
  // the vector path's tiles (the scalar path walks 4 times as many with
  // the same grid)
  const int tile = kThreads * kUnroll * (vec_ok ? 4 : 1);
  const long long tiles = (long long)rows * ((B + tile - 1) / tile);
  long long grid = resident_blocks();
  if (tiles < grid) grid = tiles;
  if (grid < 1) grid = 1;
  block_write_kernel<<<(int)grid, kThreads, 0, s>>>(dst, src, start, rows, N,
                                                    B, vec_ok ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}
