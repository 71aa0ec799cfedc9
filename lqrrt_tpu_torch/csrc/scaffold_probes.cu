// Seven scaffold probes, each a small kernel.
//
// Replaces: tools/dbg_steer_scaffold.py, attempt (:18) and the seven
// kernels it ran (:30-100), which asked which piece of the rollout
// kernel's structure Mosaic would lower.  On Hopper each probe is the same
// function written as a CUDA kernel, b the fastest index of every load and
// store; A and D-G one thread a column b of the (6, B) input:
//   A  y = 2 x                                  (6, B)
//   B  y[h] = x for every step h                 (H, 6, B)
//   C  c = x; y[h] = c = 1.01 c, step by step    (H, 6, B)
//   D  y = sum of x over its 6 rows              (B,)
//   E  done |= (column sum of c > 1e9); c = 1.01 c, H steps; y = done
//                                                (B,) int32
//   F  y = x + g[:, None], g (6,)                (6, B)
//   G  y = x + the sum of a (7, 2) constant      (6, B)
// Each equals its one-line PyTorch version (ops/kernels/scaffold_probes.py)
// bit for bit on the tool's all-ones data, where every order of a sum gives
// the same value; D and E sum the rows in the order of PyTorch's CUDA
// reduction over dim 0 (sum6_rows), G its 14 values in one fixed order.
//
// Bound on the H100: bytes for each (the input read once, the output
// written once; B and C write H times the input, 2.4 MB at the tool's
// B = 1024).  No probe has work enough to hide a launch: at B = 1024 each is
// a few microseconds.  B and C, the two that write (H, 6, B), spread that
// write over the card (probe_geometry in ops/kernels/scaffold_probes.py
// picks the grid from B and the SM count):
// - B: a 2-D grid, x over the 6B elements of x (float4s where 6B is a
//   multiple of 4 and both pointers 16-byte aligned, else floats), y over
//   chunks of h_per steps: each thread loads its element once and stores
//   it h_per times;
// - C: the value at step h is h roundings of x 1.01, a serial chain an
//   element, so one thread an element of (6, B), in blocks small enough to
//   reach every SM.
#include <cuda_runtime.h>

#include "boat_device.cuh"

namespace {

using boat::add;
using boat::kN;
using boat::mul;

__global__ void probe_a_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#pragma unroll
  for (int i = 0; i < kN; ++i) y[i * B + b] = mul(x[i * B + b], 2.0f);
}

// y[h] = x for h in [h_per blockIdx.y, h_per (blockIdx.y + 1)): T is
// float4 or float, n the count of T in x
template <class T>
__global__ void probe_b_kernel(const T* __restrict__ x, T* __restrict__ y,
                               int n, int H, int h_per) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  const int h0 = blockIdx.y * h_per, h1 = min(H, h0 + h_per);
  const T v = x[e];
  for (int h = h0; h < h1; ++h) y[(size_t)h * n + e] = v;
}

// element e of x (n = 6B): y[h, e] = c = 1.01 c, step by step
__global__ void probe_c_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int n, int H) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float c = x[e];
  for (int h = 0; h < H; ++h) {
    c = mul(c, 1.01f);
    y[(size_t)h * n + e] = c;
  }
}

__global__ void probe_d_kernel(const float* __restrict__ x,
                               float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) c[i] = x[i * B + b];
  y[b] = boat::sum6_rows(c);
}

__global__ void probe_e_kernel(const float* __restrict__ x,
                               int* __restrict__ y, int B, int H) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float c[kN];
#pragma unroll
  for (int i = 0; i < kN; ++i) c[i] = x[i * B + b];
  bool done = false;
  for (int h = 0; h < H; ++h) {
    done = done || boat::sum6_rows(c) > 1e9f;
#pragma unroll
    for (int i = 0; i < kN; ++i) c[i] = mul(c[i], 1.01f);
  }
  y[b] = done;
}

__global__ void probe_f_kernel(const float* __restrict__ x,
                               const float* __restrict__ g,
                               float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
#pragma unroll
  for (int i = 0; i < kN; ++i) y[i * B + b] = add(x[i * B + b], g[i]);
}

// the 14 values of a contiguous (7, 2) tensor: 8 lanes, lane l adds a[l]
// and a[l + 8], then a tree by offsets 4, 2 and 1
__device__ __forceinline__ float sum14(const float* a) {
  float s[8];
#pragma unroll
  for (int l = 0; l < 8; ++l) s[l] = l < 6 ? add(a[l], a[l + 8]) : a[l];
#pragma unroll
  for (int off = 4; off > 0; off /= 2)
#pragma unroll
    for (int l = 0; l < off; ++l) s[l] = add(s[l], s[l + off]);
  return s[0];
}

__global__ void probe_g_kernel(const float* __restrict__ x,
                               const float* __restrict__ c2,
                               float* __restrict__ y, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float a[14];
#pragma unroll
  for (int i = 0; i < 14; ++i) a[i] = c2[i];
  const float s = sum14(a);
#pragma unroll
  for (int i = 0; i < kN; ++i) y[i * B + b] = add(x[i * B + b], s);
}

}  // namespace

// probe 0-6 = A-G.  x (6, B); aux: g (6,) for F, the (7, 2) constant for G,
// else unused; y: float32 (6, B), (H, 6, B) or (B,), int32 (B,) for E.
// Geometry (probe_geometry in ops/kernels/scaffold_probes.py): threads a
// block, a grid of blocks_x x blocks_y; for B, h_per steps a block row and
// vec (4 or 1) floats a thread.
extern "C" int lqrrt_scaffold_probe(const float* x, const float* aux,
                                    void* y, int probe, int B, int H,
                                    int threads, int blocks_x, int blocks_y,
                                    int h_per, int vec, void* stream) {
  const long long n = 6LL * B;   // the elements of x
  const long long cover = (long long)blocks_x * threads;
  const bool ok =
      threads >= 32 && threads <= 1024 && threads % 32 == 0 &&
      blocks_y >= 1 && (probe == 1 || blocks_y == 1) &&
      (probe != 1 || ((vec == 1 || vec == 4) && n % vec == 0 &&
                      cover * vec >= n && h_per >= 1 &&
                      (long long)blocks_y * h_per >= H)) &&
      (probe != 2 || cover >= n) && (probe == 1 || probe == 2 || cover >= B);
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_x, blocks_y);
  float* yf = static_cast<float*>(y);
  int* yi = static_cast<int*>(y);
  switch (probe) {
    case 0: probe_a_kernel<<<grid, threads, 0, s>>>(x, yf, B); break;
    case 1:
      if (vec == 4)
        probe_b_kernel<<<grid, threads, 0, s>>>(
            reinterpret_cast<const float4*>(x), reinterpret_cast<float4*>(yf),
            static_cast<int>(n / 4), H, h_per);
      else
        probe_b_kernel<<<grid, threads, 0, s>>>(x, yf, static_cast<int>(n), H,
                                                h_per);
      break;
    case 2:
      probe_c_kernel<<<grid, threads, 0, s>>>(x, yf, static_cast<int>(n), H);
      break;
    case 3: probe_d_kernel<<<grid, threads, 0, s>>>(x, yf, B); break;
    case 4: probe_e_kernel<<<grid, threads, 0, s>>>(x, yi, B, H); break;
    case 5: probe_f_kernel<<<grid, threads, 0, s>>>(x, aux, yf, B); break;
    case 6: probe_g_kernel<<<grid, threads, 0, s>>>(x, aux, yf, B); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
