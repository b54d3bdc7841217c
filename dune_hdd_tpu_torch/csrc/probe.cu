// probe: o = 2 x + y elementwise on float32 tensors of any size.
//
// Replaces the TPU kernel scripts/pallas_minimal_repro.py:7 `kern`, a
// compile probe for the Pallas toolchain on a [64, 128] tile.  Here it is
// the smallest kernel of the build route: nvcc, the plain C interface,
// ctypes, and a check of the launch.
//
// What bounds it: bytes (12 B moved per element, 2 flops).  So the design
// is about bytes in flight and about the last wave:
//
// * 16-byte accesses.  Each block owns one tile of kThreads * kUnroll
//   float4s; each thread loads its kUnroll float4 of x and of y (LDG.128,
//   neighbouring threads on neighbouring addresses) before it stores any
//   (STG.128).
// * The grid is one tile per block, sized from n.  A grid of the card's
//   resident capacity (SMs times blocks per SM) walking the range in a
//   grid-stride loop was slower on an H100 at 2^24 elements: its last pass
//   leaves SMs idle (PERF.md, the probe's findings).
// * Cache hints: stores are evict-first (__stcs), since nothing reads o
//   again; loads keep the default path, because evict-first loads
//   (__ldcs) were slower there too.
// * A scalar head (elements before o's first 16-byte boundary) and a
//   scalar tail (the (n - head) mod 4 elements after the last float4) run
//   in block 0 of the same kernel, so any contiguous view is a legal input.
// * Alignment: a float4 access needs x, y and o at the same offset modulo
//   16 bytes.  The kernel checks the three pointers; when their offsets
//   differ (for example x[1:] beside a fresh y), every block takes the
//   scalar loop of the same kernel over its 4 * kUnroll * kThreads
//   elements.  The host function reports which path ran, and the wrapper
//   counts scalar launches on their own.
//
// 2x and the sum are rounded separately (__fmul_rn, __fadd_rn: no
// contraction into an FMA), as `2 * x + y` rounds them, so kernel and plain
// version agree bitwise.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // float4 per input per thread
constexpr long long kTileElements = 4LL * kUnroll * kThreads;

__host__ __device__ inline bool vector_aligned(const void* x, const void* y, const void* o) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(o) & 15;
  return ((reinterpret_cast<uintptr_t>(x) & 15) == a) &&
         ((reinterpret_cast<uintptr_t>(y) & 15) == a);
}

__device__ __forceinline__ float axpy2(float x, float y) {
  return __fadd_rn(__fmul_rn(2.0f, x), y);
}

__global__ void __launch_bounds__(kThreads)
probe_kernel(const float* __restrict__ x, const float* __restrict__ y,
             float* __restrict__ o, long long n) {
  if (!vector_aligned(x, y, o)) {  // offsets differ modulo 16: all scalar
    const long long base = blockIdx.x * kTileElements + threadIdx.x;
    float a[4 * kUnroll], b[4 * kUnroll];
#pragma unroll
    for (int u = 0; u < 4 * kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < n) {
        a[u] = x[i];
        b[u] = y[i];
      }
    }
#pragma unroll
    for (int u = 0; u < 4 * kUnroll; ++u) {
      const long long i = base + u * kThreads;
      if (i < n) __stcs(o + i, axpy2(a[u], b[u]));
    }
    return;
  }

  // scalar head: up to o's first 16-byte boundary (0-3 elements)
  long long head = (long long)((16 - (reinterpret_cast<uintptr_t>(o) & 15)) & 15) / 4;
  if (head > n) head = n;
  const long long nv = (n - head) / 4;
  if (blockIdx.x == 0) {
    if (threadIdx.x < head) {
      __stcs(o + threadIdx.x, axpy2(x[threadIdx.x], y[threadIdx.x]));
    }
    // scalar tail: the (n - head) mod 4 elements after the last float4
    const long long t = head + 4 * nv + threadIdx.x;
    if (t < n) __stcs(o + t, axpy2(x[t], y[t]));
  }

  const float4* __restrict__ x4 = reinterpret_cast<const float4*>(x + head);
  const float4* __restrict__ y4 = reinterpret_cast<const float4*>(y + head);
  float4* __restrict__ o4 = reinterpret_cast<float4*>(o + head);
  const long long base = (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  float4 a[kUnroll], b[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {  // every load before any store
    const long long i = base + u * kThreads;
    if (i < nv) {
      a[u] = x4[i];
      b[u] = y4[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = base + u * kThreads;
    if (i < nv) {
      __stcs(o4 + i, make_float4(axpy2(a[u].x, b[u].x), axpy2(a[u].y, b[u].y),
                                 axpy2(a[u].z, b[u].z), axpy2(a[u].w, b[u].w)));
    }
  }
}

}  // namespace

// C interface for ctypes.  Writes 1 to *vector_path if the float4 path runs
// (0 if the whole range is scalar) and returns cudaGetLastError() after the
// launch.
extern "C" int probe_f32(const void* x, const void* y, void* o, long long n,
                         int device, void* stream, int* vector_path) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  *vector_path = vector_aligned(x, y, o) ? 1 : 0;
  if (n == 0) return 0;
  const long long blocks = (n + kTileElements - 1) / kTileElements;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  probe_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)o, n);
  return (int)cudaGetLastError();
}
