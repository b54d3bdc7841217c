// probe: o = 2 x + y elementwise on float32 tensors of any size.
//
// Replaces the TPU kernel scripts/pallas_minimal_repro.py:7 `kern`, a
// compile probe for the Pallas toolchain on a [64, 128] tile.  Here it is
// the smallest kernel of the build route: nvcc, the plain C interface,
// ctypes, and a check of the launch.
//
// What bounds it: bytes (12 B moved per element, 2 flops).  One thread
// per element in a grid-stride loop, consecutive threads on consecutive
// elements.  2x and the sum are rounded separately (__fmul_rn, __fadd_rn:
// no contraction), as `2 * x + y` rounds them, so kernel and plain version
// agree bitwise.
#include <cuda_runtime.h>

namespace {

__global__ void probe_kernel(const float* __restrict__ x,
                             const float* __restrict__ y,
                             float* __restrict__ o, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    o[i] = __fadd_rn(__fmul_rn(2.0f, x[i]), y[i]);
  }
}

}  // namespace

// C interface for ctypes.  Returns cudaGetLastError() after the launch.
extern "C" int probe_f32(const void* x, const void* y, void* o, long long n,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n == 0) return 0;
  const int threads = 256;
  long long want = (n + threads - 1) / threads;
  const unsigned blocks = (unsigned)(want < 65536 ? want : 65536);
  probe_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (float*)o, n);
  return (int)cudaGetLastError();
}
