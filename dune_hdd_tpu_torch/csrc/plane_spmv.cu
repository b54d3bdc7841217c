// plane_spmv: the structured block SpMV of the SWIPDG stencil operator.
//
//   Y[i, k, y, x] = sum_{s=0..3} sum_j W[s, i, j, k, y, x] * X_s[j, k, y, x]
//   X_0 = X,  X_{s+1}[j, k, y, x] = X[j, ks, (y+dy) mod KY, (x+dx) mod KX]
//   with (ks, dy, dx) = plan[k][s]
//
// W is [4, 3, 3, 8, KY, KX] (slot 0 = the cell's own block), X and Y are
// [3, 8, KY, KX], all contiguous; this is StencilBlockEll.matvec of the
// reference package (dune_hdd_tpu/la/stencil.py:190-207).
//
// Replaces the two TPU kernels of the same SpMV:
//   * dune_hdd_tpu/la/pallas_spmv.py:32 build_structured_pallas_matvec
//     (flat-modulo wrap; agrees wherever the wrapped blocks are zero, which
//     holds for every assembled operator);
//   * scripts/pallas_plane_repro.py:83 build_pallas_matvec (plane layout,
//     per-axis wrap: the semantics held to here).
//
// What bounds it: bytes.  Each lattice site reads its 36 plane values
// (144 B in f32, 288 B in f64) and 12 X values and writes 3; the operator
// planes are ~80% of the traffic and are touched exactly once per call, so
// the kernel is a stream at device-memory bandwidth (36 flops per 36 plane
// loads is far below the H100's flop:byte balance).
//
// What this simple design does about it: one thread per (k, y, x) site,
// consecutive threads on consecutive x, so every plane load and the
// unshifted X loads coalesce, and each plane value is read exactly once.
// The shifted X reads hit lines that neighbouring warps also read, so they
// come mostly from L1/L2.  The terms are summed in the plain version's
// order (s, then j), so only FMA contraction separates the two results.
#include <cuda_runtime.h>

namespace {

struct Plan {
  int ks[8][3];
  int dy[8][3];
  int dx[8][3];
};

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

template <typename T>
__global__ void plane_spmv_kernel(const T* __restrict__ W,
                                  const T* __restrict__ X,
                                  T* __restrict__ Y, int KY, int KX,
                                  Plan plan) {
  const long long L = (long long)KY * KX;
  const long long n = 8 * L;
  const long long site = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (site >= n) return;
  const int k = (int)(site / L);
  const long long yx = site - (long long)k * L;
  const int y = (int)(yx / KX);
  const int x = (int)(yx - (long long)y * KX);

  // flat offsets (within one [8, KY, KX] field) of the four source sites
  long long src[4];
  src[0] = site;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    const int ys = wrap(y + plan.dy[k][s], KY);
    const int xs = wrap(x + plan.dx[k][s], KX);
    src[s + 1] = (long long)plan.ks[k][s] * L + (long long)ys * KX + xs;
  }
  T xv[4][3];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int j = 0; j < 3; ++j) xv[s][j] = X[j * n + src[s]];
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    T acc = T(0);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        acc += W[((s * 3 + i) * 3 + j) * n + site] * xv[s][j];
      }
    }
    Y[i * n + site] = acc;
  }
}

template <typename T>
int launch(const void* W, const void* X, void* Y, int KY, int KX,
           const int* plan_flat, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Plan plan;
  for (int k = 0; k < 8; ++k) {
    for (int s = 0; s < 3; ++s) {
      plan.ks[k][s] = plan_flat[(k * 3 + s) * 3 + 0];
      plan.dy[k][s] = plan_flat[(k * 3 + s) * 3 + 1];
      plan.dx[k][s] = plan_flat[(k * 3 + s) * 3 + 2];
    }
  }
  const long long n = 8LL * KY * KX;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  plane_spmv_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)W, (const T*)X, (T*)Y, KY, KX, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes.  plan_flat: 72 host ints, (ks, dy, dx) for
// (k, s) in row-major order.  Returns cudaGetLastError() after the launch.
extern "C" int plane_spmv_f32(const void* W, const void* X, void* Y, int KY,
                              int KX, const int* plan_flat, int device,
                              void* stream) {
  return launch<float>(W, X, Y, KY, KX, plan_flat, device, stream);
}

extern "C" int plane_spmv_f64(const void* W, const void* X, void* Y, int KY,
                              int KX, const int* plan_flat, int device,
                              void* stream) {
  return launch<double>(W, X, Y, KY, KX, plan_flat, device, stream);
}
