// plane_spmv: the structured block SpMV of the SWIPDG stencil operator.
//
//   Y[i, k, y, x] = sum_{s=0..3} sum_j W[s, i, j, k, y, x] * X_s[j, k, y, x]
//   X_0 = X,  X_{s+1}[j, k, y, x] = X[j, ks, (y+dy) mod KY, (x+dx) mod KX]
//   with (ks, dy, dx) = plan[k][s]
//
// W is [4, ND, ND, 8, KY, KX] (slot 0 = the cell's own block), X and Y are
// [ND, 8, KY, KX], all contiguous; ND is the number of DoF per cell: 3, 6
// or 10 (DG P1, P2, P3 on triangles).  This is StencilBlockEll.matvec of
// the reference package (dune_hdd_tpu/la/stencil.py:190-207).
//
// Replaces the two TPU kernels of the same SpMV, which take any ND:
//   * dune_hdd_tpu/la/pallas_spmv.py:32 build_structured_pallas_matvec
//     (flat-modulo wrap; agrees wherever the wrapped blocks are zero, which
//     holds for every assembled operator);
//   * scripts/pallas_plane_repro.py:83 build_pallas_matvec (plane layout,
//     per-axis wrap: the semantics held to here).
//
// What bounds it: bytes.  Each lattice site reads its 4 ND^2 plane values
// and 4 ND X values and writes ND; the operator planes are 80-90% of the
// traffic and are touched exactly once per call, so the kernel is a stream
// at device-memory bandwidth (one multiply-add per plane load is far below
// the H100's flop:byte balance, at every ND).
//
// What this simple design does about it: one thread per (k, y, x) site,
// consecutive threads on consecutive x, so every plane load and the
// unshifted X loads coalesce, and each plane value is read exactly once.
// The shifted X reads hit lines that neighbouring warps also read, so they
// come mostly from L1/L2.  The terms of each Y[i] are summed in the plain
// version's order (s, then j), so only FMA contraction separates the two
// results.
//
// Registers: the site's 4 ND source values are loaded up front (the ND = 3
// kernel's original layout) while they fit in 64 registers.  Above that
// (ND = 10 in f64: 80 registers for the sources alone) the loop runs slot by
// slot: ND accumulators, and the ND source values of one slot at a time.
// Each Y[i] is still summed in (s, j) order, so both layouts give the same
// result.
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

template <int ND, typename T>
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
  constexpr bool kSlotOuter = 4 * ND * sizeof(T) > 64 * 4;
  if constexpr (!kSlotOuter) {
    T xv[4][ND];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < ND; ++j) xv[s][j] = X[j * n + src[s]];
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      T acc = T(0);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc += W[((s * ND + i) * ND + j) * n + site] * xv[s][j];
        }
      }
      Y[i * n + site] = acc;
    }
  } else {
    T acc[ND];
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[i] = T(0);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      T xv[ND];
#pragma unroll
      for (int j = 0; j < ND; ++j) xv[j] = X[j * n + src[s]];
#pragma unroll
      for (int i = 0; i < ND; ++i) {
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[i] += W[((s * ND + i) * ND + j) * n + site] * xv[j];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) Y[i * n + site] = acc[i];
  }
}

template <int ND, typename T>
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
  plane_spmv_kernel<ND, T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const T*)W, (const T*)X, (T*)Y, KY, KX, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per (ND, dtype): plane_spmv_f32 and
// plane_spmv_f64 (ND = 3), plane_spmv_nd6_f32 ... plane_spmv_nd10_f64.
// plan_flat: 72 host ints, (ks, dy, dx) for (k, s) in row-major order.
// Returns cudaGetLastError() after the launch.
#define PLANE_SPMV_ENTRY(NAME, ND, T)                                        \
  extern "C" int NAME(const void* W, const void* X, void* Y, int KY, int KX, \
                      const int* plan_flat, int device, void* stream) {      \
    return launch<ND, T>(W, X, Y, KY, KX, plan_flat, device, stream);        \
  }

PLANE_SPMV_ENTRY(plane_spmv_f32, 3, float)
PLANE_SPMV_ENTRY(plane_spmv_f64, 3, double)
PLANE_SPMV_ENTRY(plane_spmv_nd6_f32, 6, float)
PLANE_SPMV_ENTRY(plane_spmv_nd6_f64, 6, double)
PLANE_SPMV_ENTRY(plane_spmv_nd10_f32, 10, float)
PLANE_SPMV_ENTRY(plane_spmv_nd10_f64, 10, double)
