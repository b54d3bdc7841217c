// sym_plane_spmv: the half-storage symmetric SpMV of the SWIPDG stencil
// operator.
//
// W is [4, ND, ND, 8, KY, KX] (slot 0 = the cell's own block), X and Y are
// [ND, 8, KY, KX], all contiguous; ND is 3, 6 or 10 (DG P1, P2, P3 on
// triangles).  Of W only the upper triangle of each self block and the 12
// forward-edge plane sets are read, and each stored plane is applied twice:
// forward at its own subclass, and transposed at the reverse slot of the
// neighbour it couples to.  For output (i, k) at site (y, x):
//
//   Y[i] = sum_j W[0, min(i,j), max(i,j), k] X[j, k]                (j ascending)
//        + per term m = 0, 1, 2 of subclass k, in the host's order:
//            forward:  sum_j W[s+1, i, j, k](y, x)   X[j, kn](y+dy, x+dx)
//            reverse:  sum_j W[s+1, j, i, kn](y+dy, x+dx) X[j, kn](y+dy, x+dx)
//
// with (kn, dy, dx) = plan[k][slot] and both lattice axes wrapping as in
// torch.roll.  The host (kernels/sym_plane_spmv.py sym_geometry) lists each
// subclass's three terms in the order in which the reference adds them,
// which is the order of its forward-edge list.
//
// Replaces StencilBlockEll._matvec_sym of the reference package
// (dune_hdd_tpu/la/stencil.py:209-260): an XLA function, not a Pallas
// kernel, applied on every PCG iteration and every f64 refinement residual
// of the bench from 3.07M DoF up.
//
// What bounds it: bytes.  Per cell it must read nd(nd+1)/2 self values and
// 12 nd^2 / 8 = 1.5 nd^2 forward plane values (19.5 at nd 3, against the
// full operator's 36), plus X and Y; one multiply and one add per value
// read twice, far below the card's flop:byte balance.  The least time is
// those bytes over 3.35 TB/s.
//
// The design is the simple one: one thread per (site, subclass), a block of
// 32 consecutive columns of one lattice row times the 8 subclasses, so a
// warp is one subclass (its terms are uniform) on 32 consecutive sites (its
// plane and X reads coalesce, shifted ones over two segments).  Every value
// is read from global memory; a reverse term reads a plane that another
// thread, a few rows or columns away, reads forward at about the same
// time, so the second read is served by L2 and the planes cross device
// memory about once.  No atomics: each output is gathered by its thread.
//
// The same arithmetic as the plain version: every product and every sum is
// rounded on its own (__fmul_rn / __fadd_rn, no contraction into a fused
// multiply-add), in the same order, so the result is bitwise the plain
// version's.
#include <cuda_runtime.h>

#include <cstdint>

// The host's table (kernels/sym_plane_spmv.py SymGeometry), passed by value.
struct SymGeometry {
  int KY, KX;
  int terms[8][3][5];  // per (subclass k, term m): forward, stored slot s, kn,
                       // dy mod KY, dx mod KX
};

namespace {

constexpr int kThreadsX = 32;  // columns of a block; threadIdx.y is the subclass

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// v + d modulo n for 0 <= v, d < n
__device__ __forceinline__ int wrap(int v, int d, int n) {
  return v + d >= n ? v + d - n : v + d;
}

template <int ND, typename T>
__global__ void __launch_bounds__(kThreadsX * 8)
    sym_plane_spmv_kernel(const T* __restrict__ W, const T* __restrict__ X, T* __restrict__ Y,
                          const __grid_constant__ SymGeometry g) {
  const int x = blockIdx.x * kThreadsX + threadIdx.x;
  const int y = blockIdx.y;
  const int k = threadIdx.y;
  if (x >= g.KX) return;
  const long long L = (long long)g.KY * g.KX;  // values per (plane, subclass)
  const long long P = 8 * L;                    // values per plane
  const long long site = (long long)y * g.KX + x;

  // self terms: the upper triangle used both ways
  T xv[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) xv[j] = __ldg(X + j * P + k * L + site);
  const T* w0 = W + k * L + site;  // W[0, i, j, k] at w0[(i ND + j) P]
  T acc[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T t = mul_rn(__ldg(w0 + (long long)i * P), xv[0]);  // W[0, 0, i]
#pragma unroll
    for (int j = 1; j < ND; ++j) {
      const int lo = i < j ? i : j, hi = i < j ? j : i;
      t = add_rn(t, mul_rn(__ldg(w0 + (long long)(lo * ND + hi) * P), xv[j]));
    }
    acc[i] = t;
  }

  // the three edge terms, in the reference's order
#pragma unroll
  for (int m = 0; m < 3; ++m) {
    const int* e = g.terms[k][m];
    const int fwd = e[0], s = e[1], kn = e[2];
    const long long nsite = (long long)wrap(y, e[3], g.KY) * g.KX + wrap(x, e[4], g.KX);
#pragma unroll
    for (int j = 0; j < ND; ++j) xv[j] = __ldg(X + j * P + kn * L + nsite);
    const T* ws = W + (long long)(s + 1) * ND * ND * P;
    if (fwd) {  // W[s+1, i, j, k] at the own site
      const T* w = ws + k * L + site;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        T t = mul_rn(__ldg(w + (long long)(i * ND) * P), xv[0]);
#pragma unroll
        for (int j = 1; j < ND; ++j) {
          t = add_rn(t, mul_rn(__ldg(w + (long long)(i * ND + j) * P), xv[j]));
        }
        acc[i] = add_rn(acc[i], t);
      }
    } else {  // W[s+1, j, i, kn] at the neighbour site: the transpose
      const T* w = ws + kn * L + nsite;
#pragma unroll
      for (int i = 0; i < ND; ++i) {
        T t = mul_rn(__ldg(w + (long long)i * P), xv[0]);
#pragma unroll
        for (int j = 1; j < ND; ++j) {
          t = add_rn(t, mul_rn(__ldg(w + (long long)(j * ND + i) * P), xv[j]));
        }
        acc[i] = add_rn(acc[i], t);
      }
    }
  }

  T* out = Y + k * L + site;
#pragma unroll
  for (int i = 0; i < ND; ++i) out[i * P] = acc[i];
}

template <int ND, typename T>
int launch(const void* W, const void* X, void* Y, const SymGeometry* g, int device,
           void* stream) {
  if (g->KY < 1 || g->KY > 65535 || g->KX < 1 || 8LL * g->KY * g->KX >= (1LL << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  for (int k = 0; k < 8; ++k) {
    for (int m = 0; m < 3; ++m) {
      const int* e = g->terms[k][m];
      if ((e[0] != 0 && e[0] != 1) || e[1] < 0 || e[1] > 2 || e[2] < 0 || e[2] > 7 ||
          e[3] < 0 || e[3] >= g->KY || e[4] < 0 || e[4] >= g->KX) {
        return (int)cudaErrorInvalidValue;
      }
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((g->KX + kThreadsX - 1) / kThreadsX, g->KY);
  sym_plane_spmv_kernel<ND, T><<<grid, dim3(kThreadsX, 8), 0, (cudaStream_t)stream>>>(
      (const T*)W, (const T*)X, (T*)Y, *g);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per (ND, dtype): sym_plane_spmv_nd3_f32
// ... sym_plane_spmv_nd10_f64.  geometry: the host's SymGeometry.  Returns
// cudaErrorInvalidValue for a geometry the kernel does not take, else
// cudaGetLastError() after the launch.
#define SYM_PLANE_SPMV_ENTRY(NAME, ND, T)                                                  \
  extern "C" int NAME(const void* W, const void* X, void* Y, const SymGeometry* geometry, \
                      int device, void* stream) {                                        \
    return launch<ND, T>(W, X, Y, geometry, device, stream);                             \
  }

SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd3_f32, 3, float)
SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd3_f64, 3, double)
SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd6_f32, 6, float)
SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd6_f64, 6, double)
SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd10_f32, 10, float)
SYM_PLANE_SPMV_ENTRY(sym_plane_spmv_nd10_f64, 10, double)
