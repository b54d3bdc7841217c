// block_jacobi: the block-Jacobi apply of the stencil smoother.
//
//   Z[i, c] = sum_{j=0..ND-1} Dinv[i, j, c] * R[j, c]
//
// over the C = 8 KY KX sites c of the plane layout.  Dinv is [ND, ND, 8,
// KY, KX] (the inverse diagonal blocks, one contiguous plane per (i, j)),
// R and Z are [ND, 8, KY, KX], all contiguous; ND is 3, 6 or 10 (DG P1, P2,
// P3 on triangles).  This is the apply of jacobi_smoother
// (la/stencil.py).
//
// Replaces no Pallas kernel: the reference package's apply
// (dune_hdd_tpu/la/stencil.py:277 jacobi_smoother) is an XLA contraction.
// In PyTorch the same loop over (i, j) was ND^2 elementwise kernels on a
// strided view of Dinv (one plane's values ND^2 elements apart, so each
// 32-byte sector fetched served one value), ND - 1 temporaries a row
// written and read again, and a stack that copied the rows once more:
// 8.5x its bound at the 2D snapshot shape.
//
// What bounds it: bytes.  Each site reads ND^2 values of Dinv and ND of R
// and writes ND of Z, against 2 ND^2 - ND flops: 0.15 flop a byte at ND 3
// in float64, far below the card's balance.  At ND 3 and 256 x 256 in
// float64 (C = 524,288) that is 62.91 MB, 18.8 us at 3.35 TB/s; at 160 x
// 800 in float32 (C = 1,024,000) 61.44 MB, 18.3 us.
//
// The design moves those bytes once, at the rate of a plain stream:
// 1. One thread owns V adjacent sites and reads each plane with one
//    16-byte load (V = 2 in float64, 4 in float32), so a warp reads 512
//    consecutive bytes of a plane per load; with C a multiple of 8 (8
//    subclasses), every plane starts 16-byte aligned when the tensors do.
//    Inputs at another offset take the same kernel with V = 1.
// 2. Loads are issued before the arithmetic that needs them: R's ND
//    vectors, then Dinv's rows in batches of kRows (all 3 rows at ND 3: 12
//    independent 16-byte loads a thread in flight; 2 rows at ND 6, 1 at ND
//    10, which keeps the batch in registers).
// 3. Nothing is reused across sites, so nothing is staged: no shared
//    memory, no TMA.  The grid covers C / V threads in one pass of blocks
//    of 256; Dinv is read with the evict-first hint (ld.global.cs), since
//    the loop's next read of it is one iteration away, and Z is stored
//    plainly, to be found in L2 by the dot that reads it next.
// 4. The rounding of the plain version: each Z[i] is Dinv[i, 0] R[0], then
//    one fused multiply-add per further j in j order (PyTorch's addcmul on
//    the card rounds as one fma), so Z is bitwise the plain version's on
//    the card and every PCG iterate is unchanged.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// V values of T in one load: 16 bytes, or one value
template <typename T, int V> struct Lanes;
template <> struct Lanes<float, 4> { using type = float4; };
template <> struct Lanes<double, 2> { using type = double2; };
template <> struct Lanes<float, 1> { using type = float; };
template <> struct Lanes<double, 1> { using type = double; };

template <int ND, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    block_jacobi_kernel(const T* __restrict__ Dinv, const T* __restrict__ R, T* __restrict__ Z,
                        int C) {
  using L = typename Lanes<T, V>::type;
  // Dinv rows loaded together: with R's ND vectors, 12 or more loads in flight
  constexpr int kRows = 12 / ND >= ND ? ND : (12 / ND > 0 ? 12 / ND : 1);
  static_assert(ND % kRows == 0, "row batches");
  const int c = (blockIdx.x * kThreads + threadIdx.x) * V;
  if (c >= C) return;

  L r[ND];
#pragma unroll
  for (int j = 0; j < ND; ++j) r[j] = __ldg(reinterpret_cast<const L*>(R + j * C + c));
#pragma unroll
  for (int i0 = 0; i0 < ND; i0 += kRows) {
    L d[kRows][ND];
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        d[ii][j] = __ldcs(reinterpret_cast<const L*>(Dinv + ((i0 + ii) * ND + j) * C + c));
      }
    }
#pragma unroll
    for (int ii = 0; ii < kRows; ++ii) {
      L z;
      T* zl = reinterpret_cast<T*>(&z);
#pragma unroll
      for (int l = 0; l < V; ++l) {
        T t = reinterpret_cast<const T*>(&d[ii][0])[l] * reinterpret_cast<const T*>(&r[0])[l];
#pragma unroll
        for (int j = 1; j < ND; ++j) {
          t = fma(reinterpret_cast<const T*>(&d[ii][j])[l], reinterpret_cast<const T*>(&r[j])[l],
                  t);
        }
        zl[l] = t;
      }
      *reinterpret_cast<L*>(Z + (i0 + ii) * C + c) = z;
    }
  }
}

template <int ND, typename T>
int launch(const void* Dinv, const void* R, void* Z, int C, int vector, int device,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(Dinv) | reinterpret_cast<uintptr_t>(R) |
        reinterpret_cast<uintptr_t>(Z)) % 16 == 0) && C % V == 0;
  if (C <= 0 || (long long)ND * ND * C >= (1LL << 31) || (vector && !aligned)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (vector) {
    const int groups = C / V;
    block_jacobi_kernel<ND, T, V><<<(groups + kThreads - 1) / kThreads, kThreads, 0,
                                    (cudaStream_t)stream>>>((const T*)Dinv, (const T*)R,
                                                            (T*)Z, C);
  } else {
    block_jacobi_kernel<ND, T, 1><<<(C + kThreads - 1) / kThreads, kThreads, 0,
                                    (cudaStream_t)stream>>>((const T*)Dinv, (const T*)R,
                                                            (T*)Z, C);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per (ND, dtype): block_jacobi_nd3_f32
// ... block_jacobi_nd10_f64.  C: sites (8 KY KX); vector: 1 for the
// 16-byte path (Dinv, R and Z 16-byte aligned, C a multiple of V), 0 for
// one value a thread.  Returns cudaErrorInvalidValue for sizes or a path
// the kernel does not take, else cudaGetLastError() after the launch.
#define BLOCK_JACOBI_ENTRY(NAME, ND, T)                                                   \
  extern "C" int NAME(const void* Dinv, const void* R, void* Z, int C, int vector,       \
                      int device, void* stream) {                                         \
    return launch<ND, T>(Dinv, R, Z, C, vector, device, stream);                          \
  }

BLOCK_JACOBI_ENTRY(block_jacobi_nd3_f32, 3, float)
BLOCK_JACOBI_ENTRY(block_jacobi_nd3_f64, 3, double)
BLOCK_JACOBI_ENTRY(block_jacobi_nd6_f32, 6, float)
BLOCK_JACOBI_ENTRY(block_jacobi_nd6_f64, 6, double)
BLOCK_JACOBI_ENTRY(block_jacobi_nd10_f32, 10, float)
BLOCK_JACOBI_ENTRY(block_jacobi_nd10_f64, 10, double)
