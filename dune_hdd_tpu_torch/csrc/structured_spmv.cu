// structured_spmv: the block-ELL SpMV in the structured (bandwidth-ordered)
// cell numbering, with a flat cell-major vector.
//
//   y[c, i] = sum_{s=0..3} sum_j B[s, i, j, c] * x[src_s(c), j]
//   src_0(c) = c,  src_{s+1}(c) = (c + off[k][s]) mod nc,  k = c / (nc / 8)
//
// B is the [4, ND, ND, nc] SoA plane repack of StructuredBlockEll.blocks
// [nc, 4, ND, ND] (slot 0 = the cell's own block), x and y are [nc * ND]
// cell-major, all float32 and contiguous; ND is the number of DoF per cell,
// 3, 6 or 10 (DG P1, P2, P3 on triangles; the Pallas kernel takes any);
// off[k][s] is taken modulo nc on the host.  This is
// StructuredBlockEll.matvec of the reference package
// (dune_hdd_tpu/la/block_ell.py:171-191).
//
// Replaces the TPU kernel dune_hdd_tpu/la/pallas_spmv.py:32
// build_structured_pallas_matvec.  That kernel rolls over the cell count
// padded to 1024, so wherever nc is not a multiple of 1024 a read that
// wraps lands in the zero padding; here every read wraps modulo nc, the
// semantics of StructuredBlockEll.matvec.  The two agree where nc is a
// multiple of 1024.
//
// What bounds it: bytes.  Each cell reads its 4 ND^2 block values and 4 ND
// x values and writes ND: a stream over the blocks at device-memory
// bandwidth, one multiply-add per block load.
//
// What this simple design does about it: one thread per cell, consecutive
// threads on consecutive cells, so every block-plane load coalesces and
// each block value is read exactly once; the x reads of neighbouring
// threads share cache lines.  Offsets into the planes are 64-bit.  The
// terms are summed in (s, j) order, the order of plane_spmv, so on an
// assembled operator in both layouts the two kernels agree bitwise.
#include <cuda_runtime.h>

namespace {

struct Offsets {
  long long off[8][3];  // in [0, nc)
};

template <int ND>
__global__ void structured_spmv_kernel(const float* __restrict__ B,
                                       const float* __restrict__ x,
                                       float* __restrict__ y, long long nc,
                                       Offsets offsets) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= nc) return;
  const int k = (int)(c / (nc / 8));
  long long src[4];
  src[0] = c;
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    long long t = c + offsets.off[k][s];
    src[s + 1] = t >= nc ? t - nc : t;
  }
  float xv[4][ND];
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int j = 0; j < ND; ++j) xv[s][j] = x[src[s] * ND + j];
  }
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    float acc = 0.0f;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
#pragma unroll
      for (int j = 0; j < ND; ++j) {
        acc += B[((long long)(s * ND + i) * ND + j) * nc + c] * xv[s][j];
      }
    }
    y[c * ND + i] = acc;
  }
}

template <int ND>
int launch(const void* B, const void* x, void* y, long long nc,
           const long long* off_flat, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Offsets offsets;
  for (int k = 0; k < 8; ++k) {
    for (int s = 0; s < 3; ++s) offsets.off[k][s] = off_flat[k * 3 + s];
  }
  const int threads = 256;
  const unsigned blocks = (unsigned)((nc + threads - 1) / threads);
  structured_spmv_kernel<ND><<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)B, (const float*)x, (float*)y, nc, offsets);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per ND: structured_spmv_f32 (ND = 3),
// structured_spmv_nd6_f32, structured_spmv_nd10_f32.  off_flat: 24 host
// ints, off[k][s] in row-major order, each in [0, nc); nc a multiple of 8.
// Returns cudaGetLastError() after the launch.
#define STRUCTURED_SPMV_ENTRY(NAME, ND)                                      \
  extern "C" int NAME(const void* B, const void* x, void* y, long long nc,   \
                      const long long* off_flat, int device, void* stream) { \
    return launch<ND>(B, x, y, nc, off_flat, device, stream);                \
  }

STRUCTURED_SPMV_ENTRY(structured_spmv_f32, 3)
STRUCTURED_SPMV_ENTRY(structured_spmv_nd6_f32, 6)
STRUCTURED_SPMV_ENTRY(structured_spmv_nd10_f32, 10)
