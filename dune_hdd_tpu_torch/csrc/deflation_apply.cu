// deflation_apply: the fine level of the two-level deflation apply in the
// plane layout (kernels/deflation_apply.py, la/stencil.py
// stencil_deflation_preconditioner).
//
// With the weighted aggregation Z_w = diag(w) Z onto an (my, mx) lattice of
// fy x fx sites (agg(y, x) = (y / fy, x / fx)), the weighted AZ planes
// AZ [4, ND, 8, KY, KX] (slot 0 = self) and the block-Jacobi inverse Dinv
// [ND, ND, 8, KY, KX], one apply M^-1 R = Z_w y1 + S - Z_w y2 is four passes
// around the two coarse solves:
//
//   pass 0  rc = Z_w^T R                                  (two launches)
//   pass 1  S  = Dinv (R - A Z_w y1)                      (one launch)
//   pass 2  T  = R - A Z_w y1, for a caller's smoother    (one launch)
//   pass 3  rc = Z_w^T A S                                (two launches)
//   pass 4  out = (w y1[agg] + S) - w y2[agg]             (one launch)
//
// Every lattice index wraps modulo (KY, KX), as torch.roll does.  The
// coarse vectors y1, y2 and rc are read and written through element strides
// (sy, sx) of the aggregate (ay, ax): x-major flat (1, my) for the dense and
// BCR coarse solves, (mx, 1) for a [my, mx] middle lattice.
//
// Replaces no Pallas kernel: the reference package's apply
// (dune_hdd_tpu/la/stencil.py stencil_deflation_preconditioner) is XLA.  In
// PyTorch the same closures were ~90 small kernels an apply: 48 rolls and 6
// stacks of [8, KY, KX] fields, broadcasts of the coarse vectors to full
// fields, and the elementwise glue, 0.55 ms at the OS2014 shape, ~8x its
// bytes.
//
// What bounds it: bytes.  An apply reads R and w, then AZ, R and Dinv and
// writes S, then reads AZ and S, then S and w and writes the result: at ND 3
// and 256 x 256 in float64 ~239 MB, ~71 us at 3.35 TB/s, with ~0.1 flop a
// byte.  The design moves each array once a pass:
// 1. The broadcast field B0 = Z y1 and its slot-shifted copies never exist:
//    the residual pass reads y1 at the aggregate of each site's slot-s
//    neighbour, (y + dy, x + dx), from the tiny coarse vector (L1).
// 2. Z_w^T A S is a gather at the target, as in sym_plane_spmv.cu: the site
//    (ks, y, x) adds, per slot, the pairing sum_i AZ[s+1, i, k] S[i, k] of
//    its source (k, y - dy, x - dx), k the unique subclass with
//    plan[k][s][0] = ks (checked bijective at build time).  No scatter, no
//    atomics.
// 3. The aggregate sums (passes 0 and 3) are two deterministic launches: in
//    the first, one thread per (aggregate row, chunk of `ch` (subclass, row)
//    pairs, lattice column) sums its sites in pair order, adjacent threads on
//    adjacent columns (coalesced whatever fx is), then the `lw` adjacent
//    columns of one aggregate are summed by a fixed shuffle tree; the
//    second sums each aggregate's nch * fx / lw partials in a fixed order
//    (`group` threads, a fixed shared-memory tree) and writes the coarse
//    vector in the layout the coarse solve reads.  The geometry (nch, ch,
//    lw, group) is chosen in Python (deflation_apply.sum_geometry).
// 4. The rounding of the PyTorch path where it is elementwise: in passes
//    1, 2 and 4 each product, sum and difference is rounded alone
//    (__dmul_rn / __dadd_rn: no contraction into fma), the slot terms added
//    in slot order, ((AZ0 B0 + AZ1 B1) + AZ2 B2) + AZ3 B3, and the Jacobi
//    product is block_jacobi.cu's chain (the j = 0 product, then one fma per
//    further j), so S and the result are bitwise the PyTorch path's for the
//    same y1 and y2.  The aggregate sums take another order.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Params {
  const void* R;     // pass 0, 1, 2: R; pass 3, 4: S   [ND, 8, KY, KX]
  const void* w;     // weight [ND, 8, KY, KX]
  const void* AZ;    // [4, ND, 8, KY, KX]
  const void* Dinv;  // [ND, ND, 8, KY, KX] (pass 1)
  const void* y1;    // coarse vector (passes 1, 2, 4)
  const void* y2;    // coarse vector (pass 4)
  void* out;         // field (passes 1, 2, 4) or coarse vector (passes 0, 3)
  void* partial;     // first-launch partials of passes 0 and 3: my * nch * KX / lw
  int KY, KX, fy, fx, my, mx;
  int sy1, sx1, sy2, sx2, syo, sxo;  // element strides (aggregate row, column)
  int nch, ch, lw, group;
  int shift[8][3][2];   // (dy, dx) of subclass k's slot s
  int source[3][8][3];  // (k, dy, dx) of slot s's source of target subclass ks
};

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ int wrap(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// y at the aggregate of lattice position (y, x), through strides (sy, sx)
template <typename T>
__device__ __forceinline__ T coarse_at(const T* __restrict__ yc, const Params& p, int y, int x,
                                       int sy, int sx) {
  return __ldg(yc + (y / p.fy) * sy + (x / p.fx) * sx);
}

// sum_i AZ[slot, i, site] S[i, site], each product and sum rounded alone
template <typename T, int ND>
__device__ __forceinline__ T pairing(const T* __restrict__ AZ, const T* __restrict__ S, int slot,
                                     int site, int C) {
  T v = mul_rn(__ldg(AZ + (slot * ND) * C + site), __ldg(S + site));
#pragma unroll
  for (int i = 1; i < ND; ++i) {
    v = add_rn(v, mul_rn(__ldg(AZ + (slot * ND + i) * C + site), __ldg(S + i * C + site)));
  }
  return v;
}

// First launch of passes 0 (ZTA false: the site value sum_i R w) and 3 (ZTA
// true: the site total of Z_w^T A S before aggregation)
template <typename T, int ND, bool ZTA>
__global__ void __launch_bounds__(kThreads) sums_kernel(const __grid_constant__ Params p) {
  const int KX = p.KX, L = p.KY * KX, C = 8 * L;
  const int n = p.my * p.nch * KX;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const T* __restrict__ R = static_cast<const T*>(p.R);
  T acc = T(0);
  if (t < n) {
    const T* __restrict__ AZ = static_cast<const T*>(p.AZ);
    const int x = t % KX, r = t / KX;
    const int c = r % p.nch, ay = r / p.nch;
    const int q0 = c * p.ch, q1 = min(q0 + p.ch, 8 * p.fy);
    for (int q = q0; q < q1; ++q) {
      const int k = q / p.fy, y = ay * p.fy + q % p.fy;
      const int site = k * L + y * KX + x;
      T v;
      if (!ZTA) {
        const T* __restrict__ w = static_cast<const T*>(p.w);
        v = mul_rn(__ldg(R + site), __ldg(w + site));
#pragma unroll
        for (int i = 1; i < ND; ++i) {
          v = add_rn(v, mul_rn(__ldg(R + i * C + site), __ldg(w + i * C + site)));
        }
      } else {
        v = pairing<T, ND>(AZ, R, 0, site, C);
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const int* src = p.source[s][k];
          const int from = src[0] * L + wrap(y - src[1], p.KY) * KX + wrap(x - src[2], KX);
          v = add_rn(v, pairing<T, ND>(AZ, R, s + 1, from, C));
        }
      }
      acc = add_rn(acc, v);
    }
  }
  // the lw adjacent columns of one aggregate (lw | fx, lw | KX, lw | 32)
  for (int off = p.lw / 2; off > 0; off /= 2) {
    acc = add_rn(acc, __shfl_down_sync(0xffffffffu, acc, off, p.lw));
  }
  if (t < n && t % p.lw == 0) static_cast<T*>(p.partial)[t / p.lw] = acc;
}

// Second launch of passes 0 and 3: `group` threads an aggregate, in
// row-major aggregate order, each summing every group-th partial, then a
// fixed tree over the group
template <typename T>
__global__ void __launch_bounds__(kThreads) aggregate_kernel(const __grid_constant__ Params p) {
  __shared__ T part[kThreads];
  const int G = p.group;
  const int a = (blockIdx.x * kThreads + threadIdx.x) / G, j = threadIdx.x % G;
  const int per_row = p.KX / p.lw, per_agg = p.fx / p.lw, terms = p.nch * per_agg;
  const int ay = a / p.mx, ax = a % p.mx;
  const bool live = a < p.my * p.mx;
  const T* __restrict__ partial = static_cast<const T*>(p.partial);
  T acc = T(0);
  if (live) {
    for (int q = j; q < terms; q += G) {
      acc = add_rn(acc, partial[(ay * p.nch + q / per_agg) * per_row + ax * per_agg + q % per_agg]);
    }
  }
  part[threadIdx.x] = acc;
  for (int off = G / 2; off > 0; off /= 2) {
    __syncthreads();
    if (j < off) part[threadIdx.x] = add_rn(part[threadIdx.x], part[threadIdx.x + off]);
  }
  if (live && j == 0) static_cast<T*>(p.out)[ay * p.syo + ax * p.sxo] = part[threadIdx.x];
}

// Passes 1 (JACOBI) and 2: one thread a site
template <typename T, int ND, bool JACOBI>
__global__ void __launch_bounds__(kThreads) residual_kernel(const __grid_constant__ Params p) {
  const int KX = p.KX, L = p.KY * KX, C = 8 * L;
  const int site = blockIdx.x * kThreads + threadIdx.x;
  if (site >= C) return;
  const int k = site / L, y = (site % L) / KX, x = site % KX;
  const T* __restrict__ R = static_cast<const T*>(p.R);
  const T* __restrict__ AZ = static_cast<const T*>(p.AZ);
  const T* __restrict__ y1 = static_cast<const T*>(p.y1);
  T* __restrict__ out = static_cast<T*>(p.out);
  T b[4];
  b[0] = coarse_at(y1, p, y, x, p.sy1, p.sx1);
#pragma unroll
  for (int s = 0; s < 3; ++s) {
    b[s + 1] = coarse_at(y1, p, wrap(y + p.shift[k][s][0], p.KY), wrap(x + p.shift[k][s][1], KX),
                         p.sy1, p.sx1);
  }
  T t[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T o = mul_rn(__ldcs(AZ + i * C + site), b[0]);
#pragma unroll
    for (int s = 1; s < 4; ++s) o = add_rn(o, mul_rn(__ldcs(AZ + (s * ND + i) * C + site), b[s]));
    t[i] = sub_rn(__ldg(R + i * C + site), o);
  }
  if (!JACOBI) {
#pragma unroll
    for (int i = 0; i < ND; ++i) out[i * C + site] = t[i];
    return;
  }
  const T* __restrict__ D = static_cast<const T*>(p.Dinv);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T z = mul_rn(__ldcs(D + (i * ND) * C + site), t[0]);
#pragma unroll
    for (int j = 1; j < ND; ++j) z = fma(__ldcs(D + (i * ND + j) * C + site), t[j], z);
    out[i * C + site] = z;
  }
}

// Pass 4: one thread a value
template <typename T>
__global__ void __launch_bounds__(kThreads) combine_kernel(const __grid_constant__ Params p, int nd) {
  const int KX = p.KX, L = p.KY * KX, C = 8 * L;
  const int e = blockIdx.x * kThreads + threadIdx.x;
  if (e >= nd * C) return;
  const int y = (e % L) / KX, x = e % KX;
  const T w = __ldg(static_cast<const T*>(p.w) + e);
  const T b1 = coarse_at(static_cast<const T*>(p.y1), p, y, x, p.sy1, p.sx1);
  const T b2 = coarse_at(static_cast<const T*>(p.y2), p, y, x, p.sy2, p.sx2);
  static_cast<T*>(p.out)[e] =
      sub_rn(add_rn(mul_rn(b1, w), __ldg(static_cast<const T*>(p.R) + e)), mul_rn(b2, w));
}

int blocks(long long threads) { return (int)((threads + kThreads - 1) / kThreads); }

template <int ND, typename T>
int launch(int pass, const Params* pp, int device, void* stream_ptr) {
  const Params p = *pp;
  const long long C = 8LL * p.KY * p.KX;
  const bool sums = pass == 0 || pass == 3;
  if (p.KY <= 0 || p.KX <= 0 || p.fy <= 0 || p.fx <= 0 || p.KY % p.fy || p.KX % p.fx ||
      p.KY / p.fy != p.my || p.KX / p.fx != p.mx || 4LL * ND * C >= (1LL << 31) ||
      (long long)ND * ND * C >= (1LL << 31) || pass < 0 || pass > 4 ||
      (sums && (p.nch <= 0 || p.ch <= 0 || (long long)p.nch * p.ch < 8LL * p.fy ||
                p.lw <= 0 || p.lw > 32 || (p.lw & (p.lw - 1)) || p.fx % p.lw ||
                p.group <= 0 || p.group > kThreads || (p.group & (p.group - 1))))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  switch (pass) {
    case 0:
    case 3: {
      const long long n = (long long)p.my * p.nch * p.KX;
      if (pass == 0) {
        sums_kernel<T, ND, false><<<blocks(n), kThreads, 0, stream>>>(p);
      } else {
        sums_kernel<T, ND, true><<<blocks(n), kThreads, 0, stream>>>(p);
      }
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
      aggregate_kernel<T><<<blocks((long long)p.my * p.mx * p.group), kThreads, 0, stream>>>(p);
      break;
    }
    case 1:
      residual_kernel<T, ND, true><<<blocks(C), kThreads, 0, stream>>>(p);
      break;
    case 2:
      residual_kernel<T, ND, false><<<blocks(C), kThreads, 0, stream>>>(p);
      break;
    case 4:
      combine_kernel<T><<<blocks(ND * C), kThreads, 0, stream>>>(p, ND);
      break;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per (ND, dtype): deflation_apply_nd3_f32
// ... deflation_apply_nd10_f64.  pass: 0 Z_w^T R, 1 Dinv (R - A Z_w y1),
// 2 R - A Z_w y1, 3 Z_w^T A S, 4 the combine; p: the Params above, copied
// into each launch.  Returns cudaErrorInvalidValue for a geometry the
// kernels do not take, else cudaGetLastError() after the launches.
#define DEFLATION_APPLY_ENTRY(NAME, ND, T)                                          \
  extern "C" int NAME(int pass, const void* p, int device, void* stream) {         \
    return launch<ND, T>(pass, static_cast<const Params*>(p), device, stream);     \
  }

DEFLATION_APPLY_ENTRY(deflation_apply_nd3_f32, 3, float)
DEFLATION_APPLY_ENTRY(deflation_apply_nd3_f64, 3, double)
DEFLATION_APPLY_ENTRY(deflation_apply_nd6_f32, 6, float)
DEFLATION_APPLY_ENTRY(deflation_apply_nd6_f64, 6, double)
DEFLATION_APPLY_ENTRY(deflation_apply_nd10_f32, 10, float)
DEFLATION_APPLY_ENTRY(deflation_apply_nd10_f64, 10, double)
