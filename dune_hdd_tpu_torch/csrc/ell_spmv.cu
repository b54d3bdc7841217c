// ell_spmv: the scalar-ELL SpMV y = A x of SparseMatrix.matvec.
//
//   y[i] = sum_{k=0..K-1} vals[i, k] * x[cols[i, k]]
//
// vals is [N, K] (float or double), cols [N, K] int32, both contiguous and
// row-major as the pattern stores them; x is [M] of the values' type and y
// [N].  Padded slots hold value 0 and column 0 and are multiplied like any
// other.
//
// Replaces no Pallas kernel: the reference package's SparseMatrix.matvec
// (dune_hdd_tpu/la/sparse.py:164) is an XLA gather, product and row sum.
// In PyTorch the same three ops were three kernels that wrote and read two
// [N, K] intermediates (the gathered x and the product) and read int64
// columns: ~2.8 GB per application at the 3D Q1 operator (2,146,689 rows,
// K = 27) where 0.72 GB are needed.
//
// What bounds it: bytes.  Each stored entry is read once (its value and its
// 4-byte column), x is read and y written once: (8 + 4) bytes an entry in
// float64, 57,066,625 entries at the 3D operator, 719 MB with x and y, 215
// us at 3.35 TB/s.  One multiply-add per entry is far below the card's
// flop:byte balance.  x (17 MB there) stays in the 50 MB L2, and the
// columns of consecutive rows are consecutive for a stencil-like pattern,
// so a warp's gathers of one slot k coalesce.
//
// The design: persistent blocks walk tiles of R consecutive rows.  A
// tile's values (R K contiguous) and columns (R K contiguous) come into one
// stage of a two-stage shared-memory ring by two 1-D bulk copies
// (cp.async.bulk) issued by one thread and completed on the stage's
// mbarrier; the next tile streams in while the block computes this one.
// Then each thread forms its rows' sums from shared memory and gathers x
// through the read-only path, 16 slots at a time so that 16 loads are in
// flight before the first multiply-add.  The [N, K] layout is the one
// matmat, the ELL build and the reference package use: no second copy.
//
// Tile and threads by K (the host's ell_geometry, kernels/ell_spmv.py):
// what paces the kernel is the rows in flight on an SM, one a thread,
// each waiting on its gathers of x (measured on the card: at K = 27, 256
// rows in flight read 86% of the bound whatever the ring's depth; at K =
// 12, 512 rows read 75% where 256 read 62%).  So a stage takes as many
// rows as fit twice in one block's shared memory, at most 512, and the
// block has one thread a row; short rows (a stage under 48 KB) give each
// thread several.  R is a multiple of 4, so every tile starts 16-byte
// aligned; the last tile's bytes past its last 16-byte multiple (at most
// 15) are copied by the issuing thread before it arms the barrier.  A
// consumer releases a stage only after fence.proxy.async: its reads go
// through the generic proxy and the refill through the async one.
//
// Columns are int32: they index at most 2^31 - 1 rows of x, which holds
// for every matrix the port builds, and they halve the index bytes, a
// third of the traffic, against int64.
//
// The order of the sums is fixed: each row is summed by one thread in slot
// order k = 0 .. K-1, each term by a fused multiply-add in the values'
// type from 0, with no atomics, so a result does not change from run to
// run.  (It differs in rounding from the plain version's row sum.)
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kStages = 2;
constexpr int kHeaderBytes = 128;  // the stages' full mbarriers, padded
constexpr int kBatch = 16;         // gathers in flight per thread

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Fills ring stage `slot` with tile `tile`'s values and columns and arms
// the stage's barrier (one thread).
template <typename T>
__device__ __forceinline__ void load_tile(const T* __restrict__ vals,
                                          const int* __restrict__ cols, unsigned char* stage,
                                          uint64_t* bar, long long tile, int n, int K, int R) {
  const long long row0 = tile * R;
  const long long rows = n - row0 < R ? n - row0 : R;
  const long long first = row0 * K;  // a multiple of 4 entries: 16-byte aligned
  const uint32_t entries = (uint32_t)(rows * K);
  T* vs = reinterpret_cast<T*>(stage);
  int* cs = reinterpret_cast<int*>(stage + (size_t)R * K * sizeof(T));
  const uint32_t vbulk = (entries * (uint32_t)sizeof(T)) & ~15u;
  const uint32_t cbulk = (entries * 4u) & ~15u;
  // the bytes past the last 16-byte multiple, by plain copies that the
  // barrier's arrival (a release) makes visible to the waiting threads
  for (uint32_t e = vbulk / sizeof(T); e < entries; ++e) vs[e] = vals[first + e];
  for (uint32_t e = cbulk / 4; e < entries; ++e) cs[e] = cols[first + e];
  mbar_arrive_expect_tx(bar, vbulk + cbulk);
  if (vbulk) bulk_load(vs, vals + first, vbulk, bar);
  if (cbulk) bulk_load(cs, cols + first, cbulk, bar);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads, 1)
    ell_spmv_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                    const T* __restrict__ x, T* __restrict__ y, int n, int K, int R, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kHeaderBytes;
  const size_t stage_bytes = (size_t)R * K * (sizeof(T) + 4);
  const int tid = threadIdx.x;
  const int mine = blockIdx.x < tiles ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < kStages && j < mine; ++j) {
      load_tile(vals, cols, ring + j * stage_bytes, &full[j],
                blockIdx.x + (long long)j * gridDim.x, n, K, R);
    }
  }
  __syncthreads();

  int slot = 0;
  uint32_t phase = 0;
  for (int j = 0; j < mine; ++j) {
    const long long tile = blockIdx.x + (long long)j * gridDim.x;
    const long long row0 = tile * R;
    const int rows = n - row0 < R ? (int)(n - row0) : R;
    mbar_wait(&full[slot], phase);
    const unsigned char* stage = ring + slot * stage_bytes;
    const T* vs = reinterpret_cast<const T*>(stage);
    const int* cs = reinterpret_cast<const int*>(stage + (size_t)R * K * sizeof(T));
    for (int r = tid; r < rows; r += blockDim.x) {
      const T* vr = vs + (size_t)r * K;
      const int* cr = cs + (size_t)r * K;
      T acc = T(0);
      for (int k0 = 0; k0 < K; k0 += kBatch) {
        T xv[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u < K) xv[u] = __ldg(x + cr[k0 + u]);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          if (k0 + u < K) acc = fma(vr[k0 + u], xv[u], acc);
        }
      }
      y[row0 + r] = acc;
    }
    // the reads above (generic proxy) ordered before the refill (async proxy)
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (tid == 0 && j + kStages < mine) {
      load_tile(vals, cols, ring + slot * stage_bytes, &full[slot],
                tile + (long long)kStages * gridDim.x, n, K, R);
    }
    if (++slot == kStages) {
      slot = 0;
      phase ^= 1;
    }
  }
}

template <typename T>
int launch(const void* vals, const void* cols, const void* x, void* y, int n, int K, int R,
           int threads, int smem_bytes, int device, void* stream) {
  if (n < 1 || K < 1 || R < 4 || R % 4 || threads < 32 || threads > kMaxThreads ||
      threads % 32 || (long long)R * K * (sizeof(T) + 4) >= (1LL << 31) ||
      smem_bytes != kHeaderBytes + kStages * (long long)R * K * (sizeof(T) + 4)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ell_spmv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return (int)err;
  const long long tiles = ((long long)n + R - 1) / R;
  const int grid = (int)(tiles < sms ? tiles : sms);
  ell_spmv_kernel<T><<<grid, threads, smem_bytes, (cudaStream_t)stream>>>(
      (const T*)vals, (const int*)cols, (const T*)x, (T*)y, n, K, R, (int)tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes: ell_spmv_f32 and ell_spmv_f64.  R (rows per
// tile, a multiple of 4), threads (a multiple of 32, at most 512) and
// smem_bytes (128 + 2 R K (bytes per value + 4)) are the host's
// ell_geometry.  Returns cudaErrorInvalidValue for a geometry the kernel
// does not take, else cudaGetLastError() after the launch.
#define ELL_SPMV_ENTRY(NAME, T)                                                            \
  extern "C" int NAME(const void* vals, const void* cols, const void* x, void* y, int n,  \
                      int K, int R, int threads, int smem_bytes, int device,              \
                      void* stream) {                                                      \
    return launch<T>(vals, cols, x, y, n, K, R, threads, smem_bytes, device, stream);      \
  }

ELL_SPMV_ENTRY(ell_spmv_f32, float)
ELL_SPMV_ENTRY(ell_spmv_f64, double)
