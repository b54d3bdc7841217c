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
// per subclass and ND X values and writes ND; the planes are 86-95% of the
// traffic and are touched exactly once, one multiply-add per plane value,
// far below the H100's flop:byte balance at every ND.  The least time is
// (planes + X + Y) / 3.35 TB/s.
//
// The design, one choice per limit of the earlier one-thread-per-site
// kernel:
//
// 1. X is read from device memory once per call, plus a halo.  A thread
//    block owns a TY x TX tile of lattice sites across all 8 subclasses.
//    Its consumer warps stage the tile's X, widened by the halo the plan's
//    shifts need (taken from the plan on the host), into shared memory with
//    cp.async; the halo's rows and columns wrap on each axis through two
//    index tables filled once per tile (a wrapped halo is periodic, not
//    TMA's zero fill).  All four slots' sources are then read from shared
//    memory, where a site's ND values lie side by side: one address per
//    (subclass, slot) and an immediate offset per j, so a thread holds
//    4 x (its subclasses) source addresses and not 4 ND of them (which
//    spilled at 96 registers).
// 2. The planes stream through a ring of shared-memory stages, filled by
//    TMA: one 3D tensor copy per stage, a box of TX x TY sites by 8 G
//    consecutive planes (G (s, i, j) groups x 8 subclasses), issued by one
//    producer thread under full / empty mbarriers.  Bytes in flight are the
//    ring's, set by shared memory and not by registers: the host sizes the
//    ring to fill what two blocks per SM leave beside the staged X.  Rows
//    and columns past the lattice arrive zero-filled and are not stored.
//    A consumer warp releases a stage only after fence.proxy.async: its
//    reads go through the generic proxy and the refill through the async
//    one, and without the fence a refill overtook the reads on the card
//    (wrong values that changed from run to run, once grids ran in several
//    waves).  One block per tile; a second block per SM streams while the
//    first stages its X or drains (a persistent variant, blocks walking
//    tiles with one ring, measured 1-3% slower on the card).
// 3. No division per site: tiles come from blockIdx, a thread's site and
//    subclasses from its index with compile-time powers of two, and the
//    X sources from per-(subclass, slot) offsets into the staged box that
//    the host computes once per plan (kernels/plane_spmv.py).
// 4. The same arithmetic as the plain version: each Y[i] starts at 0 and
//    takes one FMA per term in (s, then j) order, so the result is bitwise
//    the plain version's (and the earlier kernel's).
//
// Tile and ring per instantiation.  Config below fixes the sites of a tile
// and the (s, i, j) groups of a stage; the host (TILES in
// kernels/plane_spmv.py) picks the tile's aspect TY x TX and the number of
// stages, and the launch checks the geometry against Config.  256 consumer
// threads each own one site of the tile and 4 or 2 of its subclasses, so a
// thread keeps 4 ND or 2 ND accumulators whatever the ring holds (8
// subclasses a thread spilled at the 96 registers that two blocks of 288
// threads leave):
//   ND 3 f32: 4 x 32 sites, 4 subclasses a thread, stage 2 groups (8 KB)
//   ND 3 f64: 2 x 32, 2, 2 (8 KB)           ND 6 f32: 2 x 64, 4, 4 (16 KB)
//   ND 6 f64: 2 x 32, 2, 2 (8 KB)           ND 10 f32: 2 x 32, 2, 8 (16 KB)
//   ND 10 f64: 4 x 16, 2, 2 (8 KB)
// chosen on the card among 64 / 128 / 256 sites, 8 / 16 KB stages and
// 1 / 2 / 4-row tiles on an H100 (PERF.md).  ND 10 f64 is the
// tight case: 640 B of staged X per site.
//
// Measured share of the bound (NVIDIA H100 80GB HBM3, 700.00 W;
// `chip_smoke.py --plane-rows`, random planes under the ESV plan; the
// one-thread-per-site kernel before it in parentheses, same card and run):
//   ND 3 f32: 82.8% at 320 x 1600 (72.1%), 69.2% at 80 x 400 (73.5%)
//   ND 3 f64: 86.6% at 320 x 1600 (73.4%), 79.1% at 256 x 256 (72.5%)
//   ND 6 f32: 83.7% at 256 x 256 (75.5%)    ND 6 f64: 85.9% (71.2%)
//   ND 10 f32: 79.3-80.1% at 128 x 128 (35.1%); ND 10 f64: 83.3-84.9% (67.9%)
// Another card of the same name and limit gave 86.8% (ND 3 f32, 320 x
// 1600) and 81.2% (ND 3 f64, 256 x 256).  Below ~64 x 64 sites a launch is
// latency-bound (~9 us for ND 3): each tile streams its stages through an
// 8-stage ring in a few round trips.
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#include <cstdint>

// The launch geometry, computed on the host (kernels/plane_spmv.py
// plane_geometry) and passed by value; outside the anonymous namespace,
// so that the C entries below keep external linkage.
struct PlaneGeometry {
  int KY, KX;          // lattice
  int TY, TX, lx;      // tile; TX = 1 << lx
  int BY, BX;          // staged X box: the tile and its halo
  int hy, hx;          // halo rows above / columns left of the tile
  int stages;          // ring stages
  int grid_x, grid_y;  // tiles along x and y
  int smem_bytes;      // dynamic shared memory
  int xoff[8][4];      // per (k, s): source of tile site (0, 0) in one staged X plane
};

namespace {

constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + one producer warp
constexpr int kMaxStages = 8;
constexpr int kHeaderBytes = 128;  // kMaxStages full + kMaxStages empty mbarriers

template <int ND, typename T>
struct Config;  // kSites: tile sites (TY * TX); kGroups: (s, i, j) groups per stage
template <> struct Config<3, float> { static constexpr int kSites = 128, kGroups = 2; };
template <> struct Config<3, double> { static constexpr int kSites = 64, kGroups = 2; };
template <> struct Config<6, float> { static constexpr int kSites = 128, kGroups = 4; };
template <> struct Config<6, double> { static constexpr int kSites = 64, kGroups = 2; };
template <> struct Config<10, float> { static constexpr int kSites = 64, kGroups = 8; };
template <> struct Config<10, double> { static constexpr int kSites = 64, kGroups = 2; };


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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;" ::"r"(smem_u32(dst)), "l"(src),
               "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumers) : "memory");
}

template <int ND, typename T>
__global__ void __launch_bounds__(kThreads, 2)
    plane_spmv_kernel(const __grid_constant__ CUtensorMap planes, const T* __restrict__ X,
                      T* __restrict__ Y, const PlaneGeometry g) {
  constexpr int kSites = Config<ND, T>::kSites;
  constexpr int kGroups = Config<ND, T>::kGroups;
  constexpr int kPerThread = 8 * kSites / kConsumers;  // subclasses a thread owns
  constexpr int kStageElems = 8 * kGroups * kSites;
  constexpr int kTerms = 4 * ND * ND;                   // (s, i, j) groups per tile
  static_assert(kPerThread * kConsumers == 8 * kSites && 8 % kPerThread == 0, "tile");
  static_assert(kTerms % kGroups == 0, "stage");

  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  T* ring = reinterpret_cast<T*>(smem + kHeaderBytes);
  T* xs = ring + g.stages * kStageElems;  // [8][BY][BX][ND]: a site's ND values together
  const int box = 8 * g.BY * g.BX;
  int* rowtab = reinterpret_cast<int*>(xs + ND * box);  // wrapped row * KX
  int* coltab = rowtab + g.BY;                             // wrapped column

  const int tid = threadIdx.x;
  const int x0 = blockIdx.x * g.TX, y0 = blockIdx.y * g.TY;
  if (tid == 0) {
    for (int st = 0; st < g.stages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {  // the producer warp: one thread streams the planes
    if (tid == kConsumers) {
      int slot = 0;
      uint32_t phase = 0;
      for (int st = 0; st < kTerms / kGroups; ++st) {
        mbar_wait(&empty[slot], phase ^ 1);
        mbar_arrive_expect_tx(&full[slot], kStageElems * sizeof(T));
        tma_load_3d(ring + slot * kStageElems, &planes, x0, y0, st * 8 * kGroups, &full[slot]);
        if (++slot == g.stages) {
          slot = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // Stage X: the halo's wrap once per tile, then X[q, row r, column c] for
  // e = (q BY + r) BX + c, q = 8 j + k (consecutive threads on consecutive
  // columns), into box position (k BY + r) BX + c, value j; (q, r, c) is
  // carried from one stride of kConsumers to the next.
  for (int r = tid; r < g.BY; r += kConsumers) {
    const int v = (y0 - g.hy + r) % g.KY;
    rowtab[r] = (v < 0 ? v + g.KY : v) * g.KX;
  }
  for (int c = tid; c < g.BX; c += kConsumers) {
    const int v = (x0 - g.hx + c) % g.KX;
    coltab[c] = v < 0 ? v + g.KX : v;
  }
  consumers_sync();
  {
    const long long L = (long long)g.KY * g.KX;
    const int total = ND * box;
    const int dc = kConsumers % g.BX, drq = kConsumers / g.BX;
    const int dr = drq % g.BY, dq = drq / g.BY;
    int c = tid % g.BX, r = (tid / g.BX) % g.BY, q = tid / g.BX / g.BY;
    for (int e = tid; e < total; e += kConsumers) {
      cp_async(xs + (((q & 7) * g.BY + r) * g.BX + c) * ND + (q >> 3),
               X + q * L + rowtab[r] + coltab[c]);
      c += dc;
      r += dr;
      q += dq;
      if (c >= g.BX) {
        c -= g.BX;
        ++r;
      }
      if (r >= g.BY) {
        r -= g.BY;
        ++q;
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
  }
  consumers_sync();

  // This thread's site and subclasses kb .. kb + kPerThread - 1 (a warp's kb
  // is uniform), and where their four sources' ND values start in the box.
  const int site = tid % kSites;
  const int kg = kPerThread == 8 ? 0 : tid / kSites;
  const int kb = kg * kPerThread;
  const int y = site >> g.lx, x = site & (g.TX - 1);
  const int base = y * g.BX + x;
  int src[kPerThread][4];
#pragma unroll
  for (int kk = 0; kk < kPerThread; ++kk) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      int off = g.xoff[kk][s];
#pragma unroll
      for (int h = 1; h < 8 / kPerThread; ++h) {
        if (kg == h) off = g.xoff[h * kPerThread + kk][s];
      }
      src[kk][s] = (base + off) * ND;
    }
  }

  T acc[kPerThread][ND];
#pragma unroll
  for (int kk = 0; kk < kPerThread; ++kk) {
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[kk][i] = T(0);
  }
  const int lane = tid & 31;
  int slot = 0;
  uint32_t phase = 0;
#pragma unroll
  for (int t = 0; t < kTerms; ++t) {  // planes in memory order: (s, i, j), then k
    const int s = t / (ND * ND), i = (t / ND) % ND, j = t % ND, grp = t % kGroups;
    if (grp == 0) mbar_wait(&full[slot], phase);
    const T* w = ring + slot * kStageElems + (grp * 8 + kb) * kSites + site;
#pragma unroll
    for (int kk = 0; kk < kPerThread; ++kk) {
      acc[kk][i] = fma(w[kk * kSites], xs[src[kk][s] + j], acc[kk][i]);
    }
    if (grp == kGroups - 1) {  // this warp is done with the stage
      // its reads (generic proxy) ordered before the TMA refill (async proxy)
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[slot]);
      if (++slot == g.stages) {
        slot = 0;
        phase ^= 1;
      }
    }
  }

  const int gy = y0 + y, gx = x0 + x;
  if (gy < g.KY && gx < g.KX) {
    const long long L = (long long)g.KY * g.KX;
    T* out = Y + (long long)gy * g.KX + gx;
#pragma unroll
    for (int kk = 0; kk < kPerThread; ++kk) {
#pragma unroll
      for (int i = 0; i < ND; ++i) out[(i * 8 + kb + kk) * L] = acc[kk][i];
    }
  }
}

PFN_cuTensorMapEncodeTiled_v12000 tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
    }
  }
  return fn;
}

template <int ND, typename T>
int launch(const void* W, const void* X, void* Y, const PlaneGeometry* g, int device,
           void* stream) {
  using C = Config<ND, T>;
  constexpr long long kStageBytes = 8LL * C::kGroups * C::kSites * sizeof(T);
  const long long need = kHeaderBytes + g->stages * kStageBytes +
                         8LL * ND * g->BY * g->BX * sizeof(T) + 4LL * (g->BY + g->BX);
  if (g->TY * g->TX != C::kSites || g->TX != (1 << g->lx) || g->stages < 2 ||
      g->stages > kMaxStages || g->smem_bytes < need || g->KX % 4 != 0 ||
      g->grid_x * g->TX < g->KX || g->grid_y * g->TY < g->KY) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  PFN_cuTensorMapEncodeTiled_v12000 encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;

  // the planes as a 3D tensor: x, y, then the 32 ND^2 (s, i, j, k) planes
  CUtensorMap map;
  cuuint64_t dims[3] = {(cuuint64_t)g->KX, (cuuint64_t)g->KY, (cuuint64_t)(32 * ND * ND)};
  cuuint64_t strides[2] = {(cuuint64_t)g->KX * sizeof(T),
                           (cuuint64_t)g->KY * g->KX * sizeof(T)};
  cuuint32_t box[3] = {(cuuint32_t)g->TX, (cuuint32_t)g->TY, (cuuint32_t)(8 * C::kGroups)};
  cuuint32_t unit[3] = {1, 1, 1};
  CUresult res = encode(&map,
                        sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_FLOAT64,
                        3, const_cast<void*>(W), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;

  static int smem_set[64] = {};  // the dynamic shared memory allowed so far, per device
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (g->smem_bytes > smem_set[device]) {
    err = cudaFuncSetAttribute(plane_spmv_kernel<ND, T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, g->smem_bytes);
    if (err != cudaSuccess) return (int)err;
    smem_set[device] = g->smem_bytes;
  }
  plane_spmv_kernel<ND, T><<<dim3(g->grid_x, g->grid_y), kThreads, g->smem_bytes,
                             (cudaStream_t)stream>>>(map, (const T*)X, (T*)Y, *g);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface for ctypes, one entry per (ND, dtype): plane_spmv_f32 and
// plane_spmv_f64 (ND = 3), plane_spmv_nd6_f32 ... plane_spmv_nd10_f64.
// geometry: the host's PlaneGeometry (kernels/plane_spmv.py Geometry); W
// 16-byte aligned.
// Returns cudaErrorInvalidValue for a geometry this instantiation does not
// take, else cudaGetLastError() after the launch.
#define PLANE_SPMV_ENTRY(NAME, ND, T)                                                  \
  extern "C" int NAME(const void* W, const void* X, void* Y, const PlaneGeometry* geometry, \
                      int device, void* stream) {                                      \
    return launch<ND, T>(W, X, Y, geometry, device, stream);                           \
  }

PLANE_SPMV_ENTRY(plane_spmv_f32, 3, float)
PLANE_SPMV_ENTRY(plane_spmv_f64, 3, double)
PLANE_SPMV_ENTRY(plane_spmv_nd6_f32, 6, float)
PLANE_SPMV_ENTRY(plane_spmv_nd6_f64, 6, double)
PLANE_SPMV_ENTRY(plane_spmv_nd10_f32, 10, float)
PLANE_SPMV_ENTRY(plane_spmv_nd10_f64, 10, double)
