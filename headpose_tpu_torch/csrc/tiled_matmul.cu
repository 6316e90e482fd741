// A tiled bf16 GEMM with a float32 sum on NVIDIA Hopper's tensor cores
// (sm_90a): C (M x N, float32) = A (M x K, bf16, row-major) @ B (K x N,
// bf16, row-major).
//
// Replaces the TPU kernel scripts/probe_mosaic_matmul.py::make_pallas_matmul
// (its pl.pallas_call, body `kernel`): the textbook tiled-accumulator GEMM
// over the grid (M/bm, N/bn, K/bk), a float32 VMEM accumulator zeroed at
// k == 0, jnp.dot(..., preferred_element_type=f32) added at each K step and
// written out at the last.  The plain PyTorch version is
// ops/kernels/tiled_matmul.py::tiled_matmul_plain (K walked in steps of bk,
// each step's float32 product of the bf16 values added into a float32
// accumulator); the wrapper is tiled_matmul there, and
// tools/probe_matmul.py is the probe that times it against cuBLAS.
//
// Semantics: every product of two bf16 values is exact in float32; the sums
// are float32 in the tensor cores' order (wgmma sums the 16 products of a
// k16 slice, then the slices in K order), so the result differs from the
// plain version's sum order by float32 rounding alone.
//
// What bounds it on this card: operations.  At M = N = K = 2048 it does
// 17.2 GFLOP (0.0174 ms at 989 TFLOP/s bf16 dense) and must move 33.6 MB
// (A and B read once, C written once: 0.010 ms at 3.35 TB/s); at 4096 and
// 8192 the operations grow 8x a step and the bytes 4x.  Only wgmma reaches
// the tensor cores' full rate, and only if its operands arrive in shared
// memory faster than it consumes them and no thread stalls it.
//
// What held the first design (mma.sync, two cp.async stages, a CTA a tile)
// to 0.35-0.41x cuBLAS, and what this one does about each:
//   warp-level MMA: every warp pulled its own A and B fragments from shared
//     memory with ldmatrix at every k16 slice, so shared-memory and register
//     traffic set the pace.  Here wgmma.mma_async.m64n{128,256}k16 reads
//     both operands straight from shared memory through descriptors, a
//     warpgroup (4 warps) per instruction, and keeps the sum in registers.
//   a shallow pipeline: two stages loaded 16 bytes a thread by all threads,
//     two __syncthreads() a K step.  Here TMA (cp.async.bulk.tensor) fills a
//     ring of S stages (as many as fit the 232,448 bytes beside C's
//     staging, at most kMaxStages), each with a `full` mbarrier (the TMA's
//     bytes) and an `empty` one (one arrival from each consumer warpgroup
//     once its wgmma.wait_group shows it has read the stage).  No CTA-wide
//     barrier in the main loop.
//   a non-persistent grid: at 2048^3 256 CTAs made 1.94 waves on 132 SMs,
//     and no tile's epilogue overlapped the next tile's loads.  Here the
//     grid is min(SMs, tiles), each CTA walks tiles t = blockIdx.x +
//     i * gridDim.x in a grouped order (below), and the producer runs on
//     into the next tile while the consumers write the last one out.  The
//     consumers write C into shared memory (128-byte swizzled boxes of
//     64 x 32 floats) and one thread a warpgroup hands the boxes to TMA
//     stores (cp.async.bulk.tensor ... bulk_group), which drain while the
//     next tile's products run; C goes in P passes of 1 / P of the tile
//     each, so that the staging leaves the ring deep enough (the plan's P:
//     1 for square and narrow-M, 2 for wide-N, large and deep-K).  Storing
//     float2s straight from the registers instead, with the ring as deep as
//     the whole budget allows, was 5-18 % slower at every tile at 4096^3
//     on an H100 SXM (tools/kernel_phases.py matmul, variant direct_store;
//     PERF.md section 6).
//   register-bound occupancy: 122-220 registers a thread, one CTA an SM at
//     two tiles.  Here 384 threads are warp-specialised in one if/else that
//     never reconverges: warpgroup 0 is the producer (one elected thread
//     issues every TMA; setmaxnreg.dec drops it to 40 registers), warpgroups
//     1 and 2 are consumers (setmaxnreg.inc raises them to 232, room for 128
//     float32 accumulators a thread).
//
// Layouts.  A is K-major: a stage holds A's BM x BK slice as BK/32 boxes of
// BM rows x 32 bf16 (64 bytes) with the 64-byte swizzle; a k16 slice's
// descriptor starts 32 bytes into a box row (SBO = 512 bytes, one 8-row
// group).  B is row-major K x N, so MN-major: a stage holds B's BK x BN
// slice as BN/64 boxes of BK rows x 64 bf16 (128 bytes) with the 128-byte
// swizzle, and wgmma reads it with imm-trans-b = 1 (LBO = one box, the
// stride between 64-column atoms; SBO = 1024 bytes, one 8-row K group; a k16
// slice starts 16 rows, 2048 bytes, further).  Every box starts on a
// 1024-byte boundary, so the descriptors' base offset stays 0.
//
// The tiles (template instances).  The TPU's shapes are sized for VMEM: its
// 512 x 512 accumulator alone would need 1 MB of registers.  The port keeps
// the JAX sweep's five roles at bm/4, bn/4 and bk/16 of its shapes, and the
// two consumer warpgroups split each tile so:
//   square    128 x 128 x  32  (TPU  512 x  512 x  512): 64 rows each,
//                              m64n128, 64 accumulators a thread
//   wide-N    128 x 256 x  32  (TPU  512 x 1024 x  512): 64 rows each,
//                              m64n256, 128
//   narrow-M   64 x 256 x  32  (TPU  256 x 1024 x  512): the same 64 rows,
//                              128 columns each, m64n128, 64
//   large     256 x 128 x  32  (TPU 1024 x 1024 x  512, N halved again):
//                              128 rows each, two m64n128, 128
//   deep-K    128 x 128 x 128  (TPU  512 x  512 x 2048): as square, eight
//                              k16 slices a stage
// A stage is 2 * BK * (BM + BN) bytes: 16, 24, 20, 24 and 64 KB; C's
// staging 4 * BM * BN / P.  The launch plan (stages S, passes P, grid,
// group width G) is computed by the wrapper, ops/kernels/tiled_matmul.py::
// plan, and passed in; ptxas's registers are printed by the build
// (chip_smoke.py's build phase, `ptxas`).
//
// The tile order.  Tile t of the tiles_m x tiles_n grid is, with
// per = G * tiles_n, g = t / per, r = t % per and
// rows = min(G, tiles_m - g * G):
//   tile-row = g * G + r % rows,   tile-col = r / rows
// (ops/kernels/tiled_matmul.py::tile_order is the same map): G tile-rows at
// a time, so that the CTAs running together share B's column panels in L2.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder is fetched
                    // through cudaGetDriverEntryPoint, so no -lcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 384;        // producer warpgroup + two consumers
constexpr int kMaxStages = 16;
constexpr int kSmemLimit = 232448;   // dynamic shared memory a CTA may use
constexpr int kSmemAlign = 1024;     // slack to align the ring's base
constexpr int kErrUnsupported = -1;
constexpr int kErrTensorMap = -2;
constexpr int kMaxDevices = 64;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarrier
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity)
      : "memory");
}

// --------------------------------------------------------------------- TMA
// The box of `map` at (inner, outer) element coordinates into shared memory,
// counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         int inner, int outer, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(inner),
      "r"(outer)
      : "memory");
}

// The box of `map` at (inner, outer) written from shared memory, in this
// thread's current bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int inner,
                                          int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(inner), "r"(outer)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// until this thread's bulk stores are complete
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, seen by the TMA (the async proxy)
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// the 128 threads of one warpgroup, at named barrier `id` (0 is
// __syncthreads')
__device__ __forceinline__ void warpgroup_sync(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// ------------------------------------------------------------------- wgmma
// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1: 128 bytes, 2: 64 bytes).
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo, uint64_t swizzle) {
  return static_cast<uint64_t>((smem_u32(p) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo) << 16) |
         (static_cast<uint64_t>(sbo) << 32) | (swizzle << 62);
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// every wgmma group but the newest N complete
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// D (64 x 128, f32, 64 registers a thread) = or += A (64 x 16, K-major)
// . B (16 x 128, MN-major), both from shared memory descriptors.
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D (64 x 256, f32, 128 registers a thread) = or += A (64 x 16, K-major)
// . B (16 x 256, MN-major), both from shared memory descriptors.
__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int BM, int BN, int BK>
struct Tile {
  // the consumers split the rows of a tile of 128 or more rows, else the
  // columns
  static constexpr bool kSplitRows = BM >= 128;
  static constexpr int kMI = kSplitRows ? BM / 128 : 1;  // m64 blocks each
  static constexpr int kWN = kSplitRows ? BN : BN / 2;   // wgmma's N
  static constexpr int kAcc = kWN / 2;                   // f32 a thread each
  static constexpr int kABox = BM * 64;        // bytes: BM rows x 32 bf16
  static constexpr int kBBox = BK * 128;       // bytes: BK rows x 64 bf16
  static constexpr int kABytes = BK / 32 * kABox;
  static constexpr int kStageBytes = kABytes + BN / 64 * kBBox;
  // C staged for the TMA store: each consumer's rows x kWN float32 as
  // kCBoxes boxes of 64 rows x 32 floats (8 KB, 128-byte swizzle); box
  // i * kWN / 32 + jb holds its m64 block i's columns 32 jb to 32 jb + 31
  static constexpr int kCBox = 64 * 32 * 4;
  static constexpr int kCBoxes = kMI * kWN / 32;
  static constexpr int kCBytes = BM * BN * 4;   // both consumers' boxes
  static_assert(BK % 32 == 0 && BN % 128 == 0 && BM % 64 == 0 &&
                    (kWN == 128 || kWN == 256) && kMI * 128 * 2 >= BM,
                "a tile the consumer split does not cover");
  static_assert(kABox % 1024 == 0 && kBBox % 1024 == 0,
                "every box starts on a 1024-byte boundary");
};

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2], uint64_t da,
                                      uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_m64n128(d, da, db, accumulate);
  else
    wgmma_m64n256(d, da, db, accumulate);
}

// tile t -> (tile-row, tile-col), G tile-rows at a time
__device__ __forceinline__ void tile_order(int t, int tiles_m, int tiles_n,
                                           int group, int& tm, int& tn) {
  const int per = group * tiles_n;
  const int g = t / per, r = t - g * per;
  const int rows = min(group, tiles_m - g * group);
  tm = g * group + r % rows;
  tn = r / rows;
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads, 1)
    tiled_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                        const __grid_constant__ CUtensorMap map_b,
                        const __grid_constant__ CUtensorMap map_c, int m,
                        int n, int k, int stages, int passes, int group) {
  using T = Tile<BM, BN, BK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* staged = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kSmemAlign - 1) &
      ~static_cast<uintptr_t>(kSmemAlign - 1));  // [kCBytes / passes]
  unsigned char* ring = staged + T::kCBytes / passes;  // [stages][stage]
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * T::kStageBytes);
  uint64_t* empty = full + stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);      // the producer's expect_tx + TMA bytes
      mbar_init(&empty[s], 2);     // one arrival from each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles_m = m / BM, tiles_n = n / BN, tiles = tiles_m * tiles_n;
  const int steps = k / BK;
  const int warpgroup = threadIdx.x / 128;

  if (warpgroup == 0) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_a))
                   : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                       reinterpret_cast<uint64_t>(&map_b))
                   : "memory");
      int stage = 0;
      uint32_t phase = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int tm, tn;
        tile_order(t, tiles_m, tiles_n, group, tm, tn);
        for (int s = 0; s < steps; ++s) {
          mbar_wait(&empty[stage], phase ^ 1);   // the first round passes
          mbar_expect(&full[stage], T::kStageBytes);
          unsigned char* sa = ring + stage * T::kStageBytes;
          unsigned char* sb = sa + T::kABytes;
#pragma unroll
          for (int j = 0; j < BK / 32; ++j)
            tma_load(sa + j * T::kABox, &map_a, s * BK + j * 32, tm * BM,
                     &full[stage]);
#pragma unroll
          for (int j = 0; j < BN / 64; ++j)
            tma_load(sb + j * T::kBBox, &map_b, tn * BN + j * 64, s * BK,
                     &full[stage]);
          if (++stage == stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int cw = warpgroup - 1;                 // consumer 0 or 1
    const int tid = threadIdx.x % 128;
    const int row0 = T::kSplitRows ? cw * (BM / 2) : 0;
    const int col0 = T::kSplitRows ? 0 : cw * (BN / 2);
    float acc[T::kMI][T::kAcc];
    int stage = 0;
    uint32_t phase = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int tm, tn;
      tile_order(t, tiles_m, tiles_n, group, tm, tn);
      int held = 0;                               // the stage last read
      for (int s = 0; s < steps; ++s) {
        mbar_wait(&full[stage], phase);
        const unsigned char* sa = ring + stage * T::kStageBytes;
        const unsigned char* sb = sa + T::kABytes + (col0 / 64) * T::kBBox;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          const uint64_t db =
              smem_desc(sb + kk * 16 * 128, T::kBBox / 16, 1024 / 16, 1);
#pragma unroll
          for (int i = 0; i < T::kMI; ++i) {
            const uint64_t da = smem_desc(
                sa + (kk / 2) * T::kABox + (row0 + 64 * i) * 64 + (kk % 2) * 32,
                1, 512 / 16, 2);
            wgmma<T::kWN>(acc[i], da, db, s > 0 || kk > 0);
          }
        }
        wgmma_commit();
        wgmma_wait<1>();                // the previous stage has been read
        if (s > 0 && tid == 0) mbar_arrive(&empty[held]);
        held = stage;
        if (++stage == stages) {
          stage = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (tid == 0) mbar_arrive(&empty[held]);

      // C through shared memory, kCBoxes / passes boxes a pass: the
      // previous pass's stores have read the staging boxes before anyone
      // writes them again.  Accumulator (i, 4j + 2h + e): row
      // 16 * warp + lane / 4 + 8h, column 8j + 2 (lane % 4) + e of the
      // consumer's m64 block i, in box (i, j / 4); there, 16-byte chunk
      // q = column % 32 / 4 of the row goes to chunk q ^ row % 8.
      unsigned char* cs = staged + cw * (T::kCBytes / 2 / passes);
      const int warp = tid / 32, lane = tid % 32;
      const int per = T::kCBoxes / passes;
      for (int lo = 0; lo < T::kCBoxes; lo += per) {
        if (tid == 0) bulk_wait_read();
        warpgroup_sync(warpgroup);
#pragma unroll
        for (int i = 0; i < T::kMI; ++i)
#pragma unroll
          for (int j = 0; j < T::kWN / 8; ++j) {
            const int box = i * (T::kWN / 32) + j / 4;
            if (box < lo || box >= lo + per) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = 16 * warp + lane / 4 + 8 * h;
              const int q = 2 * (j % 4) + (lane % 4) / 2;
              *reinterpret_cast<float2*>(
                  cs + (box - lo) * T::kCBox + r * 128 + (q ^ (r % 8)) * 16 +
                  8 * (lane % 2)) =
                  make_float2(acc[i][4 * j + 2 * h],
                              acc[i][4 * j + 2 * h + 1]);
            }
          }
        fence_async_smem();
        warpgroup_sync(warpgroup);
        if (tid == 0) {
          for (int box = lo; box < lo + per; ++box)
            tma_store(&map_c, cs + (box - lo) * T::kCBox,
                      tn * BN + col0 + 32 * (box % (T::kWN / 32)),
                      tm * BM + row0 + 64 * (box / (T::kWN / 32)));
          bulk_commit();
        }
      }
    }
    if (tid == 0) bulk_wait();          // C is written before the CTA ends
  }
}

// The dynamic shared memory limit of a kernel, raised on the current device
// only when a launch needs more than it was last set to (once per kernel and
// device, not once per launch).
template <auto Kernel>
int reserve_smem(int smem) {
  static int reserved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrUnsupported;
  if (smem <= reserved[dev]) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  reserved[dev] = smem;
  return 0;
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, looked up once through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of a row-major (outer x inner) bf16 or float32 matrix, read or
// written in boxes of box_outer rows x box_inner elements with the given
// swizzle.
int encode(CUtensorMap* map, const void* base, CUtensorMapDataType type,
           int inner, int outer, int box_inner, int box_outer,
           CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return kErrTensorMap;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(inner),
                              static_cast<cuuint64_t>(outer)};
  const cuuint64_t strides[1] = {
      static_cast<cuuint64_t>(inner) *
      (type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4 : 2)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_inner),
                             static_cast<cuuint32_t>(box_outer)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = fn(map, type, 2,
                        const_cast<void*>(base), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrTensorMap;
}

template <int BM, int BN, int BK>
int launch(const bf16* a, const bf16* b, float* c, int m, int n, int k,
           int stages, int passes, int grid, int group, cudaStream_t stream) {
  using T = Tile<BM, BN, BK>;
  if (m % BM != 0 || n % BN != 0 || k % BK != 0) return kErrUnsupported;
  if (passes < 1 || T::kCBoxes % passes != 0) return kErrUnsupported;
  const long smem = kSmemAlign + T::kCBytes / passes +
                    static_cast<long>(stages) *
                        (T::kStageBytes + 2 * sizeof(uint64_t));
  if (stages < 2 || stages > kMaxStages || smem > kSmemLimit || grid < 1 ||
      group < 1)
    return kErrUnsupported;
  CUtensorMap map_a, map_b, map_c;
  int err = encode(&map_a, a, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, k, m, 32, BM,
                   CU_TENSOR_MAP_SWIZZLE_64B);
  if (err == 0)
    err = encode(&map_b, b, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, n, k, 64, BK,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == 0)
    err = encode(&map_c, c, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, n, m, 32, 64,
                 CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != 0) return err;
  err = reserve_smem<tiled_matmul_kernel<BM, BN, BK>>(static_cast<int>(smem));
  if (err != 0) return err;
  tiled_matmul_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(
      map_a, map_b, map_c, m, n, k, stages, passes, group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A @ B on `stream`; returns 0, a CUDA error code, -1 for a tile that is
// not one of the five instances, a shape it does not divide or a plan the
// kernel cannot run, or -2 when the driver gives no tensor map for an
// operand.
//
//   a    (m, k) bf16, row-major, device, 16-byte aligned
//   b    (k, n) bf16, row-major, device, 16-byte aligned
//   c    (m, n) float32, row-major, device
//   bm, bn, bk   the tile: 128x128x32, 128x256x32, 64x256x32, 256x128x32
//                or 128x128x128
//   stages, passes, grid, group   the launch plan (ops/kernels/
//                tiled_matmul.py::plan): ring stages, passes of C's staging
//                (each stages 1 / passes of the tile), persistent CTAs,
//                tile-rows a group
extern "C" int headpose_tiled_matmul(const void* a, const void* b, void* c,
                                     int m, int n, int k, int bm, int bn,
                                     int bk, int stages, int passes, int grid,
                                     int group, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return kErrUnsupported;
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  float* pc = static_cast<float*>(c);
#define HEADPOSE_TILE(BM, BN, BK)                                          \
  if (bm == BM && bn == BN && bk == BK)                                    \
    return launch<BM, BN, BK>(pa, pb, pc, m, n, k, stages, passes, grid,   \
                              group, stream);
  HEADPOSE_TILE(128, 128, 32)
  HEADPOSE_TILE(128, 256, 32)
  HEADPOSE_TILE(64, 256, 32)
  HEADPOSE_TILE(256, 128, 32)
  HEADPOSE_TILE(128, 128, 128)
#undef HEADPOSE_TILE
  return kErrUnsupported;
}
