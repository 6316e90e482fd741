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
// are float32 in the tensor cores' order (mma.sync sums 16 products of a K
// step, then K steps in order), so the result differs from the plain
// version's sum order by float32 rounding alone.
//
// What bounds it on this card: operations.  At M = N = K = 2048 it does
// 17.2 GFLOP (0.0174 ms at 989 TFLOP/s bf16 dense) and must move 33.6 MB
// (A and B read once, C written once: 0.010 ms at 3.35 TB/s); at 4096 and
// 8192 the operations grow 8x a step and the bytes 4x.
//
// Design (a simple kernel that is right; wgmma, TMA and a persistent
// schedule are later work).  The TPU's grid axes map so:
//   M, N ("parallel")   -> blockIdx.y, blockIdx.x: one CTA owns one bm x bn
//                          output tile; CTAs run in parallel on the 132 SMs;
//   K ("arbitrary")     -> a loop inside the CTA; the accumulator lives in
//                          registers across it (no VMEM scratch on Hopper),
//                          and leaves the chip once, as float32, at the end.
// 256 threads: 8 warps as 2 (M) x 4 (N); a warp owns a (bm/2) x (bn/4)
// sub-tile as (bm/32) x (bn/32) mma.sync.m16n8k16 bf16 -> f32 tiles.  The A
// and B K-slices of a step are staged in shared memory by 16-byte cp.async
// into two buffers: step k+1's slices load while step k's products run.
// Rows are padded by 16 bytes (A: bk + 8 bf16, B: bn + 8), so that the 8
// row addresses of each ldmatrix phase fall on distinct banks.  A's
// fragments come by ldmatrix.x4, B's (a column fragment of a row-major
// K x N tile) by ldmatrix.x4.trans, two n8 tiles a load.  The epilogue
// writes each fragment's two float pairs straight from the registers.
//
// The tiles (template instances).  The TPU's shapes are sized for VMEM: its
// 512 x 512 accumulator alone would need 1 MB of registers.  The port keeps
// the JAX sweep's five roles at bm/4, bn/4 and bk/16 of its shapes:
//   square    128 x 128 x  32  (TPU  512 x  512 x  512)
//   wide-N    128 x 256 x  32  (TPU  512 x 1024 x  512)
//   narrow-M   64 x 256 x  32  (TPU  256 x 1024 x  512)
//   large     256 x 128 x  32  (TPU 1024 x 1024 x  512: 256 x 256 would hold
//                               65,536 float32 accumulators, an SM's whole
//                               register file, so this one is halved)
//   deep-K    128 x 128 x 128  (TPU  512 x  512 x 2048)
// Dynamic shared memory (two stages) 37,888 / 54,272 / 44,032 / 58,368 /
// 139,264 bytes; ptxas's registers a thread are printed by the build
// (chip_smoke.py's build phase, `ptxas`).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsM = 2;
constexpr int kWarpsN = 4;
constexpr int kPad = 8;              // bf16 a shared row: 16 bytes
constexpr int kErrUnsupported = -1;
constexpr int kMaxDevices = 64;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest complete
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// D += A.B for one m16n8k16 tile: A row-major bf16 (4 registers of 2),
// B column-major bf16 (2 registers of 2), D fp32 (4 registers).
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int kAStride = BK + kPad;   // bf16 a shared A row
  static constexpr int kBStride = BN + kPad;   // bf16 a shared B row
  static constexpr int kAElems = BM * kAStride;
  static constexpr int kBElems = BK * kBStride;
  static constexpr size_t kSmem = 2 * sizeof(bf16) * (kAElems + kBElems);
  static constexpr int kWM = BM / kWarpsM, kWN = BN / kWarpsN;
  static constexpr int kMI = kWM / 16, kNI = kWN / 8;
  static constexpr int kAChunks = BM * BK / 8 / kThreads;   // 16 B a thread
  static constexpr int kBChunks = BK * BN / 8 / kThreads;
  static_assert(BK % 16 == 0 && kWM % 16 == 0 && kWN % 16 == 0,
                "a warp's sub-tile is whole m16n8k16 tiles, n8 in pairs");
  static_assert(kAChunks * 8 * kThreads == BM * BK &&
                    kBChunks * 8 * kThreads == BK * BN,
                "every thread stages the same number of 16-byte chunks");
};

// The A (BM x BK) and B (BK x BN) slices of K step k0 into one stage.
template <int BM, int BN, int BK>
__device__ __forceinline__ void stage_slices(bf16* sa, bf16* sb,
                                             const bf16* __restrict__ ga,
                                             const bf16* __restrict__ gb,
                                             int n, int k, int k0) {
  using T = Tile<BM, BN, BK>;
#pragma unroll
  for (int j = 0; j < T::kAChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (BK / 8), c = 8 * (i % (BK / 8));
    cp_async16(sa + r * T::kAStride + c,
               ga + static_cast<size_t>(r) * k + k0 + c);
  }
#pragma unroll
  for (int j = 0; j < T::kBChunks; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (BN / 8), c = 8 * (i % (BN / 8));
    cp_async16(sb + r * T::kBStride + c,
               gb + static_cast<size_t>(k0 + r) * n + c);
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(kThreads)
    tiled_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b,
                        float* __restrict__ c, int n, int k) {
  using T = Tile<BM, BN, BK>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sa = reinterpret_cast<bf16*>(smem);       // [2][BM][kAStride]
  bf16* sb = sa + 2 * T::kAElems;                 // [2][BK][kBStride]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const bf16* ga = a + static_cast<size_t>(row0) * k;
  const bf16* gb = b + col0;

  float acc[T::kMI][T::kNI][4];
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;

  // lane -> the row (A) or K index (B) and 8-column half it addresses for
  // ldmatrix: lanes 0-7, 8-15, 16-23, 24-31 give matrices 0-3
  const int lrow = lane & 15, lcol = 8 * (lane >> 4);
  const int steps = k / BK;
  stage_slices<BM, BN, BK>(sa, sb, ga, gb, n, k, 0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    const int cur = s & 1;
    if (s + 1 < steps)
      stage_slices<BM, BN, BK>(sa + (cur ^ 1) * T::kAElems,
                               sb + (cur ^ 1) * T::kBElems, ga, gb, n, k,
                               (s + 1) * BK);
    cp_async_commit();           // an empty group on the last step
    cp_async_wait_one();         // step s's slices have landed
    __syncthreads();
    const bf16* ta = sa + cur * T::kAElems + (wm * T::kWM + lrow) * T::kAStride
                     + lcol;
    const bf16* tb = sb + cur * T::kBElems + lrow * T::kBStride
                     + wn * T::kWN + lcol;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[T::kMI][4], bfr[T::kNI][2];
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
        ldmatrix_x4(af[mi], ta + mi * 16 * T::kAStride + kk);
#pragma unroll
      for (int nj = 0; nj < T::kNI / 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, tb + kk * T::kBStride + nj * 16);
        bfr[2 * nj][0] = r[0];
        bfr[2 * nj][1] = r[1];
        bfr[2 * nj + 1][0] = r[2];
        bfr[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < T::kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < T::kNI; ++ni) mma_bf16(acc[mi][ni], af[mi], bfr[ni]);
    }
    __syncthreads();             // the stage is free for step s + 2
  }

  // fragment (mi, ni): rows g and g + 8, columns 2t and 2t + 1 of its tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < T::kMI; ++mi) {
    const int r = row0 + wm * T::kWM + mi * 16 + g;
#pragma unroll
    for (int ni = 0; ni < T::kNI; ++ni) {
      const int col = col0 + wn * T::kWN + ni * 8 + 2 * t;
      float* p = c + static_cast<size_t>(r) * n + col;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      *reinterpret_cast<float2*>(p + 8 * static_cast<size_t>(n)) =
          make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

// The dynamic shared memory limit of a kernel, raised on the current device
// only when a launch needs more than it was last set to (once per kernel and
// device, not once per launch).
template <auto Kernel>
int reserve_smem(size_t smem) {
  static int reserved[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrUnsupported;
  if (static_cast<int>(smem) <= reserved[dev]) return 0;
  err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  reserved[dev] = static_cast<int>(smem);
  return 0;
}

template <int BM, int BN, int BK>
int launch(const bf16* a, const bf16* b, float* c, int m, int n, int k,
           cudaStream_t stream) {
  if (m % BM != 0 || n % BN != 0 || k % BK != 0) return kErrUnsupported;
  constexpr size_t smem = Tile<BM, BN, BK>::kSmem;
  const int err = reserve_smem<tiled_matmul_kernel<BM, BN, BK>>(smem);
  if (err != 0) return err;
  const dim3 grid(n / BN, m / BM);
  tiled_matmul_kernel<BM, BN, BK><<<grid, kThreads, smem, stream>>>(a, b, c,
                                                                     n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C = A @ B on `stream`; returns 0, a CUDA error code, or -1 for a tile
// that is not one of the five instances or a shape it does not divide.
//
//   a    (m, k) bf16, row-major, device, 16-byte aligned
//   b    (k, n) bf16, row-major, device, 16-byte aligned
//   c    (m, n) float32, row-major, device
//   bm, bn, bk   the tile: 128x128x32, 128x256x32, 64x256x32, 256x128x32
//                or 128x128x128
extern "C" int headpose_tiled_matmul(const void* a, const void* b, void* c,
                                     int m, int n, int k, int bm, int bn,
                                     int bk, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || k <= 0) return kErrUnsupported;
  const bf16* pa = static_cast<const bf16*>(a);
  const bf16* pb = static_cast<const bf16*>(b);
  float* pc = static_cast<float*>(c);
  if (bm == 128 && bn == 128 && bk == 32)
    return launch<128, 128, 32>(pa, pb, pc, m, n, k, stream);
  if (bm == 128 && bn == 256 && bk == 32)
    return launch<128, 256, 32>(pa, pb, pc, m, n, k, stream);
  if (bm == 64 && bn == 256 && bk == 32)
    return launch<64, 256, 32>(pa, pb, pc, m, n, k, stream);
  if (bm == 256 && bn == 128 && bk == 32)
    return launch<256, 128, 32>(pa, pb, pc, m, n, k, stream);
  if (bm == 128 && bn == 128 && bk == 128)
    return launch<128, 128, 128>(pa, pb, pc, m, n, k, stream);
  return kErrUnsupported;
}
