// Island blocks of a dense-composed BlazeFace backbone at single-pass bf16,
// on NVIDIA Hopper's tensor cores (sm_90a): one block over a large map
// (island_block_kernel), or a whole run of small-map blocks in one launch
// (island_chain_kernel).
//
// Has no Pallas counterpart: the JAX package runs an island block as an XLA
// conv at Precision.DEFAULT (headpose_tpu/models/blazeface.py::BlazeFace.
// apply, dense=True with the block in fast_blocks), the function of the
// detector's precision="turbo" and "max" islands.  The plain PyTorch
// version is headpose_tpu_torch/models/blazeface.py::BlazeBlock.forward
// with dense and fast (ops/kernels/dense_bf16.py::dense_block_plain, and
// dense_chain_plain, their composition); the wrappers are ops/kernels/
// dense_bf16.py::dense_block and dense_chain, and island_chains there
// decides, by shape alone, which blocks run as chains.
//
// Semantics (NHWC, float32 maps), one block:
//   K[a,b,ci,co] = dw[a,b,ci] * pw[ci,co] in fp32, rounded once to bf16 (the
//       wrapper's pack); bias = dw_bias @ pw + pw_bias in fp32, unrounded;
//   t = conv3x3/s(bf16(x), K) + bias: x rounded to bf16 (nearest, ties to
//       even), every product of two bf16 values exact in fp32, the sums fp32
//       (TF SAME: stride 1 pads 1/1, stride 2 0/1);
//   y = relu(t + skip), skip = x (fp32, unrounded), max-pooled 2x2/2 at
//       stride 2, zero-padded on the channel axis when the block widens.
// A chain applies its blocks in order; only the map after the spec's tap
// block (when it lies inside) and the last map leave the chip.
//
// What bounds each part on this card:
//   large maps (the front model's blocks 0-5 at 64x64 and 32x32, the back
//   model's 0-6 up to 128x128): bytes.  Front block 0 at B=128 reads and
//   writes 100 MB of fp32 (0.030 ms at 3.35 TB/s) for 5.4 GFLOP (0.005 ms
//   at 989 TFLOP/s);
//   chains (16x16 and 8x8): latency.  The front "turbo" chain (blocks
//   10-15) at B=128 moves 25 MB (block 10's input, the tap, the last map;
//   0.0075 ms) for 10.8 GFLOP on the tensor cores (0.011 ms), but one CTA
//   owns an image and walks 6 blocks x 9 taps in order, so each tap's step
//   (its weights' arrival, a CTA barrier, a few mma.sync a warp) sets the
//   pace, whatever the batch.
//   chip_smoke.py recomputes every bound from this run's shapes.
//
// Design, island_block_kernel (one launch a block): an implicit GEMM, M =
// output pixels, N = Cout padded to 8, K = 9 taps of Cin padded to 16 (Kp).
// Persistent CTAs of 512 threads; blockIdx.y picks a slice of at most 64
// output channels (one slice on every large map of the shipped specs), whose
// bf16 weights arrive once per CTA by 16-byte cp.async, a tap's slice one
// contiguous span of the pack (9 x Np rows of Kp + 8: rows padded by 16 bytes
// so that a warp's B-fragment loads hit 32 banks; the chain kernel reads the
// same pack).  A CTA walks tiles: a band of up to 16 output rows of one image,
// as tall as shared memory allows (8 rows at 64x64x24: the halo re-read is
// 1.25x where the first design's 2-row band read 2x; 2 rows at 128x128x24,
// stride 2).  A tile's fp32 input rows, halo rows included (zeros past the
// map), land in one of two buffers while the other tile's products run: one
// bulk copy a row (the bulk-copy engine, counted on the buffer's mbarrier)
// when Cin % 4 == 0, so that a tile costs a few requests, not thousands; else
// 16-byte cp.async.  The halo columns and channel pad of both buffers stay
// zero from one clearing.  The tile is converted once, 4 channels a thread,
// into a bf16 A operand in shared memory (rows of Kp / 2 + 4 words at stride
// 1, + 2 at stride 2, so that the fragment loads of 8 neighbouring output
// pixels hit 32 banks).  A warp takes 16 pixels and up to NT n-tiles and
// issues, per tap and 16 input channels, one mma.sync.m16n8k16 bf16 -> fp32
// per n-tile; Kp / 16 and NT (4 or 8, the launch's widest unit) are template
// arguments, so the loops are unrolled to the block's own width and no issue
// slot goes to an n-tile the warp does not have; small tiles split the n-tiles
// over more warps.  The epilogue adds the bias and the skip, both read from
// shared memory (the skip from the staged fp32 tile: unrounded), applies the
// ReLU, stages the warp's 16 pixels in its own rows and writes them with
// 16-byte stores (a band is one contiguous span of the output).
//
// Design, island_chain_kernel (one launch a run of small-map blocks): one CTA
// of 512 threads owns one image (persistent over images) and keeps on chip,
// from block to block, the fp32 map (for the skip: unrounded) and its bf16
// copy with the zero halo (the A operand).  The map is updated in place at
// stride 1 (the thread that writes an element is the one that read its skip);
// at stride 2 the pooled skips go to registers first and the smaller map is
// written after a barrier, at a channel stride of its own, so the 16x16 map is
// never as wide as the 8x8 one.  Each block's composed weights stream tap by
// tap through a ring of 2-4 slots in shared memory (as many as fit) by the
// bulk-copy engine: one 1-D copy a tap, from a pack whose rows are padded like
// the slot's, counted on the slot's mbarrier; tap q+S-1 loads while tap q's
// products run, across block and image boundaries.  One copy a tap: a tap's
// arrival paced the chain when it took a thousand 16-byte cp.async requests,
// and more so as a copy a weight row.  Every image takes its taps in the same
// order, 0 to 8, so that an image's sums, and with them its maps, do not
// depend on its place in the batch.  A warp owns one m-tile and a fixed group
// of n-tiles for the whole block, its sums in registers over the 9 taps,
// compiled for the block's own unit width (4, 8 or 12 n-tiles); the epilogue
// writes the fp32 map and, for the next block, the bf16 pairs of its A
// operand, so the next block needs no staging pass.  Only the tap block's map
// and the last map are written to device memory, with 16-byte stores.
//
// mma.sync, not wgmma: 24-128 channels are narrower than a warpgroup's
// 64-row tile is useful for, and bytes (large maps) and latency (chains),
// not the tensor cores, bound these kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 512;             // both kernels: 16 warps
constexpr int kWarps = kThreads / 32;
constexpr int kNT = 8;                    // island_block_kernel: n-tiles of a unit
constexpr int kMaxSlice = 8 * kNT;        // output channels per CTA
constexpr int kMaxRows = 16;              // output rows per tile
constexpr int kMinTiles = 264;            // tiles that give every SM two
constexpr int kChainPixels = 16 * kWarps; // a chain's map: an m-tile a warp
constexpr int kMaxChain = 16;             // blocks per chain launch
constexpr int kMaxStages = 4;             // taps in the chain's weight ring
constexpr int kSkipNT = 4;                // n-tiles of a stride-2 chain unit
constexpr int kChainNT = 12;              // n-tiles of any chain unit
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kMaxChannels = 128;
constexpr int kMaxDevices = 64;
constexpr int kErrTooWide = -1;           // a shape the kernels do not take

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t round_up16(size_t x) {
  return (x + 15) / 16 * 16;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
// N bytes from src, or N zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8z(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4z(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the newest N complete
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bulk-copy engine (TMA, 1-D): `bytes` (a multiple of 16, both ends
// 16-byte aligned) from global to shared memory, counted on an mbarrier.
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
// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
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
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar))
      : "memory");
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

__device__ __forceinline__ uint32_t bf16x2_bits(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// a / d for 0 <= a < 2^22 and inv = 1.0f / d: (a + 0.5) / d lies at least
// 0.5 / d from an integer, and two float roundings (of inv and of the
// product) move it by less than that
__host__ __device__ __forceinline__ int fast_div(int a, float inv) {
  return static_cast<int>((static_cast<float>(a) + 0.5f) * inv);
}

// A warp's share of a block's products: m-tile `mt` (16 output pixels) and
// n-tiles nf .. nf + ntw - 1; small maps split the n-tiles over more warps.
struct Unit {
  int m_tiles, groups, per;
};
__host__ __device__ inline Unit units(int n_pix, int nt) {
  Unit u;
  u.m_tiles = cdiv(n_pix, 16);
  int groups = kWarps / u.m_tiles;
  groups = groups < 1 ? 1 : (groups > nt ? nt : groups);
  u.per = cdiv(nt, groups);
  u.groups = cdiv(nt, u.per);
  return u;
}

// ----------------------------------------------------- island_block_kernel
// One launch's shape and shared memory, in bytes: the weight slice (9 taps x
// ns rows of wk words), two fp32 input tiles (in_rows x in_cols pixels of
// cps floats, for the skip and the next tile's copy), the tile's bf16 A
// operand (in_rows x in_cols pixels of ws words), the warps' output staging
// (16 rows of os floats each) and the bias slice (ns floats).
struct BlockLayout {
  int Ho, rows, in_rows, in_cols, cps, kp, np, ns, wk, ws, os;
  size_t w, tile0, tile1, a, stage, bias, bar, total;
};

__host__ __device__ inline BlockLayout block_layout(int H, int Cin, int Cout,
                                                    int stride, int n_slices,
                                                    int rows) {
  BlockLayout l;
  l.Ho = H / stride;
  l.rows = rows;
  l.in_rows = stride == 1 ? rows + 2 : 2 * rows + 1;
  l.in_cols = stride == 1 ? H + 2 : H + 1;
  l.cps = round_up(Cin, 4);
  l.kp = round_up(Cin, 16);
  l.np = round_up(Cout, 8);
  l.ns = round_up(cdiv(l.np, n_slices), 8);
  l.wk = l.kp / 2 + 4;
  // A rows: the fragment loads of 8 neighbouring output pixels (1 staged
  // pixel apart at stride 1, 2 at stride 2) hit 32 banks
  l.ws = l.kp / 2 + (stride == 1 ? 4 : 2);
  l.os = l.ns % 16 ? l.ns : l.ns + 8;
  const size_t px = static_cast<size_t>(l.in_rows) * l.in_cols;
  const size_t tile = sizeof(float) * px * l.cps;
  l.w = 0;
  l.tile0 = sizeof(uint32_t) * 9 * static_cast<size_t>(l.ns) * l.wk;
  l.tile1 = l.tile0 + tile;
  l.a = l.tile1 + tile;
  l.stage = l.a + round_up16(sizeof(uint32_t) * px * l.ws);
  l.bias = l.stage + sizeof(float) * kWarps * 16 * static_cast<size_t>(l.os);
  l.bar = l.bias + sizeof(float) * l.ns;   // a tile's mbarrier, each
  l.total = l.bar + 2 * sizeof(uint64_t);
  return l;
}

// (n_slices, rows) of a block: the fewest slices of at most kMaxSlice
// output channels for which a tile fits a block's shared memory, with the
// tallest tile (at most kMaxRows output rows) that fits, shortened while the
// launch has fewer than kMinTiles tiles.  false when nothing fits.
bool block_plan(int batch, int H, int Cin, int Cout, int stride,
                int* n_slices, int* rows) {
  const int Ho = H / stride, np = round_up(Cout, 8);
  for (int s = cdiv(np, kMaxSlice); s <= np / 8; ++s) {
    int r = Ho < kMaxRows ? Ho : kMaxRows;
    while (r > 0 && block_layout(H, Cin, Cout, stride, s, r).total >
                        static_cast<size_t>(kSmemMax))
      --r;
    if (r == 0) continue;
    while (r > 1 && static_cast<long>(s) * batch * cdiv(Ho, r) < kMinTiles)
      --r;
    *n_slices = s;
    *rows = r;
    return true;
  }
  return false;
}

// A tile's input rows (with the halo rows, zeros past the map) into `tile`
template <int STRIDE>
__device__ void stage_tile(const float* __restrict__ in, float* tile,
                           const BlockLayout& l, int item, int n_bands, int H,
                           int Cin) {
  const int b = item / n_bands, r0 = item % n_bands * l.rows;
  const int row0 = STRIDE == 1 ? r0 - 1 : 2 * r0;   // input row of tile row 0
  const int col0 = STRIDE == 1 ? 1 : 0;             // tile col of input col 0
  const float* ib = in + static_cast<size_t>(b) * H * H * Cin;
  const int vec = Cin % 4 == 0 ? 4 : (Cin % 2 == 0 ? 2 : 1);
  const int per = Cin / vec, n = l.in_rows * H * per;
  const float inv_per = 1.0f / per, inv_h = 1.0f / H;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int px = fast_div(i, inv_per), j = i - px * per;
    const int r = fast_div(px, inv_h), c = px - r * H;
    const int gr = row0 + r;
    const bool ok = gr >= 0 && gr < H;
    const float* src = ok ? ib + (static_cast<size_t>(gr) * H + c) * Cin + vec * j
                          : in;
    float* dst = tile + (r * l.in_cols + c + col0) * l.cps + vec * j;
    if (vec == 4)
      cp_async16z(dst, src, ok);
    else if (vec == 2)
      cp_async8z(dst, src, ok);
    else
      cp_async4z(dst, src, ok);
  }
}

// The same by the bulk-copy engine, one copy an input row (Cin % 4 == 0:
// the row's H pixels then lie in the tile as in the map), counted on `bar`;
// the rows past the map are zeroed by plain stores, fenced so that no
// later bulk copy into the same row can overtake them.
template <int STRIDE>
__device__ void stage_tile_bulk(const float* __restrict__ in, float* tile,
                                uint64_t* bar, const BlockLayout& l, int item,
                                int n_bands, int H, int Cin) {
  const int b = item / n_bands, r0 = item % n_bands * l.rows;
  const int row0 = STRIDE == 1 ? r0 - 1 : 2 * r0;   // input row of tile row 0
  const int col0 = STRIDE == 1 ? 1 : 0;             // tile col of input col 0
  const int ra = row0 < 0 ? -row0 : 0;               // rows ra .. rb - 1 exist
  const int rb = H - row0 < l.in_rows ? H - row0 : l.in_rows;
  const int bytes = H * Cin * 4;
  if (threadIdx.x < 32) {
    if (threadIdx.x == 0) mbar_expect(bar, (rb - ra) * bytes);
    __syncwarp();
    for (int r = ra + static_cast<int>(threadIdx.x); r < rb; r += 32)
      bulk_copy(tile + (r * l.in_cols + col0) * l.cps,
                in + (static_cast<size_t>(b) * H + row0 + r) * H * Cin, bytes, bar);
  }
  const int q = H * l.cps / 4;              // float4s of a row's pixels
  const int n = (ra + l.in_rows - rb) * q;
  const float inv = 1.0f / q;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int k = fast_div(i, inv), r = k < ra ? k : rb + k - ra;
    reinterpret_cast<float4*>(tile + (r * l.in_cols + col0) * l.cps)[i - k * q] =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The staged fp32 tile (zero halo) as bf16 pairs into the A operand, 4
// channels a thread at a time; channels Cin .. Kp - 1 are zeros.
__device__ void tile_to_a(const float* tile, uint32_t* a, const BlockLayout& l,
                          int Cin) {
  const int kq = l.kp / 4, n = l.in_rows * l.in_cols * kq;
  const float inv_kq = 1.0f / kq;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int px = fast_div(i, inv_kq), q = i - px * kq, c = 4 * q;
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    const float* src = tile + px * l.cps + c;
    if (c + 3 < Cin) {
      v = *reinterpret_cast<const float4*>(src);
    } else if (c < Cin) {
      v.x = src[0];
      if (c + 1 < Cin) v.y = src[1];
      if (c + 2 < Cin) v.z = src[2];
    }
    *reinterpret_cast<uint2*>(a + px * l.ws + 2 * q) =
        make_uint2(bf16x2_bits(v.x, v.y), bf16x2_bits(v.z, v.w));
  }
}

// in (B, H, H, Cin) -> out (B, Ho, Ho, Cout): one island block; KS = Kp / 16,
// NT the widest n-tile unit of a warp (4 or 8): the products' width.
template <int STRIDE, int KS, int NT>
__global__ void __launch_bounds__(kThreads, 1)
island_block_kernel(const float* __restrict__ in,          // (B, H, H, Cin)
                    const __nv_bfloat16* __restrict__ w,   // (9, Np, Kp + 8)
                    const float* __restrict__ bias,        // (Np)
                    float* __restrict__ out,               // (B, Ho, Ho, Cout)
                    int batch, int H, int Cin, int Cout, int n_slices,
                    int rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockLayout l = block_layout(H, Cin, Cout, STRIDE, n_slices, rows);
  const int Ho = l.Ho, n_bands = cdiv(Ho, rows), items = batch * n_bands;
  const int n0 = blockIdx.y * l.ns;         // the slice's first channel
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem + l.w);
  float* const tiles[2] = {reinterpret_cast<float*>(smem + l.tile0),
                           reinterpret_cast<float*>(smem + l.tile1)};
  uint32_t* s_a = reinterpret_cast<uint32_t*>(smem + l.a);
  float* s_st = reinterpret_cast<float*>(smem + l.stage) + warp * 16 * l.os;
  float* s_bias = reinterpret_cast<float*>(smem + l.bias);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bar);
  const bool bulk = Cin % 4 == 0;           // the tiles' rows by bulk copies

  // both tiles zeroed once: their halo columns and channel pad stay zero
  {
    uint4* z = reinterpret_cast<uint4*>(smem + l.tile0);
    const int n = static_cast<int>((l.a - l.tile0) / 16);
    for (int i = threadIdx.x; i < n; i += kThreads)
      z[i] = make_uint4(0u, 0u, 0u, 0u);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_init(bars, 1);
      mbar_init(bars + 1, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  // the slice's weights, once: a tap's rows n0 .. n0 + ns - 1 of the pack
  // are one span laid out as in shared memory; rows past Np are zeros
  {
    const int per = l.ns * l.wk / 4;        // 16-byte chunks of a tap's slice
    const int have = (l.np - n0 < l.ns ? l.np - n0 : l.ns) * l.wk / 4;
    for (int i = threadIdx.x; i < 9 * per; i += kThreads) {
      const int tap = i / per, j = i - tap * per;
      uint32_t* dst = s_w + tap * l.ns * l.wk + 4 * j;
      if (j < have)
        cp_async16(dst, w + (static_cast<size_t>(tap) * l.np + n0) * 2 * l.wk + 8 * j);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    for (int i = threadIdx.x; i < l.ns; i += kThreads)
      s_bias[i] = n0 + i < l.np ? bias[n0 + i] : 0.0f;
  }
  __syncthreads();                          // the zeros before any copy

  // tile k goes to buffer k & 1 (by bulk copies: on barrier k & 1, its
  // (k >> 1)-th phase); one cp.async group a loop step either way, empty
  // past the CTA's last tile, so that wait_group 1 leaves only the next one
  auto stage = [&](int it, int k) {
    if (bulk)
      stage_tile_bulk<STRIDE>(in, tiles[k & 1], bars + (k & 1), l, it, n_bands, H, Cin);
    else
      stage_tile<STRIDE>(in, tiles[k & 1], l, it, n_bands, H, Cin);
  };
  int item = blockIdx.x;
  if (item < items) stage(item, 0);
  cp_async_commit();
  const int nt = l.ns / 8;
  for (int k = 0; item < items; ++k, item += gridDim.x) {
    const int next = item + gridDim.x;
    if (next < items) stage(next, k + 1);
    cp_async_commit();
    if (bulk) {                             // the weights, then this tile
      cp_async_wait<0>();
      mbar_wait(bars + (k & 1), (k >> 1) & 1);
    } else {
      cp_async_wait<1>();                   // the weights and this tile
    }
    __syncthreads();                        // ... landed; A is free
    const float* x = tiles[k & 1];
    tile_to_a(x, s_a, l, Cin);
    __syncthreads();

    const int b = item / n_bands, r0 = item % n_bands * rows;
    const int n_pix = min(rows, Ho - r0) * Ho;
    const Unit un = units(n_pix, nt);
    for (int u = warp; u < un.m_tiles * un.groups; u += kWarps) {
      const int mt = u % un.m_tiles, nf = (u / un.m_tiles) * un.per;
      const int ntw = min(un.per, nt - nf);
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      // A rows g and g + 8: pixels of the band (clamped past its end: their
      // rows are computed and never written)
      const int pa = min(mt * 16 + g, n_pix - 1);
      const int pb = min(mt * 16 + g + 8, n_pix - 1);
      const uint32_t* xa = s_a + ((pa / Ho) * STRIDE * l.in_cols + (pa % Ho) * STRIDE) * l.ws + t;
      const uint32_t* xb = s_a + ((pb / Ho) * STRIDE * l.in_cols + (pb % Ho) * STRIDE) * l.ws + t;
      const uint32_t* wb = s_w + (nf * 8 + g) * l.wk + t;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * l.in_cols + tap % 3) * l.ws;
        const uint32_t* wt = wb + tap * l.ns * l.wk;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          const int kw = 8 * ks;
          const uint32_t a[4] = {xa[off + kw], xb[off + kw], xa[off + kw + 4],
                                 xb[off + kw + 4]};
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            if (j < ntw) {
              const uint32_t* br = wt + j * 8 * l.wk + kw;
              const uint32_t bf[2] = {br[0], br[4]};
              mma_bf16(acc[j], a, bf);
            }
          }
        }
      }
      // epilogue: bias, skip (from the staged fp32 tile), ReLU into the
      // warp's staging rows.  D rows g and g + 8, columns 2t and 2t + 1 of
      // each n-tile.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= n_pix) continue;
        const int oy = p / Ho, ox = p % Ho;   // oy within the band
        const float* s0 = x + (STRIDE == 1 ? (oy + 1) * l.in_cols + ox + 1
                                           : 2 * oy * l.in_cols + 2 * ox) * l.cps;
        float* st = s_st + (g + 8 * h) * l.os;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j >= ntw) continue;
          const int cl = (nf + j) * 8 + 2 * t, co = n0 + cl;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = co + e;
            float skip = 0.0f;              // the channel pad
            if (c < Cin) {
              skip = STRIDE == 1
                         ? s0[c]
                         : fmaxf(fmaxf(s0[c], s0[c + l.cps]),
                                 fmaxf(s0[c + l.in_cols * l.cps],
                                       s0[c + (l.in_cols + 1) * l.cps]));
            }
            v[e] = fmaxf((acc[j][2 * h + e] + s_bias[cl + e]) + skip, 0.0f);
          }
          *reinterpret_cast<float2*>(st + j * 8 + 2 * t) = make_float2(v[0], v[1]);
        }
      }
      __syncwarp();
      // the unit's 16 pixels x (ntw * 8) channels: a band is contiguous
      const int col = n0 + nf * 8, width = min(ntw * 8, Cout - col);
      const int valid = min(16, n_pix - mt * 16);
      float* ob = out + ((static_cast<size_t>(b) * Ho + r0) * Ho + mt * 16) * Cout + col;
      if (width > 0 && Cout % 4 == 0) {
        const int w4 = width / 4;
        const float inv = 1.0f / w4;
        for (int i = lane; i < valid * w4; i += 32) {
          const int r = fast_div(i, inv), c = i - r * w4;
          *reinterpret_cast<float4*>(ob + static_cast<size_t>(r) * Cout + 4 * c) =
              *reinterpret_cast<const float4*>(s_st + r * l.os + 4 * c);
        }
      } else if (width > 0) {
        for (int i = lane; i < valid * width; i += 32) {
          const int r = i / width, c = i % width;
          ob[static_cast<size_t>(r) * Cout + c] = s_st[r * l.os + c];
        }
      }
      __syncwarp();                         // the staging rows are free
    }
    __syncthreads();                        // this tile is free for the next
  }
}

// ----------------------------------------------------- island_chain_kernel
struct ChainBlock {
  const __nv_bfloat16* w;   // (9, Np, Kp + 8)
  const float* bias;        // (Np)
  int cin, cout, stride, H; // H: the side of the block's input map
  int cs_in, cs_out;        // channel strides (floats) of the map in and out
};
struct Chain {
  ChainBlock blk[kMaxChain];
  int n;
  int tap;                  // the block whose map goes to tap_out, or -1
};

// A block's A operand (the bf16 copy with its zero halo): pc x pc pixels of
// ws words, the interior at (off, off); ws keeps the fragment loads of 8
// neighbouring pixels on 32 banks (stride 1: 4 mod 8 words; stride 2, where
// they lie 2 pixels apart: 2 mod 8)
struct AShape {
  int pc, off, ws, kw2;
};
__host__ __device__ inline AShape a_shape(const ChainBlock& b) {
  const int kp = round_up(b.cin, 16);
  return AShape{b.stride == 1 ? b.H + 2 : b.H + 1, b.stride == 1 ? 1 : 0,
                kp / 2 + (b.stride == 1 ? 4 : 2), kp / 2};
}

// Shared memory of a chain, in bytes: the fp32 map (the largest of its
// resolutions, each at its own channel stride), the A operand (the largest
// block's), `stages` ring slots of one tap's weights (the widest block's Np
// rows of Kp / 2 + 4 words), and an mbarrier a slot.
struct ChainLayout {
  size_t map, a, ring, slot, bar, total;
  int stages;
};

__host__ __device__ inline ChainLayout chain_layout(const Chain& c) {
  size_t map = 0, a = 0, slot = 0;
  for (int k = 0; k < c.n; ++k) {
    const ChainBlock& b = c.blk[k];
    const int Ho = b.H / b.stride;
    const AShape s = a_shape(b);
    const size_t in = sizeof(float) * static_cast<size_t>(b.H) * b.H * b.cs_in;
    const size_t out = sizeof(float) * static_cast<size_t>(Ho) * Ho * b.cs_out;
    const size_t ab = sizeof(uint32_t) * static_cast<size_t>(s.pc) * s.pc * s.ws;
    const size_t wb = sizeof(uint32_t) * static_cast<size_t>(round_up(b.cout, 8)) *
                      (s.kw2 + 4);
    map = map > in ? map : in;
    map = map > out ? map : out;
    a = a > ab ? a : ab;
    slot = slot > wb ? slot : wb;
  }
  ChainLayout l;
  l.map = 0;
  l.a = round_up16(map);
  l.ring = l.a + round_up16(a);
  l.slot = slot;
  const size_t bars = sizeof(uint64_t) * kMaxStages;
  const size_t room = l.ring + bars < static_cast<size_t>(kSmemMax)
                          ? static_cast<size_t>(kSmemMax) - l.ring - bars : 0;
  const size_t fit = slot ? room / slot : 0;
  l.stages = static_cast<int>(fit < static_cast<size_t>(kMaxStages) ? fit : kMaxStages);
  l.bar = l.ring + l.stages * slot;
  l.total = l.bar + bars;
  return l;
}

// The widest n-tile unit of a warp on block b of a chain, rounded up to 4:
// the products' width, so that no issue slot goes to an n-tile a warp does
// not have (3 n-tiles a warp at 8x8, 11 at 16x16).
__host__ __device__ inline int block_nt(const ChainBlock& b) {
  const int Ho = b.H / b.stride;
  return round_up(units(Ho * Ho, round_up(b.cout, 8) / 8).per, 4);
}

// The chain kernel's state on one CTA: its shared memory and its stream of
// weight taps (9 a block, image after image).
struct ChainCta {
  float* map;
  uint32_t* a;
  uint32_t* ring;
  uint64_t* bar;            // a barrier a ring slot
  int slot_words, stages, taps, steps;
};

// step q of the CTA's stream (image q / taps of the CTA's, block q % taps /
// 9, tap q % 9) into slot q % stages: one bulk copy of the tap's Np rows of
// Kp + 8 bf16 (the slot's own image), counted on the slot's barrier
__device__ void load_tap(const Chain& chain, const ChainCta& c, int q) {
  if (q >= c.steps || threadIdx.x != 0) return;
  const ChainBlock& b = chain.blk[(q % c.taps) / 9];
  const int bytes = round_up(b.cout, 8) * (round_up(b.cin, 16) + 8) * 2;
  uint64_t* bar = c.bar + q % c.stages;
  mbar_expect(bar, bytes);
  bulk_copy(c.ring + (q % c.stages) * c.slot_words,
            reinterpret_cast<const unsigned char*>(b.w) +
                static_cast<size_t>(q % 9) * bytes,
            bytes, bar);
}

// step q's tap has landed: the (q / stages)-th phase of its slot's barrier
__device__ __forceinline__ void wait_tap(const ChainCta& c, int q) {
  mbar_wait(c.bar + q % c.stages, (q / c.stages) & 1);
}

// b's output map (Ho x Ho x cout at cs_out) to dst, 16 bytes at a time
__device__ void write_map(const ChainBlock& b, const float* map, float* dst) {
  const int Ho = b.H / b.stride, c4 = b.cout / 4;
  const float inv = 1.0f / c4;
  for (int i = threadIdx.x; i < Ho * Ho * c4; i += kThreads) {
    const int p = fast_div(i, inv);
    *reinterpret_cast<float4*>(dst + 4 * static_cast<size_t>(i)) =
        *reinterpret_cast<const float4*>(map + p * b.cs_out + 4 * (i - p * c4));
  }
}

// Block k of a chain on the CTA's image, from step q of its stream: the
// products of its 9 taps, then the epilogue into the map and the next
// block's A operand.  NT = block_nt(blk[k]).
template <int NT>
__device__ void chain_block(const Chain& chain, const ChainCta& c, int k,
                            int& q) {
  const ChainBlock& b = chain.blk[k];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int H = b.H, s = b.stride, Ho = H / s, n_pix = Ho * Ho;
  const AShape as = a_shape(b);
  const int np = round_up(b.cout, 8), nt = np / 8, wk = as.kw2 + 4;
  const Unit un = units(n_pix, nt);
  const bool busy = warp < un.m_tiles * un.groups;
  const int mt = warp % un.m_tiles, nf = (warp / un.m_tiles) * un.per;
  const int ntw = busy ? min(un.per, nt - nf) : 0;
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
  const int pa = min(mt * 16 + g, n_pix - 1);
  const int pb = min(mt * 16 + g + 8, n_pix - 1);
  const uint32_t* xa = c.a + ((pa / Ho) * s * as.pc + (pa % Ho) * s) * as.ws + t;
  const uint32_t* xb = c.a + ((pb / Ho) * s * as.pc + (pb % Ho) * s) * as.ws + t;
  for (int tap = 0; tap < 9; ++tap, ++q) {
    wait_tap(c, q);
    __syncthreads();                        // every warp is past tap q - 1
    load_tap(chain, c, q + c.stages - 1);   // into tap q - 1's slot
    if (ntw == 0) continue;
    const uint32_t* wt = c.ring + (q % c.stages) * c.slot_words + (nf * 8 + g) * wk + t;
    const int off = ((tap / 3) * as.pc + tap % 3) * as.ws;
    for (int kw = 0; kw < as.kw2; kw += 8) {
      const uint32_t a[4] = {xa[off + kw], xb[off + kw], xa[off + kw + 4],
                             xb[off + kw + 4]};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < ntw) {
          const uint32_t* br = wt + j * 8 * wk + kw;
          const uint32_t bf[2] = {br[0], br[4]};
          mma_bf16(acc[j], a, bf);
        }
      }
    }
  }
  __syncthreads();                          // every product done: A is free

  // epilogue: bias, skip, ReLU; the fp32 map, and the next block's A
  const bool more = k + 1 < chain.n;
  AShape na{0, 0, 0, 0};
  if (more) na = a_shape(chain.blk[k + 1]);
  float sk[kSkipNT][4];                     // stride 2: the pooled skips
  if (s == 2) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      const int oy = p / Ho, ox = p % Ho;
      const float* si = c.map + (2 * oy * H + 2 * ox) * b.cs_in;
#pragma unroll
      for (int j = 0; j < kSkipNT; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int ch = (nf + j) * 8 + 2 * t + e;
          float v = 0.0f;
          if (j < ntw && p < n_pix && ch < b.cin)
            v = fmaxf(fmaxf(si[ch], si[ch + b.cs_in]),
                      fmaxf(si[ch + H * b.cs_in], si[ch + (H + 1) * b.cs_in]));
          sk[j][2 * h + e] = v;
        }
      }
    }
    __syncthreads();                        // every skip read: the map is free
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = mt * 16 + g + 8 * h;
    if (p >= n_pix) continue;
    const int oy = p / Ho, ox = p % Ho;
    float* so = c.map + (oy * Ho + ox) * b.cs_out;   // in place at stride 1
    uint32_t* ao = c.a + ((oy + na.off) * na.pc + ox + na.off) * na.ws;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j >= ntw) continue;
      const int co = (nf + j) * 8 + 2 * t;
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float skip = 0.0f;                  // the channel pad
        if (s == 2)
          skip = sk[j < kSkipNT ? j : 0][2 * h + e];
        else if (co + e < b.cin)
          skip = so[co + e];
        v[e] = fmaxf((acc[j][2 * h + e] + __ldg(b.bias + co + e)) + skip, 0.0f);
      }
      if (co < b.cout)                      // Cout % 4 == 0: co + 1 too
        *reinterpret_cast<float2*>(so + co) = make_float2(v[0], v[1]);
      if (more) ao[co / 2] = bf16x2_bits(v[0], v[1]);
    }
  }
  // the next A's halo and K pad, unless it has this A's shape: then they
  // are zero already (a chain never narrows, so the words past this
  // epilogue's np / 2 were past the last one's)
  if (more && (na.pc != as.pc || na.off != as.off || na.ws != as.ws ||
               na.kw2 != as.kw2)) {
    const int from = np / 2;
    const float inv_w = 1.0f / na.kw2, inv_p = 1.0f / na.pc;
    for (int i = threadIdx.x; i < na.pc * na.pc * na.kw2; i += kThreads) {
      const int px = fast_div(i, inv_w), wd = i - px * na.kw2;
      const int pr = fast_div(px, inv_p);
      const int r = pr - na.off, cc = px - pr * na.pc - na.off;
      if (r < 0 || r >= Ho || cc < 0 || cc >= Ho || wd >= from)
        c.a[px * na.ws + wd] = 0u;
    }
  }
  __syncthreads();                          // the map and A are the block's
}

// A run of island blocks, one image per CTA (persistent over images), its
// map on chip throughout.
__global__ void __launch_bounds__(kThreads, 1)
island_chain_kernel(const float* __restrict__ in,   // (B, H, H, Cin) of blk[0]
                    float* __restrict__ out,         // the last block's map
                    float* __restrict__ tap_out,     // blk[tap]'s map, or null
                    const __grid_constant__ Chain chain, int batch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainLayout l = chain_layout(chain);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + l.bar);
  ChainCta c;
  c.bar = bars;
  c.map = reinterpret_cast<float*>(smem + l.map);
  c.a = reinterpret_cast<uint32_t*>(smem + l.a);
  c.ring = reinterpret_cast<uint32_t*>(smem + l.ring);
  c.slot_words = static_cast<int>(l.slot / sizeof(uint32_t));
  c.stages = l.stages;
  c.taps = 9 * chain.n;
  c.steps = (blockIdx.x < batch ? cdiv(batch - blockIdx.x, gridDim.x) : 0) * c.taps;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kMaxStages; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int s = 0; s < c.stages - 1; ++s) load_tap(chain, c, s);
  int q = 0;
  const ChainBlock& b0 = chain.blk[0];
  const ChainBlock& bl = chain.blk[chain.n - 1];
  const int in_pix = b0.H * b0.H, out_ho = bl.H / bl.stride;
  for (int img = blockIdx.x; img < batch; img += gridDim.x) {
    // the image's map, 16 bytes at a time, at the first block's stride
    {
      const float* src = in + static_cast<size_t>(img) * in_pix * b0.cin;
      const int c4 = b0.cin / 4;
      const float inv = 1.0f / c4;
      for (int i = threadIdx.x; i < in_pix * c4; i += kThreads) {
        const int p = fast_div(i, inv);
        cp_async16(c.map + p * b0.cs_in + 4 * (i - p * c4), src + 4 * i);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
    }
    // the first block's A operand from the map: bf16 pairs, zero halo and pad
    {
      const AShape a = a_shape(b0);
      const float inv_w = 1.0f / a.kw2, inv_p = 1.0f / a.pc;
      for (int i = threadIdx.x; i < a.pc * a.pc * a.kw2; i += kThreads) {
        const int px = fast_div(i, inv_w), wd = i - px * a.kw2;
        const int pr = fast_div(px, inv_p);
        const int r = pr - a.off, cc = px - pr * a.pc - a.off;
        uint32_t v = 0u;
        if (r >= 0 && r < b0.H && cc >= 0 && cc < b0.H && 2 * wd < b0.cin) {
          const float2 f = *reinterpret_cast<const float2*>(
              c.map + (r * b0.H + cc) * b0.cs_in + 2 * wd);
          v = bf16x2_bits(f.x, f.y);
        }
        c.a[px * a.ws + wd] = v;
      }
      __syncthreads();
    }
    for (int k = 0; k < chain.n; ++k) {
      const ChainBlock& b = chain.blk[k];
      switch (block_nt(b)) {
        case 4: chain_block<4>(chain, c, k, q); break;
        case 8: chain_block<8>(chain, c, k, q); break;
        default: chain_block<12>(chain, c, k, q); break;
      }
      if (k == chain.tap)
        write_map(b, c.map, tap_out + static_cast<size_t>(img) * (b.H / b.stride) *
                                          (b.H / b.stride) * b.cout);
    }
    write_map(bl, c.map, out + static_cast<size_t>(img) * out_ho * out_ho * bl.cout);
    __syncthreads();                        // the map is read: the next image
  }
}

// ------------------------------------------------------------------ host
// CTAs of `Kernel` one SM holds at `smem` bytes, times the SMs.  The
// dynamic shared memory limit is raised once per kernel and device; the fit
// is read once per kernel, size and device (not per launch).
template <auto Kernel>
int resident_ctas(size_t smem, int* ctas) {
  struct Fit { int smem, ctas; };
  constexpr int kSizes = 16;
  static bool raised[kMaxDevices] = {};
  static Fit fit[kMaxDevices][kSizes] = {};
  static int n_fit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrTooWide;
  if (!raised[dev]) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    raised[dev] = true;
  }
  for (int i = 0; i < n_fit[dev]; ++i)
    if (fit[dev][i].smem == static_cast<int>(smem)) {
      *ctas = fit[dev][i].ctas;
      return 0;
    }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel, kThreads,
                                                      smem);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int found = n_fit[dev] < kSizes ? n_fit[dev]++ : 0;
  fit[dev][found] = Fit{static_cast<int>(smem), (per_sm > 0 ? per_sm : 1) * sms};
  *ctas = fit[dev][found].ctas;
  return 0;
}

bool block_takes(int H, int Cin, int Cout, int stride) {
  return Cin >= 1 && Cout >= Cin && Cout <= kMaxChannels && H >= 1 &&
         (stride == 1 || stride == 2) && (stride == 1 || H % 2 == 0);
}

template <int STRIDE, int KS, int NT>
int launch_block_nt(const float* x, const __nv_bfloat16* w, const float* bias,
                    float* out, int batch, int H, int Cin, int Cout,
                    int n_slices, int rows, cudaStream_t stream) {
  const BlockLayout l = block_layout(H, Cin, Cout, STRIDE, n_slices, rows);
  const int items = batch * cdiv(l.Ho, rows);
  int ctas = 0;
  const int err = resident_ctas<island_block_kernel<STRIDE, KS, NT>>(l.total, &ctas);
  if (err != 0) return err;
  int gx = ctas / n_slices;
  if (gx < 1) gx = 1;
  if (gx > items) gx = items;
  island_block_kernel<STRIDE, KS, NT><<<dim3(gx, n_slices), kThreads, l.total, stream>>>(
      x, w, bias, out, batch, H, Cin, Cout, n_slices, rows);
  return static_cast<int>(cudaGetLastError());
}

// NT of a launch: the unit of its tallest tile, which no shorter tile's
// exceeds (fewer m-tiles split the n-tiles over more warps)
template <int STRIDE, int KS>
int launch_block_ks(const float* x, const __nv_bfloat16* w, const float* bias,
                    float* out, int batch, int H, int Cin, int Cout,
                    int n_slices, int rows, cudaStream_t stream) {
  const BlockLayout l = block_layout(H, Cin, Cout, STRIDE, n_slices, rows);
  const int rows_max = rows < l.Ho ? rows : l.Ho;
  if (units(rows_max * l.Ho, l.ns / 8).per <= 4)
    return launch_block_nt<STRIDE, KS, 4>(x, w, bias, out, batch, H, Cin, Cout,
                                          n_slices, rows, stream);
  return launch_block_nt<STRIDE, KS, 8>(x, w, bias, out, batch, H, Cin, Cout,
                                        n_slices, rows, stream);
}

template <int STRIDE>
int launch_block(const float* x, const __nv_bfloat16* w, const float* bias,
                 float* out, int batch, int H, int Cin, int Cout,
                 cudaStream_t stream) {
  int n_slices = 0, rows = 0;
  if (!block_plan(batch, H, Cin, Cout, STRIDE, &n_slices, &rows))
    return kErrTooWide;
  switch (round_up(Cin, 16) / 16) {
#define KS_CASE(K)                                                           \
  case K:                                                                    \
    return launch_block_ks<STRIDE, K>(x, w, bias, out, batch, H, Cin, Cout,  \
                                      n_slices, rows, stream);
    KS_CASE(1) KS_CASE(2) KS_CASE(3) KS_CASE(4)
    KS_CASE(5) KS_CASE(6) KS_CASE(7) KS_CASE(8)
#undef KS_CASE
    default:
      return kErrTooWide;
  }
}

// The chain of n blocks (channels[0..n], strides[0..n-1], input side H) with
// its channel strides: a map resolution's stride is the widest map it holds
// (the chain's input, or a block's output), a multiple of 4.  Returns the
// widest unit of n-tiles a warp takes (block_nt's widest), or 0 when the
// kernel does not take the chain.
int make_chain(const int* channels, const int* strides, int n, int H, int tap,
               Chain* c) {
  if (n < 1 || n > kMaxChain || tap < -1 || tap >= n) return 0;
  *c = Chain{};
  c->n = n;
  c->tap = tap;
  int widest[kMaxChain + 1] = {}, level[kMaxChain] = {}, lv = 0, per = 0;
  widest[0] = channels[0];
  for (int k = 0; k < n; ++k) {
    ChainBlock& b = c->blk[k];
    b.cin = channels[k];
    b.cout = channels[k + 1];
    b.stride = strides[k];
    b.H = H;
    if (!block_takes(H, b.cin, b.cout, b.stride) || b.cin % 4 || b.cout % 4 ||
        H * H > kChainPixels)
      return 0;
    level[k] = lv;
    if (b.stride == 2) ++lv;
    if (b.cout > widest[lv]) widest[lv] = b.cout;
    H /= b.stride;
    const Unit u = units(H * H, round_up(b.cout, 8) / 8);
    if ((b.stride == 2 && u.per > kSkipNT) || u.per > kChainNT) return 0;
    if (u.per > per) per = u.per;
  }
  for (int k = 0; k < n; ++k) {
    c->blk[k].cs_in = round_up(widest[level[k]], 4);
    c->blk[k].cs_out = round_up(widest[level[k] + (c->blk[k].stride == 2)], 4);
  }
  return chain_layout(*c).stages >= 2 ? round_up(per, 4) : 0;
}

}  // namespace

// One island block on `stream`; returns 0, a CUDA error code, or -1
// (kErrTooWide) for a shape the kernel does not take.
//
//   x      (B, H, H, Cin) float32 NHWC, device, 16-byte aligned
//   w      (9, Np, Kp + 8) bf16, device, 16-byte aligned: the composed
//          kernel K[tap][co][ci] rounded to bf16, zero-padded to Np = Cout
//          rounded up to 8 and Kp + 8 (Kp = Cin rounded up to 16), tap =
//          3 a + b
//   bias   (Np) float32, device: dw_bias @ pw + pw_bias, zero-padded
//   out    (B, H / stride, H / stride, Cout) float32 NHWC, device, 16-byte
//          aligned
//   stride 1 or 2 (H even at stride 2); Cin <= Cout <= 128
extern "C" int headpose_dense_bf16_block(const float* x,
                                         const __nv_bfloat16* w,
                                         const float* bias, float* out,
                                         int batch, int H, int Cin, int Cout,
                                         int stride, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (!block_takes(H, Cin, Cout, stride)) return kErrTooWide;
  return stride == 1 ? launch_block<1>(x, w, bias, out, batch, H, Cin, Cout, stream)
                     : launch_block<2>(x, w, bias, out, batch, H, Cin, Cout, stream);
}

// The plan of one block: plan[0..2] = n_slices, rows, shared memory bytes.
// Returns 0, or -1 when the kernel does not take the block.
extern "C" int headpose_dense_bf16_block_plan(int batch, int H, int Cin,
                                              int Cout, int stride, int* plan) {
  int n_slices = 0, rows = 0;
  if (batch < 1 || !block_takes(H, Cin, Cout, stride) ||
      !block_plan(batch, H, Cin, Cout, stride, &n_slices, &rows))
    return kErrTooWide;
  plan[0] = n_slices;
  plan[1] = rows;
  plan[2] = static_cast<int>(block_layout(H, Cin, Cout, stride, n_slices, rows).total);
  return 0;
}

// The layout of one chain: plan[0..3] = ring stages, shared memory bytes,
// the map's bytes, NT.  Returns 0, or -1 when the kernel does not take it.
extern "C" int headpose_dense_bf16_chain_plan(const int* channels,
                                              const int* strides, int n, int H,
                                              int* plan) {
  Chain c;
  const int nt = make_chain(channels, strides, n, H, -1, &c);
  if (nt == 0) return kErrTooWide;
  const ChainLayout l = chain_layout(c);
  plan[0] = l.stages;
  plan[1] = static_cast<int>(l.total);
  plan[2] = static_cast<int>(l.a);
  plan[3] = nt;
  return 0;
}

// A run of n island blocks in one launch on `stream`; returns 0, a CUDA
// error code, or -1 for a chain the kernel does not take.
//
//   x         (B, H, H, channels[0]) float32 NHWC, device, 16-byte aligned
//   w, bias   per block, as headpose_dense_bf16_block takes them
//   channels  n + 1 channel counts (each a multiple of 4, at most 128);
//   strides   n strides; H the first block's input side (H * H <= 256)
//   tap       the block (0 .. n - 2) whose map goes to tap_out, or -1
//   out       the last block's map, float32 NHWC, device, 16-byte aligned
extern "C" int headpose_dense_bf16_chain(const float* x,
                                         const void* const* w,
                                         const void* const* bias,
                                         const int* channels,
                                         const int* strides, int n, int H,
                                         int tap, float* out, float* tap_out,
                                         int batch, cudaStream_t stream) {
  Chain c;
  const int nt = make_chain(channels, strides, n, H, tap, &c);
  if (nt == 0 || (tap >= 0 && tap_out == nullptr)) return kErrTooWide;
  if (batch <= 0) return 0;
  for (int k = 0; k < n; ++k) {
    c.blk[k].w = static_cast<const __nv_bfloat16*>(w[k]);
    c.blk[k].bias = static_cast<const float*>(bias[k]);
  }
  const size_t smem = chain_layout(c).total;
  int ctas = 0;
  const int err = resident_ctas<island_chain_kernel>(smem, &ctas);
  if (err != 0) return err;
  const int grid = batch < ctas ? batch : ctas;
  island_chain_kernel<<<grid, kThreads, smem, stream>>>(x, out, tap_out, c, batch);
  return static_cast<int>(cudaGetLastError());
}
