// One island block of a dense-composed BlazeFace backbone at single-pass
// bf16, on NVIDIA Hopper's tensor cores (sm_90a).
//
// Has no Pallas counterpart: the JAX package runs an island block as an XLA
// conv at Precision.DEFAULT (headpose_tpu/models/blazeface.py::BlazeFace.
// apply, dense=True with the block in fast_blocks), the function of the
// detector's precision="turbo" and "max" islands.  The plain PyTorch
// version is headpose_tpu_torch/models/blazeface.py::BlazeBlock.forward
// with dense and fast (ops/kernels/dense_bf16.py::dense_block_plain), the
// wrapper ops/kernels/dense_bf16.py::dense_block.
//
// Semantics (NHWC, float32 maps), one block:
//   K[a,b,ci,co] = dw[a,b,ci] * pw[ci,co] in fp32, rounded once to bf16 (the
//       wrapper's pack); bias = dw_bias @ pw + pw_bias in fp32, unrounded;
//   t = conv3x3/s(bf16(x), K) + bias: x rounded to bf16 (nearest, ties to
//       even) as it is staged, every product of two bf16 values exact in
//       fp32, the sums fp32 (TF SAME: stride 1 pads 1/1, stride 2 0/1);
//   y = relu(t + skip), skip = x (fp32, unrounded), max-pooled 2x2/2 at
//       stride 2, zero-padded on the channel axis when the block widens.
// cuDNN's bf16 conv rounds its output to bf16 as well, a second rounding the
// function does not make; its fp32 conv on pre-rounded operands computes the
// function but leaves the tensor cores idle.  Neither is used by the port.
//
// What bounds it on this card: bytes.  The front model's "turbo" island
// (blocks 10-15) at B=128 reads its inputs and writes its outputs once: 63
// MB of fp32, 0.019 ms at 3.35 TB/s, against 10.8 GFLOP on the tensor cores
// (0.011 ms at 989 TFLOP/s).  chip_smoke.py recomputes both per block.
//
// Design: an implicit GEMM, M = output pixels, N = Cout padded to 8, K = 9
// taps of Cin padded to 16 (Kp).  A CTA of 256 threads owns one slice of at
// most 64 output channels (blockIdx.y) and keeps that slice's bf16 weights,
// 9 x slice x Kp, in shared memory for its whole life (16-byte cp.async,
// rows padded by 16 bytes so that a warp's B-fragment loads hit 32 banks);
// it walks work items, each a band of output rows of one image holding at
// most 128 pixels (blockIdx.x, stride gridDim.x).  Per item the input rows
// the band reads, with the halo and the zero pad, are staged as bf16 pairs
// (__floats2bfloat162_rn), a pixel a row of Kp/2 + 4 words at stride 1 and
// Kp/2 + 2 at stride 2, so that the A-fragment loads of 8 neighbouring
// pixels hit 32 banks.  A warp takes 16 pixels and up to 8 n-tiles of 8
// channels and issues, per tap and 16 input channels, one mma.sync.
// m16n8k16 bf16 -> fp32 per n-tile; on small maps two warps share an m-tile
// and split its n-tiles.  One epilogue adds the bias and the skip (read in
// fp32 from the input in global memory), applies the ReLU and writes fp32.
// One launch per block; a chain launch over a run of small-map blocks, and
// overlap of the next item's staging with the current item's products, are
// later work.  mma.sync, not wgmma: 24-128 channels are narrower than a
// warpgroup's tile, and bytes, not the tensor cores, bound the block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxPixels = 16 * kWarps;   // output pixels per work item
constexpr int kMaxSlice = 64;             // output channels per CTA
constexpr int kNT = kMaxSlice / 8;        // n-tiles a warp takes at most
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kMaxChannels = 128;
constexpr int kMaxDevices = 64;
constexpr int kErrTooWide = -1;           // a shape the kernel does not take

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
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

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  uint32_t u;
  memcpy(&u, &v, sizeof(u));
  return u;
}

// The shape of one launch and its shared memory, in bytes: the weight slice
// (9 taps x ns rows of wk words), the staged input (in_rows x in_cols pixels
// of ws words) and the bias slice (ns floats).
struct Layout {
  int Ho, band, in_rows, in_cols, kp, np, n_slices, ns, ws, wk;
  size_t x, bias, total;
};

__host__ __device__ inline Layout layout(int H, int Cin, int Cout, int stride,
                                         int band) {
  Layout l;
  l.Ho = H / stride;
  l.band = band;
  l.in_rows = stride == 1 ? band + 2 : 2 * band + 1;
  l.in_cols = stride == 1 ? H + 2 : H + 1;
  l.kp = round_up(Cin, 16);
  l.np = round_up(Cout, 8);
  l.n_slices = cdiv(l.np, kMaxSlice);
  l.ns = round_up(cdiv(l.np, l.n_slices), 8);
  l.ws = l.kp / 2 + (stride == 1 ? 4 : 2);
  l.wk = l.kp / 2 + 4;
  l.x = sizeof(uint32_t) * 9 * static_cast<size_t>(l.ns) * l.wk;
  l.bias = l.x + sizeof(uint32_t) * static_cast<size_t>(l.in_rows) *
                     l.in_cols * l.ws;
  l.total = l.bias + sizeof(float) * l.ns;
  return l;
}

// in (B, H, H, Cin) -> out (B, Ho, Ho, Cout): one island block.
template <int STRIDE>
__global__ void __launch_bounds__(kThreads, 1)
dense_kernel(const float* __restrict__ in,            // (B, H, H, Cin)
             const __nv_bfloat16* __restrict__ w,     // (9, Np, Kp)
             const float* __restrict__ bias,          // (Np)
             float* __restrict__ out,                 // (B, Ho, Ho, Cout)
             int batch, int H, int Cin, int Cout, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(H, Cin, Cout, STRIDE, band);
  const int Ho = l.Ho, n_bands = cdiv(Ho, band), items = batch * n_bands;
  const int kw2 = l.kp / 2;                 // words of a pixel's channels
  const int n0 = blockIdx.y * l.ns;         // the slice's first channel
  uint32_t* s_w = reinterpret_cast<uint32_t*>(smem);
  uint32_t* s_x = reinterpret_cast<uint32_t*>(smem + l.x);
  float* s_bias = reinterpret_cast<float*>(smem + l.bias);

  // the slice's weights, once: rows past Np are zeros
  {
    const int chunks = l.kp / 8;            // 16-byte chunks of a row
    for (int i = threadIdx.x; i < 9 * l.ns * chunks; i += kThreads) {
      const int c = i % chunks, r = (i / chunks) % l.ns, tap = i / (chunks * l.ns);
      uint32_t* dst = s_w + (tap * l.ns + r) * l.wk + 4 * c;
      if (n0 + r < l.np)
        cp_async16(dst, w + (static_cast<size_t>(tap) * l.np + n0 + r) * l.kp + 8 * c);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < l.ns; i += kThreads)
      s_bias[i] = n0 + i < Cout ? bias[n0 + i] : 0.0f;
  }

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt_slice = l.ns / 8;
  const int col0 = STRIDE == 1 ? -1 : 0;    // input col of staged col 0
  const bool pairs = (Cin % 2) == 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int b = item / n_bands, r0 = item % n_bands * band;
    const int rows = min(band, Ho - r0), n_pix = rows * Ho;
    const int row0 = STRIDE == 1 ? r0 - 1 : 2 * r0;   // input row of staged row 0
    const float* ib = in + static_cast<size_t>(b) * H * H * Cin;
    __syncthreads();                        // the last item's loads are done
    // stage: bf16 pairs of channels, zeros in the halo, pad and K pad
    for (int i = threadIdx.x; i < l.in_rows * l.in_cols * kw2; i += kThreads) {
      const int c2 = i % kw2, pix = i / kw2;
      const int r = row0 + pix / l.in_cols, col = col0 + pix % l.in_cols;
      const int c = 2 * c2;
      float v0 = 0.0f, v1 = 0.0f;
      if (r >= 0 && r < H && col >= 0 && col < H && c < Cin) {
        const float* src = ib + (static_cast<size_t>(r) * H + col) * Cin + c;
        if (pairs) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(src));
          v0 = v.x;
          v1 = v.y;
        } else {
          v0 = __ldg(src);
          v1 = c + 1 < Cin ? __ldg(src + 1) : 0.0f;
        }
      }
      s_x[pix * l.ws + c2] = bf16x2_bits(__floats2bfloat162_rn(v0, v1));
    }
    cp_async_wait_all();
    __syncthreads();

    // a warp's share: m-tile mt and n-tiles nt_first .. + ntw of the slice
    const int m_tiles = cdiv(n_pix, 16);
    int n_groups = kWarps / m_tiles;
    if (n_groups < 1) n_groups = 1;
    if (n_groups > nt_slice) n_groups = nt_slice;
    const int per_group = cdiv(nt_slice, n_groups);
    for (int pair = warp; pair < m_tiles * n_groups; pair += kWarps) {
      const int mt = pair % m_tiles, ng = pair / m_tiles;
      const int nt_first = ng * per_group;
      const int ntw = min(per_group, nt_slice - nt_first);
      float acc[kNT][4];
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      // A rows g and g + 8: pixels of the band (clamped past its end: their
      // rows are computed and never written)
      const int p_a = min(mt * 16 + g, n_pix - 1);
      const int p_b = min(mt * 16 + g + 8, n_pix - 1);
      const uint32_t* xa =
          s_x + ((p_a / Ho) * STRIDE * l.in_cols + (p_a % Ho) * STRIDE) * l.ws + t;
      const uint32_t* xb =
          s_x + ((p_b / Ho) * STRIDE * l.in_cols + (p_b % Ho) * STRIDE) * l.ws + t;
      const uint32_t* wb = s_w + (nt_first * 8 + g) * l.wk + t;
      for (int tap = 0; tap < 9; ++tap) {
        const int off = ((tap / 3) * l.in_cols + tap % 3) * l.ws;
        const uint32_t* wt = wb + tap * l.ns * l.wk;
        for (int kw = 0; kw < kw2; kw += 8) {
          const uint32_t a[4] = {xa[off + kw], xb[off + kw], xa[off + kw + 4],
                                 xb[off + kw + 4]};
#pragma unroll
          for (int j = 0; j < kNT; ++j) {
            if (j < ntw) {
              const uint32_t* br = wt + j * 8 * l.wk + kw;
              const uint32_t bf[2] = {br[0], br[4]};
              mma_bf16(acc[j], a, bf);
            }
          }
        }
      }
      // epilogue: bias, skip, ReLU, fp32 out.  D rows g and g + 8, columns
      // 2t and 2t + 1 of each n-tile.
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= n_pix) continue;
        const int oy = r0 + p / Ho, ox = p % Ho;
        float* o = out + ((static_cast<size_t>(b) * Ho + oy) * Ho + ox) * Cout;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          if (j >= ntw) continue;
          const int cl = (nt_first + j) * 8 + 2 * t, co = n0 + cl;
          float v[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = co + e;
            float skip = 0.0f;              // the channel pad
            if (c < Cin) {
              if (STRIDE == 1) {
                skip = __ldg(ib + (static_cast<size_t>(oy) * H + ox) * Cin + c);
              } else {                      // 2x2 max pool of rows 2oy, 2oy+1
                const float* s = ib + (static_cast<size_t>(2 * oy) * H + 2 * ox) * Cin + c;
                skip = fmaxf(fmaxf(__ldg(s), __ldg(s + Cin)),
                             fmaxf(__ldg(s + H * Cin), __ldg(s + H * Cin + Cin)));
              }
            }
            v[e] = fmaxf((acc[j][2 * h + e] + s_bias[cl + e]) + skip, 0.0f);
          }
          if (co < Cout) o[co] = v[0];
          if (co + 1 < Cout) o[co + 1] = v[1];
        }
      }
    }
  }
}

// The widest band (output rows per item, at most kMaxPixels pixels) whose
// CTA fits in a block's shared memory; 0 when not even one row does.
int pick_band(int H, int Cin, int Cout, int stride) {
  const int Ho = H / stride;
  int band = kMaxPixels / Ho;
  if (band > Ho) band = Ho;
  if (band < 1) band = 1;
  while (band > 1 && layout(H, Cin, Cout, stride, band).total >
                         static_cast<size_t>(kSmemMax))
    --band;
  return layout(H, Cin, Cout, stride, band).total <=
                 static_cast<size_t>(kSmemMax)
             ? band
             : 0;
}

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

template <int STRIDE>
int launch(const float* x, const __nv_bfloat16* w, const float* bias,
           float* out, int batch, int H, int Cin, int Cout,
           cudaStream_t stream) {
  const int band = pick_band(H, Cin, Cout, STRIDE);
  if (band == 0) return kErrTooWide;
  const Layout l = layout(H, Cin, Cout, STRIDE, band);
  const int items = batch * cdiv(l.Ho, band);
  int ctas = 0;
  const int err = resident_ctas<dense_kernel<STRIDE>>(l.total, &ctas);
  if (err != 0) return err;
  int gx = ctas / l.n_slices;
  if (gx < 1) gx = 1;
  if (gx > items) gx = items;
  dense_kernel<STRIDE><<<dim3(gx, l.n_slices), kThreads, l.total, stream>>>(
      x, w, bias, out, batch, H, Cin, Cout, band);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One island block on `stream`; returns 0, a CUDA error code, or -1
// (kErrTooWide) for a shape the kernel does not take.
//
//   x      (B, H, H, Cin) float32 NHWC, device, 8-byte aligned
//   w      (9, Np, Kp) bf16, device, 16-byte aligned: the composed kernel
//          K[tap][co][ci] rounded to bf16, zero-padded to Np = Cout rounded
//          up to 8 and Kp = Cin rounded up to 16 (tap = 3 a + b)
//   bias   (Np) float32, device: dw_bias @ pw + pw_bias, zero-padded
//   out    (B, H / stride, H / stride, Cout) float32 NHWC, device
//   stride 1 or 2 (H even at stride 2); Cin <= Cout <= 128
extern "C" int headpose_dense_bf16_block(const float* x,
                                         const __nv_bfloat16* w,
                                         const float* bias, float* out,
                                         int batch, int H, int Cin, int Cout,
                                         int stride, cudaStream_t stream) {
  if (batch <= 0) return 0;
  if (Cin < 1 || Cout < Cin || Cout > kMaxChannels || H < 1 ||
      (stride != 1 && stride != 2) || (stride == 2 && H % 2))
    return kErrTooWide;
  return stride == 1 ? launch<1>(x, w, bias, out, batch, H, Cin, Cout, stream)
                     : launch<2>(x, w, bias, out, batch, H, Cin, Cout, stream);
}
