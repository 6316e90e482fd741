// Split-bf16 BlazeFace segments for NVIDIA Hopper (sm_90a): blocks 0-10 and
// 12-15 of the backbone, each one fused launch, with the pointwise 1x1 on the
// tensor cores.
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/backbone2.py::
// _make_segment_kernel (run_segment, driven by apply_fused; _block_s1_flat,
// _block_s1_planes, _block_s2_planes, _pw_matmul).  The plain PyTorch
// version is headpose_tpu_torch/ops/kernels/backbone2.py::run_segment_plain,
// the wrapper run_segment / apply_fused.  The stem and block 11 stay outside
// in fp32, as in the JAX function (csrc/backbone.cu's entry points).
//
// Semantics (NHWC, float32 maps), per block:
//   d = dw3x3/s(y) + b_dw in fp32 (TF SAME: stride 1 pads 1/1, stride 2 pads
//       0/1);
//   d_hi = bf16(d), d_lo = bf16(d - d_hi), both round-to-nearest-even (the
//       difference is exact in fp32); likewise w_hi, w_lo of the pointwise
//       weights (split once by the wrapper);
//   t = d_hi.w_hi + d_lo.w_hi + d_hi.w_lo, products exact, fp32 accumulate
//       (3-pass split-bf16: the dropped lo.lo term is below 2^-16 relative);
//   y' = relu((t + b_pw) + skip), skip = y, max-pooled 2x2/2 at stride 2,
//       zero-padded on the channel axis when the block widens.
//
// What bounds it on this card: bytes.  At B=128 the four segments take the
// stem's output (64x64x24) and block 11's (8x8x96) and write feat88
// (16x16x88) and feat96 (8x8x96): 68 MB of fp32, 0.020 ms at 3.35 TB/s.
// Their 17.7 M pointwise multiply-adds per image are 13.6 GFLOP on the tensor
// cores over three passes (0.014 ms at 989 TFLOP/s), and the depthwise,
// biases, skips and ReLUs 1.2 GFLOP of fp32 on the CUDA cores (0.018 ms at
// 67 TFLOP/s).  chip_smoke.py recomputes these from the shapes.
//
// Design: csrc/backbone.cu's structure with the product moved to the tensor
// cores.  One launch per block; a CTA of 256 threads takes one image
// (grid.y) and a band of output rows (grid.x) and stages its input rows with
// the halo, zero-padded, in shared memory, so each launch reads its input map
// once and writes its output map once; the depthwise result, its split, the
// bias, the skip and the ReLU never leave the SM.  Phase 1 computes the
// depthwise result of the band (one thread per pixel and channel) and writes
// its hi and lo halves as bf16 rows of the A operand, [pixel][channel], K
// padded with zeros to a multiple of 16 and each row 8 elements longer than
// K so that the fragment loads of a warp hit 32 different banks.  The
// weights sit beside them as the B operand, [out channel][in channel], N
// padded to 8.  Phase 2: a warp takes 16 pixels and every output channel and
// issues, per 16 input channels and 8 output channels, three
// mma.sync.m16n8k16 bf16 -> fp32 (hi.hi, lo.hi, hi.lo) into one accumulator
// kept in registers; the epilogue adds bias and skip from the staged input
// and applies the ReLU.  Bands are at most 8 rows and shrink until the CTA
// fits in 110 KB, so two CTAs share an SM.  mma.sync, not wgmma: the layers
// are 24-96 channels wide, and the bytes bound the kernel, not the tensor
// cores.  FMA contraction is allowed: the wrapper holds the result to its
// plain version within a tolerance, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBand = 8;               // output rows per CTA at most
constexpr int kSmemBudget = 110 * 1024;   // two CTAs per SM
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kRowPad = 8;                // bf16 elements after each operand
                                          // row: conflict-free fragments
constexpr int kMaxChannels = 128;
constexpr int kErrTooWide = -1;           // channels > 128, or no band fits

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

struct Layout {       // a CTA's shared memory, in bytes from its start
  int in_rows, in_cols, m_pad, k_pad, n_pad, k_stride;
  size_t s_in, s_dww, s_dwb, s_pwb, s_xhi, s_xlo, s_whi, s_wlo, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) / 16 * 16; }

__host__ __device__ inline Layout layout(int H, int Cin, int Cout, int stride,
                                         int band) {
  Layout l;
  const int Ho = H / stride;
  l.in_rows = stride == 1 ? band + 2 : 2 * band + 1;
  l.in_cols = H + 2;
  l.m_pad = round_up(band * Ho, 16);
  l.k_pad = round_up(Cin, 16);
  l.n_pad = round_up(Cout, 8);
  l.k_stride = l.k_pad + kRowPad;
  size_t off = 0;
  l.s_in = off;  off = align16(off + sizeof(float) * l.in_rows * l.in_cols * Cin);
  l.s_dww = off; off = align16(off + sizeof(float) * 9 * Cin);
  l.s_dwb = off; off = align16(off + sizeof(float) * Cin);
  l.s_pwb = off; off = align16(off + sizeof(float) * Cout);
  const size_t x_bytes = sizeof(__nv_bfloat16) * l.m_pad * l.k_stride;
  const size_t w_bytes = sizeof(__nv_bfloat16) * l.n_pad * l.k_stride;
  l.s_xhi = off; off = align16(off + x_bytes);
  l.s_xlo = off; off = align16(off + x_bytes);
  l.s_whi = off; off = align16(off + w_bytes);
  l.s_wlo = off; off = align16(off + w_bytes);
  l.total = off;
  return l;
}

// One block: in (B, H, H, Cin) -> out (B, H/STRIDE, H/STRIDE, Cout).  NT is
// the most n-tiles of 8 output channels the instance takes (Cout <= 8 NT).
template <int NT, int STRIDE>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ in,             // (B, H, H, Cin)
             const float* __restrict__ dw_w,           // (3, 3, Cin)
             const float* __restrict__ dw_b,           // (Cin)
             const __nv_bfloat16* __restrict__ w_hi,   // (Np, Kp)
             const __nv_bfloat16* __restrict__ w_lo,   // (Np, Kp)
             const float* __restrict__ pw_b,           // (Cout)
             float* __restrict__ out,                  // (B, Ho, Ho, Cout)
             int H, int Cin, int Cout, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout l = layout(H, Cin, Cout, STRIDE, band);
  float* s_in = reinterpret_cast<float*>(smem + l.s_in);
  float* s_dww = reinterpret_cast<float*>(smem + l.s_dww);
  float* s_dwb = reinterpret_cast<float*>(smem + l.s_dwb);
  float* s_pwb = reinterpret_cast<float*>(smem + l.s_pwb);
  __nv_bfloat16* s_xhi = reinterpret_cast<__nv_bfloat16*>(smem + l.s_xhi);
  __nv_bfloat16* s_xlo = reinterpret_cast<__nv_bfloat16*>(smem + l.s_xlo);
  __nv_bfloat16* s_whi = reinterpret_cast<__nv_bfloat16*>(smem + l.s_whi);
  __nv_bfloat16* s_wlo = reinterpret_cast<__nv_bfloat16*>(smem + l.s_wlo);
  const int Ho = H / STRIDE;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * band;
  const int rows = min(band, Ho - r0);
  const int in_cols = l.in_cols, Kp = l.k_pad, Ks = l.k_stride;

  // local row lr holds input row row_lo + lr, local col lc input col lc - 1;
  // zero outside the map (TF SAME: stride 1 pads 1/1, stride 2 pads 0/1)
  const int row_lo = STRIDE == 1 ? r0 - 1 : 2 * r0;
  const float* ib = in + static_cast<size_t>(b) * H * H * Cin;
  const int n_in = l.in_rows * in_cols * Cin;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int c = i % Cin;
    const int lc = (i / Cin) % in_cols;
    const int lr = i / (Cin * in_cols);
    const int r = row_lo + lr, col = lc - 1;
    s_in[i] = (r >= 0 && r < H && col >= 0 && col < H)
                  ? ib[(static_cast<size_t>(r) * H + col) * Cin + c]
                  : 0.0f;
  }
  for (int i = threadIdx.x; i < l.n_pad * Kp; i += kThreads) {
    const int n = i / Kp, k = i % Kp;
    s_whi[n * Ks + k] = w_hi[i];
    s_wlo[n * Ks + k] = w_lo[i];
  }
  for (int i = threadIdx.x; i < 9 * Cin; i += kThreads) s_dww[i] = dw_w[i];
  for (int i = threadIdx.x; i < Cin; i += kThreads) s_dwb[i] = dw_b[i];
  for (int i = threadIdx.x; i < Cout; i += kThreads) s_pwb[i] = pw_b[i];
  __syncthreads();

  // phase 1: depthwise 3x3 + bias of the band in fp32, split into the bf16
  // A operands; pixels past the band and channels past Cin are zeros
  const int n_pix = rows * Ho;
  for (int i = threadIdx.x; i < l.m_pad * Kp; i += kThreads) {
    const int c = i % Kp;
    const int p = i / Kp;
    float v = 0.0f;
    if (p < n_pix && c < Cin) {
      const int lr = p / Ho, j = p % Ho;
      // output (lr, j) reads local rows rb..rb+2, local cols cb..cb+2
      const int rb = STRIDE == 1 ? lr : 2 * lr;
      const int cb = STRIDE == 1 ? j : 2 * j + 1;
      float acc = 0.0f;
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj)
          acc = fmaf(s_in[((rb + di) * in_cols + cb + dj) * Cin + c],
                     s_dww[(di * 3 + dj) * Cin + c], acc);
      v = acc + s_dwb[c];
    }
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    s_xhi[p * Ks + c] = hi;
    s_xlo[p * Ks + c] = __float2bfloat16_rn(v - __bfloat162float(hi));
  }
  __syncthreads();

  // phase 2: the pointwise product on the tensor cores, then bias + skip +
  // ReLU.  Fragment layout of m16n8k16 (PTX ISA): lane = 4 g + t; A rows g
  // and g + 8, columns 2t, 2t+1 (+8); B column g, rows 2t, 2t+1 (+8); D rows
  // g and g + 8, columns 2t, 2t+1.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = l.n_pad / 8;
  for (int mt = warp; mt * 16 < n_pix; mt += kWarps) {
    float acc[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
    const int arow = (mt * 16 + g) * Ks + 2 * t;
    for (int k0 = 0; k0 < Kp; k0 += 16) {
      const uint32_t a_hi[4] = {ld_pair(s_xhi + arow + k0),
                                ld_pair(s_xhi + arow + 8 * Ks + k0),
                                ld_pair(s_xhi + arow + k0 + 8),
                                ld_pair(s_xhi + arow + 8 * Ks + k0 + 8)};
      const uint32_t a_lo[4] = {ld_pair(s_xlo + arow + k0),
                                ld_pair(s_xlo + arow + 8 * Ks + k0),
                                ld_pair(s_xlo + arow + k0 + 8),
                                ld_pair(s_xlo + arow + 8 * Ks + k0 + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (j < nt) {
          const int brow = (j * 8 + g) * Ks + k0 + 2 * t;
          const uint32_t b_hi[2] = {ld_pair(s_whi + brow),
                                    ld_pair(s_whi + brow + 8)};
          const uint32_t b_lo[2] = {ld_pair(s_wlo + brow),
                                    ld_pair(s_wlo + brow + 8)};
          mma_bf16(acc[j], a_hi, b_hi);
          mma_bf16(acc[j], a_lo, b_hi);
          mma_bf16(acc[j], a_hi, b_lo);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = mt * 16 + g + 8 * h;
      if (p >= n_pix) continue;
      const int lr = p / Ho, j = p % Ho;
      float* o = out + ((static_cast<size_t>(b) * Ho + r0 + lr) * Ho + j) * Cout;
#pragma unroll
      for (int jt = 0; jt < NT; ++jt) {
        if (jt >= nt) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = jt * 8 + 2 * t + e;
          if (co >= Cout) continue;
          float skip = 0.0f;   // the channel zero-pad
          if (co < Cin) {
            if (STRIDE == 1) {
              skip = s_in[((lr + 1) * in_cols + j + 1) * Cin + co];
            } else {             // 2x2 max pool of input rows 2i, 2i+1
              const float* s = s_in + ((2 * lr) * in_cols + 2 * j + 1) * Cin + co;
              const int down = in_cols * Cin;
              skip = fmaxf(fmaxf(s[0], s[Cin]), fmaxf(s[down], s[down + Cin]));
            }
          }
          o[co] = fmaxf((acc[jt][2 * h + e] + s_pwb[co]) + skip, 0.0f);
        }
      }
    }
  }
}

// The widest band (at most kMaxBand rows) whose CTA fits the budget; 0 when
// not even one row fits in a block's shared memory.
int pick_band(int H, int Cin, int Cout, int stride) {
  const int Ho = H / stride;
  int band = Ho < kMaxBand ? Ho : kMaxBand;
  while (band > 1 &&
         layout(H, Cin, Cout, stride, band).total > static_cast<size_t>(kSmemBudget))
    --band;
  return layout(H, Cin, Cout, stride, band).total <= static_cast<size_t>(kSmemMax)
             ? band : 0;
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <int STRIDE>
int launch_block(const float* in, const float* dw_w, const float* dw_b,
                 const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                 const float* pw_b, float* out, int batch, int H, int Cin,
                 int Cout, cudaStream_t stream) {
  if (Cin > kMaxChannels || Cout > kMaxChannels) return kErrTooWide;
  const int band = pick_band(H, Cin, Cout, STRIDE);
  if (band == 0) return kErrTooWide;
  const int Ho = H / STRIDE;
  const dim3 grid((Ho + band - 1) / band, batch);
  const size_t smem = layout(H, Cin, Cout, STRIDE, band).total;
  const int nt = round_up(Cout, 8) / 8;
  // instances for up to 32, 64, 96 and (stride 1) 128 output channels: the
  // stride-2 segment blocks (2 and 5) are no wider than block 11, <= 96
  if (nt <= 4) return launch(block_kernel<4, STRIDE>, grid, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, H, Cin, Cout, band);
  if (nt <= 8) return launch(block_kernel<8, STRIDE>, grid, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, H, Cin, Cout, band);
  if (nt <= 12) return launch(block_kernel<12, STRIDE>, grid, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, H, Cin, Cout, band);
  if constexpr (STRIDE == 1) {
    return launch(block_kernel<16, 1>, grid, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, H, Cin, Cout, band);
  }
  return kErrTooWide;
}

}  // namespace

// Runs the blocks of one segment on `stream`, one launch each, and returns
// 0, a CUDA error code, or -1 (kErrTooWide) when a layer is wider than the
// kernel takes.
//
//   x         (B, H, H, Cin) float32 NHWC, device: the segment's input
//   f32       the packed fp32 weights, device; `f32_offsets` (host, 3 ints
//             per block) give each block's dw (3, 3, Cin), dw bias (Cin) and
//             pw bias (Cout), in floats
//   bf16      the packed bf16 weights, device; `bf16_offsets` (host, 2 ints
//             per block) give each block's w_hi and w_lo, (Np, Kp) each:
//             the pointwise weights transposed, [out][in], zero-padded to
//             Np = Cout rounded up to 8 and Kp = Cin rounded up to 16
//   channels, strides   (host, n_blocks ints) each block's Cout and stride
//   buf_a, buf_b        device scratch, each the size of the largest
//             intermediate map (unused for a one-block segment)
//   out       (B, Ho, Ho, channels[n_blocks - 1]): the segment's output
extern "C" int headpose_backbone2_segment(
    const float* x, const float* f32, const int* f32_offsets,
    const __nv_bfloat16* bf16, const int* bf16_offsets, const int* channels,
    const int* strides, int n_blocks, int H, int cin, float* buf_a,
    float* buf_b, float* out, int batch, cudaStream_t stream) {
  if (batch <= 0) return 0;
  const float* cur = x;
  for (int i = 0; i < n_blocks; ++i) {
    float* dst = i == n_blocks - 1 ? out : (cur == buf_a ? buf_b : buf_a);
    const int* fo = f32_offsets + 3 * i;
    const int* bo = bf16_offsets + 2 * i;
    const int cout = channels[i];
    const int err =
        strides[i] == 1
            ? launch_block<1>(cur, f32 + fo[0], f32 + fo[1], bf16 + bo[0],
                              bf16 + bo[1], f32 + fo[2], dst, batch, H, cin,
                              cout, stream)
            : launch_block<2>(cur, f32 + fo[0], f32 + fo[1], bf16 + bo[0],
                              bf16 + bo[1], f32 + fo[2], dst, batch, H, cin,
                              cout, stream);
    if (err != 0) return err;
    cur = dst;
    H /= strides[i];
    cin = cout;
  }
  return 0;
}
