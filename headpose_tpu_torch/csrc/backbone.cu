// Fused BlazeFace backbone for NVIDIA Hopper (sm_90a): the 5x5 stride-2
// stem + ReLU, then every BlazeBlock as one fused launch.
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/backbone.py::
// backbone_forward (_make_kernel, _stem5x5s2, _depthwise3x3, _pointwise,
// _maxpool2).  The plain PyTorch version is headpose_tpu_torch/ops/kernels/
// backbone.py::backbone_forward_plain, the wrapper backbone_forward.
//
// Semantics (NHWC, float32), for a spec whose taps land at S/8 and S/16:
//   stem:   y = relu(conv5x5/2(x) + b), TF SAME: 1 row/col before, 2 after;
//   block:  t = pw1x1(dw3x3/s(y) + b_dw) + b_pw, TF SAME: stride 1 pads 1/1,
//           stride 2 pads 0/1;  skip = y, max-pooled 2x2/2 at stride 2,
//           zero-padded on the channel axis when the block widens;
//           y = relu(t + skip).
//   The block `tap` writes feat88, the last block feat96.
//
// What bounds it on this card: operations.  At B=128, S=128 the backbone is
// 7.64 GFLOP of fp32 (59.7 MFLOP per image, the stem 14.7 M of it) against
// 39.8 MB that must move (the frames in, the two taps out): 0.114 ms at
// 67 TFLOP/s against 0.012 ms at 3.35 TB/s.  No TF32: fp32 on the CUDA cores.
//
// Design: the TPU kernel keeps a whole tile of images and every activation in
// VMEM.  A 64x64x28 map is 459 KB per image, twice a block's 227 KB of shared
// memory, so here each layer is one launch, and each launch reads its input
// map once and writes its output map once (the TPU kernel's HBM traffic per
// layer, not per op: the depthwise result, the bias, the skip, the channel
// pad and the ReLU never leave the SM).  A CTA of 256 threads takes one image
// (grid.y) and a band of output rows (grid.x), and stages its input rows plus
// the halo, zero-padded, in shared memory, with the layer's weights.  Bands
// are at most 8 rows and shrink until the CTA fits in 110 KB, so two CTAs
// share an SM.  In a block, phase 1 writes the depthwise result of the band
// to shared memory (one thread per pixel and channel); phase 2 is the
// pointwise product: a warp takes 8 pixels, lane l the output channels
// l, l+32, ... (CT of them), and keeps the 8 x CT sums in registers; the
// depthwise value is a broadcast read, the weight a conflict-free one.  The
// epilogue adds the bias and the skip from the staged input and applies the
// ReLU, and a warp's stores are consecutive channels of one pixel.  The stem
// is the same product with the 75 taps of the 5x5x3 window in place of the
// channels.  FMA contraction is allowed (the wrapper holds the result to its
// plain version within a tolerance, not bit for bit).
//
// The stem and a single block are also entry points of their own
// (headpose_backbone_stem, headpose_backbone_block): the split-bf16 backbone
// (csrc/backbone2.cu) runs its fp32 stem and its fp32 block 11 through them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPix = 8;                   // pixels per warp tile
constexpr int kMaxBand = 8;               // output rows per CTA at most
constexpr int kSmemBudget = 110 * 1024;   // two CTAs per SM
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kStemTaps = 75;             // 5 x 5 x 3
constexpr int kPad = 128;                 // slack after a weight matrix: lanes
                                          // past the last channel read it
constexpr int kErrTooWide = -1;           // channels > 128, or no band fits

template <int CT>
__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x,     // (B, S, S, 3)
            const float* __restrict__ w,     // (5, 5, 3, C), HWIO
            const float* __restrict__ bias,  // (C)
            float* __restrict__ out,         // (B, S/2, S/2, C)
            int S, int C, int band) {
  extern __shared__ float smem[];
  const int So = S / 2;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * band;
  const int rows = min(band, So - r0);
  const int in_rows = 2 * band + 3;
  const int in_cols = S + 3;
  float* s_in = smem;                               // in_rows x in_cols x 3
  float* s_w = s_in + in_rows * in_cols * 3;        // 75 x C (+ kPad)
  float* s_b = s_w + kStemTaps * C + kPad;          // C

  // local row lr holds input row 2*r0 - 1 + lr, local col lc input col
  // lc - 1; zero outside the image (TF SAME: 1 before, 2 after)
  const float* xb = x + static_cast<size_t>(b) * S * S * 3;
  const int n_in = in_rows * in_cols * 3;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int c = i % 3;
    const int lc = (i / 3) % in_cols;
    const int lr = i / (3 * in_cols);
    const int r = 2 * r0 - 1 + lr, col = lc - 1;
    s_in[i] = (r >= 0 && r < S && col >= 0 && col < S)
                  ? xb[(static_cast<size_t>(r) * S + col) * 3 + c]
                  : 0.0f;
  }
  for (int i = threadIdx.x; i < kStemTaps * C; i += kThreads) s_w[i] = w[i];
  for (int i = threadIdx.x; i < kPad; i += kThreads) s_w[kStemTaps * C + i] = 0.0f;
  for (int i = threadIdx.x; i < C; i += kThreads) s_b[i] = bias[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_pix = rows * So;
  for (int tile = warp; tile * kPix < n_pix; tile += kWarps) {
    int base[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int p = min(tile * kPix + q, n_pix - 1);
      base[q] = (2 * (p / So) * in_cols + 2 * (p % So)) * 3;
    }
    float acc[kPix][CT];
#pragma unroll
    for (int q = 0; q < kPix; ++q)
#pragma unroll
      for (int k = 0; k < CT; ++k) acc[q][k] = 0.0f;
    for (int di = 0; di < 5; ++di) {
      for (int dj = 0; dj < 5; ++dj) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const int t = (di * 5 + dj) * 3 + c;
          const int off = (di * in_cols + dj) * 3 + c;
          float wv[CT];
#pragma unroll
          for (int k = 0; k < CT; ++k) wv[k] = s_w[t * C + lane + 32 * k];
#pragma unroll
          for (int q = 0; q < kPix; ++q) {
            const float a = s_in[base[q] + off];
#pragma unroll
            for (int k = 0; k < CT; ++k) acc[q][k] = fmaf(a, wv[k], acc[q][k]);
          }
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int p = tile * kPix + q;
      if (p >= n_pix) break;
      float* o = out + ((static_cast<size_t>(b) * So + r0 + p / So) * So + p % So) * C;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int co = lane + 32 * k;
        if (co < C) o[co] = fmaxf(acc[q][k] + s_b[co], 0.0f);
      }
    }
  }
}

template <int CT, int STRIDE>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ in,    // (B, H, H, Cin)
             const float* __restrict__ dw_w,  // (3, 3, Cin)
             const float* __restrict__ dw_b,  // (Cin)
             const float* __restrict__ pw_w,  // (Cin, Cout)
             const float* __restrict__ pw_b,  // (Cout)
             float* __restrict__ out,         // (B, H/STRIDE, H/STRIDE, Cout)
             int H, int Cin, int Cout, int band) {
  extern __shared__ float smem[];
  const int Ho = H / STRIDE;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * band;
  const int rows = min(band, Ho - r0);
  const int in_rows = STRIDE == 1 ? band + 2 : 2 * band + 1;
  const int in_cols = H + 2;
  float* s_in = smem;                               // in_rows x in_cols x Cin
  float* s_dw = s_in + in_rows * in_cols * Cin;     // band*Ho x Cin
  float* s_pw = s_dw + band * Ho * Cin;             // Cin x Cout (+ kPad)
  float* s_dww = s_pw + Cin * Cout + kPad;          // 9 x Cin
  float* s_dwb = s_dww + 9 * Cin;                   // Cin
  float* s_pwb = s_dwb + Cin;                       // Cout

  // local row lr holds input row row_lo + lr, local col lc input col lc - 1;
  // zero outside the map (TF SAME: stride 1 pads 1/1, stride 2 pads 0/1)
  const int row_lo = STRIDE == 1 ? r0 - 1 : 2 * r0;
  const float* ib = in + static_cast<size_t>(b) * H * H * Cin;
  const int n_in = in_rows * in_cols * Cin;
  for (int i = threadIdx.x; i < n_in; i += kThreads) {
    const int c = i % Cin;
    const int lc = (i / Cin) % in_cols;
    const int lr = i / (Cin * in_cols);
    const int r = row_lo + lr, col = lc - 1;
    s_in[i] = (r >= 0 && r < H && col >= 0 && col < H)
                  ? ib[(static_cast<size_t>(r) * H + col) * Cin + c]
                  : 0.0f;
  }
  for (int i = threadIdx.x; i < Cin * Cout; i += kThreads) s_pw[i] = pw_w[i];
  for (int i = threadIdx.x; i < kPad; i += kThreads) s_pw[Cin * Cout + i] = 0.0f;
  for (int i = threadIdx.x; i < 9 * Cin; i += kThreads) s_dww[i] = dw_w[i];
  for (int i = threadIdx.x; i < Cin; i += kThreads) s_dwb[i] = dw_b[i];
  for (int i = threadIdx.x; i < Cout; i += kThreads) s_pwb[i] = pw_b[i];
  __syncthreads();

  // phase 1: depthwise 3x3 + bias of the band, pixel-major
  const int n_pix = rows * Ho;
  for (int i = threadIdx.x; i < n_pix * Cin; i += kThreads) {
    const int c = i % Cin;
    const int p = i / Cin;
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
    s_dw[i] = acc + s_dwb[c];
  }
  __syncthreads();

  // phase 2: pointwise product, then bias + skip + ReLU
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int tile = warp; tile * kPix < n_pix; tile += kWarps) {
    int row[kPix];
#pragma unroll
    for (int q = 0; q < kPix; ++q) row[q] = min(tile * kPix + q, n_pix - 1) * Cin;
    float acc[kPix][CT];
#pragma unroll
    for (int q = 0; q < kPix; ++q)
#pragma unroll
      for (int k = 0; k < CT; ++k) acc[q][k] = 0.0f;
    for (int ci = 0; ci < Cin; ++ci) {
      float wv[CT];
#pragma unroll
      for (int k = 0; k < CT; ++k) wv[k] = s_pw[ci * Cout + lane + 32 * k];
#pragma unroll
      for (int q = 0; q < kPix; ++q) {
        const float a = s_dw[row[q] + ci];
#pragma unroll
        for (int k = 0; k < CT; ++k) acc[q][k] = fmaf(a, wv[k], acc[q][k]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPix; ++q) {
      const int p = tile * kPix + q;
      if (p >= n_pix) break;
      const int lr = p / Ho, j = p % Ho;
      float* o = out + ((static_cast<size_t>(b) * Ho + r0 + lr) * Ho + j) * Cout;
#pragma unroll
      for (int k = 0; k < CT; ++k) {
        const int co = lane + 32 * k;
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
        o[co] = fmaxf((acc[q][k] + s_pwb[co]) + skip, 0.0f);
      }
    }
  }
}

size_t stem_smem(int S, int C, int band) {
  return sizeof(float) * (static_cast<size_t>(2 * band + 3) * (S + 3) * 3 +
                          kStemTaps * C + kPad + C);
}

size_t block_smem(int H, int Cin, int Cout, int stride, int band) {
  const int Ho = H / stride;
  const int in_rows = stride == 1 ? band + 2 : 2 * band + 1;
  return sizeof(float) * (static_cast<size_t>(in_rows) * (H + 2) * Cin +
                          static_cast<size_t>(band) * Ho * Cin +
                          static_cast<size_t>(Cin) * Cout + kPad + 9 * Cin +
                          Cin + Cout);
}

// The widest band (at most kMaxBand rows) whose CTA fits the budget; 0 when
// not even one row fits in a block's shared memory.
template <typename Smem>
int pick_band(int out_rows, Smem smem) {
  int band = out_rows < kMaxBand ? out_rows : kMaxBand;
  while (band > 1 && smem(band) > static_cast<size_t>(kSmemBudget)) --band;
  return smem(band) <= static_cast<size_t>(kSmemMax) ? band : 0;
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

int launch_stem(const float* x, const float* w, const float* bias, float* out,
                int batch, int S, int C, cudaStream_t stream) {
  const int So = S / 2;
  const int band = pick_band(So, [&](int r) { return stem_smem(S, C, r); });
  if (band == 0) return kErrTooWide;
  const dim3 grid((So + band - 1) / band, batch);
  const size_t smem = stem_smem(S, C, band);
  switch ((C + 31) / 32) {
    case 1: return launch(stem_kernel<1>, grid, smem, stream, x, w, bias, out, S, C, band);
    case 2: return launch(stem_kernel<2>, grid, smem, stream, x, w, bias, out, S, C, band);
    case 3: return launch(stem_kernel<3>, grid, smem, stream, x, w, bias, out, S, C, band);
    case 4: return launch(stem_kernel<4>, grid, smem, stream, x, w, bias, out, S, C, band);
    default: return kErrTooWide;
  }
}

template <int STRIDE>
int launch_block_s(const float* in, const float* dw_w, const float* dw_b,
                   const float* pw_w, const float* pw_b, float* out, int batch,
                   int H, int Cin, int Cout, cudaStream_t stream) {
  const int Ho = H / STRIDE;
  const int band = pick_band(
      Ho, [&](int r) { return block_smem(H, Cin, Cout, STRIDE, r); });
  if (band == 0) return kErrTooWide;
  const dim3 grid((Ho + band - 1) / band, batch);
  const size_t smem = block_smem(H, Cin, Cout, STRIDE, band);
  switch ((Cout + 31) / 32) {
    case 1: return launch(block_kernel<1, STRIDE>, grid, smem, stream, in, dw_w, dw_b, pw_w, pw_b, out, H, Cin, Cout, band);
    case 2: return launch(block_kernel<2, STRIDE>, grid, smem, stream, in, dw_w, dw_b, pw_w, pw_b, out, H, Cin, Cout, band);
    case 3: return launch(block_kernel<3, STRIDE>, grid, smem, stream, in, dw_w, dw_b, pw_w, pw_b, out, H, Cin, Cout, band);
    case 4: return launch(block_kernel<4, STRIDE>, grid, smem, stream, in, dw_w, dw_b, pw_w, pw_b, out, H, Cin, Cout, band);
    default: return kErrTooWide;
  }
}

}  // namespace

// The stem alone on `stream`: x (B, S, S, 3) -> out (B, S/2, S/2, C), with
// w (5, 5, 3, C) HWIO and bias (C).  Returns 0, a CUDA error code, or -1.
extern "C" int headpose_backbone_stem(const float* x, const float* w,
                                      const float* bias, float* out,
                                      int batch, int input_size, int channels,
                                      cudaStream_t stream) {
  if (batch <= 0) return 0;
  return launch_stem(x, w, bias, out, batch, input_size, channels, stream);
}

// One block alone on `stream`: in (B, H, H, Cin) -> out (B, H/stride,
// H/stride, Cout), with dw (3, 3, Cin), dw bias, pw (Cin, Cout), pw bias.
// Returns 0, a CUDA error code, or -1.
extern "C" int headpose_backbone_block(const float* in, const float* dw_w,
                                       const float* dw_b, const float* pw_w,
                                       const float* pw_b, float* out,
                                       int batch, int H, int cin, int cout,
                                       int stride, cudaStream_t stream) {
  if (batch <= 0) return 0;
  return stride == 1
             ? launch_block_s<1>(in, dw_w, dw_b, pw_w, pw_b, out, batch, H,
                                 cin, cout, stream)
             : launch_block_s<2>(in, dw_w, dw_b, pw_w, pw_b, out, batch, H,
                                 cin, cout, stream);
}

// Runs the stem and every block on `stream` and returns 0, a CUDA error
// code, or -1 (kErrTooWide) when a layer is wider than the kernels take.
//
//   x         (B, S, S, 3) float32 NHWC, device
//   params    the packed weights, device: stem (5,5,3,C0) and bias, then per
//             block dw (3,3,Cin), dw bias, pw (Cin,Cout), pw bias; `offsets`
//             (host, 2 + 4 * n_blocks ints) gives each one's start in floats
//   channels, strides   (host, n_blocks ints) each block's Cout and stride
//   buf_a, buf_b        device scratch, each the size of the largest map
//   out88     (B, S/8, S/8, channels[tap]), out96 (B, S/16, S/16, channels[n-1])
// The caller checks the spec's domain (taps at S/8 and S/16, S % 16 == 0).
extern "C" int headpose_backbone_forward(
    const float* x, const float* params, const int* offsets,
    const int* channels, const int* strides, int n_blocks, int stem_features,
    int input_size, int tap, float* buf_a, float* buf_b, float* out88,
    float* out96, int batch, cudaStream_t stream) {
  if (batch <= 0) return 0;
  int err = launch_stem(x, params + offsets[0], params + offsets[1], buf_a,
                        batch, input_size, stem_features, stream);
  if (err != 0) return err;
  const float* cur = buf_a;
  int H = input_size / 2, cin = stem_features;
  for (int i = 0; i < n_blocks; ++i) {
    float* dst = i == tap ? out88
                 : i == n_blocks - 1 ? out96
                 : (cur == buf_a ? buf_b : buf_a);
    const int* off = offsets + 2 + 4 * i;
    const int cout = channels[i];
    err = strides[i] == 1
              ? launch_block_s<1>(cur, params + off[0], params + off[1],
                                  params + off[2], params + off[3], dst, batch,
                                  H, cin, cout, stream)
              : launch_block_s<2>(cur, params + off[0], params + off[1],
                                  params + off[2], params + off[3], dst, batch,
                                  H, cin, cout, stream);
    if (err != 0) return err;
    cur = dst;
    H /= strides[i];
    cin = cout;
  }
  return 0;
}
