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
// 67 TFLOP/s against 0.012 ms at 3.35 TB/s.  A design of one launch per
// layer also moves every intermediate map in and out once: 17 grids, 0.139
// GB at B=128, 0.042 ms.  No TF32: fp32 on the CUDA cores.
//
// Design: the TPU kernel keeps a whole tile of images and every activation in
// VMEM.  A 64x64x28 map is 459 KB per image, twice a block's 227 KB of shared
// memory, so here each layer is one launch that reads its input map once and
// writes its output map once (the depthwise result, the bias, the skip, the
// channel pad and the ReLU never leave the SM).  A work item is one image and
// a band of output rows; the band is the widest (at most 8 rows) whose CTA
// fits in 113 KB, so two CTAs share an SM, and narrower on small maps until
// the layer has 512 work items.  The CTAs are persistent: each
// stages the layer's weights once and walks work items with a stride of the
// grid, and the input rows of its next item (with the halo) load into a
// second buffer with cp.async while it computes the current one: 16-byte
// copies of whole rows (a row of a NHWC map is contiguous), the halo zeroed
// apart, no division per element.  In a block, phase 1 (depthwise) gives a
// thread 4 channels (float4) of one output column and slides a 3x3 window of
// float4s down 4 output rows, so each staged input is read once per thread,
// and writes the band's depthwise result pixel-major; phase 2 (pointwise)
// gives a thread 4 pixels x 4 output channels and reads 4 channels of each
// pixel and 4 weight rows as float4s, 8 shared loads per 64 FMAs; 24 or 28
// output channels are 6 or 7 whole channel groups, so no lane idles.  The
// epilogue adds the bias and the skip (from the staged input) and applies
// the ReLU, with float4 stores.  The stem is the same product with the 75
// taps of the 5x5x3 window in place of the channels.  FMA contraction is
// allowed (the wrapper holds the result to its plain version within a
// tolerance, not bit for bit).
//
// The stem and a single block are also entry points of their own
// (headpose_backbone_stem, headpose_backbone_block): the split-bf16 backbone
// (csrc/backbone2.cu) runs its fp32 stem and its fp32 block 11 through them.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBand = 8;               // output rows per work item at most
constexpr int kDwRows = 4;                // output rows per depthwise thread
constexpr int kSmemBudget = 113 * 1024;   // two CTAs per SM
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kMinItems = 512;            // work items that fill the card:
                                          // 132 SMs x 2 CTAs, twice over
constexpr int kStemTaps = 75;             // 5 x 5 x 3
constexpr int kMaxChannels = 128;
constexpr int kMaxDevices = 64;
constexpr int kErrTooWide = -1;           // channels > 128, or no band fits

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes, or 4 zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

__device__ __forceinline__ void fma4(float4& acc, float a, const float4& w) {
  acc.x = fmaf(a, w.x, acc.x);
  acc.y = fmaf(a, w.y, acc.y);
  acc.z = fmaf(a, w.z, acc.z);
  acc.w = fmaf(a, w.w, acc.w);
}
__device__ __forceinline__ float4 fma4v(const float4& a, const float4& w,
                                        float4 acc) {
  acc.x = fmaf(a.x, w.x, acc.x);
  acc.y = fmaf(a.y, w.y, acc.y);
  acc.z = fmaf(a.z, w.z, acc.z);
  acc.w = fmaf(a.w, w.w, acc.w);
  return acc;
}
__device__ __forceinline__ float4 max4(const float4& a, const float4& b) {
  return make_float4(fmaxf(a.x, b.x), fmaxf(a.y, b.y), fmaxf(a.z, b.z),
                     fmaxf(a.w, b.w));
}

// n floats from global to shared, 16 bytes at a time (both 16-byte aligned)
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    cp_async16(dst + i, src + i);
}

// w (rows, cols) row-major into dst (rows_pad, cols_pad) with cp.async (the
// packed weights are 4-byte aligned only): zeros in the pad
__device__ void stage_matrix(float* dst, const float* __restrict__ w, int rows,
                             int cols, int rows_pad, int cols_pad) {
  for (int i = threadIdx.x; i < rows_pad * cols_pad; i += kThreads) {
    const int r = i / cols_pad, c = i % cols_pad;
    const bool ok = r < rows && c < cols;
    cp_async4(dst + i, ok ? w + r * cols + c : w, ok);
  }
}

// ------------------------------------------------------------------ stem
// Shared memory of the stem, in floats.  A staged input row is sp floats:
// 4 floats (unused, then col -1), the S x 3 floats of the row, then cols
// S..S+3 (zeros), so that col 0 starts 16-byte aligned.
struct StemLayout {
  int sp, in_rows, cp;
  size_t buf, w, b, total;
};

__host__ __device__ inline StemLayout stem_layout(int S, int C, int band) {
  StemLayout l;
  l.sp = 3 * S + 16;
  l.in_rows = 2 * band + 3;
  l.cp = round_up(C, 4);
  l.buf = static_cast<size_t>(l.in_rows) * l.sp;
  l.w = 2 * l.buf;
  l.b = l.w + static_cast<size_t>(kStemTaps) * l.cp;
  l.total = l.b + l.cp;
  return l;
}

// input rows 2 r0 - 1 .. of image b into buf; zeros outside the image
__device__ void stem_stage(float* buf, const float* __restrict__ x, int b,
                           int r0, int S, const StemLayout& l) {
  const float* xb = x + static_cast<size_t>(b) * S * S * 3;
  for (int lr = 0; lr < l.in_rows; ++lr) {
    const int r = 2 * r0 - 1 + lr;
    float* row = buf + lr * l.sp;
    if (r >= 0 && r < S) {
      stage_span(row + 4, xb + static_cast<size_t>(r) * S * 3, 3 * S);
      for (int i = threadIdx.x; i < 16; i += kThreads)
        row[i < 4 ? i : 3 * S + i] = 0.0f;          // cols -1 and S..S+3
    } else {
      for (int i = threadIdx.x; i < l.sp; i += kThreads) row[i] = 0.0f;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
stem_kernel(const float* __restrict__ x,     // (B, S, S, 3)
            const float* __restrict__ w,     // (5, 5, 3, C), HWIO
            const float* __restrict__ bias,  // (C)
            float* __restrict__ out,         // (B, S/2, S/2, C)
            int batch, int S, int C, int band) {
  extern __shared__ __align__(16) float smem[];
  const StemLayout l = stem_layout(S, C, band);
  const int So = S / 2, n_bands = (So + band - 1) / band;
  const int items = batch * n_bands, ng = l.cp / 4;
  float* s_w = smem + l.w;
  float* s_b = smem + l.b;
  stage_matrix(s_w, w, kStemTaps, C, kStemTaps, l.cp);
  stage_matrix(s_b, bias, 1, C, 1, l.cp);
  int item = blockIdx.x;
  if (item < items) stem_stage(smem, x, item / n_bands, item % n_bands * band, S, l);
  cp_async_commit();
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int next = item + gridDim.x;
    if (next < items)
      stem_stage(smem + ((it + 1) & 1) * l.buf, x, next / n_bands,
                 next % n_bands * band, S, l);
    cp_async_commit();
    const float* s_in = smem + (it & 1) * l.buf + 4;   // col 0 of row 0
    const int b = item / n_bands, r0 = item % n_bands * band;
    const int rows = min(band, So - r0);
    // a thread: 4 consecutive output columns of one row x 4 channels
    const int n_items = rows * (So / 4) * ng;
    for (int i = threadIdx.x; i < n_items; i += kThreads) {
      const int c4 = i % ng, pg = i / ng;
      const int lr = pg / (So / 4), j0 = 4 * (pg % (So / 4));
      float4 acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int di = 0; di < 5; ++di) {
        const float* rp = s_in + (2 * lr + di) * l.sp + 3 * (2 * j0 - 1);
        const float4* wp = reinterpret_cast<const float4*>(s_w) + di * 15 * ng + c4;
#pragma unroll
        for (int dj = 0; dj < 5; ++dj)
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float4 wv = wp[(dj * 3 + c) * ng];
#pragma unroll
            for (int q = 0; q < 4; ++q) fma4(acc[q], rp[3 * (2 * q + dj) + c], wv);
          }
      }
      const float4 bv = reinterpret_cast<const float4*>(s_b)[c4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4 v = acc[q];
        v.x = fmaxf(v.x + bv.x, 0.f);
        v.y = fmaxf(v.y + bv.y, 0.f);
        v.z = fmaxf(v.z + bv.z, 0.f);
        v.w = fmaxf(v.w + bv.w, 0.f);
        float* o = out + ((static_cast<size_t>(b) * So + r0 + lr) * So + j0 + q) * C + 4 * c4;
        if (C % 4 == 0) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float vv[4] = {v.x, v.y, v.z, v.w};
          for (int k = 0; k < 4 && 4 * c4 + k < C; ++k) o[k] = vv[k];
        }
      }
    }
  }
}

// ----------------------------------------------------------------- block
// Shared memory of a block, in floats: two input buffers (in_rows x in_cols
// pixels of cp floats: Cin rounded up to 4, zeros past Cin), the band's
// depthwise result (pp pixels of cp), the pointwise weights (cp x op: Cout
// rounded up to 4, zeros in the pad), the depthwise weights (9 x cp) and
// biases (cp, op).
struct BlockLayout {
  int in_rows, in_cols, cp, op, pp;
  size_t buf, dw, pw, dww, dwb, pwb, total;
};

__host__ __device__ inline BlockLayout block_layout(int H, int Cin, int Cout,
                                                    int stride, int band) {
  BlockLayout l;
  const int Ho = H / stride;
  l.in_rows = stride == 1 ? band + 2 : 2 * band + 1;
  l.in_cols = H + 2;
  l.cp = round_up(Cin, 4);
  l.op = round_up(Cout, 4);
  l.pp = round_up(band * Ho, 4);
  l.buf = static_cast<size_t>(l.in_rows) * l.in_cols * l.cp;
  l.dw = 2 * l.buf;
  l.pw = l.dw + static_cast<size_t>(l.pp) * l.cp;
  l.dww = l.pw + static_cast<size_t>(l.cp) * l.op;
  l.dwb = l.dww + 9 * l.cp;
  l.pwb = l.dwb + l.cp;
  l.total = l.pwb + l.op;
  return l;
}

// input rows row_lo .. of image b into buf (local col = input col + 1);
// zeros outside the map and in the channel pad
__device__ void block_stage(float* buf, const float* __restrict__ in, int b,
                            int row_lo, int H, int Cin, const BlockLayout& l) {
  const float* ib = in + static_cast<size_t>(b) * H * H * Cin;
  const int row_f = l.in_cols * l.cp;              // floats per staged row
  if (Cin % 4 == 0) {                              // whole rows, 16 bytes
    for (int lr = 0; lr < l.in_rows; ++lr) {
      const int r = row_lo + lr;
      float* row = buf + lr * row_f;
      if (r >= 0 && r < H) {
        stage_span(row + Cin, ib + static_cast<size_t>(r) * H * Cin, H * Cin);
        for (int i = threadIdx.x; i < 2 * Cin; i += kThreads)
          row[i < Cin ? i : H * Cin + i] = 0.0f;   // cols -1 and H
      } else {
        for (int i = threadIdx.x; i < row_f; i += kThreads) row[i] = 0.0f;
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < l.in_rows * row_f; i += kThreads) {
    const int c = i % l.cp, lc = (i / l.cp) % l.in_cols, lr = i / row_f;
    const int r = row_lo + lr, col = lc - 1;
    if (r >= 0 && r < H && col >= 0 && col < H && c < Cin)
      cp_async4(buf + i, ib + (static_cast<size_t>(r) * H + col) * Cin + c);
    else
      buf[i] = 0.0f;
  }
}

template <int STRIDE>
__global__ void __launch_bounds__(kThreads)
block_kernel(const float* __restrict__ in,    // (B, H, H, Cin)
             const float* __restrict__ dw_w,  // (3, 3, Cin)
             const float* __restrict__ dw_b,  // (Cin)
             const float* __restrict__ pw_w,  // (Cin, Cout)
             const float* __restrict__ pw_b,  // (Cout)
             float* __restrict__ out,         // (B, H/STRIDE, H/STRIDE, Cout)
             int batch, int H, int Cin, int Cout, int band) {
  extern __shared__ __align__(16) float smem[];
  const BlockLayout l = block_layout(H, Cin, Cout, STRIDE, band);
  const int Ho = H / STRIDE, n_bands = (Ho + band - 1) / band;
  const int items = batch * n_bands;
  const int cg = l.cp / 4, og = l.op / 4;          // channel groups of 4
  float4* s_dw = reinterpret_cast<float4*>(smem + l.dw);    // [pixel][cg]
  const float4* s_pw = reinterpret_cast<const float4*>(smem + l.pw);
  const float4* s_dww = reinterpret_cast<const float4*>(smem + l.dww);
  const float4* s_dwb = reinterpret_cast<const float4*>(smem + l.dwb);
  const float4* s_pwb = reinterpret_cast<const float4*>(smem + l.pwb);
  stage_matrix(smem + l.pw, pw_w, Cin, Cout, l.cp, l.op);
  stage_matrix(smem + l.dww, dw_w, 9, Cin, 9, l.cp);
  stage_matrix(smem + l.dwb, dw_b, 1, Cin, 1, l.cp);
  stage_matrix(smem + l.pwb, pw_b, 1, Cout, 1, l.op);
  // local row lr holds input row row_lo + lr; TF SAME: stride 1 pads 1/1,
  // stride 2 pads 0/1
  auto row_lo = [&](int r0) { return STRIDE == 1 ? r0 - 1 : 2 * r0; };
  int item = blockIdx.x;
  if (item < items)
    block_stage(smem, in, item / n_bands, row_lo(item % n_bands * band), H,
                Cin, l);
  cp_async_commit();
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int next = item + gridDim.x;
    if (next < items)
      block_stage(smem + ((it + 1) & 1) * l.buf, in, next / n_bands,
                  row_lo(next % n_bands * band), H, Cin, l);
    cp_async_commit();
    const float4* s_in = reinterpret_cast<const float4*>(smem + (it & 1) * l.buf);
    const int b = item / n_bands, r0 = item % n_bands * band;
    const int rows = min(band, Ho - r0);

    // phase 1: depthwise 3x3 + bias; a thread takes 4 channels of output
    // column j and slides its window down kDwRows output rows, which start
    // at local rows STRIDE * lr (local cols j + dj at stride 1, 2 j + 1 + dj
    // at stride 2)
    const int n_dw = Ho * cg * ((rows + kDwRows - 1) / kDwRows);
    for (int i = threadIdx.x; i < n_dw; i += kThreads) {
      const int j = i % Ho, c4 = (i / Ho) % cg, lr0 = i / (Ho * cg) * kDwRows;
      const int cb = STRIDE == 1 ? j : 2 * j + 1;
      float4 w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = s_dww[k * cg + c4];
      const float4 bias = s_dwb[c4];
      auto px = [&](int lrow, int dj) {
        return s_in[(lrow * l.in_cols + cb + dj) * cg + c4];
      };
      float4 win[3][3];
#pragma unroll
      for (int di = 0; di < 3; ++di)
#pragma unroll
        for (int dj = 0; dj < 3; ++dj) win[di][dj] = px(STRIDE * lr0 + di, dj);
      const int lr1 = min(lr0 + kDwRows, rows);
      for (int lr = lr0; lr < lr1; ++lr) {
        float4 acc = bias;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            acc = fma4v(win[di][dj], w[di * 3 + dj], acc);
        s_dw[(lr * Ho + j) * cg + c4] = acc;
        if (lr + 1 < lr1) {                 // the window of the next row
          const int top = STRIDE * (lr + 1);
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) {
            if (STRIDE == 1) {
              win[0][dj] = win[1][dj];
              win[1][dj] = win[2][dj];
              win[2][dj] = px(top + 2, dj);
            } else {
              win[0][dj] = win[2][dj];
              win[1][dj] = px(top + 1, dj);
              win[2][dj] = px(top + 2, dj);
            }
          }
        }
      }
    }
    __syncthreads();

    // phase 2: pointwise, 4 pixels x 4 output channels a thread, then bias +
    // skip + ReLU
    const int n_pix = rows * Ho;
    const int n_pw = (n_pix + 3) / 4 * og;
    for (int i = threadIdx.x; i < n_pw; i += kThreads) {
      const int o4 = i % og, p0 = 4 * (i / og);
      float4 acc[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      int pq[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) pq[q] = min(p0 + q, n_pix - 1) * cg;
      for (int c4 = 0; c4 < cg; ++c4) {
        float4 wv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) wv[k] = s_pw[(4 * c4 + k) * og + o4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float4 a = s_dw[pq[q] + c4];
          fma4(acc[q], a.x, wv[0]);
          fma4(acc[q], a.y, wv[1]);
          fma4(acc[q], a.z, wv[2]);
          fma4(acc[q], a.w, wv[3]);
        }
      }
      const float4 bias = s_pwb[o4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int p = p0 + q;
        if (p >= n_pix) break;
        const int lr = p / Ho, j = p % Ho;
        float4 skip = make_float4(0.f, 0.f, 0.f, 0.f);   // the channel pad
        if (o4 < cg) {
          if (STRIDE == 1) {
            skip = s_in[((lr + 1) * l.in_cols + j + 1) * cg + o4];
          } else {       // 2x2 max pool of input rows 2i, 2i+1, cols 2j, 2j+1
            const float4* s = s_in + ((2 * lr) * l.in_cols + 2 * j + 1) * cg + o4;
            const int down = l.in_cols * cg;
            skip = max4(max4(s[0], s[cg]), max4(s[down], s[down + cg]));
          }
        }
        float4 v = acc[q];
        v.x = fmaxf((v.x + bias.x) + skip.x, 0.f);
        v.y = fmaxf((v.y + bias.y) + skip.y, 0.f);
        v.z = fmaxf((v.z + bias.z) + skip.z, 0.f);
        v.w = fmaxf((v.w + bias.w) + skip.w, 0.f);
        float* o = out + ((static_cast<size_t>(b) * Ho + r0 + lr) * Ho + j) * Cout + 4 * o4;
        if (Cout % 4 == 0) {
          *reinterpret_cast<float4*>(o) = v;
        } else {
          const float vv[4] = {v.x, v.y, v.z, v.w};
          for (int k = 0; k < 4 && 4 * o4 + k < Cout; ++k) o[k] = vv[k];
        }
      }
    }
  }
}

// The widest band (at most kMaxBand rows) whose CTA fits the budget,
// narrowed while the layer has fewer than kMinItems work items (the small
// maps: more CTAs in flight for a little more halo); 0 when not even one
// row fits in a block's shared memory.
template <typename Smem>
int pick_band(int batch, int out_rows, Smem smem) {
  int band = out_rows < kMaxBand ? out_rows : kMaxBand;
  while (band > 1 && smem(band) > static_cast<size_t>(kSmemBudget)) --band;
  while (band > 1 && batch * ((out_rows + band - 1) / band) < kMinItems) --band;
  return smem(band) <= static_cast<size_t>(kSmemMax) ? band : 0;
}

// Persistent launch of `items` work items: the kernel's dynamic shared
// memory limit is raised, and its CTAs per SM read, once per kernel, size
// and device (not once per launch); the grid is what fits on the card at
// once, or `items` when fewer.
template <auto Kernel, typename... Args>
int launch(int items, size_t smem, cudaStream_t stream, Args... args) {
  struct Fit { int smem, grid; };
  static Fit fit[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= kMaxDevices) return kErrTooWide;
  if (fit[dev].smem != static_cast<int>(smem)) {
    err = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                          kThreads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    fit[dev] = Fit{static_cast<int>(smem), (per_sm > 0 ? per_sm : 1) * sms};
  }
  const int grid = items < fit[dev].grid ? items : fit[dev].grid;
  Kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

int launch_stem(const float* x, const float* w, const float* bias, float* out,
                int batch, int S, int C, cudaStream_t stream) {
  if (C > kMaxChannels) return kErrTooWide;
  const int So = S / 2;
  const int band =
      pick_band(batch, So, [&](int r) { return sizeof(float) * stem_layout(S, C, r).total; });
  if (band == 0) return kErrTooWide;
  const size_t smem = sizeof(float) * stem_layout(S, C, band).total;
  const int items = batch * ((So + band - 1) / band);
  return launch<stem_kernel>(items, smem, stream, x, w, bias, out, batch, S, C,
                             band);
}

template <int STRIDE>
int launch_block(const float* in, const float* dw_w, const float* dw_b,
                 const float* pw_w, const float* pw_b, float* out, int batch,
                 int H, int Cin, int Cout, cudaStream_t stream) {
  if (Cin > kMaxChannels || Cout > kMaxChannels) return kErrTooWide;
  const int Ho = H / STRIDE;
  const int band = pick_band(batch, Ho, [&](int r) {
    return sizeof(float) * block_layout(H, Cin, Cout, STRIDE, r).total;
  });
  if (band == 0) return kErrTooWide;
  const size_t smem = sizeof(float) * block_layout(H, Cin, Cout, STRIDE, band).total;
  const int items = batch * ((Ho + band - 1) / band);
  return launch<block_kernel<STRIDE>>(items, smem, stream, in, dw_w, dw_b,
                                      pw_w, pw_b, out, batch, H, Cin, Cout,
                                      band);
}

int launch_block_s(int stride, const float* in, const float* dw_w,
                   const float* dw_b, const float* pw_w, const float* pw_b,
                   float* out, int batch, int H, int Cin, int Cout,
                   cudaStream_t stream) {
  return stride == 1 ? launch_block<1>(in, dw_w, dw_b, pw_w, pw_b, out, batch,
                                       H, Cin, Cout, stream)
                     : launch_block<2>(in, dw_w, dw_b, pw_w, pw_b, out, batch,
                                       H, Cin, Cout, stream);
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
  return launch_block_s(stride, in, dw_w, dw_b, pw_w, pw_b, out, batch, H, cin,
                        cout, stream);
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
    err = launch_block_s(strides[i], cur, params + off[0], params + off[1],
                         params + off[2], params + off[3], dst, batch, H, cin,
                         cout, stream);
    if (err != 0) return err;
    cur = dst;
    H /= strides[i];
    cin = cout;
  }
  return 0;
}
