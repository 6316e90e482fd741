// Split-bf16 BlazeFace segments for NVIDIA Hopper (sm_90a): every block of a
// segment with the pointwise 1x1 on the tensor cores.
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/backbone2.py::
// _make_segment_kernel (run_segment, driven by apply_fused; _block_s1_flat,
// _block_s1_planes, _block_s2_planes, _pw_matmul).  The plain PyTorch
// version is headpose_tpu_torch/ops/kernels/backbone2.py::run_segment_plain,
// the wrapper run_segment / apply_fused; the segments come from the spec
// (backbone2.py::segment_plan).  The stem (and on the front topology block
// 11) stay outside in fp32, as in the JAX function (csrc/backbone.cu).
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
// What bounds it on this card: bytes.  At B=128 the flagship's four segments
// take the stem's output (64x64x24) and block 11's (8x8x96) and write feat88
// (16x16x88) and feat96 (8x8x96): 68 MB of fp32, 0.020 ms at 3.35 TB/s.
// Their 17.7 M pointwise multiply-adds per image are 13.6 GFLOP on the tensor
// cores over three passes (0.014 ms at 989 TFLOP/s), and the depthwise,
// biases, skips and ReLUs 1.2 GFLOP of fp32 on the CUDA cores (0.018 ms at
// 67 TFLOP/s).  chip_smoke.py recomputes these from the plan's shapes.
//
// Design.  Two kernels; the host groups a segment's blocks into launches
// (`plan_groups`):
//
// block_kernel, one launch per block (large maps, and stride-2 blocks): the
// structure of csrc/backbone.cu.  Persistent CTAs of 256 threads, capped at
// 128 registers so that two share an SM as their shared memory allows (at
// 153-166 registers one fits: on an H100 80GB HBM3 at 700 W the flagship's
// segments at B=128 took 0.667 ms so, 0.499 with two; tools/
// kernel_phases.py backbone2), walk (image, band of output rows) items;
// the next item's input rows, with the halo,
// load into a second buffer with 16-byte cp.async (a NHWC row is contiguous)
// while the current item computes.  The bf16 weight pack (rows padded to 16
// bytes by the wrapper) arrives once per CTA lifetime by 16-byte cp.async.
// Phase 1, the depthwise, gives a thread 4 channels (float4) of one output
// column and slides its 3x3 window down 4 output rows, and writes the split
// hi and lo halves straight into the A operand: per pixel one row of ks
// 32-bit words, hi (ks bf16) then lo (ks bf16), ks = 4 mod 8 so that the
// fragment loads of a warp hit 32 banks.  Phase 2: a warp takes 16 pixels
// and every output channel and issues, per 16 input and 8 output channels,
// three mma.sync.m16n8k16 bf16 -> fp32 (hi.hi, lo.hi, hi.lo) into one
// accumulator; the epilogue adds the bias and the skip (from the staged
// input), applies the ReLU, stages the warp's 16 x Cout tile in its own A
// rows (ks >= Cout) and writes it with 16-byte stores: a band's output is
// one contiguous span of the map.
//
// chain_kernel, one launch for a run of stride-1 blocks whose whole map fits
// in shared memory (the 16x16 and 8x8 maps): a CTA of 512 threads holds one
// image's map across the run's blocks and updates it in place (each output
// element is written by the thread that read its skip, after a barrier ends
// the depthwise that reads the neighbours).  Per block the depthwise
// weights, then the bf16 weights, load by cp.async; the pointwise weights
// land while the depthwise runs.  A warp takes 16 pixels x 32 output
// channels.  The last block's map leaves with 16-byte stores.
//
// mma.sync, not wgmma: the layers are 24-128 channels wide, and the bytes
// and latency bound the kernel, not the tensor cores.  FMA contraction is
// allowed: the wrapper holds the result to its plain version within a
// tolerance, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 256;             // block_kernel
constexpr int kWarps = kThreads / 32;
constexpr int kChainThreads = 512;        // chain_kernel: one CTA per SM
constexpr int kChainWarps = kChainThreads / 32;
constexpr int kChainTiles = 4;            // n-tiles of 8 per chain work unit
constexpr int kMaxChain = 8;              // blocks per chain launch
constexpr int kMaxBand = 8;               // output rows per work item at most
constexpr int kDwRows = 4;                // output rows per depthwise thread
constexpr int kSmemBudget = 113 * 1024;   // block_kernel: two CTAs per SM
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kMinItems = 512;            // work items that fill the card
constexpr int kMaxChannels = 128;
constexpr int kMaxDevices = 64;
constexpr int kErrTooWide = -1;           // channels > 128, or no band fits

__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes, or 4 zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid = true) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
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
// every group but the newest complete
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
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

// hi = bf16(v), lo = bf16(v - hi) of 4 floats, round-to-nearest-even, as
// two bf16 pairs each (element 0 in the low half)
__device__ __forceinline__ void split4(const float4& v, uint2& hi, uint2& lo) {
  const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
  const float2 f01 = __bfloat1622float2(h01);
  const float2 f23 = __bfloat1622float2(h23);
  hi = make_uint2(bf16x2_bits(h01), bf16x2_bits(h23));
  lo = make_uint2(bf16x2_bits(__floats2bfloat162_rn(v.x - f01.x, v.y - f01.y)),
                  bf16x2_bits(__floats2bfloat162_rn(v.z - f23.x, v.w - f23.y)));
}

__device__ __forceinline__ float4 fma4v(const float4& a, const float4& w,
                                        float4 acc) {
  acc.x = fmaf(a.x, w.x, acc.x);
  acc.y = fmaf(a.y, w.y, acc.y);
  acc.z = fmaf(a.z, w.z, acc.z);
  acc.w = fmaf(a.w, w.w, acc.w);
  return acc;
}
__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float2 max2(const float2& a, const float2& b) {
  return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
}

// w (rows, cols) row-major into dst (rows_pad, cols_pad) with 4-byte
// cp.async (the fp32 pack is 4-byte aligned only): zeros in the pad
template <int Threads>
__device__ void stage_matrix(float* dst, const float* __restrict__ w, int rows,
                             int cols, int rows_pad, int cols_pad) {
  for (int i = threadIdx.x; i < rows_pad * cols_pad; i += Threads) {
    const int r = i / cols_pad, c = i % cols_pad;
    const bool ok = r < rows && c < cols;
    cp_async4(dst + i, ok ? w + r * cols + c : w, ok);
  }
}

// a bf16 pack (rows, kp) into rows of wk bf16 (kp + 8), 16 bytes at a time
template <int Threads>
__device__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* __restrict__ w,
                           int rows, int kp, int wk) {
  const int chunks = kp / 8;
  for (int i = threadIdx.x; i < rows * chunks; i += Threads) {
    const int r = i / chunks, c = 8 * (i % chunks);
    cp_async16(dst + r * wk + c, w + r * kp + c);
  }
}

// The A operand of 16 pixels: lane (g, t) reads hi words k0/2 + t (+4) of rows
// g and g + 8; lo sits ks/2 words after hi in each row
struct AFrag {
  uint32_t hi[4], lo[4];
};
__device__ __forceinline__ void load_a(AFrag& f, const uint32_t* r0, int ks,
                                       int kw) {
  const uint32_t* r1 = r0 + 8 * ks;
  const int lo = ks / 2;
  f.hi[0] = r0[kw];
  f.hi[1] = r1[kw];
  f.hi[2] = r0[kw + 4];
  f.hi[3] = r1[kw + 4];
  f.lo[0] = r0[kw + lo];
  f.lo[1] = r1[kw + lo];
  f.lo[2] = r0[kw + lo + 4];
  f.lo[3] = r1[kw + lo + 4];
}
// three passes of one n-tile: brow points at the tile's row g, word k0/2 + t
__device__ __forceinline__ void mma_3pass(float (&acc)[4], const AFrag& a,
                                          const uint32_t* bhi,
                                          const uint32_t* blo) {
  const uint32_t b_hi[2] = {bhi[0], bhi[4]};
  const uint32_t b_lo[2] = {blo[0], blo[4]};
  mma_bf16(acc, a.hi, b_hi);
  mma_bf16(acc, a.lo, b_hi);
  mma_bf16(acc, a.hi, b_lo);
}

// ------------------------------------------------------------ block_kernel
// Shared memory of block_kernel, in bytes: two input buffers (in_rows x
// in_cols pixels of cp floats, zeros past Cin), the A operand (mp pixel rows
// of ks words), w_hi and w_lo (np rows of wk bf16), the depthwise weights (9
// x cp) and biases (cp, op floats).
struct BlockLayout {
  int in_rows, in_cols, cp, op, kp, np, ks, wk, mp;
  size_t buf, a, whi, wlo, dww, dwb, pwb, total;
};

__host__ __device__ inline BlockLayout block_layout(int H, int Cin, int Cout,
                                                    int stride, int band) {
  BlockLayout l;
  const int Ho = H / stride;
  l.in_rows = stride == 1 ? band + 2 : 2 * band + 1;
  l.in_cols = H + 2;
  l.cp = round_up(Cin, 4);
  l.op = round_up(Cout, 4);
  l.kp = round_up(Cin, 16);
  l.np = round_up(Cout, 8);
  l.ks = round_up(imax(l.kp, Cout), 8) + 4;   // >= Kp bf16 and >= Cout floats
  l.wk = l.kp + 8;
  l.mp = round_up(band * Ho, 16);
  l.buf = static_cast<size_t>(l.in_rows) * l.in_cols * l.cp;   // floats
  l.a = 2 * sizeof(float) * l.buf;
  l.whi = l.a + sizeof(uint32_t) * static_cast<size_t>(l.mp) * l.ks;
  l.wlo = l.whi + sizeof(__nv_bfloat16) * static_cast<size_t>(l.np) * l.wk;
  l.dww = l.wlo + sizeof(__nv_bfloat16) * static_cast<size_t>(l.np) * l.wk;
  l.dwb = l.dww + sizeof(float) * 9 * l.cp;
  l.pwb = l.dwb + sizeof(float) * l.cp;
  l.total = l.pwb + sizeof(float) * l.op;
  return l;
}

// n floats from global to shared, 16 bytes at a time (both 16-byte aligned)
__device__ __forceinline__ void stage_span(float* dst, const float* src,
                                           int n) {
  for (int i = 4 * threadIdx.x; i < n; i += 4 * kThreads)
    cp_async16(dst + i, src + i);
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

// One block: in (B, H, H, Cin) -> out (B, H/STRIDE, H/STRIDE, Cout).  NT is
// the most n-tiles of 8 output channels the instance takes (Cout <= 8 NT).
template <int NT, int STRIDE>
__global__ void __launch_bounds__(kThreads, 2)
block_kernel(const float* __restrict__ in,             // (B, H, H, Cin)
             const float* __restrict__ dw_w,           // (3, 3, Cin)
             const float* __restrict__ dw_b,           // (Cin)
             const __nv_bfloat16* __restrict__ w_hi,   // (Np, Kp)
             const __nv_bfloat16* __restrict__ w_lo,   // (Np, Kp)
             const float* __restrict__ pw_b,           // (Cout)
             float* __restrict__ out,                  // (B, Ho, Ho, Cout)
             int batch, int H, int Cin, int Cout, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BlockLayout l = block_layout(H, Cin, Cout, STRIDE, band);
  const int Ho = H / STRIDE, n_bands = (Ho + band - 1) / band;
  const int items = batch * n_bands;
  const int cg = l.cp / 4, kg = l.kp / 4, ks = l.ks, wkw = l.wk / 2;
  float* bufs = reinterpret_cast<float*>(smem);
  uint32_t* s_a = reinterpret_cast<uint32_t*>(smem + l.a);
  __nv_bfloat16* s_whi = reinterpret_cast<__nv_bfloat16*>(smem + l.whi);
  __nv_bfloat16* s_wlo = reinterpret_cast<__nv_bfloat16*>(smem + l.wlo);
  float* s_pwb = reinterpret_cast<float*>(smem + l.pwb);
  const float4* s_dww = reinterpret_cast<const float4*>(smem + l.dww);
  const float4* s_dwb = reinterpret_cast<const float4*>(smem + l.dwb);
  stage_bf16<kThreads>(s_whi, w_hi, l.np, l.kp, l.wk);
  stage_bf16<kThreads>(s_wlo, w_lo, l.np, l.kp, l.wk);
  stage_matrix<kThreads>(reinterpret_cast<float*>(smem + l.dww), dw_w, 9, Cin,
                         9, l.cp);
  stage_matrix<kThreads>(reinterpret_cast<float*>(smem + l.dwb), dw_b, 1, Cin,
                         1, l.cp);
  stage_matrix<kThreads>(s_pwb, pw_b, 1, Cout, 1, l.op);
  // local row lr holds input row row_lo + lr; TF SAME: stride 1 pads 1/1,
  // stride 2 pads 0/1
  auto row_lo = [&](int r0) { return STRIDE == 1 ? r0 - 1 : 2 * r0; };
  int item = blockIdx.x;
  if (item < items)
    block_stage(bufs, in, item / n_bands, row_lo(item % n_bands * band), H,
                Cin, l);
  cp_async_commit();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int nt = l.np / 8;
  for (int it = 0; item < items; item += gridDim.x, ++it) {
    cp_async_wait_all();
    __syncthreads();
    const int next = item + gridDim.x;
    if (next < items)
      block_stage(bufs + ((it + 1) & 1) * l.buf, in, next / n_bands,
                  row_lo(next % n_bands * band), H, Cin, l);
    cp_async_commit();
    const float* s_inf = bufs + (it & 1) * l.buf;
    const float4* s_in = reinterpret_cast<const float4*>(s_inf);
    const int b = item / n_bands, r0 = item % n_bands * band;
    const int rows = min(band, Ho - r0);

    // phase 1: depthwise 3x3 + bias, split into the hi and lo A operands; a
    // thread takes 4 channels of output column j and slides its window down
    // kDwRows output rows, which start at local rows STRIDE * lr (local cols
    // j + dj at stride 1, 2 j + 1 + dj at stride 2); channel groups past Cin
    // write the zeros of the K pad
    const int n_dw = ((rows + kDwRows - 1) / kDwRows) * Ho * kg;
    for (int i = threadIdx.x; i < n_dw; i += kThreads) {
      const int c4 = i % kg, j = (i / kg) % Ho, lr0 = i / (kg * Ho) * kDwRows;
      const int lr1 = min(lr0 + kDwRows, rows);
      if (c4 >= cg) {
        for (int lr = lr0; lr < lr1; ++lr) {
          uint32_t* a = s_a + (lr * Ho + j) * ks + 2 * c4;
          *reinterpret_cast<uint2*>(a) = make_uint2(0u, 0u);
          *reinterpret_cast<uint2*>(a + ks / 2) = make_uint2(0u, 0u);
        }
        continue;
      }
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
      for (int lr = lr0; lr < lr1; ++lr) {
        float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            acc = fma4v(win[di][dj], w[di * 3 + dj], acc);
        acc = add4(acc, bias);           // the bias last, as the plain sum
        uint2 hi, lo;
        split4(acc, hi, lo);
        uint32_t* a = s_a + (lr * Ho + j) * ks + 2 * c4;
        *reinterpret_cast<uint2*>(a) = hi;
        *reinterpret_cast<uint2*>(a + ks / 2) = lo;
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

    // phase 2: the pointwise product on the tensor cores, 16 pixels x every
    // output channel a warp, then bias + skip + ReLU.  Fragment layout of
    // m16n8k16 (PTX ISA): lane = 4 g + t; A rows g and g + 8, columns 2t,
    // 2t+1 (+8); B column g, rows 2t, 2t+1 (+8); D rows g and g + 8, columns
    // 2t, 2t+1.
    const int n_pix = rows * Ho;
    const uint32_t* whi = reinterpret_cast<const uint32_t*>(s_whi) + g * wkw + t;
    const uint32_t* wlo = reinterpret_cast<const uint32_t*>(s_wlo) + g * wkw + t;
    for (int mt = warp; mt * 16 < n_pix; mt += kWarps) {
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
      uint32_t* rows16 = s_a + mt * 16 * ks;
      for (int k0 = 0; k0 < l.kp; k0 += 16) {
        AFrag a;
        load_a(a, rows16 + g * ks + t, ks, k0 / 2);
#pragma unroll
        for (int j = 0; j < NT; ++j)
          if (j < nt)
            mma_3pass(acc[j], a, whi + j * 8 * wkw + k0 / 2,
                      wlo + j * 8 * wkw + k0 / 2);
      }
      __syncwarp();
      // the epilogue stages the warp's tile in its own A rows (ks floats a
      // pixel), then writes it with 16-byte stores
      float* tile = reinterpret_cast<float*>(rows16);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pl = g + 8 * h, p = mt * 16 + pl;
        if (p >= n_pix) continue;
        const int lr = p / Ho, j = p % Ho;
#pragma unroll
        for (int jt = 0; jt < NT; ++jt) {
          const int co = jt * 8 + 2 * t;
          if (jt >= nt || co >= Cout) continue;
          float2 skip = make_float2(0.f, 0.f);   // the channel pad
          if (co < Cin) {
            if (STRIDE == 1) {
              skip = *reinterpret_cast<const float2*>(
                  s_inf + ((lr + 1) * l.in_cols + j + 1) * l.cp + co);
            } else {             // 2x2 max pool of input rows 2i, 2i+1
              const float* s = s_inf + ((2 * lr) * l.in_cols + 2 * j + 1) * l.cp + co;
              const int down = l.in_cols * l.cp;
              skip = max2(max2(*reinterpret_cast<const float2*>(s),
                               *reinterpret_cast<const float2*>(s + l.cp)),
                          max2(*reinterpret_cast<const float2*>(s + down),
                               *reinterpret_cast<const float2*>(s + down + l.cp)));
            }
          }
          const float2 bias = *reinterpret_cast<const float2*>(s_pwb + co);
          *reinterpret_cast<float2*>(tile + pl * ks + co) = make_float2(
              fmaxf((acc[jt][2 * h] + bias.x) + skip.x, 0.0f),
              fmaxf((acc[jt][2 * h + 1] + bias.y) + skip.y, 0.0f));
        }
      }
      __syncwarp();
      const int nv = min(16, n_pix - mt * 16);
      float* o = out + ((static_cast<size_t>(b) * Ho + r0) * Ho + mt * 16) * Cout;
      if (Cout % 4 == 0) {
        const int c4n = Cout / 4;
        for (int q = lane; q < nv * c4n; q += 32) {
          const int pl = q / c4n, c = 4 * (q % c4n);
          *reinterpret_cast<float4*>(o + pl * Cout + c) =
              *reinterpret_cast<const float4*>(tile + pl * ks + c);
        }
      } else {
        for (int q = lane; q < nv * Cout; q += 32)
          o[q] = tile[q / Cout * ks + q % Cout];
      }
    }
  }
}

// ------------------------------------------------------------ chain_kernel
struct ChainBlock {
  const float* dw_w;              // (3, 3, Cin)
  const float* dw_b;              // (Cin)
  const float* pw_b;              // (Cout)
  const __nv_bfloat16* w_hi;      // (Np, Kp)
  const __nv_bfloat16* w_lo;
  int cin, cout;
};
struct Chain {
  ChainBlock blk[kMaxChain];
  int n;
};

// Shared memory of chain_kernel, in bytes: the map (H*H pixels of cs floats,
// cs = the widest block's Cout), the A operand (mp rows of the widest ks
// words), w_hi and w_lo (the widest np rows of the widest wk bf16), the
// depthwise weights and biases (the widest cp, op)
struct ChainLayout {
  int cs, mp;
  size_t map, a, whi, wlo, dww, dwb, pwb, total;
};

__host__ __device__ inline ChainLayout chain_layout(int H, const Chain& c) {
  int cs = 0, kp = 0, np = 0, cp = 0, op = 0;
  for (int k = 0; k < c.n; ++k) {
    cs = imax(cs, round_up(c.blk[k].cout, 4));
    kp = imax(kp, round_up(c.blk[k].cin, 16));
    np = imax(np, round_up(c.blk[k].cout, 8));
    cp = imax(cp, round_up(c.blk[k].cin, 4));
    op = imax(op, round_up(c.blk[k].cout, 4));
  }
  ChainLayout l;
  l.cs = cs;
  l.mp = round_up(H * H, 16);
  l.map = 0;
  l.a = sizeof(float) * static_cast<size_t>(H) * H * cs;
  l.whi = l.a + sizeof(uint32_t) * static_cast<size_t>(l.mp) * (kp + 4);
  l.wlo = l.whi + sizeof(__nv_bfloat16) * static_cast<size_t>(np) * (kp + 8);
  l.dww = l.wlo + sizeof(__nv_bfloat16) * static_cast<size_t>(np) * (kp + 8);
  l.dwb = l.dww + sizeof(float) * 9 * cp;
  l.pwb = l.dwb + sizeof(float) * cp;
  l.total = l.pwb + sizeof(float) * op;
  return l;
}

// A run of stride-1 blocks on (B, H, H, Cin0) maps, one image per CTA
// (persistent over images), the map in shared memory throughout.  Every
// block's Cin and Cout are multiples of 4 (the host checks).
__global__ void __launch_bounds__(kChainThreads, 1)
chain_kernel(const float* __restrict__ in, float* __restrict__ out,
             const __grid_constant__ Chain chain, int batch, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ChainLayout l = chain_layout(H, chain);
  const int cs = l.cs, n_pix = H * H;
  float* s_map = reinterpret_cast<float*>(smem + l.map);
  uint32_t* s_a = reinterpret_cast<uint32_t*>(smem + l.a);
  __nv_bfloat16* s_whi = reinterpret_cast<__nv_bfloat16*>(smem + l.whi);
  __nv_bfloat16* s_wlo = reinterpret_cast<__nv_bfloat16*>(smem + l.wlo);
  float* s_dww = reinterpret_cast<float*>(smem + l.dww);
  float* s_dwb = reinterpret_cast<float*>(smem + l.dwb);
  float* s_pwb = reinterpret_cast<float*>(smem + l.pwb);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int cin0 = chain.blk[0].cin, cout_n = chain.blk[chain.n - 1].cout;
  for (int img = blockIdx.x; img < batch; img += gridDim.x) {
    // the image's map, 16 bytes at a time, into rows of cs floats
    {
      const float* src = in + static_cast<size_t>(img) * n_pix * cin0;
      const int c4n = cin0 / 4;
      for (int i = threadIdx.x; i < n_pix * c4n; i += kChainThreads)
        cp_async16(s_map + (i / c4n) * cs + 4 * (i % c4n), src + 4 * i);
    }
    for (int k = 0; k < chain.n; ++k) {
      const ChainBlock& blk = chain.blk[k];
      const int Cin = blk.cin, Cout = blk.cout;
      const int kp = round_up(Cin, 16), ks = kp + 4, wkw = (kp + 8) / 2;
      const int cg = Cin / 4, kg = kp / 4, nt = round_up(Cout, 8) / 8;
      stage_matrix<kChainThreads>(s_dww, blk.dw_w, 9, Cin, 9, Cin);
      stage_matrix<kChainThreads>(s_dwb, blk.dw_b, 1, Cin, 1, Cin);
      stage_matrix<kChainThreads>(s_pwb, blk.pw_b, 1, Cout, 1, Cout);
      cp_async_commit();
      stage_bf16<kChainThreads>(s_whi, blk.w_hi, nt * 8, kp, kp + 8);
      stage_bf16<kChainThreads>(s_wlo, blk.w_lo, nt * 8, kp, kp + 8);
      cp_async_commit();
      cp_async_wait_one();             // the map and the depthwise weights
      __syncthreads();

      // depthwise 3x3 + bias (stride 1, zeros outside the map), split into
      // the A operands; a thread takes 4 channels of column j and slides
      // down kDwRows rows; groups past Cin write the zeros of the K pad
      const float4* map4 = reinterpret_cast<const float4*>(s_map);
      const float4* dww4 = reinterpret_cast<const float4*>(s_dww);
      const int cs4 = cs / 4;
      const int n_dw = ((H + kDwRows - 1) / kDwRows) * H * kg;
      for (int i = threadIdx.x; i < n_dw; i += kChainThreads) {
        const int c4 = i % kg, j = (i / kg) % H, r0 = i / (kg * H) * kDwRows;
        const int r1 = min(r0 + kDwRows, H);
        if (c4 >= cg) {
          for (int r = r0; r < r1; ++r) {
            uint32_t* a = s_a + (r * H + j) * ks + 2 * c4;
            *reinterpret_cast<uint2*>(a) = make_uint2(0u, 0u);
            *reinterpret_cast<uint2*>(a + ks / 2) = make_uint2(0u, 0u);
          }
          continue;
        }
        float4 w[9];
#pragma unroll
        for (int q = 0; q < 9; ++q) w[q] = dww4[q * cg + c4];
        const float4 bias = reinterpret_cast<const float4*>(s_dwb)[c4];
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        auto px = [&](int r, int c) {
          return (r >= 0 && r < H && c >= 0 && c < H)
                     ? map4[(r * H + c) * cs4 + c4] : zero;
        };
        float4 win[3][3];
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj) win[di][dj] = px(r0 - 1 + di, j - 1 + dj);
        for (int r = r0; r < r1; ++r) {
          float4 acc = zero;
#pragma unroll
          for (int di = 0; di < 3; ++di)
#pragma unroll
            for (int dj = 0; dj < 3; ++dj)
              acc = fma4v(win[di][dj], w[di * 3 + dj], acc);
          acc = add4(acc, bias);
          uint2 hi, lo;
          split4(acc, hi, lo);
          uint32_t* a = s_a + (r * H + j) * ks + 2 * c4;
          *reinterpret_cast<uint2*>(a) = hi;
          *reinterpret_cast<uint2*>(a + ks / 2) = lo;
          if (r + 1 < r1) {
#pragma unroll
            for (int dj = 0; dj < 3; ++dj) {
              win[0][dj] = win[1][dj];
              win[1][dj] = win[2][dj];
              win[2][dj] = px(r + 2, j - 1 + dj);
            }
          }
        }
      }
      cp_async_wait_all();             // the pointwise weights
      __syncthreads();

      // pointwise: a unit is 16 pixels x kChainTiles n-tiles; the epilogue
      // updates the map in place (the thread that writes an element is the
      // one that read its skip)
      const int mts = (n_pix + 15) / 16, ngs = (nt + kChainTiles - 1) / kChainTiles;
      const uint32_t* whi = reinterpret_cast<const uint32_t*>(s_whi) + g * wkw + t;
      const uint32_t* wlo = reinterpret_cast<const uint32_t*>(s_wlo) + g * wkw + t;
      for (int u = warp; u < mts * ngs; u += kChainWarps) {
        const int mt = u / ngs, n0 = (u % ngs) * kChainTiles;
        float acc[kChainTiles][4];
#pragma unroll
        for (int j = 0; j < kChainTiles; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.0f;
        const uint32_t* rows16 = s_a + mt * 16 * ks;
        for (int k0 = 0; k0 < kp; k0 += 16) {
          AFrag a;
          load_a(a, rows16 + g * ks + t, ks, k0 / 2);
#pragma unroll
          for (int j = 0; j < kChainTiles; ++j)
            if (n0 + j < nt)
              mma_3pass(acc[j], a, whi + (n0 + j) * 8 * wkw + k0 / 2,
                        wlo + (n0 + j) * 8 * wkw + k0 / 2);
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = mt * 16 + g + 8 * h;
          if (p >= n_pix) continue;
          float* m = s_map + p * cs;
#pragma unroll
          for (int j = 0; j < kChainTiles; ++j) {
            const int co = (n0 + j) * 8 + 2 * t;
            if (co >= Cout) continue;
            const float2 skip = co < Cin ? *reinterpret_cast<const float2*>(m + co)
                                         : make_float2(0.f, 0.f);
            const float2 bias = *reinterpret_cast<const float2*>(s_pwb + co);
            *reinterpret_cast<float2*>(m + co) = make_float2(
                fmaxf((acc[j][2 * h] + bias.x) + skip.x, 0.0f),
                fmaxf((acc[j][2 * h + 1] + bias.y) + skip.y, 0.0f));
          }
        }
      }
      __syncthreads();
    }
    // the last block's map, 16 bytes at a time
    {
      float* dst = out + static_cast<size_t>(img) * n_pix * cout_n;
      const int c4n = cout_n / 4;
      for (int i = threadIdx.x; i < n_pix * c4n; i += kChainThreads)
        *reinterpret_cast<float4*>(dst + 4 * i) =
            *reinterpret_cast<const float4*>(s_map + (i / c4n) * cs + 4 * (i % c4n));
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ host
// The grid of a persistent launch of `items` work items: what fits on the
// card at once, or `items` when fewer.  The kernel's dynamic shared memory
// limit is raised to the block maximum once per kernel and device, and its
// CTAs per SM are read once per kernel, size and device (not per launch).
template <auto Kernel, int Threads>
int persistent_grid(int items, size_t smem, int* grid) {
  struct Fit { int smem, grid; };
  constexpr int kSizes = 8;
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
  int found = -1;
  for (int i = 0; i < n_fit[dev]; ++i)
    if (fit[dev][i].smem == static_cast<int>(smem)) found = i;
  if (found < 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, Kernel,
                                                        Threads, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    found = n_fit[dev] < kSizes ? n_fit[dev]++ : 0;
    fit[dev][found] = Fit{static_cast<int>(smem), (per_sm > 0 ? per_sm : 1) * sms};
  }
  *grid = items < fit[dev][found].grid ? items : fit[dev][found].grid;
  return 0;
}

template <auto Kernel, int Threads, typename... Args>
int launch(int items, size_t smem, cudaStream_t stream, Args... args) {
  int grid = 0;
  const int err = persistent_grid<Kernel, Threads>(items, smem, &grid);
  if (err != 0) return err;
  Kernel<<<grid, Threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// The widest band (at most kMaxBand rows) whose CTA fits the budget,
// narrowed while the layer has fewer than kMinItems work items (the small
// maps: more CTAs in flight for a little more halo); 0 when not even one
// row fits in a block's shared memory.
int pick_band(int batch, int H, int Cin, int Cout, int stride) {
  const int Ho = H / stride;
  auto smem = [&](int r) { return block_layout(H, Cin, Cout, stride, r).total; };
  int band = Ho < kMaxBand ? Ho : kMaxBand;
  while (band > 1 && smem(band) > static_cast<size_t>(kSmemBudget)) --band;
  while (band > 1 && batch * ((Ho + band - 1) / band) < kMinItems) --band;
  return smem(band) <= static_cast<size_t>(kSmemMax) ? band : 0;
}

template <int STRIDE>
int launch_block(const float* in, const float* dw_w, const float* dw_b,
                 const __nv_bfloat16* w_hi, const __nv_bfloat16* w_lo,
                 const float* pw_b, float* out, int batch, int H, int Cin,
                 int Cout, cudaStream_t stream) {
  if (Cin > kMaxChannels || Cout > kMaxChannels) return kErrTooWide;
  const int band = pick_band(batch, H, Cin, Cout, STRIDE);
  if (band == 0) return kErrTooWide;
  const int Ho = H / STRIDE;
  const int items = batch * ((Ho + band - 1) / band);
  const size_t smem = block_layout(H, Cin, Cout, STRIDE, band).total;
  const int nt = round_up(Cout, 8) / 8;
  if (nt <= 4)
    return launch<block_kernel<4, STRIDE>, kThreads>(items, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, batch, H, Cin, Cout, band);
  if (nt <= 8)
    return launch<block_kernel<8, STRIDE>, kThreads>(items, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, batch, H, Cin, Cout, band);
  if (nt <= 12)
    return launch<block_kernel<12, STRIDE>, kThreads>(items, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, batch, H, Cin, Cout, band);
  return launch<block_kernel<16, STRIDE>, kThreads>(items, smem, stream, in, dw_w, dw_b, w_hi, w_lo, pw_b, out, batch, H, Cin, Cout, band);
}

// Does a chain of blocks first..last (stride 1 on an H x H map) fit one
// chain_kernel CTA?  Channels must be multiples of 4.
bool chain_fits(const int* channels, int first, int last, int H, int cin) {
  if (last - first + 1 > kMaxChain) return false;
  Chain c{};
  c.n = last - first + 1;
  for (int i = first; i <= last; ++i) {
    const int ci = i == first ? cin : channels[i - 1];
    if (ci % 4 || channels[i] % 4 || channels[i] > kMaxChannels) return false;
    c.blk[i - first].cin = ci;
    c.blk[i - first].cout = channels[i];
  }
  return chain_layout(H, c).total <= static_cast<size_t>(kSmemMax);
}

// The launches of a segment: group_sizes[g] blocks each, in order.  The
// longest run of two or more stride-1 blocks from a block on whose map
// chain_fits holds is one chain launch; every other block is one
// block_kernel launch.  Returns the number of groups.
int plan_groups(const int* channels, const int* strides, int n_blocks, int H,
                int cin, int* group_sizes) {
  int n_groups = 0, i = 0;
  while (i < n_blocks) {
    const int ci = i == 0 ? cin : channels[i - 1];
    int last = i;
    if (strides[i] == 1) {
      while (last + 1 < n_blocks && strides[last + 1] == 1 &&
             chain_fits(channels, i, last + 1, H, ci))
        ++last;
    }
    if (last > i) {
      group_sizes[n_groups++] = last - i + 1;
    } else {
      group_sizes[n_groups++] = 1;
      H /= strides[i];
    }
    i = last + 1;
  }
  return n_groups;
}

}  // namespace

// The launches `headpose_backbone2_segment` makes for a segment: writes each
// launch's number of blocks into group_sizes (n_blocks ints) and returns
// their count.  Arguments as for headpose_backbone2_segment.
extern "C" int headpose_backbone2_groups(const int* channels,
                                         const int* strides, int n_blocks,
                                         int H, int cin, int* group_sizes) {
  return plan_groups(channels, strides, n_blocks, H, cin, group_sizes);
}

// Runs the blocks of one segment on `stream` and returns 0, a CUDA error
// code, or -1 (kErrTooWide) when a layer is wider than the kernels take.
//
//   x         (B, H, H, Cin) float32 NHWC, device, 16-byte aligned: the
//             segment's input
//   f32       the packed fp32 weights, device; `f32_offsets` (host, 3 ints
//             per block) give each block's dw (3, 3, Cin), dw bias (Cin) and
//             pw bias (Cout), in floats
//   bf16      the packed bf16 weights, device, 16-byte aligned;
//             `bf16_offsets` (host, 2 ints per block, multiples of 8) give
//             each block's w_hi and w_lo, (Np, Kp) each: the pointwise
//             weights transposed, [out][in], zero-padded to Np = Cout
//             rounded up to 8 and Kp = Cin rounded up to 16
//   channels, strides   (host, n_blocks ints) each block's Cout and stride
//   buf_a, buf_b        device scratch, each the size of the largest
//             intermediate map (unused for a one-launch segment)
//   out       (B, Ho, Ho, channels[n_blocks - 1]): the segment's output
extern "C" int headpose_backbone2_segment(
    const float* x, const float* f32, const int* f32_offsets,
    const __nv_bfloat16* bf16, const int* bf16_offsets, const int* channels,
    const int* strides, int n_blocks, int H, int cin, float* buf_a,
    float* buf_b, float* out, int batch, cudaStream_t stream) {
  if (batch <= 0) return 0;
  int sizes[64];
  if (n_blocks > 64) return kErrTooWide;
  const int n_groups = plan_groups(channels, strides, n_blocks, H, cin, sizes);
  const float* cur = x;
  int i = 0;
  for (int gi = 0; gi < n_groups; ++gi) {
    float* dst = gi == n_groups - 1 ? out : (cur == buf_a ? buf_b : buf_a);
    int err;
    if (sizes[gi] > 1) {
      Chain c{};
      c.n = sizes[gi];
      for (int k = 0; k < c.n; ++k) {
        const int* fo = f32_offsets + 3 * (i + k);
        const int* bo = bf16_offsets + 2 * (i + k);
        c.blk[k] = ChainBlock{f32 + fo[0], f32 + fo[1], f32 + fo[2],
                              bf16 + bo[0], bf16 + bo[1],
                              k == 0 ? cin : channels[i + k - 1],
                              channels[i + k]};
      }
      err = launch<chain_kernel, kChainThreads>(
          batch, chain_layout(H, c).total, stream, cur, dst, c, batch, H);
      cin = channels[i + c.n - 1];
    } else {
      const int* fo = f32_offsets + 3 * i;
      const int* bo = bf16_offsets + 2 * i;
      const int cout = channels[i];
      err = strides[i] == 1
                ? launch_block<1>(cur, f32 + fo[0], f32 + fo[1], bf16 + bo[0],
                                  bf16 + bo[1], f32 + fo[2], dst, batch, H,
                                  cin, cout, stream)
                : launch_block<2>(cur, f32 + fo[0], f32 + fo[1], bf16 + bo[0],
                                  bf16 + bo[1], f32 + fo[2], dst, batch, H,
                                  cin, cout, stream);
      H /= strides[i];
      cin = cout;
    }
    if (err != 0) return err;
    i += sizes[gi];
    cur = dst;
  }
  return 0;
}
