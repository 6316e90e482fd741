// The SE-Transformer pose head for NVIDIA Hopper (sm_90a): squeeze-and-
// excitation gate, multi-head self-attention over each image's tokens,
// residual + LayerNorm, FFN, residual + LayerNorm, ReLU 1x1 and the output
// 1x1, for a batch of (B, H, W, C) maps; every product on the tensor cores
// in 3-pass TF32, the rest in fp32 on the CUDA cores.
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/se_attention.py::
// se_transformer_forward (_kernel).  The plain PyTorch version is
// headpose_tpu_torch/ops/kernels/se_attention.py::
// se_transformer_forward_plain, the wrapper se_transformer_forward.
//
// Semantics, per image of T = H*W tokens x (T, C):
//   s  = sigmoid(relu(mean_t(x) @ W1 + b1) @ W2 + b2)          (1, C)
//   t  = x * s
//   q, k, v = t @ Wq + bq, t @ Wk + bk, t @ Wv + bv   (T, H*D), heads
//             flattened as the JAX wrapper flattens (C, H, D) → (C, H*D)
//   o_h = softmax(q_h k_h^T * (1 / sqrt(D))) v_h      per head h
//   t1 = LN1(t + (o @ Wo + bo));  t2 = LN2(t1 + relu(t1 @ F1 + f1) @ F2 + f2)
//   y  = relu(t2 @ Wfc + bfc) @ Wout + bout             (T, out)
// LayerNorm: (x - mu) * (1 / sqrt(var + 1e-3)) * g + b, var the mean of
// (x - mu)^2 (Keras).  A (N, C) row is a 1x1 map: T = 1, where the softmax
// over one key is exactly 1 and o = v.
//
// Precision: 3-pass TF32.  Each operand x is split in registers into
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna; x - hi is exact), and a
// product is lo.hi + hi.lo + hi.hi, each an mma.sync.m16n8k8 with fp32
// accumulation.  hi + lo holds x to about 2^-22 of its value, so the
// dropped lo.lo term and the split cost about what fp32 rounding does; the
// split-bf16 of csrc/backbone2.cu keeps 2^-17 and does not meet this head's
// rtol 1e-4 / atol 1e-5 after the softmax and two LayerNorms (the CPU tests
// emulate both: tests/test_torch_se_attention.py).
//
// What bounds it on this card: operations.  At the flagship's maps (16x16
// tokens of 88 channels, 8x8 of 96; 4 heads of 16, ff 64, hidden 128) the
// two heads are 6.07 GFLOP of products at B=128: three TF32 passes, 18.2
// GFLOP, take 0.037 ms at 495 TFLOP/s; the softmax, LayerNorms and gate
// about 0.28 GFLOP of fp32 (0.004 ms at 67 TFLOP/s); 15.6 MB move (0.005 ms).
//
// Design.  Rows are tiled by 64 (an image of 256 tokens spans 4 CTAs; a tile
// of 1x1 maps holds 64 images); 8 warps, warp w owns rows 16 (w % 4) and,
// in a product, half of each 32-column weight tile (w / 4), or in the
// attention, every other head.  Three launches for T > 1:
//   * gate: one CTA per image, the token mean (eight loads in flight per
//     thread) and the gate's two small products;
//   * kv: per tile, t = x * gate and K, V of its rows into a scratch buffer
//     (K and V of every token are needed by every tile of the image:
//     recomputing them per query tile would do 4x the K/V products);
//   * attend: t and Q of the tile's rows; then, flash-style, each warp's 16
//     rows against its image's keys, streamed through shared memory in
//     chunks of 32 keys with cp.async into two buffers (the next chunk loads
//     while this one is used): S = Q K^T per 8-key block as mma fragments,
//     a running max and sum per row in registers (quad shuffles), the
//     accumulator rescaled when the max moves, and P (kept in its C
//     fragment: keys are taken in the order 2t, 2t+1 -> k, k+4, so the C
//     fragment is the A fragment) times V as the second product.  Then the
//     output projection, LayerNorm (a warp per row), FFN, LayerNorm and the
//     two 1x1s.  Only the (rows, out) result is written.
// For T = 1 one launch: attend computes each row's gate itself (the mean of
// one token is the token) and o = t @ Wv + bv, with no Q, K or softmax.
// The tile's rows of x arrive with cp.async.  Each layer's weights are
// staged in tiles of 32 columns (16-byte copies from a pack padded for it)
// into two shared buffers with cp.async, the next tile (or the next layer's
// first) while this one is multiplied; the K/V chunks use the same two
// buffers.  Every shared array read as a fragment has a pitch that sends a
// warp's 32 loads to 32 banks: activations and K/V p = 4 (mod 32), weights
// 40 floats.  Two CTAs share an SM (100 KB of shared memory and 125
// registers a thread at the flagship's widths).
// FMA contraction is allowed (the wrapper's plain version is matched within
// a tolerance); no fast math: sqrtf and division are IEEE, expf (the gate)
// and exp2f (the softmax, on scores scaled by log2(e) / sqrt(D)) libdevice's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // rows (tokens) per CTA
constexpr int kTileN = 32;              // weight columns per staged tile
constexpr int kWarpN = kTileN / 2;      // of which a warp's
constexpr int kWPitch = kTileN + 8;     // floats per staged weight row: the
                                        // rows t = 0..3 of a B fragment
                                        // start 8 banks apart
constexpr int kKeys = 32;               // keys per K/V chunk
constexpr int kMaxC = 128;
constexpr int kMaxHD = 64;
constexpr int kMaxFF = 256;
constexpr int kMaxHidden = 256;
constexpr int kMaxOut = 8;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;        // a block's limit on sm_90
constexpr int kErrUnsupported = -1;
constexpr float kEps = 1e-3f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}
// a pitch >= n with pitch = 4 (mod 32): the rows g = 0..7 of a fragment load
// start 4 banks apart, and its columns t = 0..3 fill the gaps
__host__ __device__ constexpr int frag_pitch(int n) { return round_up(n, 32) + 4; }

// the packed weights, in the order of ops/kernels/se_attention.py::_leaves
enum Leaf : int {
  kSe1W, kSe1B, kSe2W, kSe2B, kQW, kQB, kKW, kKB, kVW, kVB, kOW, kOB,
  kLn1G, kLn1B, kF1W, kF1B, kF2W, kF2B, kLn2G, kLn2B, kFcW, kFcB, kOutW,
  kOutB, kLeaves
};

struct Dims {
  int C, M, H, D, HD, F, hidden, out;   // M: the SE gate's width
  int T, n_rows;
  int off[kLeaves];
};

// A CTA's shared memory, in floats.  attend: t (kRows x pc), x (kRows x px:
// Q, then o, the FFN's and the 1x1's hidden rows), the ring (two weight
// tiles or two K/V chunks).  kv: t, then the ring (two weight tiles).
struct Layout {
  int pc, px, pkv, wbuf, kvbuf;
  size_t t, x, ring, total;
};

__host__ __device__ inline Layout layout(const Dims& d, bool attend) {
  Layout l;
  l.pc = frag_pitch(d.C);
  l.px = attend ? frag_pitch(imax(imax(d.HD, d.M), imax(d.F, d.hidden))) : 0;
  l.pkv = frag_pitch(d.HD);
  const int k8 = attend ? round_up(imax(imax(d.C, d.HD), imax(d.F, d.hidden)), 8)
                        : round_up(d.C, 8);
  l.wbuf = k8 * kWPitch;
  l.kvbuf = 2 * kKeys * l.pkv;
  const int ring = 2 * (attend ? imax(l.wbuf, l.kvbuf) : l.wbuf);
  l.t = 0;
  l.x = static_cast<size_t>(kRows) * l.pc;
  l.ring = l.x + static_cast<size_t>(kRows) * l.px;
  l.total = l.ring + ring;
  return l;
}

// ---------------------------------------------------------------- helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 4 bytes, or 4 zeros when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
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

// x = hi + lo, each a TF32 value in a 32-bit register
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float r = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(r));
}

// D += A.B for one m16n8k8 TF32 tile.  Fragments (PTX ISA), lane = 4 g + t:
// A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (t, g),
// b1 (t + 4, g); D d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8,
// 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the 3-pass product, small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// the A fragment of rows a[0..15] (pitch ap), columns k0..k0+7, split
__device__ __forceinline__ void load_a(const float* a, int ap, int k0,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  split(a[g * ap + k0 + t], hi[0], lo[0]);
  split(a[(g + 8) * ap + k0 + t], hi[1], lo[1]);
  split(a[g * ap + k0 + t + 4], hi[2], lo[2]);
  split(a[(g + 8) * ap + k0 + t + 4], hi[3], lo[3]);
}

struct Layer {
  const float* w;   // (K, N) in a (round_up(K, 8), round_up(N, 32)) array
  const float* b;   // (N)
  int K, N;
};

__device__ inline Layer layer(const float* p, const Dims& d, int w, int b,
                              int K, int N) {
  return Layer{p + d.off[w], p + d.off[b], K, N};
}

// columns [n0, n0 + kTileN) of L's weights into dst: round_up(K, 8) rows of
// kWPitch floats.  The pack holds each such matrix zero-padded to
// (round_up(K, 8), round_up(N, 32)) with a 16-byte aligned start
// (ops/kernels/se_attention.py::_kernel_leaves), so a tile is whole
// 16-byte chunks.
__device__ void stage_weights(float* dst, const Layer& L, int n0) {
  constexpr int q = kTileN / 4;
  const int k8 = round_up(L.K, 8), ld = round_up(L.N, kTileN);
  for (int i = threadIdx.x; i < k8 * q; i += kThreads) {
    const int k = i / q, f = 4 * (i % q);
    cp_async16(dst + k * kWPitch + f, L.w + static_cast<size_t>(k) * ld + n0 + f);
  }
}

// rows row0 .. row0 + rows - 1 of x (n, C) into t (kRows x pc) with
// cp.async (16 bytes when C % 4 == 0); zeros in the rows past `rows` and in
// columns C..round_up(C, 8)
__device__ void stage_rows(float* t, int pc, const float* __restrict__ x,
                           int row0, int rows, int C) {
  const float* xr = x + static_cast<size_t>(row0) * C;
  if (C % 4 == 0) {
    const int q = C / 4;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int r = i / q, f = 4 * (i % q);
      cp_async16(t + r * pc + f, xr + r * C + f);
    }
  } else {
    for (int i = threadIdx.x; i < rows * C; i += kThreads)
      cp_async4(t + i / C * pc + i % C, xr + i, true);
  }
  const int c8 = round_up(C, 8);
  for (int i = threadIdx.x; i < kRows * c8; i += kThreads) {
    const int r = i / c8, c = i % c8;
    if (r >= rows || c >= C) t[r * pc + c] = 0.0f;
  }
}

// out = a (kRows x K, pitch ap, zeros in columns K..round_up(K, 8)) @ L.w,
// tile by tile of 32 columns; the first tile is already in flight into ring
// buffer (tile & 1).  While a tile is multiplied the next one (or `next`'s
// first) loads into the other buffer.  epi(row, col, v0, v1) is called for
// each pair of columns col, col + 1 (col even) of the warp's rows with
// col < round_up(N, 8).  hi.hi and the two lo terms sum into separate
// accumulators (two dependency chains, not one), added at the end.
template <typename Epi>
__device__ void dense(const float* a, int ap, const Layer& L,
                      const Layer* next, float* ring, int wbuf, int& tile,
                      Epi epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3), c0 = kWarpN * (warp >> 2);
  const int k8 = round_up(L.K, 8), n8 = round_up(L.N, 8);
  const int chunks = (L.N + kTileN - 1) / kTileN;
  for (int c = 0; c < chunks; ++c, ++tile) {
    cp_async_wait_all();
    __syncthreads();
    float* other = ring + ((tile + 1) & 1) * wbuf;
    if (c + 1 < chunks) {
      stage_weights(other, L, (c + 1) * kTileN);
    } else if (next != nullptr) {
      stage_weights(other, *next, 0);
    }
    cp_async_commit();
    const int n0 = c * kTileN + c0;
    if (n0 >= n8) continue;                      // warp-uniform
    const float* w = ring + (tile & 1) * wbuf + c0;
    constexpr int NJ = kWarpN / 8;
    float hh[NJ][4] = {}, lo[NJ][4] = {};
#pragma unroll 2
    for (int k0 = 0; k0 < k8; k0 += 8) {
      uint32_t ah[4], al[4];
      load_a(a + r0 * ap, ap, k0, ah, al);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        uint32_t bh[2], bl[2];
        split(w[(k0 + t) * kWPitch + 8 * j + g], bh[0], bl[0]);
        split(w[(k0 + t + 4) * kWPitch + 8 * j + g], bh[1], bl[1]);
        mma_tf32(lo[j], al, bh);
        mma_tf32(lo[j], ah, bl);
        mma_tf32(hh[j], ah, bh);
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      if (col >= n8) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(r0 + g + 8 * h, col, hh[j][2 * h] + lo[j][2 * h],
            hh[j][2 * h + 1] + lo[j][2 * h + 1]);
    }
  }
}

// In place, each of the kRows rows of x (pitch p, C channels): LayerNorm
// with gain g and offset b.  One warp per row; lanes hold channels lane,
// lane + 32, ...
__device__ void layernorm(float* x, int p, int C, const float* __restrict__ g,
                          const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = x + r * p;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += row[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / static_cast<float>(C);
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float dlt = row[c] - mu;
      sq += dlt * dlt;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.0f / sqrtf(sq / static_cast<float>(C) + kEps);
    for (int c = lane; c < C; c += 32)
      row[c] = (row[c] - mu) * rstd * __ldg(g + c) + __ldg(b + c);
  }
}

// Launch 1 (T > 1): the SE gate of each image, one CTA per image.
//   x (n_images * T, C); gate (n_images, C)
__global__ void __launch_bounds__(kThreads)
gate_kernel(const float* __restrict__ x, const float* __restrict__ p,
            float* __restrict__ gate, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int C = d.C, T = d.T, M = d.M, img = blockIdx.x;
  const int split = imax(1, kThreads / C);           // partial sums per channel
  float* part = smem;                                // split x C
  float* s = part + split * C;                       // C: mean, gate
  float* mid = s + C;                                // M
  const float* xi = x + static_cast<size_t>(img) * T * C;
  // the token mean: thread (q, c) sums tokens q, q + split, ... with eight
  // loads in flight
  if (threadIdx.x < split * C) {
    const int c = threadIdx.x % C, q = threadIdx.x / C;
    float acc[8] = {};
    int tok = q;
    for (; tok + 7 * split < T; tok += 8 * split) {
#pragma unroll
      for (int u = 0; u < 8; ++u)
        acc[u] += xi[static_cast<size_t>(tok + u * split) * C + c];
    }
    for (; tok < T; tok += split) acc[0] += xi[static_cast<size_t>(tok) * C + c];
    part[threadIdx.x] = ((acc[0] + acc[1]) + (acc[2] + acc[3])) +
                        ((acc[4] + acc[5]) + (acc[6] + acc[7]));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float acc = 0.0f;
    for (int q = 0; q < split; ++q) acc += part[q * C + c];
    s[c] = acc / static_cast<float>(T);
  }
  __syncthreads();
  // relu(mean W1 + b1): a warp per hidden value, lanes over the channels
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int m = warp; m < M; m += kThreads / 32) {
    const float* w = p + d.off[kSe1W];
    float acc = 0.0f;
    for (int c = lane; c < C; c += 32) acc = fmaf(s[c], __ldg(w + c * M + m), acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0) mid[m] = fmaxf(acc + __ldg(p + d.off[kSe1B] + m), 0.0f);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float* w = p + d.off[kSe2W];
    float acc = __ldg(p + d.off[kSe2B] + c);
    for (int m = 0; m < M; ++m) acc = fmaf(mid[m], __ldg(w + m * C + c), acc);
    gate[static_cast<size_t>(img) * C + c] = 1.0f / (1.0f + expf(-acc));
  }
}

// t = x * gate of the tile's rows, in place (the gates from launch 1)
__device__ void apply_gates(float* t, int pc, const float* __restrict__ gate,
                            int row0, int rows, int C, int T) {
#pragma unroll 4
  for (int i = threadIdx.x; i < rows * C; i += kThreads) {
    const int r = i / C, c = i % C;
    t[r * pc + c] *= __ldg(gate + static_cast<size_t>((row0 + r) / T) * C + c);
  }
}

// Launch 2 (T > 1): K and V of the tile's rows.  kv (n_rows, 2 HD): [K | V]
__global__ void __launch_bounds__(kThreads)
kv_kernel(const float* __restrict__ x, const float* __restrict__ p,
          const float* __restrict__ gate, float* __restrict__ kv, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(d, false);
  const int C = d.C, HD = d.HD, pc = L.pc;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n_rows - row0);
  float* t = smem + L.t;                             // kRows x pc
  float* ring = smem + L.ring;
  const Layer lk = layer(p, d, kKW, kKB, C, HD);
  const Layer lv = layer(p, d, kVW, kVB, C, HD);
  stage_rows(t, pc, x, row0, rows, C);
  stage_weights(ring, lk, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  apply_gates(t, pc, gate, row0, rows, C, d.T);
  int tile = 0;                                      // dense() syncs first
  float* kvt = kv + static_cast<size_t>(row0) * 2 * HD;
  for (int half = 0; half < 2; ++half) {            // K, then V
    const Layer& lw = half == 0 ? lk : lv;
    dense(t, pc, lw, half == 0 ? &lv : nullptr, ring, L.wbuf, tile,
          [&](int r, int col, float v0, float v1) {
            if (r < rows)                             // HD % 8 == 0
              *reinterpret_cast<float2*>(kvt + r * 2 * HD + half * HD + col) =
                  make_float2(v0 + __ldg(lw.b + col), v1 + __ldg(lw.b + col + 1));
          });
  }
}

// a chunk of kKeys keys from key0 into dst: K (kKeys x pkv) then V; keys
// at or past k_end are zeros (masked, and 0 * V must stay finite)
__device__ void stage_kv(float* dst, const float* __restrict__ kv, int key0,
                         int k_end, int pkv, int HD) {
  const int n = min(kKeys, k_end - key0);
  const int q4 = HD / 2;                       // float4s per key: K then V
  for (int i = threadIdx.x; i < kKeys * q4; i += kThreads) {
    const int key = i / q4, f = 4 * (i % q4);
    float* to = dst + (f < HD ? key * pkv + f : (kKeys + key) * pkv + f - HD);
    if (key < n) {
      cp_async16(to, kv + static_cast<size_t>(key0 + key) * 2 * HD + f);
    } else {
      *reinterpret_cast<float4*>(to) = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// Flash attention of the tile's rows: each warp 16 rows and every other head
// (all heads for one head: warps 0-3).  q (kRows x px) holds Q on entry and
// o on return, head h in columns h D .. h D + D - 1.
template <int D, int H>
__device__ void attention(float* q, int px, const float* __restrict__ kv,
                          float* ring, const Layout& L, const Dims& d,
                          int row0, int rows, int img0, int n_img) {
  constexpr int HPW = H >= 2 ? H / 2 : 1;   // heads per warp
  constexpr int ND = D / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = 16 * (warp & 3);
  const int T = d.T, HD = d.HD, pkv = L.pkv;
  const bool active = (H >= 2 || warp < 4) && r0 < rows;
  // the images of the thread's two rows (-1 past the end), the warp's keys
  const int img_a = r0 + g < rows ? (row0 + r0 + g) / T : -1;
  const int img_b = r0 + g + 8 < rows ? (row0 + r0 + g + 8) / T : -1;
  const int key_lo = (row0 + r0) / T * T;
  const int key_hi = ((row0 + min(r0 + 16, rows) - 1) / T + 1) * T;
  // all 16 rows in one image: a key block inside it needs no mask
  const bool one_image = r0 + 16 <= rows && key_hi - key_lo == T;
  // scores in log2 units: q.k / sqrt(D) * log2(e), and exp2
  const float scale = 1.44269504088896341f / sqrtf(static_cast<float>(D));

  uint32_t qh[HPW][ND][4], ql[HPW][ND][4];
  float acc[HPW][ND][4], m[HPW][2], l[HPW][2];
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = (warp >> 2) + 2 * i;
#pragma unroll
    for (int kk = 0; kk < ND; ++kk) {
      if (active) load_a(q + r0 * px, px, h * D + 8 * kk, qh[i][kk], ql[i][kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][kk][e] = 0.0f;
    }
    m[i][0] = m[i][1] = -INFINITY;
    l[i][0] = l[i][1] = 0.0f;
  }

  const int k_begin = img0 * T, k_end = (img0 + n_img) * T;
  stage_kv(ring, kv, k_begin, k_end, pkv, HD);
  cp_async_commit();
  int j = 0;
  for (int c0 = k_begin; c0 < k_end; c0 += kKeys, ++j) {
    cp_async_wait_all();
    __syncthreads();
    if (c0 + kKeys < k_end)
      stage_kv(ring + ((j + 1) & 1) * L.kvbuf, kv, c0 + kKeys, k_end, pkv, HD);
    cp_async_commit();
    if (!active || c0 >= key_hi || c0 + kKeys <= key_lo) continue;
    const float* ks = ring + (j & 1) * L.kvbuf;
    const float* vs = ks + kKeys * pkv;
#pragma unroll
    for (int i = 0; i < HPW; ++i) {
      const int h = (warp >> 2) + 2 * i;
      float s[kKeys / 8][4];
      bool live[kKeys / 8];
#pragma unroll
      for (int kb = 0; kb < kKeys / 8; ++kb) {
        const int base = c0 + 8 * kb;
        live[kb] = base < k_end && base + 8 > key_lo && base < key_hi;
#pragma unroll
        for (int e = 0; e < 4; ++e) s[kb][e] = 0.0f;
        if (live[kb]) {
#pragma unroll
          for (int kk = 0; kk < ND; ++kk) {
            const float* kr = ks + (8 * kb + g) * pkv + h * D + 8 * kk + t;
            uint32_t bh[2], bl[2];
            split(kr[0], bh[0], bl[0]);
            split(kr[4], bh[1], bl[1]);
            mma3(s[kb], qh[i][kk], ql[i][kk], bh, bl);
          }
        }
        if (one_image && base >= key_lo && base + 8 <= key_hi) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[kb][e] *= scale;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = base + 2 * t + (e & 1);
            const int img = e < 2 ? img_a : img_b;
            const bool ok = live[kb] && img >= 0 && key >= img * T &&
                            key < img * T + T;
            s[kb][e] = ok ? s[kb][e] * scale : -INFINITY;
          }
        }
      }
      // the running max of rows g and g + 8, the rescale, P
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int kb = 0; kb < kKeys / 8; ++kb)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[kb][e]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float mn = fmaxf(m[i][r], mx[r]);
        const float alpha = mn == -INFINITY ? 1.0f : exp2f(m[i][r] - mn);
        m[i][r] = mn;
        mx[r] = mn;                    // from here: the new max
        l[i][r] *= alpha;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          acc[i][dn][2 * r] *= alpha;
          acc[i][dn][2 * r + 1] *= alpha;
        }
      }
#pragma unroll
      for (int kb = 0; kb < kKeys / 8; ++kb) {
        if (!live[kb]) continue;
        float pv[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mn = mx[e >> 1];
          pv[e] = s[kb][e] == -INFINITY ? 0.0f : exp2f(s[kb][e] - mn);
          l[i][e >> 1] += pv[e];
        }
        // keys 2t, 2t + 1 of the block stand at k = t, t + 4 of the A
        // fragment: a0 (g, 2t), a1 (g + 8, 2t), a2 (g, 2t + 1), a3 (g + 8, 2t + 1)
        uint32_t ph[4], pl[4];
        split(pv[0], ph[0], pl[0]);
        split(pv[2], ph[1], pl[1]);
        split(pv[1], ph[2], pl[2]);
        split(pv[3], ph[3], pl[3]);
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          const float* vr = vs + (8 * kb + 2 * t) * pkv + h * D + 8 * dn + g;
          uint32_t bh[2], bl[2];
          split(vr[0], bh[0], bl[0]);
          split(vr[pkv], bh[1], bl[1]);
          mma3(acc[i][dn], ph, pl, bh, bl);
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int i = 0; i < HPW; ++i) {
    const int h = (warp >> 2) + 2 * i;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 1);
      l[i][r] += __shfl_xor_sync(0xffffffffu, l[i][r], 2);
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float li = l[i][e >> 1];
        q[(r0 + g + 8 * (e >> 1)) * px + h * D + 8 * dn + 2 * t + (e & 1)] =
            li > 0.0f ? acc[i][dn][e] / li : 0.0f;
      }
  }
}

// Launch 3 (the only one for T = 1): t (and for T = 1 the gate) of the
// tile's rows, then Q and the attention, or for T = 1 o = V; then the
// block's tail and the head's two 1x1s.  out (n_rows, out).
template <int D, int H>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ x, const float* __restrict__ p,
              const float* __restrict__ gate, const float* __restrict__ kv,
              float* __restrict__ out, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(d, true);
  const int C = d.C, T = d.T, HD = d.HD, pc = L.pc, px = L.px;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n_rows - row0);
  const int img0 = row0 / T;
  const int n_img = (row0 + rows - 1) / T - img0 + 1;
  float* t = smem + L.t;                    // kRows x pc
  float* xs = smem + L.x;                   // kRows x px
  float* ring = smem + L.ring;
  const Layer lq = layer(p, d, kQW, kQB, C, HD);
  const Layer lv = layer(p, d, kVW, kVB, C, HD);
  const Layer lo = layer(p, d, kOW, kOB, HD, C);
  const Layer lf1 = layer(p, d, kF1W, kF1B, C, d.F);
  const Layer lf2 = layer(p, d, kF2W, kF2B, d.F, C);
  const Layer lfc = layer(p, d, kFcW, kFcB, C, d.hidden);
  const Layer lout = layer(p, d, kOutW, kOutB, d.hidden, d.out);
  int tile = 0;
  // the tile's rows of x into t and the first weight tile, together
  stage_rows(t, pc, x, row0, rows, C);
  stage_weights(ring, T == 1 ? lv : lq, 0);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  if (T == 1) {
    // each row is its own image: s = sigmoid(relu(x W1 + b1) W2 + b2), the
    // hidden values in xs; then o = v = t Wv + bv (softmax over one key: 1)
    for (int item = threadIdx.x; item < kRows * d.M; item += kThreads) {
      const int r = item / d.M, m = item % d.M;
      const float* w = p + d.off[kSe1W];
      float acc = __ldg(p + d.off[kSe1B] + m);
#pragma unroll 8
      for (int c = 0; c < C; ++c)
        acc = fmaf(t[r * pc + c], __ldg(w + c * d.M + m), acc);
      xs[r * px + m] = fmaxf(acc, 0.0f);
    }
    __syncthreads();
    for (int item = threadIdx.x; item < kRows * C; item += kThreads) {
      const int r = item / C, c = item % C;
      const float* w = p + d.off[kSe2W];
      float acc = __ldg(p + d.off[kSe2B] + c);
      for (int m = 0; m < d.M; ++m)
        acc = fmaf(xs[r * px + m], __ldg(w + m * C + c), acc);
      t[r * pc + c] *= 1.0f / (1.0f + expf(-acc));
    }
    dense(t, pc, lv, &lo, ring, L.wbuf, tile,
          [&](int r, int col, float v0, float v1) {   // HD % 8 == 0
            xs[r * px + col] = v0 + __ldg(lv.b + col);
            xs[r * px + col + 1] = v1 + __ldg(lv.b + col + 1);
          });
  } else {
    apply_gates(t, pc, gate, row0, rows, C, T);   // dense() syncs first
    dense(t, pc, lq, nullptr, ring, L.wbuf, tile,
          [&](int r, int col, float v0, float v1) {
            xs[r * px + col] = v0 + __ldg(lq.b + col);
            xs[r * px + col + 1] = v1 + __ldg(lq.b + col + 1);
          });
    __syncthreads();                      // Q whole; the ring free for K/V
    attention<D, H>(xs, px, kv, ring, L, d, row0, rows, img0, n_img);
    __syncthreads();                      // o whole; the ring free again
    stage_weights(ring + (tile & 1) * L.wbuf, lo, 0);
    cp_async_commit();
  }

  // epilogues: column c of a pair (each col < round_up(N, 8)); columns
  // N..round_up(N, 8) of a shared array read as an A operand get zeros
  auto residual = [&](const Layer& lw) {      // t += v + b, in place
    return [&, lw](int r, int col, float v0, float v1) {
      const float v[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float* u = t + r * pc + col + e;
        *u = col + e < C ? *u + (v[e] + __ldg(lw.b + col + e)) : 0.0f;
      }
    };
  };
  auto hidden = [&](const Layer& lw) {        // xs = relu(v + b)
    return [&, lw](int r, int col, float v0, float v1) {
      const float v[2] = {v0, v1};
#pragma unroll
      for (int e = 0; e < 2; ++e)
        xs[r * px + col + e] =
            col + e < lw.N ? fmaxf(v[e] + __ldg(lw.b + col + e), 0.0f) : 0.0f;
    };
  };
  // u = t + (o @ Wo + bo), in t; t1 = LN1(u)
  dense(xs, px, lo, &lf1, ring, L.wbuf, tile, residual(lo));
  __syncthreads();
  layernorm(t, pc, C, p + d.off[kLn1G], p + d.off[kLn1B]);
  // u2 = t1 + relu(t1 @ F1 + f1) @ F2 + f2, in t; t2 = LN2(u2)
  dense(t, pc, lf1, &lf2, ring, L.wbuf, tile, hidden(lf1));
  dense(xs, px, lf2, &lfc, ring, L.wbuf, tile, residual(lf2));
  __syncthreads();
  layernorm(t, pc, C, p + d.off[kLn2G], p + d.off[kLn2B]);
  // y = relu(t2 @ Wfc + bfc) @ Wout + bout
  dense(t, pc, lfc, &lout, ring, L.wbuf, tile, hidden(lfc));
  dense(xs, px, lout, nullptr, ring, L.wbuf, tile,
        [&](int r, int col, float v0, float v1) {
          const float v[2] = {v0, v1};
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (r < rows && col + e < d.out)
              out[static_cast<size_t>(row0 + r) * d.out + col + e] =
                  v[e] + __ldg(lout.b + col + e);
        });
}

// The dynamic shared memory limit of a kernel, raised on the current device
// only when a launch needs more than it was last set to (once per kernel,
// size and device, not once per launch).
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

template <int D, int H>
int launch_attend(const float* x, const float* p, const float* gate,
                  const float* kv, float* out, const Dims& d, int grid,
                  size_t smem, cudaStream_t stream) {
  const int err = reserve_smem<attend_kernel<D, H>>(smem);
  if (err != 0) return err;
  attend_kernel<D, H><<<grid, kThreads, smem, stream>>>(x, p, gate, kv, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the head over n_images maps of T tokens on `stream` and returns 0, a
// CUDA error code, or -1 for a head outside the kernel's domain:
// num_heads in {1, 2, 4, 8}, key_dim in {8, 16, 32}, num_heads * key_dim
// <= 64, C <= 128, ff <= 256, hidden <= 256, out <= 8, 1 <= C / reduction.
//
//   x        (n_images * T, C) float32, device: the maps' tokens, row-major
//   params   the packed weights, device; offsets (host, 24 ints, each a
//            multiple of 4) give the start of each leaf in the order of enum
//            Leaf, each row-major: dense kernels (in, out), q/k/v (C, H*D),
//            attn_out (H*D, C); the matrices of q/k/v, attn_out, ff1, ff2,
//            fc and out zero-padded to (in rounded up to 8, out rounded up
//            to 32)
//   dims     (host, 7 ints) C, M (the gate's width), H, D, ff, hidden, out
//   gate     (n_images, C) float32, device scratch (T > 1; unused for T = 1)
//   kv       (n_images * T, 2 * H * D) float32, device scratch (likewise)
//   out      (n_images * T, out) float32, device
extern "C" int headpose_se_transformer(const float* x, const float* params,
                                       float* gate, float* kv, float* out,
                                       int n_images, int T, const int* dims,
                                       const int* offsets,
                                       cudaStream_t stream) {
  Dims d;
  d.C = dims[0];
  d.M = dims[1];
  d.H = dims[2];
  d.D = dims[3];
  d.HD = d.H * d.D;
  d.F = dims[4];
  d.hidden = dims[5];
  d.out = dims[6];
  d.T = T;
  for (int i = 0; i < kLeaves; ++i) d.off[i] = offsets[i];
  const bool heads_ok = d.H == 1 || d.H == 2 || d.H == 4 || d.H == 8;
  const bool dim_ok = d.D == 8 || d.D == 16 || d.D == 32;
  if (!heads_ok || !dim_ok || d.HD > kMaxHD || d.C < 1 || d.C > kMaxC ||
      d.M < 1 || d.F < 1 || d.F > kMaxFF || d.hidden < 1 ||
      d.hidden > kMaxHidden || d.out < 1 || d.out > kMaxOut || T < 1 ||
      n_images < 0 || static_cast<long long>(n_images) * T > (1 << 30))
    return kErrUnsupported;
  d.n_rows = n_images * T;
  if (d.n_rows == 0) return 0;
  const int grid = (d.n_rows + kRows - 1) / kRows;
  const size_t smem1 = sizeof(float) * layout(d, false).total;
  const size_t smem2 = sizeof(float) * layout(d, true).total;
  if (smem1 > static_cast<size_t>(kSmemMax) ||
      smem2 > static_cast<size_t>(kSmemMax))
    return kErrUnsupported;

  if (T > 1) {
    const size_t smem0 = sizeof(float) *
        (static_cast<size_t>(imax(1, kThreads / d.C) + 1) * d.C + d.M);
    gate_kernel<<<n_images, kThreads, smem0, stream>>>(x, params, gate, d);
    int err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
    err = reserve_smem<kv_kernel>(smem1);
    if (err != 0) return err;
    kv_kernel<<<grid, kThreads, smem1, stream>>>(x, params, gate, kv, d);
    err = static_cast<int>(cudaGetLastError());
    if (err != 0) return err;
  }
  switch (d.D * 16 + d.H) {
#define HEADPOSE_ATTEND(D_, H_) \
  case D_ * 16 + H_:            \
    return launch_attend<D_, H_>(x, params, gate, kv, out, d, grid, smem2, stream);
    HEADPOSE_ATTEND(8, 1)
    HEADPOSE_ATTEND(8, 2)
    HEADPOSE_ATTEND(8, 4)
    HEADPOSE_ATTEND(8, 8)
    HEADPOSE_ATTEND(16, 1)
    HEADPOSE_ATTEND(16, 2)
    HEADPOSE_ATTEND(16, 4)
    HEADPOSE_ATTEND(32, 1)
    HEADPOSE_ATTEND(32, 2)
#undef HEADPOSE_ATTEND
    default:
      return kErrUnsupported;
  }
}
