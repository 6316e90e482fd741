// The SE-Transformer pose head for NVIDIA Hopper (sm_90a): squeeze-and-
// excitation gate, multi-head self-attention over each image's tokens,
// residual + LayerNorm, FFN, residual + LayerNorm, ReLU 1x1 and the output
// 1x1, for a batch of (B, H, W, C) maps, fp32 on the CUDA cores.
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
// (x - mu)^2 (Keras).  A (N, C) row is a 1x1 map: T = 1.
//
// What bounds it on this card: operations.  At the flagship's maps (16x16
// tokens of 88 channels, 8x8 of 96; 4 heads of 16, ff 64, hidden 128) the
// two heads are 47.4 MFLOP per 128x128 frame, 6.07 GFLOP at B=128: 0.091 ms
// at 67 TFLOP/s fp32; they read 14.7 MB of maps (0.0044 ms at 3.35 TB/s).
//
// Design.  The TPU kernel holds one image's tokens, Q, K, V and each head's
// T x T scores in VMEM.  Here that is 90 KB of tokens, 192 KB of Q/K/V and
// 256 KB per head of scores at T = 256: more than a CTA's 227 KB.  So:
//   * rows are tiled by 32 (an image of 256 tokens spans 8 CTAs; a tile of
//     1x1 maps holds 32 images), and every row attends only to the tokens
//     of its own image;
//   * launch 1 (gate_kv) computes, per tile, the SE gate of each image the
//     tile touches (the token mean over the whole image, read again by each
//     of the image's tiles from L2: recomputing it costs less than a third
//     launch), writes the gate of each image whose first row it holds, and
//     writes K and V of its rows into a scratch buffer the wrapper
//     allocates (K and V of every token are needed by every tile of the
//     image; recomputing them per query tile would do 8x the QKV work);
//   * launch 2 (attend) reads the gates, computes t and Q for its rows,
//     streams its image's K/V through shared memory in chunks of 64 keys
//     with an online softmax (a running max and sum per row and head), so
//     no T x T matrix exists; each (row, head) is split over 256 / (32 H)
//     threads that take alternate keys and merge their partial softmax
//     states with warp shuffles.  A chunk is laid out so that the 8 threads
//     of a quarter-warp (one row: every head, every key offset) read 8
//     different 16-byte bank groups: each head's slice padded from D to
//     D + 4 floats, each key's row padded to a pitch P with P / 4 = H Q
//     mod 8, Q = (D + 4) / 4 odd (`kv_pitch`): without the padding, heads
//     h and h + 2 and neighbouring keys share banks, a 4-way conflict on
//     every load of the loop.  Then the output projection, both
//     LayerNorms (one warp per row, shuffle reductions in which the lanes
//     past C add nothing: 88 and 96 are not multiples of 32), the FFN and
//     the two 1x1s, all in shared memory; only the (rows, out) result is
//     written.
// Dense products take one output column for 8 rows per thread, weights
// read through L1/L2 (__ldg), rows from shared memory.  FMA contraction is
// allowed (the wrapper's plain version is matched within a tolerance); no
// fast math: expf, sqrtf and division are IEEE.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;               // rows (tokens) per CTA
constexpr int kRowTile = 8;             // rows per thread in a dense product
constexpr int kGroups = kRows / kRowTile;
constexpr int kKeys = 64;               // keys per K/V chunk in shared memory
constexpr int kSplit = 8;               // partial sums per channel of a mean
constexpr int kMaxC = 128;
constexpr int kMaxHD = 64;
constexpr int kMaxFF = 256;
constexpr int kMaxHidden = 256;
constexpr int kMaxOut = 8;
constexpr int kSmemMax = 232448;        // a block's limit on sm_90
constexpr int kErrUnsupported = -1;
constexpr float kEps = 1e-3f;

__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

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

enum Act : int { kLinear = 0, kRelu = 1 };

// floats per key in a K/V chunk: K then V, each head's D floats padded to
// D + 4; (pitch / 4) = H (D + 4) / 4 (mod 8), see the design note above
__host__ __device__ inline int kv_pitch(int H, int D) {
  const int q = (D + 4) / 4;                  // odd for D in {8, 16, 32}
  const int p = 2 * H * q;
  return 4 * (p + ((H * q - p) % 8 + 8) % 8);
}

// out[r][j] = act(b[j] + sum_k in[r][k] w[k][j]) (+ res[r][j]) for the
// tile's 32 rows and N columns; in, out and res in shared memory.
__device__ void dense(const float* in, int in_pitch, int K,
                      const float* __restrict__ w, const float* __restrict__ b,
                      int N, float* out, int out_pitch, int act,
                      const float* res = nullptr, int res_pitch = 0) {
  for (int item = threadIdx.x; item < kGroups * N; item += kThreads) {
    const int j = item % N, g = item / N;
    const float* hg = in + g * kRowTile * in_pitch;
    float acc[kRowTile];
#pragma unroll
    for (int q = 0; q < kRowTile; ++q) acc[q] = 0.0f;
    for (int k = 0; k < K; ++k) {
      const float wv = __ldg(w + static_cast<size_t>(k) * N + j);
#pragma unroll
      for (int q = 0; q < kRowTile; ++q)
        acc[q] = fmaf(hg[q * in_pitch + k], wv, acc[q]);
    }
    const float bj = __ldg(b + j);
#pragma unroll
    for (int q = 0; q < kRowTile; ++q) {
      const int r = g * kRowTile + q;
      float v = acc[q] + bj;
      if (act == kRelu) v = fmaxf(v, 0.0f);
      if (res != nullptr) v = res[r * res_pitch + j] + v;
      out[r * out_pitch + j] = v;
    }
  }
}

// In place, each of the 32 rows of x (pitch C): LayerNorm with gain g and
// offset b.  One warp per row; lanes hold channels lane, lane + 32, ...
__device__ void layernorm(float* x, int C, const float* __restrict__ g,
                          const float* __restrict__ b) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float* row = x + r * C;
    float sum = 0.0f;
    for (int c = lane; c < C; c += 32) sum += row[c];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mu = sum / static_cast<float>(C);
    float sq = 0.0f;
    for (int c = lane; c < C; c += 32) {
      const float d = row[c] - mu;
      sq += d * d;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float rstd = 1.0f / sqrtf(sq / static_cast<float>(C) + kEps);
    for (int c = lane; c < C; c += 32)
      row[c] = (row[c] - mu) * rstd * __ldg(g + c) + __ldg(b + c);
  }
}

// Launch 1: the SE gate of each image the tile touches, and K, V of its rows.
//   x (n_rows, C); gate (n_images, C); kv (n_rows, 2 HD): [K | V]
__global__ void __launch_bounds__(kThreads)
gate_kv_kernel(const float* __restrict__ x, const float* __restrict__ p,
               float* __restrict__ gate, float* __restrict__ kv, Dims d) {
  extern __shared__ float smem[];
  const int C = d.C, T = d.T, HD = d.HD;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n_rows - row0);
  const int img0 = row0 / T;
  const int n_img = (row0 + rows - 1) / T - img0 + 1;
  const int split = T >= kSplit ? kSplit : 1;
  float* t = smem;                                   // kRows x C
  float* part = t + kRows * C;                       // n_img x split x C
  float* s = part + (kRows + kSplit) * C;            // n_img x C: mean, gate
  float* mid = s + kRows * C;                        // n_img x M

  // the token mean of each image: `split` partial sums per channel
  for (int item = threadIdx.x; item < n_img * split * C; item += kThreads) {
    const int c = item % C, q = (item / C) % split, i = item / (C * split);
    const float* xi = x + static_cast<size_t>(img0 + i) * T * C + c;
    float acc = 0.0f;
    for (int tok = q; tok < T; tok += split)
      acc += xi[static_cast<size_t>(tok) * C];
    part[item] = acc;
  }
  __syncthreads();
  for (int item = threadIdx.x; item < n_img * C; item += kThreads) {
    const int c = item % C, i = item / C;
    float acc = 0.0f;
    for (int q = 0; q < split; ++q) acc += part[(i * split + q) * C + c];
    s[item] = acc / static_cast<float>(T);
  }
  __syncthreads();
  for (int item = threadIdx.x; item < n_img * d.M; item += kThreads) {
    const int m = item % d.M, i = item / d.M;
    const float* w = p + d.off[kSe1W];
    float acc = __ldg(p + d.off[kSe1B] + m);
    for (int c = 0; c < C; ++c)
      acc = fmaf(s[i * C + c], __ldg(w + c * d.M + m), acc);
    mid[item] = fmaxf(acc, 0.0f);
  }
  __syncthreads();
  for (int item = threadIdx.x; item < n_img * C; item += kThreads) {
    const int c = item % C, i = item / C;
    const float* w = p + d.off[kSe2W];
    float acc = __ldg(p + d.off[kSe2B] + c);
    for (int m = 0; m < d.M; ++m)
      acc = fmaf(mid[i * d.M + m], __ldg(w + m * C + c), acc);
    const float g = 1.0f / (1.0f + expf(-acc));
    s[item] = g;                       // the mean is no longer read
    const int img = img0 + i;
    if (img * T >= row0)               // this tile holds the image's first row
      gate[static_cast<size_t>(img) * C + c] = g;
  }
  __syncthreads();

  // t = x * gate; rows past the end are zero and never written out
  const float* xt = x + static_cast<size_t>(row0) * C;
  for (int item = threadIdx.x; item < kRows * C; item += kThreads) {
    const int r = item / C, c = item % C;
    t[item] = r < rows ? xt[item] * s[((row0 + r) / T - img0) * C + c] : 0.0f;
  }
  __syncthreads();

  // K and V, straight to device memory
  for (int item = threadIdx.x; item < kGroups * 2 * HD; item += kThreads) {
    const int j = item % (2 * HD), g = item / (2 * HD);
    const bool is_v = j >= HD;
    const int col = is_v ? j - HD : j;
    const float* w = p + d.off[is_v ? kVW : kKW];
    const float* tg = t + g * kRowTile * C;
    float acc[kRowTile];
#pragma unroll
    for (int q = 0; q < kRowTile; ++q) acc[q] = 0.0f;
    for (int k = 0; k < C; ++k) {
      const float wv = __ldg(w + k * HD + col);
#pragma unroll
      for (int q = 0; q < kRowTile; ++q) acc[q] = fmaf(tg[q * C + k], wv, acc[q]);
    }
    const float bj = __ldg(p + d.off[is_v ? kVB : kKB] + col);
#pragma unroll
    for (int q = 0; q < kRowTile; ++q) {
      const int r = g * kRowTile + q;
      if (r < rows) kv[static_cast<size_t>(row0 + r) * 2 * HD + j] = acc[q] + bj;
    }
  }
}

// Launch 2: t and Q of the tile's rows, attention over each row's image,
// then the block's tail and the head's two 1x1s.  out (n_rows, out).
template <int D>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const float* __restrict__ x, const float* __restrict__ p,
              const float* __restrict__ gate, const float* __restrict__ kv,
              float* __restrict__ out, Dims d) {
  extern __shared__ float smem[];
  const int C = d.C, T = d.T, H = d.H, HD = d.HD;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, d.n_rows - row0);
  const int img0 = row0 / T;
  const int n_img = (row0 + rows - 1) / T - img0 + 1;
  float* g = smem;                                   // kRows x C: gates, u2
  float* t = g + kRows * C;                          // kRows x C
  float* u = t + kRows * C;                          // kRows x C: u, t1
  float* q = u + kRows * C;                          // kRows x HD
  float* o = q + kRows * HD;                         // kRows x HD
  const int pitch = kv_pitch(H, D);
  float* kvs = o + kRows * HD;                       // kKeys x pitch
  float* fh = kvs + kKeys * pitch;                   // kRows x max(F, hid)
  float* y = fh + kRows * imax(d.F, d.hidden);        // kRows x out

  for (int item = threadIdx.x; item < n_img * C; item += kThreads)
    g[item] = gate[static_cast<size_t>(img0) * C + item];
  __syncthreads();
  const float* xt = x + static_cast<size_t>(row0) * C;
  for (int item = threadIdx.x; item < kRows * C; item += kThreads) {
    const int r = item / C, c = item % C;
    t[item] = r < rows ? xt[item] * g[((row0 + r) / T - img0) * C + c] : 0.0f;
  }
  __syncthreads();
  dense(t, C, C, p + d.off[kQW], p + d.off[kQB], HD, q, HD, kLinear);
  __syncthreads();

  // attention: (row, head) pairs, `lanes` consecutive threads each
  const int lanes = kThreads / (kRows * H);
  const int pair = threadIdx.x / lanes, sub = threadIdx.x % lanes;
  const int r = pair / H, h = pair % H;
  const bool live = r < rows;
  const int img = live ? (row0 + r) / T : img0;
  const int lo = img * T, hi = lo + T;            // this row's keys
  const float inv_scale = 1.0f / sqrtf(static_cast<float>(D));
  float qr[D], acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = q[r * HD + h * D + i];
    acc[i] = 0.0f;
  }
  float m = -INFINITY, l = 0.0f;
  const int k_begin = img0 * T, k_end = (img0 + n_img) * T;
  for (int c0 = k_begin; c0 < k_end; c0 += kKeys) {
    const int n = min(kKeys, k_end - c0);
    __syncthreads();
    for (int item = threadIdx.x; item < n * 2 * HD; item += kThreads) {
      const int key = item / (2 * HD), col = item % (2 * HD);
      kvs[key * pitch + (col / D) * (D + 4) + col % D] =
          kv[static_cast<size_t>(c0) * 2 * HD + item];
    }
    __syncthreads();
    if (!live) continue;
    for (int j = sub; j < n; j += lanes) {
      const int key = c0 + j;
      if (key < lo || key >= hi) continue;
      const float4* kj = reinterpret_cast<const float4*>(
          kvs + j * pitch + h * (D + 4));
      float sc = 0.0f;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 k4 = kj[i];
        sc = fmaf(qr[4 * i], k4.x, sc);
        sc = fmaf(qr[4 * i + 1], k4.y, sc);
        sc = fmaf(qr[4 * i + 2], k4.z, sc);
        sc = fmaf(qr[4 * i + 3], k4.w, sc);
      }
      sc *= inv_scale;
      if (sc > m) {                        // rescale what was summed so far
        const float a = expf(m - sc);      // 0 while nothing was summed
        l *= a;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] *= a;
        m = sc;
      }
      const float e = expf(sc - m);
      l += e;
      const float4* vj = kj + H * (D + 4) / 4;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) {
        const float4 v4 = vj[i];
        acc[4 * i] = fmaf(e, v4.x, acc[4 * i]);
        acc[4 * i + 1] = fmaf(e, v4.y, acc[4 * i + 1]);
        acc[4 * i + 2] = fmaf(e, v4.z, acc[4 * i + 2]);
        acc[4 * i + 3] = fmaf(e, v4.w, acc[4 * i + 3]);
      }
    }
  }
  // merge the partial softmax states of a pair's lanes (consecutive lanes
  // of one warp: lanes is 1, 2, 4 or 8)
  for (int w = lanes / 2; w > 0; w >>= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, w);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, w);
    const float mm = fmaxf(m, m2);
    const float a = m == -INFINITY ? 0.0f : expf(m - mm);
    const float b = m2 == -INFINITY ? 0.0f : expf(m2 - mm);
    l = l * a + l2 * b;
#pragma unroll
    for (int i = 0; i < D; ++i) {
      const float acc2 = __shfl_xor_sync(0xffffffffu, acc[i], w);
      acc[i] = acc[i] * a + acc2 * b;
    }
    m = mm;
  }
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < D; ++i)
      o[r * HD + h * D + i] = l > 0.0f ? acc[i] / l : 0.0f;
  }
  __syncthreads();

  // u = t + (o @ Wo + bo); t1 = LN1(u)
  dense(o, HD, HD, p + d.off[kOW], p + d.off[kOB], C, u, C, kLinear, t, C);
  __syncthreads();
  layernorm(u, C, p + d.off[kLn1G], p + d.off[kLn1B]);
  __syncthreads();
  // u2 = t1 + relu(t1 @ F1 + f1) @ F2 + f2; t2 = LN2(u2), in g
  dense(u, C, C, p + d.off[kF1W], p + d.off[kF1B], d.F, fh, d.F, kRelu);
  __syncthreads();
  dense(fh, d.F, d.F, p + d.off[kF2W], p + d.off[kF2B], C, g, C, kLinear,
        u, C);
  __syncthreads();
  layernorm(g, C, p + d.off[kLn2G], p + d.off[kLn2B]);
  __syncthreads();
  // y = relu(t2 @ Wfc + bfc) @ Wout + bout
  dense(g, C, C, p + d.off[kFcW], p + d.off[kFcB], d.hidden, fh, d.hidden,
        kRelu);
  __syncthreads();
  dense(fh, d.hidden, d.hidden, p + d.off[kOutW], p + d.off[kOutB], d.out, y,
        d.out, kLinear);
  __syncthreads();
  for (int item = threadIdx.x; item < rows * d.out; item += kThreads)
    out[static_cast<size_t>(row0) * d.out + item] = y[item];
}

template <int D>
int launch_attend(const float* x, const float* p, const float* gate,
                  const float* kv, float* out, const Dims& d, int grid,
                  size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attend_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  attend_kernel<D><<<grid, kThreads, smem, stream>>>(x, p, gate, kv, out, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the head over n_images maps of T tokens on `stream` and returns 0, a
// CUDA error code, or -1 for a head outside the kernel's domain:
// num_heads in {1, 2, 4, 8}, key_dim in {8, 16, 32}, num_heads * key_dim
// <= 64, C <= 128, ff <= 256, hidden <= 256, out <= 8, 1 <= C / reduction.
//
//   x        (n_images * T, C) float32, device: the maps' tokens, row-major
//   params   the packed weights, device; offsets (host, 24 ints) give the
//            start of each leaf in the order of enum Leaf, each row-major:
//            dense kernels (in, out), q/k/v (C, H*D), attn_out (H*D, C)
//   dims     (host, 7 ints) C, M (the gate's width), H, D, ff, hidden, out
//   gate     (n_images, C) float32, device scratch
//   kv       (n_images * T, 2 * H * D) float32, device scratch
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

  const size_t smem1 = sizeof(float) *
      (static_cast<size_t>(kRows + kRows + kSplit + kRows) * d.C +
       static_cast<size_t>(kRows) * d.M);
  const size_t smem2 = sizeof(float) *
      (3 * static_cast<size_t>(kRows) * d.C + 2 * kRows * d.HD +
       kKeys * kv_pitch(d.H, d.D) + kRows * imax(d.F, d.hidden) +
       kRows * d.out);
  if (smem1 > static_cast<size_t>(kSmemMax) ||
      smem2 > static_cast<size_t>(kSmemMax))
    return kErrUnsupported;

  cudaError_t err = cudaFuncSetAttribute(
      gate_kv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem1));
  if (err != cudaSuccess) return static_cast<int>(err);
  gate_kv_kernel<<<grid, kThreads, smem1, stream>>>(x, params, gate, kv, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (d.D) {
    case 8: return launch_attend<8>(x, params, gate, kv, out, d, grid, smem2, stream);
    case 16: return launch_attend<16>(x, params, gate, kv, out, d, grid, smem2, stream);
    default: return launch_attend<32>(x, params, gate, kv, out, d, grid, smem2, stream);
  }
}
