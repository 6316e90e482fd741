// Fused MLP pose head for NVIDIA Hopper (sm_90a): every dense layer and
// Keras activation of an MLPHead over a tile of feature rows, in one launch.
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/head_mlp.py::
// mlp_head_forward (_kernel).  The plain PyTorch version is
// headpose_tpu_torch/ops/kernels/head_mlp.py::mlp_head_forward_plain, the
// wrapper mlp_head_forward.
//
// Semantics: h_0 = x (N, C); h_{l+1} = act_l(h_l @ W_l + b_l); the output is
// the last h, (N, out).  Activations follow Keras (core/activations.py):
// leaky_relu alpha 0.2, exact-erf gelu, selu's constants, softplus as
// PyTorch computes it (x above 20 passes through).
//
// Precision: fp32 on the CUDA cores.  Each output is one fmaf chain over k
// in order from 0, then + bias, then the activation: the order of a plain
// fp32 product.  3-pass TF32 on the tensor cores (the design of
// csrc/se_attention.cu) misses this head's rtol = atol = 1e-5 against the
// plain version: emulated on the CPU in the kernel's own accumulation
// order it lies up to 1.39x the tolerance away on unified-best-distilled's
// head96 over tests/golden/heads.npz's cells, where each of the two alone
// is about 0.7x from float64 (tests/test_torch_head_mlp.py).
//
// What bounds it on this card: operations.  At B=128 the flagship's heads
// (256 rows of 88 -> 64 -> 3, 64 rows of 96 -> 32 -> 16 -> 3 per frame) are
// 0.45 GFLOP, 0.0067 ms at 67 TFLOP/s fp32; unified-best-distilled's
// (88 -> 256 -> 128 -> 3 and 96 -> 256 -> 128 -> 3, tanh) 4.63 GFLOP,
// 0.069 ms.  The rows they read, 15.2 MB, take 0.0045 ms at 3.35 TB/s.
//
// Design.  One CTA of 256 threads per tile of R rows (64; 32 or 16 where
// the widest layers need the room).  The tile's rows are loaded once
// (16-byte loads where the rows allow) and every hidden layer stays in
// shared memory, in two buffers that the layers alternate between, stored
// k-major (feature k of the tile's rows is R consecutive floats, their
// groups of 4 XOR-swizzled by k so that an epilogue's column stores spread
// over the banks).  A layer's weights, packed (K, N rounded up to 4) with
// zero columns, are staged by 16-byte cp.async into two buffers of 2,048
// floats, a tile of a pass's columns and as many multiples of 16 rows as
// fit (16 rows of a 128-column pass, all 128 of a 3-wide last layer): the
// next tile (of this pass, the next or the next layer's) loads while this
// one is multiplied.  A layer goes in passes over its columns: wide ones
// of 128 while 128 remain, where a thread sums R / 16 rows x 8 columns,
// then narrow ones of up to 64, where it sums TM rows x 4 columns (TM 1, 2
// or 4: the fewest rows that fit the pass into 256 threads).  A warp of a
// 16 x 16 thread grid takes 4 row groups x 8 column groups, so that per k
// its loads touch 4 row vectors and 8 column vectors (one bank wavefront
// each).  Each k is one vector load of the rows, one or two of the columns
// and TM x TN fmaf into registers: at most 128 a thread, two CTAs an SM
// (unified-best-distilled's widths take 112 KB of shared memory a CTA;
// kernel_phases head measures narrow passes only, and a cap of 64
// registers for four CTAs an SM).  Sum + bias goes to the other shared
// buffer for a hidden layer (all its padded columns: the next layer reads
// only its K real rows), to device memory for the last (its columns below
// N, rows below the tile's end); then one loop over them applies the
// activation in place, instantiated per activation, four values a thread
// at a time.
// FMA contraction is allowed (the wrapper's plain version is matched within
// a tolerance, not bit for bit); no fast math.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWide = 128;                // columns of a wide pass
constexpr int kNarrow = 64;               // columns of a narrow pass, at most
constexpr int kStep = 16;                 // k per unrolled step of a pass
constexpr int kTileFloats = 2048;         // a staging buffer
constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 896;
constexpr int kMaxDevices = 64;
constexpr int kSmemMax = 232448;          // a block's limit on sm_90
constexpr int kErrUnsupported = -1;

// The numbers of core/activations.py::ACTIVATION_IDS.
enum Activation : int {
  kLinear = 0,
  kRelu = 1,
  kTanh = 2,
  kSigmoid = 3,
  kSoftsign = 4,
  kElu = 5,
  kSelu = 6,
  kSoftplus = 7,
  kSwish = 8,
  kLeakyRelu = 9,
  kGelu = 10,
};

struct Layers {
  int n;                    // number of dense layers
  int in_dim;               // C
  int out[kMaxLayers];      // each layer's width N
  int act[kMaxLayers];      // each layer's Activation
  int w_off[kMaxLayers];    // each layer's (K, round4(N)) weights, in floats
  int b_off[kMaxLayers];    // each layer's round4(N) bias, in floats
};

__host__ __device__ constexpr int round4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ int kdim(const Layers& L, int l) {
  return l == 0 ? L.in_dim : L.out[l - 1];
}

// Element (k, r) of a k-major activation buffer of R rows: the groups of 4
// rows permuted by k
template <int R>
__device__ __forceinline__ int at(int k, int r) {
  return k * R + ((((r >> 2) ^ k) & (R / 4 - 1)) << 2) + (r & 3);
}

template <int A>
__device__ __forceinline__ float activate(float x) {
  switch (A) {
    case kRelu: return fmaxf(x, 0.0f);
    case kTanh: return tanhf(x);
    case kSigmoid: return 1.0f / (1.0f + expf(-x));
    case kSoftsign: return x / (1.0f + fabsf(x));
    case kElu: return x > 0.0f ? x : expm1f(x);
    case kSelu:
      return 1.0507009873554804934193349852946f *
             (x > 0.0f ? x : 1.6732632423543772848170429916717f * expm1f(x));
    case kSoftplus: return x > 20.0f ? x : log1pf(expf(x));
    case kSwish: return x / (1.0f + expf(-x));
    case kLeakyRelu: return x > 0.0f ? x : 0.2f * x;
    case kGelu: return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));
    default: return x;      // kLinear
  }
}

// ---------------------------------------------------------------- cp.async
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// A layer's columns (round4(N) of them) go in passes: wide ones of 128
// while 128 remain, then narrow ones of up to 64.  Pass p's first column
// and width:
__device__ __forceinline__ void pass_span(int np, int p, int& n0, int& width) {
  const int wide = np / kWide;
  n0 = p < wide ? p * kWide : wide * kWide + (p - wide) * kNarrow;
  width = p < wide ? kWide : min(kNarrow, np - n0);
}

// The weight rows a staged tile of a pass of `width` columns holds: as many
// multiples of 16 as fill a buffer (16 for a wide pass, 32 for a 64-column
// one, the whole K of a 3-wide last layer)
__device__ __forceinline__ int chunk_rows(int width) {
  return (kTileFloats / width) & ~(kStep - 1);
}

// A staged weight tile: layer l, pass p, k chunk c (rows c chunk_rows ..).
// The tiles of a head are taken in the order (l, p, c).
struct Tile {
  int l, p, c;
};

__device__ __forceinline__ bool advance(const Layers& L, Tile& t) {
  const int np = round4(L.out[t.l]);
  int n0, width;
  pass_span(np, t.p, n0, width);
  if (++t.c * chunk_rows(width) < kdim(L, t.l)) return true;
  t.c = 0;
  if (n0 + width < np) {
    ++t.p;
    return true;
  }
  t.p = 0;
  return ++t.l < L.n;
}

// tile t's rows x columns of the layer's packed weights into dst (pitch:
// the pass's width), by 16-byte copies
__device__ void stage_weights(float* dst, const float* __restrict__ params,
                              const Layers& L, const Tile& t) {
  const int K = kdim(L, t.l), np = round4(L.out[t.l]);
  int n0, width;
  pass_span(np, t.p, n0, width);
  const int kc = chunk_rows(width), k0 = t.c * kc;
  const int q = width >> 2;                          // 16-byte pieces a row
  const int rows = min(kc, K - k0);
  const float* w = params + L.w_off[t.l] + static_cast<size_t>(k0) * np + n0;
  if ((q & (q - 1)) == 0) {                          // no divide
    const int s = __ffs(q) - 1;
    for (int i = threadIdx.x; i < rows * q; i += kThreads) {
      const int k = i >> s, f = (i & (q - 1)) << 2;
      cp_async16(dst + k * width + f, w + static_cast<size_t>(k) * np + f);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * q; i += kThreads) {
    const int k = i / q, f = (i - k * q) << 2;
    cp_async16(dst + k * width + f, w + static_cast<size_t>(k) * np + f);
  }
}

// rows row0 .. row0 + rows - 1 of x (n, C) into the k-major buffer dst;
// zeros in the rows past `rows`
template <int R>
__device__ void stage_rows(float* dst, const float* __restrict__ x, int row0,
                           int rows, int C) {
  const float* xt = x + static_cast<size_t>(row0) * C;
  if ((C & 3) == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0) {
    constexpr int kBatch = 4;                        // loads in flight
    const int total = R * (C >> 2);
    for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * kThreads) {
      float4 v[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads, r = i & (R - 1);
        v[b] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (i < total && r < rows)
          v[b] = __ldg(reinterpret_cast<const float4*>(
                           xt + static_cast<size_t>(r) * C) + i / R);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * kThreads, r = i & (R - 1), k = 4 * (i / R);
        if (i < total) {
          dst[at<R>(k, r)] = v[b].x;
          dst[at<R>(k + 1, r)] = v[b].y;
          dst[at<R>(k + 2, r)] = v[b].z;
          dst[at<R>(k + 3, r)] = v[b].w;
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * C; i += kThreads) {
      const int r = i & (R - 1), k = i / R;
      dst[at<R>(k, r)] =
          r < rows ? __ldg(xt + static_cast<size_t>(r) * C + k) : 0.0f;
    }
  }
}

template <int TM>
struct Vec;
template <>
struct Vec<4> { using T = float4; };
template <>
struct Vec<2> { using T = float2; };
template <>
struct Vec<1> { using T = float; };

// rows r0 .. r0 + TM - 1 at feature k (one vector load)
template <int R, int TM>
__device__ __forceinline__ void load_rows(const float* buf, int k, int r0,
                                          float (&a)[TM]) {
  const auto v = *reinterpret_cast<const typename Vec<TM>::T*>(buf + at<R>(k, r0));
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < TM; ++i) a[i] = f[i];
}

template <int R, int TM>
__device__ __forceinline__ void store_rows(float* buf, int k, int r0,
                                           const float (&a)[TM]) {
  typename Vec<TM>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < TM; ++i) f[i] = a[i];
  *reinterpret_cast<typename Vec<TM>::T*>(buf + at<R>(k, r0)) = v;
}

// One pass of layer l: its `width` columns from n0 for the tile's R rows,
// the weights streamed through the two staging buffers (tile t in
// wbuf[slot] is already in flight; each chunk starts the next tile).  A
// thread sums TM rows x TN columns: TN = 8 in a wide pass (columns 4 g ..
// 4 g + 3 and 64 + 4 g .. 64 + 4 g + 3 of the pass), else 4.  Where a pass
// has 16 row groups and 16 column groups, a warp takes 4 x 8 of them, so
// that its loads of a k touch 4 row vectors and 8 column vectors.  Hidden layers write sum +
// bias into nxt; the last (nxt == nullptr) writes its columns below N for
// the rows below `rows` into out.  The activation follows, once the
// layer's passes are done (activate_layer).
template <int R, int TM, int TN>
__device__ void run_pass(const float* __restrict__ params, const Layers& L,
                         int l, int n0, int width, const float* in, float* nxt,
                         float* __restrict__ out, int row0, int rows,
                         float* wbuf, Tile& t, int& slot) {
  const int K = kdim(L, l), N = L.out[l];
  const int groups = TN == 8 ? 16 : width >> 2;      // of 4 columns
  int g, rg;
  if (groups == 16 && R / TM == 16) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    rg = (warp >> 1) * 4 + (lane >> 3);
    g = (warp & 1) * 8 + (lane & 7);
  } else {
    g = threadIdx.x % groups;
    rg = threadIdx.x / groups;
  }
  const bool active = rg < R / TM;
  const int r0 = rg * TM;
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  // acc += rows r0.. at feature k times the thread's columns of tile row kk
  auto step = [&](const float* w, int k, int kk) {
    float4 wv[TN / 4];
#pragma unroll
    for (int h = 0; h < TN / 4; ++h)
      wv[h] = *reinterpret_cast<const float4*>(w + kk * width + 64 * h);
    float a[TM];
    load_rows<R, TM>(in, k, r0, a);
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        acc[i][4 * h] = fmaf(a[i], wv[h].x, acc[i][4 * h]);
        acc[i][4 * h + 1] = fmaf(a[i], wv[h].y, acc[i][4 * h + 1]);
        acc[i][4 * h + 2] = fmaf(a[i], wv[h].z, acc[i][4 * h + 2]);
        acc[i][4 * h + 3] = fmaf(a[i], wv[h].w, acc[i][4 * h + 3]);
      }
  };

  const int kc = chunk_rows(width);
  const int chunks = (K + kc - 1) / kc;
  for (int c = 0; c < chunks; ++c) {
    cp_async_wait_all();
    __syncthreads();
    Tile next = t;
    if (advance(L, next)) stage_weights(wbuf + (slot ^ 1) * kTileFloats,
                                        params, L, next);
    cp_async_commit();
    if (active) {
      const float* w = wbuf + slot * kTileFloats + 4 * g;
      const int k0 = c * kc, kn = min(kc, K - k0);
      for (int kb = 0; kb < kn; kb += kStep) {
        if (kb + kStep <= kn) {
#pragma unroll
          for (int kk = kb; kk < kb + kStep; ++kk) step(w, k0 + kk, kk);
        } else {
          for (int kk = kb; kk < kn; ++kk) step(w, k0 + kk, kk);
        }
      }
    }
    t = next;
    slot ^= 1;
  }
  if (!active) return;
  const float* bias = params + L.b_off[l];
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + 4 * g + (j & 3) + 64 * (j >> 2);
    const float b = __ldg(bias + col);
    float v[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) v[i] = acc[i][j] + b;
    if (nxt != nullptr) {
      store_rows<R, TM>(nxt, col, r0, v);
    } else if (col < N) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (r0 + i < rows)
          out[static_cast<size_t>(row0 + r0 + i) * N + col] = v[i];
    }
  }
}

// activation A over v[0 .. n), in place: four values a thread at a time
// (one float4 where v holds whole, aligned groups of 4), so that four
// evaluations are in flight
template <int A>
__device__ void activate_all(float* v, int n, bool vec) {
  if (vec) {
    float4* v4 = reinterpret_cast<float4*>(v);
    for (int i = threadIdx.x; i < n / 4; i += kThreads) {
      float4 a = v4[i];
      a.x = activate<A>(a.x);
      a.y = activate<A>(a.y);
      a.z = activate<A>(a.z);
      a.w = activate<A>(a.w);
      v4[i] = a;
    }
    return;
  }
  for (int i0 = threadIdx.x; i0 < n; i0 += 4 * kThreads) {
    float a[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + b * kThreads;
      a[b] = i < n ? v[i] : 0.0f;
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int i = i0 + b * kThreads;
      if (i < n) v[i] = activate<A>(a[b]);
    }
  }
}

// Layer l's activation, in place, once its passes have written their sums:
// over its buffer (R rows x round4(N) columns, padded ones included) for a
// hidden layer, else over the tile's rows of out.  One loop a layer, not
// code in every unrolled pass.
template <int R>
__device__ void activate_layer(const Layers& L, int l, float* nxt,
                               float* __restrict__ out, int row0, int rows) {
  const int act = L.act[l];
  if (act == kLinear) return;
  __syncthreads();
  float* v = nxt;
  int n = R * round4(L.out[l]);
  if (nxt == nullptr) {
    v = out + static_cast<size_t>(row0) * L.out[l];
    n = rows * L.out[l];
  }
  const bool vec = nxt != nullptr;
  switch (act) {
    case kRelu: return activate_all<kRelu>(v, n, vec);
    case kTanh: return activate_all<kTanh>(v, n, vec);
    case kSigmoid: return activate_all<kSigmoid>(v, n, vec);
    case kSoftsign: return activate_all<kSoftsign>(v, n, vec);
    case kElu: return activate_all<kElu>(v, n, vec);
    case kSelu: return activate_all<kSelu>(v, n, vec);
    case kSoftplus: return activate_all<kSoftplus>(v, n, vec);
    case kSwish: return activate_all<kSwish>(v, n, vec);
    case kLeakyRelu: return activate_all<kLeakyRelu>(v, n, vec);
    case kGelu: return activate_all<kGelu>(v, n, vec);
    default: return;
  }
}

// buf1 (floats) is where the second activation buffer starts after the first
template <int R>
__global__ void __launch_bounds__(kThreads, 2)
mlp_head_kernel(const float* __restrict__ x,       // (n_rows, C)
                const float* __restrict__ params,  // packed weights
                float* __restrict__ out,           // (n_rows, out[n - 1])
                int n_rows, const __grid_constant__ Layers L, int buf1) {
  extern __shared__ __align__(16) float smem[];
  float* wbuf = smem;                                // 2 staged tiles
  float* const buf0 = smem + 2 * kTileFloats;       // h_0 = x, h_2, ...
  float* const buf1p = buf0 + buf1;                  // h_1, h_3, ...
  const int row0 = blockIdx.x * R;
  const int rows = min(R, n_rows - row0);

  Tile t{0, 0, 0};
  int slot = 0;
  stage_weights(wbuf, params, L, t);                 // in flight while the
  cp_async_commit();                                 // rows load
  stage_rows<R>(buf0, x, row0, rows, L.in_dim);

  for (int l = 0; l < L.n; ++l) {
    const float* in = (l & 1) ? buf1p : buf0;
    float* nxt = l + 1 == L.n ? nullptr : (l & 1) ? buf0 : buf1p;
    const int np = round4(L.out[l]);
    for (int p = 0, n0 = 0, width = 0; n0 + width < np; ++p) {
      pass_span(np, p, n0, width);
      const int groups = width >> 2;
      // wide: 16 row groups of R / 16; narrow: the fewest rows a thread
      // that fit the pass into 256 threads
      if (width == kWide) {
        run_pass<R, R / 16, 8>(params, L, l, n0, width, in, nxt, out, row0,
                               rows, wbuf, t, slot);
      } else if (groups * R <= kThreads) {
        run_pass<R, 1, 4>(params, L, l, n0, width, in, nxt, out, row0, rows,
                          wbuf, t, slot);
      } else if (groups * (R / 2) <= kThreads) {
        run_pass<R, 2, 4>(params, L, l, n0, width, in, nxt, out, row0, rows,
                          wbuf, t, slot);
      } else {
        run_pass<R, 4, 4>(params, L, l, n0, width, in, nxt, out, row0, rows,
                          wbuf, t, slot);
      }
    }
    activate_layer<R>(L, l, nxt, out, row0, rows);
  }
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

template <int R>
int launch(const float* x, const float* params, float* out, int n_rows,
           const Layers& L, int buf1, size_t smem, cudaStream_t stream) {
  const int err = reserve_smem<mlp_head_kernel<R>>(smem);
  if (err != 0) return err;
  const int grid = (n_rows + R - 1) / R;
  mlp_head_kernel<R><<<grid, kThreads, smem, stream>>>(x, params, out, n_rows,
                                                       L, buf1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Runs the head over n_rows rows on `stream` and returns 0, a CUDA error
// code, or -1 for a head outside the kernel's domain: 1 to 8 layers, every
// width (C and each layer's) 1 to 896, activations 0 to 10, weight and
// bias offsets multiples of 4.
//
//   x        (n_rows, C) float32, device
//   params   the packed weights, device: per layer (K, round4(N)) row-major
//            with zero padding columns, then its bias (round4(N)), each at
//            a multiple of 4 floats (ops/kernels/head_mlp.py::head_pack)
//   table    (host, 2 + 4 n ints) n, C, then per layer N, its Activation,
//            the start of its weights and of its bias in params
//   out      (n_rows, N of the last layer) float32, device
extern "C" int headpose_mlp_head(const float* x, const float* params,
                                 float* out, int n_rows, const int* table,
                                 cudaStream_t stream) {
  Layers L;
  L.n = table[0];
  L.in_dim = table[1];
  if (L.n < 1 || L.n > kMaxLayers || L.in_dim < 1 || L.in_dim > kMaxWidth ||
      n_rows < 0)
    return kErrUnsupported;
  // the two activation buffers' widths: h_0 = x and the even layers'
  // inputs, the odd ones'; the last layer's output leaves the CTA
  int width[2] = {L.in_dim, 0};
  for (int l = 0; l < L.n; ++l) {
    const int* e = table + 2 + 4 * l;
    L.out[l] = e[0];
    L.act[l] = e[1];
    L.w_off[l] = e[2];
    L.b_off[l] = e[3];
    if (e[0] < 1 || e[0] > kMaxWidth || e[1] < kLinear || e[1] > kGelu ||
        (e[2] & 3) != 0 || (e[3] & 3) != 0)
      return kErrUnsupported;
    if (l + 1 < L.n && round4(e[0]) > width[(l + 1) & 1])
      width[(l + 1) & 1] = round4(e[0]);
  }
  if (n_rows == 0) return 0;
  const size_t staged = sizeof(float) * 2 * kTileFloats;
  const int cols = width[0] + width[1];
  const size_t need64 = staged + sizeof(float) * 64 * static_cast<size_t>(cols);
  const size_t need32 = staged + sizeof(float) * 32 * static_cast<size_t>(cols);
  const size_t need16 = staged + sizeof(float) * 16 * static_cast<size_t>(cols);
  if (need64 <= static_cast<size_t>(kSmemMax))
    return launch<64>(x, params, out, n_rows, L, 64 * width[0], need64, stream);
  if (need32 <= static_cast<size_t>(kSmemMax))
    return launch<32>(x, params, out, n_rows, L, 32 * width[0], need32, stream);
  if (need16 <= static_cast<size_t>(kSmemMax))
    return launch<16>(x, params, out, n_rows, L, 16 * width[0], need16, stream);
  return kErrUnsupported;
}
