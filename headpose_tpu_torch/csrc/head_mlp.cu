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
// What bounds it on this card: at the flagship's shapes, operations and
// launch latency.  Both flagship heads are 3.45 MFLOP per 128x128 frame
// (256 rows of 88 -> 64 -> 3 and 64 rows of 96 -> 32 -> 16 -> 3), 0.0066 ms
// at B=128 and 67 TFLOP/s fp32; the rows they read (14.7 MB at B=128) take
// 0.0044 ms at 3.35 TB/s.
//
// Design: one CTA of 256 threads per tile of 32 rows.  The tile's input rows
// are staged in shared memory, and each layer's output goes to the other of
// two shared buffers (32 rows x the widest layer), so no hidden layer leaves
// the SM: only the final columns are written to device memory.  A thread
// computes one output column for 8 rows (the 8 sums stay in registers), reads
// the layer's weights through L1/L2 (`__ldg`; consecutive threads read
// consecutive columns) and the rows from shared memory as broadcasts, and
// applies the bias and the activation in registers.  Weights are not staged:
// unified-best-distilled's head96 alone is 57,728 floats (231 KB), more than
// a block's shared memory.  FMA contraction is allowed (the wrapper holds the
// result to its plain version within a tolerance, not bit for bit).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                 // rows per CTA
constexpr int kRowTile = 8;               // rows per thread
constexpr int kGroups = kRows / kRowTile;
constexpr int kMaxLayers = 8;
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
  int pitch;                // floats per row of a shared buffer
  int out[kMaxLayers];      // each layer's width
  int act[kMaxLayers];      // each layer's Activation
  int w_off[kMaxLayers];    // each layer's (in, out) weights, in floats
  int b_off[kMaxLayers];    // each layer's bias, in floats
};

__device__ __forceinline__ float activate(float x, int act) {
  switch (act) {
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

__global__ void __launch_bounds__(kThreads)
mlp_head_kernel(const float* __restrict__ x,       // (N, C)
                const float* __restrict__ params,  // packed weights
                float* __restrict__ out,           // (N, out[n - 1])
                int n_rows, Layers L) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + kRows * L.pitch};
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - row0);

  // the tile's rows; rows past the end are zero and never written out
  const float* xt = x + static_cast<size_t>(row0) * L.in_dim;
  for (int i = threadIdx.x; i < kRows * L.in_dim; i += kThreads) {
    const int r = i / L.in_dim, c = i % L.in_dim;
    buf[0][r * L.pitch + c] = r < rows ? xt[i] : 0.0f;
  }
  __syncthreads();

  int cur = 0, K = L.in_dim;
  for (int l = 0; l < L.n; ++l) {
    const int N = L.out[l];
    const int act = L.act[l];
    const bool last = l == L.n - 1;
    const float* w = params + L.w_off[l];
    const float* bias = params + L.b_off[l];
    const float* h = buf[cur];
    float* next = buf[cur ^ 1];
    for (int item = threadIdx.x; item < kGroups * N; item += kThreads) {
      const int j = item % N, g = item / N;
      const float* hg = h + g * kRowTile * L.pitch;
      float acc[kRowTile];
#pragma unroll
      for (int q = 0; q < kRowTile; ++q) acc[q] = 0.0f;
      for (int k = 0; k < K; ++k) {
        const float wv = __ldg(w + static_cast<size_t>(k) * N + j);
#pragma unroll
        for (int q = 0; q < kRowTile; ++q)
          acc[q] = fmaf(hg[q * L.pitch + k], wv, acc[q]);
      }
      const float bj = __ldg(bias + j);
#pragma unroll
      for (int q = 0; q < kRowTile; ++q) {
        const int r = g * kRowTile + q;
        const float v = activate(acc[q] + bj, act);
        if (!last) {
          next[r * L.pitch + j] = v;
        } else if (r < rows) {
          out[static_cast<size_t>(row0 + r) * N + j] = v;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
    K = N;
  }
}

}  // namespace

// Runs the head over n_rows rows on `stream` and returns 0, a CUDA error
// code, or -1 when the head has more than 8 layers or a layer wider than
// the shared buffers take (2 x 32 rows x the widest layer in 227 KB).
//
//   x        (n_rows, in_dim) float32, device
//   params   the packed weights, device: per layer (in, out) then (out);
//            w_offs / b_offs (host, n_layers ints) give their starts
//   out_dims, acts   (host, n_layers ints) each layer's width, Activation
//   out      (n_rows, out_dims[n_layers - 1]) float32, device
extern "C" int headpose_mlp_head(const float* x, const float* params,
                                 float* out, int n_rows, int in_dim,
                                 int n_layers, const int* out_dims,
                                 const int* acts, const int* w_offs,
                                 const int* b_offs, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || in_dim < 1)
    return kErrUnsupported;
  Layers L;
  L.n = n_layers;
  L.in_dim = in_dim;
  int pitch = in_dim;
  for (int l = 0; l < n_layers; ++l) {
    L.out[l] = out_dims[l];
    L.act[l] = acts[l];
    L.w_off[l] = w_offs[l];
    L.b_off[l] = b_offs[l];
    if (out_dims[l] < 1) return kErrUnsupported;
    if (out_dims[l] > pitch) pitch = out_dims[l];
  }
  L.pitch = pitch;
  const size_t smem = sizeof(float) * 2 * kRows * static_cast<size_t>(pitch);
  if (smem > static_cast<size_t>(kSmemMax)) return kErrUnsupported;
  if (n_rows <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlp_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n_rows + kRows - 1) / kRows;
  mlp_head_kernel<<<grid, kThreads, smem, stream>>>(x, params, out, n_rows, L);
  return static_cast<int>(cudaGetLastError());
}
