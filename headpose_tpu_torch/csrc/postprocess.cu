// Detection postprocess kernel, from the network's raw outputs to the
// finished slab in one launch: sanitize, score threshold, anchor decode,
// greedy selection NMS, survivor extraction and the score's sigmoid, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/postprocess.py::_nms_kernel
// (postprocess_pallas) together with the XLA prologue and epilogue around
// it.  It computes what the plain chain computes, bit for bit: the plain
// PyTorch version is headpose_tpu_torch/ops/detection.py::postprocess
// (prepare_postprocess -> nms_slab_plain -> finish_postprocess), the
// wrapper headpose_tpu_torch/ops/kernels/postprocess.py::postprocess_slab.
// The TPU kernel's layout (128 images in the lanes of one kernel instance)
// is a TPU layout and is not carried over.
//
// Semantics, per image:
//   logit = nan -> -inf, else min(logit, big) (big = the largest finite
//           logit, float32(log(FLT_MAX)): +inf and anything above it);
//   loc entries that are not finite -> 0;
//   decode (the plain version's loc @ M + bias, M of _decode_matrix): every
//           column has at most two non-zero products, each exact (a power
//           of two times 1/input_size, which the wrapper requires to be a
//           power of two), so the sum rounds once; then the anchor centre
//           (ax for even columns, ay for odd ones) is added;
//   remaining[i] = logit[i] if logit[i] > logit_thr else -inf.  Repeat until
//           nothing remains or max_faces slots are full: select the argmax of
//           remaining (the LOWEST index wins a tie, as in
//           tf.image.non_max_suppression), write slot t = [16 decoded values
//           | 3 pose angles at the anchor's cell | sigmoid(logit) | 1], then
//           set remaining to -inf for the selected anchor and for every
//           anchor whose IoU with it is > iou_thr (in the plain version's
//           order of arithmetic).  Slots past the count are zeros.
//   sigmoid(x) = 1 / (1 + expf(-x)) in float, PyTorch's CUDA sigmoid.
//
// What bounds it on this card: a serial loop whose trip count is the number
// of survivors, each trip an argmax over 896 anchors and a suppression pass.
// It is latency-bound, not bytes-bound.  Bytes: B*896*(1+16)*4 + B*320*3*4
// + 896*4*4 read (logits, loc, pose maps, anchors), B*F*21*4 written.
//
// Design: one CTA of 256 threads per image.  The block stages remaining,
// x1, y1, x2, y2 and area of the 896 anchors in shared memory (21.5 KB), so
// each trip touches device memory only for the one selected anchor.  Each
// thread owns anchors tid, tid+256, ...; a trip is a thread-local argmax, a
// warp-shuffle argmax, a cross-warp argmax in warp 0 (two barriers), the
// slot write by 21 threads and the suppression of each thread's anchors.
// It skips the IoU of anchors already at -inf (suppression cannot change
// them) and the division where the intersection is 0 (the IoU is then 0 in
// the plain version too).  It writes every slot, so the wrapper allocates
// the slab with torch.empty.  (One warp per image, with each lane's 28
// anchors in registers and no block barrier, measured slower: PERF.md.)
//
// Numerics: build with --fmad=false and without --use_fast_math.  With FMA
// contraction `area + barea - inter` could fuse with inter's product, and
// the decode's sum with its products, and round differently from the plain
// version, which can flip an `iou > thr` decision and change the detection
// set.  Division is IEEE round-to-nearest; expf is libdevice's, as in
// PyTorch's own build.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kAnchors = 896;       // 16*16*2 front + 8*8*6 back
constexpr int kFrontAnchors = 512;
constexpr int kFrontGrid = 16;
constexpr int kBackGrid = 8;
constexpr int kLoc = 16;            // raw loc values per anchor
constexpr int kSlab = 21;           // 16 decoded | 3 pose | score | valid
constexpr int kPose = 16, kScore = 19, kValid = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Params {
  const float* logits;      // (B, 896)
  const float* loc;         // (B, 896, 16)
  const float* pose_front;  // image b at pose_front + b * front_stride,
  const float* pose_back;   //   (16, 16, 3) / (8, 8, 3) contiguous
  const float* anchors;     // (896, 4): cx, cy, w, h
  float* out;               // (B, F, 21)
  long long front_stride, back_stride;
  int batch, max_faces;
  float scale, half;        // 1/input_size and 0.5/input_size (float32)
  float big, logit_thr, iou_thr;
};

// the argmax rule: larger value wins, the lower index wins a tie
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ float clean(float v) {
  return isfinite(v) ? v : 0.0f;
}

__device__ __forceinline__ float sanitize_logit(float v, float big) {
  return isnan(v) ? -CUDART_INF_F : fminf(v, big);
}

// decoded column j (0..15) of anchor a from its raw loc row l
__device__ __forceinline__ float decode(const float* __restrict__ l,
                                        const float* __restrict__ anchors,
                                        int a, int j, const Params& p) {
  const float bias = anchors[a * 4 + (j & 1)];
  float v;
  if (j < 4) {                 // x1, y1, x2, y2: centre -+ half the size
    const float c = clean(l[j & 1]) * p.scale;
    const float s = clean(l[2 + (j & 1)]) * (j < 2 ? -p.half : p.half);
    v = c + s;
  } else {                     // keypoint coordinates
    v = clean(l[j]) * p.scale;
  }
  return v + bias;
}

// the box (x1, y1, x2, y2) of anchor a, as `decode` computes columns 0-3
__device__ __forceinline__ float4 decode_box(const float* __restrict__ l,
                                             const float* __restrict__ anchors,
                                             int a, const Params& p) {
  const float4 raw = *reinterpret_cast<const float4*>(l);
  const float ax = anchors[a * 4], ay = anchors[a * 4 + 1];
  const float cx = clean(raw.x) * p.scale, cy = clean(raw.y) * p.scale;
  const float w = clean(raw.z), h = clean(raw.w);
  return make_float4((cx + w * -p.half) + ax, (cy + h * -p.half) + ay,
                     (cx + w * p.half) + ax, (cy + h * p.half) + ay);
}

__device__ __forceinline__ float box_area(float4 b) {
  return fmaxf(b.z - b.x, 0.0f) * fmaxf(b.w - b.y, 0.0f);
}

// IoU > thr of box (x1..y2, area) against the selected box, in the plain
// version's order of arithmetic
__device__ __forceinline__ bool overlaps(float x1, float y1, float x2,
                                         float y2, float area, float bx1,
                                         float by1, float bx2, float by2,
                                         float barea, float thr) {
  const float ix1 = fmaxf(x1, bx1);
  const float iy1 = fmaxf(y1, by1);
  const float ix2 = fminf(x2, bx2);
  const float iy2 = fminf(y2, by2);
  const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
  float iou = 0.0f;
  if (inter > 0.0f) {          // inter == 0: the plain IoU is 0 (or 0 / uni)
    const float uni = area + barea - inter;
    iou = uni > 0.0f ? inter / uni : 0.0f;
  }
  return iou > thr;
}

// slab element k (0..20) of the slot of anchor `sel` with logit `best`
__device__ __forceinline__ float slot_value(int k, int b, int sel, float best,
                                            const Params& p) {
  if (k < kPose) {
    const float* l = p.loc + (static_cast<size_t>(b) * kAnchors + sel) * kLoc;
    return decode(l, p.anchors, sel, k, p);
  }
  if (k < kScore) {
    const float* m;
    if (sel < kFrontAnchors) {
      const int cell = sel / 2;
      const int r = min(cell / kFrontGrid, kFrontGrid - 1);
      const int c = min(cell % kFrontGrid, kFrontGrid - 1);
      m = p.pose_front + b * p.front_stride + (r * kFrontGrid + c) * 3;
    } else {
      const int cell = (sel - kFrontAnchors) / 6;
      const int r = min(cell / kBackGrid, kBackGrid - 1);
      const int c = min(cell % kBackGrid, kBackGrid - 1);
      m = p.pose_back + b * p.back_stride + (r * kBackGrid + c) * 3;
    }
    return m[k - kPose];
  }
  if (k == kScore) return 1.0f / (1.0f + expf(-best));
  return 1.0f;
}

__global__ void __launch_bounds__(kThreads) cta_kernel(const Params p) {
  __shared__ float s_rem[kAnchors];
  __shared__ float s_x1[kAnchors], s_y1[kAnchors];
  __shared__ float s_x2[kAnchors], s_y2[kAnchors];
  __shared__ float s_area[kAnchors];
  __shared__ float s_wv[kWarps];
  __shared__ int s_wi[kWarps];
  __shared__ float s_best;
  __shared__ int s_sel;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* lg = p.logits + static_cast<size_t>(b) * kAnchors;
  const float* loc = p.loc + static_cast<size_t>(b) * kAnchors * kLoc;
  float* slab = p.out + static_cast<size_t>(b) * p.max_faces * kSlab;

  for (int i = tid; i < kAnchors; i += kThreads) {
    const float v = sanitize_logit(lg[i], p.big);
    s_rem[i] = v > p.logit_thr ? v : -CUDART_INF_F;
    const float4 bx = decode_box(loc + i * kLoc, p.anchors, i, p);
    s_x1[i] = bx.x;
    s_y1[i] = bx.y;
    s_x2[i] = bx.z;
    s_y2[i] = bx.w;
    s_area[i] = box_area(bx);
  }
  __syncthreads();

  int t = 0;
  for (; t < p.max_faces; ++t) {
    // 1. thread-local argmax over this thread's anchors
    float bv = -CUDART_INF_F;
    int bi = kAnchors;
    for (int i = tid; i < kAnchors; i += kThreads) {
      const float v = s_rem[i];
      if (better(v, i, bv, bi)) {
        bv = v;
        bi = i;
      }
    }
    // 2. warp argmax, then across the warps in warp 0
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, bv, off);
      const int oi = __shfl_down_sync(0xffffffffu, bi, off);
      if (better(ov, oi, bv, bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      s_wv[warp] = bv;
      s_wi[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bv = lane < kWarps ? s_wv[lane] : -CUDART_INF_F;
      bi = lane < kWarps ? s_wi[lane] : kAnchors;
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oi = __shfl_down_sync(0xffffffffu, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (lane == 0) {
        s_best = bv;
        s_sel = bi;
      }
    }
    __syncthreads();
    const float best = s_best;
    const int sel = s_sel;
    // 3. nothing left: every thread reads the same s_best, so all leave
    if (best == -CUDART_INF_F) break;

    // 4. slot t
    if (tid < kSlab)
      slab[static_cast<size_t>(t) * kSlab + tid] = slot_value(tid, b, sel, best, p);

    // 5. suppress this thread's anchors
    const float bx1 = s_x1[sel], by1 = s_y1[sel];
    const float bx2 = s_x2[sel], by2 = s_y2[sel];
    const float barea = s_area[sel];
    for (int i = tid; i < kAnchors; i += kThreads) {
      if (s_rem[i] == -CUDART_INF_F) continue;
      if (i == sel || overlaps(s_x1[i], s_y1[i], s_x2[i], s_y2[i], s_area[i],
                               bx1, by1, bx2, by2, barea, p.iou_thr))
        s_rem[i] = -CUDART_INF_F;
    }
    __syncthreads();
  }
  // 6. the slots past the count are zeros
  for (int k = t * kSlab + tid; k < p.max_faces * kSlab; k += kThreads)
    slab[k] = 0.0f;
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to float32 tensors: logits (B, 896) and loc
// (B, 896, 16) contiguous, anchors (896, 4) contiguous, the pose maps with
// each image's (16, 16, 3) / (8, 8, 3) block contiguous and images
// front_stride / back_stride floats apart (0 for a map expanded over the
// batch), out (B, F, 21) contiguous, written whole.  scale and half are
// 1/input_size and 0.5/input_size in float32 (input_size a power of two);
// big is float32(log(FLT_MAX)); the thresholds are float32.
extern "C" int headpose_postprocess(
    const float* logits, const float* loc, const float* pose_front,
    const float* pose_back, const float* anchors, float* out,
    long long front_stride, long long back_stride, int batch, int max_faces,
    float scale, float half, float big, float logit_thr, float iou_thr,
    cudaStream_t stream) {
  if (batch > 0 && max_faces > 0) {
    const Params p{logits, loc, pose_front, pose_back, anchors, out,
                   front_stride, back_stride, batch, max_faces, scale, half,
                   big, logit_thr, iou_thr};
    cta_kernel<<<batch, kThreads, 0, stream>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
