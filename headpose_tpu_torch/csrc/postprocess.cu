// Detection postprocess kernel: score threshold, greedy selection NMS and
// survivor extraction, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel headpose_tpu/ops/pallas/postprocess.py::_nms_kernel
// (postprocess_pallas).  It computes what that kernel computes, bit for bit:
// the plain PyTorch twin is headpose_tpu_torch/ops/detection.py::
// nms_slab_plain, and the wrapper is headpose_tpu_torch/ops/kernels/
// postprocess.py::postprocess_kernel.  The TPU kernel's layout (128 images in
// the lanes of one kernel instance) is a TPU layout and is not carried over.
//
// Semantics, per image: remaining[i] = logit[i] if logit[i] > logit_thr else
// -inf.  Repeat until nothing remains or max_faces slots are full: select the
// argmax of remaining (the LOWEST index wins a tie, as in
// tf.image.non_max_suppression), write slot t = [16 decoded values | 3 pose
// angles at the anchor's cell | logit | 1], then set remaining to -inf for the
// selected anchor and for every anchor whose IoU with it is > iou_thr.  Slots
// past the count stay zero (the wrapper allocates the output with zeros).
//
// What bounds it on this card: a serial loop whose trip count is the number
// of survivors, each trip one block-wide argmax reduction and one
// suppression pass over 896 anchors, separated by barriers.  It is
// latency-bound, not bytes-bound.  Bytes: B*896*17*4 + B*320*3*4 read
// (logits, decoded values, pose maps), B*F*(4+12+3+1+1)*4 written.
//
// Design: one CTA of 256 threads per image (grid = B).  The block stages
// remaining, x1, y1, x2, y2 and area of the 896 anchors in shared memory
// (21.5 KB, static), so each trip touches device memory only for the 21
// values of the one selected anchor.  Each thread owns anchors tid, tid+256,
// ...; a trip is a thread-local argmax, a warp-shuffle argmax, a cross-warp
// argmax in warp 0, then the slot write by 21 threads and the suppression of
// each thread's own anchors.
//
// Numerics: build with --fmad=false and without --use_fast_math.  With FMA
// contraction `area + barea - inter` could fuse with inter's product and
// round differently from the twin, which can flip an `iou > thr` decision
// and change the detection set.  Division is IEEE round-to-nearest.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kAnchors = 896;       // 16*16*2 front + 8*8*6 back
constexpr int kFrontAnchors = 512;
constexpr int kFrontGrid = 16;
constexpr int kBackGrid = 8;
constexpr int kLoc = 16;            // decoded values per anchor
constexpr int kSlab = 21;           // 16 decoded | 3 pose | logit | valid
constexpr int kPose = 16, kLogit = 19, kValid = 20;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// the argmax rule: larger value wins, the lower index wins a tie
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__global__ void __launch_bounds__(kThreads)
postprocess_nms_kernel(const float* __restrict__ logits,      // (B, 896)
                       const float* __restrict__ decoded,     // (B, 896, 16)
                       const float* __restrict__ pose_front,  // (B, 16, 16, 3)
                       const float* __restrict__ pose_back,   // (B, 8, 8, 3)
                       float* __restrict__ out,               // (B, F, 21)
                       int max_faces, float logit_thr, float iou_thr) {
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
  const float* lg = logits + static_cast<size_t>(b) * kAnchors;
  const float* dec = decoded + static_cast<size_t>(b) * kAnchors * kLoc;
  float* slab = out + static_cast<size_t>(b) * max_faces * kSlab;

  for (int i = tid; i < kAnchors; i += kThreads) {
    const float v = lg[i];
    s_rem[i] = v > logit_thr ? v : -CUDART_INF_F;
    const float x1 = dec[i * kLoc + 0], y1 = dec[i * kLoc + 1];
    const float x2 = dec[i * kLoc + 2], y2 = dec[i * kLoc + 3];
    s_x1[i] = x1;
    s_y1[i] = y1;
    s_x2[i] = x2;
    s_y2[i] = y2;
    s_area[i] = fmaxf(x2 - x1, 0.0f) * fmaxf(y2 - y1, 0.0f);
  }
  __syncthreads();

  for (int t = 0; t < max_faces; ++t) {
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

    // 4. slot t: decoded values, pose at the anchor's cell, logit, valid
    float* row = slab + static_cast<size_t>(t) * kSlab;
    if (tid < kLoc) {
      row[tid] = dec[sel * kLoc + tid];
    } else if (tid < kLogit) {
      const int k = tid - kPose;
      const float* p;
      if (sel < kFrontAnchors) {
        const int cell = sel / 2;
        const int r = min(cell / kFrontGrid, kFrontGrid - 1);
        const int c = min(cell % kFrontGrid, kFrontGrid - 1);
        p = pose_front + ((static_cast<size_t>(b) * kFrontGrid + r) * kFrontGrid + c) * 3;
      } else {
        const int cell = (sel - kFrontAnchors) / 6;
        const int r = min(cell / kBackGrid, kBackGrid - 1);
        const int c = min(cell % kBackGrid, kBackGrid - 1);
        p = pose_back + ((static_cast<size_t>(b) * kBackGrid + r) * kBackGrid + c) * 3;
      }
      row[kPose + k] = p[k];
    } else if (tid == kLogit) {
      row[kLogit] = best;
    } else if (tid == kValid) {
      row[kValid] = 1.0f;
    }

    // 5. suppress this thread's anchors, in the twin's order of arithmetic
    const float bx1 = s_x1[sel], by1 = s_y1[sel];
    const float bx2 = s_x2[sel], by2 = s_y2[sel];
    const float barea = s_area[sel];
    for (int i = tid; i < kAnchors; i += kThreads) {
      const float ix1 = fmaxf(s_x1[i], bx1);
      const float iy1 = fmaxf(s_y1[i], by1);
      const float ix2 = fminf(s_x2[i], bx2);
      const float iy2 = fminf(s_y2[i], by2);
      const float inter = fmaxf(ix2 - ix1, 0.0f) * fmaxf(iy2 - iy1, 0.0f);
      const float uni = s_area[i] + barea - inter;
      const float iou = uni > 0.0f ? inter / uni : 0.0f;
      if (iou > iou_thr || i == sel) s_rem[i] = -CUDART_INF_F;
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).  All
// pointers are device pointers to contiguous float32 tensors of the shapes
// noted on the kernel; `out` is zero-filled by the caller.
extern "C" int headpose_postprocess_nms(const float* logits,
                                        const float* decoded,
                                        const float* pose_front,
                                        const float* pose_back, float* out,
                                        int batch, int max_faces,
                                        float logit_thr, float iou_thr,
                                        cudaStream_t stream) {
  if (batch > 0 && max_faces > 0) {
    postprocess_nms_kernel<<<batch, kThreads, 0, stream>>>(
        logits, decoded, pose_front, pose_back, out, max_faces, logit_thr,
        iou_thr);
  }
  return static_cast<int>(cudaGetLastError());
}
