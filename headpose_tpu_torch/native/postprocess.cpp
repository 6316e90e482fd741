// Native detection postprocess on the host: score filter + anchor decode +
// greedy NMS + pose lookup, the function of ops/detection.py::postprocess
// (the plain chain) and of kernel #1 (csrc/postprocess.cu), which the
// reference pipeline computes in numpy (blazeFaceDetectorH5.py:284-357).
//
// This is the EDGE half of the deployment story: a TFLite artifact
// (tools/tflite.py) plus this library is a complete detection pipeline with
// no Python numerics in the loop.  Bindings and the combined pipeline live
// in runtime/edge.py (NativePostprocess, EdgeDetector); g++ builds it on
// first use (utils/nativelib.py).  Held to the plain chain in
// tests/test_torch_edge.py and to kernel #1's slab on the card in
// chip_smoke.py: boxes, keypoints and poses bit for bit, scores within a
// sigmoid ulp.
//
// Numeric notes for exact parity with the plain chain:
//  * sanitize: nan logits -> -inf, +inf logits clamped to log(FLT_MAX);
//    non-finite loc entries -> 0  (sanitize_model_outputs)
//  * threshold in logit space; t <= 0 maps to -log(FLT_MAX) (the reference's
//    strict prob > 0 filter), t >= 1 to +inf  (score_threshold_to_logit)
//  * decode is affine with coefficients s = 1/input_size and -0.5*s computed
//    in double then rounded to float, exactly like the f32 decode matrix
//    built from Python doubles (_decode_matrix); the decode matmul adds 14
//    exact zeros, so per-column sums reduce to the same two-term f32
//    expressions
//  * NMS: greedy by descending score, FIRST index wins ties, suppress
//    IoU > threshold; trip count = survivors  (nms_static)
//  * scores: sigmoid of the selected logit (selected anchors always passed
//    the threshold, so the safe_logits masking is a no-op for them)

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kLocDim = 16;
constexpr int kKeypoints = 6;

inline float sanitize_logit(float v) {
  if (std::isnan(v)) return -std::numeric_limits<float>::infinity();
  const float big = std::log(std::numeric_limits<float>::max());
  return v > big ? big : v;
}

inline float sanitize_loc(float v) { return std::isfinite(v) ? v : 0.0f; }

// score_threshold arrives as DOUBLE: the f32 logit cutoff must round from
// the unrounded threshold exactly as score_threshold_to_logit's
// double-precision log does (narrowing t to float first shifts the cutoff
// by one ulp for most thresholds, which can flip a detection).
inline float logit_threshold(double score_threshold) {
  if (score_threshold <= 0.0)
    return -std::log(std::numeric_limits<float>::max());
  if (score_threshold >= 1.0)
    return std::numeric_limits<float>::infinity();
  return static_cast<float>(
      std::log(score_threshold / (1.0 - score_threshold)));
}

}  // namespace

extern "C" {

// Single-image postprocess.  Inputs:
//   logits (A,), loc (A, 16) raw model outputs (front anchors then back);
//   pose_front (hf, wf, 3), pose_back (hb, wb, 3) pose maps;
//   anchors (A, 4) normalized anchor table (cx, cy, w, h; only centers used
//   — fixed_anchor_size=True, blazeFaceUtils.py:59-127);
//   num_front = anchor count of the front grid (front: 2/cell on hf x wf,
//   back: 6/cell on hb x wb — blazeFaceDetectorH5.py:342-353).
// Outputs (caller-allocated, only the first `count` rows meaningful):
//   boxes (max_faces, 4) x1,y1,x2,y2 normalized; keypoints (max_faces, 12);
//   scores (max_faces,); poses (max_faces, 3).
// Returns the detection count, or -1 on invalid arguments.
int hp_postprocess(const float* logits, const float* loc,
                   const float* pose_front, const float* pose_back,
                   const float* anchors, int num_anchors, int num_front,
                   int hf, int wf, int hb, int wb, double score_threshold,
                   float iou_threshold, int input_size, int max_faces,
                   float* boxes, float* keypoints, float* scores,
                   float* poses) {
  if (num_anchors <= 0 || num_front < 0 || num_front > num_anchors ||
      hf <= 0 || wf <= 0 || hb <= 0 || wb <= 0 || input_size <= 0 ||
      max_faces <= 0)
    return -1;
  if (num_front != 2 * hf * wf || num_anchors - num_front != 6 * hb * wb)
    return -1;  // anchor layout must tile the grids exactly

  const float thr = logit_threshold(score_threshold);
  const float ninf = -std::numeric_limits<float>::infinity();
  // coefficients exactly as the f32 decode matrix holds them: doubles
  // rounded once to float (_decode_matrix)
  const float s = static_cast<float>(1.0 / static_cast<double>(input_size));
  const float hs = static_cast<float>(0.5 * (1.0 / static_cast<double>(input_size)));

  std::vector<float> remaining(num_anchors);
  std::vector<float> bx1(num_anchors), by1(num_anchors), bx2(num_anchors),
      by2(num_anchors), area(num_anchors);
  for (int a = 0; a < num_anchors; ++a) {
    const float lg = sanitize_logit(logits[a]);
    remaining[a] = lg > thr ? lg : ninf;
    const float* l = loc + a * kLocDim;
    const float ax = anchors[a * 4 + 0];
    const float ay = anchors[a * 4 + 1];
    const float sx = sanitize_loc(l[0]);
    const float sy = sanitize_loc(l[1]);
    const float w = sanitize_loc(l[2]);
    const float h = sanitize_loc(l[3]);
    // two-term f32 sums, then + anchor bias — the decode matmul's
    // effective arithmetic (14 exact-zero addends drop out)
    bx1[a] = (sx * s + w * -hs) + ax;
    by1[a] = (sy * s + h * -hs) + ay;
    bx2[a] = (sx * s + w * hs) + ax;
    by2[a] = (sy * s + h * hs) + ay;
    const float bw = bx2[a] - bx1[a] > 0.0f ? bx2[a] - bx1[a] : 0.0f;
    const float bh = by2[a] - by1[a] > 0.0f ? by2[a] - by1[a] : 0.0f;
    area[a] = bw * bh;
  }

  std::memset(boxes, 0, sizeof(float) * max_faces * 4);
  std::memset(keypoints, 0, sizeof(float) * max_faces * kKeypoints * 2);
  std::memset(scores, 0, sizeof(float) * max_faces);
  std::memset(poses, 0, sizeof(float) * max_faces * 3);

  int count = 0;
  while (count < max_faces) {
    // first-index argmax: the lowest index wins a tie, as in nms_static
    int best = 0;
    float best_v = remaining[0];
    for (int a = 1; a < num_anchors; ++a)
      if (remaining[a] > best_v) { best_v = remaining[a]; best = a; }
    if (!(best_v > ninf)) break;  // nothing eligible left

    // emit
    float* ob = boxes + count * 4;
    ob[0] = bx1[best]; ob[1] = by1[best]; ob[2] = bx2[best]; ob[3] = by2[best];
    const float* l = loc + best * kLocDim;
    const float ax = anchors[best * 4 + 0];
    const float ay = anchors[best * 4 + 1];
    float* ok = keypoints + count * kKeypoints * 2;
    for (int k = 0; k < kKeypoints; ++k) {
      ok[2 * k + 0] = sanitize_loc(l[4 + 2 * k]) * s + ax;
      ok[2 * k + 1] = sanitize_loc(l[5 + 2 * k]) * s + ay;
    }
    scores[count] = 1.0f / (1.0f + std::exp(-sanitize_logit(logits[best])));
    // anchor -> flat grid cell: 2/cell front, 6/cell back (anchor_cells)
    const float* src = best < num_front
                           ? pose_front + (best / 2) * 3
                           : pose_back + ((best - num_front) / 6) * 3;
    std::memcpy(poses + count * 3, src, sizeof(float) * 3);

    // suppress: self + IoU > threshold
    for (int a = 0; a < num_anchors; ++a) {
      if (remaining[a] == ninf) continue;
      if (a == best) { remaining[a] = ninf; continue; }
      const float ix1 = bx1[a] > bx1[best] ? bx1[a] : bx1[best];
      const float iy1 = by1[a] > by1[best] ? by1[a] : by1[best];
      const float ix2 = bx2[a] < bx2[best] ? bx2[a] : bx2[best];
      const float iy2 = by2[a] < by2[best] ? by2[a] : by2[best];
      const float iw = ix2 - ix1 > 0.0f ? ix2 - ix1 : 0.0f;
      const float ih = iy2 - iy1 > 0.0f ? iy2 - iy1 : 0.0f;
      const float inter = iw * ih;
      const float uni = area[a] + area[best] - inter;
      const float iou = uni > 0.0f ? inter / uni : 0.0f;
      if (iou > iou_threshold) remaining[a] = ninf;
    }
    ++count;
  }
  return count;
}

// Batched convenience wrapper: loops hp_postprocess over B images laid out
// contiguously; counts (B,) receives per-image detection counts.  Returns 0,
// or -1 if any image reported invalid arguments.
int hp_postprocess_batch(const float* logits, const float* loc,
                         const float* pose_front, const float* pose_back,
                         const float* anchors, int batch, int num_anchors,
                         int num_front, int hf, int wf, int hb, int wb,
                         double score_threshold, float iou_threshold,
                         int input_size, int max_faces, float* boxes,
                         float* keypoints, float* scores, float* poses,
                         int32_t* counts) {
  for (int b = 0; b < batch; ++b) {
    const int c = hp_postprocess(
        logits + static_cast<size_t>(b) * num_anchors,
        loc + static_cast<size_t>(b) * num_anchors * kLocDim,
        pose_front + static_cast<size_t>(b) * hf * wf * 3,
        pose_back + static_cast<size_t>(b) * hb * wb * 3, anchors,
        num_anchors, num_front, hf, wf, hb, wb, score_threshold,
        iou_threshold, input_size, max_faces,
        boxes + static_cast<size_t>(b) * max_faces * 4,
        keypoints + static_cast<size_t>(b) * max_faces * kKeypoints * 2,
        scores + static_cast<size_t>(b) * max_faces,
        poses + static_cast<size_t>(b) * max_faces * 3);
    if (c < 0) return -1;
    counts[b] = c;
  }
  return 0;
}

}  // extern "C"
