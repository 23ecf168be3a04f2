// yolo_host: native host-side runtime kernels for darknet_tpu.
//
// The reference's host-side box pipeline (box.cpp NmsSort, detector.cpp PR
// accumulation) is native C++; these are this framework's equivalents for
// the host stages that remain off-device: greedy/DIoU NMS over thousands of
// candidates (mAP validation runs at thresh=.005) and the PR-curve
// accumulation.  Built as a plain C ABI shared library, loaded via ctypes.
//
// Semantics match darknet_tpu.ops.nms.nms_numpy exactly (same as reference
// box.cpp:372-419): per class, sort candidates by prob descending (stable),
// then greedily zero lower-ranked overlaps.

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <vector>

namespace {

struct BoxView {
  const float* b;  // x, y, w, h
  float left() const { return b[0] - b[2] / 2; }
  float right() const { return b[0] + b[2] / 2; }
  float top() const { return b[1] - b[3] / 2; }
  float bottom() const { return b[1] + b[3] / 2; }
};

inline float box_iou(const float* a, const float* c) {
  BoxView A{a}, B{c};
  float w = std::min(A.right(), B.right()) - std::max(A.left(), B.left());
  float h = std::min(A.bottom(), B.bottom()) - std::max(A.top(), B.top());
  if (w < 0 || h < 0) return 0.f;
  float inter = w * h;
  float uni = a[2] * a[3] + c[2] * c[3] - inter;
  if (std::fabs(inter) < FLT_EPSILON || std::fabs(uni) < FLT_EPSILON)
    return 0.f;
  return inter / uni;
}

inline float box_diou(const float* a, const float* c, float beta) {
  BoxView A{a}, B{c};
  float w = std::max(A.right(), B.right()) - std::min(A.left(), B.left());
  float h = std::max(A.bottom(), B.bottom()) - std::min(A.top(), B.top());
  float C = w * w + h * h;
  float i = box_iou(a, c);
  if (std::fabs(C) < FLT_EPSILON) return i;
  float d = (a[0] - c[0]) * (a[0] - c[0]) + (a[1] - c[1]) * (a[1] - c[1]);
  return i - std::pow(d / C, beta);
}

}  // namespace

extern "C" {

// In-place NMS: boxes (n,4) row-major, probs (n,c) row-major.
// kind: 0 = greedy IoU, 1 = DIoU.
void yolo_nms(const float* boxes, float* probs, int n, int c, float thresh,
              int kind, float beta) {
  std::vector<int> order(n);
  for (int k = 0; k < c; ++k) {
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int x, int y) {
      return probs[x * c + k] > probs[y * c + k];
    });
    for (int oi = 0; oi < n; ++oi) {
      int i = order[oi];
      if (std::fabs(probs[i * c + k]) < FLT_EPSILON) continue;
      const float* a = boxes + i * 4;
      for (int oj = oi + 1; oj < n; ++oj) {
        int j = order[oj];
        const float* b = boxes + j * 4;
        float sim = kind == 0 ? box_iou(a, b) : box_diou(a, b, beta);
        if (sim > thresh) probs[j * c + k] = 0.f;
      }
    }
  }
}

// Pairwise IoU matrix: out (n,m).
void yolo_iou_matrix(const float* a, int n, const float* b, int m,
                     float* out) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < m; ++j)
      out[i * m + j] = box_iou(a + i * 4, b + j * 4);
}

// Greedy per-detection GT matching for mAP (ValidateDetector semantics,
// detector.cpp:388-424): for each (det, class-with-prob>0), find the
// highest-IoU same-class GT with IoU > iou_thresh.
//
// dets: (nd,4), det_probs: (nd,nc); gt: (ng,5) [cls,x,y,w,h].
// out rows are (prob, cid, gt_idx or -1, best_iou) quads appended per
// nonzero class prob; returns the count of rows written (caller sizes
// out to nd*nc*4).  Because the argmax over {gt : iou > t} equals the
// global argmax whenever the global max exceeds t, the quad computed at
// iou_thresh=0 derives the match at EVERY threshold t as
// (best_iou > t ? gt_idx : -1) — one pass serves the whole COCO
// AP@[.5:.95] sweep (detector.cpp:388-424 re-matches per threshold).
int yolo_match_dets(const float* dets, const float* det_probs, int nd, int nc,
                    const float* gt, int ng, float iou_thresh, float* out) {
  int rows = 0;
  for (int j = 0; j < nd; ++j) {
    for (int cid = 0; cid < nc; ++cid) {
      float p = det_probs[j * nc + cid];
      if (std::fabs(p) < FLT_EPSILON) continue;
      int best = -1;
      float best_iou = 0.f;
      for (int g = 0; g < ng; ++g) {
        if (static_cast<int>(gt[g * 5]) != cid) continue;
        float iou = box_iou(dets + j * 4, gt + g * 5 + 1);
        if (iou > iou_thresh && iou > best_iou) {
          best_iou = iou;
          best = g;
        }
      }
      out[rows * 4 + 0] = p;
      out[rows * 4 + 1] = static_cast<float>(cid);
      out[rows * 4 + 2] = static_cast<float>(best);
      out[rows * 4 + 3] = best_iou;
      ++rows;
    }
  }
  return rows;
}

}  // extern "C"
