// Greedy detection-to-gt matching of the COCO and VOC evaluators, and the
// host IoU matrix.
//
// engine/eval.py matches each (image, class) pair's score-sorted detections
// to its gts once for every IoU threshold: at COCO's scale millions of calls
// of an O(D * G) loop, the host's hot path of evaluation. These are the
// loops of engine/eval.py's plain Python matchers (_match_image_plain,
// _coco_match_img_plain), with the same order of visits, comparisons and
// tie rules, so that both give the same matches.
//
// Boxes are row-major [N, 4] xyxy doubles with the inclusive +1 pixel area
// rule (offset). Plain C++17 with a C interface; no call keeps state.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline double box_area(const double* b, double offset) {
  return (b[2] - b[0] + offset) * (b[3] - b[1] + offset);
}

// IoU as engine/eval.py's _iou_matrix computes it: the intersection's sides
// clipped at 0, the union floored at 1e-9.
inline double pair_iou(const double* a, const double* b, double offset) {
  const double x1 = a[0] > b[0] ? a[0] : b[0];
  const double y1 = a[1] > b[1] ? a[1] : b[1];
  const double x2 = a[2] < b[2] ? a[2] : b[2];
  const double y2 = a[3] < b[3] ? a[3] : b[3];
  double w = x2 - x1 + offset;
  double h = y2 - y1 + offset;
  w = w > 0 ? w : 0.0;
  h = h > 0 ? h : 0.0;
  const double inter = w * h;
  const double uni = box_area(a, offset) + box_area(b, offset) - inter;
  return inter / (uni > 1e-9 ? uni : 1e-9);
}

}  // namespace

extern "C" {

// The VOC protocol's greedy matcher.
//   det:       [D, 4] detections, by descending score
//   gt:        [G, 4] gts; gt_ignore [G] uint8, 1 = ignored (difficult, crowd)
//   regions:   [R, 4] ignore regions that absorb an otherwise unmatched det
// Each det takes the free non-ignored gt of highest IoU at or above iou_thr
// (the first such gt on a tie), else the free ignored gt of highest IoU above
// iou_thr (then it is ignored), else it is ignored when a region reaches
// iou_thr. Outputs [D] uint8: matched (a true positive), det_ignored.
void td_match_image(const double* det, int64_t D, const double* gt, int64_t G,
                    const uint8_t* gt_ignore, const double* regions, int64_t R,
                    double iou_thr, double offset, uint8_t* matched,
                    uint8_t* det_ignored) {
  std::vector<uint8_t> taken(static_cast<size_t>(G), 0);
  std::memset(matched, 0, static_cast<size_t>(D));
  std::memset(det_ignored, 0, static_cast<size_t>(D));
  for (int64_t i = 0; i < D; ++i) {
    const double* d = det + i * 4;
    int64_t best = -1, best_ignored = -1;
    double best_iou = iou_thr, best_ignored_iou = iou_thr;
    for (int64_t j = 0; j < G; ++j) {
      if (taken[static_cast<size_t>(j)]) continue;
      const double iou = pair_iou(d, gt + j * 4, offset);
      if (iou < iou_thr) continue;
      if (gt_ignore[j]) {
        if (iou > best_ignored_iou) {
          best_ignored_iou = iou;
          best_ignored = j;
        }
      } else if (iou > best_iou || best < 0) {
        best_iou = iou;
        best = j;
      }
    }
    if (best >= 0) {
      matched[i] = 1;
      taken[static_cast<size_t>(best)] = 1;
    } else if (best_ignored >= 0) {
      det_ignored[i] = 1;
      taken[static_cast<size_t>(best_ignored)] = 1;
    } else {
      for (int64_t r = 0; r < R; ++r) {
        if (pair_iou(d, regions + r * 4, offset) >= iou_thr) {
          det_ignored[i] = 1;
          break;
        }
      }
    }
  }
}

// COCO's evaluateImg matching at T thresholds at once.
//   iou:      [D, G] any IoU (boxes or masks; a crowd column normalised by the
//             detection's area), gt columns ordered non-ignored first
//   gt_ig:    [G] uint8, 1 = ignored (crowd, or outside the area range)
//   gt_crowd: [G] uint8, 1 = crowd (matched by any number of detections)
// Each det, by descending score, takes the gt of highest IoU at or above
// min(thr, 1 - 1e-10) that is free or a crowd (the last such gt on a tie);
// once it holds a non-ignored gt, the ignored ones after it cannot take it.
// Outputs [T, D] uint8: matched (any gt), ignored (the gt matched is).
void td_coco_match(const double* iou, int64_t D, int64_t G, const uint8_t* gt_ig,
                   const uint8_t* gt_crowd, const double* thrs, int64_t T,
                   uint8_t* matched, uint8_t* ignored) {
  std::memset(matched, 0, static_cast<size_t>(T * D));
  std::memset(ignored, 0, static_cast<size_t>(T * D));
  std::vector<int64_t> gtm(static_cast<size_t>(G));
  for (int64_t t = 0; t < T; ++t) {
    const double thr = thrs[t] < 1.0 - 1e-10 ? thrs[t] : 1.0 - 1e-10;
    std::fill(gtm.begin(), gtm.end(), int64_t{-1});
    for (int64_t d = 0; d < D; ++d) {
      double best = thr;
      int64_t m = -1;
      const double* row = iou + d * G;
      for (int64_t g = 0; g < G; ++g) {
        if (gtm[static_cast<size_t>(g)] >= 0 && !gt_crowd[g]) continue;
        if (m > -1 && !gt_ig[m] && gt_ig[g]) break;
        if (row[g] < best) continue;
        best = row[g];
        m = g;
      }
      if (m == -1) continue;
      matched[t * D + d] = 1;
      ignored[t * D + d] = gt_ig[m];
      gtm[static_cast<size_t>(m)] = d;
    }
  }
}

// out[i, j] = IoU(a[i], b[j]), [N, M] row-major.
void td_iou_matrix(const double* a, int64_t N, const double* b, int64_t M, double offset,
                   double* out) {
  for (int64_t i = 0; i < N; ++i)
    for (int64_t j = 0; j < M; ++j) out[i * M + j] = pair_iou(a + i * 4, b + j * 4, offset);
}

}  // extern "C"
