// Native COCO bbox matcher — the C++ counterpart of pycocotools'
// C/Cython evaluation core (the reference consumes it via
// pycocotools.COCOeval; SURVEY.md §2b "COCOEvaluator ... native C").
//
// One call performs greedy detection->gt matching for one
// (image, category) cell across ALL IoU thresholds and ALL area
// ranges. Greedy matching in score order is prefix-stable, so results
// for smaller maxDets are prefixes of this one.
//
// Built by locov_torch/utils/native.py (g++ -O3 -shared -fPIC) into
// build/native/. The port's own copy of locov_tpu/native/cocoeval.cpp.
#include <cstdint>
#include <algorithm>

extern "C" {

// ious:      [D, G] row-major (crowd-adjusted IoU)
// g_ignore:  [A, G] per-area-range gt ignore flags (ignore|crowd|area)
// g_crowd:   [G]
// d_area:    [D]
// area_lo/hi:[A]
// thrs:      [T]
// dtm_out:   [A, T, D]  (1 = matched)
// dtig_out:  [A, T, D]  (1 = ignored detection)
// Matching follows pycocotools evaluateImg: gts are processed in
// (non-ignored first) order; a det takes the best-IoU available gt at
// or above the threshold; crowd gts can absorb multiple dets; once a
// non-ignored match candidate is held, ignored gts cannot displace it.
void coco_match_cell(const double* ious, int D, int G,
                     const uint8_t* g_ignore, const uint8_t* g_crowd,
                     const double* d_area,
                     const double* area_lo, const double* area_hi, int A,
                     const double* thrs, int T,
                     uint8_t* dtm_out, uint8_t* dtig_out) {
  // scratch: gt processing order per area range (stable: non-ignored
  // first, original order within groups)
  int* order = new int[G];
  int* gtm = new int[G];

  for (int a = 0; a < A; ++a) {
    const uint8_t* gig = g_ignore + (size_t)a * G;
    int n = 0;
    for (int g = 0; g < G; ++g) if (!gig[g]) order[n++] = g;
    for (int g = 0; g < G; ++g) if (gig[g]) order[n++] = g;

    for (int t = 0; t < T; ++t) {
      uint8_t* dtm = dtm_out + ((size_t)a * T + t) * D;
      uint8_t* dtig = dtig_out + ((size_t)a * T + t) * D;
      for (int g = 0; g < G; ++g) gtm[g] = -1;
      for (int d = 0; d < D; ++d) {
        double best = thrs[t] < (1.0 - 1e-10) ? thrs[t] : (1.0 - 1e-10);
        int m = -1;
        for (int oi = 0; oi < G; ++oi) {
          int g = order[oi];
          if (gtm[g] >= 0 && !g_crowd[g]) continue;
          if (m > -1 && !gig[m] && gig[g]) break;
          double iou = ious[(size_t)d * G + g];
          if (iou < best) continue;
          best = iou;
          m = g;
        }
        if (m == -1) {
          bool out = d_area[d] < area_lo[a] || d_area[d] > area_hi[a];
          dtm[d] = 0;
          dtig[d] = out ? 1 : 0;
          continue;
        }
        dtm[d] = 1;
        dtig[d] = gig[m] ? 1 : 0;
        gtm[m] = d;
      }
    }
  }
  delete[] order;
  delete[] gtm;
}

}  // extern "C"
