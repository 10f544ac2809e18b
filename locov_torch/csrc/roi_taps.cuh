// The sample taps of ROIAlignV2 (aligned, half-pixel offset) with
// torchvision's border rules, shared by the float kernels of
// roi_align.cu and the int8 kernel of roi_align_int8.cu: one box's
// extent in feature coordinates, the taps of one bin's samples along one
// axis, and that bin's dense weights over the cells they touch. The
// arithmetic is the plain version's (ops/roi_align.py: _interp_matrix,
// _sample_coords, _adaptive_coords), in IEEE __f*_rn operations.
#pragma once

#include <math.h>

#include <cuda_runtime.h>

namespace locov {

constexpr int SR_MAX = 8;  // ops/roi_align.py ADAPTIVE_SR_MAX

struct Tap {
  int lo, hi;
  float wlo, whi;  // hat weights times the sample weight
};

// One sample at continuous position `coord` along an axis of `dim`
// cells, with sample weight `sw` (ops/roi_align.py:_interp_matrix).
__device__ __forceinline__ Tap make_tap(float coord, int dim, float sw) {
  const bool outside = coord < -1.0f || coord > (float)dim;
  const float cc = fminf(fmaxf(coord, 0.0f), (float)(dim - 1));
  const float low = floorf(cc);
  const float frac = __fsub_rn(cc, low);
  Tap t;
  t.lo = (int)low;
  t.hi = min(t.lo + 1, dim - 1);
  t.wlo = outside ? 0.0f : __fmul_rn(__fsub_rn(1.0f, frac), sw);
  t.whi = outside ? 0.0f : __fmul_rn(frac, sw);
  return t;
}

// Samples of bin `p` of one axis of a box starting at `lo` with extent
// `size`: fixed `ratio` > 0, or adaptive (ratio <= 0). Writes up to
// SR_MAX taps, returns how many.
__device__ __forceinline__ int bin_taps(float lo, float size, int pooled,
                                        int ratio, int p, int dim,
                                        Tap* taps) {
  const float bin = __fdiv_rn(size, (float)pooled);
  if (ratio > 0) {
    const float sw = __fdiv_rn(1.0f, (float)ratio);
    for (int s = 0; s < ratio; ++s) {
      const float frac = __fdiv_rn(__fadd_rn((float)s, 0.5f), (float)ratio);
      const float coord = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, frac),
                                                  bin));
      taps[s] = make_tap(coord, dim, sw);
    }
    return ratio;
  }
  const float sr = fminf(fmaxf(ceilf(bin), 0.0f), (float)SR_MAX);
  const float srn = fmaxf(sr, 1.0f);
  const float sw = __fdiv_rn(1.0f, srn);
  const int n = (int)sr;
  for (int s = 0; s < n; ++s) {
    const float pos = __fdiv_rn(__fadd_rn((float)s, 0.5f), srn);
    const float coord = __fadd_rn(lo, __fmul_rn(__fadd_rn((float)p, pos),
                                                bin));
    taps[s] = make_tap(coord, dim, sw);
  }
  return n;
}

// A box in feature coordinates: aligned=True (ROIAlignV2), half-pixel
// correction, no size clamping.
struct Box {
  float x0, y0, bw, bh;
};

__device__ __forceinline__ Box load_box(const float* box, float scale) {
  Box r;
  r.x0 = __fsub_rn(__fmul_rn(box[0], scale), 0.5f);
  r.y0 = __fsub_rn(__fmul_rn(box[1], scale), 0.5f);
  r.bw = __fsub_rn(__fsub_rn(__fmul_rn(box[2], scale), 0.5f), r.x0);
  r.bh = __fsub_rn(__fsub_rn(__fmul_rn(box[3], scale), 0.5f), r.y0);
  return r;
}

// The span of cells [lo, hi] that a bin's `nt` taps weigh on (empty: lo
// > hi).
__device__ __forceinline__ int2 tap_span(const Tap* taps, int nt, int dim) {
  int lo = dim, hi = -1;
  for (int s = 0; s < nt; ++s) {
    if (taps[s].wlo != 0.0f) {
      lo = min(lo, taps[s].lo);
      hi = max(hi, taps[s].lo);
    }
    if (taps[s].whi != 0.0f) {
      lo = min(lo, taps[s].hi);
      hi = max(hi, taps[s].hi);
    }
  }
  return make_int2(lo, hi);
}

// A bin's dense weight at cell i: its taps' weights there, summed in the
// samples' order from 0.
__device__ __forceinline__ float tap_weight(const Tap* taps, int nt, int i) {
  float v = 0.0f;
  for (int s = 0; s < nt; ++s) {
    if (taps[s].lo == i) v += taps[s].wlo;
    if (taps[s].hi == i) v += taps[s].whi;
  }
  return v;
}

// The dense weights of one bin of one axis, k[i] for i in its span of
// cells [lo, hi], from the shared tap code; returns the span.
__device__ __forceinline__ int2 dense_bin(float lo0, float size, int pooled,
                                          int ratio, int bin, int dim,
                                          float* k) {
  Tap taps[SR_MAX];
  const int nt = bin_taps(lo0, size, pooled, ratio, bin, dim, taps);
  const int2 span = tap_span(taps, nt, dim);
  for (int i = span.x; i <= span.y; ++i) k[i] = tap_weight(taps, nt, i);
  return span;
}

}  // namespace locov
