// Shared RoIAlign geometry for K3 (roi_align.cu) and K4 (roi_align_backward.cu).
//
// Both kernels must sample the same positions with the same weights as the
// plain PyTorch version, ops/roi_align.py::multilevel_roi_align: every product
// and sum is rounded on its own (no FMA contraction), in the plain version's
// order. A sample with pos <= -1 or pos >= limit is out of bounds and counts 0;
// low positions clamp to 0; a low tap on the last row or column uses weight 0
// for its (clamped) high neighbour.

#pragma once

#include <cuda_runtime.h>

namespace pfr_roi {

constexpr int kMaxLevels = 4;

struct Pyramid {
  int H[kMaxLevels];
  int W[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, rounded to float32
};

inline Pyramid make_pyramid(const int* hs, const int* ws, const int* strides) {
  Pyramid pyr;
  for (int i = 0; i < kMaxLevels; ++i) {
    pyr.H[i] = hs[i];
    pyr.W[i] = ws[i];
    pyr.scale[i] = strides[i] > 0 ? (float)(1.0 / (double)strides[i]) : 0.0f;
  }
  return pyr;
}

struct Tap {
  int y_low, y_high, x_low, x_high;
  float w00, w01, w10, w11;
  bool oob;
};

__device__ __forceinline__ Tap make_tap(float yy, float xx, int H, int W) {
  Tap t;
  t.oob = yy <= -1.0f || yy >= (float)H || xx <= -1.0f || xx >= (float)W;
  float yc = fmaxf(yy, 0.0f);
  float xc = fmaxf(xx, 0.0f);
  int yl = t.oob ? 0 : (int)floorf(yc);
  int xl = t.oob ? 0 : (int)floorf(xc);
  bool ye = yl >= H - 1;
  bool xe = xl >= W - 1;
  t.y_low = ye ? H - 1 : yl;
  t.x_low = xe ? W - 1 : xl;
  t.y_high = ye ? t.y_low : t.y_low + 1;
  t.x_high = xe ? t.x_low : t.x_low + 1;
  float ly = ye ? 0.0f : __fsub_rn(yc, (float)t.y_low);
  float lx = xe ? 0.0f : __fsub_rn(xc, (float)t.x_low);
  float hy = __fsub_rn(1.0f, ly);
  float hx = __fsub_rn(1.0f, lx);
  t.w00 = __fmul_rn(hy, hx);
  t.w01 = __fmul_rn(hy, lx);
  t.w10 = __fmul_rn(ly, hx);
  t.w11 = __fmul_rn(ly, lx);
  return t;
}

// Top-left corner and bin size of RoI k on a level of the given scale.
struct RoiGeom {
  float x1, y1, bin_h, bin_w;
};

__device__ __forceinline__ RoiGeom roi_geom(const float* __restrict__ rois, int k,
                                            float scale, int OH, int OW) {
  RoiGeom r;
  r.x1 = __fmul_rn(rois[4 * k], scale);
  r.y1 = __fmul_rn(rois[4 * k + 1], scale);
  float x2 = __fmul_rn(rois[4 * k + 2], scale);
  float y2 = __fmul_rn(rois[4 * k + 3], scale);
  float roi_w = fmaxf(__fsub_rn(x2, r.x1), 1.0f);
  float roi_h = fmaxf(__fsub_rn(y2, r.y1), 1.0f);
  r.bin_h = __fdiv_rn(roi_h, (float)OH);
  r.bin_w = __fdiv_rn(roi_w, (float)OW);
  return r;
}

// Position of sample s of output cell i: start + (i + (s + .5) / S) * bin.
__device__ __forceinline__ float sample_pos(float start, int i, int s, int S, float bin) {
  float p = __fadd_rn((float)i, __fdiv_rn(__fadd_rn((float)s, 0.5f), (float)S));
  return __fadd_rn(start, __fmul_rn(p, bin));
}

}  // namespace pfr_roi
