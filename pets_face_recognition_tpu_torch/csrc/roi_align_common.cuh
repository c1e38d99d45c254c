// Shared RoIAlign geometry for K3 (roi_align.cu) and K4 (roi_align_backward.cu).
//
// Both kernels must sample the same positions with the same weights as the
// plain PyTorch version, ops/roi_align.py::multilevel_roi_align: every product
// and sum is rounded on its own (no FMA contraction), in the plain version's
// order. A sample with pos <= -1 or pos >= limit is out of bounds and counts 0;
// low positions clamp to 0; a low tap on the last row or column uses weight 0
// for its (clamped) high neighbour. These rules act on each axis alone, so a
// sample's taps are the product of a row tap and a column tap (axis_tap): K4
// builds its separable tables from axis_tap; K3 keeps each RoI's row and
// column taps and multiplies a row weight by a column weight for each of a
// sample's four taps (w00 = row low x column low, w01 = row low x column
// high, w10, w11), and is out of bounds where the row or the column is.

#pragma once

#include <cuda_bf16.h>
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

// The canonical FPN level mapper (torchvision LevelMapper) as the kernels
// apply it: inv_scale is 1 / canonical_scale rounded to float32, computed in
// float32 on the host, because PyTorch's CUDA kernels divide by a Python
// scalar as a product by that rounded reciprocal.
struct LevelMap {
  float inv_scale;
  int canonical_level;
  int min_level;
  int n_levels;
};

inline LevelMap make_level_map(float canonical_scale, int canonical_level, int min_level,
                               int n_levels) {
  return {1.0f / canonical_scale, canonical_level, min_level, n_levels};
}

// 0-based level of RoI (x1, y1, x2, y2): roi_levels' ops on the card, each
// rounded on its own: floor(k0 + log2(sqrt(w * h) * inv_scale) + 1e-6),
// clamped to the levels. A zero-area box maps to the first level; a NaN box,
// where torch's int cast is undefined, to the first level too.
__device__ __forceinline__ int roi_level(const float* __restrict__ box, const LevelMap& m) {
  const float w = fmaxf(__fsub_rn(box[2], box[0]), 0.0f);
  const float h = fmaxf(__fsub_rn(box[3], box[1]), 0.0f);
  const float r = __fmul_rn(__fsqrt_rn(__fmul_rn(w, h)), m.inv_scale);
  float v = floorf(__fadd_rn(__fadd_rn(log2f(r), (float)m.canonical_level), 1e-6f));
  v = fminf(fmaxf(v, (float)m.min_level), (float)(m.min_level + m.n_levels - 1));
  return (int)v - m.min_level;
}

// v rounded to bfloat16 (to nearest even) and back: the bfloat16 instances'
// weights, and K4's bfloat16 cotangent.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The two taps of one axis: weight w_low on index low, w_high on index high.
struct AxisTap {
  int low, high;
  float w_low, w_high;
  bool oob;
};

__device__ __forceinline__ AxisTap axis_tap(float pos, int limit) {
  AxisTap a;
  a.oob = pos <= -1.0f || pos >= (float)limit;
  float c = fmaxf(pos, 0.0f);
  int l = a.oob ? 0 : (int)floorf(c);  // no int cast of a far-out position
  bool edge = l >= limit - 1;
  a.low = edge ? limit - 1 : l;
  a.high = edge ? a.low : a.low + 1;
  a.w_high = edge ? 0.0f : __fsub_rn(c, (float)a.low);
  a.w_low = __fsub_rn(1.0f, a.w_high);
  return a;
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
