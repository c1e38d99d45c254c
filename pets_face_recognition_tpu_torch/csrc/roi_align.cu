// K3: FPN multilevel RoIAlign forward (torchvision aligned=False semantics).
//
// Replaces pets_face_recognition_tpu/ops/pallas_roi_align.py::
// multilevel_roi_align_pallas (Pallas body _roi_kernel). Each RoI pools from the
// pyramid level that the canonical mapper assigned it (computed by the wrapper
// with ops/roi_align.py::roi_levels, the same function the plain version uses).
// Output cell (i, j) is the mean of S x S bilinear samples at
// y1 + (i + (p + .5) / S) * bin_h, with the tap rules of roi_align_common.cuh,
// as in ops/roi_align.py::multilevel_roi_align. The TPU kernel's fixed 40x48
// windows, which clamp wide RoIs, are not carried over: every RoI is pooled
// exactly. Its gradient is K4 (roi_align_backward.cu).
//
// Bound: memory, on the sampled reads (4 taps x S*S samples per output cell and
// channel, mostly cache hits) and the (K, OH, OW, C) write. Design: one block
// per RoI and slice of at most 128 channels (narrower slices where there are
// too few RoIs to fill the card). The block first computes the RoI's geometry
// once into shared memory: roi_geom, then the OH * S row taps and OW * S column
// taps (axis_tap), kept as offsets into the level and weights; a sample's four
// weights are then products of a row and a column weight, and its
// out-of-bounds test is the row's or the column's (roi_align_common.cuh), so
// no division is left in the inner loop. Then each thread owns four neighbouring channels (16-byte
// loads and stores, float4 along C) of one cell after another, and the warps
// of a block run over neighbouring cells of the RoI at once, so the taps that
// neighbouring cells share are L1 hits. Each output sums its S * S samples in
// order (sy outer, sx inner), each sample's four products in the order w00,
// w01, w10, w11, every product and sum rounded on its own, and divides by
// S * S (for a power of two as a product by its exact reciprocal, which rounds
// alike): the plain version's arithmetic, so the result is bit-equal to it.
// Tried on an H100 and slower or no faster: visiting the RoIs in (level,
// image) order, staging a small RoI's footprint in shared memory, and a thread
// per bin row that sweeps the sample columns with the last two in registers.

#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;

constexpr int kThreads = 256;
constexpr int kMinSliceF4 = 8;       // a slice is at least 32 channels (128 bytes a cell)
constexpr int kMaxSliceF4 = 32;      // and at most 128
constexpr int kTargetBlocks = 264;   // two blocks for each of the H100's 132 SMs

struct Levels {
  const float* data[kMaxLevels];
};

__device__ __forceinline__ float4 madd4(float4 acc, float4 v, float w) {
  return make_float4(__fadd_rn(acc.x, __fmul_rn(v.x, w)), __fadd_rn(acc.y, __fmul_rn(v.y, w)),
                     __fadd_rn(acc.z, __fmul_rn(v.z, w)), __fadd_rn(acc.w, __fmul_rn(v.w, w)));
}

__device__ __forceinline__ float4 mul4(float4 v, float w) {
  return make_float4(__fmul_rn(v.x, w), __fmul_rn(v.y, w), __fmul_rn(v.z, w),
                     __fmul_rn(v.w, w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

// One axis tap as the inner loop uses it: the two tap positions as offsets
// into the level (rows times W * C4, columns times C4, in float4s) and their
// weights; lo is -1 for a sample out of bounds. 16 bytes, one shared load.
struct TapOffsets {
  int lo, hi;
  float w_lo, w_hi;
};

// The RoI's geometry, once for the block: roi_geom, then its OH * S row taps
// and OW * S column taps (axis_tap; rows first) into shared memory.
__device__ __forceinline__ void block_taps(const float* __restrict__ rois, int k, float scale,
                                           int H, int W, int C4, int OH, int OW, int S,
                                           TapOffsets* taps) {
  __shared__ pfr_roi::RoiGeom geom;
  if (threadIdx.x == 0) geom = pfr_roi::roi_geom(rois, k, scale, OH, OW);
  __syncthreads();
  const int n_rows = OH * S, n_cols = OW * S;
  for (int t = threadIdx.x; t < n_rows + n_cols; t += blockDim.x) {
    const bool row = t < n_rows;
    const int u = row ? t : t - n_rows;  // cell * S + sample along the axis
    const pfr_roi::AxisTap a =
        row ? pfr_roi::axis_tap(pfr_roi::sample_pos(geom.y1, u / S, u % S, S, geom.bin_h), H)
            : pfr_roi::axis_tap(pfr_roi::sample_pos(geom.x1, u / S, u % S, S, geom.bin_w), W);
    const int step = row ? W * C4 : C4;
    taps[t] = {a.oob ? -1 : a.low * step, a.high * step, a.w_low, a.w_high};
  }
  __syncthreads();
}

// grid (K, n_slices), kThreads threads; dynamic shared memory: (OH + OW) * S
// taps, rows first. Thread t owns channels 4 * (t % slice_f4) .. + 3 of the
// slice, for cells t / slice_f4, + kThreads / slice_f4, ... S is kS, or the
// argument where kS is 0.
template <int kS>
__global__ void __launch_bounds__(kThreads)
multilevel_roi_align_kernel(Levels lv, pfr_roi::Pyramid pyr, int C,
                            const float* __restrict__ rois, const int* __restrict__ batch_idx,
                            const int* __restrict__ level, int OH, int OW, int s_arg,
                            int slice_f4, float* __restrict__ out) {
  extern __shared__ TapOffsets taps[];
  const int S = kS ? kS : s_arg;
  const int k = blockIdx.x;
  const int l = level[k];
  const int C4 = C / 4;
  block_taps(rois, k, pyr.scale[l], pyr.H[l], pyr.W[l], C4, OH, OW, S, taps);
  const TapOffsets* ytap = taps;
  const TapOffsets* xtap = taps + OH * S;

  const int per_cell = kThreads / slice_f4;  // threads of one channel group
  if (threadIdx.x >= per_cell * slice_f4) return;
  const int c4 = blockIdx.y * slice_f4 + threadIdx.x % slice_f4;
  const float4* f = reinterpret_cast<const float4*>(
                        lv.data[l] + (long long)batch_idx[k] * pyr.H[l] * pyr.W[l] * C) + c4;
  float4* o = reinterpret_cast<float4*>(out + (long long)k * OH * OW * C) + c4;
  // the mean over S * S samples: a power of two divides exactly as a product
  // by its reciprocal, with the same rounding
  const int n = S * S;
  const bool pow2 = (n & (n - 1)) == 0;
  const float inv = 1.0f / (float)n;
  int cell = threadIdx.x / slice_f4;
  int ph = cell / OW, pw = cell % OW;
  for (; ph < OH; cell += per_cell, pw += per_cell) {
    while (pw >= OW) {
      pw -= OW;
      ++ph;
    }
    if (ph >= OH) break;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
    for (int sy = 0; sy < S; ++sy) {
      const TapOffsets ay = ytap[ph * S + sy];
#pragma unroll
      for (int sx = 0; sx < S; ++sx) {
        const TapOffsets ax = xtap[pw * S + sx];
        float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (ay.lo >= 0 && ax.lo >= 0) {
          const float4 a = __ldg(f + ay.lo + ax.lo);
          const float4 b = __ldg(f + ay.lo + ax.hi);
          const float4 d = __ldg(f + ay.hi + ax.lo);
          const float4 e = __ldg(f + ay.hi + ax.hi);
          // the weights row x column, summed w00, w01, w10, w11
          v = mul4(a, __fmul_rn(ay.w_lo, ax.w_lo));
          v = madd4(v, b, __fmul_rn(ay.w_lo, ax.w_hi));
          v = madd4(v, d, __fmul_rn(ay.w_hi, ax.w_lo));
          v = madd4(v, e, __fmul_rn(ay.w_hi, ax.w_hi));
        }
        acc = add4(acc, v);
      }
    }
    o[(long long)cell * C4] =
        pow2 ? mul4(acc, inv)
             : make_float4(__fdiv_rn(acc.x, (float)n), __fdiv_rn(acc.y, (float)n),
                           __fdiv_rn(acc.z, (float)n), __fdiv_rn(acc.w, (float)n));
  }
}

}  // namespace

extern "C" int pfr_multilevel_roi_align(
    const float* p0, const float* p1, const float* p2, const float* p3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, const int* level, int K, int OH,
    int OW, int sampling_ratio, float* out, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || C % 4 != 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  Levels lv = {{p0, p1, p2, p3}};
  pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  // channel slices of at most kMaxSliceF4 float4s, halved while there are too
  // few blocks to fill the card
  int slice_f4 = C / 4, n_slices = 1;
  while (slice_f4 % 2 == 0 && (slice_f4 > kMaxSliceF4 ||
                               ((long long)K * n_slices < kTargetBlocks &&
                                slice_f4 / 2 >= kMinSliceF4))) {
    slice_f4 /= 2;
    n_slices *= 2;
  }
  const size_t smem = (size_t)(OH + OW) * sampling_ratio * sizeof(TapOffsets);
  if (smem > 48 * 1024 || slice_f4 > kThreads) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)K, (unsigned int)n_slices);
  if (sampling_ratio == 2)
    multilevel_roi_align_kernel<2><<<grid, kThreads, smem, stream>>>(
        lv, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, slice_f4, out);
  else
    multilevel_roi_align_kernel<0><<<grid, kThreads, smem, stream>>>(
        lv, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, slice_f4, out);
  return (int)cudaGetLastError();
}
