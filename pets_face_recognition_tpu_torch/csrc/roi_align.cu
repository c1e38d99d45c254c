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
//
// bfloat16 levels (pfr_multilevel_roi_align_bf16): the JAX kernel's
// compute_dtype=bfloat16 (pallas_roi_align.py:140-142,170-171,243), which the
// JAX detector runs when it computes in bfloat16. Each thread reads its four
// channels as 8 bytes; the row and column weights are rounded to bfloat16
// (round to nearest even) once per RoI in shared memory; a sample sums each
// column's two rows first, a_lo = wy_lo f(lo, lo) + wy_hi f(hi, lo) and a_hi
// likewise (the TPU's Wy @ window product; bfloat16 products are exact in
// float32), then a_lo wx_lo + a_hi wx_hi (its @ Wx^T), all in float32, and
// the output is float32, as the TPU's. The float32 instance is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;

constexpr int kThreads = 256;
constexpr int kMinSliceF4 = 8;       // a slice is at least 32 channels (128 bytes a cell)
constexpr int kMaxSliceF4 = 32;      // and at most 128
constexpr int kTargetBlocks = 264;   // two blocks for each of the H100's 132 SMs

template <typename T>
struct Levels {
  const T* data[kMaxLevels];
};

// four neighbouring channels as float32: 16 bytes of float32, 8 of bfloat16
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

using pfr_roi::round_bf16;

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
// and OW * S column taps (axis_tap; rows first) into shared memory, their
// weights rounded to bfloat16 where kBF16.
template <bool kBF16>
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
    taps[t] = {a.oob ? -1 : a.low * step, a.high * step,
               kBF16 ? round_bf16(a.w_low) : a.w_low, kBF16 ? round_bf16(a.w_high) : a.w_high};
  }
  __syncthreads();
}

// grid (K, n_slices), kThreads threads; dynamic shared memory: (OH + OW) * S
// taps, rows first. Thread t owns channels 4 * (t % slice_f4) .. + 3 of the
// slice, for cells t / slice_f4, + kThreads / slice_f4, ... S is kS, or the
// argument where kS is 0. T is the levels' type, float or __nv_bfloat16.
template <int kS, typename T>
__global__ void __launch_bounds__(kThreads)
multilevel_roi_align_kernel(Levels<T> lv, pfr_roi::Pyramid pyr, int C,
                            const float* __restrict__ rois, const int* __restrict__ batch_idx,
                            const int* __restrict__ level, int OH, int OW, int s_arg,
                            int slice_f4, float* __restrict__ out) {
  extern __shared__ TapOffsets taps[];
  const int S = kS ? kS : s_arg;
  const int k = blockIdx.x;
  const int l = level[k];
  const int C4 = C / 4;
  constexpr bool kBF16 = sizeof(T) == 2;
  block_taps<kBF16>(rois, k, pyr.scale[l], pyr.H[l], pyr.W[l], C4, OH, OW, S, taps);
  const TapOffsets* ytap = taps;
  const TapOffsets* xtap = taps + OH * S;

  const int per_cell = kThreads / slice_f4;  // threads of one channel group
  if (threadIdx.x >= per_cell * slice_f4) return;
  const int c4 = blockIdx.y * slice_f4 + threadIdx.x % slice_f4;
  // f + 4 * (offset) is the first of the four channels at a tap's offset
  const T* f = lv.data[l] + (long long)batch_idx[k] * pyr.H[l] * pyr.W[l] * C + 4 * c4;
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
          const float4 a = load4(f + 4 * (ay.lo + ax.lo));
          const float4 b = load4(f + 4 * (ay.lo + ax.hi));
          const float4 d = load4(f + 4 * (ay.hi + ax.lo));
          const float4 e = load4(f + 4 * (ay.hi + ax.hi));
          if (kBF16) {
            // each column's two rows, then the two columns
            const float4 col_lo = madd4(mul4(a, ay.w_lo), d, ay.w_hi);
            const float4 col_hi = madd4(mul4(b, ay.w_lo), e, ay.w_hi);
            v = madd4(mul4(col_lo, ax.w_lo), col_hi, ax.w_hi);
          } else {
            // the weights row x column, summed w00, w01, w10, w11
            v = mul4(a, __fmul_rn(ay.w_lo, ax.w_lo));
            v = madd4(v, b, __fmul_rn(ay.w_lo, ax.w_hi));
            v = madd4(v, d, __fmul_rn(ay.w_hi, ax.w_lo));
            v = madd4(v, e, __fmul_rn(ay.w_hi, ax.w_hi));
          }
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

template <typename T>
int roi_align(const T* p0, const T* p1, const T* p2, const T* p3, int h0, int h1, int h2,
              int h3, int w0, int w1, int w2, int w3, int stride0, int stride1, int stride2,
              int stride3, int n_levels, int C, const float* rois, const int* batch_idx,
              const int* level, int K, int OH, int OW, int sampling_ratio, float* out,
              cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || C % 4 != 0) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  Levels<T> lv = {{p0, p1, p2, p3}};
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
    multilevel_roi_align_kernel<2, T><<<grid, kThreads, smem, stream>>>(
        lv, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, slice_f4, out);
  else
    multilevel_roi_align_kernel<0, T><<<grid, kThreads, smem, stream>>>(
        lv, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, slice_f4, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pfr_multilevel_roi_align(
    const float* p0, const float* p1, const float* p2, const float* p3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, const int* level, int K, int OH,
    int OW, int sampling_ratio, float* out, cudaStream_t stream) {
  return roi_align<float>(p0, p1, p2, p3, h0, h1, h2, h3, w0, w1, w2, w3, stride0, stride1,
                          stride2, stride3, n_levels, C, rois, batch_idx, level, K, OH, OW,
                          sampling_ratio, out, stream);
}

extern "C" int pfr_multilevel_roi_align_bf16(
    const __nv_bfloat16* p0, const __nv_bfloat16* p1, const __nv_bfloat16* p2,
    const __nv_bfloat16* p3, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, const int* level, int K, int OH,
    int OW, int sampling_ratio, float* out, cudaStream_t stream) {
  return roi_align<__nv_bfloat16>(p0, p1, p2, p3, h0, h1, h2, h3, w0, w1, w2, w3, stride0,
                                  stride1, stride2, stride3, n_levels, C, rois, batch_idx,
                                  level, K, OH, OW, sampling_ratio, out, stream);
}
