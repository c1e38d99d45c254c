// K3: FPN multilevel RoIAlign forward (torchvision aligned=False semantics).
//
// Replaces pets_face_recognition_tpu/ops/pallas_roi_align.py::
// multilevel_roi_align_pallas (Pallas body _roi_kernel). Each RoI pools from the
// pyramid level that the canonical mapper assigns it, which the kernel
// computes itself in its geometry prologue (roi_align_common.cuh, roi_level:
// ops/roi_align.py::roi_levels' operations as they run on the card).
// Output cell (i, j) is the mean of S x S bilinear samples at
// y1 + (i + (p + .5) / S) * bin_h, with the tap rules of roi_align_common.cuh,
// as in ops/roi_align.py::multilevel_roi_align. The TPU kernel's fixed 40x48
// windows, which clamp wide RoIs, are not carried over: every RoI is pooled
// exactly. Its gradient is K4 (roi_align_backward.cu).
//
// Bound: memory, on the sampled reads (4 taps x S*S samples per output cell and
// channel, mostly cache hits) and the (K, OH, OW, C) write. Design: one block
// per RoI and slice of at most 128 channels (narrower slices where there are
// too few RoIs to fill the card). The block first computes the RoI's level
// and geometry once into shared memory: roi_level, roi_geom, then the OH * S
// row taps and OW * S column taps (axis_tap), kept as offsets into the level
// and weights; a sample's four weights are then products of a row and a
// column weight, and its out-of-bounds test is the row's or the column's
// (roi_align_common.cuh), so no division is left in the inner loop. Then
// each thread owns one 16-byte vector of neighbouring channels (four float32
// or eight bfloat16) of one cell after another, and the warps of a block run
// over neighbouring cells of the RoI at once, so the taps that neighbouring
// cells share are L1 hits. Each output sums its S * S samples in order (sy
// outer, sx inner), each sample's four products in the order w00, w01, w10,
// w11, every product and sum rounded on its own, and divides by S * S (for a
// power of two as a product by its exact reciprocal, which rounds alike): the
// plain version's arithmetic, so the result is bit-equal to it. Tried on an
// H100 and slower or no faster: visiting the RoIs in (level, image) order,
// staging a small RoI's footprint in shared memory, and a thread per bin row
// that sweeps the sample columns with the last two in registers.
//
// bfloat16 levels (pfr_multilevel_roi_align_bf16): the JAX kernel's
// compute_dtype=bfloat16 (pallas_roi_align.py:140-142,170-171,243), which the
// JAX detector runs when it computes in bfloat16. The row and column weights
// are rounded to bfloat16 (round to nearest even) once per RoI in shared
// memory; a sample sums each column's two rows first, a_lo = wy_lo f(lo, lo)
// + wy_hi f(hi, lo) and a_hi likewise (the TPU's Wy @ window product;
// bfloat16 products are exact in float32), then a_lo wx_lo + a_hi wx_hi (its
// @ Wx^T), all in float32. Its output is float32, as the TPU's, or bfloat16
// (out_bf16: the float32 result rounded to nearest even at the store) where
// the caller's next layer rounds it to bfloat16 anyway. The instance's first
// form read four channels (8 bytes) a thread and its wrapper mapped the levels
// with ten small launches; it now reads eight (16 bytes) and maps them in the
// kernel.
// Its bound at the serving shapes is a few microseconds of bytes, so what a
// call costs is mostly the host's: the wrapper is one allocation and one
// launch. The float32 instance's inner loop is unchanged.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;

constexpr int kThreads = 256;
constexpr int kMinSliceChannels = 32;   // a slice is at least 32 channels
constexpr int kMaxSliceChannels = 128;  // and at most 128
constexpr int kTargetBlocks = 264;      // two blocks for each of the H100's 132 SMs

template <typename T>
struct Levels {
  const T* data[kMaxLevels];
};

// The channels one thread owns: one 16-byte load of the levels' type.
template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);
  float v[kN];
};

__device__ __forceinline__ Vec<float> load_vec(const float* p) {
  const float4 f = __ldg(reinterpret_cast<const float4*>(p));
  return {{f.x, f.y, f.z, f.w}};
}

__device__ __forceinline__ Vec<__nv_bfloat16> load_vec(const __nv_bfloat16* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned int w[4] = {u.x, u.y, u.z, u.w};
  Vec<__nv_bfloat16> r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    r.v[2 * i] = f.x;
    r.v[2 * i + 1] = f.y;
  }
  return r;
}

using pfr_roi::round_bf16;

template <typename V>
__device__ __forceinline__ V madd(V acc, const V& x, float w) {
#pragma unroll
  for (int i = 0; i < V::kN; ++i) acc.v[i] = __fadd_rn(acc.v[i], __fmul_rn(x.v[i], w));
  return acc;
}

template <typename V>
__device__ __forceinline__ V mul(V x, float w) {
#pragma unroll
  for (int i = 0; i < V::kN; ++i) x.v[i] = __fmul_rn(x.v[i], w);
  return x;
}

template <typename V>
__device__ __forceinline__ V add(V a, const V& b) {
#pragma unroll
  for (int i = 0; i < V::kN; ++i) a.v[i] = __fadd_rn(a.v[i], b.v[i]);
  return a;
}

// the vector's channels as float32 (16-byte stores) or rounded to bfloat16
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&v)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4)
    reinterpret_cast<float4*>(p)[i / 4] = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float (&v)[N]) {
  static_assert(N % 8 == 0, "bfloat16 stores go 8 channels at a time");
#pragma unroll
  for (int i = 0; i < N; i += 8) {
    unsigned int w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
      w[j] = *reinterpret_cast<const unsigned int*>(&h);
    }
    reinterpret_cast<uint4*>(p)[i / 8] = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// One axis tap as the inner loop uses it: the two tap positions as offsets
// into the level (rows times W * CV, columns times CV, in vectors) and their
// weights; lo is -1 for a sample out of bounds. 16 bytes, one shared load.
struct TapOffsets {
  int lo, hi;
  float w_lo, w_hi;
};

struct RoiLevel {
  pfr_roi::RoiGeom geom;
  int level;
};

// The RoI's level and geometry, once for the block (roi_level, roi_geom),
// then its OH * S row taps and
// OW * S column taps (axis_tap; rows first) into shared memory, their weights
// rounded to bfloat16 where kBF16. Returns the level.
template <bool kBF16>
__device__ __forceinline__ int block_taps(const float* __restrict__ rois, int k,
                                          const pfr_roi::Pyramid& pyr,
                                          const pfr_roi::LevelMap& map, int CV, int OH, int OW,
                                          int S, TapOffsets* taps) {
  __shared__ RoiLevel rl;
  if (threadIdx.x == 0) {
    const int l = pfr_roi::roi_level(rois + 4 * k, map);
    rl = {pfr_roi::roi_geom(rois, k, pyr.scale[l], OH, OW), l};
  }
  __syncthreads();
  const int H = pyr.H[rl.level], W = pyr.W[rl.level];
  const int n_rows = OH * S, n_cols = OW * S;
  for (int t = threadIdx.x; t < n_rows + n_cols; t += blockDim.x) {
    const bool row = t < n_rows;
    const int u = row ? t : t - n_rows;  // cell * S + sample along the axis
    const pfr_roi::AxisTap a =
        row ? pfr_roi::axis_tap(pfr_roi::sample_pos(rl.geom.y1, u / S, u % S, S,
                                                    rl.geom.bin_h), H)
            : pfr_roi::axis_tap(pfr_roi::sample_pos(rl.geom.x1, u / S, u % S, S,
                                                    rl.geom.bin_w), W);
    const int step = row ? W * CV : CV;
    taps[t] = {a.oob ? -1 : a.low * step, a.high * step,
               kBF16 ? round_bf16(a.w_low) : a.w_low, kBF16 ? round_bf16(a.w_high) : a.w_high};
  }
  __syncthreads();
  return rl.level;
}

// grid (K, n_slices), kThreads threads; dynamic shared memory: (OH + OW) * S
// taps, rows first. Thread t owns the vector of channels t % slice_v of the
// slice (kN channels), for cells t / slice_v, + kThreads / slice_v, ... S is
// kS, or the argument where kS is 0. T is the levels' type, float or
// __nv_bfloat16; O the output's, float or (for bfloat16 levels) __nv_bfloat16.
template <int kS, typename T, typename O>
__global__ void __launch_bounds__(kThreads)
multilevel_roi_align_kernel(Levels<T> lv, pfr_roi::Pyramid pyr, pfr_roi::LevelMap map, int C,
                            const float* __restrict__ rois, const int* __restrict__ batch_idx,
                            int OH, int OW, int s_arg, int slice_v, O* __restrict__ out) {
  extern __shared__ TapOffsets taps[];
  using V = Vec<T>;
  constexpr int kN = V::kN;
  constexpr bool kBF16 = sizeof(T) == 2;
  const int S = kS ? kS : s_arg;
  const int k = blockIdx.x;
  const int CV = C / kN;
  const int l = block_taps<kBF16>(rois, k, pyr, map, CV, OH, OW, S, taps);
  const TapOffsets* ytap = taps;
  const TapOffsets* xtap = taps + OH * S;

  const int per_cell = kThreads / slice_v;  // threads of one channel vector
  if (threadIdx.x >= per_cell * slice_v) return;
  const int cv = blockIdx.y * slice_v + threadIdx.x % slice_v;
  // f + kN * (offset) is the first of the vector's channels at a tap's offset
  const T* f = lv.data[l] + (long long)batch_idx[k] * pyr.H[l] * pyr.W[l] * C + kN * cv;
  O* o = out + (long long)k * OH * OW * C + kN * cv;
  // the mean over S * S samples: a power of two divides exactly as a product
  // by its reciprocal, with the same rounding
  const int n = S * S;
  const bool pow2 = (n & (n - 1)) == 0;
  const float inv = 1.0f / (float)n;
  int cell = threadIdx.x / slice_v;
  int ph = cell / OW, pw = cell % OW;
  for (; ph < OH; cell += per_cell, pw += per_cell) {
    while (pw >= OW) {
      pw -= OW;
      ++ph;
    }
    if (ph >= OH) break;
    V acc = {};
#pragma unroll
    for (int sy = 0; sy < S; ++sy) {
      const TapOffsets ay = ytap[ph * S + sy];
#pragma unroll
      for (int sx = 0; sx < S; ++sx) {
        const TapOffsets ax = xtap[pw * S + sx];
        V v = {};
        if (ay.lo >= 0 && ax.lo >= 0) {
          const V a = load_vec(f + kN * (ay.lo + ax.lo));
          const V b = load_vec(f + kN * (ay.lo + ax.hi));
          const V d = load_vec(f + kN * (ay.hi + ax.lo));
          const V e = load_vec(f + kN * (ay.hi + ax.hi));
          if (kBF16) {
            // each column's two rows, then the two columns
            const V col_lo = madd(mul(a, ay.w_lo), d, ay.w_hi);
            const V col_hi = madd(mul(b, ay.w_lo), e, ay.w_hi);
            v = madd(mul(col_lo, ax.w_lo), col_hi, ax.w_hi);
          } else {
            // the weights row x column, summed w00, w01, w10, w11
            v = mul(a, __fmul_rn(ay.w_lo, ax.w_lo));
            v = madd(v, b, __fmul_rn(ay.w_lo, ax.w_hi));
            v = madd(v, d, __fmul_rn(ay.w_hi, ax.w_lo));
            v = madd(v, e, __fmul_rn(ay.w_hi, ax.w_hi));
          }
        }
        acc = add(acc, v);
      }
    }
#pragma unroll
    for (int i = 0; i < kN; ++i) acc.v[i] = pow2 ? __fmul_rn(acc.v[i], inv)
                                                 : __fdiv_rn(acc.v[i], (float)n);
    store_vec(o + (long long)cell * C, acc.v);
  }
}

template <typename T, typename O>
int roi_align(const T* p0, const T* p1, const T* p2, const T* p3, int h0, int h1, int h2,
              int h3, int w0, int w1, int w2, int w3, int stride0, int stride1, int stride2,
              int stride3, int n_levels, int C, const float* rois, const int* batch_idx, int K,
              int OH, int OW, int sampling_ratio, float canonical_scale, int canonical_level,
              int min_level, O* out, cudaStream_t stream) {
  constexpr int kN = Vec<T>::kN;
  if (n_levels < 1 || n_levels > kMaxLevels || C % kN != 0 || sampling_ratio < 1)
    return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  Levels<T> lv = {{p0, p1, p2, p3}};
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const pfr_roi::LevelMap map =
      pfr_roi::make_level_map(canonical_scale, canonical_level, min_level, n_levels);
  // channel slices of at most kMaxSliceChannels, halved while there are too
  // few blocks to fill the card
  int slice_v = C / kN, n_slices = 1;
  while (slice_v % 2 == 0 && (slice_v * kN > kMaxSliceChannels ||
                              ((long long)K * n_slices < kTargetBlocks &&
                               slice_v / 2 * kN >= kMinSliceChannels))) {
    slice_v /= 2;
    n_slices *= 2;
  }
  const size_t smem = (size_t)(OH + OW) * sampling_ratio * sizeof(TapOffsets);
  if (smem > 48 * 1024 || slice_v > kThreads) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned int)K, (unsigned int)n_slices);
  if (sampling_ratio == 2)
    multilevel_roi_align_kernel<2, T, O><<<grid, kThreads, smem, stream>>>(
        lv, pyr, map, C, rois, batch_idx, OH, OW, sampling_ratio, slice_v, out);
  else
    multilevel_roi_align_kernel<0, T, O><<<grid, kThreads, smem, stream>>>(
        lv, pyr, map, C, rois, batch_idx, OH, OW, sampling_ratio, slice_v, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pfr_multilevel_roi_align(
    const float* p0, const float* p1, const float* p2, const float* p3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, int K, int OH, int OW, int sampling_ratio,
    float canonical_scale, int canonical_level, int min_level, float* out,
    cudaStream_t stream) {
  return roi_align<float, float>(p0, p1, p2, p3, h0, h1, h2, h3, w0, w1, w2, w3, stride0,
                                 stride1, stride2, stride3, n_levels, C, rois, batch_idx, K, OH,
                                 OW, sampling_ratio, canonical_scale, canonical_level,
                                 min_level, out, stream);
}

// The same over bfloat16 levels; out is float32, or bfloat16 where out_bf16.
extern "C" int pfr_multilevel_roi_align_bf16(
    const __nv_bfloat16* p0, const __nv_bfloat16* p1, const __nv_bfloat16* p2,
    const __nv_bfloat16* p3, int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, int K, int OH, int OW, int sampling_ratio,
    float canonical_scale, int canonical_level, int min_level, void* out, int out_bf16,
    cudaStream_t stream) {
  if (out_bf16)
    return roi_align<__nv_bfloat16, __nv_bfloat16>(
        p0, p1, p2, p3, h0, h1, h2, h3, w0, w1, w2, w3, stride0, stride1, stride2, stride3,
        n_levels, C, rois, batch_idx, K, OH, OW, sampling_ratio, canonical_scale,
        canonical_level, min_level, static_cast<__nv_bfloat16*>(out), stream);
  return roi_align<__nv_bfloat16, float>(
      p0, p1, p2, p3, h0, h1, h2, h3, w0, w1, w2, w3, stride0, stride1, stride2, stride3,
      n_levels, C, rois, batch_idx, K, OH, OW, sampling_ratio, canonical_scale,
      canonical_level, min_level, static_cast<float*>(out), stream);
}
