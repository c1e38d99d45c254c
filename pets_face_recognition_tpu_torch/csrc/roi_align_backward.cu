// K4: gradient of the FPN multilevel RoIAlign (K3) with respect to each level.
//
// Replaces pets_face_recognition_tpu/ops/pallas_roi_align.py::_roi_backward
// (Pallas body _roi_bwd_level_kernel, the backward of
// multilevel_roi_align_pallas_diff). The RoIs and batch indices get no
// gradient, as in the JAX custom VJP and in torchvision. This is the exact
// gradient of K3: output cell (ph, pw) of RoI k is the mean of S x S bilinear
// samples, so level cell (y, x) of the RoI's image and level receives
//   sum_ph sum_pw Ay[y, ph] * Ax[x, pw] * g[k, ph, pw, c] / S^2,
// where Ay[y, ph] sums the row weights that the S sample rows of bin row ph put
// on row y (zero for a sample row out of bounds), and Ax likewise for columns:
// K3's tap weights are a row weight times a column weight, and its
// out-of-bounds test is a row test or a column test (roi_align_common.cuh,
// axis_tap, the same geometry and rounding as K3).
// The TPU form (per-level window matmuls accumulated in VMEM across a sequential
// grid, with wide RoIs clamped to the window) is not carried over.
//
// Bound: bytes. It must read g once and write every level gradient once (most
// of p2 is zero), 0.29 ms a launch at the training shapes on an H100.
// Design, owner computes, in two kernels:
// - roi_footprints_kernel, the pre-pass: one thread per RoI gives its sort key
//   (level * B + image) and its footprint on its level, every row and column
//   that one of its taps with a nonzero weight can reach, with a margin of one
//   (its plain twin, operation for operation, is ops/roi_align.py::
//   roi_footprints). The wrapper sorts the keys, stably.
// - multilevel_roi_align_backward_kernel: one block owns a tile of kTile x
//   kTile cells of one (level, image) gradient map and a slice of kSlice
//   channels, and writes each element of it exactly once, zeros included, so
//   there is no memset and no atomic on the result. The block walks its
//   (level, image) group in RoI index order, 256 footprints at a time, keeps
//   the RoIs that overlap its tile (a warp ballot and a prefix over the warps,
//   which keeps the order) with their geometry, and for each builds the tile's
//   Ay and Ax tables in shared memory (one lane per bin row or column, with the
//   range of bins that touch each tile row and column). Then each thread walks
//   the bins that touch its rows and the tile's columns, loads g once for each
//   (ph, pw) (independent loads, unrolled; one gather per cell and bin, each
//   load waiting on the last, left the block waiting on latency) and adds its
//   weight into all of its cells' sums in registers, zero weights included.
//   One thread owns each output element and the order of the RoIs and bins is
//   fixed, so the result is bit-identical from launch to launch. The tables
//   are double-buffered: one barrier per RoI. The coarse levels, whose tiles
//   meet the most RoIs, are scheduled first. Sizes, timed on an H100 at both
//   training shapes: a slice of 128 channels and 4 rows a thread (each load of
//   g feeds 32 sums) ran faster than 64 or 256 channels, 1, 2 or 8 rows, a
//   register cap, deeper unrolling, staging g in shared memory, an L2
//   prefetch of the next RoI's g, or summing columns first (fewer products,
//   more registers).
//
// kBF16 is the same kernel with the Pallas backward's bfloat16 operands
// (_roi_backward with compute_dtype=bfloat16, its default): the cotangent of
// each sample, g / S^2, and each sample's row and column weights are rounded
// to bfloat16 (pallas_roi_align.py:399-403), and everything is summed in
// float32. The tables then sum S rounded weights a bin, each load of g is
// divided by S^2 (a product by 1 / S^2 where that is exact) and rounded
// before it is used, and the result is written undivided; the wrapper
// rounds the float32 level gradients to the levels' bfloat16, as the custom
// VJP does (:477-483). The TPU form is the same two window matmuls, in
// bfloat16 to fit VMEM; here the rounding costs a few instructions a load
// and nothing in memory, so the bound is K4's.

#include <cuda_runtime.h>

#include <climits>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;
using pfr_roi::round_bf16;

constexpr int kTile = 8;                       // rows and columns of a tile
constexpr int kSlice = 128;                    // channels of a block
constexpr int kGroups = 2;                     // row groups of a tile
constexpr int kRows = kTile / kGroups;         // tile rows a thread owns
constexpr int kThreads = kSlice * kGroups;     // one thread per (channel, row group)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 32;                   // OH, OW <= kMaxBins (one warp a table)

struct LevelGrads {
  float* data[kMaxLevels];
};

// Tiles of each level: level l holds blocks [first[l], first[l] + count[l]),
// image-major.
struct TileGrid {
  int first[kMaxLevels];
  int count[kMaxLevels];
  int rows[kMaxLevels];
  int cols[kMaxLevels];
};

struct Tables {
  float ay[kTile][kMaxBins];   // ay[r][ph]: weight of bin row ph on tile row r
  float ax[kTile][kMaxBins];   // ax[q][pw]: weight of bin column pw on tile column q
  int ph_lo[kTile], ph_hi[kTile];
  int pw_lo[kTile], pw_hi[kTile];
};

// One axis of ops/roi_align.py::roi_footprints: the first and last cell that
// the taps of n bins from r1 to r2 can reach, with a margin of one, clipped to
// [0, limit - 1]; `empty` when no sample can be in bounds.
__device__ __forceinline__ void footprint_axis(float r1, float r2, int n, int S, int limit,
                                               float* lo, float* hi, bool* empty) {
  const float bin = __fdiv_rn(fmaxf(__fsub_rn(r2, r1), 1.0f), (float)n);
  const float half = (float)(0.5 / S);
  const float first = __fsub_rn(floorf(__fadd_rn(r1, __fmul_rn(bin, half))), 1.0f);
  const float last = __fadd_rn(
      floorf(__fadd_rn(r1, __fmul_rn(bin, __fsub_rn((float)n, half)))), 2.0f);
  const float top = (float)(limit - 1);
  *empty = *empty || last < 0.0f || first > top;
  *lo = fminf(fmaxf(first, 0.0f), top);
  *hi = fminf(fmaxf(last, 0.0f), top);
}

__global__ void roi_footprints_kernel(const float* __restrict__ rois,
                                      const int* __restrict__ batch_idx,
                                      const int* __restrict__ level, pfr_roi::Pyramid pyr,
                                      int n_levels, int B, int K, int OH, int OW, int S,
                                      int* __restrict__ key, int4* __restrict__ footprint) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const int l = level[k];
  const int b = batch_idx[k];
  key[k] = (b >= 0 && b < B) ? l * B + b : n_levels * B;
  const float scale = pyr.scale[l];
  const float* box = rois + 4 * k;
  bool empty = false;
  float x_lo, x_hi, y_lo, y_hi;
  footprint_axis(__fmul_rn(box[0], scale), __fmul_rn(box[2], scale), OW, S, pyr.W[l], &x_lo,
                 &x_hi, &empty);
  footprint_axis(__fmul_rn(box[1], scale), __fmul_rn(box[3], scale), OH, S, pyr.H[l], &y_lo,
                 &y_hi, &empty);
  footprint[k] = make_int4((int)y_lo, empty ? -1 : (int)y_hi, (int)x_lo,
                           empty ? -1 : (int)x_hi);
}

// One lane per bin (lane < n_bins) fills column `bin` of `tab` for the tile
// cells [t0, t0 + kTile) of an axis of length `limit`, and widens the bin range
// of every tile cell it touches; with kBF16 each sample's weight is rounded to
// bfloat16 before it is added.
template <bool kBF16>
__device__ __forceinline__ void build_axis(float (*tab)[kMaxBins], int* lo, int* hi,
                                           int lane, int n_bins, float start,
                                           float bin, int S, int limit, int t0) {
  if (lane < kTile) {
    lo[lane] = INT_MAX;
    hi[lane] = -1;
  }
  __syncwarp();
  if (lane < n_bins) {
#pragma unroll
    for (int r = 0; r < kTile; ++r) tab[r][lane] = 0.0f;
    for (int s = 0; s < S; ++s) {
      const pfr_roi::AxisTap a =
          pfr_roi::axis_tap(pfr_roi::sample_pos(start, lane, s, S, bin), limit);
      if (a.oob) continue;
      const int rl = a.low - t0;
      const int rh = a.high - t0;
      const float w_low = kBF16 ? round_bf16(a.w_low) : a.w_low;
      const float w_high = kBF16 ? round_bf16(a.w_high) : a.w_high;
      if (rl >= 0 && rl < kTile) {
        tab[rl][lane] = __fadd_rn(tab[rl][lane], w_low);
        atomicMin(lo + rl, lane);
        atomicMax(hi + rl, lane);
      }
      if (rh >= 0 && rh < kTile) {
        tab[rh][lane] = __fadd_rn(tab[rh][lane], w_high);
        atomicMin(lo + rh, lane);
        atomicMax(hi + rh, lane);
      }
    }
  }
}

template <bool kBF16>
__global__ void __launch_bounds__(kThreads) multilevel_roi_align_backward_kernel(
    const float* __restrict__ g, LevelGrads lg, pfr_roi::Pyramid pyr, TileGrid grid,
    int n_levels, int B, int C, const float* __restrict__ rois,
    const long long* __restrict__ order, const int4* __restrict__ footprint,
    const int* __restrict__ group_start, int OH, int OW, int S) {
  __shared__ Tables tables[2];
  __shared__ int hit_roi[kThreads];
  __shared__ pfr_roi::RoiGeom hit_geom[kThreads];
  __shared__ int warp_hits[kWarps];

  int l = 0;
  while (l + 1 < n_levels &&
         !(blockIdx.x >= grid.first[l] && blockIdx.x < grid.first[l] + grid.count[l]))
    ++l;
  int t = blockIdx.x - grid.first[l];
  const int per_image = grid.rows[l] * grid.cols[l];
  const int b = t / per_image;
  t -= b * per_image;
  const int y0 = (t / grid.cols[l]) * kTile;
  const int x0 = (t % grid.cols[l]) * kTile;
  const int H = pyr.H[l];
  const int W = pyr.W[l];
  const float scale = pyr.scale[l];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kSlice + threadIdx.x % kSlice;
  const int r0 = (threadIdx.x / kSlice) * kRows;
  const bool live = c < C;
  const long long bin_stride = (long long)OW * C;
  const float n_samples = (float)(S * S);
  // with S * S a power of two (the models' S = 2) the bfloat16 instance's
  // division by it is a product by its exact reciprocal, to the bit
  const bool pow2_samples = ((S * S) & (S * S - 1)) == 0;
  const float inv_samples = 1.0f / n_samples;

  float acc[kRows][kTile];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[i][q] = 0.0f;

  const int begin = group_start[l * B + b];
  const int end = group_start[l * B + b + 1];
  int parity = 0;
  for (int base = begin; base < end; base += kThreads) {
    const int i = base + threadIdx.x;
    int k = 0;
    bool hit = false;
    if (i < end) {
      k = (int)order[i];
      const int4 fp = footprint[k];  // (y_lo, y_hi, x_lo, x_hi), inclusive
      hit = fp.x < y0 + kTile && fp.y >= y0 && fp.z < x0 + kTile && fp.w >= x0;
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    if (lane == 0) warp_hits[warp] = __popc(mask);
    __syncthreads();
    int before = 0;
    int n_hits = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      before += w < warp ? warp_hits[w] : 0;
      n_hits += warp_hits[w];
    }
    if (hit) {
      const int slot = before + __popc(mask & ((1u << lane) - 1u));
      hit_roi[slot] = k;
      hit_geom[slot] = pfr_roi::roi_geom(rois, k, scale, OH, OW);
    }
    __syncthreads();

    for (int h = 0; h < n_hits; ++h) {
      Tables& tb = tables[parity];
      parity ^= 1;
      if (warp == 0)
        build_axis<kBF16>(tb.ay, tb.ph_lo, tb.ph_hi, lane, OH, hit_geom[h].y1,
                          hit_geom[h].bin_h, S, H, y0);
      else if (warp == 1)
        build_axis<kBF16>(tb.ax, tb.pw_lo, tb.pw_hi, lane, OW, hit_geom[h].x1,
                          hit_geom[h].bin_w, S, W, x0);
      // the other buffer was last read before the previous RoI's barrier
      __syncthreads();
      if (!live) continue;
      int ph0 = INT_MAX, ph1 = -1, pw0 = INT_MAX, pw1 = -1;
#pragma unroll
      for (int r = 0; r < kTile; ++r) {
        pw0 = min(pw0, tb.pw_lo[r]);
        pw1 = max(pw1, tb.pw_hi[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        ph0 = min(ph0, tb.ph_lo[r0 + r]);
        ph1 = max(ph1, tb.ph_hi[r0 + r]);
      }
      const float* gk = g + (long long)hit_roi[h] * OH * bin_stride + c;
      for (int ph = ph0; ph <= ph1; ++ph) {
        float wy[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) wy[r] = tb.ay[r0 + r][ph];
        const float* grow = gk + ph * bin_stride;
#pragma unroll 4
        for (int pw = pw0; pw <= pw1; ++pw) {
          float v = __ldg(grow + (long long)pw * C);
          if (kBF16)
            v = round_bf16(pow2_samples ? __fmul_rn(v, inv_samples) : __fdiv_rn(v, n_samples));
#pragma unroll
          for (int q = 0; q < kTile; ++q) {
            const float wx = tb.ax[q][pw];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              acc[r][q] = fmaf(__fmul_rn(wy[r], wx), v, acc[r][q]);
          }
        }
      }
    }
  }

  if (!live) return;
  float* f = lg.data[l] + (long long)b * H * W * C + c;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int y = y0 + r0 + r;
    if (y >= H) continue;
#pragma unroll
    for (int q = 0; q < kTile; ++q) {
      const int x = x0 + q;
      if (x < W)
        f[((long long)y * W + x) * C] = kBF16 ? acc[r][q] : __fdiv_rn(acc[r][q], n_samples);
    }
  }
}

bool bad_args(int n_levels, int OH, int OW, int S) {
  return n_levels < 1 || n_levels > kMaxLevels || OH < 1 || OW < 1 || OH > kMaxBins ||
         OW > kMaxBins || S < 1;
}

}  // namespace

extern "C" int pfr_roi_footprints(const float* rois, const int* batch_idx, const int* level,
                                  int h0, int h1, int h2, int h3, int w0, int w1, int w2,
                                  int w3, int stride0, int stride1, int stride2, int stride3,
                                  int n_levels, int B, int K, int OH, int OW,
                                  int sampling_ratio, int* key, int* footprint,
                                  cudaStream_t stream) {
  if (bad_args(n_levels, OH, OW, sampling_ratio)) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const int threads = 256;
  roi_footprints_kernel<<<(K + threads - 1) / threads, threads, 0, stream>>>(
      rois, batch_idx, level, pyr, n_levels, B, K, OH, OW, sampling_ratio, key,
      reinterpret_cast<int4*>(footprint));
  return (int)cudaGetLastError();
}

namespace {

template <bool kBF16>
int roi_align_backward(
    const float* g, float* d0, float* d1, float* d2, float* d3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const long long* order, const int* footprint, const int* group_start,
    int OH, int OW, int sampling_ratio, cudaStream_t stream) {
  if (bad_args(n_levels, OH, OW, sampling_ratio)) return (int)cudaErrorInvalidValue;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  LevelGrads lg = {{d0, d1, d2, d3}};
  TileGrid grid = {};
  int n_tiles = 0;
  for (int i = n_levels - 1; i >= 0; --i) {  // coarse levels first
    grid.rows[i] = (hs[i] + kTile - 1) / kTile;
    grid.cols[i] = (ws[i] + kTile - 1) / kTile;
    grid.first[i] = n_tiles;
    grid.count[i] = B * grid.rows[i] * grid.cols[i];
    n_tiles += grid.count[i];
  }
  if (n_tiles == 0 || C == 0) return 0;
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const dim3 blocks((unsigned int)n_tiles, (unsigned int)((C + kSlice - 1) / kSlice));
  multilevel_roi_align_backward_kernel<kBF16><<<blocks, kThreads, 0, stream>>>(
      g, lg, pyr, grid, n_levels, B, C, rois, order,
      reinterpret_cast<const int4*>(footprint), group_start, OH, OW, sampling_ratio);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int pfr_multilevel_roi_align_backward(
    const float* g, float* d0, float* d1, float* d2, float* d3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const long long* order, const int* footprint, const int* group_start,
    int OH, int OW, int sampling_ratio, cudaStream_t stream) {
  return roi_align_backward<false>(g, d0, d1, d2, d3, h0, h1, h2, h3, w0, w1, w2, w3, stride0,
                                   stride1, stride2, stride3, n_levels, B, C, rois, order,
                                   footprint, group_start, OH, OW, sampling_ratio, stream);
}

// K4 with bfloat16 operands: the same arguments, float32 level gradients.
extern "C" int pfr_multilevel_roi_align_backward_bf16(
    const float* g, float* d0, float* d1, float* d2, float* d3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const long long* order, const int* footprint, const int* group_start,
    int OH, int OW, int sampling_ratio, cudaStream_t stream) {
  return roi_align_backward<true>(g, d0, d1, d2, d3, h0, h1, h2, h3, w0, w1, w2, w3, stride0,
                                  stride1, stride2, stride3, n_levels, B, C, rois, order,
                                  footprint, group_start, OH, OW, sampling_ratio, stream);
}
