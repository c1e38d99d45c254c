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
// of p2 is zero): 0.29 ms a launch at the training shapes in float32 on an
// H100, 0.206 ms with bfloat16 gradients and a float32 cotangent, 0.144 ms
// with a bfloat16 one.
// Design, owner computes, in two kernels:
// - roi_footprints_kernel, the pre-pass: one thread per RoI maps it to its
//   level (roi_level, as K3 does) and gives its sort key (level * B + image)
//   and its footprint on its level, every row and column that one of its taps
//   with a nonzero weight can reach, with a margin of one (its plain twin,
//   operation for operation, is ops/roi_align.py::roi_levels then
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
// bfloat16 operands (pfr_multilevel_roi_align_backward_bf16): the Pallas
// backward with compute_dtype=bfloat16, its default (pallas_roi_align.py:
// 399-403): each sample's cotangent g / S^2 and its row and column weights are
// rounded to bfloat16, and everything is summed in float32. Its first form ran it
// through the loop above, with tables that sum S rounded weights a bin and a
// product and a rounding on every load of g; that made it instruction-bound
// (a multiply and an FMA for each of 32 sums a load) and 26-33% slower than
// the float32 instance, and it wrote float32 gradients that the wrapper then
// rounded in a second pass. multilevel_roi_align_backward_bf16_mma_kernel
// contracts over samples instead of bins, so that every operand of the first
// contraction is a bfloat16 number, as on the TPU:
//   out[y, x, c] = sum_sx Wx[sx, x] * (sum_sy Wy[sy, y] * G[sy, sx, c]),
// Wy and Wx the rounded weights of each sample, G the rounded g / S^2 of the
// sample's bin (G repeats over the S x S samples of a bin). The inner sum,
// T[c, y] for one bin column pw, runs on the tensor cores:
// mma.sync.m16n8k16 bf16 -> f32 with 16 channels as M, the tile's 8 rows as
// N and 16 sample rows as the depth (the 7 x 7 launch's 14 sample rows and
// the 14 x 14 launch's 28 padded with zero weights to 16 and 32). A warp owns
// 16 channels, eight warps a slice of 128. Only the sample rows of the bins
// that touch the tile's rows are visited (depth chunks of 16 from the even
// sample row at or before the first, so that a lane's two Wy entries are one
// aligned 32-bit load when S is odd), and a bin outside them reads as 0, so
// nothing outside the RoI's footprint is loaded. The outer sum keeps T in float32: for each bin column pw, each
// of a thread's four T values (two channels x two rows) feeds the 8 tile
// columns with Ax[x, pw] (the S rounded weights of the bin column summed in
// float32, as the first form's tables did) by FMAs on the CUDA cores, 32 a bin against
// the first form's 64 a bin row and bin. The products of the tensor-core part are
// exact in float32; its sums are not a sequence of rounded adds, so the result
// is held to the plain version within 1e-5 of the scale, not to the bit. The
// RoIs that meet a tile are taken eight at a time: each warp builds one RoI's
// Wy and Ax tables, one barrier, every warp runs the eight on its channels,
// one barrier. The block writes its tile once, through shared memory (the
// tables' space, free by then), as 16-byte stores of float32 or of bfloat16
// (out_bf16: each float32 sum rounded to nearest even at the store, so the
// bfloat16 result is the float32 instance's rounded), and reads a float32 or
// bfloat16 cotangent as it comes (g_bf16; with S = 2, g / 4 of a bfloat16 g is
// exact, so both give the same bits). The RoIs' order, the pre-pass and
// owner-computes are the float32 instance's, so the result is bit-identical
// from launch to launch.
// Bound: the bytes above; the operations (the first contraction at the
// tensor cores' rate, the FMAs at float32's) take under a tenth of that. What
// bounds the kernel is the instructions it issues, about 70 a warp for each
// bin column of each RoI and tile, the 32 FMAs most of them. Timed on an H100
// at both training shapes, from slower to faster: one RoI's tables a barrier,
// built by two warps and double-buffered (about 1.4x the kept form's time);
// eight a barrier; that with at most 80 registers (3 blocks an SM), kept.
// Slower than the kept form: unrolling the bin-column loop, and loading each
// step's cotangent one step ahead (more instructions for a loop that does
// not wait on its loads). Not built: the outer sum on the tensor cores with T
// split into three bfloat16 terms; its splits, the exchange of T between
// lanes and 24 MMAs a RoI and tile would issue about as
// many instructions as the 128 FMAs they replace.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

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
// the bfloat16 instance: 16 channels a warp, kWarps warps a slice of kSlice
constexpr int kMmaChannels = 16;
static_assert(kMmaChannels * kWarps == kSlice, "one MMA row block a warp");
constexpr int kMaxSamples = 64;                // OH * S <= kMaxSamples sample rows
// a row of the Wy table: kMaxSamples, 16 more for the last chunk's overhang,
// and 8 so that the rows of one B fragment fall in different banks
constexpr int kWyStride = kMaxSamples + 16 + 8;

template <typename T>
struct LevelGrads {
  T* data[kMaxLevels];
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

// The bfloat16 instance's tables for one RoI and tile.
struct __align__(16) MmaTables {
  __nv_bfloat16 wy[kTile][kWyStride];  // wy[r][sy]: rounded weight of sample row sy on tile row r
  float ax[kMaxBins][kTile];           // ax[pw][q]: summed rounded weights of bin column pw on q
  int ph_lo, ph_hi;                    // the bins whose samples touch the tile's rows
  int pw_lo, pw_hi;                    // and its columns; -1 in hi for none
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
                                      const int* __restrict__ batch_idx, pfr_roi::Pyramid pyr,
                                      pfr_roi::LevelMap map, int B, int K, int OH, int OW,
                                      int S, int* __restrict__ key,
                                      int4* __restrict__ footprint) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= K) return;
  const float* box = rois + 4 * k;
  const int l = pfr_roi::roi_level(box, map);
  const int b = batch_idx[k];
  key[k] = (b >= 0 && b < B) ? l * B + b : map.n_levels * B;
  const float scale = pyr.scale[l];
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
// of every tile cell it touches.
__device__ __forceinline__ void build_axis(float (*tab)[kMaxBins], int* lo, int* hi, int lane,
                                           int n_bins, float start, float bin, int S, int limit,
                                           int t0) {
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
      if (rl >= 0 && rl < kTile) {
        tab[rl][lane] = __fadd_rn(tab[rl][lane], a.w_low);
        atomicMin(lo + rl, lane);
        atomicMax(hi + rl, lane);
      }
      if (rh >= 0 && rh < kTile) {
        tab[rh][lane] = __fadd_rn(tab[rh][lane], a.w_high);
        atomicMin(lo + rh, lane);
        atomicMax(hi + rh, lane);
      }
    }
  }
}

// The block's tile: its level, image and top-left cell.
struct Tile {
  int l, b, y0, x0;
};

__device__ __forceinline__ Tile block_tile(const TileGrid& grid, int n_levels) {
  int l = 0;
  while (l + 1 < n_levels &&
         !(blockIdx.x >= grid.first[l] && blockIdx.x < grid.first[l] + grid.count[l]))
    ++l;
  int t = blockIdx.x - grid.first[l];
  const int per_image = grid.rows[l] * grid.cols[l];
  const int b = t / per_image;
  t -= b * per_image;
  return {l, b, (t / grid.cols[l]) * kTile, (t % grid.cols[l]) * kTile};
}

// The RoIs of group entries [base, min(base + kThreads, end)) whose footprints
// overlap the tile, in order, into hit_roi and hit_geom (one entry a thread, a
// warp ballot and a prefix over the warps); returns their count. Every thread
// of the block calls it.
__device__ __forceinline__ int collect_hits(int base, int end, const long long* __restrict__ order,
                                            const int4* __restrict__ footprint,
                                            const float* __restrict__ rois, float scale, int OH,
                                            int OW, int y0, int x0, int* hit_roi,
                                            pfr_roi::RoiGeom* hit_geom, int* warp_hits) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
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
  return n_hits;
}

__global__ void __launch_bounds__(kThreads) multilevel_roi_align_backward_kernel(
    const float* __restrict__ g, LevelGrads<float> lg, pfr_roi::Pyramid pyr, TileGrid grid,
    int n_levels, int B, int C, const float* __restrict__ rois,
    const long long* __restrict__ order, const int4* __restrict__ footprint,
    const int* __restrict__ group_start, int OH, int OW, int S) {
  __shared__ Tables tables[2];
  __shared__ int hit_roi[kThreads];
  __shared__ pfr_roi::RoiGeom hit_geom[kThreads];
  __shared__ int warp_hits[kWarps];

  const Tile tile = block_tile(grid, n_levels);
  const int l = tile.l, b = tile.b, y0 = tile.y0, x0 = tile.x0;
  const int H = pyr.H[l];
  const int W = pyr.W[l];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c = blockIdx.y * kSlice + threadIdx.x % kSlice;
  const int r0 = (threadIdx.x / kSlice) * kRows;
  const bool live = c < C;
  const long long bin_stride = (long long)OW * C;
  const float n_samples = (float)(S * S);

  float acc[kRows][kTile];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[i][q] = 0.0f;

  const int begin = group_start[l * B + b];
  const int end = group_start[l * B + b + 1];
  int parity = 0;
  for (int base = begin; base < end; base += kThreads) {
    const int n_hits = collect_hits(base, end, order, footprint, rois, pyr.scale[l], OH, OW,
                                    y0, x0, hit_roi, hit_geom, warp_hits);
    for (int h = 0; h < n_hits; ++h) {
      Tables& tb = tables[parity];
      parity ^= 1;
      if (warp == 0)
        build_axis(tb.ay, tb.ph_lo, tb.ph_hi, lane, OH, hit_geom[h].y1, hit_geom[h].bin_h, S,
                   H, y0);
      else if (warp == 1)
        build_axis(tb.ax, tb.pw_lo, tb.pw_hi, lane, OW, hit_geom[h].x1, hit_geom[h].bin_w, S,
                   W, x0);
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
          const float v = __ldg(grow + (long long)pw * C);
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
      if (x < W) f[((long long)y * W + x) * C] = __fdiv_rn(acc[r][q], n_samples);
    }
  }
}

// ---- the bfloat16 instance ----------------------------------------------

// Warp 0: the tile's Wy table, wy[r][sy] = the rounded weight that sample row
// sy puts on tile row r (zero elsewhere, and in the overhang past OH * S), and
// the range of bins whose samples touch the tile's rows. A sample's two taps
// meet on one cell only at the last row, where the high weight is 0, so each
// entry is one bfloat16 number.
__device__ __forceinline__ void build_wy(MmaTables& tb, int lane, int OH, int S, float y1,
                                         float bin_h, int H, int y0) {
  uint32_t* words = reinterpret_cast<uint32_t*>(&tb.wy[0][0]);
  for (int i = lane; i < kTile * kWyStride / 2; i += 32) words[i] = 0u;
  __syncwarp();
  int lo = INT_MAX, hi = -1;
  for (int sy = lane; sy < OH * S; sy += 32) {
    const int ph = sy / S;
    const pfr_roi::AxisTap a =
        pfr_roi::axis_tap(pfr_roi::sample_pos(y1, ph, sy - ph * S, S, bin_h), H);
    if (a.oob) continue;
    const int rl = a.low - y0;
    const int rh = a.high - y0;
    const float w_low = round_bf16(a.w_low);
    const float w_high = round_bf16(a.w_high);
    bool touched = false;
    if (rl >= 0 && rl < kTile) {
      tb.wy[rl][sy] = __float2bfloat16_rn(rh == rl ? __fadd_rn(w_low, w_high) : w_low);
      touched = true;
    }
    if (rh != rl && rh >= 0 && rh < kTile) {
      tb.wy[rh][sy] = __float2bfloat16_rn(w_high);
      touched = true;
    }
    if (touched) {
      lo = min(lo, ph);
      hi = max(hi, ph);
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    tb.ph_lo = lo;
    tb.ph_hi = hi;
  }
}

// Warp 1: one lane per bin column (lane < OW) fills ax[pw][q], the sum of the
// S rounded weights that its samples put on tile column q (added in sample
// order, as build_axis adds them), and the range of bins that touch the tile.
__device__ __forceinline__ void build_ax(MmaTables& tb, int lane, int OW, int S, float x1,
                                         float bin_w, int W, int x0) {
  int lo = INT_MAX, hi = -1;
  if (lane < OW) {
    float* col = tb.ax[lane];
#pragma unroll
    for (int q = 0; q < kTile; ++q) col[q] = 0.0f;
    bool touched = false;
    for (int s = 0; s < S; ++s) {
      const pfr_roi::AxisTap a =
          pfr_roi::axis_tap(pfr_roi::sample_pos(x1, lane, s, S, bin_w), W);
      if (a.oob) continue;
      const int ql = a.low - x0;
      const int qh = a.high - x0;
      if (ql >= 0 && ql < kTile) {
        col[ql] = __fadd_rn(col[ql], round_bf16(a.w_low));
        touched = true;
      }
      if (qh >= 0 && qh < kTile) {
        col[qh] = __fadd_rn(col[qh], round_bf16(a.w_high));
        touched = true;
      }
    }
    if (touched) lo = hi = lane;
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    tb.pw_lo = lo;
    tb.pw_hi = hi;
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// D += A B on the tensor cores: A 16 x 16 (row-major fragment), B 16 x 8
// (column-major), bfloat16, D 16 x 8 float32 (PTX ISA, mma.m16n8k16).
__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                            pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

// The tables of up to kWarps RoIs, or the tile's store stage: the stage is
// used only once the walk is over.
union MmaShared {
  MmaTables tables[kWarps];
  float stage[kTile * kTile][kSlice];  // stage[cell][channel of the slice]
};

// grid and RoI walk as the float32 kernel's; kThreads threads (at most 80
// registers, so that three blocks share an SM), warp w owns
// channels [16 w, 16 w + 16) of the block's slice. The hits are taken kWarps
// at a time: warp j builds the tables of hit j (its Wy, then its Ax), one
// barrier, then every warp runs the kWarps RoIs on its channels, one barrier.
// Lane (gid = lane / 4, tig = lane % 4) holds, in the MMA's layouts: A = G^T
// for channels gid and gid + 8 and sample rows kb + 2 tig (+1) and
// kb + 2 tig + 8 (+1); B = Wy for tile row gid; D = T for channels gid,
// gid + 8 and tile rows 2 tig, 2 tig + 1. G is the cotangent's type (float or
// __nv_bfloat16), O the gradients'. S is kS, or the argument where kS is 0.
template <int kS, typename G, typename O>
__global__ void __launch_bounds__(kThreads, 3) multilevel_roi_align_backward_bf16_mma_kernel(
    const G* __restrict__ g, LevelGrads<O> lg, pfr_roi::Pyramid pyr, TileGrid grid,
    int n_levels, int B, int C, const float* __restrict__ rois,
    const long long* __restrict__ order, const int4* __restrict__ footprint,
    const int* __restrict__ group_start, int OH, int OW, int s_arg) {
  __shared__ MmaShared sh;
  __shared__ int hit_roi[kThreads];
  __shared__ pfr_roi::RoiGeom hit_geom[kThreads];
  __shared__ int warp_hits[kWarps];

  const int S = kS ? kS : s_arg;
  const Tile tile = block_tile(grid, n_levels);
  const int l = tile.l, b = tile.b, y0 = tile.y0, x0 = tile.x0;
  const int H = pyr.H[l];
  const int W = pyr.W[l];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;
  const int tig = lane & 3;
  const int c_lo = blockIdx.y * kSlice + warp * kMmaChannels + gid;
  const int c_hi = c_lo + 8;
  const bool live_lo = c_lo < C;
  const bool live_hi = c_hi < C;
  const long long bin_stride = (long long)OW * C;
  // g / S^2, by a product with the exact reciprocal where S^2 is a power of two
  const int n_samples = S * S;
  const bool pow2 = (n_samples & (n_samples - 1)) == 0;
  const float inv_samples = 1.0f / (float)n_samples;

  // acc[i][q]: D element i (channel gid or gid + 8, tile row 2 tig or 2 tig + 1)
  // at tile column q
  float acc[4][kTile];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < kTile; ++q) acc[i][q] = 0.0f;

  const int begin = group_start[l * B + b];
  const int end = group_start[l * B + b + 1];
  for (int base = begin; base < end; base += kThreads) {
    const int n_hits = collect_hits(base, end, order, footprint, rois, pyr.scale[l], OH, OW,
                                    y0, x0, hit_roi, hit_geom, warp_hits);
    for (int h0 = 0; h0 < n_hits; h0 += kWarps) {
      const int n_batch = min(kWarps, n_hits - h0);
      if (warp < n_batch) {
        const pfr_roi::RoiGeom geom = hit_geom[h0 + warp];
        build_wy(sh.tables[warp], lane, OH, S, geom.y1, geom.bin_h, H, y0);
        build_ax(sh.tables[warp], lane, OW, S, geom.x1, geom.bin_w, W, x0);
      }
      __syncthreads();
      for (int j = 0; j < n_batch; ++j) {
        const MmaTables& tb = sh.tables[j];
        const int ph0 = tb.ph_lo, ph1 = tb.ph_hi, pw0 = tb.pw_lo, pw1 = tb.pw_hi;
        if (ph1 < 0 || pw1 < 0) continue;  // no tap of the RoI on the tile
        // the first chunk starts on an even sample row, so that each lane's
        // pair of Wy entries is one aligned 32-bit load (with S odd, ph0 * S
        // may be odd: the row before it is then a bin's that misses the tile)
        const int sy0 = (ph0 * S) & ~1;
        const int n_chunks = ((ph1 + 1) * S - sy0 + 15) >> 4;
        const G* gk = g + (long long)hit_roi[h0 + j] * OH * bin_stride;
        // the rounded g / S^2 of sample row sy's bin at channel c (0 for a bin
        // outside those that touch the tile, or a channel past C)
        auto sample = [&](const G* gp, int sy, int c, bool live) -> float {
          const int ph = sy / S;
          float v = 0.0f;
          if (live && (kS == 2 || ph >= ph0) && ph <= ph1)
            v = to_float(gp[ph * bin_stride + c]);
          return pow2 ? __fmul_rn(v, inv_samples) : __fdiv_rn(v, (float)n_samples);
        };
        auto pair = [&](const G* gp, int sy, int c, bool live) -> uint32_t {
          const float v0 = sample(gp, sy, c, live);
          // with S = 2 both sample rows of a pair are one bin's (sy is even)
          return pack_bf16(v0, kS == 2 ? v0 : sample(gp, sy + 1, c, live));
        };
        for (int pw = pw0; pw <= pw1; ++pw) {
          const G* gp = gk + (long long)pw * C;
          float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          for (int ci = 0; ci < n_chunks; ++ci) {
            const int kb = sy0 + 16 * ci + 2 * tig;
            const uint32_t a[4] = {pair(gp, kb, c_lo, live_lo), pair(gp, kb, c_hi, live_hi),
                                   pair(gp, kb + 8, c_lo, live_lo),
                                   pair(gp, kb + 8, c_hi, live_hi)};
            const uint32_t bf[2] = {*reinterpret_cast<const uint32_t*>(&tb.wy[gid][kb]),
                                    *reinterpret_cast<const uint32_t*>(&tb.wy[gid][kb + 8])};
            mma_bf16_16816(d, a, bf);
          }
          const float4 xa = *reinterpret_cast<const float4*>(&tb.ax[pw][0]);
          const float4 xb = *reinterpret_cast<const float4*>(&tb.ax[pw][4]);
          const float ax[kTile] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
#pragma unroll
          for (int q = 0; q < kTile; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) acc[i][q] = fmaf(ax[q], d[i], acc[i][q]);
        }
      }
      // the tables are rebuilt (or the stage written) only once every warp is done
      __syncthreads();
    }
  }

  // the tile through shared memory, then 16-byte stores of 8 channels, each
  // element of the tile written once
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 2 * tig + (i & 1);
    const int ch = warp * kMmaChannels + gid + 8 * (i >> 1);
#pragma unroll
    for (int q = 0; q < kTile; ++q) sh.stage[r * kTile + q][ch] = acc[i][q];
  }
  __syncthreads();
  constexpr int kVecs = kSlice / 8;  // 8-channel vectors of a cell
  O* f = lg.data[l] + (long long)b * H * W * C;
  for (int v = threadIdx.x; v < kTile * kTile * kVecs; v += kThreads) {
    const int cell = v / kVecs;
    const int cv = v - cell * kVecs;
    const int y = y0 + cell / kTile;
    const int x = x0 + cell % kTile;
    const int c = blockIdx.y * kSlice + 8 * cv;
    if (y < H && x < W && c < C)
      store8(f + ((long long)y * W + x) * C + c, &sh.stage[cell][8 * cv]);
  }
}

bool bad_args(int n_levels, int OH, int OW, int S) {
  return n_levels < 1 || n_levels > kMaxLevels || OH < 1 || OW < 1 || OH > kMaxBins ||
         OW > kMaxBins || S < 1;
}

// The tile grid (coarse levels first) and block count of a launch; 0 blocks
// when there is nothing to write.
TileGrid tile_grid(const int* hs, const int* ws, int n_levels, int B, int* n_tiles) {
  TileGrid grid = {};
  *n_tiles = 0;
  for (int i = n_levels - 1; i >= 0; --i) {  // coarse levels first
    grid.rows[i] = (hs[i] + kTile - 1) / kTile;
    grid.cols[i] = (ws[i] + kTile - 1) / kTile;
    grid.first[i] = *n_tiles;
    grid.count[i] = B * grid.rows[i] * grid.cols[i];
    *n_tiles += grid.count[i];
  }
  return grid;
}

template <typename G, typename O>
int backward_bf16(const G* g, void* const* d, const int* hs, const int* ws, const int* st,
                  int n_levels, int B, int C, const float* rois, const long long* order,
                  const int* footprint, const int* group_start, int OH, int OW, int S,
                  cudaStream_t stream) {
  int n_tiles = 0;
  const TileGrid grid = tile_grid(hs, ws, n_levels, B, &n_tiles);
  if (n_tiles == 0 || C == 0) return 0;
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const LevelGrads<O> lg = {{static_cast<O*>(d[0]), static_cast<O*>(d[1]),
                             static_cast<O*>(d[2]), static_cast<O*>(d[3])}};
  const dim3 blocks((unsigned int)n_tiles, (unsigned int)((C + kSlice - 1) / kSlice));
  const int4* fp = reinterpret_cast<const int4*>(footprint);
  if (S == 2)
    multilevel_roi_align_backward_bf16_mma_kernel<2, G, O><<<blocks, kThreads, 0, stream>>>(
        g, lg, pyr, grid, n_levels, B, C, rois, order, fp, group_start, OH, OW, S);
  else
    multilevel_roi_align_backward_bf16_mma_kernel<0, G, O><<<blocks, kThreads, 0, stream>>>(
        g, lg, pyr, grid, n_levels, B, C, rois, order, fp, group_start, OH, OW, S);
  return (int)cudaGetLastError();
}

// the gradients' type from out_bf16
template <typename G>
int backward_bf16(const G* g, void* const* d, int out_bf16, const int* hs, const int* ws,
                  const int* st, int n_levels, int B, int C, const float* rois,
                  const long long* order, const int* footprint, const int* group_start, int OH,
                  int OW, int S, cudaStream_t stream) {
  if (out_bf16)
    return backward_bf16<G, __nv_bfloat16>(g, d, hs, ws, st, n_levels, B, C, rois, order,
                                           footprint, group_start, OH, OW, S, stream);
  return backward_bf16<G, float>(g, d, hs, ws, st, n_levels, B, C, rois, order, footprint,
                                 group_start, OH, OW, S, stream);
}

}  // namespace

extern "C" int pfr_roi_footprints(const float* rois, const int* batch_idx, int h0, int h1,
                                  int h2, int h3, int w0, int w1, int w2, int w3, int stride0,
                                  int stride1, int stride2, int stride3, int n_levels, int B,
                                  int K, int OH, int OW, int sampling_ratio,
                                  float canonical_scale, int canonical_level, int min_level,
                                  int* key, int* footprint, cudaStream_t stream) {
  if (bad_args(n_levels, OH, OW, sampling_ratio)) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const pfr_roi::LevelMap map =
      pfr_roi::make_level_map(canonical_scale, canonical_level, min_level, n_levels);
  const int threads = 256;
  roi_footprints_kernel<<<(K + threads - 1) / threads, threads, 0, stream>>>(
      rois, batch_idx, pyr, map, B, K, OH, OW, sampling_ratio, key,
      reinterpret_cast<int4*>(footprint));
  return (int)cudaGetLastError();
}

extern "C" int pfr_multilevel_roi_align_backward(
    const float* g, float* d0, float* d1, float* d2, float* d3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const long long* order, const int* footprint, const int* group_start,
    int OH, int OW, int sampling_ratio, cudaStream_t stream) {
  if (bad_args(n_levels, OH, OW, sampling_ratio)) return (int)cudaErrorInvalidValue;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  int n_tiles = 0;
  const TileGrid grid = tile_grid(hs, ws, n_levels, B, &n_tiles);
  if (n_tiles == 0 || C == 0) return 0;
  const pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  const LevelGrads<float> lg = {{d0, d1, d2, d3}};
  const dim3 blocks((unsigned int)n_tiles, (unsigned int)((C + kSlice - 1) / kSlice));
  multilevel_roi_align_backward_kernel<<<blocks, kThreads, 0, stream>>>(
      g, lg, pyr, grid, n_levels, B, C, rois, order,
      reinterpret_cast<const int4*>(footprint), group_start, OH, OW, sampling_ratio);
  return (int)cudaGetLastError();
}

// K4 with bfloat16 operands: the same arguments, with the cotangent float32 or
// bfloat16 (g_bf16) and the level gradients float32 or bfloat16 (out_bf16).
// C a multiple of 8 and OH * sampling_ratio <= 64.
extern "C" int pfr_multilevel_roi_align_backward_bf16(
    const void* g, int g_bf16, void* d0, void* d1, void* d2, void* d3, int out_bf16,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const long long* order, const int* footprint, const int* group_start,
    int OH, int OW, int sampling_ratio, cudaStream_t stream) {
  if (bad_args(n_levels, OH, OW, sampling_ratio) || C % 8 != 0 ||
      OH * sampling_ratio > kMaxSamples)
    return (int)cudaErrorInvalidValue;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  void* const d[kMaxLevels] = {d0, d1, d2, d3};
  if (g_bf16)
    return backward_bf16(static_cast<const __nv_bfloat16*>(g), d, out_bf16, hs, ws, st,
                         n_levels, B, C, rois, order, footprint, group_start, OH, OW,
                         sampling_ratio, stream);
  return backward_bf16(static_cast<const float*>(g), d, out_bf16, hs, ws, st, n_levels, B, C,
                       rois, order, footprint, group_start, OH, OW, sampling_ratio, stream);
}
