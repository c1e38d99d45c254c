// K1: batched projective inverse warp, 4-tap bilinear, zero border.
//
// Replaces pets_face_recognition_tpu/ops/pallas_warp.py::warp_affine_batch_pallas
// (Pallas body _warp_kernel; the JAX wrapper inverts H with jnp.linalg.inv
// before the call). Output pixel (x, y) of image b samples the source at
// H[b]^-1 @ (x, y, 1) with bilinear interpolation and zero outside the image
// (cv2 BORDER_CONSTANT), exactly as ops/homography.py::warp_perspective does.
// The TPU kernel's band clamp, chunk-skip flags, channel planes and images per
// program are not carried over: this kernel computes the exact op.
//
// Compute modes, as the JAX kernel's compute_dtype (pallas_warp.py:114-139,
// 287-292), one extern "C" symbol each:
//   f32  (pfr_warp_perspective_batch): the exact op above;
//   bf16 (pfr_warp_perspective_batch_bf16): each tap's pixel and each x-tent
//        weight (1 - fx, fx) rounded to bfloat16 (round to nearest even), the
//        two products of a source row summed in float32 (each product of two
//        bfloat16 values is exact in float32), and the two row sums weighted
//        by the float32 y-tent (1 - fy, fy): out = A0 (1 - fy) + A1 fy;
//   int8 (pfr_warp_perspective_batch_int8): q = clip(rint(127 p), 0, 127) and
//        w = rint(127 wx), the row sum an exact integer, scaled by the float32
//        1 / 127^2, then weighted by the float32 y-tent.
// The x-tent covers the source columns the TPU kernel contracts over, so these
// are its numbers wherever the TPU sums a row's two taps in one chunk (the
// taps of a pixel fall into two 128-column chunks only at columns 127/128,
// where the TPU adds the chunks' partial rows in another order). out_bf16
// rounds the float32 result once to bfloat16 (the JAX out_dtype).
//
// Bound: memory. Per image it must read the source pixels under the crop once
// and write the 224*224*C crop; its arithmetic is ~50 flops per pixel. Every
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn) in the order of the plain PyTorch version
// (ops/homography.py::invert_homographies and _bilinear_sample), so each mode
// gives the plain version's numbers to the bit on the same inputs.
//
// float32 and bfloat16 (warp_perspective_kernel): one launch, nothing before
// it (a separate batched inverse, a library LU of several launches and host
// work, made the wrapper 4.4x slower than grid_sample). A block covers 256
// output pixels of one image (grid.y is the image); its first thread inverts
// the image's 3x3 by the closed form (adjugate over determinant) into shared
// memory, which timed faster on an H100 than every thread inverting. One
// thread per output pixel handles all C channels (C <= 4, a template
// parameter, so the 4*C tap loads are issued together), NHWC in and out, taps
// read through the read-only cache; the bfloat16 instance rounds each tap in
// registers.
//
// int8 (warp_perspective_tiles_kernel): in the one-pixel-a-thread shape each
// tap was loaded as a float and quantized in registers, so at the served
// scales (0.6-1.4 source pixels a crop pixel) each source pixel under a crop
// was loaded and quantized about four times. Here a block owns a 32 x 16 tile
// of one crop, 4 adjacent pixels a thread (128 threads):
//   - warp 0 inverts the map (one adjugate entry and one division a lane, in
//     the closed form's order) and evaluates the tile's four corner pixels
//     with the pixels' own formula;
//   - where the corners' denominators share one sign and every corner is
//     finite, a rational-linear map has no extremum inside the rectangle, so
//     the corners' taps, widened by kBoxSlack pixels on every side for float32
//     rounding (as the JAX wrapper's band slack), bound every tap of the tile.
//     That box, clipped to the image and a one-pixel ring around it, columns
//     aligned to 4 pixels, is staged in shared memory once, from 16-byte loads
//     of each row's run (NHWC rows are contiguous): each pixel's int8 code as
//     bfloat16 (exact), 0 outside the image, C = 3 padded to 4 so that a tap is
//     one 8-byte shared load; rows of an odd count of 4-pixel groups against
//     bank conflicts;
//   - a pixel whose four taps lie in the box reads them there, with no
//     in-image test (the ring holds the zeros). Any other pixel, and every
//     pixel of a tile whose corners fail the sign or finiteness test or whose
//     box spans more than kStagePixels (a large scale or rotation), reads
//     global memory with the float32 kernel's tests and quantizes there:
//     correctness never depends on the box;
//   - a thread's 4 pixels go out in 16- or 8-byte stores as alignment allows,
//     scalar stores at the ragged edge.
// Probes on an H100 (PERF.md; kernel_ab.py times the modes): the staged int8
// instance is 7-11% faster than the one-pixel-a-thread one at B = 8 and 32, and
// 10-15% faster than the same kernel staging nothing (register blocking
// alone). The same staged design for bfloat16, whose taps cost one rounding
// each, was 9% slower at B = 8 (all tiles resident at once expose the staging
// round trip) and 1.3% slower at B = 32, so bfloat16 keeps the one-pixel-a-
// thread kernel. Fewer pixels a thread (1 or 2), other tiles (32 x 8, 16 x 16,
// 64 x 8), staging unrolled, register caps, per-warp boxes and positions
// computed before staging each lost at B = 32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Mode { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float det2(float a, float b, float c, float d) {
  return __fsub_rn(__fmul_rn(a, b), __fmul_rn(c, d));  // a*b - c*d
}

// m = H^-1 of the row-major 3x3 h: adjugate over determinant.
__device__ __forceinline__ void invert3x3(const float* __restrict__ h, float* m) {
  const float a = __ldg(h), b = __ldg(h + 1), c = __ldg(h + 2);
  const float d = __ldg(h + 3), e = __ldg(h + 4), f = __ldg(h + 5);
  const float g = __ldg(h + 6), k = __ldg(h + 7), i = __ldg(h + 8);
  const float adj[9] = {det2(e, i, f, k), det2(c, k, b, i), det2(b, f, c, e),
                        det2(f, g, d, i), det2(a, i, c, g), det2(c, d, a, f),
                        det2(d, k, e, g), det2(b, g, a, k), det2(a, e, b, d)};
  const float det = __fadd_rn(__fadd_rn(__fmul_rn(a, adj[0]), __fmul_rn(b, adj[3])),
                              __fmul_rn(c, adj[6]));
#pragma unroll
  for (int j = 0; j < 9; ++j) m[j] = __fdiv_rn(adj[j], det);
}

__device__ __forceinline__ float tap(const float* __restrict__ img, bool inb,
                                     int y, int x, int W, int C, int c) {
  return inb ? __ldg(img + ((long long)y * W + x) * C + c) : 0.0f;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one source row's two taps (a at x0, b at x0 + 1) with their bfloat16 x-tents
__device__ __forceinline__ float bf16_row_sum(float a, float b, float wx0, float wx1) {
  return __fadd_rn(__fmul_rn(round_bf16(a), wx0), __fmul_rn(round_bf16(b), wx1));
}

__device__ __forceinline__ void store(float* o, float v) { *o = v; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float v) { *o = __float2bfloat16_rn(v); }

template <int C, int MODE, typename OutT>
__global__ void warp_perspective_kernel(const float* __restrict__ src,
                                        const float* __restrict__ hs,
                                        OutT* __restrict__ out, int H, int W,
                                        int OH, int OW) {
  __shared__ float m[9];
  const int b = blockIdx.y;
  if (threadIdx.x == 0) invert3x3(hs + b * 9, m);
  __syncthreads();
  const long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= (long long)OH * OW) return;
  const float gx = (float)(p % OW);
  const float gy = (float)(p / OW);

  float den = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), __fmul_rn(m[7], gy)), m[8]);
  if (fabsf(den) < 1e-12f) den = 1e-12f;
  float sx = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), __fmul_rn(m[1], gy)), m[2]), den);
  float sy = __fdiv_rn(
      __fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), __fmul_rn(m[4], gy)), m[5]), den);

  float x0 = floorf(sx);
  float y0 = floorf(sy);
  float fx = __fsub_rn(sx, x0);
  float fy = __fsub_rn(sy, y0);
  float gfx = __fsub_rn(1.0f, fx);
  float gfy = __fsub_rn(1.0f, fy);

  // in-bounds tests on the float coordinates: exact for integral values and
  // safe where the coordinate is far outside the int range (or NaN)
  float x1 = x0 + 1.0f;
  float y1 = y0 + 1.0f;
  bool inx0 = x0 >= 0.0f && x0 < (float)W;
  bool inx1 = x1 >= 0.0f && x1 < (float)W;
  bool iny0 = y0 >= 0.0f && y0 < (float)H;
  bool iny1 = y1 >= 0.0f && y1 < (float)H;
  int xi0 = inx0 ? (int)x0 : 0;
  int xi1 = inx1 ? (int)x1 : 0;
  int yi0 = iny0 ? (int)y0 : 0;
  int yi1 = iny1 ? (int)y1 : 0;

  const float* img = src + (long long)b * H * W * C;
  OutT* o = out + ((long long)b * OH * OW + p) * C;
  float t[4][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    t[0][c] = tap(img, iny0 && inx0, yi0, xi0, W, C, c);
    t[1][c] = tap(img, iny0 && inx1, yi0, xi1, W, C, c);
    t[2][c] = tap(img, iny1 && inx0, yi1, xi0, W, C, c);
    t[3][c] = tap(img, iny1 && inx1, yi1, xi1, W, C, c);
  }
  if (MODE == kF32) {
    float w00 = __fmul_rn(gfy, gfx);
    float w01 = __fmul_rn(gfy, fx);
    float w10 = __fmul_rn(fy, gfx);
    float w11 = __fmul_rn(fy, fx);
#pragma unroll
    for (int c = 0; c < C; ++c)
      store(o + c, __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(t[0][c], w00),
                                                 __fmul_rn(t[1][c], w01)),
                                       __fmul_rn(t[2][c], w10)),
                             __fmul_rn(t[3][c], w11)));
  } else {
    const float wx0 = round_bf16(gfx);
    const float wx1 = round_bf16(fx);
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a0 = bf16_row_sum(t[0][c], t[1][c], wx0, wx1);
      const float a1 = bf16_row_sum(t[2][c], t[3][c], wx0, wx1);
      store(o + c, __fadd_rn(__fmul_rn(a0, gfy), __fmul_rn(a1, fy)));
    }
  }
}

// ---- the int8 instance: staged tiles ----

// these five are mirrored by ops/homography.py's K1_TILE, K1_PX,
// K1_STAGE_PIXELS and K1_BOX_SLACK; a CPU test reads them from this file
constexpr int kTileW = 32;           // tile of a crop: columns
constexpr int kTileH = 16;           // rows
constexpr int kPx = 4;               // adjacent pixels a thread
constexpr int kStagePixels = 3072;   // most staged pixels a tile: its box's rows times their pitch
constexpr int kBoxSlack = 1;         // the box's widening in pixels on every side
constexpr int kLanesX = kTileW / kPx;        // threads along a tile row
constexpr int kThreads = kLanesX * kTileH;   // 128

// the box widening of the launches that follow: kBoxSlack, or what the test
// hook pfr_warp_int8_test_box_slack set
int g_box_slack = kBoxSlack;

// the int8 code of a pixel, q = clip(rint(127 p), 0, 127), as a float (exact)
__device__ __forceinline__ float code(float p) {
  return fminf(fmaxf(rintf(__fmul_rn(p, 127.0f)), 0.0f), 127.0f);
}

// one source row's two codes (a at x0, b at x0 + 1) with their x-tents
// rint(127 wx): integers below 2^14, so the fused multiply-add gives the
// exact integer row sum, then scaled by the float32 1 / 127^2
__device__ __forceinline__ float code_row_sum(float a, float b, float wx0, float wx1) {
  return __fmul_rn(__fmaf_rn(a, wx0, __fmul_rn(b, wx1)), 1.0f / 16129.0f);
}

// a staged pixel: C codes as bfloat16 (exact in it), C = 3 padded to 4, so
// that a tap is one 2-, 4- or 8-byte shared load
template <int C>
struct Staged {
  static constexpr int kChannels = C == 3 ? 4 : C;
  static constexpr int kBytes = 2 * kChannels;  // also a group of 4 pixels' 32-bit words
};

// the staged region of a tile: columns [x, x + w), rows [y, y + h), row pitch
// in pixels; w = h = 0 where nothing is staged
struct Box {
  int x, y, w, h, pitch;
};

// stage the box: each thread converts groups of 4 pixels of a row (C 16-byte
// loads where the rows are 16-byte aligned and the group lies in the image)
// into codes, 0 outside the image
template <int C>
__device__ __forceinline__ void stage_box(const float* __restrict__ img, int H, int W,
                                          const Box& bx, unsigned char* stage, bool vec) {
  using S = Staged<C>;
  const int groups = bx.w / 4;
  const int total = groups * bx.h;
#pragma unroll 2
  for (int g = threadIdx.x; g < total; g += kThreads) {
    const int r = g / groups;
    const int x = bx.x + 4 * (g - r * groups);
    const int y = bx.y + r;
    const float* p = img + ((long long)y * W + x) * C;
    float v[4 * C];
    if (vec && y >= 0 && y < H && x >= 0 && x + 4 <= W) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(p) + j);
        v[4 * j] = f.x;
        v[4 * j + 1] = f.y;
        v[4 * j + 2] = f.z;
        v[4 * j + 3] = f.w;
      }
    } else {
      const bool row = y >= 0 && y < H;
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int c = 0; c < C; ++c)
          v[k * C + c] = row && x + k >= 0 && x + k < W ? __ldg(p + k * C + c) : 0.0f;
    }
    unsigned w[S::kBytes];
#pragma unroll
    for (int i = 0; i < S::kBytes; ++i) {
      // elements 2i and 2i + 1 of the group: pixel e / kChannels, channel e % kChannels
      float pair[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int e = 2 * i + h, k = e / S::kChannels, c = e % S::kChannels;
        pair[h] = c < C ? code(v[k * C + c]) : 0.0f;
      }
      const __nv_bfloat162 b2 = __floats2bfloat162_rn(pair[0], pair[1]);
      w[i] = *reinterpret_cast<const unsigned*>(&b2);
    }
    unsigned* d = reinterpret_cast<unsigned*>(stage + ((long long)r * bx.pitch + (x - bx.x)) *
                                                          S::kBytes);
    if constexpr (S::kBytes % 4 == 0) {
#pragma unroll
      for (int i = 0; i < S::kBytes / 4; ++i)
        reinterpret_cast<uint4*>(d)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
    } else {
      reinterpret_cast<uint2*>(d)[0] = make_uint2(w[0], w[1]);
    }
  }
}

// a staged pixel's C codes
template <int C>
__device__ __forceinline__ void load_staged(float (&t)[C], const unsigned char* s) {
  unsigned w[2] = {0u, 0u};
  if constexpr (Staged<C>::kBytes == 8) {
    const uint2 u = *reinterpret_cast<const uint2*>(s);
    w[0] = u.x;
    w[1] = u.y;
  } else if constexpr (Staged<C>::kBytes == 4) {
    w[0] = *reinterpret_cast<const unsigned*>(s);
  } else {
    w[0] = *reinterpret_cast<const unsigned short*>(s);
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
    t[c] = __uint_as_float(c % 2 ? w[c / 2] & 0xffff0000u : w[c / 2] << 16);
}

// a tap read from the source: 0 outside the image, else its code
template <int C>
__device__ __forceinline__ void load_global(float (&t)[C], const float* __restrict__ img,
                                            bool inb, int y, int x, int W) {
  const float* p = img + ((long long)y * W + x) * C;
#pragma unroll
  for (int c = 0; c < C; ++c) t[c] = inb ? code(__ldg(p + c)) : 0.0f;
}

// a thread's n adjacent output pixels: one run of n * C values from o, in
// 16- or 8-byte stores as alignment allows, scalar stores at the ragged edge
template <int C, typename OutT>
__device__ __forceinline__ void store_pixels(OutT* o, const float (&res)[kPx][C], int n) {
  constexpr int kBytes = kPx * C * (int)sizeof(OutT);
  static_assert(kBytes % 8 == 0, "a thread's pixels fill whole 8-byte words");
  const uintptr_t a = reinterpret_cast<uintptr_t>(o);
  if (n == kPx && a % 8 == 0) {
    unsigned w[kBytes / 4];
#pragma unroll
    for (int i = 0; i < kBytes / 4; ++i) {
      if constexpr (sizeof(OutT) == 4) {
        w[i] = __float_as_uint(res[i / C][i % C]);
      } else {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(res[(2 * i) / C][(2 * i) % C],
                                                        res[(2 * i + 1) / C][(2 * i + 1) % C]);
        w[i] = *reinterpret_cast<const unsigned*>(&b2);
      }
    }
    unsigned* d = reinterpret_cast<unsigned*>(o);
    if (kBytes % 16 == 0 && a % 16 == 0) {
#pragma unroll
      for (int i = 0; i < kBytes / 16; ++i)
        reinterpret_cast<uint4*>(d)[i] = make_uint4(w[4 * i], w[4 * i + 1], w[4 * i + 2],
                                                    w[4 * i + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < kBytes / 8; ++i)
        reinterpret_cast<uint2*>(d)[i] = make_uint2(w[2 * i], w[2 * i + 1]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kPx; ++k)
    if (k < n)
#pragma unroll
      for (int c = 0; c < C; ++c) store(o + k * C + c, res[k][c]);
}

template <int C, typename OutT>
__global__ void __launch_bounds__(kThreads)
    warp_perspective_tiles_kernel(const float* __restrict__ src, const float* __restrict__ hs,
                                  OutT* __restrict__ out, int H, int W, int OH, int OW,
                                  int tiles_x, int slack) {
  __shared__ float s_m[9];
  __shared__ Box s_box;
  __shared__ __align__(16) unsigned char s_stage[kStagePixels * Staged<C>::kBytes];
  const int b = blockIdx.y;
  const int ty0 = (int)(blockIdx.x / tiles_x) * kTileH;
  const int tx0 = (int)(blockIdx.x % tiles_x) * kTileW;
  const float* img = src + (long long)b * H * W * C;

  if (threadIdx.x < 32) {
    // warp 0: invert3x3's adjugate in every lane, one division a lane
    const int lane = threadIdx.x;
    const float* h = hs + b * 9;
    const float a = __ldg(h), bb = __ldg(h + 1), c = __ldg(h + 2);
    const float d = __ldg(h + 3), e = __ldg(h + 4), f = __ldg(h + 5);
    const float g = __ldg(h + 6), k = __ldg(h + 7), i = __ldg(h + 8);
    const float adj[9] = {det2(e, i, f, k), det2(c, k, bb, i), det2(bb, f, c, e),
                          det2(f, g, d, i), det2(a, i, c, g), det2(c, d, a, f),
                          det2(d, k, e, g), det2(bb, g, a, k), det2(a, e, bb, d)};
    const float det = __fadd_rn(__fadd_rn(__fmul_rn(a, adj[0]), __fmul_rn(bb, adj[3])),
                                __fmul_rn(c, adj[6]));
    float mine = adj[0];
#pragma unroll
    for (int j = 1; j < 9; ++j) mine = lane == j ? adj[j] : mine;
    if (lane < 9) s_m[lane] = __fdiv_rn(mine, det);
    __syncwarp();
    float m[9];
#pragma unroll
    for (int j = 0; j < 9; ++j) m[j] = s_m[j];
    // corner (lane & 3) of the tile: its last real pixel at a ragged edge
    const float cx = (float)((lane & 1) ? min(tx0 + kTileW, OW) - 1 : tx0);
    const float cy = (float)((lane & 2) ? min(ty0 + kTileH, OH) - 1 : ty0);
    const float den = __fadd_rn(__fadd_rn(__fmul_rn(m[6], cx), __fmul_rn(m[7], cy)), m[8]);
    const float dd = fabsf(den) < 1e-12f ? 1e-12f : den;
    const float sx =
        __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], cx), __fmul_rn(m[1], cy)), m[2]), dd);
    const float sy =
        __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], cx), __fmul_rn(m[4], cy)), m[5]), dd);
    const bool fin = isfinite(sx) && isfinite(sy);
    const bool safe = __all_sync(0xffffffffu, fin && den > 0.0f) ||
                      __all_sync(0xffffffffu, fin && den < 0.0f);
    float lo_x = sx, hi_x = sx, lo_y = sy, hi_y = sy;
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      lo_x = fminf(lo_x, __shfl_xor_sync(0xffffffffu, lo_x, off));
      hi_x = fmaxf(hi_x, __shfl_xor_sync(0xffffffffu, hi_x, off));
      lo_y = fminf(lo_y, __shfl_xor_sync(0xffffffffu, lo_y, off));
      hi_y = fmaxf(hi_y, __shfl_xor_sync(0xffffffffu, hi_y, off));
    }
    if (lane == 0) {
      // the corners' taps widened by slack, clipped to the image and a ring of
      // one pixel around it (staged as 0)
      const float sl = (float)slack;
      const float xl = fmaxf(floorf(lo_x) - sl, -1.0f);
      const float xh = fminf(floorf(hi_x) + 1.0f + sl, (float)W);
      const float yl = fmaxf(floorf(lo_y) - sl, -1.0f);
      const float yh = fminf(floorf(hi_y) + 1.0f + sl, (float)H);
      Box box = {0, 0, 0, 0, 0};
      if (safe && xl <= xh && yl <= yh) {
        const int x0 = (int)xl & ~3;
        const int w = ((int)xh - x0 + 4) & ~3;
        const int pitch = ((w / 4) | 1) * 4;
        const int rows = (int)yh - (int)yl + 1;
        if ((long long)rows * pitch <= kStagePixels) box = {x0, (int)yl, w, rows, pitch};
      }
      s_box = box;
    }
  }
  __syncthreads();
  const Box bx = s_box;
  if (bx.h > 0) {
    const bool vec = (reinterpret_cast<uintptr_t>(src) & 15) == 0 && (W * C) % 4 == 0;
    stage_box<C>(img, H, W, bx, s_stage, vec);
  }
  __syncthreads();

  const int oy = ty0 + (int)threadIdx.x / kLanesX;
  const int ox = tx0 + (int)(threadIdx.x % kLanesX) * kPx;
  if (oy >= OH || ox >= OW) return;
  float m[9];
#pragma unroll
  for (int j = 0; j < 9; ++j) m[j] = s_m[j];
  const float gy = (float)oy;
  const float my0 = __fmul_rn(m[1], gy), my1 = __fmul_rn(m[4], gy), my2 = __fmul_rn(m[7], gy);
  // a pixel reads shared memory where its four taps lie in the box: x0 in
  // [bx.x, bx.x + w - 2], y0 in [bx.y, bx.y + h - 2] (false for NaN)
  const float bx_lo = (float)bx.x, bx_hi = (float)(bx.x + bx.w - 2);
  const float by_lo = (float)bx.y, by_hi = (float)(bx.y + bx.h - 2);
  const int n = min(kPx, OW - ox);
  float res[kPx][C];
#pragma unroll
  for (int k = 0; k < kPx; ++k) {
    if (k >= n) break;
    const float gx = (float)(ox + k);
    float den = __fadd_rn(__fadd_rn(__fmul_rn(m[6], gx), my2), m[8]);
    if (fabsf(den) < 1e-12f) den = 1e-12f;
    const float sx = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[0], gx), my0), m[2]), den);
    const float sy = __fdiv_rn(__fadd_rn(__fadd_rn(__fmul_rn(m[3], gx), my1), m[5]), den);
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float fx = __fsub_rn(sx, x0);
    const float fy = __fsub_rn(sy, y0);
    const float gfx = __fsub_rn(1.0f, fx);
    const float gfy = __fsub_rn(1.0f, fy);
    float t[4][C];
    if (x0 >= bx_lo && x0 <= bx_hi && y0 >= by_lo && y0 <= by_hi) {
      const unsigned char* s = s_stage + (((int)y0 - bx.y) * bx.pitch + ((int)x0 - bx.x)) *
                                             Staged<C>::kBytes;
      const int down = bx.pitch * Staged<C>::kBytes;
      load_staged<C>(t[0], s);
      load_staged<C>(t[1], s + Staged<C>::kBytes);
      load_staged<C>(t[2], s + down);
      load_staged<C>(t[3], s + down + Staged<C>::kBytes);
    } else {
      // in-bounds tests on the float coordinates, as the float32 kernel's
      const float x1 = x0 + 1.0f;
      const float y1 = y0 + 1.0f;
      const bool inx0 = x0 >= 0.0f && x0 < (float)W;
      const bool inx1 = x1 >= 0.0f && x1 < (float)W;
      const bool iny0 = y0 >= 0.0f && y0 < (float)H;
      const bool iny1 = y1 >= 0.0f && y1 < (float)H;
      const int xi0 = inx0 ? (int)x0 : 0;
      const int xi1 = inx1 ? (int)x1 : 0;
      const int yi0 = iny0 ? (int)y0 : 0;
      const int yi1 = iny1 ? (int)y1 : 0;
      load_global<C>(t[0], img, iny0 && inx0, yi0, xi0, W);
      load_global<C>(t[1], img, iny0 && inx1, yi0, xi1, W);
      load_global<C>(t[2], img, iny1 && inx0, yi1, xi0, W);
      load_global<C>(t[3], img, iny1 && inx1, yi1, xi1, W);
    }
    const float wx0 = rintf(__fmul_rn(gfx, 127.0f));
    const float wx1 = rintf(__fmul_rn(fx, 127.0f));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a0 = code_row_sum(t[0][c], t[1][c], wx0, wx1);
      const float a1 = code_row_sum(t[2][c], t[3][c], wx0, wx1);
      res[k][c] = __fadd_rn(__fmul_rn(a0, gfy), __fmul_rn(a1, fy));
    }
  }
  store_pixels<C, OutT>(out + (((long long)b * OH + oy) * OW + ox) * C, res, n);
}

template <int MODE, typename OutT>
int launch(const float* src, const float* hs, void* out, int B, int H, int W, int C, int OH,
           int OW, cudaStream_t stream) {
  long long pixels = (long long)OH * OW;
  const int threads = 256;
  dim3 grid((unsigned int)((pixels + threads - 1) / threads), (unsigned int)B);
  OutT* o = static_cast<OutT*>(out);
  switch (C) {
    case 1:
      warp_perspective_kernel<1, MODE, OutT><<<grid, threads, 0, stream>>>(src, hs, o, H, W, OH, OW);
      break;
    case 2:
      warp_perspective_kernel<2, MODE, OutT><<<grid, threads, 0, stream>>>(src, hs, o, H, W, OH, OW);
      break;
    case 3:
      warp_perspective_kernel<3, MODE, OutT><<<grid, threads, 0, stream>>>(src, hs, o, H, W, OH, OW);
      break;
    default:
      warp_perspective_kernel<4, MODE, OutT><<<grid, threads, 0, stream>>>(src, hs, o, H, W, OH, OW);
  }
  return (int)cudaGetLastError();
}

template <int C, typename OutT>
int launch_tiles_c(const float* src, const float* hs, void* out, int B, int H, int W, int OH,
                   int OW, cudaStream_t stream) {
  const int tiles_x = (OW + kTileW - 1) / kTileW;
  const long long tiles = (long long)tiles_x * ((OH + kTileH - 1) / kTileH);
  if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  warp_perspective_tiles_kernel<C, OutT>
      <<<dim3((unsigned int)tiles, (unsigned int)B), kThreads, 0, stream>>>(
          src, hs, static_cast<OutT*>(out), H, W, OH, OW, tiles_x, g_box_slack);
  return (int)cudaGetLastError();
}

template <typename OutT>
int launch_tiles(const float* src, const float* hs, void* out, int B, int H, int W, int C,
                 int OH, int OW, cudaStream_t stream) {
  switch (C) {
    case 1:
      return launch_tiles_c<1, OutT>(src, hs, out, B, H, W, OH, OW, stream);
    case 2:
      return launch_tiles_c<2, OutT>(src, hs, out, B, H, W, OH, OW, stream);
    case 3:
      return launch_tiles_c<3, OutT>(src, hs, out, B, H, W, OH, OW, stream);
    default:
      return launch_tiles_c<4, OutT>(src, hs, out, B, H, W, OH, OW, stream);
  }
}

template <int MODE>
int warp(const float* src, const float* hs, void* out, int B, int H, int W, int C, int OH,
         int OW, int out_bf16, cudaStream_t stream) {
  if (B > 65535 || C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  if (B == 0 || (long long)OH * OW == 0) return 0;
  return out_bf16 ? launch<MODE, __nv_bfloat16>(src, hs, out, B, H, W, C, OH, OW, stream)
                  : launch<MODE, float>(src, hs, out, B, H, W, C, OH, OW, stream);
}

}  // namespace

// out is float32, or bfloat16 where out_bf16 is nonzero
extern "C" int pfr_warp_perspective_batch(const float* src, const float* hs, void* out,
                                          int B, int H, int W, int C, int OH, int OW,
                                          int out_bf16, cudaStream_t stream) {
  return warp<kF32>(src, hs, out, B, H, W, C, OH, OW, out_bf16, stream);
}

extern "C" int pfr_warp_perspective_batch_bf16(const float* src, const float* hs, void* out,
                                               int B, int H, int W, int C, int OH, int OW,
                                               int out_bf16, cudaStream_t stream) {
  return warp<kBF16>(src, hs, out, B, H, W, C, OH, OW, out_bf16, stream);
}

extern "C" int pfr_warp_perspective_batch_int8(const float* src, const float* hs, void* out,
                                               int B, int H, int W, int C, int OH, int OW,
                                               int out_bf16, cudaStream_t stream) {
  if (B > 65535 || C < 1 || C > 4) return (int)cudaErrorInvalidValue;
  if (B == 0 || (long long)OH * OW == 0) return 0;
  return out_bf16 ? launch_tiles<__nv_bfloat16>(src, hs, out, B, H, W, C, OH, OW, stream)
                  : launch_tiles<float>(src, hs, out, B, H, W, C, OH, OW, stream);
}

// Test hook, not part of K1's interface: the int8 instance's box widening in
// pixels for the launches that follow (kBoxSlack until set). A negative value
// shrinks the boxes, so that taps fall outside them and read global memory,
// which gives the same numbers; a check sets it back to kBoxSlack after use.
extern "C" int pfr_warp_int8_test_box_slack(int slack) {
  g_box_slack = slack;
  return 0;
}
