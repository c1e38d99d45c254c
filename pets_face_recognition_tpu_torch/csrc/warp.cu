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
// 287-292), one template instance and one extern "C" symbol each:
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
// Bound: memory. Per image it must read the source once (H*W*C*4 bytes) and
// write the 224*224*C*4-byte crop; its arithmetic is ~50 flops per pixel. Design:
// one launch per call, nothing before it (a separate batched inverse, a library
// LU of several launches and host work, made the wrapper 4.4x slower than
// grid_sample). A block covers 256 output pixels of one image (grid.y is the
// image); its first thread inverts the image's 3x3 by the closed form
// (adjugate over determinant) into shared memory, which timed faster on an
// H100 than every thread inverting. One thread per output pixel handles all C
// channels (C <= 4, a template parameter, so the 4*C tap loads are issued
// together rather than one channel's latency after another, which also timed
// faster), NHWC in and out, so a warp writes a
// contiguous run of the crop; taps are read through the read-only cache. Every
// product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn) in the order of the plain PyTorch version
// (ops/homography.py::invert_homographies and warp_perspective_batch), so the
// kernel gives the plain version's numbers to the bit on the same inputs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

enum Mode { kF32 = 0, kBF16 = 1, kInt8 = 2 };

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

// the int8 mode's quantized pixel: clip(rint(127 p), 0, 127)
__device__ __forceinline__ int quant_pixel(float p) {
  return (int)fminf(fmaxf(rintf(__fmul_rn(p, 127.0f)), 0.0f), 127.0f);
}

// one source row's two taps (a at x0, b at x0 + 1) with their x-tents
template <int MODE>
__device__ __forceinline__ float row_sum(float a, float b, float wx0, float wx1) {
  if (MODE == kBF16)
    return __fadd_rn(__fmul_rn(round_bf16(a), wx0), __fmul_rn(round_bf16(b), wx1));
  // kInt8: wx0, wx1 hold rint(127 wx); the integer sum is exact in float32
  const int s = quant_pixel(a) * (int)wx0 + quant_pixel(b) * (int)wx1;
  return __fmul_rn((float)s, 1.0f / 16129.0f);
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
    const float wx0 = MODE == kBF16 ? round_bf16(gfx) : rintf(__fmul_rn(gfx, 127.0f));
    const float wx1 = MODE == kBF16 ? round_bf16(fx) : rintf(__fmul_rn(fx, 127.0f));
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float a0 = row_sum<MODE>(t[0][c], t[1][c], wx0, wx1);
      const float a1 = row_sum<MODE>(t[2][c], t[3][c], wx0, wx1);
      store(o + c, __fadd_rn(__fmul_rn(a0, gfy), __fmul_rn(a1, fy)));
    }
  }
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
  return warp<kInt8>(src, hs, out, B, H, W, C, OH, OW, out_bf16, stream);
}
