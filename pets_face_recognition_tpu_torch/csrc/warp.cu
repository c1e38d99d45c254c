// K1: batched projective inverse warp, 4-tap bilinear, zero border.
//
// Replaces pets_face_recognition_tpu/ops/pallas_warp.py::warp_affine_batch_pallas
// (Pallas body _warp_kernel). Output pixel (x, y) of image b samples the source
// at Hinv[b] @ (x, y, 1) with bilinear interpolation and zero outside the image
// (cv2 BORDER_CONSTANT), exactly as ops/homography.py::warp_perspective does.
// The TPU kernel's band clamp, chunk-skip flags, channel planes, images per
// program and int8 tents are not carried over: this kernel computes the exact op.
//
// Bound: memory. Per image it must read the source once (H*W*C*4 bytes) and
// write the 224*224*C*4-byte crop; its arithmetic is ~50 flops per pixel. Design:
// one thread per output pixel handling all C channels (C <= 4), NHWC in and out,
// so a warp writes a contiguous run of the crop; taps are read through the
// read-only cache. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn) in the order of the plain PyTorch version, so the kernel gives the
// plain version's numbers to the bit on the same inputs.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float tap(const float* __restrict__ img, bool inb,
                                     int y, int x, int W, int C, int c) {
  return inb ? __ldg(img + ((long long)y * W + x) * C + c) : 0.0f;
}

__global__ void warp_perspective_kernel(const float* __restrict__ src,
                                        const float* __restrict__ hinv,
                                        float* __restrict__ out, int B, int H,
                                        int W, int C, int OH, int OW) {
  long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  long long total = (long long)B * OH * OW;
  if (idx >= total) return;
  int j = (int)(idx % OW);
  int i = (int)((idx / OW) % OH);
  int b = (int)(idx / ((long long)OH * OW));
  const float* m = hinv + b * 9;
  float gx = (float)j;
  float gy = (float)i;

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
  float w00 = __fmul_rn(gfy, gfx);
  float w01 = __fmul_rn(gfy, fx);
  float w10 = __fmul_rn(fy, gfx);
  float w11 = __fmul_rn(fy, fx);

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
  float* o = out + idx * C;
  for (int c = 0; c < C; ++c) {
    float t00 = tap(img, iny0 && inx0, yi0, xi0, W, C, c);
    float t01 = tap(img, iny0 && inx1, yi0, xi1, W, C, c);
    float t10 = tap(img, iny1 && inx0, yi1, xi0, W, C, c);
    float t11 = tap(img, iny1 && inx1, yi1, xi1, W, C, c);
    float v = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(t00, w00), __fmul_rn(t01, w01)),
                  __fmul_rn(t10, w10)),
        __fmul_rn(t11, w11));
    o[c] = v;
  }
}

}  // namespace

extern "C" int pfr_warp_perspective_batch(const float* src, const float* hinv,
                                          float* out, int B, int H, int W,
                                          int C, int OH, int OW,
                                          cudaStream_t stream) {
  long long total = (long long)B * OH * OW;
  if (total == 0) return 0;
  const int threads = 256;
  unsigned int blocks = (unsigned int)((total + threads - 1) / threads);
  warp_perspective_kernel<<<blocks, threads, 0, stream>>>(src, hinv, out, B, H,
                                                          W, C, OH, OW);
  return (int)cudaGetLastError();
}
