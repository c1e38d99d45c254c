// K3: FPN multilevel RoIAlign forward (torchvision aligned=False semantics).
//
// Replaces pets_face_recognition_tpu/ops/pallas_roi_align.py::
// multilevel_roi_align_pallas (Pallas body _roi_kernel). Each RoI pools from the
// pyramid level that the canonical mapper assigned it (computed by the wrapper
// with ops/roi_align.py::roi_levels, the same function the plain version uses).
// Output cell (i, j) is the mean of S x S bilinear samples at
// y1 + (i + (p + .5) / S) * bin_h; a sample with pos <= -1 or pos >= limit gives
// 0, low positions clamp to 0 and high ones to limit - 1, as in
// ops/roi_align.py::multilevel_roi_align. The TPU kernel's fixed 40x48 windows,
// which clamp wide RoIs, are not carried over: every RoI is pooled exactly.
//
// Bound: memory, on the sampled reads (4 taps x S*S samples per output cell and
// channel, mostly L2 hits) and the (K, OH, OW, C) write. Design: one block per
// (RoI, output cell), threads over channels, so neighbouring threads read
// neighbouring addresses of the NHWC level and write neighbouring outputs;
// accumulation is float32. Products and sums are rounded on their own, in the
// plain version's order.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 4;

struct Pyramid {
  const float* data[kMaxLevels];
  int H[kMaxLevels];
  int W[kMaxLevels];
  float scale[kMaxLevels];  // 1 / stride, rounded to float32
};

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

__global__ void multilevel_roi_align_kernel(Pyramid pyr, int C,
                                            const float* __restrict__ rois,
                                            const int* __restrict__ batch_idx,
                                            const int* __restrict__ level,
                                            int OH, int OW, int S,
                                            float* __restrict__ out) {
  const int k = blockIdx.x;
  const int ph = blockIdx.y / OW;
  const int pw = blockIdx.y % OW;
  const int l = level[k];
  const int H = pyr.H[l];
  const int W = pyr.W[l];
  const float scale = pyr.scale[l];
  const float* f = pyr.data[l] + (long long)batch_idx[k] * H * W * C;

  float x1 = __fmul_rn(rois[4 * k], scale);
  float y1 = __fmul_rn(rois[4 * k + 1], scale);
  float x2 = __fmul_rn(rois[4 * k + 2], scale);
  float y2 = __fmul_rn(rois[4 * k + 3], scale);
  float roi_w = fmaxf(__fsub_rn(x2, x1), 1.0f);
  float roi_h = fmaxf(__fsub_rn(y2, y1), 1.0f);
  float bin_h = __fdiv_rn(roi_h, (float)OH);
  float bin_w = __fdiv_rn(roi_w, (float)OW);
  const float n_samples = (float)(S * S);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int sy = 0; sy < S; ++sy) {
      float py = __fadd_rn((float)ph, __fdiv_rn(__fadd_rn((float)sy, 0.5f), (float)S));
      float yy = __fadd_rn(y1, __fmul_rn(py, bin_h));
      for (int sx = 0; sx < S; ++sx) {
        float px = __fadd_rn((float)pw, __fdiv_rn(__fadd_rn((float)sx, 0.5f), (float)S));
        float xx = __fadd_rn(x1, __fmul_rn(px, bin_w));
        Tap t = make_tap(yy, xx, H, W);
        float v = 0.0f;
        if (!t.oob) {
          float a = __ldg(f + ((long long)t.y_low * W + t.x_low) * C + c);
          float b = __ldg(f + ((long long)t.y_low * W + t.x_high) * C + c);
          float d = __ldg(f + ((long long)t.y_high * W + t.x_low) * C + c);
          float e = __ldg(f + ((long long)t.y_high * W + t.x_high) * C + c);
          v = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, t.w00), __fmul_rn(b, t.w01)),
                                  __fmul_rn(d, t.w10)),
                        __fmul_rn(e, t.w11));
        }
        acc = __fadd_rn(acc, v);
      }
    }
    out[(((long long)k * OH + ph) * OW + pw) * C + c] = __fdiv_rn(acc, n_samples);
  }
}

}  // namespace

extern "C" int pfr_multilevel_roi_align(
    const float* p0, const float* p1, const float* p2, const float* p3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int C,
    const float* rois, const int* batch_idx, const int* level, int K, int OH,
    int OW, int sampling_ratio, float* out, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  Pyramid pyr;
  const float* ps[kMaxLevels] = {p0, p1, p2, p3};
  int hs[kMaxLevels] = {h0, h1, h2, h3};
  int ws[kMaxLevels] = {w0, w1, w2, w3};
  int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  for (int i = 0; i < kMaxLevels; ++i) {
    pyr.data[i] = ps[i];
    pyr.H[i] = hs[i];
    pyr.W[i] = ws[i];
    pyr.scale[i] = st[i] > 0 ? (float)(1.0 / (double)st[i]) : 0.0f;
  }
  int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid((unsigned int)K, (unsigned int)(OH * OW));
  multilevel_roi_align_kernel<<<grid, threads, 0, stream>>>(
      pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, out);
  return (int)cudaGetLastError();
}
