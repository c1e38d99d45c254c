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
// channel, mostly L2 hits) and the (K, OH, OW, C) write. Design: one block per
// (RoI, output cell), threads over channels, so neighbouring threads read
// neighbouring addresses of the NHWC level and write neighbouring outputs;
// accumulation is float32. Products and sums are rounded on their own, in the
// plain version's order.

#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;

struct Levels {
  const float* data[kMaxLevels];
};

__global__ void multilevel_roi_align_kernel(Levels lv, pfr_roi::Pyramid pyr, int C,
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
  const float* f = lv.data[l] + (long long)batch_idx[k] * H * W * C;
  const pfr_roi::RoiGeom r = pfr_roi::roi_geom(rois, k, pyr.scale[l], OH, OW);
  const float n_samples = (float)(S * S);

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float acc = 0.0f;
    for (int sy = 0; sy < S; ++sy) {
      float yy = pfr_roi::sample_pos(r.y1, ph, sy, S, r.bin_h);
      for (int sx = 0; sx < S; ++sx) {
        float xx = pfr_roi::sample_pos(r.x1, pw, sx, S, r.bin_w);
        pfr_roi::Tap t = pfr_roi::make_tap(yy, xx, H, W);
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
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  Levels lv = {{p0, p1, p2, p3}};
  pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid((unsigned int)K, (unsigned int)(OH * OW));
  multilevel_roi_align_kernel<<<grid, threads, 0, stream>>>(
      lv, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio, out);
  return (int)cudaGetLastError();
}
