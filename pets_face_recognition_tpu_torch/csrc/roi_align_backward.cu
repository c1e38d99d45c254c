// K4: gradient of the FPN multilevel RoIAlign (K3) with respect to each level.
//
// Replaces pets_face_recognition_tpu/ops/pallas_roi_align.py::_roi_backward
// (Pallas body _roi_bwd_level_kernel, the backward of
// multilevel_roi_align_pallas_diff). The RoIs and batch indices get no
// gradient, as in the JAX custom VJP and in torchvision. This is the exact
// gradient of K3: output cell (i, j) of RoI k is the mean of S x S bilinear
// samples, so each sample adds g[k, i, j, c] / S^2 times each of its four tap
// weights into the taps of its level (roi_align_common.cuh, the same geometry
// and rounding as K3 and as ops/roi_align.py::multilevel_roi_align_backward).
// The TPU form (per-level window matmuls accumulated in VMEM across a sequential
// grid, with wide RoIs clamped to the window) is not carried over.
//
// Bound: bytes. Each (RoI, cell, channel) reads g once and makes 4 * S^2
// read-modify-writes into the level gradients; the per-image levels (p2 of a
// 640x640 image: 160 x 160 x 256 floats, 26 MB) mostly stay in the 50 MB L2, so
// the floor is the g read plus one write of every level. Design: the launcher
// zeroes the level gradients (cudaMemsetAsync), then one block per (RoI, output
// cell), threads over channels, adds with float atomicAdd; neighbouring threads
// hit neighbouring NHWC addresses, so a warp's 32 atomics fall in one 128-byte
// segment and coalesce in L2. Float atomics sum in an order that changes from run
// to run, so the result is not bit-stable (torchvision's roi_align backward
// behaves the same way); it agrees with the plain version to float32 rounding
// of a short sum (held at 1e-4 absolute on the card). A deterministic segmented
// reduction is later work.

#include <cuda_runtime.h>

#include "roi_align_common.cuh"

namespace {

using pfr_roi::kMaxLevels;

struct LevelGrads {
  float* data[kMaxLevels];
};

__global__ void multilevel_roi_align_backward_kernel(
    const float* __restrict__ g, LevelGrads lg, pfr_roi::Pyramid pyr, int C,
    const float* __restrict__ rois, const int* __restrict__ batch_idx,
    const int* __restrict__ level, int OH, int OW, int S) {
  const int k = blockIdx.x;
  const int ph = blockIdx.y / OW;
  const int pw = blockIdx.y % OW;
  const int l = level[k];
  const int H = pyr.H[l];
  const int W = pyr.W[l];
  float* f = lg.data[l] + (long long)batch_idx[k] * H * W * C;
  const pfr_roi::RoiGeom r = pfr_roi::roi_geom(rois, k, pyr.scale[l], OH, OW);
  const float n_samples = (float)(S * S);
  const float* gk = g + (((long long)k * OH + ph) * OW + pw) * C;

  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float gs = __fdiv_rn(__ldg(gk + c), n_samples);
    for (int sy = 0; sy < S; ++sy) {
      float yy = pfr_roi::sample_pos(r.y1, ph, sy, S, r.bin_h);
      for (int sx = 0; sx < S; ++sx) {
        float xx = pfr_roi::sample_pos(r.x1, pw, sx, S, r.bin_w);
        pfr_roi::Tap t = pfr_roi::make_tap(yy, xx, H, W);
        if (t.oob) continue;
        atomicAdd(f + ((long long)t.y_low * W + t.x_low) * C + c, __fmul_rn(gs, t.w00));
        atomicAdd(f + ((long long)t.y_low * W + t.x_high) * C + c, __fmul_rn(gs, t.w01));
        atomicAdd(f + ((long long)t.y_high * W + t.x_low) * C + c, __fmul_rn(gs, t.w10));
        atomicAdd(f + ((long long)t.y_high * W + t.x_high) * C + c, __fmul_rn(gs, t.w11));
      }
    }
  }
}

}  // namespace

extern "C" int pfr_multilevel_roi_align_backward(
    const float* g, float* d0, float* d1, float* d2, float* d3,
    int h0, int h1, int h2, int h3, int w0, int w1, int w2, int w3,
    int stride0, int stride1, int stride2, int stride3, int n_levels, int B, int C,
    const float* rois, const int* batch_idx, const int* level, int K, int OH,
    int OW, int sampling_ratio, cudaStream_t stream) {
  if (n_levels < 1 || n_levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int hs[kMaxLevels] = {h0, h1, h2, h3};
  const int ws[kMaxLevels] = {w0, w1, w2, w3};
  const int st[kMaxLevels] = {stride0, stride1, stride2, stride3};
  LevelGrads lg = {{d0, d1, d2, d3}};
  for (int i = 0; i < n_levels; ++i) {
    size_t bytes = (size_t)B * hs[i] * ws[i] * C * sizeof(float);
    cudaError_t err = cudaMemsetAsync(lg.data[i], 0, bytes, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (K == 0) return 0;
  pfr_roi::Pyramid pyr = pfr_roi::make_pyramid(hs, ws, st);
  int threads = C >= 256 ? 256 : ((C + 31) / 32) * 32;
  dim3 grid((unsigned int)K, (unsigned int)(OH * OW));
  multilevel_roi_align_backward_kernel<<<grid, threads, 0, stream>>>(
      g, lg, pyr, C, rois, batch_idx, level, OH, OW, sampling_ratio);
  return (int)cudaGetLastError();
}
