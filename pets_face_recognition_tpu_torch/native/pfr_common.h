// What the two JPEG decoders of this folder share (pfr_native.cpp: libjpeg on
// the host; pfr_nvjpeg.cpp: nvJPEG on the GPU): the bilinear letterbox and the
// thread pool of the batch call, so that both export one C ABI
// (pfr_decode_batch, pfr_decode_single) with the same geometry; and libjpeg's
// own reconstruction of RGB from decoded YCbCr planes, so that the nvJPEG
// route rebuilds its pixels as libjpeg (and so PIL) does.
//
// Letterbox geometry matches utils/collate.letterbox_image: scale = min(H/h, W/w), new
// size = round(h*scale), round(w*scale), pad = (dim - new)/2 floor; the image
// sits at (pad_y, pad_x) of a zero canvas.

#pragma once

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace pfr {

inline void letterbox_into(const uint8_t* src, int sw, int sh, uint8_t* out,
                           int out_w, int out_h, float* scale_out,
                           float* pad_x_out, float* pad_y_out) {
  const float scale = std::min(static_cast<float>(out_h) / sh,
                               static_cast<float>(out_w) / sw);
  const int nw = std::max(1, static_cast<int>(std::lround(sw * scale)));
  const int nh = std::max(1, static_cast<int>(std::lround(sh * scale)));
  const int pad_x = (out_w - nw) / 2;
  const int pad_y = (out_h - nh) / 2;
  *scale_out = scale;
  *pad_x_out = static_cast<float>(pad_x);
  *pad_y_out = static_cast<float>(pad_y);

  std::memset(out, 0, static_cast<size_t>(out_w) * out_h * 3);

  // cv2.INTER_LINEAR convention: src = (dst + 0.5) * (s / n) - 0.5
  const float fx = static_cast<float>(sw) / nw;
  const float fy = static_cast<float>(sh) / nh;
  for (int y = 0; y < nh; ++y) {
    float sy = (y + 0.5f) * fy - 0.5f;
    sy = std::max(0.0f, std::min(sy, static_cast<float>(sh - 1)));
    const int y0 = static_cast<int>(sy);
    const int y1 = std::min(y0 + 1, sh - 1);
    const float wy = sy - y0;
    uint8_t* dst_row = out + (static_cast<size_t>(y + pad_y) * out_w + pad_x) * 3;
    const uint8_t* row0 = src + static_cast<size_t>(y0) * sw * 3;
    const uint8_t* row1 = src + static_cast<size_t>(y1) * sw * 3;
    for (int x = 0; x < nw; ++x) {
      float sx = (x + 0.5f) * fx - 0.5f;
      sx = std::max(0.0f, std::min(sx, static_cast<float>(sw - 1)));
      const int x0 = static_cast<int>(sx);
      const int x1 = std::min(x0 + 1, sw - 1);
      const float wx = sx - x0;
      for (int c = 0; c < 3; ++c) {
        const float top = row0[x0 * 3 + c] * (1 - wx) + row0[x1 * 3 + c] * wx;
        const float bot = row1[x0 * 3 + c] * (1 - wx) + row1[x1 * 3 + c] * wx;
        dst_row[x * 3 + c] =
            static_cast<uint8_t>(std::lround(top * (1 - wy) + bot * wy));
      }
    }
  }
}

// One plane of `width` x `height` samples, rows `pitch` bytes apart.
struct Plane {
  const uint8_t* data;
  int width;
  int height;
  size_t pitch;
};

// Upsample a chroma plane by (hf, vf) in {1, 2}^2 to out (out_w x out_h,
// cropped) as libjpeg does by default (jdsample.c): "fancy" triangle filters
// (h2v1, h1v2, h2v2_fancy_upsample) with their rounding biases, the rows
// beyond the plane's top and bottom edges replicated (jdmainct.c), and plain
// replication where libjpeg uses it (a plane at most 2 samples wide, for h2).
inline void upsample_plane(const Plane& in, int hf, int vf, int out_w,
                           int out_h, uint8_t* out) {
  const int iw = in.width;
  const bool fancy_h = hf == 2 && iw > 2;
  const bool fancy_v = vf == 2 && (hf == 1 || iw > 2);
  std::vector<int> colsum(iw);
  std::vector<uint8_t> row(static_cast<size_t>(iw) * hf);
  for (int oy = 0; oy < out_h; ++oy) {
    const int r = std::min(oy / vf, in.height - 1);
    const uint8_t* in0 = in.data + static_cast<size_t>(r) * in.pitch;
    uint8_t* dst = row.data();
    if (!fancy_v) {
      if (fancy_h) {  // h2v1_fancy_upsample
        int v = in0[0];
        dst[0] = static_cast<uint8_t>(v);
        dst[1] = static_cast<uint8_t>((v * 3 + in0[1] + 2) >> 2);
        for (int c = 1; c < iw - 1; ++c) {
          v = in0[c] * 3;
          dst[2 * c] = static_cast<uint8_t>((v + in0[c - 1] + 1) >> 2);
          dst[2 * c + 1] = static_cast<uint8_t>((v + in0[c + 1] + 2) >> 2);
        }
        v = in0[iw - 1];
        dst[2 * iw - 2] = static_cast<uint8_t>((v * 3 + in0[iw - 2] + 1) >> 2);
        dst[2 * iw - 1] = static_cast<uint8_t>(v);
      } else {  // no upsampling, or plain replication
        for (int c = 0; c < iw; ++c)
          for (int k = 0; k < hf; ++k) dst[c * hf + k] = in0[c];
      }
    } else {
      // the nearer input row is r, the further one above (even output rows)
      // or below (odd output rows), the edge rows replicated
      const bool below = oy % 2 == 1;
      const int r1 = below ? std::min(r + 1, in.height - 1) : std::max(r - 1, 0);
      const uint8_t* in1 = in.data + static_cast<size_t>(r1) * in.pitch;
      for (int c = 0; c < iw; ++c) colsum[c] = in0[c] * 3 + in1[c];
      if (hf == 1) {  // h1v2_fancy_upsample
        const int bias = below ? 2 : 1;
        for (int c = 0; c < iw; ++c)
          dst[c] = static_cast<uint8_t>((colsum[c] + bias) >> 2);
      } else {  // h2v2_fancy_upsample
        int cur = colsum[0];
        dst[0] = static_cast<uint8_t>((cur * 4 + 8) >> 4);
        dst[1] = static_cast<uint8_t>((cur * 3 + colsum[1] + 7) >> 4);
        for (int c = 1; c < iw - 1; ++c) {
          cur = colsum[c];
          dst[2 * c] = static_cast<uint8_t>((cur * 3 + colsum[c - 1] + 8) >> 4);
          dst[2 * c + 1] = static_cast<uint8_t>((cur * 3 + colsum[c + 1] + 7) >> 4);
        }
        cur = colsum[iw - 1];
        dst[2 * iw - 2] = static_cast<uint8_t>((cur * 3 + colsum[iw - 2] + 8) >> 4);
        dst[2 * iw - 1] = static_cast<uint8_t>((cur * 4 + 7) >> 4);
      }
    }
    std::memcpy(out + static_cast<size_t>(oy) * out_w, row.data(),
                std::min<size_t>(out_w, row.size()));
  }
}

// Interleaved RGB (width x height) from a Y plane and, unless gray, Cb and Cr
// planes subsampled by (hf, vf): libjpeg's upsampling (above) and its
// fixed-point ycc_rgb_convert (jdcolor.c: 16-bit tables, results clamped to
// [0, 255]); a gray image's Y goes to all three channels.
inline void ycc_to_rgb(const Plane& y, const Plane* cb, const Plane* cr,
                       int hf, int vf, int width, int height, uint8_t* rgb) {
  const size_t n = static_cast<size_t>(width) * height;
  if (cb == nullptr) {
    for (int r = 0; r < height; ++r)
      for (int c = 0; c < width; ++c) {
        const uint8_t v = y.data[static_cast<size_t>(r) * y.pitch + c];
        uint8_t* o = rgb + (static_cast<size_t>(r) * width + c) * 3;
        o[0] = o[1] = o[2] = v;
      }
    return;
  }
  std::vector<uint8_t> up_cb(n), up_cr(n);
  upsample_plane(*cb, hf, vf, width, height, up_cb.data());
  upsample_plane(*cr, hf, vf, width, height, up_cr.data());
  constexpr int kBits = 16;
  constexpr int64_t kHalf = int64_t{1} << (kBits - 1);
  auto fix = [](double x) { return static_cast<int64_t>(x * (1 << kBits) + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0; i < 256; ++i) {
    const int64_t x = i - 128;
    cr_r[i] = static_cast<int>((fix(1.40200) * x + kHalf) >> kBits);
    cb_b[i] = static_cast<int>((fix(1.77200) * x + kHalf) >> kBits);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + kHalf;
  }
  auto clamp = [](int v) { return static_cast<uint8_t>(std::min(255, std::max(0, v))); };
  for (int r = 0; r < height; ++r) {
    const uint8_t* yr = y.data + static_cast<size_t>(r) * y.pitch;
    for (int c = 0; c < width; ++c) {
      const size_t i = static_cast<size_t>(r) * width + c;
      const int yy = yr[c], b = up_cb[i], rr = up_cr[i];
      uint8_t* o = rgb + i * 3;
      o[0] = clamp(yy + cr_r[rr]);
      o[1] = clamp(yy + static_cast<int>((cb_g[b] + cr_g[rr]) >> kBits));
      o[2] = clamp(yy + cb_b[b]);
    }
  }
}

// Decode `n` files with `decode(path, target_min_side, &pixels, &w, &h)` on a
// pool of `num_threads` threads (0: one per core) and letterbox each into
// out (n, out_h, out_w, 3). ok[i] = 1 where image i decoded; a failed slot is
// zeroed. Returns the number decoded.
template <typename Decode>
int decode_batch(const char** paths, int n, uint8_t* out, int out_w, int out_h,
                 uint8_t* ok, float* scales, float* pads, int num_threads,
                 Decode decode) {
  if (num_threads <= 0) {
    num_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (num_threads <= 0) num_threads = 4;
  }
  std::atomic<int> next(0);
  std::atomic<int> n_ok(0);
  const size_t img_bytes = static_cast<size_t>(out_w) * out_h * 3;
  const int target_min = std::min(out_w, out_h);

  auto worker = [&]() {
    std::vector<uint8_t> pixels;
    int w = 0, h = 0;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      ok[i] = 0;
      scales[i] = 0.0f;
      pads[i * 2] = pads[i * 2 + 1] = 0.0f;
      if (!decode(paths[i], target_min, &pixels, &w, &h)) {
        std::memset(out + i * img_bytes, 0, img_bytes);
        continue;
      }
      letterbox_into(pixels.data(), w, h, out + i * img_bytes, out_w, out_h,
                     &scales[i], &pads[i * 2], &pads[i * 2 + 1]);
      ok[i] = 1;
      n_ok.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  const int pool = std::min(num_threads, n);
  threads.reserve(pool);
  for (int t = 0; t < pool; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return n_ok.load();
}

}  // namespace pfr
