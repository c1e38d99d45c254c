// pfr_native (libjpeg route): threaded JPEG decode + letterbox on the host,
// and JPEG encode.
//
// Decodes a batch of JPEG files on a thread pool straight into one
// preallocated uint8 NHWC array, letterboxed to a fixed (H, W) with the
// geometry of utils/collate.letterbox_image, and returns each image's
// scale and pads so that points can be mapped back.
//
// Fast path: libjpeg's scale_denom DCT downscaling picks the largest 1/1,
// 1/2, 1/4, 1/8 factor whose output still covers the target, so a 4000 px
// photo headed for 320 px decodes ~8x cheaper before the bilinear pass.
//
// The encoder is PIL's default JPEG save: libjpeg's defaults (baseline,
// integer DCT, 4:2:0 chroma) at a given quality, 75 when PIL is given none.
//
// C ABI only (ctypes), shared with pfr_nvjpeg.cpp.

#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "pfr_common.h"

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG file to RGB. Returns true on success; the image buffer and
// its dimensions come back through the out params.
bool decode_jpeg_file(const char* path, int target_min_side,
                      std::vector<uint8_t>* pixels, int* width, int* height) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;

  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    std::fclose(f);
    return false;
  }

  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);

  // DCT-domain downscale: largest denom whose output still covers the target.
  if (target_min_side > 0) {
    const int full_min = std::min<int>(cinfo.image_width, cinfo.image_height);
    int denom = 1;
    while (denom < 8 && full_min / (denom * 2) >= target_min_side) denom *= 2;
    cinfo.scale_num = 1;
    cinfo.scale_denom = denom;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);

  *width = cinfo.output_width;
  *height = cinfo.output_height;
  const int stride = cinfo.output_width * cinfo.output_components;
  pixels->resize(static_cast<size_t>(stride) * cinfo.output_height);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = pixels->data() +
                   static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  std::fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Decode `n` JPEG files into `out` (n, out_h, out_w, 3) uint8 with letterbox.
// paths: n C strings. ok: n bytes, 1 = decoded. scales / pads: per-image
// geometry (n floats / n*2 floats). Returns the number decoded.
int pfr_decode_batch(const char** paths, int n, uint8_t* out, int out_w,
                     int out_h, uint8_t* ok, float* scales, float* pads,
                     int num_threads) {
  return pfr::decode_batch(paths, n, out, out_w, out_h, ok, scales, pads,
                           num_threads, decode_jpeg_file);
}

// Decode a single JPEG at full (or DCT-downscaled) resolution into a caller
// buffer; call with out == nullptr to query width/height first.
int pfr_decode_single(const char* path, uint8_t* out, int* width, int* height,
                      int target_min_side) {
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_jpeg_file(path, target_min_side, &pixels, &w, &h)) return 0;
  *width = w;
  *height = h;
  if (out != nullptr) std::memcpy(out, pixels.data(), pixels.size());
  return 1;
}

// Encode an (height, width, 3) uint8 RGB image as a baseline JPEG at
// `quality` with 4:2:0 chroma into `out` (`capacity` bytes). Returns the
// size; 0 on failure; minus the size when `capacity` is too small.
long pfr_encode_jpeg(const uint8_t* rgb, int width, int height, int quality,
                     uint8_t* out, long capacity) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  unsigned char* buffer = nullptr;
  unsigned long size = 0;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_compress(&cinfo);
    std::free(buffer);
    return 0;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, &buffer, &size);
  cinfo.image_width = width;
  cinfo.image_height = height;
  cinfo.input_components = 3;
  cinfo.in_color_space = JCS_RGB;
  jpeg_set_defaults(&cinfo);  // YCbCr, 2x2 / 1x1 / 1x1 sampling, JDCT_ISLOW
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  const int stride = width * 3;
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(rgb) +
                   static_cast<size_t>(cinfo.next_scanline) * stride;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  long n = static_cast<long>(size);
  if (n > capacity) n = -n;
  else std::memcpy(out, buffer, size);
  std::free(buffer);
  return n;
}

}  // extern "C"
