// pfr_native (nvJPEG route): JPEG decode on the GPU with the CUDA toolkit's
// nvJPEG, colour reconstruction and letterbox on the host.
//
// The same C ABI and letterbox as pfr_native.cpp (pfr_common.h), for hosts
// that have the CUDA toolkit but no libjpeg headers. Each file is read on a
// worker thread and decoded by nvjpegDecode (hybrid backend: Huffman on the
// host, IDCT on the GPU) to its Y, Cb and Cr planes at their own
// subsampling; the planes come back to the host, where pfr::ycc_to_rgb
// rebuilds RGB as libjpeg does by default (fancy upsampling, fixed-point
// YCbCr -> RGB), and the same worker letterboxes. nvJPEG's own RGB output
// upsamples chroma otherwise and differed from libjpeg by up to 51 levels
// (mean 4) on the 4:2:0 corpus; what is left now is the IDCTs' rounding.
// Subsamplings other than 4:4:4, 4:2:2, 4:2:0, 4:4:0 and gray take nvJPEG's
// RGB output. Each worker decodes with a decoder of its own (below), so the
// host's Huffman decoding runs on as many threads as the batch call has.
//
// Departures from the libjpeg route: no DCT-domain downscale (target_min_side
// is ignored; every image decodes at full size), and nvJPEG's IDCT may round
// differently from libjpeg's integer one.
//
// The encoder (pfr_encode_jpeg) is nvJPEG's on the GPU at the quality asked
// for and 4:2:0 chroma, PIL's defaults; its DCT, quantisation rounding and
// chroma downsampling are nvJPEG's own, so its pixels differ from libjpeg's
// by a few levels. One encoder state serves the process, one call at a time.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <vector>

#include "pfr_common.h"

namespace {

// One decoder per concurrent caller: the nvJPEG handle is shared (it is
// thread-safe), and each decoder (state, stream, device buffer) serves one
// thread at a time. Idle decoders are kept for the process's life, so that
// no buffer is freed between calls (cudaFree would wait for the whole device).
struct Decoder {
  nvjpegJpegState_t state = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* buffer = nullptr;  // device: the decoded planes
  size_t capacity = 0;
};

std::mutex g_mutex;  // guards the handle's creation and the idle list
nvjpegHandle_t g_handle = nullptr;
bool g_tried = false;
std::vector<Decoder*> g_idle;

// The process's nvJPEG handle, created on first use; nullptr if it could not
// be. Call with g_mutex held.
nvjpegHandle_t handle_locked() {
  if (!g_tried) {
    g_tried = true;
    if (nvjpegCreateSimple(&g_handle) != NVJPEG_STATUS_SUCCESS) g_handle = nullptr;
  }
  return g_handle;
}

nvjpegHandle_t handle() {
  std::lock_guard<std::mutex> lock(g_mutex);
  return handle_locked();
}

// An idle decoder, or a new one; nullptr if CUDA or nvJPEG cannot be set up.
Decoder* acquire() {
  std::lock_guard<std::mutex> lock(g_mutex);
  if (handle_locked() == nullptr) return nullptr;
  if (!g_idle.empty()) {
    Decoder* d = g_idle.back();
    g_idle.pop_back();
    return d;
  }
  auto* d = new Decoder;
  // its stream does not block on the legacy default stream, so decoding
  // overlaps the GPU work that other threads queue there
  if (cudaStreamCreateWithFlags(&d->stream, cudaStreamNonBlocking) !=
          cudaSuccess ||
      nvjpegJpegStateCreate(g_handle, &d->state) != NVJPEG_STATUS_SUCCESS) {
    delete d;
    return nullptr;
  }
  return d;
}

// A decoder held for one scope, back on the idle list after it.
struct Lease {
  Decoder* d = acquire();
  Lease() = default;
  Lease(const Lease&) = delete;
  Lease& operator=(const Lease&) = delete;
  ~Lease() {
    if (d == nullptr) return;
    std::lock_guard<std::mutex> lock(g_mutex);
    g_idle.push_back(d);
  }
};

bool read_file(const char* path, std::vector<unsigned char>* bytes) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  bytes->clear();
  unsigned char chunk[1 << 16];
  size_t got;
  while ((got = std::fread(chunk, 1, sizeof(chunk), f)) > 0) {
    bytes->insert(bytes->end(), chunk, chunk + got);
  }
  const bool ok = !std::ferror(f);
  std::fclose(f);
  return ok && !bytes->empty();
}

// Width and height of a JPEG in memory, or false if nvJPEG cannot parse it.
bool image_info(nvjpegHandle_t h_nv, const std::vector<unsigned char>& bytes,
                int* w, int* h) {
  int n_components = 0;
  nvjpegChromaSubsampling_t subsampling;
  int widths[NVJPEG_MAX_COMPONENT];
  int heights[NVJPEG_MAX_COMPONENT];
  if (nvjpegGetImageInfo(h_nv, bytes.data(), bytes.size(), &n_components,
                         &subsampling, widths, heights) !=
      NVJPEG_STATUS_SUCCESS) {
    return false;
  }
  *w = widths[0];
  *h = heights[0];
  return *w > 0 && *h > 0;
}

// libjpeg's upsampling factors (h, v) of the chroma planes, or (0, 0) where
// this file rebuilds no RGB itself (gray: (1, 0)).
void chroma_factors(nvjpegChromaSubsampling_t ss, int* hf, int* vf) {
  *hf = *vf = 0;
  switch (ss) {
    case NVJPEG_CSS_444: *hf = 1; *vf = 1; break;
    case NVJPEG_CSS_422: *hf = 2; *vf = 1; break;
    case NVJPEG_CSS_420: *hf = 2; *vf = 2; break;
    case NVJPEG_CSS_440: *hf = 1; *vf = 2; break;
    case NVJPEG_CSS_GRAY: *hf = 1; break;
    default: break;
  }
}

// Decode one JPEG file to host RGB (the signature pfr::decode_batch takes).
bool decode_jpeg_file(const char* path, int /*target_min_side*/,
                      std::vector<uint8_t>* pixels, int* width, int* height) {
  std::vector<unsigned char> bytes;
  if (!read_file(path, &bytes)) return false;
  std::vector<uint8_t> planes;
  int n_planes = 0, hf = 0, vf = 0;
  int widths[NVJPEG_MAX_COMPONENT] = {0};
  int heights[NVJPEG_MAX_COMPONENT] = {0};
  size_t offsets[NVJPEG_MAX_COMPONENT + 1] = {0};
  {
    Lease lease;
    Decoder* d = lease.d;
    if (d == nullptr) return false;
    int n_components = 0;
    nvjpegChromaSubsampling_t subsampling;
    if (nvjpegGetImageInfo(g_handle, bytes.data(), bytes.size(), &n_components,
                           &subsampling, widths, heights) !=
            NVJPEG_STATUS_SUCCESS ||
        widths[0] <= 0 || heights[0] <= 0) {
      return false;
    }
    chroma_factors(subsampling, &hf, &vf);
    const bool own_rgb = hf > 0 && (vf == 0 || n_components == 3);
    nvjpegOutputFormat_t format = NVJPEG_OUTPUT_RGBI;
    if (!own_rgb) {  // nvJPEG's interleaved RGB
      n_planes = 1;
      offsets[1] = static_cast<size_t>(widths[0]) * heights[0] * 3;
    } else {         // Y, or Y, Cb and Cr at their own sizes
      format = vf == 0 ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
      n_planes = vf == 0 ? 1 : 3;
      for (int c = 0; c < n_planes; ++c)
        offsets[c + 1] = offsets[c] + static_cast<size_t>(widths[c]) * heights[c];
    }
    const size_t n = offsets[n_planes];
    if (n > d->capacity) {
      if (d->buffer != nullptr) cudaFreeAsync(d->buffer, d->stream);
      d->buffer = nullptr;
      d->capacity = 0;
      if (cudaMallocAsync(reinterpret_cast<void**>(&d->buffer), n, d->stream) !=
          cudaSuccess) {
        return false;
      }
      d->capacity = n;
    }
    nvjpegImage_t image;
    std::memset(&image, 0, sizeof(image));
    for (int c = 0; c < n_planes; ++c) {
      image.channel[c] = d->buffer + offsets[c];
      image.pitch[c] = own_rgb ? widths[c] : static_cast<size_t>(widths[0]) * 3;
    }
    if (nvjpegDecode(g_handle, d->state, bytes.data(), bytes.size(), format,
                     &image, d->stream) != NVJPEG_STATUS_SUCCESS) {
      cudaStreamSynchronize(d->stream);
      return false;
    }
    planes.resize(n);
    if (cudaMemcpyAsync(planes.data(), d->buffer, n, cudaMemcpyDeviceToHost,
                        d->stream) != cudaSuccess ||
        cudaStreamSynchronize(d->stream) != cudaSuccess) {
      return false;
    }
    if (!own_rgb) hf = 0;
  }
  const int w = widths[0], h = heights[0];
  if (hf == 0) {
    pixels->swap(planes);
  } else {
    pixels->resize(static_cast<size_t>(w) * h * 3);
    pfr::Plane p[3];
    for (int c = 0; c < n_planes; ++c)
      p[c] = pfr::Plane{planes.data() + offsets[c], widths[c], heights[c],
                        static_cast<size_t>(widths[c])};
    pfr::ycc_to_rgb(p[0], n_planes == 3 ? &p[1] : nullptr,
                    n_planes == 3 ? &p[2] : nullptr, hf, vf, w, h,
                    pixels->data());
  }
  *width = w;
  *height = h;
  return true;
}

// The process's encoder: state, parameters, stream and device buffer,
// created on first use and kept; guarded by g_encode_mutex.
struct Encoder {
  nvjpegEncoderState_t state = nullptr;
  nvjpegEncoderParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  unsigned char* buffer = nullptr;  // device: the interleaved RGB input
  size_t capacity = 0;
};

std::mutex g_encode_mutex;
Encoder* g_encoder = nullptr;

Encoder* encoder_locked() {
  if (g_encoder != nullptr) return g_encoder;
  nvjpegHandle_t h_nv = handle();
  if (h_nv == nullptr) return nullptr;
  auto* e = new Encoder;
  if (cudaStreamCreateWithFlags(&e->stream, cudaStreamNonBlocking) != cudaSuccess ||
      nvjpegEncoderStateCreate(h_nv, &e->state, e->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsCreate(h_nv, &e->params, e->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncoderParamsSetSamplingFactors(e->params, NVJPEG_CSS_420, e->stream) !=
          NVJPEG_STATUS_SUCCESS) {
    delete e;
    return nullptr;
  }
  g_encoder = e;
  return e;
}

}  // namespace

extern "C" {

// As pfr_native.cpp's pfr_decode_batch.
int pfr_decode_batch(const char** paths, int n, uint8_t* out, int out_w,
                     int out_h, uint8_t* ok, float* scales, float* pads,
                     int num_threads) {
  return pfr::decode_batch(paths, n, out, out_w, out_h, ok, scales, pads,
                           num_threads, decode_jpeg_file);
}

// As pfr_native.cpp's pfr_decode_single, always at full size; with
// out == nullptr only the header is parsed.
int pfr_decode_single(const char* path, uint8_t* out, int* width, int* height,
                      int /*target_min_side*/) {
  if (out == nullptr) {
    std::vector<unsigned char> bytes;
    if (!read_file(path, &bytes)) return 0;
    nvjpegHandle_t h_nv = handle();
    return h_nv != nullptr && image_info(h_nv, bytes, width, height) ? 1 : 0;
  }
  std::vector<uint8_t> pixels;
  int w = 0, h = 0;
  if (!decode_jpeg_file(path, 0, &pixels, &w, &h)) return 0;
  *width = w;
  *height = h;
  std::memcpy(out, pixels.data(), pixels.size());
  return 1;
}

// As pfr_native.cpp's pfr_encode_jpeg, with nvJPEG on the GPU.
long pfr_encode_jpeg(const uint8_t* rgb, int width, int height, int quality,
                     uint8_t* out, long capacity) {
  std::lock_guard<std::mutex> lock(g_encode_mutex);
  Encoder* e = encoder_locked();
  if (e == nullptr) return 0;
  const size_t n = static_cast<size_t>(width) * height * 3;
  if (n > e->capacity) {
    if (e->buffer != nullptr) cudaFreeAsync(e->buffer, e->stream);
    e->buffer = nullptr;
    e->capacity = 0;
    if (cudaMallocAsync(reinterpret_cast<void**>(&e->buffer), n, e->stream) !=
        cudaSuccess) {
      return 0;
    }
    e->capacity = n;
  }
  nvjpegImage_t image;
  std::memset(&image, 0, sizeof(image));
  image.channel[0] = e->buffer;
  image.pitch[0] = static_cast<size_t>(width) * 3;
  size_t length = 0;
  if (nvjpegEncoderParamsSetQuality(e->params, quality, e->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaMemcpyAsync(e->buffer, rgb, n, cudaMemcpyHostToDevice, e->stream) !=
          cudaSuccess ||
      nvjpegEncodeImage(g_handle, e->state, e->params, &image, NVJPEG_INPUT_RGBI,
                        width, height, e->stream) != NVJPEG_STATUS_SUCCESS ||
      nvjpegEncodeRetrieveBitstream(g_handle, e->state, nullptr, &length,
                                    e->stream) != NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(e->stream) != cudaSuccess) {
    cudaStreamSynchronize(e->stream);
    return 0;
  }
  if (static_cast<long>(length) > capacity) return -static_cast<long>(length);
  if (nvjpegEncodeRetrieveBitstream(g_handle, e->state, out, &length, e->stream) !=
          NVJPEG_STATUS_SUCCESS ||
      cudaStreamSynchronize(e->stream) != cudaSuccess) {
    return 0;
  }
  return static_cast<long>(length);
}

}  // extern "C"
