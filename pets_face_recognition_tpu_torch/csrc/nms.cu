// K2: G independent exact greedy NMS problems over score-sorted boxes.
//
// Replaces pets_face_recognition_tpu/ops/pallas_nms.py::nms_keep_sorted_batch
// (Pallas body _nms_batch_kernel). Boxes of each group are sorted by score,
// descending. A box j > i is suppressed when a surviving box i overlaps it with
// iou > threshold (union > 0 guard); an invalid box neither suppresses nor
// survives; areas clamp at 0.
//
// Bound: latency. The greedy sweep is K dependent steps per group, and the work
// per step is tiny (at most K IoUs). Design: one block per group; its boxes,
// areas and alive mask sit in dynamic shared memory, 24 bytes a box, so a block
// holds K <= 9685 (the 232,448 bytes a Hopper block may use; past the 48 KB
// default the launcher raises the kernel's limit, which the training budget
// K = 2000, 48,000 bytes, does not need); a loop over the pivot i, with one
// __syncthreads() per step, has the threads cover the columns j > i. The float
// expressions are those of the plain PyTorch version, each rounded on its own,
// so the keep masks are bit-equal to it.

#include <cuda_runtime.h>

namespace {

constexpr size_t kBytesPerBox = 6 * sizeof(float);
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // Hopper: 227 KB of dynamic shared memory

__global__ void nms_keep_sorted_batch_kernel(const float* __restrict__ boxes,
                                             const unsigned char* __restrict__ valid,
                                             unsigned char* __restrict__ keep,
                                             int K, float thr) {
  extern __shared__ float sm[];
  float* x1 = sm;
  float* y1 = sm + K;
  float* x2 = sm + 2 * K;
  float* y2 = sm + 3 * K;
  float* area = sm + 4 * K;
  int* alive = reinterpret_cast<int*>(sm + 5 * K);

  const int g = blockIdx.x;
  const float* gb = boxes + (long long)g * K * 4;
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    float a = gb[4 * j], b = gb[4 * j + 1], c = gb[4 * j + 2], d = gb[4 * j + 3];
    x1[j] = a;
    y1[j] = b;
    x2[j] = c;
    y2[j] = d;
    area[j] = __fmul_rn(fmaxf(__fsub_rn(c, a), 0.0f), fmaxf(__fsub_rn(d, b), 0.0f));
    alive[j] = valid[(long long)g * K + j] != 0;
  }
  __syncthreads();

  for (int i = 0; i < K; ++i) {
    // alive[i] is written only at steps < i, all of which ended in a barrier
    if (alive[i]) {
      float bx1 = x1[i], by1 = y1[i], bx2 = x2[i], by2 = y2[i], ba = area[i];
      for (int j = i + 1 + threadIdx.x; j < K; j += blockDim.x) {
        if (!alive[j]) continue;
        float ix1 = fmaxf(x1[j], bx1);
        float iy1 = fmaxf(y1[j], by1);
        float ix2 = fminf(x2[j], bx2);
        float iy2 = fminf(y2[j], by2);
        float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f),
                                fmaxf(__fsub_rn(iy2, iy1), 0.0f));
        float uni = __fsub_rn(__fadd_rn(area[j], ba), inter);
        float iou = uni > 0.0f ? __fdiv_rn(inter, uni) : 0.0f;
        if (iou > thr) alive[j] = 0;
      }
    }
    __syncthreads();
  }

  for (int j = threadIdx.x; j < K; j += blockDim.x)
    keep[(long long)g * K + j] = (unsigned char)alive[j];
}

}  // namespace

extern "C" int pfr_nms_keep_sorted_batch(const float* boxes,
                                         const unsigned char* valid,
                                         unsigned char* keep, int G, int K,
                                         float iou_threshold,
                                         cudaStream_t stream) {
  if (G == 0 || K == 0) return 0;
  int threads = K < 128 ? ((K + 31) / 32) * 32 : 128;
  size_t smem = (size_t)K * kBytesPerBox;
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        nms_keep_sorted_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_sorted_batch_kernel<<<G, threads, smem, stream>>>(
      boxes, valid, keep, K, iou_threshold);
  return (int)cudaGetLastError();
}
