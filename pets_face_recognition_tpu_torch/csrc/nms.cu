// K2: G independent exact greedy NMS problems over score-sorted boxes.
//
// Replaces pets_face_recognition_tpu/ops/pallas_nms.py::nms_keep_sorted_batch
// (Pallas body _nms_batch_kernel). Boxes of each group are sorted by score,
// descending. A box j > i is suppressed when a surviving box i overlaps it with
// iou > threshold (union > 0 guard); an invalid box neither suppresses nor
// survives; areas clamp at 0.
//
// Bound: the greedy order is K dependent decisions per group, but the
// arithmetic (the IoUs) does not depend on it. Design, two kernels launched by
// one call:
//   1. nms_keep_sorted_batch_mask_kernel, over every SM: for each group, row
//      block rb of 64 pivots and column block cb >= rb of 64 boxes, one 64-bit
//      word a pivot, bit b set when the pivot suppresses box 64 * cb + b
//      (j > i and iou > thr). Layout (G, n, n, 64) for n = ceil(K / 64): word
//      cb of pivot 64 * rb + t at [g, rb, cb, t], so a block writes 512
//      contiguous bytes and the sweep reads a chunk's words in one run
//      (ops/nms.py::nms_suppress_words is its plain twin).
//   2. nms_keep_sorted_batch_sweep_kernel, one block a group: warp 0 holds the
//      "removed" bits of the group, one 64-bit word a box block, in registers
//      (invalid boxes start removed), and for each chunk c of 64 pivots decides
//      them from the chunk's diagonal words in a few warp-wide rounds (not one
//      pivot at a time), then ORs the words of the chunk's kept pivots into the
//      removed words after c; meanwhile six other warps load chunk c + 1's
//      words into shared memory. The sweep's time depends on K, not on how
//      many boxes the data keeps (ops/nms.py::nms_sweep_words is its plain
//      twin).
// The float expressions are those of the plain PyTorch version, each rounded
// on its own (iou_above decides most pairs exactly without the division), so
// every bit the sweep reads equals the plain version's suppress[g, i, j] and
// the keep masks are equal.

#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;           // pivots (rows) and boxes (columns) a word covers
constexpr int kWordsPerLane = 8;     // a warp holds 256 "removed" words
constexpr size_t kDefaultSmem = 48 * 1024;
constexpr size_t kMaxSmem = 232448;  // Hopper: 227 KB of dynamic shared memory

__device__ __forceinline__ float box_area(float x1, float y1, float x2, float y2) {
  return __fmul_rn(fmaxf(__fsub_rn(x2, x1), 0.0f), fmaxf(__fsub_rn(y2, y1), 0.0f));
}

// iou > thr for the plain version's iou = union > 0 ? inter / union : 0, with
// inter >= 0 or not a number, and the quotient rounded to float. With fast
// (thr in [2^-20, 2^20], eps = thr * 2^-22, uni above 1e-20 so that eps * uni
// stays a normal float), the sign of inter - thr * uni, exact in one fused
// multiply-add, decides without a division: at or below 0 the quotient is at
// most thr; above eps * uni it is more than 1.8 ulps above thr, so it rounds
// above thr. The rounded quotient decides what lies between.
__device__ __forceinline__ bool iou_above(float inter, float uni, float thr, bool fast,
                                          float eps) {
  if (!(inter > 0.0f && uni > 0.0f)) return 0.0f > thr;
  if (fast && uni > 1e-20f) {
    const float r = __fmaf_rn(-thr, uni, inter);
    if (r <= 0.0f) return false;
    if (r > __fmul_rn(eps, uni)) return true;
  }
  return __fdiv_rn(inter, uni) > thr;
}

// grid (n_words * (n_words + 1) / 2, G), 64 threads: block (t, g) is tile t of
// the upper triangle, row by row: the words of pivots 64 * rb .. + 63 for boxes
// 64 * cb .. + 63, cb >= rb. The words of an invalid pivot, and tiles whose
// boxes are all invalid, are not written: the sweep masks the first out (an
// invalid pivot is never kept or undecided), and the second only name boxes it
// has removed from the start.
__global__ void nms_keep_sorted_batch_mask_kernel(const float* __restrict__ boxes,
                                                  const unsigned char* __restrict__ valid,
                                                  int K, int n_words, float thr,
                                                  unsigned long long* __restrict__ mask) {
  const int tile = blockIdx.x, g = blockIdx.y;
  // row rb of the triangle starts at tile rb * n_words - rb * (rb - 1) / 2
  const float b2 = 2.0f * n_words + 1.0f;
  int rb = (int)((b2 - sqrtf(b2 * b2 - 8.0f * tile)) * 0.5f);
  while (rb > 0 && rb * n_words - rb * (rb - 1) / 2 > tile) --rb;
  while ((rb + 1) * n_words - (rb + 1) * rb / 2 <= tile) ++rb;
  const int cb = rb + tile - (rb * n_words - rb * (rb - 1) / 2);

  __shared__ float4 cbox[kBlock];
  __shared__ float carea[kBlock];
  const float4* gb = reinterpret_cast<const float4*>(boxes) + (long long)g * K;
  const unsigned char* gv = valid + (long long)g * K;
  const int t = threadIdx.x;
  const int n_cols = min(kBlock, K - cb * kBlock);
  bool any = false;
  if (t < n_cols) {
    const float4 b = gb[cb * kBlock + t];
    cbox[t] = b;
    carea[t] = box_area(b.x, b.y, b.z, b.w);
    any = gv[cb * kBlock + t];
  }
  if (!__syncthreads_or(any)) return;
  const int i = rb * kBlock + t;
  if (i >= K || !gv[i]) return;
  const float4 p = gb[i];
  const float pa = box_area(p.x, p.y, p.z, p.w);
  const bool fast = thr >= 0x1p-20f && thr <= 0x1p20f;
  const float eps = thr * 0x1p-22f;
  // columns j > i only: on the diagonal block, those after t
  const int start = cb == rb ? t + 1 : 0;
  unsigned long long bits = 0ULL;
  for (int c = start; c < n_cols; ++c) {
    const float4 q = cbox[c];
    float ix1 = fmaxf(q.x, p.x);
    float iy1 = fmaxf(q.y, p.y);
    float ix2 = fminf(q.z, p.z);
    float iy2 = fminf(q.w, p.w);
    float inter = __fmul_rn(fmaxf(__fsub_rn(ix2, ix1), 0.0f), fmaxf(__fsub_rn(iy2, iy1), 0.0f));
    float uni = __fsub_rn(__fadd_rn(carea[c], pa), inter);
    if (iou_above(inter, uni, thr, fast, eps)) bits |= 1ULL << c;
  }
  mask[(((long long)g * n_words + rb) * n_words + cb) * kBlock + t] = bits;
}

// removed word w of warp 0 (lane w % 32, slot w / 32), to every lane
__device__ __forceinline__ unsigned long long word_of(const unsigned long long* removed, int w) {
  unsigned long long mine = 0ULL;
#pragma unroll
  for (int s = 0; s < kWordsPerLane; ++s)
    if (s == (w >> 5)) mine = removed[s];
  return __shfl_sync(0xffffffffu, mine, w & 31);
}

// one block of kSweepWarps warps per group: warp 0 sweeps; warps 1-3 and 5-7
// load the next chunk's words into shared memory meanwhile (warp 4 shares warp
// 0's scheduler and idles). Shared memory: two buffers of n_words x kRowPad
// words, word w of row t of a chunk at [(w - c) * kRowPad + t].
constexpr int kSweepWarps = 8;
constexpr int kLoaders = 6 * 32;
constexpr int kRowPad = kBlock + 1;   // odd: lanes reading one t of 32 words hit 16 banks

__global__ void __launch_bounds__(kSweepWarps * 32)
nms_keep_sorted_batch_sweep_kernel(const unsigned char* __restrict__ valid,
                                   const unsigned long long* __restrict__ mask, int K,
                                   int n_words, unsigned char* __restrict__ keep) {
  extern __shared__ unsigned long long smem[];
  const int g = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int loader = warp == 0 || warp == 4 ? -1 : ((warp < 4 ? warp - 1 : warp - 2) << 5) + lane;
  // words (chunk c, word w) of rows 64 c .. 64 c + 63: gm + (c * n_words + w) * 64
  const unsigned long long* gm = mask + (long long)g * n_words * n_words * kBlock;
  unsigned long long* bufs[2] = {smem, smem + n_words * kRowPad};

  // loaders: words c .. n_words - 1 of chunk c, 8 independent loads a thread at a time
  auto stage = [&](int c, unsigned long long* buf) {
    const unsigned long long* src = gm + ((long long)c * n_words + c) * kBlock;
    const int total = (n_words - c) * kBlock;
    for (int base = loader; base < total; base += 8 * kLoaders) {
      unsigned long long v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = base + i * kLoaders;
        v[i] = q < total ? src[q] : 0ULL;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int q = base + i * kLoaders;
        if (q < total) buf[(q >> 6) * kRowPad + (q & 63)] = v[i];
      }
    }
  };

  // warp 0: removed[s] is word s * 32 + lane; invalid boxes and those past K
  // start removed
  unsigned long long removed[kWordsPerLane];
  if (warp == 0) {
    const unsigned char* gv = valid + (long long)g * K;
#pragma unroll
    for (int s = 0; s < kWordsPerLane; ++s) {
      const int w = s * 32 + lane;
      unsigned long long bits = ~0ULL;
      if (w < n_words) {
        bits = 0ULL;
#pragma unroll
        for (int b = 0; b < kBlock; ++b) {
          const int j = w * kBlock + b;
          const unsigned char v = j < K ? gv[j] : 0;
          if (!v) bits |= 1ULL << b;
        }
      }
      removed[s] = bits;
    }
  }
  if (loader >= 0) stage(0, bufs[0]);
  __syncthreads();

  unsigned char* gk = keep + (long long)g * K;
  for (int c = 0; c < n_words; ++c) {
    if (loader >= 0 && c + 1 < n_words) stage(c + 1, bufs[(c + 1) & 1]);
    if (warp == 0) {
      const unsigned long long* rb = bufs[c & 1];
      const int n_rows = min(kBlock, K - c * kBlock);
      // decide the chunk's pivots in rounds, the warp together: lane l holds
      // the columns of pivots l and l + 32 of the chunk's diagonal words (which
      // earlier pivots of the chunk would suppress it). A pivot not yet decided
      // is removed once a kept pivot suppresses it, and kept once no pivot
      // before it that suppresses it is kept or undecided: the greedy order's
      // result, with the lowest undecided pivot decided in every round.
      const unsigned long long d_lo = rb[lane], d_hi = rb[32 + lane];
      unsigned long long col_lo = 0ULL, col_hi = 0ULL;
#pragma unroll 8
      for (int u = 0; u < kBlock; ++u) {
        const unsigned long long cu =
            (unsigned long long)__ballot_sync(0xffffffffu, (d_lo >> u) & 1ULL) |
            ((unsigned long long)__ballot_sync(0xffffffffu, (d_hi >> u) & 1ULL) << 32);
        if ((u & 31) == lane) {
          if (u < 32) col_lo = cu;
          else col_hi = cu;
        }
      }
      const unsigned long long rows_mask = n_rows == kBlock ? ~0ULL : (1ULL << n_rows) - 1;
      unsigned long long und = ~word_of(removed, c) & rows_mask, kept = 0ULL;
      while (und) {
        const bool u_lo = (und >> lane) & 1ULL, u_hi = (und >> (lane + 32)) & 1ULL;
        const unsigned long long k2 =
            (unsigned long long)__ballot_sync(0xffffffffu, u_lo && !(col_lo & (kept | und))) |
            ((unsigned long long)__ballot_sync(0xffffffffu, u_hi && !(col_hi & (kept | und)))
             << 32);
        const unsigned long long r2 =
            (unsigned long long)__ballot_sync(0xffffffffu, u_lo && (col_lo & kept)) |
            ((unsigned long long)__ballot_sync(0xffffffffu, u_hi && (col_hi & kept)) << 32);
        kept |= k2;
        und &= ~(k2 | r2);
      }
      // every pivot of the chunk that is not kept is removed
#pragma unroll
      for (int s = 0; s < kWordsPerLane; ++s)
        if (s == (c >> 5) && lane == (c & 31)) removed[s] = ~kept;

      // every kept pivot of the chunk removes what it suppresses after chunk c
#pragma unroll
      for (int s = 0; s < kWordsPerLane; ++s) {
        const int w = s * 32 + lane;
        if (w > c && w < n_words) {
          const unsigned long long* col = rb + (w - c) * kRowPad;
          unsigned long long r = removed[s];
#pragma unroll 16
          for (int t = 0; t < kBlock; ++t) r |= col[t] & (0ULL - ((kept >> t) & 1ULL));
          removed[s] = r;
        }
      }
      const int base = c * kBlock;
      if (base + lane < K) gk[base + lane] = (unsigned char)((kept >> lane) & 1ULL);
      if (base + lane + 32 < K) gk[base + lane + 32] = (unsigned char)((kept >> (lane + 32)) & 1ULL);
    }
    __syncthreads();  // chunk c + 1 is in place; chunk c's buffer is free
  }
}

}  // namespace

extern "C" int pfr_nms_keep_sorted_batch(const float* boxes, const unsigned char* valid,
                                         unsigned long long* mask, unsigned char* keep, int G,
                                         int K, float iou_threshold, cudaStream_t stream) {
  if (G == 0 || K == 0) return 0;
  const int n_words = (K + kBlock - 1) / kBlock;
  if (n_words > 32 * kWordsPerLane || G > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)n_words * kRowPad * sizeof(unsigned long long);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > kDefaultSmem) {
    cudaError_t err = cudaFuncSetAttribute(nms_keep_sorted_batch_sweep_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  nms_keep_sorted_batch_mask_kernel<<<dim3(n_words * (n_words + 1) / 2, G), kBlock, 0,
                                      stream>>>(boxes, valid, K, n_words, iou_threshold, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_keep_sorted_batch_sweep_kernel<<<G, kSweepWarps * 32, smem, stream>>>(valid, mask, K,
                                                                           n_words, keep);
  return (int)cudaGetLastError();
}

