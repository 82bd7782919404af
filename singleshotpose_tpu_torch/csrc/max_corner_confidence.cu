// Max-over-ground-truths corner confidence for Hopper (sm_90a): pass 1 of
// the region loss's target assignment.
//
// Replaces singleshotpose_tpu/ops/pallas_kernels.py:_kernel (the Pallas TPU
// kernel behind max_corner_confidence).
//
// For every image b and predicted cell s:
//   out[b, s] = max over slots g with valid[b, g] of
//               mean over the K keypoints of c(d),
//   d    = sqrt((dx * im_w)^2 + (dy * im_h)^2),  (dx, dy) = gt - pred,
//   c(d) = (exp(sharpness * (1 - d / th)) - 1) / denom  where d < th, else 0,
// with denom = e^sharpness - 1 + 1e-5 computed by the caller.  An image with
// no valid slot gives zeros (every confidence is >= 0, and the max starts
// at 0).
//
// What bounds it.  Not bytes: the kernel reads its inputs once (B*S*2K +
// B*G*2K floats), writes (B, S), and nothing of size G*S leaves the chip.
// Nor operations: only the valid (slot, cell) pairs need their K keypoints
// (a distance, an IEEE sqrt, two IEEE divisions, an accurate exp), and the
// paths send few: one slot an image in single-object training, at most
// eight (an object and its seven companions) in multi-object training.
// What is left is latency: each block's staging round trip, then the
// dependent chain of its pairs' keypoints.  On an H100 80GB HBM3 at 700 W
// (scripts/k2_variants.py, PERF.md §6): 2.33 us at (B, G, S) = (8, 50, 169)
// on the train step's own inputs (one slot an image), 1.66 of them
// without any pair (flags, staging copies, stores); 11.07 us at
// (32, 50, 845) with eight slots an image, 4.20 of them without pairs.
//
// Design.  A block of 256 threads takes kCells consecutive cells of one
// image; the grid, (S / kCells, B), comes from the shapes alone.  It issues
// every staging copy at once with cp.async (its cells' predictions and the
// GT rows of the image's first 256 slots, valid or not), and meanwhile every
// warp ballots the slots' flags, so each valid slot's thread knows its rank
// without a barrier and writes it to a list.  The block's nr valid slots and
// nc cells make nc * nr pairs, packed densely in (cell, slot) order:
//  - at most one pass of kPass pairs (one slot an image): K lanes a pair,
//    32 / K pairs a warp; lane k evaluates keypoint k, and the pair's K
//    confidences are added in k order through shuffles, so the block waits
//    for one keypoint's chain, not K;
//  - more (eight slots an image): one thread a pair, its K keypoints summed
//    in order, 256 pairs a pass, which fills a warp with 32 pairs, not 3
//    (at eight slots, 11.07 us against 20.84 for K lanes a pair); a cell's
//    max over its consecutive threads in a warp by shuffles.
// A keypoint's confidence is taken under a select, not a branch on d < th,
// and each warp's part of a cell's max goes to shared memory by one
// atomicMax on the float's bits (the values are >= 0, and non-negative
// floats order as their bits do): exact in any order.  Slots past 256 are
// taken in further rounds of 256.  The TPU kernel's layout (cells on lanes,
// every slot against every cell, the transposes, the 512-wide padding) is
// not carried over.
//
// Rounding.  Every product and sum is an explicitly rounded intrinsic
// (__fmul_rn, __fadd_rn, ...), so nvcc contracts nothing, as the plain
// PyTorch version does not; sqrtf and __fdiv_rn are IEEE and expf is the
// accurate library function (no fast math); the K confidences are summed in
// order k = 0..K-1, and their sum divided by K with __fdiv_rn.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCells = 24;        // cells a block

// An asynchronous 4-byte copy from global to shared memory, and the wait for
// all of this thread's.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src) : "memory");
}

__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The confidence of one keypoint of GT g against prediction r; 0 where
// d >= th.
__device__ __forceinline__ float confidence(float2 g, float2 r, float th,
                                            float sharpness, float im_w,
                                            float im_h, float denom) {
  const float dx = __fmul_rn(__fsub_rn(g.x, r.x), im_w);
  const float dy = __fmul_rn(__fsub_rn(g.y, r.y), im_h);
  const float d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  const float e1 = __fsub_rn(
      expf(__fmul_rn(sharpness, __fsub_rn(1.0f, __fdiv_rn(d, th)))), 1.0f);
  return d < th ? __fdiv_rn(e1, denom) : 0.0f;
}

template <int K>
__global__ void __launch_bounds__(kThreads)
max_corner_confidence_kernel(const float* __restrict__ gt,
                             const bool* __restrict__ valid,
                             const float* __restrict__ pred,
                             float* __restrict__ out, int G, int S, float th,
                             float sharpness, float im_w, float im_h,
                             float denom) {
  constexpr int kPerWarp = 32 / K;              // pairs a warp, K lanes each
  constexpr int kPass = kWarps * kPerWarp;      // pairs a pass, K lanes each
  __shared__ float2 gt_s[kThreads][K];          // the round's GT rows
  __shared__ float2 pred_s[kCells][K];          // the block's predictions
  __shared__ int list[kThreads];                // the round's valid rows
  __shared__ unsigned cell_max[kCells];         // a cell's max, as its bits

  const int b = blockIdx.y, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int c0 = blockIdx.x * kCells;
  const int nc = S - c0 < kCells ? S - c0 : kCells;
  const int k = lane % K, first = lane - k;     // this lane's keypoint
  if (t < kCells) cell_max[t] = 0u;

  for (int g0 = 0; g0 < G; g0 += kThreads) {
    if (g0 == 0) {                              // one contiguous run
      const float* src = pred + ((long long)b * S + c0) * 2 * K;
      for (int i = t; i < nc * 2 * K; i += kThreads)
        copy4(&pred_s[0][0].x + i, src + i);
    }
    const int rows = G - g0 < kThreads ? G - g0 : kThreads;
    const float* src = gt + ((long long)b * G + g0) * 2 * K;
    for (int i = t; i < rows * 2 * K; i += kThreads)
      copy4(&gt_s[0][0].x + i, src + i);
    // every warp ballots all the round's flags (loads first, all in
    // flight): the round's count nr, and its own slots' ranks
    bool flag[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int g = g0 + 32 * w + lane;
      flag[w] = g < G && valid[(long long)b * G + g];
    }
    int nr = 0, rank = -1;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const unsigned v = __ballot_sync(~0u, flag[w]);
      if (w == warp && flag[w]) rank = nr + __popc(v & ((1u << lane) - 1u));
      nr += __popc(v);
    }
    if (rank >= 0) list[rank] = t;
    copies_wait();
    __syncthreads();

    const int pairs = nc * nr;
    if (0 < pairs && pairs <= kPass) {          // one pass, K lanes a pair
      const int p = warp * kPerWarp + lane / K;
      const bool ok = lane < kPerWarp * K && p < pairs;
      const int cell = ok ? p / nr : 0, j = ok ? p - cell * nr : 0;
      const float c = confidence(gt_s[list[j]][k], pred_s[cell][k], th,
                                 sharpness, im_w, im_h, denom);
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i)
        sum = __fadd_rn(sum, __shfl_sync(~0u, c, first + i));
      if (ok && k == 0)
        atomicMax(&cell_max[cell], __float_as_uint(__fdiv_rn(sum, (float)K)));
    } else {                                    // one thread a pair
      for (int q0 = 0; q0 < pairs; q0 += kThreads) {
        const int q = q0 + t, cell = q / nr, j = q - cell * nr;
        float best = 0.0f;
        if (q < pairs) {
          const float2* g = gt_s[list[j]];
          const float2* r = pred_s[cell];
          float sum = 0.0f;
#pragma unroll
          for (int i = 0; i < K; ++i)
            sum = __fadd_rn(sum, confidence(g[i], r[i], th, sharpness, im_w,
                                            im_h, denom));
          best = __fdiv_rn(sum, (float)K);
        }
        // the max over the cell's threads in this warp (a lane past the
        // warp's end reads its own value)
        const int next = (cell + 1) * nr;
#pragma unroll
        for (int off = 1; off < 32; off *= 2) {
          const float o = __shfl_down_sync(~0u, best, off);
          if (q + off < next) best = fmaxf(best, o);
        }
        if (q < pairs && (lane == 0 || j == 0))
          atomicMax(&cell_max[cell], __float_as_uint(best));
      }
    }
    if (g0 + kThreads < G) __syncthreads();     // the round's rows are read
  }
  __syncthreads();
  if (t < nc) out[(long long)b * S + c0 + t] = __uint_as_float(cell_max[t]);
}

}  // namespace

// Plain C entry point for ctypes.  gt (B, G, 2K) f32, valid (B, G) bool,
// pred (B, S, 2K) f32, out (B, S) f32; all contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// keypoint count the library was not built for.  The grid depends on the
// shapes only.
extern "C" int max_corner_confidence_launch(const float* gt, const bool* valid,
                                            const float* pred, float* out,
                                            int B, int G, int S, int K,
                                            float th, float sharpness,
                                            float im_w, float im_h,
                                            float denom, void* stream) {
  if (K != 9) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kCells - 1) / kCells, B);
  max_corner_confidence_kernel<9><<<grid, kThreads, 0,
                                    reinterpret_cast<cudaStream_t>(stream)>>>(
      gt, valid, pred, out, G, S, th, sharpness, im_w, im_h, denom);
  return (int)cudaGetLastError();
}
