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
// with denom = e^sharpness - 1 + 1e-5 computed by the caller.  A batch with
// no valid slot gives zeros (every confidence is >= 0, and the max starts
// at 0).
//
// What bounds it.  The plain version writes a (B, G, S, K) distance and a
// (B, G, S) confidence tensor to device memory; this kernel reads the
// inputs once (B*S*2K + B*G*2K floats) and writes (B, S): nothing of size
// G*S ever leaves the registers.  What is left is up to G*K = 450
// evaluations of sqrt, exp and three IEEE divisions per cell, a chain of
// dependent long-latency instructions; at the main path's shapes (B*S of
// 1,352 to 27,040 cells) the kernel is bound by that latency and by how many
// warps are in flight to hide it, not by bytes.
//
// Design.  One warp per cell, eight cells per block, a grid of
// (S/8, B) blocks: even the smallest shape fills the card's SMs with warps.
// The block stages its image's G*2K ground-truth values and G validity flags
// in shared memory (3.8 KB at G = 50, K = 9); lane l of a warp takes the
// slots l, l+32, ..., reads its cell's 2K predictions (one broadcast load per
// value for the warp), and keeps the max of its slots' mean confidences;
// five shuffles take the max across the warp, which is exact in any order.
// The TPU kernel's layout (cells on lanes, the transposes, the 512-wide
// padding) is not carried over: predictions are read interleaved,
// (B, S, 2K), as they come.
//
// Rounding.  Every product and sum of the distance and the confidence is an
// explicitly rounded intrinsic (__fmul_rn, __fadd_rn, ...), so nvcc does
// not contract them into FMAs, which the plain PyTorch version does not do;
// expf and sqrtf are the accurate library functions (no fast math).

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                 // cells per block
constexpr int kThreads = 32 * kWarps;

template <int K>
__global__ void __launch_bounds__(kThreads)
max_corner_confidence_kernel(const float* __restrict__ gt,
                             const bool* __restrict__ valid,
                             const float* __restrict__ pred,
                             float* __restrict__ out, int G, int S, float th,
                             float sharpness, float im_w, float im_h,
                             float denom) {
  extern __shared__ float smem[];
  float* gs = smem;                 // (G, 2K) ground truth of image b
  float* vs = smem + G * 2 * K;     // (G,) validity of image b, 0 or 1
  const int b = blockIdx.y;
  const float* gt_b = gt + (long long)b * G * 2 * K;
  for (int i = threadIdx.x; i < G * 2 * K; i += blockDim.x) gs[i] = gt_b[i];
  for (int i = threadIdx.x; i < G; i += blockDim.x)
    vs[i] = valid[(long long)b * G + i] ? 1.0f : 0.0f;
  __syncthreads();

  const int lane = threadIdx.x % 32;
  const int s = blockIdx.x * kWarps + threadIdx.x / 32;
  if (s >= S) return;               // whole warps leave together
  float p[2 * K];
  const float* pred_s = pred + ((long long)b * S + s) * 2 * K;
#pragma unroll
  for (int j = 0; j < 2 * K; ++j) p[j] = pred_s[j];

  float best = 0.0f;
  for (int g = lane; g < G; g += 32) {
    if (vs[g] == 0.0f) continue;
    const float* q = gs + g * 2 * K;
    float sum = 0.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float dx = __fmul_rn(__fsub_rn(q[2 * k], p[2 * k]), im_w);
      const float dy = __fmul_rn(__fsub_rn(q[2 * k + 1], p[2 * k + 1]), im_h);
      const float d = sqrtf(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
      float c = 0.0f;
      if (d < th) {
        const float e = expf(__fmul_rn(sharpness,
                                       __fsub_rn(1.0f, __fdiv_rn(d, th))));
        c = __fdiv_rn(__fsub_rn(e, 1.0f), denom);
      }
      sum = __fadd_rn(sum, c);
    }
    best = fmaxf(best, __fdiv_rn(sum, (float)K));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[(long long)b * S + s] = best;
}

}  // namespace

// Plain C entry point for ctypes.  gt (B, G, 2K) f32, valid (B, G) bool,
// pred (B, S, 2K) f32, out (B, S) f32; all contiguous.  Launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a
// keypoint count the library was not built for.
extern "C" int max_corner_confidence_launch(const float* gt, const bool* valid,
                                            const float* pred, float* out,
                                            int B, int G, int S, int K,
                                            float th, float sharpness,
                                            float im_w, float im_h,
                                            float denom, void* stream) {
  if (K != 9) return (int)cudaErrorInvalidValue;
  if (B == 0 || S == 0) return 0;
  const dim3 grid((S + kWarps - 1) / kWarps, B);
  const size_t smem = (size_t)G * (2 * K + 1) * sizeof(float);
  max_corner_confidence_kernel<9><<<grid, kThreads, smem,
                                    reinterpret_cast<cudaStream_t>(stream)>>>(
      gt, valid, pred, out, G, S, th, sharpness, im_w, im_h, denom);
  return (int)cudaGetLastError();
}
