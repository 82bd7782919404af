// Device code shared by the serving stem (stem_serve.cu, K1) and the train
// stem (stem_train.cu, K3-K6): conv 3x3 s1 p1, 3 -> 32 channels, on
// bf16-rounded operands with f32 sums, seen from one 2x2 pool window.
//
// A thread owns one pooled pixel (py, px): it holds the 4x4x3 input patch
// that the window's four conv outputs read (rows 2py-1 .. 2py+2, columns
// 2px-1 .. 2px+2 of the zero-padded image), and reads the weights from
// shared memory as ws[tap][co], tap = (ky * 3 + kx) * 3 + ci, the order of
// the TPU kernels' weight matrix (singleshotpose_tpu/ops/stem.py:_wmat).
// Every conv output is the same chain of fmaf over (ky, kx, ci), so K1 and
// K3 compute the same bits for the same inputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace stem {

constexpr int kCin = 3;
constexpr int kCout = 32;
constexpr int kTaps = 27;                  // 3 x 3 x kCin
constexpr float kSlope = 0.10009765625f;   // bf16(0.1)

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ws[tap][co] <- bf16(w[co][ci][ky][kx]) for OIHW w; the block's threads
// share the work; the caller synchronises before reading ws.
__device__ __forceinline__ void stage_weights(float* ws,
                                              const float* __restrict__ w) {
  for (int i = threadIdx.x; i < kTaps * kCout; i += blockDim.x) {
    const int co = i / kTaps, rem = i % kTaps;
    const int ci = rem / 9, ky = (rem % 9) / 3, kx = rem % 3;
    ws[((ky * 3 + kx) * kCin + ci) * kCout + co] = round_bf16(w[i]);
  }
}

// The bf16-rounded 4x4x3 patch of pooled pixel (b, py, px) of the
// (B, H, W, 3) f32 image x; zeros outside the image (the conv's padding).
__device__ __forceinline__ void load_patch(float (&patch)[4][4][kCin],
                                           const float* __restrict__ x,
                                           int b, int py, int px, int H,
                                           int W) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int iy = 2 * py - 1 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int ix = 2 * px - 1 + c;
      const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
      const float* src = x + (((long long)b * H + iy) * W + ix) * kCin;
#pragma unroll
      for (int ci = 0; ci < kCin; ++ci)
        patch[r][c][ci] = in ? round_bf16(src[ci]) : 0.0f;
    }
  }
}

// The f32 conv output of channel o at window position (dy, dx).
__device__ __forceinline__ float conv_at(const float (&patch)[4][4][kCin],
                                         const float* ws, int dy, int dx,
                                         int o) {
  float acc = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky)
#pragma unroll
    for (int kx = 0; kx < 3; ++kx)
#pragma unroll
      for (int ci = 0; ci < kCin; ++ci)
        acc = fmaf(patch[dy + ky][dx + kx][ci],
                   ws[((ky * 3 + kx) * kCin + ci) * kCout + o], acc);
  return acc;
}

}  // namespace stem
