// Folded serving stem for Hopper (sm_90a): conv 3x3 s1 p1, 3 -> 32 channels,
// + folded BN bias, leaky (slope bf16(0.1)), 2x2/2 max pool, in one kernel.
//
// Replaces singleshotpose_tpu/ops/stem.py:_k_serve (the Pallas TPU kernel
// behind stem_conv_pool_infer).
//
// What bounds it.  Unfused, this block is bound by memory traffic: at 672^2,
// batch 8, the plain path writes the (8, 672, 672, 32) conv output once in
// bf16 (231 MB), and the bias add, leaky and pool each read and write it
// again.  This kernel reads the f32 image once (43 MB) and writes the pooled
// bf16 output once (58 MB); the (B, H, W, 32) conv output never reaches
// device memory, it lives in registers for the 2x2 window of one thread.
// With the bytes cut to 101 MB, the 3.1 G f32 FMAs this simple version runs
// on the CUDA cores (27 per conv output, 4 outputs per pooled pixel and
// channel) can become the bound; moving them to the tensor cores is later
// work.
//
// Design.  One thread per pooled output pixel computes all 32 channels: it
// loads its 4x4x3 input patch (zero padded at the border), rounds it to bf16,
// and for each channel runs the 4 convolutions of the pool window with the
// 864 weights from shared memory (a warp reads one weight at a time, a
// broadcast).  The 32 bf16 results (64 bytes) leave as four 16-byte stores
// into the NHWC output.
//
// Rounding points, as in _k_serve (stem.py:562-565): products of bf16-rounded
// operands accumulated in f32; the sum rounded to bf16; the f32 bias added to
// that, rounded to bf16 again; leaky on the rounded value; the max over the 4
// positions; one bf16 store.  The kernel allocates nothing.  The conv
// itself (weights staged in shared memory, the patch, the fmaf chain) is
// stem_common.cuh, shared with the train stem's K3.

#include "stem_common.cuh"

namespace {

using stem::kCin;
using stem::kCout;
using stem::kSlope;
using stem::kTaps;
using stem::round_bf16;

constexpr int kThreads = 256;

// x: (B, H, W, 3) f32; w: (32, 3, 3, 3) f32 OIHW, BN folded; bias: (32,) f32;
// out: (B, H/2, W/2, 32) bf16.
__global__ void __launch_bounds__(kThreads)
stem_serve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  // ws[tap][co], tap = (ky * 3 + kx) * 3 + ci
  __shared__ float ws[kTaps * kCout];
  __shared__ float bs[kCout];
  stem::stage_weights(ws, w);
  if (threadIdx.x < kCout) bs[threadIdx.x] = bias[threadIdx.x];
  __syncthreads();

  const int Hp = H / 2, Wp = W / 2;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (pix >= (long long)B * Hp * Wp) return;
  const int px = (int)(pix % Wp);
  const long long t = pix / Wp;
  const int py = (int)(t % Hp);
  const int b = (int)(t / Hp);

  float patch[4][4][kCin];
  stem::load_patch(patch, x, b, py, px, H, W);

  // 8 channels per 16-byte store; q stays a loop so `p` stays in registers
  uint4* dst = reinterpret_cast<uint4*>(out + pix * kCout);
#pragma unroll 1
  for (int q = 0; q < kCout / 8; ++q) {
    uint32_t p[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float best[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int o = q * 8 + j * 2 + k;
        float m = -__int_as_float(0x7f800000);   // -inf
#pragma unroll
        for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const float acc = stem::conv_at(patch, ws, dy, dx, o);
            const float z = round_bf16(round_bf16(acc) + bs[o]);
            const float a = z >= 0.0f ? z : kSlope * z;
            m = fmaxf(m, a);
          }
        }
        best[k] = m;
      }
      const __nv_bfloat162 two = __floats2bfloat162_rn(best[0], best[1]);
      p[j] = *reinterpret_cast<const uint32_t*>(&two);
    }
    dst[q] = make_uint4(p[0], p[1], p[2], p[3]);
  }
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int stem_conv_pool_infer_launch(const float* x, const float* w,
                                           const float* bias, void* out,
                                           int B, int H, int W,
                                           void* stream) {
  const long long n = (long long)B * (H / 2) * (W / 2);
  if (n == 0) return 0;
  const long long blocks = (n + kThreads - 1) / kThreads;
  stem_serve_kernel<<<(unsigned)blocks, kThreads, 0,
                      reinterpret_cast<cudaStream_t>(stream)>>>(
      x, w, bias, reinterpret_cast<__nv_bfloat16*>(out), B, H, W);
  return (int)cudaGetLastError();
}
