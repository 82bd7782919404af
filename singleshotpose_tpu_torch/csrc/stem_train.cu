// The fused train stem for Hopper (sm_90a): conv 3x3 s1 p1 3 -> 32 +
// train-mode BatchNorm + leaky (slope bf16(0.1)) + 2x2/2 max pool, forward
// and backward, as four kernels and one reduction pass.
//
//   K3 stem_conv_stats_kernel  replaces singleshotpose_tpu/ops/stem.py:_k1_conv_stats
//   K4 stem_bn_pool_kernel     replaces singleshotpose_tpu/ops/stem.py:_k2_bn_pool
//   K5 stem_bwd_sums_kernel    replaces singleshotpose_tpu/ops/stem.py:_b1_sums
//   K6 stem_bwd_dw_kernel      replaces singleshotpose_tpu/ops/stem.py:_b2_dw
//
// Layout.  The conv output y is kept in bf16 between the passes, as the TPU
// kernels keep it, grouped by pool window: y[b][py][px][p][co] with window
// position p = dy * 2 + dx in the order (0,0),(0,1),(1,0),(1,1).  One pooled
// pixel's four positions are 256 contiguous bytes, so every pass reads or
// writes whole 16-byte chunks of 8 channels.  The TPU kernels' phase-split
// planes (a layout for its 128-wide lanes) are not carried over.
//
// What bounds them.  Each pass moves the bf16 y (B*H*W*32*2 bytes: 88.6 MB
// at batch 8, 416^2) once, and so each is bound by memory traffic on this
// card: at 3.35 TB/s, K3 (16.6 MB image in + 88.6 MB y out) >= 31.4 us,
// K4 (88.6 MB y in + 22.2 MB pooled out) >= 33.1 us, K5 (88.6 + 22.2 MB
// in) >= 33.1 us, K6 (88.6 + 22.2 + 16.6 MB in) >= 38.0 us.  The conv
// (2.39 GFLOP forward in K3, the same again for dW in K6) would take 2.4 us
// on the bf16 tensor cores; this simple version runs it as f32 FMAs on the
// CUDA cores, K3 with one thread per pooled pixel as K1 does (the conv is
// stem_common.cuh, shared with K1), K6 as a product over shared memory.
//
// Reductions.  The TPU kernels carry their sums across a sequential grid.
// Here blocks run in any order, so every kernel that sums (K3: sum y and
// sum y^2 per channel; K5: sum gz and sum gz*xhat; K6: dW) writes one
// partial per block, each summed in a fixed order, and
// reduce_partials_kernel sums the partials in a fixed order.  There are no
// float atomics: the statistics and dW are the same bits from run to run.
//
// Rounding.  The BN arithmetic uses explicitly rounded intrinsics
// (__fmul_rn, __fadd_rn, __fsub_rn) so nvcc contracts no FMA the plain
// PyTorch version does not; bf16 products in the convs are exact in f32, so
// fmaf there is a product and one rounded add.  The kernels allocate
// nothing: the wrappers in ops/stem.py allocate outputs and partials.

#include "stem_common.cuh"

namespace {

using stem::kCin;
using stem::kCout;
using stem::kSlope;
using stem::kTaps;
using stem::round_bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPhases = 4;
constexpr int kGroups = kCout / 8;         // 16-byte groups of 8 channels

__device__ __forceinline__ void unpack8(const uint4& v, float (&out)[8]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 two = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
    const float2 f = __bfloat1622float2(two);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&in)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 two = __floats2bfloat162_rn(in[2 * i], in[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&two);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// K3.  One thread per pooled pixel: its window's 4 x 32 conv outputs, as K1
// computes them, rounded to bf16 and stored; per channel, the sum and the
// sum of squares of those rounded values (the TPU kernel's statistics are
// of the bf16 y too, stem.py:200-204), reduced over the block in a fixed
// order into partials[block][2][32].
__global__ void __launch_bounds__(kThreads)
stem_conv_stats_kernel(const float* __restrict__ x,
                       const float* __restrict__ w,
                       __nv_bfloat16* __restrict__ y,
                       float* __restrict__ partials, int B, int H, int W) {
  __shared__ float ws[kTaps * kCout];
  __shared__ float red[kWarps][2][kCout];
  stem::stage_weights(ws, w);
  __syncthreads();

  const int Hp = H / 2, Wp = W / 2;
  const long long total = (long long)B * Hp * Wp;
  const long long pix = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const bool valid = pix < total;     // the rest add zeros to the sums
  float patch[4][4][kCin];
  if (valid) {
    const int px = (int)(pix % Wp);
    const long long t = pix / Wp;
    stem::load_patch(patch, x, (int)(t / Hp), (int)(t % Hp), px, H, W);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int ci = 0; ci < kCin; ++ci) patch[r][c][ci] = 0.0f;
  }

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  uint4* dst = reinterpret_cast<uint4*>(y + pix * kPhases * kCout);
#pragma unroll 1
  for (int q = 0; q < kGroups; ++q) {
    float yv[kPhases][8];
#pragma unroll
    for (int p = 0; p < kPhases; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        yv[p][j] = round_bf16(stem::conv_at(patch, ws, p / 2, p % 2, q * 8 + j));
    if (valid) {
#pragma unroll
      for (int p = 0; p < kPhases; ++p) dst[p * kGroups + q] = pack8(yv[p]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
      for (int p = 0; p < kPhases; ++p) {
        s1 = __fadd_rn(s1, yv[p][j]);
        s2 = __fadd_rn(s2, __fmul_rn(yv[p][j], yv[p][j]));
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        red[warp][0][q * 8 + j] = s1;
        red[warp][1][q * 8 + j] = s2;
      }
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kCout) {
    const int k = threadIdx.x / kCout, o = threadIdx.x % kCout;
    float s = 0.0f;
    for (int v = 0; v < kWarps; ++v) s = __fadd_rn(s, red[v][k][o]);
    partials[(long long)blockIdx.x * 2 * kCout + threadIdx.x] = s;
  }
}

// out[m] = the sum over p < P of partials[p][m], for m < M: one block per
// m, each thread a strided run of p in order, then a tree over the block.
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials,
                       float* __restrict__ out, int P, int M) {
  __shared__ float sh[kThreads];
  const int m = blockIdx.x;
  float s = 0.0f;
  for (int p = threadIdx.x; p < P; p += blockDim.x)
    s = __fadd_rn(s, partials[(long long)p * M + m]);
  sh[threadIdx.x] = s;
  __syncthreads();
  for (int off = kThreads / 2; off > 0; off /= 2) {
    if (threadIdx.x < off)
      sh[threadIdx.x] = __fadd_rn(sh[threadIdx.x], sh[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[m] = sh[0];
}

// K4.  One thread per (pooled pixel, group of 8 channels): z =
// bf16(y * inv + shift), leaky in f32 on z, the max over the window, one
// bf16 store (rounding commutes with the max), as stem.py:_k2_bn_pool.
__global__ void __launch_bounds__(kThreads)
stem_bn_pool_kernel(const __nv_bfloat16* __restrict__ y,
                    const float* __restrict__ inv,
                    const float* __restrict__ shift,
                    __nv_bfloat16* __restrict__ out, long long total) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total * kGroups) return;
  const long long pix = t / kGroups;
  const int q = (int)(t % kGroups);
  const uint4* src = reinterpret_cast<const uint4*>(y) + pix * kPhases * kGroups;
  float iv[8], sh[8], best[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    iv[j] = inv[q * 8 + j];
    sh[j] = shift[q * 8 + j];
    best[j] = -__int_as_float(0x7f800000);   // -inf
  }
#pragma unroll
  for (int p = 0; p < kPhases; ++p) {
    float v[8];
    unpack8(src[p * kGroups + q], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float z = round_bf16(__fadd_rn(__fmul_rn(v[j], iv[j]), sh[j]));
      const float a = z >= 0.0f ? z : __fmul_rn(kSlope, z);
      best[j] = fmaxf(best[j], a);
    }
  }
  reinterpret_cast<uint4*>(out)[pix * kGroups + q] = pack8(best);
}

// The backward's per-element work for one (pooled pixel, group of 8
// channels), as stem.py:_routing and _b1_sums: recompute z and the rounded
// leaky output at the 4 window positions, route g to the FIRST maximum in
// window order, times leaky'(z); x-hat = (y - mean) * rstd.
struct BnParams {
  float inv[8], shift[8], mean[8], rstd[8];
};

__device__ __forceinline__ void load_params(BnParams& bp, int q,
                                            const float* __restrict__ inv,
                                            const float* __restrict__ shift,
                                            const float* __restrict__ mean,
                                            const float* __restrict__ rstd) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    bp.inv[j] = inv[q * 8 + j];
    bp.shift[j] = shift[q * 8 + j];
    bp.mean[j] = mean[q * 8 + j];
    bp.rstd[j] = rstd[q * 8 + j];
  }
}

__device__ __forceinline__ void grad_z(const __nv_bfloat16* __restrict__ y,
                                       const __nv_bfloat16* __restrict__ g,
                                       long long pix, int q,
                                       const BnParams& bp,
                                       float (&gz)[kPhases][8],
                                       float (&xhat)[kPhases][8]) {
  const uint4* src = reinterpret_cast<const uint4*>(y) + pix * kPhases * kGroups;
  float gv[8], yv[kPhases][8], z[kPhases][8], a[kPhases][8];
  unpack8(reinterpret_cast<const uint4*>(g)[pix * kGroups + q], gv);
#pragma unroll
  for (int p = 0; p < kPhases; ++p) unpack8(src[p * kGroups + q], yv[p]);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float best = -__int_as_float(0x7f800000);
#pragma unroll
    for (int p = 0; p < kPhases; ++p) {
      z[p][j] = round_bf16(__fadd_rn(__fmul_rn(yv[p][j], bp.inv[j]),
                                     bp.shift[j]));
      a[p][j] = round_bf16(z[p][j] >= 0.0f ? z[p][j]
                                           : __fmul_rn(kSlope, z[p][j]));
      best = fmaxf(best, a[p][j]);
    }
    bool taken = false;
#pragma unroll
    for (int p = 0; p < kPhases; ++p) {
      const bool hit = a[p][j] == best && !taken;
      taken = taken || hit;
      gz[p][j] = __fmul_rn(hit ? gv[j] : 0.0f,
                           z[p][j] >= 0.0f ? 1.0f : kSlope);
      xhat[p][j] = __fmul_rn(__fsub_rn(yv[p][j], bp.mean[j]), bp.rstd[j]);
    }
  }
}

// K5.  Sum gz and sum gz * xhat per channel.  Grid-stride over (pooled
// pixel, group) items, each thread in a fixed order; lanes of a warp that
// hold the same group (lane % 4) are summed by shuffles, the warps in order
// into partials[block][2][32].
__global__ void __launch_bounds__(kThreads)
stem_bwd_sums_kernel(const __nv_bfloat16* __restrict__ y,
                     const __nv_bfloat16* __restrict__ g,
                     const float* __restrict__ inv,
                     const float* __restrict__ shift,
                     const float* __restrict__ mean,
                     const float* __restrict__ rstd,
                     float* __restrict__ partials, long long total) {
  __shared__ float red[kWarps][2][kCout];
  const int q = threadIdx.x % kGroups;     // blockDim and the stride are
  BnParams bp;                             // multiples of kGroups
  load_params(bp, q, inv, shift, mean, rstd);
  float s_gz[8], s_gx[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) s_gz[j] = s_gx[j] = 0.0f;
  const long long items = total * kGroups;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < items; t += stride) {
    float gz[kPhases][8], xhat[kPhases][8];
    grad_z(y, g, t / kGroups, q, bp, gz, xhat);
#pragma unroll
    for (int p = 0; p < kPhases; ++p)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s_gz[j] = __fadd_rn(s_gz[j], gz[p][j]);
        s_gx[j] = __fadd_rn(s_gx[j], __fmul_rn(gz[p][j], xhat[p][j]));
      }
  }
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int off = 16; off >= kGroups; off /= 2) {
      s_gz[j] = __fadd_rn(s_gz[j], __shfl_xor_sync(0xffffffffu, s_gz[j], off));
      s_gx[j] = __fadd_rn(s_gx[j], __shfl_xor_sync(0xffffffffu, s_gx[j], off));
    }
    if (lane < kGroups) {
      red[warp][0][lane * 8 + j] = s_gz[j];
      red[warp][1][lane * 8 + j] = s_gx[j];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2 * kCout) {
    const int k = threadIdx.x / kCout, o = threadIdx.x % kCout;
    float s = 0.0f;
    for (int v = 0; v < kWarps; ++v) s = __fadd_rn(s, red[v][k][o]);
    partials[(long long)blockIdx.x * 2 * kCout + threadIdx.x] = s;
  }
}

// K6.  dW[tap][co] = sum over conv pixels of bf16(x)[tap] * bf16(dy)[co],
// dy = inv * gz - c1 - xhat * c2 (stem.py:321), a (27 x N) by (N x 32)
// product over N = B*H*W.  Each block walks chunks of kChunk pooled pixels
// (4 * kChunk conv pixels, the rows): half its threads compute the chunk's
// dy rows, half its im2col rows, both into shared memory; then every
// thread adds the chunk's rows into its (up to 4) outputs m = tap * 32 + co
// with m = threadIdx.x + 256 k, so a warp reads one x value (a broadcast)
// and 32 consecutive dy values per row.  Block partials partials[block][864].
constexpr int kChunk = 32;                       // pooled pixels per chunk
constexpr int kRows = kChunk * kPhases;          // 128 conv pixels
constexpr int kDyStride = kCout + 1;             // no bank conflicts on stores
constexpr int kOut = kTaps * kCout;              // 864
constexpr int kOutPerThread = (kOut + kThreads - 1) / kThreads;   // 4

__global__ void __launch_bounds__(kThreads)
stem_bwd_dw_kernel(const __nv_bfloat16* __restrict__ y,
                   const __nv_bfloat16* __restrict__ g,
                   const float* __restrict__ x,
                   const float* __restrict__ inv,
                   const float* __restrict__ shift,
                   const float* __restrict__ mean,
                   const float* __restrict__ rstd,
                   const float* __restrict__ c1,
                   const float* __restrict__ c2,
                   float* __restrict__ partials, int B, int H, int W) {
  __shared__ float sdy[kRows * kDyStride];
  __shared__ float sx[kRows * kTaps];
  const int Hp = H / 2, Wp = W / 2;
  const long long total = (long long)B * Hp * Wp;
  const long long nchunks = (total + kChunk - 1) / kChunk;

  // the dy half: thread (j, q) of the first 128 threads
  const int tq = threadIdx.x % kGroups;
  BnParams bp;
  float c1v[8], c2v[8];
  load_params(bp, tq, inv, shift, mean, rstd);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    c1v[j] = c1[tq * 8 + j];
    c2v[j] = c2[tq * 8 + j];
  }

  float acc[kOutPerThread];
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) acc[k] = 0.0f;

  for (long long chunk = blockIdx.x; chunk < nchunks; chunk += gridDim.x) {
    if (threadIdx.x < kChunk * kGroups) {
      const int jp = threadIdx.x / kGroups;
      const long long pix = chunk * kChunk + jp;
      float gz[kPhases][8], xhat[kPhases][8];
      if (pix < total) {
        grad_z(y, g, pix, tq, bp, gz, xhat);
      } else {
#pragma unroll
        for (int p = 0; p < kPhases; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) gz[p][j] = xhat[p][j] = 0.0f;
      }
#pragma unroll
      for (int p = 0; p < kPhases; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float dy = __fsub_rn(
              __fsub_rn(__fmul_rn(bp.inv[j], gz[p][j]), c1v[j]),
              __fmul_rn(xhat[p][j], c2v[j]));
          sdy[(jp * kPhases + p) * kDyStride + tq * 8 + j] =
              pix < total ? round_bf16(dy) : 0.0f;
        }
    } else {
      // the im2col half: row r = (pooled pixel jp, window position p)
      const int r = threadIdx.x - kChunk * kGroups;
      const int jp = r / kPhases, p = r % kPhases;
      const long long pix = chunk * kChunk + jp;
      float* row = sx + r * kTaps;
      if (pix < total) {
        const int px = (int)(pix % Wp);
        const long long t = pix / Wp;
        const int py = (int)(t % Hp), b = (int)(t / Hp);
        const int cy = 2 * py + p / 2, cx = 2 * px + p % 2;
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          const int iy = cy + ky - 1;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            const int ix = cx + kx - 1;
            const bool in = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const float* src = x + (((long long)b * H + iy) * W + ix) * kCin;
#pragma unroll
            for (int ci = 0; ci < kCin; ++ci)
              row[(ky * 3 + kx) * kCin + ci] = in ? round_bf16(src[ci]) : 0.0f;
          }
        }
      } else {
        for (int i = 0; i < kTaps; ++i) row[i] = 0.0f;
      }
    }
    __syncthreads();
    // the chunk's rows summed apart, then added to the block's running
    // sums: f32 chains of kRows + chunks, not kRows * chunks, additions
    const int co = threadIdx.x % 32;
    float part[kOutPerThread];
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) part[k] = 0.0f;
    for (int r = 0; r < kRows; ++r) {
      const float d = sdy[r * kDyStride + co];
#pragma unroll
      for (int k = 0; k < kOutPerThread; ++k) {
        const int tap = (threadIdx.x + k * kThreads) / kCout;
        if (tap < kTaps) part[k] = fmaf(sx[r * kTaps + tap], d, part[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) acc[k] = __fadd_rn(acc[k], part[k]);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int m = threadIdx.x + k * kThreads;
    if (m < kOut) partials[(long long)blockIdx.x * kOut + m] = acc[k];
  }
}

int reduce(const float* partials, float* out, int P, int M,
           cudaStream_t stream) {
  reduce_partials_kernel<<<M, kThreads, 0, stream>>>(partials, out, P, M);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes.  Each launches on `stream` and returns
// cudaGetLastError() (0 = launched); the wrappers check every argument.

// Blocks of K3 (= the rows of its partials) for a (B, H, W) image.
extern "C" long long stem_conv_stats_blocks(int B, int H, int W) {
  const long long n = (long long)B * (H / 2) * (W / 2);
  return (n + kThreads - 1) / kThreads;
}

// x (B, H, W, 3) f32, w (32, 3, 3, 3) f32 -> y (B, H/2, W/2, 4, 32) bf16 and
// sums (2, 32) f32, through partials (stem_conv_stats_blocks, 2, 32) f32.
extern "C" int stem_conv_stats_launch(const float* x, const float* w, void* y,
                                      float* partials, float* sums, int B,
                                      int H, int W, void* stream) {
  const long long blocks = stem_conv_stats_blocks(B, H, W);
  if (blocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  stem_conv_stats_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      x, w, reinterpret_cast<__nv_bfloat16*>(y), partials, B, H, W);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce(partials, sums, (int)blocks, 2 * kCout, s);
}

// y (B, H/2, W/2, 4, 32) bf16, inv and shift (32,) f32 -> out (B, H/2, W/2,
// 32) bf16; `total` = B * H/2 * W/2.
extern "C" int stem_bn_pool_launch(const void* y, const float* inv,
                                   const float* shift, void* out,
                                   long long total, void* stream) {
  if (total == 0) return 0;
  const long long blocks = (total * kGroups + kThreads - 1) / kThreads;
  stem_bn_pool_kernel<<<(unsigned)blocks, kThreads, 0,
                        reinterpret_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const __nv_bfloat16*>(y), inv, shift,
      reinterpret_cast<__nv_bfloat16*>(out), total);
  return (int)cudaGetLastError();
}

// Blocks of K5 and K6 (the rows of their partials): a function of the shape
// alone, so the sums are the same bits from run to run.
extern "C" long long stem_bwd_sums_blocks(long long total) {
  const long long need = (total * kGroups + kThreads - 1) / kThreads;
  return need < 1056 ? need : 1056;              // 8 blocks per SM
}

extern "C" long long stem_bwd_dw_blocks(long long total) {
  const long long need = (total + kChunk - 1) / kChunk;
  return need < 528 ? need : 528;                // 4 blocks per SM
}

// y, g (B, H/2, W/2, 32) bf16 and the (32,) f32 vectors -> sums (2, 32) f32
// = (sum gz, sum gz * xhat), through partials (stem_bwd_sums_blocks, 2, 32).
extern "C" int stem_bwd_sums_launch(const void* y, const void* g,
                                    const float* inv, const float* shift,
                                    const float* mean, const float* rstd,
                                    float* partials, float* sums,
                                    long long total, void* stream) {
  const long long blocks = stem_bwd_sums_blocks(total);
  if (blocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  stem_bwd_sums_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(y),
      reinterpret_cast<const __nv_bfloat16*>(g), inv, shift, mean, rstd,
      partials, total);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce(partials, sums, (int)blocks, 2 * kCout, s);
}

// y, g as K5, x (B, H, W, 3) f32, the (32,) f32 vectors -> dw (27, 32) f32,
// rows tap = (ky * 3 + kx) * 3 + ci, through partials (stem_bwd_dw_blocks,
// 864) f32.
extern "C" int stem_bwd_dw_launch(const void* y, const void* g, const float* x,
                                  const float* inv, const float* shift,
                                  const float* mean, const float* rstd,
                                  const float* c1, const float* c2,
                                  float* partials, float* dw, int B, int H,
                                  int W, void* stream) {
  const long long blocks =
      stem_bwd_dw_blocks((long long)B * (H / 2) * (W / 2));
  if (blocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  stem_bwd_dw_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(y),
      reinterpret_cast<const __nv_bfloat16*>(g), x, inv, shift, mean, rstd,
      c1, c2, partials, B, H, W);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce(partials, dw, (int)blocks, kOut, s);
}
