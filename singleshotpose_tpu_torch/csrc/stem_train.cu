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
// on the bf16 tensor cores.  K3 runs it as f32 FMAs on the CUDA cores, one
// thread per pooled pixel as K1 does (the conv is stem_common.cuh, shared
// with K1); K6 runs dW's product on the tensor cores (see K6).
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
// fmaf there is a product and one rounded add, and K6's tensor cores only
// sum them in another order.  The kernels allocate
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
// dy = inv * gz - c1 - xhat * c2 (stem.py:321): a (27 x N) by (N x 32)
// product over the N = B*H*W conv pixels.
//
// What bounds it.  It reads y, g and x once (88.6 + 22.2 + 16.6 = 127.4 MB
// at batch 8, 416^2): >= 38.0 us at 3.35 TB/s.  The product is 2.39 GFLOP,
// 2.4 us on the bf16 tensor cores, and the per-element BN backward that
// makes dy is the same work as K5's.  So the design moves each byte once
// and keeps the product off the CUDA cores.  What is left bounds it by
// instruction issue: dy costs ~20 instructions a conv pixel and channel,
// and neither a third stage of copies nor more blocks per SM moved its
// time.
//
// Tiles.  A tile is kTileRows x kTileCols pooled pixels of one image (2 x
// 16: 128 conv pixels, the product's K); the blocks walk the tiles with a
// grid-stride loop over a grid that depends on the shape alone.  Missing
// pixels of a tile at a ragged edge get dy = 0 (and x = 0 outside the
// image, the conv's padding).
//
// Staging.  The tile's y (32 x 256 B), g (32 x 64 B) and x halo (6 image
// rows x 34 columns x 3 channels, f32, zeros outside the image) are copied
// into shared memory once with cp.async, y and g in 16-byte chunks, the
// halo along its rows (each row segment is contiguous in (B, H, W, 3)) in
// 16-byte chunks when W is a multiple of 4, else in 4-byte words, into one
// of two stages: the next tile's copies are in flight while this tile
// computes.  TMA is not needed: a tile is ~13 KB in 10 contiguous pieces
// of at most 4 KB, and cp.async overlaps them as well.
//
// Operands.  Every thread computes dy for one pooled pixel and 4 channels
// (window_dy: K5's routing) and writes it as bf16 into sB[k][co], k =
// the tile's conv pixel (pooled pixel * 4 + window position); then every
// thread writes half of one im2col row, bf16(x) from the halo, into
// sA[k][tap] (taps padded to 32 with zeros).  Both have a row stride of
// kLd = 40 bf16 (80 B), so the rows that one ldmatrix phase reads, and the
// rows that 8 threads store, fall in distinct banks.
//
// Product.  mma.sync m16n8k16 (bf16 products, f32 sums) on operands read
// with ldmatrix .trans: sA holds A transposed (K x taps), sB holds B (K x
// co).  dW is 32 x 32, four 16 x 16 tiles; warp w takes tile w % 4 over
// the conv pixels 64 (w / 4) .. 64 (w / 4) + 63, 16 at a time.  Each 16 x
// 8 product starts from zero on the tensor cores, whose sums truncate, and
// is added to the warp's accumulator (8 registers a lane, kept across its
// tiles) with f32 round-to-nearest: the hardware's rounding reaches 16
// products only, and the f32 chains are as long as the block's tile count.
// At the end the accumulators go through shared memory and the two warps
// of each output tile are summed in warp order into the block's row of
// partials[block][864].  wgmma is not used: a 27-row A fills less than
// half of its 64-row tile, and the product is 2.4 us of tensor-core time
// under a 38 us byte bound.
constexpr int kTileRows = 2;                     // pooled rows of a tile
constexpr int kTileCols = 16;                    // pooled columns of a tile
constexpr int kTilePix = kTileRows * kTileCols;  // 32 pooled pixels
constexpr int kTileK = kTilePix * kPhases;       // 128 conv pixels
constexpr int kLd = 40;                          // sA, sB row stride, bf16
constexpr int kHaloRows = 2 * kTileRows + 2;     // 6 image rows
constexpr int kHaloWords = (2 * kTileCols + 2) * kCin;   // 102 f32 a row
constexpr int kHaloStride = 112;   // words: = 16 mod 32, so a warp's two
                                   // conv rows read distinct banks
constexpr int kOut = kTaps * kCout;              // 864
constexpr int kDwBlocksPerSm = 3;                // the grid: 396 blocks
constexpr int kOutPerThread = (kOut + kThreads - 1) / kThreads;   // 4
// a stage of the staged tile (y, g, halo), in bytes; after the loop the
// warps' accumulators reuse the stages
constexpr int kStageY = kTilePix * kPhases * kCout * 2;           // 8192
constexpr int kStageG = kTilePix * kCout * 2;                     // 2048
constexpr int kStageBytes = kStageY + kStageG + kHaloRows * kHaloStride * 4;
constexpr int kStages = 2;
static_assert(kStageBytes % 128 == 0, "16-byte copies need aligned stages");
static_assert(kWarps == 8 && kTileK == 128,
              "8 warps: 4 output tiles x 2 halves of the tile's 128 pixels");
static_assert(kWarps * 256 * 4 <= kStages * kStageBytes,
              "the accumulators must fit in the reused stages");
static_assert(kThreads == 2 * kTileK && kThreads == kTilePix * 8,
              "one thread a (pixel, 4 channels) and half an im2col row");

__device__ __forceinline__ void unpack4(const uint2& v, float (&out)[4]) {
  const float2 lo = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.x));
  const float2 hi = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&v.y));
  out[0] = lo.x;
  out[1] = lo.y;
  out[2] = hi.x;
  out[3] = hi.y;
}

// dy = bf16(inv * gz - c1 - xhat * c2) at the window's four positions, for
// 4 channels of one pooled pixel, with grad_z's routing and the plain
// version's roundings: z and the rounded leaky output recomputed, g routed
// to the first maximum in window order (a strict > scan) times leaky'(z).
// The rounded leaky output of a bf16 z is max(z, bf16(slope * z)), since
// rounding is monotonic and z is representable.  Off the first maximum gz
// = 0, where inv * gz - c1 is -c1 exactly, so the routed term is formed
// once per channel.
__device__ __forceinline__ void window_dy(const float (&yv)[kPhases][4],
                                          const float (&gv)[4],
                                          const float (&inv)[4],
                                          const float (&shift)[4],
                                          const float (&mean)[4],
                                          const float (&rstd)[4],
                                          const float (&c1)[4],
                                          const float (&c2)[4],
                                          float (&dy)[kPhases][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float z[kPhases], a[kPhases];
#pragma unroll
    for (int p = 0; p < kPhases; ++p) {
      z[p] = round_bf16(__fadd_rn(__fmul_rn(yv[p][j], inv[j]), shift[j]));
      a[p] = fmaxf(z[p], round_bf16(__fmul_rn(kSlope, z[p])));
    }
    int first = 0;
    float best = a[0], z_first = z[0];
#pragma unroll
    for (int p = 1; p < kPhases; ++p) {
      const bool more = a[p] > best;
      best = more ? a[p] : best;
      z_first = more ? z[p] : z_first;
      first = more ? p : first;
    }
    const float routed = __fsub_rn(
        __fmul_rn(inv[j], __fmul_rn(gv[j], z_first >= 0.0f ? 1.0f : kSlope)),
        c1[j]);
#pragma unroll
    for (int p = 0; p < kPhases; ++p)
      dy[p][j] = __fsub_rn(p == first ? routed : -c1[j],
                           __fmul_rn(__fmul_rn(__fsub_rn(yv[p][j], mean[j]),
                                               rstd[j]),
                                     c2[j]));
  }
}

__device__ __forceinline__ void to4(const float4& f, float (&out)[4]) {
  out[0] = f.x;
  out[1] = f.y;
  out[2] = f.z;
  out[3] = f.w;
}

__device__ __forceinline__ uint32_t pack2(float a, float b) {
  const __nv_bfloat162 two = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&two);
}

// Asynchronous copies of 16 and 4 bytes from global to shared memory;
// zeros when !in (a source size of 0 reads nothing).
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 16 : 0) : "memory");
}

__device__ __forceinline__ void copy4(float* dst, const float* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(in ? 4 : 0) : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ldmatrix .x4 .trans: four 8 x 8 bf16 blocks, transposed, lane L giving
// the address of row L % 8 of block L / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const __nv_bfloat16* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// d = A (16 x 16, row) * B (16 x 8, col) + 0 on the tensor cores: bf16
// products, f32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}

// The tiles a block walks: t = blockIdx.x, + gridDim.x, ..., as (image b,
// tile row ty, tile column tx), advanced without a division.
struct TileCursor {
  int b, ty, tx, step_b, step_y, step_x, tiles_y, tiles_x;

  __device__ TileCursor(int t, int tiles_y_, int tiles_x_)
      : tiles_y(tiles_y_), tiles_x(tiles_x_) {
    tx = t % tiles_x;
    ty = t / tiles_x % tiles_y;
    b = t / tiles_x / tiles_y;
    step_x = gridDim.x % tiles_x;
    step_y = gridDim.x / tiles_x % tiles_y;
    step_b = gridDim.x / tiles_x / tiles_y;
  }

  __device__ __forceinline__ int py0() const { return ty * kTileRows; }
  __device__ __forceinline__ int px0() const { return tx * kTileCols; }

  __device__ __forceinline__ void advance() {
    tx += step_x;
    const int cx = tx >= tiles_x;
    tx -= cx ? tiles_x : 0;
    ty += step_y + cx;
    const int cy = ty >= tiles_y;
    ty -= cy ? tiles_y : 0;
    b += step_b + cy;
  }
};

// This thread's copies of a tile, their offsets fixed for the kernel: y's
// chunk `sub` of pooled column c in both tile rows; one chunk of g
// (threads < 128); the halo's rows.  y's pixels sit 256 B apart with their
// 16-byte chunks XOR-swizzled by the pixel's parity, so that the two
// pixels of a half-warp's 8-byte reads fall in distinct banks.
//
// The halo: when W is a multiple of 4 (kWide), a row of (B, H, W, 3) f32
// starts on a 16-byte boundary, so the 102 words of a halo row, which
// start one word past one, are covered by 26 16-byte chunks, each wholly
// inside or outside the image row: 156 copies of 16 bytes, the word
// (column, channel) at 1 + 3 column + channel of the staged row.
// Otherwise 612 copies of 4 bytes, the word at 3 column + channel.
template <bool kWide>
struct TileCopies {
  static constexpr int kChunks = kWide ? 26 : kHaloWords;   // a halo row
  static constexpr int kChunkWords = kWide ? 4 : 1;
  static constexpr int kLead = kWide ? 1 : 0;   // staged word of column 0
  static constexpr int kHaloCopies =
      (kHaloRows * kChunks + kThreads - 1) / kThreads;   // 1 or 3
  static_assert(kChunks * kChunkWords >= kLead + kHaloWords &&
                    kChunks * kChunkWords <= kHaloStride,
                "the chunks cover a halo row and fit in a staged one");
  int H, W, Hp, Wp;
  int c, y_dst, y_off, g_r, g_c, g_dst, g_off;
  int h_row[kHaloCopies], h_word[kHaloCopies], h_dst[kHaloCopies],
      h_off[kHaloCopies];

  __device__ TileCopies(int H_, int W_) : H(H_), W(W_), Hp(H_ / 2), Wp(W_ / 2) {
    const int t = threadIdx.x;
    c = t / 16 % kTileCols;
    const int sub = t % 16;
    y_dst = c * 256 + (sub ^ ((c & 1) << 2)) * 16;
    y_off = c * 16 + sub;
    const int jp = t / 4 % kTilePix;
    g_r = jp / kTileCols;
    g_c = jp % kTileCols;
    g_dst = kStageY + jp * 64 + t % 4 * 16;
    g_off = (g_r * Wp + g_c) * 4 + t % 4;
#pragma unroll
    for (int q = 0; q < kHaloCopies; ++q) {
      // the last threads take the halo, the first ones g
      const int i = kThreads - 1 - t + q * kThreads;
      const int ch = i % kChunks;
      h_row[q] = i < kHaloRows * kChunks ? i / kChunks : -1;
      h_word[q] = ch * kChunkWords - kLead;   // from column 0, channel 0
      h_dst[q] = h_row[q] * kHaloStride + ch * kChunkWords;
      h_off[q] = h_row[q] * W * kCin + h_word[q];
    }
  }

  // Starts the copies of the tile at (b, py0, px0) into `stage`; zeros
  // for its pixels outside the image.
  __device__ __forceinline__ void start(unsigned char* stage,
                                        const __nv_bfloat16* __restrict__ y,
                                        const __nv_bfloat16* __restrict__ g,
                                        const float* __restrict__ x, int b,
                                        int py0, int px0) const {
    const long long base = ((long long)b * Hp + py0) * Wp + px0;
    const uint4* ys = reinterpret_cast<const uint4*>(y);
    const uint4* gs = reinterpret_cast<const uint4*>(g);
    const bool col_in = px0 + c < Wp;
#pragma unroll
    for (int r = 0; r < kTileRows; ++r) {
      const bool in = col_in && py0 + r < Hp;
      copy16(stage + r * kTileCols * 256 + y_dst,
             ys + (in ? base * 16 + r * Wp * 16 + y_off : 0), in);
    }
    if (threadIdx.x < kTilePix * 4) {
      const bool in = px0 + g_c < Wp && py0 + g_r < Hp;
      copy16(stage + g_dst, gs + (in ? base * 4 + g_off : 0), in);
    }
    float* halo = reinterpret_cast<float*>(stage + kStageY + kStageG);
    // word 0 of the halo's first row: (2 py0 - 1, 2 px0 - 1, channel 0)
    const int w0 = (2 * px0 - 1) * kCin;
    const long long xb = ((long long)b * H + 2 * py0 - 1) * W * kCin + w0;
#pragma unroll
    for (int q = 0; q < kHaloCopies; ++q) {
      if (h_row[q] < 0) continue;
      const bool in = (unsigned)(2 * py0 - 1 + h_row[q]) < (unsigned)H &&
                      (unsigned)(w0 + h_word[q]) < (unsigned)(W * kCin);
      if (kWide)
        copy16(halo + h_dst[q], x + (in ? xb + h_off[q] : 0), in);
      else
        copy4(halo + h_dst[q], x + (in ? xb + h_off[q] : 0), in);
    }
  }
};

// Taps T0 .. T0 + 15 of one im2col row: bf16(x) from the halo at the conv
// pixel's top-left tap `src`, zeros past the 27th tap.
template <int T0>
__device__ __forceinline__ void im2col_half(const float* src,
                                            __nv_bfloat16* dst) {
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t0 = T0 + 2 * i, t1 = t0 + 1;   // tap = ky * 9 + kx * 3 + ci
    const float v0 = t0 < kTaps ? src[(t0 / 9) * kHaloStride + t0 % 9] : 0.0f;
    const float v1 = t1 < kTaps ? src[(t1 / 9) * kHaloStride + t1 % 9] : 0.0f;
    w[i] = pack2(v0, v1);
  }
  uint4* d = reinterpret_cast<uint4*>(dst);
  d[0] = make_uint4(w[0], w[1], w[2], w[3]);
  d[1] = make_uint4(w[4], w[5], w[6], w[7]);
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads, kDwBlocksPerSm)
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
  __shared__ __align__(128) unsigned char stages[kStages * kStageBytes];
  __shared__ __align__(128) __nv_bfloat16 sA[kTileK * kLd];
  __shared__ __align__(128) __nv_bfloat16 sB[kTileK * kLd];
  __shared__ float4 vecs[6][kCout / 4];   // inv, shift, mean, rstd, c1, c2
  const int Hp = H / 2, Wp = W / 2;
  const int tiles_x = (Wp + kTileCols - 1) / kTileCols;
  const int tiles_y = (Hp + kTileRows - 1) / kTileRows;
  const int ntiles = B * tiles_y * tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (threadIdx.x < 6 * kCout) {          // read after the loop's barrier
    const int v = threadIdx.x / kCout, c = threadIdx.x % kCout;
    const float* src = v == 0 ? inv : v == 1 ? shift : v == 2 ? mean
                     : v == 3 ? rstd : v == 4 ? c1 : c2;
    reinterpret_cast<float*>(vecs)[threadIdx.x] = src[c];
  }
  const TileCopies<kWide> copies(H, W);

  // dy: pooled pixel jp of the tile, channels 4h .. 4h + 3
  const int jp = threadIdx.x / 8, h = threadIdx.x % 8;
  // im2col: conv pixel k of the tile, taps 16 * half .. 16 * half + 15
  const int k = threadIdx.x % kTileK, half = threadIdx.x / kTileK;
  const int kp = k / kPhases, kw = k % kPhases;
  const int cy = 2 * (kp / kTileCols) + kw / 2;
  const int cx = 2 * (kp % kTileCols) + kw % 2;
  // the product: dW rows 16 ti .. 16 ti + 15, columns 16 tj .. 16 tj + 15,
  // over the tile's conv pixels k0 .. k0 + 63; each lane's ldmatrix rows
  const int ti = warp % 4 / 2, tj = warp % 2, k0 = warp / 4 * (kTileK / 2);
  const __nv_bfloat16* a_row =
      sA + (k0 + lane / 16 * 8 + lane % 8) * kLd + 16 * ti + lane / 8 % 2 * 8;
  const __nv_bfloat16* b_row =
      sB + (k0 + lane / 8 % 2 * 8 + lane % 8) * kLd + 16 * tj + lane / 16 * 8;
  float acc[2][4] = {};   // the two 16 x 8 halves of the warp's output tile

  TileCursor tile(blockIdx.x, tiles_y, tiles_x), next = tile;
  if ((int)blockIdx.x < ntiles)
    copies.start(stages, y, g, x, tile.b, tile.py0(), tile.px0());
  copies_commit();
  for (int t = blockIdx.x, s = 0; t < ntiles;
       t += gridDim.x, s ^= 1, tile = next) {
    next.advance();
    if (t + (int)gridDim.x < ntiles)   // the other stage was read before
      copies.start(stages + (s ^ 1) * kStageBytes, y, g, x, next.b,
                   next.py0(), next.px0());     // the last barrier
    copies_commit();
    copies_wait<1>();      // this thread's copies of tile t have landed,
    __syncthreads();       // and every thread's
    const unsigned char* stage = stages + s * kStageBytes;
    const int py0 = tile.py0(), px0 = tile.px0();

    {  // dy -> sB
      const bool valid = py0 + jp / kTileCols < Hp &&
                         px0 + jp % kTileCols < Wp;
      float iv[4], sh[4], mu[4], rs[4], c1v[4], c2v[4];
      to4(vecs[0][h], iv);
      to4(vecs[1][h], sh);
      to4(vecs[2][h], mu);
      to4(vecs[3][h], rs);
      to4(vecs[4][h], c1v);
      to4(vecs[5][h], c2v);
      float yv[kPhases][4], gv[4], d[kPhases][4] = {};
      if (valid) {
#pragma unroll
        for (int p = 0; p < kPhases; ++p) {
          const int sub = (p * 4 + h / 2) ^ ((jp & 1) << 2);
          unpack4(*reinterpret_cast<const uint2*>(
                      stage + jp * 256 + sub * 16 + (h % 2) * 8), yv[p]);
        }
        unpack4(*reinterpret_cast<const uint2*>(
                    stage + kStageY + jp * 64 + h * 8), gv);
        window_dy(yv, gv, iv, sh, mu, rs, c1v, c2v, d);
      }
#pragma unroll
      for (int p = 0; p < kPhases; ++p)
        *reinterpret_cast<uint2*>(sB + (jp * kPhases + p) * kLd + 4 * h) =
            make_uint2(pack2(d[p][0], d[p][1]), pack2(d[p][2], d[p][3]));
    }
    {  // im2col -> sA
      const float* src = reinterpret_cast<const float*>(
                             stage + kStageY + kStageG) +
                         cy * kHaloStride + cx * kCin +
                         TileCopies<kWide>::kLead;
      if (half == 0)
        im2col_half<0>(src, sA + k * kLd);
      else
        im2col_half<16>(src, sA + k * kLd + 16);
    }
    __syncthreads();

    // the warp's output tile over its 64 conv pixels, 16 at a time: each
    // 16 x 8 product summed from zero on the tensor cores, then added here
#pragma unroll
    for (int kk = 0; kk < kTileK / 2; kk += 16) {
      uint32_t a[4], b[4];
      ldmatrix_x4_trans(a, a_row + kk * kLd);
      ldmatrix_x4_trans(b, b_row + kk * kLd);
      float d[2][4];
      mma_bf16(d[0], a, b[0], b[1]);
      mma_bf16(d[1], a, b[2], b[3]);
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(acc[n][e], d[n][e]);
    }
    // no barrier here: the next tile's copies go to the other stage, and
    // its sA and sB are written after the next barrier
  }
  copies_wait<0>();
  __syncthreads();   // the accumulators reuse the stages

  // red[warp][16][16] (mma's layout: lane holds rows lane / 4 and + 8,
  // columns 2 (lane % 4) and + 1 of each 16 x 8 half); output (tap, co) is
  // in warps u and u + 4 of its tile u, summed in that order
  float* red = reinterpret_cast<float*>(stages);
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    float* o = red + warp * 256 + lane / 4 * 16 + n * 8 + lane % 4 * 2;
    o[0] = acc[n][0];
    o[1] = acc[n][1];
    o[8 * 16] = acc[n][2];
    o[8 * 16 + 1] = acc[n][3];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kOutPerThread; ++q) {
    const int m = threadIdx.x + q * kThreads;
    if (m < kOut) {
      const int tap = m / kCout, co = m % kCout;
      const int u = tap / 16 * 2 + co / 16, e = tap % 16 * 16 + co % 16;
      partials[(long long)blockIdx.x * kOut + m] =
          __fadd_rn(red[u * 256 + e], red[(u + 4) * 256 + e]);
    }
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

// Blocks of K6: one per tile up to kDwBlocksPerSm on each of the 132 SMs.
extern "C" long long stem_bwd_dw_blocks(int B, int H, int W) {
  const long long tiles = (long long)B * ((H / 2 + kTileRows - 1) / kTileRows) *
                          ((W / 2 + kTileCols - 1) / kTileCols);
  return tiles < 132 * kDwBlocksPerSm ? tiles : 132 * kDwBlocksPerSm;
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
  const long long blocks = stem_bwd_dw_blocks(B, H, W);
  if (blocks == 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  // 16-byte halo copies when every image row starts 16-byte aligned
  const bool wide =
      W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = wide ? stem_bwd_dw_kernel<true> : stem_bwd_dw_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      reinterpret_cast<const __nv_bfloat16*>(y),
      reinterpret_cast<const __nv_bfloat16*>(g), x, inv, shift, mean, rstd,
      c1, c2, partials, B, H, W);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return reduce(partials, dw, (int)blocks, kOut, s);
}
