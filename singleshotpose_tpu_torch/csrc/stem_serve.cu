// Folded serving stem for Hopper (sm_90a): conv 3x3 s1 p1, 3 -> 32 channels,
// + folded BN bias, leaky (slope bf16(0.1)), 2x2/2 max pool, in one kernel.
//
// Replaces singleshotpose_tpu/ops/stem.py:_k_serve (the Pallas TPU kernel
// behind stem_conv_pool_infer), which runs the conv as a bf16 dot_general
// with f32 sums on the MXU.
//
// What bounds it.  The kernel reads the f32 image once and writes the pooled
// bf16 output once: at batch 8, 672^2, 43.35 MB + 57.80 MB, >= 30.2 us at
// 3.35 TB/s.  The conv is 3.12 G multiply-adds; as f32 FMAs on the CUDA
// cores (the first version of this kernel) that alone is 93 us at 67
// TFLOP/s, on the bf16 tensor cores (27 taps padded to 32) 7.5 us.  So the
// conv runs on the tensor cores, and what is left besides the bytes is
// instruction issue: the gather, and ~5 instructions for each of the 115.6
// M conv outputs (the k-step sum, two bf16 roundings around the bias add,
// the pool's max).  Measured on an H100 (scripts/stem_serve_variants.py),
// the copies and stores alone take 3/4 of the kernel's time, and the
// kernel without its copies, or without its stores, 9/10 of it: the bytes
// and the compute overlap only in part.
//
// Design.  A persistent grid (2 blocks an SM) walks tiles of 8 x 16 pooled
// pixels of one image.  A tile's image halo (18 rows x 34 columns x 3
// channels, f32, zeros outside the image) is copied into shared memory once
// with cp.async, in 16-byte chunks when W is a multiple of 4 and the image
// is 16-byte aligned, else in 4-byte words (template kWide, picked at
// launch), into one of three stages: the next two tiles' copies are in
// flight while this one computes, and one barrier a tile suffices.  Each
// warp keeps its B fragments (the bf16 weights, 16 registers) and its
// lanes' bias for its whole life, and computes two groups of 8 pooled
// pixels a tile with stem_common.cuh's tensor-core conv: the A fragments
// gathered straight from the staged halo (no im2col copy, no bank
// conflicts), 16 mma.sync.m16n8k16 a group.  The mma's C layout leaves each
// lane all four window positions of its pixel for 8 channels, so the
// epilogue runs in registers on bf16 pairs: z = bf16(bf16(acc) + bias), the
// max of the 4 positions, then leaky once, as max(z, bf16(slope z)).  The 8
// pixels' 32 channels are then regrouped through 512 bytes of shared memory
// a warp, so that each lane stores one 16-byte piece and a warp writes 512
// contiguous bytes of the NHWC output.
//
// Rounding points, as in _k_serve (stem.py:562-565): products of
// bf16-rounded operands summed in f32 (the tensor cores, each k-step from
// zero, the two added in f32 round-to-nearest); the sum
// rounded to bf16; the f32 bias added to that, rounded to bf16 again; leaky
// on the rounded value with the bf16 product rounded once; the max over the
// 4 positions (taken before leaky, which is monotone: the same value); one
// bf16 store.  The f32 sums run in another order than F.conv2d's, so a conv
// output near a bf16 rounding boundary may round the other way.  The
// kernel allocates nothing, uses no atomics, and gives the same bits from
// run to run.

#include "stem_common.cuh"

namespace {

using stem::kCout;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 8;                        // pooled rows of a tile
constexpr int kTileCols = stem::kTcCols;            // pooled columns, 16
constexpr int kGroups = kTileRows * kTileCols / 8;  // 16 groups of 8 pixels
constexpr int kStages = 3;
constexpr int kBlocksPerSm = 2;
constexpr int kS = stem::kTcStride;
using Halo = stem::HaloTile<kTileRows>;
static_assert(kGroups % kWarps == 0, "every warp takes as many groups");
// bf16(0.1) in both halves of a bf16 pair
constexpr uint32_t kSlope2 = 0x3DCD3DCDu;

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t bf16x2_max(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// z = bf16(bf16(s) + bias) of a pair of f32 conv outputs, as a bf16 pair.
__device__ __forceinline__ uint32_t biased(float s0, float s1, float b0,
                                           float b1) {
  const uint32_t r = stem::pack2(s0, s1);
  const float z0 = __fadd_rn(__uint_as_float(r << 16), b0);
  const float z1 = __fadd_rn(__uint_as_float(r & 0xffff0000u), b1);
  return stem::pack2(z0, z1);
}

// leaky of a bf16 pair: for a bf16 z, where(z >= 0, z, bf16(slope z)) =
// max(z, bf16(slope z)), since 0 < slope < 1.  It is monotone, so the max
// of the leaky outputs of a window is the leaky output of its max.
__device__ __forceinline__ uint32_t leaky(uint32_t z) {
  return bf16x2_max(z, bf16x2_mul(z, kSlope2));
}

// x: (B, H, W, 3) f32; w: (32, 3, 3, 3) f32 OIHW, BN folded; bias: (32,) f32;
// out: (B, H/2, W/2, 32) bf16.
template <bool kWide>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
stem_serve_kernel(const float* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ bias,
                  __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  __shared__ __align__(128) float stages[kStages][Halo::kWords];
  __shared__ __align__(16) uint32_t regroup[kWarps][8 * 16];
  const int Hp = H / 2, Wp = W / 2;
  const int tiles_x = (Wp + kTileCols - 1) / kTileCols;
  const int tiles_y = (Hp + kTileRows - 1) / kTileRows;
  const int ntiles = B * tiles_y * tiles_x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  uint32_t bw[2][4][2];
  stem::load_tc_weights(bw, w, lane);
  float bs[4][2];   // the bias of channels 8 n + 2t, + 1
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    bs[n][0] = bias[8 * n + 2 * t];
    bs[n][1] = bias[8 * n + 2 * t + 1];
  }
  const stem::GatherLane gl(lane, kWide ? 1 : 0);
  // the regrouped pixel's 16 words, its 16-byte chunks XOR-swizzled so that
  // neither the 4-byte writes nor the 16-byte reads conflict
  uint32_t* rg = regroup[warp] + 16 * g;
  const int swz = (g >> 1) & 3;

  const stem::HaloCopies<kWide, kTileRows, kThreads, kS> copies(H, W);
  stem::TileWalk tile(blockIdx.x, tiles_y, tiles_x), ahead = tile;
  const int grid = gridDim.x;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {    // the first kStages - 1 tiles
    if ((int)blockIdx.x + k * grid < ntiles)
      copies.start(stages[k], x, ahead.b, ahead.ty * kTileRows,
                   ahead.tx * kTileCols);
    stem::copies_commit();
    ahead.advance();
  }
  for (int i = blockIdx.x, s = 0; i < ntiles; i += grid) {
    // this thread's copies of tile i have landed; past the barrier every
    // thread's have, and no warp still reads the stage of tile i - grid,
    // which tile i + (kStages - 1) grid now takes
    stem::copies_wait<kStages - 2>();
    __syncthreads();
    const int s_ahead = s == 0 ? kStages - 1 : s - 1;
    if (i + (kStages - 1) * grid < ntiles)
      copies.start(stages[s_ahead], x, ahead.b, ahead.ty * kTileRows,
                   ahead.tx * kTileCols);
    stem::copies_commit();
    ahead.advance();

    const float* halo = stages[s];
    const int py0 = tile.ty * kTileRows, px0 = tile.tx * kTileCols;
#pragma unroll
    for (int q = 0; q < kGroups / kWarps; ++q) {
      const int grp = warp + q * kWarps;
      const int pr = grp / 2, half = grp % 2;
      const int py = py0 + pr;
      if (py >= Hp) continue;             // the same for the whole warp
      const float* group = halo + 2 * pr * kS + 48 * half;
      uint32_t best[4];
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        float acc[4][4];
        if (dy == 0)
          stem::conv_row<0>(acc, group, gl, bw);
        else
          stem::conv_row<1>(acc, group, gl, bw);
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const uint32_t m = bf16x2_max(
              biased(acc[n][0], acc[n][1], bs[n][0], bs[n][1]),
              biased(acc[n][2], acc[n][3], bs[n][0], bs[n][1]));
          best[n] = dy == 0 ? m : bf16x2_max(best[n], m);
        }
      }
#pragma unroll
      for (int n = 0; n < 4; ++n) best[n] = leaky(best[n]);
      // chunk n of pixel g holds channels 8 n .. 8 n + 7: lane t's pair of
      // each; lane t then stores chunk t
#pragma unroll
      for (int n = 0; n < 4; ++n) rg[4 * (n ^ swz) + t] = best[n];
      __syncwarp();
      const uint4 v = *reinterpret_cast<const uint4*>(rg + 4 * (t ^ swz));
      __syncwarp();
      const int px = px0 + 8 * half + g;
      if (px < Wp)
        reinterpret_cast<uint4*>(out)[(((long long)tile.b * Hp + py) * Wp +
                                       px) * (kCout / 8) + t] = v;
    }
    s = s == kStages - 1 ? 0 : s + 1;
    tile.advance();
  }
  stem::copies_wait<0>();
}

}  // namespace

// Plain C entry point for ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int stem_conv_pool_infer_launch(const float* x, const float* w,
                                           const float* bias, void* out,
                                           int B, int H, int W,
                                           void* stream) {
  const int Hp = H / 2, Wp = W / 2;
  if (B == 0 || Hp == 0 || Wp == 0) return 0;
  const long long tiles = (long long)B * ((Hp + kTileRows - 1) / kTileRows) *
                          ((Wp + kTileCols - 1) / kTileCols);
  // kBlocksPerSm on each of the H100's 132 SMs; the walk is correct for any
  // grid, so another card only loses balance
  const long long most = 132 * kBlocksPerSm;
  const long long blocks = tiles < most ? tiles : most;
  // 16-byte halo copies when every image row starts 16-byte aligned
  const bool wide = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = wide ? stem_serve_kernel<true> : stem_serve_kernel<false>;
  kernel<<<(unsigned)blocks, kThreads, 0,
           reinterpret_cast<cudaStream_t>(stream)>>>(
      x, w, bias, reinterpret_cast<__nv_bfloat16*>(out), B, H, W);
  return (int)cudaGetLastError();
}
