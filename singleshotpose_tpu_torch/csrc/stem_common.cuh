// Device code shared by the serving stem (stem_serve.cu, K1) and the train
// stem (stem_train.cu, K3-K6): conv 3x3 s1 p1, 3 -> 32 channels, on
// bf16-rounded operands with f32 sums, on the tensor cores; and the PTX
// one-liners the kernels use.
//
// Which kernel uses which routine:
//   - K1 and K3 run the tensor-core conv (TileWalk, HaloCopies, GatherLane,
//     load_tc_weights, conv_row): a block stages a tile's image halo in
//     shared memory with cp.async, and a warp computes 8 pooled pixels' 4 x
//     32 conv outputs as mma.sync products.  K1 pools them; K3 stores them
//     and sums them.
//   - K6 walks its tiles with TileWalk, stages its x halo with HaloCopies at
//     a row stride of its own, and runs its own product (stem_train.cu) on
//     the PTX one-liners (copy16, copy4, copies_commit, copies_wait,
//     ldmatrix_x4_trans, mma_bf16, pack2).
// The tensor cores sum the same exact bf16 products in another order than
// F.conv2d, so a conv output rounded to bf16 can differ from the plain
// versions': mostly by one step, by more where the sum cancels to near 0.

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

// ---------------------------------------------------------------------------
// PTX one-liners
// ---------------------------------------------------------------------------

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

// ---------------------------------------------------------------------------
// The tensor-core conv over a staged image halo
// ---------------------------------------------------------------------------
//
// Tiles.  A tile is kRows x kTcCols pooled pixels of one image.  Its halo,
// image rows 2 py0 - 1 .. 2 py0 + 2 kRows and columns 2 px0 - 1 .. 2 px0 +
// 32, f32 with zeros outside the image (the conv's padding), is staged in
// shared memory: 2 kRows + 2 rows of kTcStride words, the word (halo column
// j, channel ci) at lead + 3 j + ci.  When W is a multiple of 4 and x is
// 16-byte aligned (kWide), every image row starts on a 16-byte boundary and
// a halo row, which starts one word past one (px0 is a multiple of 16), is
// copied as 26 16-byte chunks, each wholly inside or outside the image row,
// with lead = 1; otherwise as 102 4-byte words with lead = 0.
//
// The product.  mma.sync.m16n8k16: A is 16 conv pixels x 32 taps (27 and 5
// zeros, two k-steps), B is 32 taps x 8 channels (four n-tiles), bf16, f32
// sums.  The order of the 32 k rows is free, since A and B use the same one;
// it is chosen so that a lane's A values are words at fixed offsets from its
// conv pixel, the same for every tile:
//   k = 8 ky + o       for o = kx * 3 + ci < 8   (ky = 0, 1, 2: k 0 .. 23)
//   k = 24 + 2 ky      for o = 8                 (k 24, 26, 28)
//   k = 25, 27, 29, 30, 31: zero.
// Lane (g = lane / 4, t = lane % 4) then holds, for each of its rows, the
// words o = 2t and 2t + 1 of halo rows ky = 0, 1, 2 (one 2-word pair each)
// and word 8 of halo row t (t < 3).  That is 7 shared loads a row and
// k-step pair, with constant offsets.
//
// Rows.  A warp owns a group of 8 pooled pixels in a row of the tile, lane
// group g the pixel g, and the product runs as two m-tiles, window row dy =
// 0 and 1.  In m-tile dy, row g is pixel g at window column dx0 = (g >= 4)
// and row g + 8 the same pixel at 1 - dx0: the mma's C fragment puts rows g
// and g + 8 in lane group g, so each lane ends with all four window
// positions of its pixel, for the channels 8 n + 2t, 8 n + 2t + 1.  The swap
// of dx for g >= 4 puts half of a load's 32 words on odd word addresses, so
// with kTcStride = 8 mod 32 no load of the gather has a bank conflict (two
// lanes on one word is a broadcast).
//
// Sums.  Each 16 x 8 product starts from a zero C and the two k-steps are
// added in f32 round-to-nearest: the tensor cores' own f32 sums truncate.
constexpr int kTcCols = 16;                          // pooled columns a tile
constexpr int kTcHaloWords = (2 * kTcCols + 2) * kCin;   // 102 a halo row
constexpr int kTcStride = 104;                       // words a staged row

template <int kRows>
struct HaloTile {
  static constexpr int kRowsStaged = 2 * kRows + 2;
  static constexpr int kWords = kRowsStaged * kTcStride;
  static_assert(kTcStride % 4 == 0 && kTcStride % 32 == 8,
                "16-byte staged rows, conflict-free gathers");
};

// The tiles a block walks: t = blockIdx.x, + gridDim.x, ..., as (image b,
// tile row ty, tile column tx), advanced without a division.
struct TileWalk {
  int b, ty, tx, step_b, step_y, step_x, tiles_y, tiles_x;

  __device__ TileWalk(int t, int tiles_y_, int tiles_x_)
      : tiles_y(tiles_y_), tiles_x(tiles_x_) {
    tx = t % tiles_x;
    ty = t / tiles_x % tiles_y;
    b = t / tiles_x / tiles_y;
    step_x = gridDim.x % tiles_x;
    step_y = gridDim.x / tiles_x % tiles_y;
    step_b = gridDim.x / tiles_x / tiles_y;
  }

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

// This thread's copies of a tile's halo, the block's kThreads threads
// sharing them, into 2 kRows + 2 staged rows of kStride words (K1 and K3:
// kTcStride; K6 its own).  With kWide, each thread's (at most kPer = 2)
// 16-byte chunks keep their offsets for the kernel's life; the 4-byte
// copies (kPer = 8 at 8-row tiles) are laid out on the fly.
template <bool kWide, int kRows, int kThreads, int kStride>
struct HaloCopies {
  static constexpr int kChunks = kWide ? 26 : kTcHaloWords;   // a halo row
  static constexpr int kChunkWords = kWide ? 4 : 1;
  static constexpr int kLead = kWide ? 1 : 0;    // staged word of column 0
  static constexpr int kCopies = (2 * kRows + 2) * kChunks;
  static constexpr int kPer = (kCopies + kThreads - 1) / kThreads;
  static constexpr int kKept = kWide ? kPer : 1;
  static_assert(kChunks * kChunkWords >= kLead + kTcHaloWords &&
                    kChunks * kChunkWords <= kStride && kStride % 4 == 0,
                "the chunks cover a halo row and fit in a staged one");
  int H, W;
  // copy q: its halo row (-1: none), its first word from the halo row's
  // word 0, its staged word, and its word offset in the image
  int row[kKept], word[kKept], dst[kKept], off[kKept];

  __device__ HaloCopies(int H_, int W_) : H(H_), W(W_) {
#pragma unroll
    for (int q = 0; q < kKept; ++q) lay_out(q, row[q], word[q], dst[q], off[q]);
  }

  __device__ __forceinline__ void lay_out(int q, int& r, int& wd, int& d,
                                          int& o) const {
    const int i = threadIdx.x + q * kThreads;
    const int ch = i % kChunks;
    r = i < kCopies ? i / kChunks : -1;
    wd = ch * kChunkWords - kLead;
    d = r * kStride + ch * kChunkWords;
    o = r * W * kCin + wd;
  }

  // Starts the copies of the halo of the tile at (b, py0, px0) of the (B,
  // H, W, 3) f32 image x into `halo`; zeros outside the image.
  __device__ __forceinline__ void start(float* halo,
                                        const float* __restrict__ x, int b,
                                        int py0, int px0) const {
    // word 0 of the halo's first row: (2 py0 - 1, 2 px0 - 1, channel 0)
    const int w0 = (2 * px0 - 1) * kCin, iy0 = 2 * py0 - 1;
    const long long xb = ((long long)b * H + iy0) * W * kCin + w0;
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      int r, wd, d, o;
      if (kWide) {
        r = row[q], wd = word[q], d = dst[q], o = off[q];
      } else {
        lay_out(q, r, wd, d, o);
      }
      if (r < 0) continue;
      const bool in = (unsigned)(iy0 + r) < (unsigned)H &&
                      (unsigned)(w0 + wd) < (unsigned)(W * kCin);
      const float* src = x + (in ? xb + o : 0);
      if (kWide)
        copy16(halo + d, src, in);
      else
        copy4(halo + d, src, in);
    }
  }
};

// This lane's B fragments, b[k-step][n-tile][register], for the k order
// above: bf16(w) of OIHW w, channel 8 n + lane / 4.  16 registers, loaded
// once for a kernel's life.
__device__ __forceinline__ void load_tc_weights(uint32_t (&b)[2][4][2],
                                                const float* __restrict__ w,
                                                int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // k = 16 ks + 8 r + 2t + e: halo row ky, word o
          const bool mixed = ks == 1 && r == 1;
          const bool real = !mixed || (e == 0 && t < 3);
          const int ky = mixed ? t : 2 * ks + r;
          const int o = mixed ? 8 : 2 * t + e;
          const int co = 8 * n + g;
          v[e] = real ? w[co * kTaps + (o % 3) * 9 + ky * 3 + o / 3] : 0.0f;
        }
        b[ks][n][r] = pack2(v[0], v[1]);
      }
}

// The A fragments, a[k-step][register], of window row DY: rows g read from
// `p0`, rows g + 8 from `p1`, each pointing at word 2t of halo row 0 of its
// conv pixel; `m0` and `m1` at word 8 of halo row min(t, 2); `keep` (0 for
// t == 3, else all ones) zeroes the one tap that lane does not hold, a
// real tap of row 2 read again, so that a non-finite image value there
// cannot meet the zero weight.
template <int DY>
__device__ __forceinline__ void gather_a(uint32_t (&a)[2][4], const float* p0,
                                         const float* p1, const float* m0,
                                         const float* m1, uint32_t keep) {
  constexpr int S = kTcStride;
#pragma unroll
  for (int ky = 0; ky < 3; ++ky) {
    // ky 0, 1: k-step 0, registers (0, 1) and (2, 3); ky 2: k-step 1, (0, 1)
    const int ks = ky / 2, r = ky % 2 * 2;
    a[ks][r] = pack2(p0[(DY + ky) * S], p0[(DY + ky) * S + 1]);
    a[ks][r + 1] = pack2(p1[(DY + ky) * S], p1[(DY + ky) * S + 1]);
  }
  a[1][2] = pack2(m0[DY * S], 0.0f) & keep;
  a[1][3] = pack2(m1[DY * S], 0.0f) & keep;
}

// acc[n][e]: the f32 conv outputs of n-tile n in the mma's C layout (e 0, 1:
// row g, channels 8 n + 2t, + 1; e 2, 3: row g + 8), each the sum of the
// two k-steps' products, each started from zero.
__device__ __forceinline__ void conv_mtile(float (&acc)[4][4],
                                           const uint32_t (&a)[2][4],
                                           const uint32_t (&b)[2][4][2]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    float d0[4], d1[4];
    mma_bf16(d0, a[0], b[0][n][0], b[0][n][1]);
    mma_bf16(d1, a[1], b[1][n][0], b[1][n][1]);
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = __fadd_rn(d0[e], d1[e]);
  }
}

// This lane's gather offsets, in words from the staged halo word where a
// group's pooled row and first column start (row 2 pr of the halo, word 48
// half: pooled row pr of the tile, columns 8 half .. 8 half + 7): `col0` for
// rows g of the m-tiles (window column dx0 = (g >= 4)), `col1` for rows g +
// 8 (the other column), each at the lane's taps o = 2t, 2t + 1; `mix` from
// those to word 8 of halo row min(t, 2); `keep` as gather_a takes it.
// `lead` is HaloCopies' kLead.
struct GatherLane {
  int col0, col1, mix;
  uint32_t keep;

  __device__ GatherLane(int lane, int lead) {
    const int g = lane / 4, t = lane % 4, dx0 = g >= 4;
    col0 = lead + 3 * (2 * g + dx0) + 2 * t;
    col1 = lead + 3 * (2 * g + 1 - dx0) + 2 * t;
    mix = (t < 2 ? t : 2) * kTcStride + 8 - 2 * t;
    keep = t == 3 ? 0u : ~0u;
  }
};

// The f32 conv outputs of window row DY of the group whose staged halo
// starts at `group` (see GatherLane), in conv_mtile's layout.
template <int DY>
__device__ __forceinline__ void conv_row(float (&acc)[4][4], const float* group,
                                         const GatherLane& l,
                                         const uint32_t (&b)[2][4][2]) {
  uint32_t a[2][4];
  gather_a<DY>(a, group + l.col0, group + l.col1, group + l.col0 + l.mix,
               group + l.col1 + l.mix, l.keep);
  conv_mtile(acc, a, b);
}

}  // namespace stem
