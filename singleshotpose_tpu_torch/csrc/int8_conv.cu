// int8 convolution as an implicit GEMM on Hopper's warpgroup tensor cores
// (sm_90a), with the int8 serve's epilogue in the kernel: NHWC int8
// activations x int8 weights -> int32 sums -> (optionally) the dequant, the
// compute-dtype rounding, leaky and the next conv's quantizer, written as
// int32, or as bf16 / f32 and/or int8 NHWC.
//
// Replaces no Pallas kernel: the JAX package's int8 serve
// (singleshotpose_tpu/models/quantize.py:apply_quantized) leaves its conv,
// models/layers.py:30 conv2d(xq, wq, preferred_dtype=int32), and the
// elementwise chain after it to XLA, which fuses the requantize into the
// conv's epilogue so that the intermediate materializes as int8
// (quantize.py:205-216).  PyTorch has no CUDA int8 convolution; the port's
// plain twin is F.unfold + torch._int_mm + the same elementwise ops
// (ops/int8_conv.py).
//
// The GEMM: M = B*Ho*Wo output pixels, N = C_out, K = KH*KW*C_in in HWIO's
// (kh, kw, c_in) order.  A (M x K) is gathered from the NHWC input as it is
// copied to shared memory (0 outside the image: the quantized zero, and
// JAX's pad); B is the weights packed once to [C_out][Kp], Kp = K rounded
// up to a multiple of 32 with zeros.  Both are K-major, as 8-bit wgmma
// takes them.  Integer sums are exact, so the product equals the twin's bit
// for bit in any order (|sum| <= 127^2 * K < 2^31 for K up to 133,000).
//
// What bounds it on an H100: the operations (2*M*N*K over 1,979 int8 TOPS)
// for the deep 3x3 layers; the bytes (int8 in, the output out, over 3.35
// TB/s) for conv_1 and the 1x1 layers.  Writing int8 (or bf16) instead of
// int32 cuts the output bytes, which set conv_1's bound, by 4x (2x).
//
// Design.  A persistent grid walks BM x BN output tiles (BM 64 or 128, BN
// 32, 64 or 128: a template, picked per shape by the wrapper's table,
// ops/int8_conv.py:tile_for, measured with scripts/int8_conv_variants.py).
// A block is BM/64 consumer warpgroups and one producer warpgroup, around a
// ring of 2-8 stages in dynamic shared memory (as many as the blocks an SM
// should hold leave beside the epilogue's staging), each stage BM rows of A
// and BN rows of B over 256 bytes of K (128 for BN 32): 128-byte K blocks in
// the 128-byte swizzled layout that wgmma's descriptors read.
//  - B, a plain 2-D tensor, arrives by TMA (one thread, a tensor map with
//    SWIZZLE_128B; columns past Kp and rows past C_out read as zeros).
//  - A, the implicit im2col, is gathered by the producer warpgroup's
//    cp.async (16-byte pieces where C_in and the input's address are
//    multiples of 16, 4-byte ones where they are multiples of 4), written
//    to the swizzled positions (chunk j of row r at chunk j ^ (r & 7)).
//    TMA's im2col mode was the other choice; the gather was picked because
//    it needs no tensor map per activation tensor (built on the host at
//    every call, for every layer and batch), handles the zero padding with
//    a source size of 0, and takes the 4-byte path of the first conv (C_in
//    3 padded to 4) in the same code.
//  - 16-byte path: a producer thread owns one 16-byte column of 8 (or 4)
//    rows: the rows' pixel decode once a tile, the column's tap decode (kh,
//    kw, c_in; two 32-bit divisions) once a K block, shared by the rows.
//    4-byte path: a thread owns a row, steps its tap along K without
//    divisions, and a warp's lanes copy neighbouring pixels' same tap.
//    Each thread's copies arrive on the stage's "full" mbarrier when they
//    land (cp.async.mbarrier.arrive.noinc); the barrier also counts the
//    TMA's bytes.
//  - Each consumer warpgroup holds 64 rows of the tile and runs
//    wgmma.mma_async m64nBNk32 s32.s8.s8 (8 a stage), after a proxy fence
//    for the gathered A, keeping one stage's group in flight and releasing
//    the previous stage to the producer on its "empty" mbarrier.
//  - The epilogue reads the accumulators in wgmma's layout (rows 16*warp +
//    lane/4 and +8, column pairs 2*(lane%4) of each 8-column block),
//    computes each output in registers, stages it in shared memory (up to
//    64 columns at a time, so that the staging leaves the ring its stages)
//    and writes it out in 16-byte pieces, a row's bytes contiguous (the
//    per-thread pairs of 2 bytes would not coalesce).  The per-channel
//    parameters are loaded while the product runs.  The producer meanwhile
//    fills the ring with the next tile's stages.
//
// The epilogue, per output (bit for bit the plain chain of
// models/quantize.py, which is XLA's): int32 -> f32 round to nearest; one
// FMA y*scale[n] + b[n] (XLA contracts it); the compute dtype's rounding
// (bf16 round to nearest even, or none for f32); leaky as v >= 0 ? v :
// round(v * slope), the slope rounded to the compute dtype (in bf16 the
// product of two bf16 values is exact in f32, so one rounding); then, for
// an int8 output, the next conv's quantizer v * q (the constants form) or
// v / q (a true division; never a reciprocal), q per channel or a scalar,
// rint (half to even), a clamp to +-127, int8.  Built without fast math.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

namespace {

constexpr int kMaxStages = 8;    // ring depth: what shared memory holds
constexpr int kSmemPerSm = 233472;      // H100: 228 KB of shared memory an
constexpr int kSmemPerBlock = 232448;   // SM, 227 KB a block at most
constexpr int kRowBytes = 128;   // K bytes of a stage: one swizzle row
constexpr int kNoRow = -(1 << 29);   // a tile row past M
// K blocks of 128 bytes a stage: two halve the ring's handshakes per
// product; the narrowest tiles (the first conv's, K <= 128 in the serves)
// keep one, and so more stages in flight
template <int kBN>
constexpr int kStageBlocks = kBN == 32 ? 1 : 2;

// epilogue flags (ops/int8_conv.py builds them)
constexpr int kOutI32 = 1;       // int32 sums, no epilogue
constexpr int kOutValue = 2;     // the compute-dtype value
constexpr int kValueBf16 = 4;    // the compute dtype is bf16 (else f32)
constexpr int kOutI8 = 8;        // the next conv's int8
constexpr int kLeaky = 16;
constexpr int kDivide = 32;      // the quantizer divides (else multiplies)
constexpr int kVecI32 = 64;      // an output may be stored in 16-byte pieces
constexpr int kVecValue = 128;
constexpr int kVecI8 = 256;

struct Shape {
  int B, H, W, C, Ho, Wo, N, KW, stride, pad, K, Kp, M;
  int tiles_n, tiles, srow, stages;
};

struct Epi {
  const float* scale;
  const float* bias;
  const float* q;
  int q_stride;            // 1: a quantizer per channel; 0: one scalar
  int flags;
  float slope;
  int32_t* y32;
  void* yv;
  int8_t* y8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, cp.async ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(smem_addr(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

// returns once the phase of parity `parity` has completed; a wait of many
// seconds means a lost arrival, and the kernel traps rather than hang
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  for (long long n = 0; !mbar_try_wait(bar, parity); ++n)
    if (n > (1LL << 28)) __trap();
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// cp.async of 16 or 4 bytes; a source size of 0 reads nothing and writes
// zeros
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(uint32_t dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

// arrives on `bar` once this thread's earlier cp.asyncs have landed; the
// arrival counts toward the barrier's expected count
__device__ __forceinline__ void copies_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// the generic proxy's shared-memory writes (cp.async, st.shared) become
// visible to the async proxy (wgmma, TMA)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// the 128 threads of consumer warpgroup `wg` (named barriers 1, 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// A K-major operand of rows x 128 bytes in the 128-byte swizzle, its base
// 1024-byte aligned: 8-row groups 1024 bytes apart (SBO), the leading
// offset unused.  Adding 2 (32 bytes >> 4) steps K by one k32 slice.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending)
               : "memory");
}

// keeps the compiler from moving accumulator accesses across the async mma
template <int kN>
__device__ __forceinline__ void fence_acc(int (&d)[kN]) {
#pragma unroll
  for (int i = 0; i < kN; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_n32(int (&d)[16], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n64(int (&d)[32], uint64_t a,
                                          uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t a,
                                           uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int kBN>
__device__ __forceinline__ void wgmma_k32(int (&d)[kBN / 2], uint64_t a,
                                          uint64_t b, int scale_d) {
  if constexpr (kBN == 32) {
    wgmma_n32(d, a, b, scale_d);
  } else if constexpr (kBN == 64) {
    wgmma_n64(d, a, b, scale_d);
  } else {
    wgmma_n128(d, a, b, scale_d);
  }
}

// ---- the epilogue ----------------------------------------------------------

// The epilogue runs on the pairs of an accumulator row and spends few of
// the SM's conversion instructions (16 a cycle, against 128 FMAs): one
// int -> f32 each, one bf16 rounding (F2FP) a pair, leaky on the bf16 pair
// (HMUL2 rounds the exact product of two bf16 values once, as the plain
// f32 product rounded to bf16 does; max(v, slope * v) is leaky for a slope
// in (0, 1)), and the quantizer's round and int8 as f32 adds.

// fma(f32(y), scale, b), the compute dtype, leaky, for two columns: the f32
// values, and in `bits` the bf16 pair's bits when the dtype is bf16
__device__ __forceinline__ float2 dequant2(int y0, int y1, float2 scale,
                                           float2 bias, int flags,
                                           float slope, uint32_t& bits) {
  const float f0 = __fmaf_rn(__int2float_rn(y0), scale.x, bias.x);
  const float f1 = __fmaf_rn(__int2float_rn(y1), scale.y, bias.y);
  if (flags & kValueBf16) {
    __nv_bfloat162 p = __floats2bfloat162_rn(f0, f1);
    if (flags & kLeaky)
      p = __hmax2(p, __hmul2_rn(p, __float2bfloat162_rn(slope)));
    bits = *reinterpret_cast<uint32_t*>(&p);
    return make_float2(__low2float(p), __high2float(p));
  }
  if (flags & kLeaky)
    return make_float2(fmaxf(f0, __fmul_rn(f0, slope)),
                       fmaxf(f1, __fmul_rn(f1, slope)));
  return make_float2(f0, f1);
}

// clip(round(v * q or v / q), +-127) as the bits of a float whose low byte
// is the int8: clamping first gives the same integer, and adding 1.5 * 2^23
// rounds a value of magnitude <= 127 to the nearest integer, ties to even,
// into the sum's low mantissa bits
__device__ __forceinline__ uint32_t requant(float v, float q, int flags) {
  float u = (flags & kDivide) ? __fdiv_rn(v, q) : __fmul_rn(v, q);
  u = fminf(fmaxf(u, -127.0f), 127.0f);
  return __float_as_uint(__fadd_rn(u, 12582912.0f));
}

// rows [m_wg, m_wg + 64) x columns [n0, n0 + BN) of one output, staged at
// byte `off` of each staged row, written to `out` (row stride N elements)
template <int kBN, int esz>
__device__ __forceinline__ void copy_out(const uint8_t* stg, int srow, int off,
                                         bool vec, uint8_t* out,
                                         const Shape& s, int m_wg, int n0,
                                         int t) {
  const int valid = min(kBN, s.N - n0) * esz;
  if (vec) {
    constexpr int cpr = kBN * esz / 16;
    for (int idx = t; idx < 64 * cpr; idx += 128) {
      const int r = idx / cpr;
      const int c = (idx - r * cpr) * 16;
      const int m = m_wg + r;
      if (m < s.M && c < valid)
        *reinterpret_cast<uint4*>(
            out + (static_cast<long long>(m) * s.N + n0) * esz + c) =
            *reinterpret_cast<const uint4*>(stg + r * srow + off + c);
    }
    return;
  }
  for (int idx = t; idx < 64 * kBN; idx += 128) {
    const int r = idx / kBN;
    const int c = idx - r * kBN;
    const int m = m_wg + r;
    if (m >= s.M || c * esz >= valid) continue;
    uint8_t* dst = out + (static_cast<long long>(m) * s.N + n0 + c) * esz;
    const uint8_t* src = stg + r * srow + off + c * esz;
    for (int b = 0; b < esz; ++b) dst[b] = src[b];
  }
}

// The fused epilogue of one consumer warpgroup's 64 rows: the outputs of
// kPart columns at a time computed from the accumulators into the staging
// rows (the value, then the int8), then written out row-wise.  `par` holds
// the tile's scale, bias and quantizer per column.
template <int kBN, int kPart>
__device__ __forceinline__ void stage_out(const int (&acc)[kBN / 2],
                                          uint8_t* my_stg, const float* par,
                                          const Shape& s, const Epi& e,
                                          int wg, int r_a, int c_a, int m_wg,
                                          int n0, int t) {
  const int flags = e.flags;
  const int esz_v = (flags & kValueBf16) ? 2 : 4;
  const int off_i8 = (flags & kOutValue) ? kPart * esz_v : 0;
#pragma unroll
  for (int part = 0; part < kBN / kPart; ++part) {
    wg_sync(wg);                        // the parameters; the last reads
#pragma unroll
    for (int i = 0; i < kPart / 8; ++i) {
      const int col = (part * (kPart / 8) + i) * 8 + c_a;   // in the tile
      const int at = i * 8 + c_a;                            // in the part
      const int a = 4 * (part * (kPart / 8) + i);
      const float2 sc = *reinterpret_cast<const float2*>(par + col);
      const float2 bi = *reinterpret_cast<const float2*>(par + kBN + col);
      const float2 qq =
          *reinterpret_cast<const float2*>(par + 2 * kBN + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t bits = 0;
        const float2 v = dequant2(acc[a + 2 * h], acc[a + 2 * h + 1], sc,
                                  bi, flags, e.slope, bits);
        uint8_t* row = my_stg + (r_a + 8 * h) * s.srow;
        if (flags & kOutValue) {
          if (flags & kValueBf16) {
            *reinterpret_cast<uint32_t*>(row + at * 2) = bits;
          } else {
            *reinterpret_cast<float2*>(row + at * 4) = v;
          }
        }
        if (flags & kOutI8)
          *reinterpret_cast<uint16_t*>(row + off_i8 + at) =
              static_cast<uint16_t>(__byte_perm(requant(v.x, qq.x, flags),
                                                requant(v.y, qq.y, flags),
                                                0x0040));
      }
    }
    wg_sync(wg);                        // the part is staged
    const int np = n0 + part * kPart;
    if ((flags & kOutValue) && esz_v == 2)
      copy_out<kPart, 2>(my_stg, s.srow, 0, flags & kVecValue,
                         reinterpret_cast<uint8_t*>(e.yv), s, m_wg, np, t);
    if ((flags & kOutValue) && esz_v == 4)
      copy_out<kPart, 4>(my_stg, s.srow, 0, flags & kVecValue,
                         reinterpret_cast<uint8_t*>(e.yv), s, m_wg, np, t);
    if (flags & kOutI8)
      copy_out<kPart, 1>(my_stg, s.srow, off_i8, flags & kVecI8,
                         reinterpret_cast<uint8_t*>(e.y8), s, m_wg, np, t);
  }
}

// ---- the kernel ------------------------------------------------------------

template <int kBM, int kBN, int kVec>
__global__ void __launch_bounds__((kBM / 64 + 1) * 128,
                                  kBM == 64 || kBN == 32 ? 2 : 1)
    int8_conv_kernel(const __grid_constant__ CUtensorMap wmap,
                     const int8_t* __restrict__ x, const Shape s,
                     const Epi e) {
  constexpr int kWG = kBM / 64;           // consumer warpgroups
  constexpr int kRows = kBM / 16;         // A rows of a producer thread
  constexpr int kKB = kStageBlocks<kBN>;  // 128-byte K blocks a stage
  constexpr int kABlock = kBM * kRowBytes;
  constexpr int kBBlock = kBN * kRowBytes;
  constexpr int kAStage = kKB * kABlock;
  constexpr int kBStage = kKB * kBBlock;

  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int stages = s.stages;
  uint8_t* a_ring = smem;
  uint8_t* b_ring = a_ring + stages * kAStage;
  uint8_t* stg = b_ring + stages * kBStage;
  float* params = reinterpret_cast<float*>(stg + kBM * s.srow);
  // a stage's barriers: "full" counts the producers' cp.async arrivals and
  // the TMA's bytes, "empty" one arrival of each consumer warpgroup
  uint64_t* full = reinterpret_cast<uint64_t*>(params + kWG * 3 * kBN);
  uint64_t* empty = full + stages;

  const int wg = threadIdx.x >> 7;
  const int t = threadIdx.x & 127;
  if (threadIdx.x == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(&full[i], 128 + 1);       // the producers' arrives + TMA's
      mbar_init(&empty[i], kWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int n_ks = (s.Kp + kKB * kRowBytes - 1) / (kKB * kRowBytes);

  if (wg == kWG) {
    // ---- producer warpgroup: B by TMA, A gathered by cp.async ----
    // 16-byte path: thread t copies column j (16 bytes) of rows r0 + 16 i,
    // a warp 4 rows' 128 contiguous bytes at a time.  4-byte path (C_in a
    // multiple of 4): thread t copies 4-byte pieces ph, ph + kLpr, ... of
    // row r0, so a warp's lanes copy neighbouring pixels' same tap (for the
    // first conv, C_in 4: 128 contiguous bytes), stepping its tap along K
    // without divisions.
    constexpr int kLpr = 128 / kBM;       // 4-byte path: threads a row
    constexpr int kPr = kVec == 16 ? kRows : 1;   // rows a thread
    const int j = t & 7;
    const int r0 = kVec == 16 ? t >> 3 : t % kBM;
    const int ph = t / kBM;
    const int swz = (j ^ (r0 & 7)) << 4;  // (r0 + 16 i) & 7 == r0 & 7
    const int hw = s.Ho * s.Wo;
    int st = 0, phase = 0;                // the ring's slot and its round
    for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
      const int m0 = (tile / s.tiles_n) * kBM;
      const int n0 = (tile % s.tiles_n) * kBN;
      long long base[kPr];
      int iy0[kPr], ix0[kPr];
#pragma unroll
      for (int i = 0; i < kPr; ++i) {
        const int m = m0 + r0 + 16 * i;
        if (m < s.M) {
          const int b = m / hw;
          const int rem = m - b * hw;
          const int oy = rem / s.Wo;
          iy0[i] = oy * s.stride - s.pad;
          ix0[i] = (rem - oy * s.Wo) * s.stride - s.pad;
          base[i] = ((static_cast<long long>(b) * s.H + iy0[i]) * s.W +
                     ix0[i]) * s.C;
        } else {
          iy0[i] = kNoRow;                // no copies: its sums go unwritten
          ix0[i] = 0;
          base[i] = 0;
        }
      }
      // the 4-byte path's tap (kh, kw) and channel ci at byte 4 * ph of K
      int ci = 4 * ph % s.C;
      int kw = 4 * ph / s.C % s.KW;
      int kh = 4 * ph / s.C / s.KW;
      for (int ks = 0; ks < n_ks; ++ks) {
        mbar_wait(&empty[st], phase ^ 1);
        const int k0 = ks * kKB * kRowBytes;
        if (t == 0) {
          // the stage's K blocks that hold weights (past Kp only zeros)
          const int blocks = min(kKB, (s.Kp - k0 + kRowBytes - 1) / kRowBytes);
          mbar_expect_tx(&full[st], blocks * kBBlock);
          for (int cb = 0; cb < blocks; ++cb)
            tma_load_2d(b_ring + st * kBStage + cb * kBBlock, &wmap,
                        k0 + cb * kRowBytes, n0, &full[st]);
        }
        // A's columns past K are not copied: whatever the stage holds there
        // meets the weights' zero padding
        const uint32_t a_st = smem_addr(a_ring + st * kAStage);
        if constexpr (kVec == 16) {
#pragma unroll
          for (int cb = 0; cb < kKB; ++cb) {
            const int k = k0 + cb * kRowBytes + 16 * j;
            if (k >= s.K) break;
            const int tap = k / s.C;
            const int th = tap / s.KW;
            const int tw = tap - th * s.KW;
            const int toff = (th * s.W + tw) * s.C + (k - tap * s.C);
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              const int iy = iy0[i] + th, ix = ix0[i] + tw;
              const bool in = static_cast<unsigned>(iy) <
                                  static_cast<unsigned>(s.H) &&
                              static_cast<unsigned>(ix) <
                                  static_cast<unsigned>(s.W);
              copy16(a_st + cb * kABlock + (r0 + 16 * i) * kRowBytes + swz,
                     in ? x + base[i] + toff : x, in);
            }
          }
        } else if (iy0[0] != kNoRow) {
          const uint32_t row = a_st + r0 * kRowBytes;
          for (int p = 0; p < kKB * kRowBytes / 4 / kLpr; ++p) {
            const int kb = 4 * (ph + kLpr * p);      // byte of the stage's K
            if (k0 + kb >= s.K) break;
            const int kc = kb & (kRowBytes - 1);     // byte of its block
            const int iy = iy0[0] + kh, ix = ix0[0] + kw;
            const bool in =
                static_cast<unsigned>(iy) < static_cast<unsigned>(s.H) &&
                static_cast<unsigned>(ix) < static_cast<unsigned>(s.W);
            copy4(row + (kb / kRowBytes) * kABlock +
                      ((((kc >> 4) ^ (r0 & 7)) << 4) | (kc & 15)),
                  in ? x + base[0] + (kh * s.W + kw) * s.C + ci : x, in);
            ci += 4 * kLpr;
            while (ci >= s.C) {
              ci -= s.C;
              if (++kw == s.KW) {
                kw = 0;
                ++kh;
              }
            }
          }
        }
        copies_arrive(&full[st]);
        if (++st == stages) {
          st = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups: wgmma over the ring, then the epilogue ----
  const int warp = t >> 5;
  const int lane = t & 31;
  const int flags = e.flags;
  int acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0;
  uint8_t* my_stg = stg + wg * 64 * s.srow;
  float* par = params + wg * 3 * kBN;     // the tile's scale, bias, q
  const uint32_t a_base = smem_addr(a_ring) + wg * 64 * kRowBytes;
  const uint32_t b_base = smem_addr(b_ring);
  const int r_a = warp * 16 + (lane >> 2);
  const int c_a = (lane & 3) * 2;
  int st = 0, phase = 0, prev = 0;        // the ring's slot, round, last
  int par_n0 = -1;                        // the columns `par` holds
  for (int tile = blockIdx.x; tile < s.tiles; tile += gridDim.x) {
    const int m0 = (tile / s.tiles_n) * kBM;
    const int n0 = (tile % s.tiles_n) * kBN;
    // this tile's per-channel parameters, loaded while the product runs
    // (a tile of the columns of the previous one keeps them)
    const bool fresh = !(flags & kOutI32) && n0 != par_n0;
    float p_sc = 0.0f, p_bi = 0.0f, p_q = 1.0f;
    if (fresh && t < kBN && n0 + t < s.N) {
      p_sc = __ldg(e.scale + n0 + t);
      p_bi = __ldg(e.bias + n0 + t);
      if (flags & kOutI8) p_q = __ldg(e.q + (n0 + t) * e.q_stride);
    }
    for (int ks = 0; ks < n_ks; ++ks) {
      mbar_wait(&full[st], phase);
      fence_async_shared();               // the gathered A, for wgmma
      const int nk = min(4 * kKB, (s.Kp - ks * kKB * kRowBytes) / 32);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4 * kKB; ++kk) {
        // k32 step kk: block kk / 4 of the stage, 32 bytes in per step
        const uint64_t da = sw128_desc(a_base + st * kAStage +
                                       (kk >> 2) * kABlock);
        const uint64_t db = sw128_desc(b_base + st * kBStage +
                                       (kk >> 2) * kBBlock);
        if (kk < nk)
          wgmma_k32<kBN>(acc, da + 2 * (kk & 3), db + 2 * (kk & 3), ks | kk);
      }
      wgmma_commit();
      fence_acc(acc);
      if (ks > 0) {
        wgmma_wait<1>();
        fence_acc(acc);
        if (t == 0) mbar_arrive(&empty[prev]);
      }
      prev = st;
      if (++st == stages) {
        st = 0;
        phase ^= 1;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (t == 0) mbar_arrive(&empty[prev]);
    const int m_wg = m0 + wg * 64;
    if (flags & kOutI32) {
      // the int32 sums, staged 32 columns at a time, so that the staging
      // leaves the ring its stages
#pragma unroll
      for (int part = 0; part < kBN / 32; ++part) {
        wg_sync(wg);                      // the previous copy-out's reads
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int a = 4 * (4 * part + i);
          const int col = i * 8 + c_a;
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<int2*>(my_stg + (r_a + 8 * h) * s.srow +
                                     col * 4) =
                make_int2(acc[a + 2 * h], acc[a + 2 * h + 1]);
        }
        wg_sync(wg);
        copy_out<32, 4>(my_stg, s.srow, 0, flags & kVecI32,
                        reinterpret_cast<uint8_t*>(e.y32), s, m_wg,
                        n0 + 32 * part, t);
      }
      continue;
    }

    // the epilogue: the tile's per-channel parameters into shared memory
    // (the previous tile's reads of them ended before its last barrier)
    if (fresh) {
      if (t < kBN) {
        par[t] = p_sc;
        par[kBN + t] = p_bi;
        par[2 * kBN + t] = p_q;
      }
      par_n0 = n0;
    }
    // the outputs: with a value, staged 64 columns at a time, so that the
    // staging leaves the ring its stages; the int8 alone, the whole tile
    if (flags & kOutValue) {
      stage_out<kBN, kBN < 64 ? kBN : 64>(acc, my_stg, par, s, e, wg, r_a,
                                          c_a, m_wg, n0, t);
    } else {
      stage_out<kBN, kBN>(acc, my_stg, par, s, e, wg, r_a, c_a, m_wg, n0, t);
    }
  }
}

// ---- the host side ---------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library links no libcuda of its own
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = (EncodeTiled)p;
  }
  return fn;
}

template <int kBM, int kBN, int kVec>
int launch(const CUtensorMap& map, const int8_t* x, Shape s, const Epi& e,
           cudaStream_t stream) {
  auto kernel = int8_conv_kernel<kBM, kBN, kVec>;
  constexpr int threads = (kBM / 64 + 1) * 128;
  // as many stages as the shared memory of the blocks an SM should hold
  // (two of the narrow tiles, one of 128 x 128) leaves beside the staging
  constexpr int kPerSm = kBM == 64 || kBN == 32 ? 2 : 1;
  constexpr int kBudget = kSmemPerSm / kPerSm - 1024;   // 1 KB the system's
  const int fixed = 1024 + kBM / 64 * 3 * kBN * 4 + 2 * kMaxStages * 8 +
                    kBM * s.srow;
  const int stage = kStageBlocks<kBN> * (kBM + kBN) * kRowBytes;
  int stages = min(kMaxStages, (kBudget - fixed) / stage);
  if (stages < 2)   // a wide staged row: one block an SM, with 2 stages
    stages = min(kMaxStages, (kSmemPerBlock - fixed) / stage);
  if (stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  s.stages = stages;
  const int smem = fixed + stages * stage;
  static const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemPerBlock);
  if (set != cudaSuccess) return static_cast<int>(set);
  // blocks resident on the card, for this shared-memory size
  static std::mutex lock;
  static std::map<std::tuple<int, int>, int> resident;
  int device = 0;
  cudaGetDevice(&device);
  int blocks;
  {
    std::lock_guard<std::mutex> guard(lock);
    auto key = std::make_tuple(device, smem);
    auto hit = resident.find(key);
    if (hit == resident.end()) {
      int per_sm = 0, sms = 0;
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      hit = resident.emplace(key, per_sm * sms).first;
    }
    blocks = hit->second;
  }
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int grid = s.tiles < blocks ? s.tiles : blocks;
  kernel<<<grid, threads, smem, stream>>>(map, x, s, e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (B, H, W, C) int8 NHWC, C a multiple of `vec` (16 or 4), its address
// too; wk: (N, Kp) int8, row n the HWIO weights of output channel n
// flattened over (kh, kw, c) and zero-padded, 16-byte aligned.  flags: the
// k* bits above.  kOutI32: y32 (B, Ho, Wo, N) int32, no epilogue.  Else
// scale, bias: f32 (N,); q: f32 (N,) (q_stride 1) or (1,) (q_stride 0),
// read when kOutI8; yv: (B, Ho, Wo, N) bf16 or f32 when kOutValue; y8:
// (B, Ho, Wo, N) int8 when kOutI8.  bm in {64, 128}, bn in {32, 64, 128}:
// the tile.  Returns cudaGetLastError() after the launch, or the error
// that kept it from launching.
extern "C" int int8_conv_launch(const void* x, const void* wk, void* y32,
                                void* yv, void* y8, const void* scale,
                                const void* bias, const void* q, int q_stride,
                                int flags, float slope, int B, int H, int W,
                                int C, int Ho, int Wo, int N, int KH, int KW,
                                int stride, int pad, int Kp, int vec, int bm,
                                int bn, void* stream) {
  const long long M = static_cast<long long>(B) * Ho * Wo;
  if (M == 0 || N == 0) return 0;
  if (M >= (1LL << 31) || (vec != 16 && vec != 4) ||
      (bm != 64 && bm != 128) || (bn != 32 && bn != 64 && bn != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{B, H, W, C, Ho, Wo, N, KW, stride, pad, KH * KW * C, Kp,
          static_cast<int>(M), 0, 0, 0, 0};
  s.tiles_n = (N + bn - 1) / bn;
  const long long tiles = ((M + bm - 1) / bm) * s.tiles_n;
  if (tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  s.tiles = static_cast<int>(tiles);
  // the epilogue's staged row (stage_out): 32 int32 sums, the value and
  // the int8 of up to 64 columns, or the int8 of all; rows 16 bytes apart,
  // fewer bank conflicts
  const int part = (flags & kOutValue) && bn > 64 ? 64 : bn;
  s.srow = 16 + ((flags & kOutI32)
                     ? 32 * 4
                     : ((flags & kOutValue)
                            ? part * ((flags & kValueBf16) ? 2 : 4)
                            : 0) +
                           ((flags & kOutI8) ? part : 0));
  Epi e{static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<const float*>(q), q_stride, flags, slope,
        static_cast<int32_t*>(y32), yv, static_cast<int8_t*>(y8)};

  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kp),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kp)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(kRowBytes),
                             static_cast<cuuint32_t>(bn)};
  const cuuint32_t unit[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(wk),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);

  const int8_t* xp = static_cast<const int8_t*>(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_CONV_CASE(BM, BN)                                    \
  if (bm == BM && bn == BN)                                       \
    return vec == 16 ? launch<BM, BN, 16>(map, xp, s, e, st)      \
                     : launch<BM, BN, 4>(map, xp, s, e, st);
  INT8_CONV_CASE(64, 32)
  INT8_CONV_CASE(64, 64)
  INT8_CONV_CASE(64, 128)
  INT8_CONV_CASE(128, 32)
  INT8_CONV_CASE(128, 64)
  INT8_CONV_CASE(128, 128)
#undef INT8_CONV_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
