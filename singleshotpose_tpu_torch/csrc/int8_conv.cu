// int8 convolution as an implicit GEMM on the tensor cores (sm_90a):
// NHWC int8 activations x int8 weights -> int32 NHWC, zero padding.
//
// Replaces no Pallas kernel: the JAX package's int8 serve
// (singleshotpose_tpu/models/quantize.py:apply_quantized) leaves its conv,
// models/layers.py:30 conv2d(xq, wq, preferred_dtype=int32), to XLA, and
// PyTorch has no CUDA int8 convolution.  The port's plain twin is
// F.unfold + torch._int_mm (ops/int8_conv.py).
//
// The GEMM: M = B*Ho*Wo output pixels, N = C_out, K = KH*KW*C_in in HWIO's
// (kh, kw, c_in) order.  A is gathered from the NHWC input as it is copied
// to shared memory (0 outside the image: the quantized zero, and JAX's
// pad); B is the weights re-packed once to [C_out][Kp], Kp = K rounded up to
// a multiple of 32 with zeros.  A block computes a 128 x 64 tile of the
// output over 64-byte slices of K, staged through a 3-deep cp.async ring;
// each of its 4 warps runs mma.sync m16n8k32 (s8 x s8 -> s32) on a 64 x 32
// part, its fragments read with ldmatrix.  Integer sums are exact, so the
// result equals the twin's bit for bit in any order (|sum| <= 127^2 * K <
// 2^31 for K up to 133,000).
//
// What bounds it on an H100: the operations (2*M*N*K over 1,979 int8
// TOPS) for the deep 3x3 layers, the bytes (int8 in, int32 out over 3.35
// TB/s) for conv_1 and the 1x1 ones.  This first version is mma.sync, not
// wgmma, and writes its int32 tile straight from the fragments; the
// dequant, bias and leaky stay outside it (plain PyTorch ops).
//
// Copy paths, picked by the wrapper: 16-byte cp.async where C_in and the
// input's address are multiples of 16; 4-byte where they are multiples of
// 4; else byte by byte (C_in = 3: K = 27 padded to 32).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels a block
constexpr int kBN = 64;           // output channels a block
constexpr int kBK = 64;           // bytes of K a stage
constexpr int kStages = 3;
constexpr int kThreads = 128;     // 4 warps, 2 x 2 over the tile
constexpr int kLds = kBK + 16;    // 80-byte rows: ldmatrix reads 8 rows
                                  // on 32 distinct banks

struct Shape {
  int B, H, W, C, Ho, Wo, N, KW, stride, pad, K, Kp;
  long long M;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// cp.async of 16 or 4 bytes; a source size of 0 reads nothing and writes
// zeros
__device__ __forceinline__ void copy16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void copies_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void copies_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The input element offset of K index k for an output pixel whose window
// starts at (iy0, ix0) in image b, or -1 outside the image or past K.
__device__ __forceinline__ long long tap_offset(const Shape& s, int b, int iy0,
                                                int ix0, int k) {
  if (k >= s.K) return -1;
  const int tap = k / s.C;
  const int ci = k - tap * s.C;
  const int kh = tap / s.KW;
  const int iy = iy0 + kh;
  const int ix = ix0 + tap - kh * s.KW;
  if (iy < 0 || iy >= s.H || ix < 0 || ix >= s.W) return -1;
  return ((static_cast<long long>(b) * s.H + iy) * s.W + ix) * s.C + ci;
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x,
                     const int8_t* __restrict__ wk, int32_t* __restrict__ y,
                     Shape s) {
  __shared__ __align__(128) int8_t a_tile[kStages][kBM * kLds];
  __shared__ __align__(128) int8_t b_tile[kStages][kBN * kLds];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;

  // each thread copies the 16-byte column `col` of 4 A rows and 2 B rows a
  // stage; its A rows' pixels are fixed over the K loop
  const int col = (tid & 3) * 16;
  const int row0 = tid >> 2;
  int pix_b[4], pix_y[4], pix_x[4];
  bool pix_in[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + row0 + 32 * i;
    pix_in[i] = m < s.M;
    const long long mm = pix_in[i] ? m : 0;
    const int hw = s.Ho * s.Wo;
    const int b = static_cast<int>(mm / hw);
    const int rem = static_cast<int>(mm - static_cast<long long>(b) * hw);
    const int oy = rem / s.Wo;
    pix_b[i] = b;
    pix_y[i] = oy * s.stride - s.pad;
    pix_x[i] = (rem - oy * s.Wo) * s.stride - s.pad;
  }

  auto load_stage = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int8_t* dst = &a_tile[stage][(row0 + 32 * i) * kLds + col];
      if (kVec == 16) {
        const long long off = pix_in[i]
            ? tap_offset(s, pix_b[i], pix_y[i], pix_x[i], k0 + col) : -1;
        copy16(dst, off >= 0 ? x + off : x, off >= 0);
      } else if (kVec == 4) {
#pragma unroll
        for (int q = 0; q < 16; q += 4) {
          const long long off = pix_in[i]
              ? tap_offset(s, pix_b[i], pix_y[i], pix_x[i], k0 + col + q)
              : -1;
          copy4(dst + q, off >= 0 ? x + off : x, off >= 0);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const long long off = pix_in[i]
              ? tap_offset(s, pix_b[i], pix_y[i], pix_x[i], k0 + col + q)
              : -1;
          dst[q] = off >= 0 ? x[off] : static_cast<int8_t>(0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = row0 + 32 * j;
      const int n = n0 + row;
      const int k = k0 + col;
      const bool in = n < s.N && k < s.Kp;
      copy16(&b_tile[stage][row * kLds + col],
             in ? wk + static_cast<long long>(n) * s.Kp + k : wk, in);
    }
  };

  const int warp_m = (warp >> 1) * 64;
  const int warp_n = (warp & 1) * 32;
  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  const int k_tiles = (s.Kp + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < k_tiles) load_stage(st, st * kBK);
    copies_commit();
  }

  for (int kt = 0; kt < k_tiles; ++kt) {
    copies_wait<kStages - 2>();
    __syncthreads();      // stage kt landed; stage kt-1 is free to refill
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next * kBK);
    copies_commit();

    const int8_t* at = a_tile[kt % kStages];
    const int8_t* bt = b_tile[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 32) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
        ldmatrix_x4(a[mi], at + (warp_m + mi * 16 + (lane & 15)) * kLds +
                               kk + (lane >> 4) * 16);
      uint32_t b[2][4];
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)
        ldmatrix_x4(b[nj], bt + (warp_n + nj * 16 + (lane & 7) +
                                 ((lane >> 4) << 3)) * kLds +
                               kk + ((lane >> 3) & 1) * 16);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_s8(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2],
                 b[ni >> 1][(ni & 1) * 2 + 1]);
    }
  }
  copies_wait<0>();

  // the accumulators: rows lane/4 and lane/4 + 8 of each 16-row tile,
  // columns 2*(lane%4) and the next of each 8-column tile
  const bool pairs = (s.N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const long long m = m0 + warp_m + mi * 16 + (lane >> 2) + half * 8;
      if (m >= s.M) continue;
      int32_t* out = y + m * s.N;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = n0 + warp_n + ni * 8 + (lane & 3) * 2;
        const int v0 = acc[mi][ni][half * 2];
        const int v1 = acc[mi][ni][half * 2 + 1];
        if (pairs && n + 1 < s.N) {
          *reinterpret_cast<int2*>(out + n) = make_int2(v0, v1);
        } else {
          if (n < s.N) out[n] = v0;
          if (n + 1 < s.N) out[n + 1] = v1;
        }
      }
    }
  }
}

}  // namespace

// x: (B, H, W, C) int8 NHWC; wk: (N, Kp) int8, row n the HWIO weights of
// output channel n flattened over (kh, kw, c) and zero-padded; y: (B, Ho,
// Wo, N) int32.  vec: 16, 4 or 1, the copy width the wrapper checked x's
// alignment and C for.  Returns cudaGetLastError() after the launch.
extern "C" int int8_conv_launch(const void* x, const void* wk, void* y, int B,
                                int H, int W, int C, int Ho, int Wo, int N,
                                int KH, int KW, int stride, int pad, int Kp,
                                int vec, void* stream) {
  Shape s{B, H, W, C, Ho, Wo, N, KW, stride, pad, KH * KW * C, Kp,
          static_cast<long long>(B) * Ho * Wo};
  if (s.M == 0 || N == 0) return 0;
  const dim3 grid(static_cast<unsigned>((s.M + kBM - 1) / kBM),
                  (N + kBN - 1) / kBN);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* xp = static_cast<const int8_t*>(x);
  const int8_t* wp = static_cast<const int8_t*>(wk);
  int32_t* yp = static_cast<int32_t*>(y);
  switch (vec) {
    case 16:
      int8_conv_kernel<16><<<grid, kThreads, 0, st>>>(xp, wp, yp, s);
      break;
    case 4:
      int8_conv_kernel<4><<<grid, kThreads, 0, st>>>(xp, wp, yp, s);
      break;
    case 1:
      int8_conv_kernel<1><<<grid, kThreads, 0, st>>>(xp, wp, yp, s);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
