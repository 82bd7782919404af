"""int8 convolution with int32 sums: the conv of the int8 serving path.

Computes what ``singleshotpose_tpu/models/layers.py:30``
``conv2d(xq, wq, stride, pad, preferred_dtype=int32)`` computes in the JAX
package's int8 serve (``models/quantize.py:apply_quantized``): NHWC int8
activations × HWIO int8 weights → int32 NHWC, zero padding.  JAX leaves this
conv to XLA; PyTorch has no CUDA int8 convolution, so on a card it is a
hand-written implicit GEMM on the int8 tensor cores (``csrc/int8_conv.cu``,
built with ``nvcc`` for sm_90a at first use and bound with ``ctypes``).

The weights are re-packed once (:func:`pack_weights`) to ``(C_out, Kp)``:
row ``n`` is output channel ``n``'s HWIO weights flattened over (kh, kw,
c_in), zero-padded to ``Kp``, a multiple of 32.

:func:`int8_conv` on a CUDA tensor launches the kernel (counted in
``int8_conv.launches``) or raises; on a CPU tensor it runs the plain twin
:func:`int8_conv_reference` (``F.unfold`` of the int8 values carried in a
float type, then ``torch._int_mm``).  Integer sums are exact, so the two
agree bit for bit.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import cuda_build

__all__ = ["pack_weights", "int8_conv", "int8_conv_reference",
           "im2col_operands", "copy_width"]

_SOURCE = "int8_conv"      # csrc/int8_conv.cu
_K_ALIGN = 32              # the kernel's K step (mma.sync m16n8k32)


def _packed_depth(ksize: int, c_in: int) -> int:
    """``Kp``: K = ksize²·c_in rounded up to a multiple of 32."""
    k = ksize * ksize * c_in
    return -(-k // _K_ALIGN) * _K_ALIGN


def pack_weights(wq: torch.Tensor) -> torch.Tensor:
    """HWIO int8 ``(KH, KW, C_in, C_out)`` → ``(C_out, Kp)`` int8,
    contiguous, on ``wq``'s device."""
    if wq.dim() != 4 or wq.dtype != torch.int8 or wq.shape[0] != wq.shape[1]:
        raise ValueError(f"wq must be square HWIO int8, got {tuple(wq.shape)} "
                         f"{wq.dtype}")
    kh, _, c_in, c_out = wq.shape
    k = kh * kh * c_in
    packed = torch.zeros((c_out, _packed_depth(kh, c_in)), dtype=torch.int8,
                         device=wq.device)
    packed[:, :k] = wq.permute(3, 0, 1, 2).reshape(c_out, k)
    return packed


def _output_size(size: int, ksize: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - ksize) // stride + 1


def _check(x: torch.Tensor, wk: torch.Tensor, ksize: int, stride: int,
           pad: int):
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"x must be (B, H, W, C) int8, got {tuple(x.shape)} "
                         f"{x.dtype}")
    if wk.dim() != 2 or wk.dtype != torch.int8:
        raise ValueError(f"wk must be packed (C_out, Kp) int8, got "
                         f"{tuple(wk.shape)} {wk.dtype}")
    if wk.shape[1] != _packed_depth(ksize, x.shape[-1]):
        raise ValueError(f"wk has depth {wk.shape[1]}, a {ksize}x{ksize} conv "
                         f"over {x.shape[-1]} channels packs to "
                         f"{_packed_depth(ksize, x.shape[-1])}")
    if wk.device != x.device:
        raise ValueError(f"wk is on {wk.device}, x on {x.device}")
    if ksize < 1 or stride < 1 or pad < 0:
        raise ValueError(f"bad conv ksize={ksize} stride={stride} pad={pad}")
    B, H, W, _ = x.shape
    ho, wo = (_output_size(n, ksize, stride, pad) for n in (H, W))
    if ho < 1 or wo < 1:
        raise ValueError(f"a {ksize}x{ksize} conv with pad {pad} does not fit "
                         f"{H}x{W}")
    return B, H, W, ho, wo


def im2col_operands(x: torch.Tensor, wk: torch.Tensor, ksize: int,
                    stride: int = 1, pad: int = 0):
    """The twin's two int8 matrices: A, ``F.unfold`` of the int8 values
    carried exactly in f16 (on a card) or f32 (on the CPU), (M, K) row by
    output pixel; B, the packed weights as (K, C_out), K in unfold's (c,
    kh, kw) order — M, K and C_out zero-padded to what cuBLASLt's int8
    product takes on a card (multiples of 8; M > 16).  Returns (A, B)."""
    B, H, W, ho, wo = _check(x, wk, ksize, stride, pad)
    c_in, c_out = x.shape[-1], wk.shape[0]
    k = ksize * ksize * c_in
    carry = torch.float16 if x.device.type == "cuda" else torch.float32
    cols = F.unfold(x.permute(0, 3, 1, 2).to(carry), ksize, padding=pad,
                    stride=stride)                       # (B, C·kh·kw, L)
    a = cols.transpose(1, 2).reshape(B * ho * wo, k).to(torch.int8)
    # the packed rows are (kh, kw, c); unfold's columns are (c, kh, kw)
    w = wk[:, :k].reshape(c_out, ksize, ksize, c_in).permute(0, 3, 1, 2) \
        .reshape(c_out, k)
    kp, np_ = -(-k // 8) * 8, -(-c_out // 8) * 8
    m = a.shape[0]
    a = F.pad(a, (0, kp - k, 0, max(-(-m // 8) * 8, 32) - m))
    return a, F.pad(w, (0, kp - k, 0, np_ - c_out)).t()


def int8_conv_reference(x: torch.Tensor, wk: torch.Tensor, ksize: int,
                        stride: int = 1, pad: int = 0) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: ``torch._int_mm`` (int8 × int8 →
    int32) of :func:`im2col_operands`.  (B, H, W, C) int8 → (B, Ho, Wo,
    C_out) int32."""
    B, _, _, ho, wo = _check(x, wk, ksize, stride, pad)
    a, b = im2col_operands(x, wk, ksize, stride, pad)
    y = torch._int_mm(a, b)[:B * ho * wo, :wk.shape[0]]
    return y.reshape(B, ho, wo, wk.shape[0])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_SOURCE)
    fn = lib.int8_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 13 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def copy_width(x: torch.Tensor) -> int:
    """The kernel's copy path for ``x``: 16-byte copies where its channel
    count and address are multiples of 16, 4-byte where they are multiples
    of 4, else byte by byte."""
    c, ptr = x.shape[-1], x.data_ptr()
    for vec in (16, 4):
        if c % vec == 0 and ptr % vec == 0:
            return vec
    return 1


def int8_conv(x: torch.Tensor, wk: torch.Tensor, ksize: int, stride: int = 1,
              pad: int = 0) -> torch.Tensor:
    """int8 conv with int32 sums.

    Args:
      x: (B, H, W, C_in) int8 NHWC.
      wk: (C_out, Kp) int8, the weights of :func:`pack_weights`.
      ksize, stride, pad: the square window, its stride, the zero padding.

    Returns (B, Ho, Wo, C_out) int32 NHWC.  A CPU tensor takes
    :func:`int8_conv_reference`; a CUDA tensor launches the kernel on the
    current stream (counted in ``int8_conv.launches``) or raises.
    """
    if x.device.type == "cpu":
        return int8_conv_reference(x, wk, ksize, stride, pad)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    B, H, W, ho, wo = _check(x, wk, ksize, stride, pad)
    for name, t in (("x", x), ("wk", wk)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if wk.data_ptr() % 16:
        raise ValueError("wk must be 16-byte aligned for the CUDA kernel")
    c_out = wk.shape[0]
    y = torch.empty((B, ho, wo, c_out), dtype=torch.int32, device=x.device)
    with torch.cuda.device(x.device):
        err = _library().int8_conv_launch(
            x.data_ptr(), wk.data_ptr(), y.data_ptr(), B, H, W, x.shape[-1],
            ho, wo, c_out, ksize, ksize, stride, pad, wk.shape[1],
            copy_width(x), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    int8_conv.launches += 1
    return y


int8_conv.launches = 0
