"""int8 convolution with int32 sums and, optionally, the int8 serve's
epilogue: the conv of the int8 serving path.

Computes what ``singleshotpose_tpu/models/layers.py:30``
``conv2d(xq, wq, stride, pad, preferred_dtype=int32)`` computes in the JAX
package's int8 serve (``models/quantize.py:apply_quantized``): NHWC int8
activations × HWIO int8 weights → int32 NHWC, zero padding; and with an
:class:`Epilogue` what that serve computes after it, per output: the
dequant ``fma(f32(y), scale, b)``, the compute dtype, leaky, and the next
quantized conv's quantizer ``clip(round(v·q or v/q), ±127)`` as int8.  JAX
leaves all of this to XLA, which fuses the requantize into the conv's
epilogue; PyTorch has no CUDA int8 convolution, so on a card it is one
hand-written kernel (``csrc/int8_conv.cu``: an implicit GEMM on ``wgmma``
with the epilogue in registers, built with ``nvcc`` for sm_90a at first use
and bound with ``ctypes``).

The weights are re-packed once (:func:`pack_weights`) to ``(C_out, Kp)``:
row ``n`` is output channel ``n``'s HWIO weights flattened over (kh, kw,
c_in), zero-padded to ``Kp``, a multiple of 32.  A C_in that is not a
multiple of 4 (the first conv's 3) is padded with zero channels, in the
weights (``pack_weights(c_in=)``) and in the input, so that the kernel
copies 4 bytes at a time; zeros add nothing to integer sums.

:func:`int8_conv` on a CUDA tensor launches the kernel (counted in
``int8_conv.launches``, the launches with an epilogue also in
``int8_conv.fused_launches``) or raises; on a CPU tensor it runs the plain
twin :func:`int8_conv_reference` (``F.unfold`` of the int8 values carried in
a float type, ``torch._int_mm``, then :func:`epilogue_reference`, the same
ops as the unfused chain).  Integer sums are exact and the epilogue rounds
where the twin does, so the two agree bit for bit.  Both sit behind the
``torch.library`` custom op ``ssp::int8_conv`` (registered when this module
is imported; the kernel is built at its first launch), whose fake
implementation gives a ``torch.export`` of the int8 serve its shapes
without tracing into the conv (``serving.export_serving``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..data.device_augment import fma
from . import cuda_build

__all__ = ["Epilogue", "pack_weights", "int8_conv", "int8_conv_reference",
           "epilogue_reference", "im2col_operands", "copy_width", "tile_for",
           "round_clip", "INT8_MAX"]

_SOURCE = "int8_conv"      # csrc/int8_conv.cu
_K_ALIGN = 32              # the kernel's K step (wgmma k32)
INT8_MAX = 127.0
_LEAKY_SLOPE = 0.1

# the kernel's flags (csrc/int8_conv.cu)
_OUT_I32, _OUT_VALUE, _VALUE_BF16, _OUT_I8 = 1, 2, 4, 8
_LEAKY, _DIVIDE = 16, 32
_VEC_I32, _VEC_VALUE, _VEC_I8 = 64, 128, 256


@dataclasses.dataclass(frozen=True)
class Epilogue:
    """What the kernel computes from each int32 sum ``y`` of output channel
    ``n``: ``v = fma(f32(y), scale[n], bias[n])`` in f32, rounded to
    ``dtype`` (bf16; ``None`` or f32: no rounding), then leaky (``leaky``)
    with the slope rounded to ``dtype``; ``v`` is an output when ``value``.
    With ``quant`` (f32, ``(C_out,)`` per channel or ``(1,)``, on the
    device): also ``clip(round(v·quant), ±127)`` as int8, or ``v / quant``
    with ``divide`` — the next quantized conv's quantizer."""

    scale: torch.Tensor
    bias: torch.Tensor
    dtype: Optional[torch.dtype] = torch.bfloat16
    leaky: bool = True
    quant: Optional[torch.Tensor] = None
    divide: bool = False
    value: bool = True

    def __post_init__(self):
        if not self.value and self.quant is None:
            raise ValueError("an epilogue writes the value, the int8 or both")


def round_clip(v: torch.Tensor) -> torch.Tensor:
    """The int8 quantizer's rounding: ``clip(round(v), ±127)``, half to
    even as ``jnp.round``, still in ``v``'s float dtype; the cast to int8
    that follows is exact (the caller's, so that it may write into a
    buffer of its own)."""
    return torch.clamp(torch.round(v), -INT8_MAX, INT8_MAX)


@functools.lru_cache(maxsize=None)
def _leaky_slope(dtype: torch.dtype) -> float:
    """Leaky's slope rounded to ``dtype`` (0.10009765625 in bf16), as
    ``models.layers.leaky_relu`` and JAX's weak-typed scalar round it."""
    return torch.tensor(_LEAKY_SLOPE, dtype=dtype).item()


def _packed_depth(ksize: int, c_in: int) -> int:
    """``Kp``: K = ksize²·c_in rounded up to a multiple of 32."""
    k = ksize * ksize * c_in
    return -(-k // _K_ALIGN) * _K_ALIGN


def pack_weights(wq: torch.Tensor, c_in: Optional[int] = None
                 ) -> torch.Tensor:
    """HWIO int8 ``(KH, KW, C_in, C_out)`` → ``(C_out, Kp)`` int8,
    contiguous, on ``wq``'s device; ``c_in``: pad the input channels with
    zeros to this count first (the input then carries as many)."""
    if wq.dim() != 4 or wq.dtype != torch.int8 or wq.shape[0] != wq.shape[1]:
        raise ValueError(f"wq must be square HWIO int8, got {tuple(wq.shape)} "
                         f"{wq.dtype}")
    kh, _, c, c_out = wq.shape
    c_in = c if c_in is None else c_in
    if c_in < c:
        raise ValueError(f"cannot pad {c} input channels to {c_in}")
    wq = F.pad(wq, (0, 0, 0, c_in - c))
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
                         f"over {x.shape[-1]} channels (padded ones "
                         f"included) packs to "
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


def epilogue_reference(y: torch.Tensor, ep: Epilogue
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """The plain epilogue on the int32 NHWC ``y``, the unfused chain's ops
    (``fma``, the cast, ``models.layers.leaky_relu``'s ``where``, the
    quantizer's multiply or division and :func:`round_clip`): (value or
    None, int8 or None)."""
    v = fma(y.float(), ep.scale, ep.bias)
    if ep.dtype is not None:
        v = v.to(ep.dtype)
    if ep.leaky:
        v = torch.where(v >= 0, v, v * _leaky_slope(v.dtype))
    q8 = None
    if ep.quant is not None:
        u = v.float()
        u = u / ep.quant if ep.divide else u * ep.quant
        q8 = round_clip(u).to(torch.int8)
    return (v if ep.value else None), q8


def int8_conv_reference(x: torch.Tensor, wk: torch.Tensor, ksize: int,
                        stride: int = 1, pad: int = 0,
                        epilogue: Optional[Epilogue] = None):
    """Plain PyTorch twin of the kernel: ``torch._int_mm`` (int8 × int8 →
    int32) of :func:`im2col_operands`, then :func:`epilogue_reference`.
    (B, H, W, C) int8 → (B, Ho, Wo, C_out) int32, or with ``epilogue``
    (value or None, int8 or None) of that shape."""
    B, _, _, ho, wo = _check(x, wk, ksize, stride, pad)
    a, b = im2col_operands(x, wk, ksize, stride, pad)
    y = torch._int_mm(a, b)[:B * ho * wo, :wk.shape[0]]
    y = y.reshape(B, ho, wo, wk.shape[0])
    return y if epilogue is None else epilogue_reference(y, epilogue)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_SOURCE)
    fn = lib.int8_conv_launch
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + \
        [ctypes.c_float] + [ctypes.c_int] * 15 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def copy_width(x: torch.Tensor) -> int:
    """The kernel's copy path for ``x``: 16-byte copies where its channel
    count and address are multiples of 16, 4-byte where they are multiples
    of 4; 1 where neither holds, which the kernel does not take."""
    c, ptr = x.shape[-1], x.data_ptr()
    for vec in (16, 4):
        if c % vec == 0 and ptr % vec == 0:
            return vec
    return 1


# H100's streaming multiprocessors: a grid of fewer tiles than this leaves
# SMs idle, so smaller tiles win there
_SMS = 132


def tile_for(m: int, n: int, k: int) -> Tuple[int, int]:
    """The kernel's (BM, BN) for an M x N x K product, a table read from
    ``scripts/int8_conv_variants.py --tiles`` (every tile at every int8 conv
    of the 672² serves at batch 8 and 1 and of the multi serve at batch 16,
    416², on an H100 80GB HBM3 at 700 W): 128 x 32 for C_out 32; else the
    largest tile of 128 x 128, 64 x 128, 64 x 64 (BN at most C_out rounded
    up to 32) that still gives every SM a tile; else 64 x 32 for K up to
    1024 and 64 x 64 past it."""
    def tiles(bm, bn):
        return -(-m // bm) * -(-n // bn)

    bn_most = min(128, -(-n // 32) * 32)
    if bn_most == 32:
        return 128, 32
    for bm, bn in ((128, 128), (64, 128), (64, 64)):
        if bn <= bn_most and tiles(bm, bn) >= _SMS:
            return bm, bn
    return (64, 32) if k <= 1024 else (64, 64)


def _vector(t: torch.Tensor, n: int, name: str) -> torch.Tensor:
    if t.dtype != torch.float32 or t.dim() != 1 or t.numel() != n \
            or not t.is_contiguous() or not t.is_cuda:
        raise ValueError(f"the epilogue's {name} must be a contiguous f32 "
                         f"({n},) CUDA tensor, got {tuple(t.shape)} {t.dtype} "
                         f"on {t.device}")
    return t


def int8_conv(x: torch.Tensor, wk: torch.Tensor, ksize: int, stride: int = 1,
              pad: int = 0, epilogue: Optional[Epilogue] = None,
              tile: Optional[Tuple[int, int]] = None):
    """int8 conv with int32 sums, or with ``epilogue`` its outputs: the
    custom op ``ssp::int8_conv``.

    Args:
      x: (B, H, W, C_in) int8 NHWC; on a card C_in and the address a
        multiple of 4 (pad C_in with zero channels, and the weights with
        ``pack_weights(c_in=)``).
      wk: (C_out, Kp) int8, the weights of :func:`pack_weights`.
      ksize, stride, pad: the square window, its stride, the zero padding.
      epilogue: None for the int32 sums, else what to compute from them.
      tile: the kernel's (BM, BN), by default :func:`tile_for`'s.

    Returns (B, Ho, Wo, C_out) int32 NHWC, or with ``epilogue`` (value, q8):
    the value in its dtype (None unless ``epilogue.value``) and the int8
    (None without ``epilogue.quant``), NHWC.  A CPU tensor takes
    :func:`int8_conv_reference`; a CUDA tensor launches the kernel on the
    current stream (counted in ``int8_conv.launches``) or raises.

    The op's schema cannot carry an :class:`Epilogue` or a ``None``
    output: the epilogue crosses it flattened (:func:`_flatten`) and the op
    returns a list of the outputs asked for, which this function maps back
    (:func:`_unflatten_outputs`).  A plain tensor outside a trace calls the
    op's kernel for its device directly: the dispatcher's call back into
    Python costs ~10–20 µs, 22 times an int8 serve (PERF.md §6), and only a
    tracer (``torch.export``, ``torch.compile``) needs the op.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no int8 conv kernel for device {x.device}")
    args = (x, wk, ksize, stride, pad, *_flatten(epilogue),
            None if tile is None else list(tile))
    if type(x) is torch.Tensor and not torch.compiler.is_compiling():
        outs = (_int8_conv_cuda if x.is_cuda else _int8_conv_cpu)(*args)
    else:
        outs = torch.ops.ssp.int8_conv.default(*args)
    return _unflatten_outputs(epilogue, outs)


def _flatten(ep: Optional[Epilogue]) -> tuple:
    """``ep`` as the op's arguments (scale, bias, quant, dtype, leaky,
    divide, value); ``scale`` None stands for no epilogue."""
    if ep is None:
        return (None,) * 4 + (False, False, True)
    return (ep.scale, ep.bias, ep.quant, ep.dtype, ep.leaky, ep.divide,
            ep.value)


def _unflatten_outputs(ep: Optional[Epilogue], outs):
    """The op's list of outputs → :func:`int8_conv`'s return: [y32] without
    an epilogue, else the value (when ``ep.value``) then the int8 (when
    ``ep.quant``)."""
    if ep is None:
        return outs[0]
    return (outs[0] if ep.value else None), \
        (outs[-1] if ep.quant is not None else None)


def _value_dtype(dtype: Optional[torch.dtype]) -> torch.dtype:
    return torch.float32 if dtype is None else dtype


def _outputs(*outs):
    """The op's outputs: those asked for, contiguous."""
    return [t.contiguous() for t in outs if t is not None]


def _int8_conv_cpu(x, wk, ksize, stride, pad, scale, bias, quant, dtype,
                   leaky, divide, value, tile):
    ep = None if scale is None else Epilogue(
        scale, bias, dtype=dtype, leaky=leaky, quant=quant, divide=divide,
        value=value)
    out = int8_conv_reference(x, wk, ksize, stride, pad, ep)
    return _outputs(out) if ep is None else _outputs(*out)


def _int8_conv_fake(x, wk, ksize, stride, pad, scale, bias, quant, dtype,
                    leaky, divide, value, tile):
    B, _, _, ho, wo = _check(x, wk, ksize, stride, pad)
    shape = (B, ho, wo, wk.shape[0])
    if scale is None:
        return [x.new_empty(shape, dtype=torch.int32)]
    return _outputs(
        x.new_empty(shape, dtype=_value_dtype(dtype)) if value else None,
        x.new_empty(shape, dtype=torch.int8) if quant is not None else None)


def _int8_conv_cuda(x, wk, ksize, stride, pad, scale, bias, quant, dtype,
                    leaky, divide, value, tile):
    B, H, W, ho, wo = _check(x, wk, ksize, stride, pad)
    for name, t in (("x", x), ("wk", wk)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    if wk.data_ptr() % 16:
        raise ValueError("wk must be 16-byte aligned for the CUDA kernel")
    vec = copy_width(x)
    if vec == 1:
        raise ValueError(f"the CUDA kernel takes C_in and x's address "
                         f"multiples of 4, got C_in {x.shape[-1]} at "
                         f"{x.data_ptr() % 16} bytes past 16: pad C_in "
                         f"with zero channels (pack_weights(c_in=))")
    c_out = wk.shape[0]
    bm, bn = tile or tile_for(B * ho * wo, c_out, ksize * ksize * x.shape[-1])
    shape = (B, ho, wo, c_out)
    vdtype = _value_dtype(dtype)
    y32 = v_out = q8 = None
    q_stride, slope = 0, 0.0
    if scale is None:
        y32 = torch.empty(shape, dtype=torch.int32, device=x.device)
        flags = _OUT_I32 | (_VEC_I32 if c_out * 4 % 16 == 0 else 0)
    else:
        if vdtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"the CUDA kernel's value is bf16 or f32, not "
                             f"{vdtype}")
        scale = _vector(scale, c_out, "scale")
        bias = _vector(bias, c_out, "bias")
        flags = _VALUE_BF16 if vdtype == torch.bfloat16 else 0
        if leaky:
            flags |= _LEAKY
            slope = _leaky_slope(vdtype)
        if value:
            v_out = torch.empty(shape, dtype=vdtype, device=x.device)
            flags |= _OUT_VALUE
            if c_out * v_out.element_size() % 16 == 0:
                flags |= _VEC_VALUE
        if quant is not None:
            quant = _vector(quant, quant.numel(), "quantizer")
            if quant.numel() not in (1, c_out):
                raise ValueError(f"the quantizer has {quant.numel()} scales "
                                 f"for {c_out} channels")
            q_stride = int(quant.numel() == c_out and c_out > 1)
            q8 = torch.empty(shape, dtype=torch.int8, device=x.device)
            flags |= _OUT_I8 | (_DIVIDE if divide else 0)
            if c_out % 16 == 0:
                flags |= _VEC_I8
        for name, t in (("scale", scale), ("bias", bias), ("quantizer", quant)):
            if t is not None and t.device != x.device:
                raise ValueError(f"the epilogue's {name} is on {t.device}, x "
                                 f"on {x.device}")

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x.device):
        err = _library().int8_conv_launch(
            x.data_ptr(), wk.data_ptr(), ptr(y32), ptr(v_out), ptr(q8),
            ptr(scale), ptr(bias), ptr(quant), q_stride, flags, slope, B, H,
            W, x.shape[-1], ho, wo, c_out, ksize, ksize, stride, pad,
            wk.shape[1], vec, bm, bn, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"int8_conv kernel launch failed: CUDA error {err}")
    int8_conv.launches += 1
    if y32 is None:
        int8_conv.fused_launches += 1
    return [t for t in (y32, v_out, q8) if t is not None]


int8_conv.launches = 0
int8_conv.fused_launches = 0

# the op: registered with ``Library``'s define/impl, whose dispatch costs less
# than ``torch.library.custom_op``'s (PERF.md §6); kept alive here
_LIB = torch.library.Library("ssp", "FRAGMENT")
_LIB.define("int8_conv(Tensor x, Tensor wk, int ksize, int stride, int pad, "
            "Tensor? scale, Tensor? bias, Tensor? quant, ScalarType? dtype, "
            "bool leaky, bool divide, bool value, int[]? tile) "
            "-> Tensor[]")
_LIB.impl("int8_conv", _int8_conv_cpu, "CPU")
_LIB.impl("int8_conv", _int8_conv_cuda, "CUDA")
torch.library.register_fake("ssp::int8_conv", _int8_conv_fake, lib=_LIB)
