"""The fused stems: conv 3×3 3→32, then 2×2/2 max pool, as hand kernels.

Mirrors ``singleshotpose_tpu/ops/stem.py``, both halves:

* serving — :func:`stem_conv_pool_infer`: conv + folded bias + leaky + pool
  in one kernel (K1, ``csrc/stem_serve.cu``; the Pallas ``_k_serve``);
* training — :func:`stem_conv_bn_pool_train`: conv + train-mode BN + leaky
  + pool as one ``torch.autograd.Function`` whose forward is K3 + K4 and
  whose backward is K5 + K6 (``csrc/stem_train.cu``; the Pallas
  ``_k1_conv_stats``, ``_k2_bn_pool``, ``_b1_sums``, ``_b2_dw``), with the
  per-channel glue between them in plain PyTorch, as the JAX package leaves
  it to XLA.

Each kernel has a wrapper and a plain PyTorch version with the same
rounding points (``*_reference``).  On a CPU tensor the wrapper runs the
plain version; on a CUDA tensor it launches the kernel, counted in the
wrapper's ``launches``, or raises.  There is no fallback from the one to
the other.  The serving stem is also the ``torch.library`` custom op
``ssp::stem_conv_pool_infer``, registered when this module is imported
(the kernel is still built at its first launch), so that a
``torch.export`` of the serve keeps it as one node
(``serving.export_serving``).

The kernels are compiled with ``nvcc`` into plain-C shared libraries at
first use, keyed on the sources' content, under
``singleshotpose_tpu_torch/_build/``, and bound with ``ctypes``
(``ops/cuda_build.py``).

The train stem keeps the conv output ``y`` between its passes in bf16,
grouped by pool window: ``(B, H/2, W/2, 4, 32)``, window position
``p = dy·2 + dx`` in the order (0,0),(0,1),(1,0),(1,1) — the order in which
a tied window routes its gradient to the first maximum.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from ..models import layers as L
from ..parallel.sharding import all_reduce_sum_
from . import cuda_build

__all__ = ["stem_conv_pool_infer", "stem_conv_pool_infer_reference",
           "stem_conv_bn_pool_train", "stem_conv_stats",
           "stem_conv_stats_reference", "stem_bn_pool",
           "stem_bn_pool_reference", "stem_bwd_sums",
           "stem_bwd_sums_reference", "stem_bwd_dw", "stem_bwd_dw_reference"]

_CO = 32
_CI = 3
_SOURCE = "stem_serve"           # csrc/stem_serve.cu
_TRAIN_SOURCE = "stem_train"     # csrc/stem_train.cu
_PHASES = 4
# the bf16-rounded leaky slope, bf16(0.1) (singleshotpose_tpu/ops/stem.py:217)
_SLOPE = 0.10009765625


def _check_args(images: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    if images.dim() != 4 or images.shape[-1] != _CI:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if tuple(w.shape) != (_CO, _CI, 3, 3):
        raise ValueError(f"w must be OIHW (32, 3, 3, 3), got {tuple(w.shape)}")
    if tuple(bias.shape) != (_CO,):
        raise ValueError(f"bias must be (32,), got {tuple(bias.shape)}")
    for name, t in (("images", images), ("w", w), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")


def stem_conv_pool_infer_reference(images: torch.Tensor, w: torch.Tensor,
                                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch serving stem: ``F.conv2d`` in f32 on bf16-rounded
    operands, rounded to bf16, plus the f32 bias, rounded to bf16, leaky with
    the bf16 slope, 2×2/2 max pool.  NHWC (B, H, W, 3) f32 → (B, H/2, W/2, 32)
    bf16, contiguous NHWC.  The value the kernel must reproduce."""
    _check_args(images, w, bias)
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16).float()
    y = F.conv2d(x, w.to(torch.bfloat16).float(), padding=1).to(torch.bfloat16)
    z = (y.float() + L.per_channel(bias, y)).to(torch.bfloat16)
    pooled = L.max_pool(L.leaky_relu(z), 2, 2)
    return pooled.permute(0, 2, 3, 1).contiguous()


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_SOURCE)
    fn = lib.stem_conv_pool_infer_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _launch(what: str, t: torch.Tensor, fn, *args) -> None:
    """``fn(*args, stream)`` on ``t``'s device and current stream; raises if
    the launch failed (the C entry points return ``cudaGetLastError()``)."""
    with torch.cuda.device(t.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stem_conv_pool_infer(images: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Fused folded-serving stem forward: the custom op
    ``ssp::stem_conv_pool_infer``.

    Args:
      images: (B, H, W, 3) f32 NHWC in [0, 1].
      w: (32, 3, 3, 3) f32 OIHW conv weights with BN folded in.
      bias: (32,) f32 folded bias.

    Returns (B, H//2, W//2, 32) bf16, contiguous NHWC —
    ``max_pool(leaky(bf16(bf16(conv(x, w)) + b)), 2, 2)``.

    A CPU tensor takes :func:`stem_conv_pool_infer_reference`; a CUDA tensor
    launches the kernel (counted in ``stem_conv_pool_infer.launches``) or
    raises.  As an op with a fake implementation it traces into a
    ``torch.export`` graph, which then dispatches by device when it runs; a
    plain tensor outside a trace calls the device's implementation
    directly, without the dispatcher's call back into Python.
    """
    if images.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no serving-stem kernel for device {images.device}")
    if type(images) is torch.Tensor and not torch.compiler.is_compiling():
        impl = _stem_infer_cuda if images.is_cuda else \
            stem_conv_pool_infer_reference
        return impl(images, w, bias)
    return torch.ops.ssp.stem_conv_pool_infer.default(images, w, bias)


def _stem_infer_cuda(images: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    _check_args(images, w, bias)
    for name, t in (("images", images), ("w", w), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    B, H, W, _ = images.shape
    out = torch.empty((B, H // 2, W // 2, _CO), dtype=torch.bfloat16,
                      device=images.device)
    _launch("stem_serve", images, _library().stem_conv_pool_infer_launch,
            images.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W)
    stem_conv_pool_infer.launches += 1
    return out


def _stem_infer_fake(images: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor) -> torch.Tensor:
    _check_args(images, w, bias)
    B, H, W, _ = images.shape
    return images.new_empty((B, H // 2, W // 2, _CO), dtype=torch.bfloat16)


# the op: registered with ``Library``'s define/impl, whose dispatch costs less
# than ``torch.library.custom_op``'s (PERF.md §6); kept alive here
_LIB = torch.library.Library("ssp", "FRAGMENT")
_LIB.define("stem_conv_pool_infer(Tensor images, Tensor w, Tensor bias) "
            "-> Tensor")
_LIB.impl("stem_conv_pool_infer", stem_conv_pool_infer_reference, "CPU")
_LIB.impl("stem_conv_pool_infer", _stem_infer_cuda, "CUDA")
torch.library.register_fake("ssp::stem_conv_pool_infer", _stem_infer_fake,
                            lib=_LIB)
stem_conv_pool_infer.launches = 0


# ---------------------------------------------------------------------------
# the train stem: K3-K6, their plain versions, the glue, the autograd.Function
# ---------------------------------------------------------------------------


def _phases(y: torch.Tensor) -> torch.Tensor:
    """NCHW conv output (B, 32, H, W) → (B, H/2, W/2, 4, 32), contiguous."""
    B, C, H, W = y.shape
    return y.reshape(B, C, H // 2, 2, W // 2, 2).permute(0, 2, 4, 3, 5, 1) \
        .reshape(B, H // 2, W // 2, _PHASES, C).contiguous()


def _unphase(yph: torch.Tensor) -> torch.Tensor:
    """(B, H/2, W/2, 4, C) → NCHW (B, C, H, W)."""
    B, Hp, Wp, _, C = yph.shape
    return yph.reshape(B, Hp, Wp, 2, 2, C).permute(0, 5, 1, 3, 2, 4) \
        .reshape(B, C, 2 * Hp, 2 * Wp)


def _check_train_images(images: torch.Tensor) -> None:
    if images.dim() != 4 or images.shape[-1] != _CI:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    B, H, W, _ = images.shape
    if B == 0 or H == 0 or W == 0 or H % 2 or W % 2:
        raise ValueError(f"the train stem takes a non-empty batch with even H "
                         f"and W, got {tuple(images.shape)}")
    if images.dtype != torch.float32:
        raise TypeError(f"images must be float32, got {images.dtype}")


def _check_tensor(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")


def _check_vectors(device, **vectors) -> None:
    for name, v in vectors.items():
        _check_tensor(name, v, (_CO,), torch.float32, device)


def _cuda_ready(*named) -> None:
    """The kernels take contiguous CUDA tensors; raise on anything else."""
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}: no train-stem kernel "
                             "for that device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")


@functools.lru_cache(maxsize=None)
def _train_library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_TRAIN_SOURCE)
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for name, args in (
            ("stem_conv_stats_launch", [p] * 5 + [i] * 3 + [p]),
            ("stem_bn_pool_launch", [p] * 4 + [ll, p]),
            ("stem_bwd_sums_launch", [p] * 8 + [ll, p]),
            ("stem_bwd_dw_launch", [p] * 11 + [i] * 3 + [p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    for name in ("stem_conv_stats_blocks", "stem_bwd_sums_blocks",
                 "stem_bwd_dw_blocks"):
        getattr(lib, name).restype = ll
    lib.stem_conv_stats_blocks.argtypes = [i, i, i]
    lib.stem_bwd_sums_blocks.argtypes = [ll]
    lib.stem_bwd_dw_blocks.argtypes = [i, i, i]
    return lib


# --- K3: conv + the statistics' sums ---------------------------------------


def stem_conv_stats_reference(images: torch.Tensor, w: torch.Tensor):
    """Plain K3: ``F.conv2d`` in f32 on bf16-rounded operands, rounded to
    bf16, in the window-grouped layout; and per channel the sum and the sum
    of squares of those bf16 values (``singleshotpose_tpu/ops/stem.py:
    200-204``).  Returns (y (B, H/2, W/2, 4, 32) bf16, sums (2, 32) f32)."""
    _check_train_images(images)
    _check_tensor("w", w, (_CO, _CI, 3, 3), torch.float32, images.device)
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16).float()
    y = F.conv2d(x, w.to(torch.bfloat16).float(), padding=1).to(torch.bfloat16)
    yf = y.float()
    sums = torch.stack([yf.sum(dim=(0, 2, 3)), (yf * yf).sum(dim=(0, 2, 3))])
    return _phases(y), sums


def stem_conv_stats(images: torch.Tensor, w: torch.Tensor):
    """K3 (``_k1_conv_stats``): the bf16 conv output, window-grouped, and
    the (2, 32) f32 sums of y and y² — :func:`stem_conv_stats_reference` on
    a CPU tensor; the kernel (``stem_conv_stats.launches``) on a CUDA one."""
    if images.device.type == "cpu":
        return stem_conv_stats_reference(images, w)
    _check_train_images(images)
    _check_tensor("w", w, (_CO, _CI, 3, 3), torch.float32, images.device)
    _cuda_ready(("images", images), ("w", w))
    B, H, W, _ = images.shape
    lib = _train_library()
    y = torch.empty((B, H // 2, W // 2, _PHASES, _CO), dtype=torch.bfloat16,
                    device=images.device)
    partials = torch.empty((lib.stem_conv_stats_blocks(B, H, W), 2, _CO),
                           dtype=torch.float32, device=images.device)
    sums = torch.empty((2, _CO), dtype=torch.float32, device=images.device)
    _launch("stem_conv_stats", images, lib.stem_conv_stats_launch,
            images.data_ptr(), w.data_ptr(), y.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), B, H, W)
    stem_conv_stats.launches += 1
    return y, sums


stem_conv_stats.launches = 0


# --- K4: BN apply + leaky + pool -------------------------------------------


def _check_y(y: torch.Tensor) -> None:
    if y.dim() != 5 or tuple(y.shape[3:]) != (_PHASES, _CO) or \
            y.dtype != torch.bfloat16:
        raise ValueError(f"y must be (B, H/2, W/2, 4, 32) bf16, got "
                         f"{tuple(y.shape)} {y.dtype}")


def _leaky_f32(z: torch.Tensor) -> torch.Tensor:
    return torch.where(z >= 0, z, z * _SLOPE)


def _bn(yf: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor):
    """z = bf16(y·inv + shift), as f32 (the multiply and the add rounded
    each, as the kernels keep them)."""
    return (yf * inv + shift).to(torch.bfloat16).float()


def stem_bn_pool_reference(y: torch.Tensor, inv: torch.Tensor,
                           shift: torch.Tensor) -> torch.Tensor:
    """Plain K4: z = bf16(y·inv + shift), leaky in f32 on z, the max over
    the window, rounded to bf16 (``_k2_bn_pool``).  Returns (B, H/2, W/2, 32)
    bf16, contiguous NHWC."""
    _check_y(y)
    _check_vectors(y.device, inv=inv, shift=shift)
    return _leaky_f32(_bn(y.float(), inv, shift)).amax(dim=3) \
        .to(torch.bfloat16)


def stem_bn_pool(y: torch.Tensor, inv: torch.Tensor,
                 shift: torch.Tensor) -> torch.Tensor:
    """K4 (``_k2_bn_pool``): :func:`stem_bn_pool_reference` on a CPU tensor;
    the kernel (``stem_bn_pool.launches``) on a CUDA one."""
    if y.device.type == "cpu":
        return stem_bn_pool_reference(y, inv, shift)
    _check_y(y)
    _check_vectors(y.device, inv=inv, shift=shift)
    _cuda_ready(("y", y), ("inv", inv), ("shift", shift))
    B, Hp, Wp = y.shape[:3]
    out = torch.empty((B, Hp, Wp, _CO), dtype=torch.bfloat16, device=y.device)
    _launch("stem_bn_pool", y, _train_library().stem_bn_pool_launch,
            y.data_ptr(), inv.data_ptr(), shift.data_ptr(), out.data_ptr(),
            B * Hp * Wp)
    stem_bn_pool.launches += 1
    return out


stem_bn_pool.launches = 0


# --- K5 and K6: the backward -----------------------------------------------


def _check_grad(y: torch.Tensor, g: torch.Tensor) -> None:
    _check_y(y)
    _check_tensor("g", g, tuple(y.shape[:3]) + (_CO,), torch.bfloat16,
                  y.device)


def _grad_z(y: torch.Tensor, g: torch.Tensor, inv, shift, mean, rstd):
    """The backward's per-element work (``_routing``, ``_b1_sums``): the
    window's z and rounded leaky outputs recomputed, g routed to the first
    maximum in window order, times leaky′(z); and x̂ = (y − mean)·rstd.
    Returns (gz, x̂), both (B, H/2, W/2, 4, 32) f32."""
    yf = y.float()
    z = _bn(yf, inv, shift)
    a = _leaky_f32(z).to(torch.bfloat16).float()
    eq = a == a.amax(dim=3, keepdim=True)
    first = eq & (torch.cumsum(eq.to(torch.int32), dim=3) == 1)
    gz = torch.where(first, g.float()[:, :, :, None, :], 0.0) \
        * torch.where(z >= 0, 1.0, _SLOPE)
    return gz, (yf - mean) * rstd


def stem_bwd_sums_reference(y, g, inv, shift, mean, rstd) -> torch.Tensor:
    """Plain K5: (Σ gz, Σ gz·x̂) per channel, (2, 32) f32."""
    _check_grad(y, g)
    _check_vectors(y.device, inv=inv, shift=shift, mean=mean, rstd=rstd)
    gz, xhat = _grad_z(y, g, inv, shift, mean, rstd)
    return torch.stack([gz.sum(dim=(0, 1, 2, 3)),
                        (gz * xhat).sum(dim=(0, 1, 2, 3))])


def stem_bwd_sums(y, g, inv, shift, mean, rstd) -> torch.Tensor:
    """K5 (``_b1_sums``): :func:`stem_bwd_sums_reference` on a CPU tensor;
    the kernel (``stem_bwd_sums.launches``) on a CUDA one."""
    if y.device.type == "cpu":
        return stem_bwd_sums_reference(y, g, inv, shift, mean, rstd)
    _check_grad(y, g)
    _check_vectors(y.device, inv=inv, shift=shift, mean=mean, rstd=rstd)
    _cuda_ready(("y", y), ("g", g), ("inv", inv), ("shift", shift),
                ("mean", mean), ("rstd", rstd))
    total = y.shape[0] * y.shape[1] * y.shape[2]
    lib = _train_library()
    partials = torch.empty((lib.stem_bwd_sums_blocks(total), 2, _CO),
                           dtype=torch.float32, device=y.device)
    sums = torch.empty((2, _CO), dtype=torch.float32, device=y.device)
    _launch("stem_bwd_sums", y, lib.stem_bwd_sums_launch,
            y.data_ptr(), g.data_ptr(), inv.data_ptr(), shift.data_ptr(),
            mean.data_ptr(), rstd.data_ptr(), partials.data_ptr(),
            sums.data_ptr(), total)
    stem_bwd_sums.launches += 1
    return sums


stem_bwd_sums.launches = 0


def _dw_oihw(dw_taps: torch.Tensor) -> torch.Tensor:
    """(27, 32) rows tap = (ky·3 + kx)·3 + ci (the TPU kernels' ``_wmat``
    order) → OIHW (32, 3, 3, 3)."""
    return dw_taps.reshape(3, 3, _CI, _CO).permute(3, 2, 0, 1).contiguous()


def stem_bwd_dw_reference(y, g, images, inv, shift, mean, rstd, c1,
                          c2) -> torch.Tensor:
    """Plain K6: dy = bf16(inv·gz − c1 − x̂·c2) (``_b2_dw``, stem.py:321),
    then the conv's weight gradient against the bf16-rounded image in f32.
    Returns OIHW (32, 3, 3, 3) f32."""
    _check_grad(y, g)
    _check_train_images(images)
    _check_vectors(y.device, inv=inv, shift=shift, mean=mean, rstd=rstd,
                   c1=c1, c2=c2)
    gz, xhat = _grad_z(y, g, inv, shift, mean, rstd)
    dy = (inv * gz - c1 - xhat * c2).to(torch.bfloat16).float()
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16).float()
    return torch.nn.grad.conv2d_weight(x, (_CO, _CI, 3, 3), _unphase(dy),
                                       padding=1)


def stem_bwd_dw(y, g, images, inv, shift, mean, rstd, c1, c2) -> torch.Tensor:
    """K6 (``_b2_dw``): :func:`stem_bwd_dw_reference` on a CPU tensor; the
    kernel (``stem_bwd_dw.launches``) on a CUDA one.  OIHW (32, 3, 3, 3)."""
    if y.device.type == "cpu":
        return stem_bwd_dw_reference(y, g, images, inv, shift, mean, rstd,
                                     c1, c2)
    _check_grad(y, g)
    _check_train_images(images)
    _check_vectors(y.device, inv=inv, shift=shift, mean=mean, rstd=rstd,
                   c1=c1, c2=c2)
    if tuple(images.shape[:3]) != (y.shape[0], 2 * y.shape[1], 2 * y.shape[2]):
        raise ValueError(f"images {tuple(images.shape)} do not match y "
                         f"{tuple(y.shape)}")
    _cuda_ready(("y", y), ("g", g), ("images", images), ("inv", inv),
                ("shift", shift), ("mean", mean), ("rstd", rstd), ("c1", c1),
                ("c2", c2))
    B, H, W, _ = images.shape
    lib = _train_library()
    partials = torch.empty((lib.stem_bwd_dw_blocks(B, H, W), 27 * _CO),
                           dtype=torch.float32, device=y.device)
    dw = torch.empty((27, _CO), dtype=torch.float32, device=y.device)
    _launch("stem_bwd_dw", y, lib.stem_bwd_dw_launch,
            y.data_ptr(), g.data_ptr(), images.data_ptr(), inv.data_ptr(),
            shift.data_ptr(), mean.data_ptr(), rstd.data_ptr(), c1.data_ptr(),
            c2.data_ptr(), partials.data_ptr(), dw.data_ptr(), B, H, W)
    stem_bwd_dw.launches += 1
    return _dw_oihw(dw)


stem_bwd_dw.launches = 0


# --- the glue and the autograd.Function -------------------------------------


def _count(n: int, device: torch.device) -> torch.Tensor:
    """``n`` as a 0-dim f32 tensor on ``device``: dividing by it is a true
    division on the card, where dividing by a Python number becomes a
    multiply by its reciprocal (the JAX glue divides)."""
    return torch.full((), float(n), device=device)


def _incoming_grad(g: torch.Tensor) -> torch.Tensor:
    """The gradient that reaches ``pooled`` as the kernels take it:
    contiguous NHWC bf16.  It comes from the next conv's data gradient, and
    is contiguous when that conv ran channels_last; otherwise it is copied
    here, and the copy is counted in ``stem_conv_bn_pool_train.grad_copies``."""
    if g.dtype != torch.bfloat16:
        g = g.to(torch.bfloat16)
    if not g.is_contiguous():
        g = g.contiguous()
        stem_conv_bn_pool_train.grad_copies += 1
    return g


class _StemTrain(torch.autograd.Function):
    """``_stem_core`` (``singleshotpose_tpu/ops/stem.py:450-474``):
    forward K3 + K4, backward K5 + K6; the image's gradient is a structural
    zero (``None``), as in ``_stem_core_bwd``.

    With a data-parallel ``group`` it follows ``_fwd_impl``/``_bwd_impl``
    with ``axis_name`` (``:372-376``, ``:412-422``): K3's (2, 32) sums are
    summed over the ranks before the statistics, with the global count, and
    the backward sums a copy of K5's for c1/c2, which every rank must agree
    on.  dW and the returned ``dscale``/``dbias`` stay the rank's own: the
    train step's gradient all-reduce sums them (returning the global sums
    would make the BN gradients world-size times too large)."""

    @staticmethod
    def forward(ctx, images, w, scale, bias, group):
        B, H, W, _ = images.shape
        world = 1 if group is None else group.world
        n = _count(B * H * W * world, images.device)
        y, sums = stem_conv_stats(images, w)
        if group is not None:
            all_reduce_sum_([sums], group)
        mean = sums[0] / n
        var = sums[1] / n - mean * mean
        inv = scale * torch.rsqrt(var + L.BN_EPS)
        shift = bias - mean * inv
        pooled = stem_bn_pool(y, inv, shift)
        ctx.save_for_backward(images, y, mean, var, inv, shift, n)
        ctx.group = group
        ctx.mark_non_differentiable(mean, var)
        return pooled, mean, var

    @staticmethod
    def backward(ctx, g_pooled, _g_mean, _g_var):
        # the batch statistics feed the running statistics only
        images, y, mean, var, inv, shift, n = ctx.saved_tensors
        g = _incoming_grad(g_pooled)
        rstd = torch.rsqrt(var + L.BN_EPS)
        sums = stem_bwd_sums(y, g, inv, shift, mean, rstd)
        gsums = sums
        if ctx.group is not None:
            gsums = sums.clone()
            all_reduce_sum_([gsums], ctx.group)
        c1 = inv * gsums[0] / n
        c2 = inv * gsums[1] / n
        dw = stem_bwd_dw(y, g, images, inv, shift, mean, rstd, c1, c2)
        return None, dw, sums[1], sums[0], None


def stem_conv_bn_pool_train(images: torch.Tensor, w: torch.Tensor,
                            scale: torch.Tensor, bias: torch.Tensor,
                            group=None):
    """Fused stem forward for training
    (``singleshotpose_tpu/ops/stem.py:stem_conv_bn_pool_train``; with
    ``group`` its ``stem_conv_bn_pool_train_sharded``).

    Args:
      images: (B, H, W, 3) f32 in [0, 1], H and W even.
      w: (32, 3, 3, 3) f32 OIHW conv weights.
      scale, bias: (32,) f32 BN affine parameters.
      group: a ``parallel.sharding.DPGroup`` when ``images`` are this
        rank's rows of a data-parallel batch: the kernels run on them
        unchanged, and the BN statistics and the backward's c1/c2 sums are
        all-reduced over its data group (sync-BN; the batch statistics
        returned are the global batch's), while the gradients returned are
        this rank's share, for the step's gradient all-reduce to sum.  On
        a data × model grid the kernels take all 32 channels: the caller
        passes conv_1's weight, scale and bias gathered over the model
        group (``models.darknet.Darknet.forward``).

    Returns (pooled, batch_mean, batch_var_biased):
      pooled: (B, H//2, W//2, 32) bf16, contiguous NHWC —
        ``max_pool(leaky(batch_norm_train(conv2d(x, w))), 2, 2)`` up to f32
        summation order in the statistics;
      the batch statistics: (32,) f32, for the caller's running update.

    Differentiable in ``w``, ``scale`` and ``bias``; the image's gradient is
    ``None``.  The kernels run where the tensors are: the plain versions on
    the CPU, K3–K6 on a card (each counted in its wrapper's ``launches``).
    """
    _check_train_images(images)
    _check_tensor("w", w, (_CO, _CI, 3, 3), torch.float32, images.device)
    _check_vectors(images.device, scale=scale, bias=bias)
    return _StemTrain.apply(images, w, scale, bias, group)


stem_conv_bn_pool_train.grad_copies = 0
