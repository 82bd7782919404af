"""Primitive layer ops for the cfg-compiled Darknet, in PyTorch.

Mirrors ``singleshotpose_tpu/models/layers.py``.  These functions take NCHW
tensors (PyTorch's convention; the model keeps them in channels_last memory
so cuDNN runs NHWC) and reproduce the JAX package's numerics: BN eps 1e-4,
the leaky slope rounded to the activation's dtype, VALID max pool, the
replicate-padded stride-1 pool and darknet's ``reorg`` channel order.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

__all__ = ["BN_EPS", "batch_norm", "leaky_relu", "max_pool",
           "max_pool_stride1", "reorg", "global_avg_pool"]

BN_EPS = 1e-4  # singleshotpose_tpu/models/layers.py:27; torch's default is 1e-5


def per_channel(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(C,) → broadcastable against NCHW (or (B, C)) ``x``."""
    return v.reshape((1, -1) + (1,) * (x.dim() - 2))


def batch_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               mean: torch.Tensor, var: torch.Tensor,
               eps: float = BN_EPS) -> torch.Tensor:
    """Normalize with given statistics (inference form), math in f32, the
    result cast back to ``x.dtype`` — the JAX formula term for term
    (``inv = scale·rsqrt(var+eps)``, ``y = x·inv + (bias − mean·inv)``)."""
    inv = scale * torch.rsqrt(var + eps)
    shift = bias - mean * inv
    y = x.float() * per_channel(inv, x) + per_channel(shift, x)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _rounded(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` and back, once per (value, dtype)."""
    return torch.tensor(value, dtype=dtype).item()


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.1) -> torch.Tensor:
    """``where(x >= 0, x, slope·x)`` with the slope rounded to ``x.dtype``
    first, as JAX does with a weak-typed Python scalar: in bf16 the slope is
    0.10009765625.  ``F.leaky_relu`` multiplies by the f32 0.1 and rounds
    differently.  The rounded slope goes in as a Python float (the product
    is taken in f32 either way), so no device tensor is made per call."""
    return torch.where(x >= 0, x, x * _rounded(negative_slope, x.dtype))


def max_pool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max pool, VALID padding (torch ``nn.MaxPool2d(size, stride)``)."""
    return F.max_pool2d(x, size, stride)


def max_pool_stride1(x: torch.Tensor) -> torch.Tensor:
    """Stride-1 2×2 max pool with replicate pad right/bottom
    (``singleshotpose_tpu/models/layers.py:126-132``)."""
    return F.max_pool2d(F.pad(x, (0, 1, 0, 1), mode="replicate"), 2, 1)


def reorg(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Space-to-depth in darknet's channel order, NCHW form of
    ``out[b, i, k, (j·s+l)·C + c] = x[b, i·s+j, k·s+l, c]``: the intra-block
    offset (j, l) is the major part of the new channel index."""
    b, c, h, w = x.shape
    if h % stride or w % stride:
        raise ValueError(f"reorg stride {stride} does not divide {h}x{w}")
    s = stride
    x = x.reshape(b, c, h // s, s, w // s, s)          # b c i j k l
    x = x.permute(0, 3, 5, 1, 2, 4)                     # b j l c i k
    return x.reshape(b, s * s * c, h // s, w // s)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C) mean."""
    return x.mean(dim=(2, 3))
