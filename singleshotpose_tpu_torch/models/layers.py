"""Primitive layer ops for the cfg-compiled Darknet, in PyTorch.

Mirrors ``singleshotpose_tpu/models/layers.py``.  These functions take NCHW
tensors (PyTorch's convention; the model keeps them in channels_last memory
so cuDNN runs NHWC) and reproduce the JAX package's numerics: BN eps 1e-4,
the leaky slope rounded to the activation's dtype, VALID max pool, the
replicate-padded stride-1 pool and darknet's ``reorg`` channel order.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

from ..parallel.sharding import DPGroup, sync_sum

__all__ = ["BN_EPS", "BN_MOMENTUM", "batch_norm", "batch_norm_train",
           "running_stat_update", "leaky_relu", "max_pool",
           "max_pool_stride1", "reorg", "upsample_nearest",
           "global_avg_pool"]

BN_EPS = 1e-4  # singleshotpose_tpu/models/layers.py:27; torch's default is 1e-5
BN_MOMENTUM = 0.1


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


def batch_norm_train(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                     eps: float = BN_EPS, group: Optional[DPGroup] = None):
    """Training-mode batch norm of NCHW ``x`` over (N, H, W), the JAX
    formula written out (``singleshotpose_tpu/models/layers.py:62-84``):
    f32 math, ``mean = E[x]``, the *biased* ``var = E[x²] − mean²``, then
    :func:`batch_norm` with those statistics, the result in ``x.dtype``.
    The gradient flows through the batch statistics.  ``F.batch_norm`` is
    not used: its variance, eps handling and backward are not these.

    ``group``: sync-BN over a data-parallel group (JAX gets it from GSPMD's
    mean over the sharded batch axis): E[x] and E[x²] cover the global
    batch — each rank's are summed over the ranks
    (``parallel.sharding.sync_sum``, whose backward sums the cross-rank
    gradient terms) and divided by the world size.  The ranks' batches are
    the same size (the drivers split the global batch evenly), so this is
    the global mean; with a group of one it is the ungrouped form bit for
    bit.  On a data × model grid the group's ``pg``/``world`` are its data
    axis's: a split conv's channels are this rank's own, so its statistics
    are summed over the data group only.

    Returns (y, batch_mean, batch_var); the statistics are f32 and still
    attached to the graph (detach them for :func:`running_stat_update`).
    """
    x32 = x.float()
    dims = (0, 2, 3)
    mean = x32.mean(dim=dims)
    sq = torch.square(x32).mean(dim=dims)
    if group is not None:
        mean, sq = sync_sum(torch.stack([mean, sq]), group) / group.world
    var = sq - torch.square(mean)
    return batch_norm(x, scale, bias, mean, var, eps), mean, var


def running_stat_update(running_mean: torch.Tensor, running_var: torch.Tensor,
                        batch_mean: torch.Tensor, batch_var: torch.Tensor,
                        n: int, momentum: float = BN_MOMENTUM):
    """The torch-convention running update (``layers.py:87-94``):
    ``running = (1 − m)·running + m·batch``, with the *unbiased* batch
    variance ``var·n/(n − 1)``.  Returns (new_mean, new_var)."""
    unbiased = batch_var * (n / max(n - 1, 1))
    return ((1 - momentum) * running_mean + momentum * batch_mean,
            (1 - momentum) * running_var + momentum * unbiased)


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


def _window_max(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """VALID max pool as the elementwise max of the window's strided
    slices: exact for any dtype (CUDA's ``max_pool2d`` has no int8)."""
    ho = (x.shape[2] - size) // stride + 1
    wo = (x.shape[3] - size) // stride + 1
    out = None
    for dy in range(size):
        for dx in range(size):
            v = x[:, :, dy:dy + stride * (ho - 1) + 1:stride,
                  dx:dx + stride * (wo - 1) + 1:stride]
            out = v if out is None else torch.maximum(out, v)
    return out


def max_pool(x: torch.Tensor, size: int, stride: int) -> torch.Tensor:
    """Max pool, VALID padding (torch ``nn.MaxPool2d(size, stride)``); an
    integer (the int8 serve's) ``x`` pools through :func:`_window_max`."""
    if not x.is_floating_point():
        return _window_max(x, size, stride)
    return F.max_pool2d(x, size, stride)


def max_pool_stride1(x: torch.Tensor) -> torch.Tensor:
    """Stride-1 2×2 max pool with replicate pad right/bottom
    (``singleshotpose_tpu/models/layers.py:126-132``)."""
    if not x.is_floating_point():
        x = torch.cat([x, x[:, :, :, -1:]], dim=3)
        return _window_max(torch.cat([x, x[:, :, -1:]], dim=2), 2, 1)
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


def upsample_nearest(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """Darknet's ``[upsample]``: ``out[b, c, i, j] = x[b, c, i // s, j //
    s]``, each value copied without rounding, in ``x``'s memory format
    (channels_last stays channels_last)."""
    return F.interpolate(x, scale_factor=stride, mode="nearest")


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) → (B, C) mean."""
    return x.mean(dim=(2, 3))
