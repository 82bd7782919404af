"""Pass 1 of target assignment: the max-over-ground-truths corner confidence.

Mirrors ``singleshotpose_tpu/ops/pallas_kernels.py`` (``max_corner_confidence``,
whose Pallas kernel is ``_kernel``).  For every predicted cell, the max over
the valid ground-truth slots of the mean keypoint confidence
(:func:`~singleshotpose_tpu_torch.ops.confidence.corner_confidences`).

On a CUDA tensor :func:`max_corner_confidence` launches the hand-written
Hopper kernel in ``csrc/max_corner_confidence.cu``, which never writes the
(B, G, S) confidences to memory and packs the image's valid (slot, cell)
pairs onto its threads, so its cost follows the valid slots, not G; on a
CPU tensor it runs
:func:`max_corner_confidence_reference`, the plain PyTorch form that
``build_targets`` uses off a TPU (``singleshotpose_tpu/ops/targets.py:113-117``).
There is no fallback from the one to the other: a CUDA tensor runs the
kernel or raises.

Data parallel (the counterpart of JAX's ``max_corner_confidence_sharded``,
``pallas_kernels.py:126-151``): each rank's train step calls
:func:`max_corner_confidence` on its own rows, with no collective.  Every
row's result depends on that row alone, so a rank's output equals those
rows of the call on the global batch bit for bit; the loss's stats are then
summed over the ranks by the step.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build
from .confidence import confidence_denominator, corner_confidences

__all__ = ["max_corner_confidence", "max_corner_confidence_reference"]

_SOURCE = "max_corner_confidence"    # csrc/max_corner_confidence.cu
_KERNEL_K = 9                        # the keypoint count the kernel is built for


def _check_args(gt_corners, valid, pred_corners) -> None:
    if gt_corners.dim() != 3 or pred_corners.dim() != 3 or valid.dim() != 2:
        raise ValueError("expected gt (B, G, 2K), valid (B, G), pred (B, S, 2K)")
    B, G, K2 = gt_corners.shape
    if tuple(valid.shape) != (B, G) or pred_corners.shape[0] != B \
            or pred_corners.shape[2] != K2 or K2 % 2:
        raise ValueError(f"shapes disagree: gt {tuple(gt_corners.shape)}, "
                         f"valid {tuple(valid.shape)}, "
                         f"pred {tuple(pred_corners.shape)}")
    for name, t in (("gt_corners", gt_corners), ("pred_corners", pred_corners)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for name, t in (("valid", valid), ("pred_corners", pred_corners)):
        if t.device != gt_corners.device:
            raise ValueError(f"{name} is on {t.device}, gt_corners on "
                             f"{gt_corners.device}")


def max_corner_confidence_reference(gt_corners: torch.Tensor,
                                    valid: torch.Tensor,
                                    pred_corners: torch.Tensor, *,
                                    th: float = 80.0, sharpness: float = 2.0,
                                    im_width: float = 640.0,
                                    im_height: float = 480.0) -> torch.Tensor:
    """Plain PyTorch version: :func:`corner_confidences` over every
    (slot, cell) pair, (B, G, S), masked by ``valid``, then the max over G,
    which starts at 0 (so G = 0 gives zeros).  The value the kernel must
    reproduce."""
    _check_args(gt_corners, valid, pred_corners)
    if gt_corners.shape[1] == 0:
        return gt_corners.new_zeros(pred_corners.shape[:2])
    confs = corner_confidences(gt_corners[:, :, None, :],
                               pred_corners[:, None, :, :], th=th,
                               sharpness=sharpness, im_width=im_width,
                               im_height=im_height)                # (B, G, S)
    confs = torch.where(valid.bool()[:, :, None], confs, 0.0)
    return confs.amax(dim=1)


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = cuda_build.load_library(_SOURCE)
    fn = lib.max_corner_confidence_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def max_corner_confidence(gt_corners: torch.Tensor, valid: torch.Tensor,
                          pred_corners: torch.Tensor, *, th: float = 80.0,
                          sharpness: float = 2.0, im_width: float = 640.0,
                          im_height: float = 480.0) -> torch.Tensor:
    """Max over valid GT slots of the mean keypoint confidence, per cell.

    Args:
      gt_corners: (B, G, 2K) f32 normalized GT keypoints.
      valid: (B, G) bool or float slot validity.
      pred_corners: (B, S, 2K) f32 normalized predictions.

    Returns (B, S) f32, equal to :func:`max_corner_confidence_reference`.

    A CPU tensor takes :func:`max_corner_confidence_reference`; a CUDA tensor
    launches the kernel (counted in ``max_corner_confidence.launches``) or
    raises.  The kernel takes contiguous inputs and K = 9 keypoints.
    """
    kw = dict(th=th, sharpness=sharpness, im_width=im_width,
              im_height=im_height)
    if gt_corners.device.type == "cpu":
        return max_corner_confidence_reference(gt_corners, valid, pred_corners,
                                               **kw)
    if gt_corners.device.type != "cuda":
        raise ValueError(f"no max_corner_confidence kernel for device "
                         f"{gt_corners.device}")
    _check_args(gt_corners, valid, pred_corners)
    B, G, K2 = gt_corners.shape
    S = pred_corners.shape[1]
    if K2 != 2 * _KERNEL_K:
        raise ValueError(f"the CUDA kernel takes {_KERNEL_K} keypoints "
                         f"(2K = {2 * _KERNEL_K}), got 2K = {K2}")
    for name, t in (("gt_corners", gt_corners), ("pred_corners", pred_corners)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    valid_b = valid if valid.dtype == torch.bool else valid != 0
    valid_b = valid_b.contiguous()
    out = torch.empty((B, S), dtype=torch.float32, device=gt_corners.device)
    lib = _library()
    with torch.cuda.device(gt_corners.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.max_corner_confidence_launch(
            gt_corners.data_ptr(), valid_b.data_ptr(), pred_corners.data_ptr(),
            out.data_ptr(), B, G, S, K2 // 2, th, sharpness, im_width,
            im_height, confidence_denominator(sharpness), stream)
    if err != 0:
        raise RuntimeError(f"max_corner_confidence kernel launch failed: "
                           f"CUDA error {err}")
    max_corner_confidence.launches += 1
    return out


max_corner_confidence.launches = 0
