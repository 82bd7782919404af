"""Distance → confidence function c(D) for keypoint rescoring.

Mirrors ``singleshotpose_tpu/ops/confidence.py``: per keypoint, the distance
between predicted and ground-truth projections in pixels of the original
image (640×480 by default), mapped through

    c(D) = (exp(sharpness · (1 − D/th)) − 1) / (exp(sharpness) − 1 + 1e-5)

where D < th (80 px, sharpness 2), else 0, and averaged over the keypoints.
It broadcasts over leading dims, so target assignment evaluates
(B, G, S) pairs at once.
"""

from __future__ import annotations

import functools

import torch

__all__ = ["corner_confidences", "confidence_denominator"]


@functools.lru_cache(maxsize=None)
def confidence_denominator(sharpness: float) -> float:
    """``exp(sharpness) − 1 + 1e-5`` evaluated in f32, as the JAX function
    evaluates it (``exp`` of an f32 scalar, then f32 arithmetic)."""
    e = torch.exp(torch.tensor(sharpness, dtype=torch.float32))
    return float(e - 1.0 + 1e-5)


def corner_confidences(gt_corners: torch.Tensor, pr_corners: torch.Tensor,
                       th: float = 80.0, sharpness: float = 2.0,
                       im_width: float = 640.0,
                       im_height: float = 480.0) -> torch.Tensor:
    """Mean keypoint confidence.

    Args:
      gt_corners: (..., 2K) normalized [x0, y0, x1, y1, ...] ground truth.
      pr_corners: (..., 2K) predictions, broadcastable against gt.

    Returns (...,), the mean confidence over the K keypoints.
    """
    diff = gt_corners - pr_corners
    dist = diff.reshape(diff.shape[:-1] + (diff.shape[-1] // 2, 2))
    dx = dist[..., 0] * im_width
    dy = dist[..., 1] * im_height
    d = torch.sqrt(dx * dx + dy * dy)
    conf = (torch.exp(sharpness * (1.0 - d / th)) - 1.0) \
        / confidence_denominator(sharpness)
    conf = torch.where(d < th, conf, 0.0)
    return conf.mean(dim=-1)
