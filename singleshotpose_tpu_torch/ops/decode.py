"""Grid decode and single-object box pick, on the tensors' device.

Mirrors the single-object half of ``singleshotpose_tpu/ops/decode.py``
(``split_activate``, ``decode_grid``, ``best_boxes``).  The head is NHWC
(B, H, W, nA·(2K+1+C)) with the anchor index major in the channel dim, and
the flattened cell index is anchor-major, ``s = a·H·W + cy·W + cx``, so the
first-max argmax picks the cell the reference's scan would.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["DecodedGrid", "split_activate", "decode_grid", "best_boxes"]


def split_activate(output: torch.Tensor, num_keypoints: int, num_classes: int,
                   num_anchors: int):
    """NHWC head → anchor-major cells; sigmoid on the centroid keypoint (k=0)
    and the objectness, raw offsets for the other keypoints.

    Returns (xs, ys, conf, cls_logits, grid_x, grid_y): xs/ys (B, S, K)
    in-cell offsets, conf (B, S), cls_logits (B, S, C), grid_x/grid_y (S,).
    """
    B, H, W, D = output.shape
    K, C, nA = num_keypoints, num_classes, num_anchors
    E = 2 * K + 1 + C
    if D != nA * E:
        raise ValueError(f"head depth {D} != nA·(2K+1+C) = {nA}·{E}")
    out = output.reshape(B, H, W, nA, E).permute(0, 3, 1, 2, 4) \
        .reshape(B, nA * H * W, E)

    kp = out[..., :2 * K].reshape(B, nA * H * W, K, 2)
    kp = torch.cat([torch.sigmoid(kp[..., 0:1, :]), kp[..., 1:, :]], dim=-2)
    xs, ys = kp[..., 0], kp[..., 1]
    conf = torch.sigmoid(out[..., 2 * K])
    cls_logits = out[..., 2 * K + 1:]

    gx = torch.arange(W, dtype=output.dtype, device=output.device)
    gy = torch.arange(H, dtype=output.dtype, device=output.device)
    grid_x = gx.repeat(H).repeat(nA)
    grid_y = gy.repeat_interleave(W).repeat(nA)
    return xs, ys, conf, cls_logits, grid_x, grid_y


class DecodedGrid(NamedTuple):
    """Per-cell decoded predictions; S = nA·H·W, anchor-major."""
    corners: torch.Tensor    # (B, S, 2K) normalized to [0, 1] grid fractions
    det_conf: torch.Tensor   # (B, S) sigmoid objectness
    cls_probs: torch.Tensor  # (B, S, C) softmax class distribution


def decode_grid(output: torch.Tensor, num_keypoints: int, num_classes: int,
                num_anchors: int) -> DecodedGrid:
    """Decode the raw head: activations as :func:`split_activate`, plus the
    cell's grid coordinate, normalized by the grid's W and H; softmax over
    classes."""
    B, H, W, _ = output.shape
    K, C, nA = num_keypoints, num_classes, num_anchors
    xs, ys, det_conf, cls_logits, grid_x, grid_y = split_activate(
        output, K, C, nA)
    px = (xs + grid_x[None, :, None]) / W
    py = (ys + grid_y[None, :, None]) / H
    corners = torch.stack([px, py], dim=-1).reshape(B, nA * H * W, 2 * K)
    cls_probs = torch.softmax(cls_logits, dim=-1) if C > 0 else \
        torch.ones((B, nA * H * W, 0), dtype=output.dtype, device=output.device)
    return DecodedGrid(corners, det_conf, cls_probs)


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Gather one cell per image: (B, S, ...) → (B, ...) at idx (B,)."""
    return a[torch.arange(a.shape[0], device=a.device), idx]


def best_boxes(decoded: DecodedGrid, only_objectness: bool = True) -> torch.Tensor:
    """Single-object selection: per image, the max-confidence cell (the first
    one on a tie).  Returns (B, 2K+3): [2K normalized coords, det_conf,
    cls_max_conf, cls_id] — the reference's box layout."""
    corners, det_conf, cls_probs = decoded
    C = cls_probs.shape[-1]
    if C > 0:
        cls_max = cls_probs.amax(dim=-1)
        cls_id = torch.argmax(cls_probs, dim=-1)
    else:
        cls_max = torch.ones_like(det_conf)
        cls_id = torch.zeros(det_conf.shape, dtype=torch.long,
                             device=det_conf.device)
    score = det_conf if only_objectness else det_conf * cls_max
    idx = torch.argmax(score, dim=-1)
    return torch.cat([
        _take(corners, idx),
        _take(det_conf, idx)[:, None],
        _take(cls_max, idx)[:, None],
        _take(cls_id, idx).to(corners.dtype)[:, None],
    ], dim=-1)
