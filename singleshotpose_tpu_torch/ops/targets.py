"""Vectorized target assignment (``build_targets``) on the tensors' device.

Mirrors ``singleshotpose_tpu/ops/targets.py``: the same fixed 50-slot padded
target tensor, the same semantics —

  * "break at the first empty slot": a slot is live only if every slot up to
    it has a non-zero x0 (a cumulative product);
  * pass 1: ``conf_mask`` starts at ``noobject_scale`` and is zeroed where
    the max-over-GT corner confidence of the predictions exceeds
    ``sil_thresh`` (:func:`~.max_corner_confidence.max_corner_confidence`,
    the CUDA kernel on the card);
  * pass 2: the responsible cell is the centroid's cell (at the anchor of
    best IoU when nA > 1), with per-keypoint in-cell offsets and the
    rescoring confidence of the current prediction; when two GTs land in one
    cell the later slot wins;
  * centroid cells are clamped to the grid.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch

from .confidence import corner_confidences
from .max_corner_confidence import max_corner_confidence

__all__ = ["BuiltTargets", "build_targets"]


class BuiltTargets(NamedTuple):
    coord_mask: torch.Tensor   # (B, S) 1 at responsible cells
    conf_mask: torch.Tensor    # (B, S) noobject / 0 / object scale weights
    cls_mask: torch.Tensor     # (B, S) bool
    txs: torch.Tensor          # (B, S, K) in-cell x offsets
    tys: torch.Tensor          # (B, S, K)
    tconf: torch.Tensor        # (B, S) soft rescoring confidence targets
    tcls: torch.Tensor         # (B, S) int64 class targets
    num_gt: torch.Tensor       # scalar
    num_correct: torch.Tensor  # scalar: rescoring conf > 0.5


@functools.lru_cache(maxsize=None)
def _anchor_wh(anchors: Tuple[float, ...], nA: int, device: torch.device):
    """The anchors' (w, h) on ``device``, made once per (anchors, device): a
    pageable host-to-device copy on every step would wait for the stream.
    Never evicted: a captured train step's graphs read these tensors."""
    a = torch.tensor(anchors, dtype=torch.float32).reshape(nA, -1)[:, :2]
    return a[:, 0].to(device), a[:, 1].to(device)


def _best_anchor(t: torch.Tensor, nl: int, nA: int, nH: int, nW: int,
                 anchors: Tuple[float, ...]) -> torch.Tensor:
    """Per GT slot, the anchor whose origin-centred box has the highest IoU
    with the GT's extent (first anchor on ties): intersection = min(w)·min(h)
    (``singleshotpose_tpu/ops/targets.py:55-65``, ``:121-127``)."""
    aw, ah = _anchor_wh(tuple(anchors), nA, t.device)
    gw = t[:, :, nl - 2, None] * nW                                # (B, G, 1)
    gh = t[:, :, nl - 1, None] * nH
    iw, ih = torch.minimum(gw, aw), torch.minimum(gh, ah)          # (B, G, nA)
    inter = torch.where((iw > 0) & (ih > 0), iw * ih, 0.0)
    union = gw * gh + aw * ah - inter
    return torch.argmax(inter / torch.clamp_min(union, 1e-12), dim=-1)


def build_targets(pred_corners: torch.Tensor, target: torch.Tensor, *,
                  num_keypoints: int, num_anchors: int, nH: int, nW: int,
                  noobject_scale: float, object_scale: float,
                  sil_thresh: float, anchors: Tuple[float, ...] = (),
                  im_width: float = 640.0, im_height: float = 480.0,
                  max_num_gt: int = 50) -> BuiltTargets:
    """Args:
      pred_corners: (B, S, 2K) f32 normalized predicted keypoints (detached),
        S = nA·nH·nW anchor-major.
      target: (B, max_num_gt·(2K+3)) f32 padded labels.
    """
    K, nA, G = num_keypoints, num_anchors, max_num_gt
    S = nA * nH * nW
    B = target.shape[0]
    nl = 2 * K + 3
    dev = target.device
    t = target.reshape(B, G, nl)

    valid = torch.cumprod((t[:, :, 1] != 0).to(torch.int32), dim=1).bool()
    gt_corners = t[:, :, 1:2 * K + 1].contiguous()                # (B, G, 2K)

    # ---- pass 1: silence cells whose predictions already match some GT ----
    cur_confs = max_corner_confidence(gt_corners, valid, pred_corners,
                                      im_width=im_width, im_height=im_height)
    conf_mask0 = torch.where(cur_confs > sil_thresh, 0.0, noobject_scale)

    # ---- the responsible cell of each GT ----
    if nA > 1:
        best_n = _best_anchor(t, nl, nA, nH, nW, anchors)
    else:
        best_n = torch.zeros((B, G), dtype=torch.int64, device=dev)
    # truncation == floor for the clamped-positive centroid
    gi0 = torch.clamp((t[:, :, 1] * nW).to(torch.int64), 0, nW - 1)
    gj0 = torch.clamp((t[:, :, 2] * nH).to(torch.int64), 0, nH - 1)
    cell = best_n * (nH * nW) + gj0 * nW + gi0                     # (B, G)

    # rescoring confidence at the responsible cell, per GT
    pred_at_cell = torch.gather(pred_corners, 1,
                                cell[:, :, None].expand(B, G, 2 * K))
    gt_conf = corner_confidences(gt_corners, pred_at_cell,
                                 im_width=im_width, im_height=im_height)

    # per-keypoint in-cell offsets
    tx_vals = gt_corners[:, :, 0::2] * nW - gi0[:, :, None].to(torch.float32)
    ty_vals = gt_corners[:, :, 1::2] * nH - gj0[:, :, None].to(torch.float32)

    # ---- pass 2: last-writer-wins scatter, order-free ----
    # The winning slot of a cell is its valid slot of highest index: a
    # scatter-max of (slot + 1) picks it.  Every other slot writes to the
    # dummy column S, which is cropped off, so the writes that collide (and
    # whose order on the card is undefined) land only in that column.
    slot = torch.arange(1, G + 1, device=dev)[None, :]
    prio = torch.where(valid, slot, 0)                              # (B, G)
    winner = torch.zeros((B, S), dtype=prio.dtype, device=dev) \
        .scatter_reduce_(1, cell, prio, "amax")
    is_winner = valid & (prio == torch.gather(winner, 1, cell))
    idx = torch.where(is_winner, cell, S)

    def scatter(val: torch.Tensor, fill) -> torch.Tensor:
        full = torch.full((B, S + 1) + tuple(val.shape[2:]), fill,
                          dtype=val.dtype, device=dev)
        index = idx.reshape((B, G) + (1,) * (val.dim() - 2)).expand(val.shape)
        return full.scatter_(1, index, val)[:, :S]

    ones = torch.ones((B, G), dtype=torch.float32, device=dev)
    coord_mask = scatter(ones, 0.0)
    cls_mask = scatter(ones.bool(), False)
    conf_mask = torch.where(cls_mask, object_scale, conf_mask0)
    tconf = scatter(gt_conf, 0.0)
    tcls = scatter(t[:, :, 0].to(torch.int64), 0)
    txs = scatter(tx_vals, 0.0)
    tys = scatter(ty_vals, 0.0)

    num_gt = valid.sum()
    num_correct = (valid & (gt_conf > 0.5)).sum()
    return BuiltTargets(coord_mask, conf_mask, cls_mask, txs, tys, tconf,
                        tcls, num_gt, num_correct)
