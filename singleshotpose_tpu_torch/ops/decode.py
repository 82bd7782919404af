"""Grid decode and box picks, on the tensors' device.

Mirrors ``singleshotpose_tpu/ops/decode.py``: ``split_activate``,
``decode_grid``, the single-object ``best_boxes``, the multi-object class
picks ``best_box_for_class`` and ``best_boxes_per_class``, and the host-side
toolkit (``bbox_iou``, ``bbox_ious``, ``nms``, ``multi_region_boxes_np``).
The head is NHWC (B, H, W, nA·(2K+1+C)) with the anchor index major in the
channel dim, and the flattened cell index is anchor-major,
``s = a·H·W + cy·W + cx``, so the first-max argmax picks the cell the
reference's scan would.

The class picks' fallback is the reference's order-dependent fold (a cell is
adopted only when its ``det_conf`` and its class prob both strictly beat the
last adopted cell's), computed here in parallel and exactly: from an adopted
cell ``i`` the next one adopted is the first later cell that beats it in
both, so the fold's result is the end of that chain, reached by pointer
doubling (:func:`_fallback_fold`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils import _pytree

__all__ = ["DecodedGrid", "split_activate", "decode_grid", "decode_heads",
           "best_boxes",
           "best_box_for_class", "best_boxes_per_class",
           "multi_region_boxes_np", "bbox_iou", "bbox_ious", "nms"]


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


# a serving artifact of the grid pick returns a DecodedGrid: its tree spec is
# saved by this name (``serving.save_exported``)
_pytree._register_namedtuple(
    DecodedGrid,
    serialized_type_name="singleshotpose_tpu_torch.ops.decode.DecodedGrid")


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


def decode_heads(heads, num_keypoints: int, num_classes: int,
                 num_anchors: int) -> DecodedGrid:
    """Decode a net's several NHWC heads (a YOLOv3-style net's, one a
    ``[yolo]`` block) into one grid: each head as :func:`decode_grid`,
    normalized by its own H and W, and their cells in order, head by head
    in cfg order (anchor-major within a head), so that one flat S runs
    over all of them and the first-max picks stay defined."""
    grids = [decode_grid(h, num_keypoints, num_classes, num_anchors)
             for h in heads]
    return DecodedGrid(*(torch.cat(parts, dim=1) for parts in zip(*grids)))


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


# booleans of one image's (classes, S, S) comparison block of the fallback
# fold: a block of classes set by S alone, so that an export with a symbolic
# batch has no guard on it (5 classes at 416², where a (B, 5, S, S) block at
# the multi serve's batch 16 is the 57 MB it was when the block was cut from
# B·S² booleans)
_FOLD_BLOCK = 1 << 22


def _first_true(mask: torch.Tensor):
    """(any True, the index of the first True — 0 where there is none)
    along the last dim, from one pass over ``mask``."""
    hit, first = mask.to(torch.uint8).max(dim=-1)
    return hit.bool(), first


def _fallback_fold(det_conf: torch.Tensor, probs: torch.Tensor):
    """The reference's sequential joint-maximum fold, exactly, in parallel.

    ``det_conf`` (B, S), ``probs`` (B, N, S): for each (b, n) the fold over
    cells s = 0..S-1 that starts from (−inf, −inf, 0) and adopts a cell when
    its det_conf AND its prob strictly exceed the last adopted cell's
    (``singleshotpose_tpu/ops/decode.py:155-168``).  The first cell adopted
    is the first with both values above −inf; from an adopted cell ``i`` the
    next is the first ``j > i`` with ``d_j > d_i`` and ``p_j > p_i`` (or
    none).  ``nxt`` maps each cell to that successor (itself where there is
    none); ⌈log2 S⌉ squarings ``nxt = nxt[nxt]`` take every cell to the end
    of its chain.  The (S, S) comparisons run in blocks of classes, the same
    for every batch size.

    Returns (idx (B, N) int64, det (B, N), prob (B, N)): the last adopted
    cell and its two values; (0, −inf, −inf) where no cell is adopted.
    """
    _, N, S = probs.shape
    ar = torch.arange(S, device=det_conf.device)
    # [b, i, j]: j comes after i and beats it in det_conf
    d_beats = (det_conf[:, None, :] > det_conf[:, :, None]) & \
        (ar[None, :] > ar[:, None])
    doublings = (S - 1).bit_length()
    live = (det_conf > float("-inf"))[:, None, :] & (probs > float("-inf"))
    adopted, start = _first_true(live)                            # (B, N)
    ends = []
    block = max(1, _FOLD_BLOCK // max(S * S, 1))
    for n0 in range(0, N, block):
        p = probs[:, n0:n0 + block]                               # (B, n, S)
        beats = d_beats[:, None] & (p[:, :, None, :] > p[:, :, :, None])
        any_beats, first = _first_true(beats)                     # (B, n, S)
        nxt = torch.where(any_beats, first, ar)
        for _ in range(doublings):
            nxt = nxt.gather(-1, nxt)
        ends.append(nxt.gather(-1, start[:, n0:n0 + block, None])[..., 0])
    end = torch.cat(ends, dim=1)                                  # (B, N)
    ninf = torch.full((), float("-inf"), dtype=probs.dtype,
                      device=probs.device)
    det = torch.where(adopted, det_conf.gather(1, end), ninf)
    prob = torch.where(adopted, probs.gather(-1, end[..., None])[..., 0], ninf)
    return torch.where(adopted, end, 0), det, prob


def _class_picks(decoded: DecodedGrid, classes: torch.Tensor,
                 conf_thresh: float) -> torch.Tensor:
    """Multi-object selection for the requested classes ``classes`` (B, N).

    For each (b, n): among cells with ``det_conf · cls_max`` above
    ``conf_thresh`` whose argmax class is ``classes[b, n]``, the highest
    ``det_conf`` (the first on a tie); where none survive, the reference's
    sequential joint-maximum fold (:func:`_fallback_fold`) over ``det_conf``
    and the prob of that class (``utils_multi.py:312-370``,
    ``valid_multi.py:118-123``).  Column 2K+1 is the kept cell's max class
    prob, or on the fallback the requested class's prob.

    The fold runs for every (image, class), whether or not a cell was kept:
    choosing on ``any_keep`` would wait on the card for it (PERF.md §7).
    """
    corners, det_conf, cls_probs = decoded
    B, S = det_conf.shape
    cls_max = cls_probs.amax(dim=-1)
    cls_id = torch.argmax(cls_probs, dim=-1)
    conf = det_conf * cls_max

    keep = (conf > conf_thresh)[:, None, :] & \
        (cls_id[:, None, :] == classes[:, :, None])               # (B, N, S)
    any_keep = keep.any(dim=-1)
    kept_idx = torch.argmax(
        torch.where(keep, det_conf[:, None, :], float("-inf")), dim=-1)
    cls_p = cls_probs.transpose(1, 2).gather(
        1, classes[:, :, None].expand(-1, -1, S))                 # (B, N, S)
    fb_idx, fb_det, fb_cls = _fallback_fold(det_conf, cls_p)

    idx = torch.where(any_keep, kept_idx, fb_idx)                 # (B, N)
    bidx = torch.arange(B, device=det_conf.device)[:, None]
    out_det = torch.where(any_keep, det_conf[bidx, idx], fb_det)
    out_clsconf = torch.where(any_keep, cls_max[bidx, idx], fb_cls)
    return torch.cat([corners[bidx, idx], out_det[..., None],
                      out_clsconf[..., None],
                      classes.to(corners.dtype)[..., None]], dim=-1)


def best_box_for_class(decoded: DecodedGrid, cls,
                       conf_thresh: float) -> torch.Tensor:
    """The box of one requested class an image, (B, 2K+3), as
    :func:`_class_picks` picks it; ``cls`` may be a scalar or a (B,)
    per-image class."""
    B = decoded.det_conf.shape[0]
    cls = torch.broadcast_to(torch.as_tensor(
        cls, dtype=torch.int64, device=decoded.det_conf.device), (B,))
    return _class_picks(decoded, cls[:, None], conf_thresh)[:, 0]


def best_boxes_per_class(decoded: DecodedGrid,
                         conf_thresh: float) -> torch.Tensor:
    """Class-picked boxes for every class at once: (B, C, 2K+3), so
    multi-GT eval can pair each ground truth with the box of its own class
    (``valid_multi.py:118-123`` matches ``boxes[j][2K+2] == truths[k][0]``
    per GT)."""
    B, _, C = decoded.cls_probs.shape
    classes = torch.arange(C, device=decoded.det_conf.device)
    return _class_picks(decoded, classes.expand(B, C), conf_thresh)


def bbox_iou(box1, box2, x1y1x2y2: bool = False) -> float:
    """IoU of two boxes, center (cx,cy,w,h) or corner form — the union-box
    formulation of the reference (``utils_multi.py:125-156``): the
    intersection is derived as w1+w2−union_w (negative ⇒ disjoint ⇒ 0)."""
    if x1y1x2y2:
        mx, Mx = min(box1[0], box2[0]), max(box1[2], box2[2])
        my, My = min(box1[1], box2[1]), max(box1[3], box2[3])
        w1, h1 = box1[2] - box1[0], box1[3] - box1[1]
        w2, h2 = box2[2] - box2[0], box2[3] - box2[1]
    else:
        mx = min(box1[0] - box1[2] / 2.0, box2[0] - box2[2] / 2.0)
        Mx = max(box1[0] + box1[2] / 2.0, box2[0] + box2[2] / 2.0)
        my = min(box1[1] - box1[3] / 2.0, box2[1] - box2[3] / 2.0)
        My = max(box1[1] + box1[3] / 2.0, box2[1] + box2[3] / 2.0)
        w1, h1, w2, h2 = box1[2], box1[3], box2[2], box2[3]
    cw = w1 + w2 - (Mx - mx)
    ch = h1 + h2 - (My - my)
    if cw <= 0 or ch <= 0:
        return 0.0
    carea = cw * ch
    return carea / (w1 * h1 + w2 * h2 - carea)


def bbox_ious(boxes1: torch.Tensor, boxes2: torch.Tensor,
              x1y1x2y2: bool = False) -> torch.Tensor:
    """Vectorized pairwise IoU: (..., 4) × (..., 4) broadcastable → (...)."""
    if x1y1x2y2:
        x11, y11, x12, y12 = (boxes1[..., i] for i in range(4))
        x21, y21, x22, y22 = (boxes2[..., i] for i in range(4))
        w1, h1 = x12 - x11, y12 - y11
        w2, h2 = x22 - x21, y22 - y21
    else:
        w1, h1 = boxes1[..., 2], boxes1[..., 3]
        w2, h2 = boxes2[..., 2], boxes2[..., 3]
        x11, y11 = boxes1[..., 0] - w1 / 2, boxes1[..., 1] - h1 / 2
        x12, y12 = boxes1[..., 0] + w1 / 2, boxes1[..., 1] + h1 / 2
        x21, y21 = boxes2[..., 0] - w2 / 2, boxes2[..., 1] - h2 / 2
        x22, y22 = boxes2[..., 0] + w2 / 2, boxes2[..., 1] + h2 / 2
    uw = torch.maximum(x12, x22) - torch.minimum(x11, x21)
    uh = torch.maximum(y12, y22) - torch.minimum(y11, y21)
    cw = w1 + w2 - uw
    ch = h1 + h2 - uh
    carea = torch.where((cw > 0) & (ch > 0), cw * ch, 0.0)
    return carea / torch.clamp_min(w1 * h1 + w2 * h2 - carea, 1e-12)


def nms(boxes, nms_thresh: float):
    """Greedy NMS over box lists (reference: ``utils_multi.py:223-241``).

    ``boxes``: sequence of arrays whose [0:4] is a center-form bbox and [4]
    the detection confidence; sorted descending by conf, suppressing any
    later box with IoU > thresh.  For toolkit parity: the eval path uses the
    class picks instead (``valid_multi.py:118``).
    """
    if len(boxes) == 0:
        return boxes
    boxes = [np.array(b, dtype=np.float32).copy() for b in boxes]
    order = np.argsort([-b[4] for b in boxes], kind="stable")
    out = []
    for oi, i in enumerate(order):
        bi = boxes[i]
        if bi[4] > 0:
            out.append(bi)
            for j in order[oi + 1:]:
                if bbox_iou(bi, boxes[j]) > nms_thresh:
                    boxes[j][4] = 0
    return out


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def multi_region_boxes_np(decoded: DecodedGrid, conf_thresh: float,
                          correspondingclass: int, only_objectness: bool = True):
    """Host-side full box list per image (toolkit parity with
    ``get_multi_region_boxes``): all cells above threshold, plus the fallback
    box when the requested class is missing.  Returns a list (len B) of
    [ (2K+3,) float arrays ].
    """
    corners = _host(decoded.corners)
    det = _host(decoded.det_conf)
    cls_probs = _host(decoded.cls_probs)
    B, S, _ = corners.shape
    cls_max = cls_probs.max(-1)
    cls_id = cls_probs.argmax(-1)
    conf = det if only_objectness else det * cls_max
    all_boxes = []
    for b in range(B):
        keep = np.nonzero(conf[b] > conf_thresh)[0]
        boxes = [np.concatenate([corners[b, s], [det[b, s], cls_max[b, s], cls_id[b, s]]])
                 for s in keep]
        if not boxes or not np.any(cls_id[b, keep] == correspondingclass):
            best_det, best_cls, best_ind = -np.inf, -np.inf, 0
            for s in range(S):
                if det[b, s] > best_det and cls_probs[b, s, correspondingclass] > best_cls:
                    best_det, best_cls, best_ind = det[b, s], cls_probs[b, s, correspondingclass], s
            boxes.append(np.concatenate([
                corners[b, best_ind], [best_det, best_cls, float(correspondingclass)]]))
        all_boxes.append(boxes)
    return all_boxes
