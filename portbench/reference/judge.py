"""The comparisons that decide ``correct``: the program's answers, judged by
the plain reference's own numbers.

Serving: each box the program returned is located on the reference's
decoded grid (the cell whose reference keypoints lie nearest its own), and
these numbers are taken over every box compared:

  * ``pick_gap``: how far that cell falls short of being the pick the rule
    makes on the reference's values.  For the best box, the reference's
    highest objectness less the cell's.  For a class pick, the smaller of
    two readings: as a kept cell, how far it misses being kept (its
    objectness times top class prob under the threshold, its class prob
    under the top one) plus how far a kept cell beats its objectness, each
    such lead capped by that cell's own margin of being kept (a cell a
    rounding can drop beats nothing by more than that); as the fallback
    fold's end, how far the keep set is from empty (its largest margin)
    plus how far a later cell beats it in both objectness and class prob
    (the fold ends at a cell no later cell beats in both);
  * ``box_err_px``: the widest keypoint gap to the reference's keypoints at
    that cell, in pixels of the served frame;
  * ``box_err_mean_px``: the mean over the boxes of that keypoint gap;
  * ``conf_err``: the widest gap of the objectness and class confidence to
    the reference's at that cell (a wrong class id counts 1);
  * ``pick_gap_mean``: the mean ``pick_gap`` over the picks.  A rounding
    moves a pick only between near-tied cells, and then by no more than
    the tie, so the mean grows with the square of the confidences' error
    (how often a pick moves, times how far); a fold that returns another
    kept cell than the rule's moves most picks, each by a wide gap.

``judge_serve`` returns a batch's widest gaps and, for the means, the sums
and the count of picks; the runner adds them up.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def _cells(boxes: np.ndarray, corners: np.ndarray) -> np.ndarray:
    """For each box (B, N, 2K+3), the cell (B, N) whose keypoints
    (corners (B, S, 2K)) lie nearest its own (largest coordinate gap)."""
    K2 = corners.shape[-1]
    d = np.abs(boxes[:, :, None, :K2] - corners[:, None, :, :]).max(-1)
    return d.argmin(-1)


def judge_serve(boxes: np.ndarray, corners, det, probs, pick: Sequence,
                size: int) -> Dict[str, float]:
    """``boxes``: the program's answers for one batch, (B, 2K+3) for
    ``("best",)`` or (B, C, 2K+3) for ``("per_class", th)``; ``corners``,
    ``det``, ``probs``: the reference's decoded grid of the same frames."""
    corners, det, probs = (t.double().cpu().numpy()
                           for t in (corners, det, probs))
    boxes = np.asarray(boxes, np.float64)
    if boxes.ndim == 2:
        boxes = boxes[:, None]
    B, N, _ = boxes.shape
    S, C = det.shape[1], probs.shape[-1]
    K2 = corners.shape[-1]
    cell = _cells(boxes, corners)                                   # (B, N)
    b = np.arange(B)[:, None]
    det_p = det[b, cell]
    cmax = probs.max(-1) if C else np.ones_like(det)
    cid = probs.argmax(-1) if C else np.zeros(det.shape, np.int64)
    if pick[0] == "best":
        gap = det.max(1)[:, None] - det_p
        cls_conf = np.abs(boxes[..., K2 + 1] - cmax[b, cell])
        prog_id = boxes[..., K2 + 2].astype(np.int64)
        if C:
            wrong = np.clip(prog_id, 0, C - 1) != prog_id
            short = cmax[b, cell] - probs[b, cell, np.clip(prog_id, 0, C - 1)]
            id_err = np.where(wrong, 1.0, short)
        else:
            id_err = (prog_id != 0).astype(np.float64)
    else:
        th = float(pick[1])
        c = np.arange(N)[None, :]
        conf = det * cmax
        keep = (conf > th)[:, None, :] & (cid[:, None, :] == c[..., None])
        p_c = probs.transpose(0, 2, 1)                              # (B, C, S)
        second = np.sort(probs, -1)[..., -2] if C > 1 else np.zeros_like(det)
        # how far each kept cell is from dropping out of the keep set
        margin = np.where(keep, np.minimum(conf[:, None, :] - th,
                                           p_c - second[:, None, :]), -np.inf)
        p_at = p_c[b, c, cell]
        miss = np.maximum(0.0, th - conf[b, cell]) \
            + np.maximum(0.0, cmax[b, cell] - p_at)
        beaten = np.maximum(0.0, np.minimum(det[:, None, :] - det_p[..., None],
                                            margin).max(-1))
        later = np.arange(S)[None, None, :] > cell[..., None]
        beat = np.minimum(det[:, None, :] - det_p[..., None],
                          p_c - p_at[..., None])
        not_end = np.maximum(0.0, np.where(later, beat, -np.inf).max(-1))
        # read as a kept cell, or as the fallback fold's end with the keep
        # set (nearly) empty: the gap is the smaller of the two readings
        gap = np.minimum(miss + beaten,
                         np.maximum(0.0, margin.max(-1)) + not_end)
        cls_conf = np.minimum(np.abs(boxes[..., K2 + 1] - cmax[b, cell]),
                              np.abs(boxes[..., K2 + 1] - p_at))
        id_err = (boxes[..., K2 + 2] != c).astype(np.float64)
    box = np.abs(boxes[..., :K2] - corners[b, cell]).max(-1) * size
    conf_err = np.maximum(np.maximum(np.abs(boxes[..., K2] - det_p),
                                     cls_conf), id_err)
    return {"pick_gap": float(np.max(gap)),
            "box_err_px": float(np.max(box)),
            "conf_err": float(np.max(conf_err)),
            "sums": {"box_err_mean_px": float(np.sum(box)),
                     "pick_gap_mean": float(np.sum(gap))},
            "picks": int(box.size)}
