"""Evaluation: the reference's 6D pose metrics, batched.

Mirrors ``singleshotpose_tpu/evaluate.py`` (``EvalContext``, ``PoseErrors``,
``pose_metrics``, ``accuracy_summary``; for OCCLUSION ``truths_length``,
``gt_corner_boxes``, the GT corner permutation and
``multi_accuracy_table``).  The ground-truth and predicted
poses come from one batched PnP solve on the requested device; the error
families are numpy, with the helpers of ``utils/geometry.py``:

  * 2D reprojection: mean pixel distance of all mesh vertices under the two
    poses; accuracy = share of frames ≤ 5 px,
  * ADD: mean 3D vertex distance; accuracy = share ≤ 0.1·diameter,
  * 5 cm 5°: translation error ≤ 0.05 m and geodesic angle ≤ 5°,
  * corner: mean 2D distance of the 9 keypoints (≤ 5 px),

with the reference's ``count·100/(n + 1e-5)`` accuracy convention.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from .config import DataConfig
from .ops.pnp import pnp_batched
from .utils.geometry import (adi, calc_pts_diameter, fix_corner_order,
                             get_3D_corners, get_camera_intrinsic)
from .utils.meshply import MeshPly

__all__ = ["EvalContext", "PoseErrors", "pose_metrics", "accuracy_summary",
           "truths_length", "gt_corner_boxes", "box3d_iou",
           "multi_accuracy_table"]

EPS = 1e-5
PX_THRESHOLD = 5.0


@dataclasses.dataclass
class EvalContext:
    """Per-object evaluation constants (mesh, intrinsics, diameter)."""
    points_3d: np.ndarray     # (9, 3): centroid + 8 bbox corners
    vertices: np.ndarray      # (4, N) homogeneous mesh vertices
    intrinsics: np.ndarray    # (3, 3)
    diam: float
    im_width: int
    im_height: int

    @classmethod
    def from_data_config(cls, dcfg: DataConfig) -> "EvalContext":
        """Read the mesh of a ``.data`` config.  The diameter is recomputed
        from the mesh vertices, as the reference does."""
        verts = np.asarray(MeshPly(dcfg.mesh).vertices, np.float32)
        vertices = np.concatenate(
            [verts, np.ones((len(verts), 1), np.float32)], axis=1).T
        corners3d = get_3D_corners(vertices)
        pts3d = np.concatenate(
            [np.zeros((3, 1), np.float32), corners3d[:3, :]], axis=1).T
        K = get_camera_intrinsic(dcfg.u0, dcfg.v0, dcfg.fx, dcfg.fy)
        return cls(pts3d.astype(np.float32), vertices.astype(np.float32),
                   K.astype(np.float32), float(calc_pts_diameter(verts)),
                   dcfg.width, dcfg.height)


class PoseErrors:
    """Accumulates per-frame error families across eval batches."""

    def __init__(self):
        self.errs_2d: List[float] = []
        self.errs_3d: List[float] = []
        self.errs_trans: List[float] = []
        self.errs_angle: List[float] = []
        self.errs_corner2d: List[float] = []

    def extend(self, other: Dict[str, np.ndarray]):
        self.errs_2d.extend(np.atleast_1d(other["err_2d"]).tolist())
        self.errs_3d.extend(np.atleast_1d(other["err_3d"]).tolist())
        self.errs_trans.extend(np.atleast_1d(other["err_trans"]).tolist())
        self.errs_angle.extend(np.atleast_1d(other["err_angle"]).tolist())
        self.errs_corner2d.extend(
            np.atleast_1d(other["err_corner2d"]).tolist())

    def __len__(self):
        return len(self.errs_2d)


def truths_length(truths: np.ndarray, max_num_gt: int = 50) -> int:
    """Number of GT slots before the first empty one (x0 == 0)."""
    t = truths.reshape(max_num_gt, -1)
    empty = np.nonzero(t[:, 1] == 0)[0]
    return int(empty[0]) if empty.size else max_num_gt


def gt_corner_boxes(target_row: np.ndarray, num_keypoints: int = 9,
                    max_num_gt: int = 50) -> np.ndarray:
    """Extract (nGT, 2K) normalized GT keypoints from a padded label row."""
    K = num_keypoints
    t = target_row.reshape(max_num_gt, -1)
    n = truths_length(target_row, max_num_gt)
    return t[:n, 1:2 * K + 1]


def pose_metrics(corners2d_gt: np.ndarray, corners2d_pr: np.ndarray,
                 ctx: EvalContext, *, pnp_iters: int = 15,
                 fix_gt_corners: bool = False, symmetric: bool = False,
                 device="cpu") -> Dict[str, np.ndarray]:
    """Batched metrics for (B, 9, 2) pixel-space keypoints.  The ground-truth
    and predicted poses come from one 2B-frame PnP solve on ``device``; the
    five error families follow ``valid.py:137-177`` of the reference.
    ``fix_gt_corners`` applies the OCCLUSION GT corner permutation
    (``valid_multi.py:132``).  ``symmetric=True`` scores the 3D error as
    ADD-S (each GT-posed vertex to its nearest predicted one, :func:`adi`
    on ``device``) instead of the index-matched ADD: the protocol for
    symmetric objects (eggbox, glue), opt-in as in the JAX package."""
    B = corners2d_gt.shape[0]
    gt = np.asarray(corners2d_gt, np.float32)
    pr = np.asarray(corners2d_pr, np.float32)
    if fix_gt_corners:
        gt = np.stack([fix_corner_order(g) for g in gt])
    err_corner = np.linalg.norm(gt - pr, axis=2).mean(axis=1)

    stacked = torch.from_numpy(np.concatenate([gt, pr], axis=0)).to(device)
    R, t = pnp_batched(ctx.points_3d, stacked, ctx.intrinsics,
                       iters=pnp_iters)
    R, t = R.cpu().numpy(), t.cpu().numpy()
    R_gt, R_pr = R[:B], R[B:]
    t_gt, t_pr = t[:B], t[B:]

    err_trans = np.linalg.norm(t_gt - t_pr, axis=1)
    trace = np.einsum("bij,bij->b", R_gt, R_pr)       # tr(Rg Rpᵀ)
    err_angle = np.degrees(np.arccos(np.clip((trace - 1.0) / 2.0, -1.0, 1.0)))

    Rt_gt = np.concatenate([R_gt, t_gt[:, :, None]], axis=2)   # (B, 3, 4)
    Rt_pr = np.concatenate([R_pr, t_pr[:, :, None]], axis=2)
    cam_gt = np.einsum("bij,jn->bin", Rt_gt, ctx.vertices)     # (B, 3, N)
    cam_pr = np.einsum("bij,jn->bin", Rt_pr, ctx.vertices)

    def proj(cam):
        pix = np.einsum("ij,bjn->bin", ctx.intrinsics, cam)
        return pix[:, :2] / pix[:, 2:3]

    err_2d = np.linalg.norm(proj(cam_gt) - proj(cam_pr), axis=1).mean(axis=1)
    if symmetric:
        err_3d = np.array([adi(cam_pr[b].T, cam_gt[b].T, device)
                           for b in range(B)], np.float32)
    else:
        err_3d = np.linalg.norm(cam_gt - cam_pr, axis=1).mean(axis=1)
    return {"err_2d": err_2d, "err_3d": err_3d, "err_trans": err_trans,
            "err_angle": err_angle, "err_corner2d": err_corner,
            "R_gt": R_gt, "R_pr": R_pr, "t_gt": t_gt, "t_pr": t_pr}


def accuracy_summary(errors: PoseErrors, diam: float,
                     px_threshold: float = PX_THRESHOLD) -> Dict[str, float]:
    """The reference's headline numbers (``valid.py:201-209``)."""
    e2d = np.asarray(errors.errs_2d)
    e3d = np.asarray(errors.errs_3d)
    et = np.asarray(errors.errs_trans)
    ea = np.asarray(errors.errs_angle)
    ec = np.asarray(errors.errs_corner2d)
    n = len(e2d)
    return {
        "acc_2d_proj": float((e2d <= px_threshold).sum() * 100.0 / (n + EPS)),
        "acc_add_0.1d": float((e3d <= diam * 0.1).sum() * 100.0 / (n + EPS)),
        "acc_5cm5deg": float(((et <= 0.05) & (ea <= 5)).sum() * 100.0
                             / (n + EPS)),
        "acc_corner_2d": float((ec <= px_threshold).sum() * 100.0 / (n + EPS)),
        "mean_err_2d": float(e2d.mean()) if n else float("nan"),
        "mean_err_3d": float(e3d.mean()) if n else float("nan"),
        "mean_corner_err_2d": float(ec.mean()) if n else float("nan"),
        "mean_err_trans": float(et.mean()) if n else float("nan"),
        "mean_err_angle": float(ea.mean()) if n else float("nan"),
        "n_samples": n,
    }


def box3d_iou(Rt_gt: np.ndarray, Rt_pr: np.ndarray,
              corners3d: np.ndarray, grid: int = 24) -> float:
    """IoU of the posed 3D bounding boxes (deterministic grid approximation).

    The BASELINE config sweep names "3D IoU" alongside 2D-projection and ADD;
    the reference repo itself never computes it, so this is a beyond-parity
    metric.  Exact oriented-box intersection is a convex-polytope problem;
    here a ``grid³`` lattice over the gt box is transformed into the pred
    box's frame and counted — deterministic, accurate to ~1/grid, and
    symmetric enough for thresholded accuracy use.  numpy, as
    ``singleshotpose_tpu/evaluate.py:232`` computes it.

    Args:
      Rt_gt / Rt_pr: (3,4) object→camera transforms.
      corners3d: (8,3) model-frame box corners (axis-aligned around origin).
    """
    lo = corners3d.min(axis=0)
    hi = corners3d.max(axis=0)
    ax = [np.linspace(l, h, grid, dtype=np.float32) for l, h in zip(lo, hi)]
    gx, gy, gz = np.meshgrid(*ax, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)    # gt-frame lattice

    # gt-frame point → camera → pred object frame
    cam = pts @ Rt_gt[:, :3].T + Rt_gt[:, 3]
    obj_pr = (cam - Rt_pr[:, 3]) @ Rt_pr[:, :3]             # R^T (x - t)
    eps = 1e-5 * (hi - lo)   # absorb f32 cancellation at the box boundary
    inside = np.all((obj_pr >= lo - eps) & (obj_pr <= hi + eps), axis=1)
    inter = inside.mean() * np.prod(hi - lo)
    union = 2.0 * np.prod(hi - lo) - inter
    return float(inter / union) if union > 0 else 0.0


def multi_accuracy_table(errs_2d: Sequence[float],
                         thresholds: Sequence[float] = tuple(range(5, 55, 5))
                         ) -> Dict[int, float]:
    """2D-reproj accuracy at 5..50 px (``valid_multi.py:153-158``)."""
    e = np.asarray(errs_2d)
    n = len(e)
    return {int(th): float((e <= th).sum() * 100.0 / (n + EPS))
            for th in thresholds}
