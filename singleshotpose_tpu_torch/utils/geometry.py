"""Geometry and 6D-pose metric primitives: camera intrinsics, 3D bbox
corners, projection, angular distance, object diameter, ADD and ADD-S, the
OCCLUSION corner order and the 2D box helpers.

The port's own copy of ``singleshotpose_tpu/utils/geometry.py`` (numpy;
``adi`` in torch on a chosen device, so the card needs no scipy), so the
port imports nothing of the JAX package; ``tests/test_torch_host.py``,
``tests/test_torch_multi_host.py`` and ``tests/test_torch_host_api.py``
hold it equal to the original.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "get_2d_bb",
    "scale_bboxes",
    "get_camera_intrinsic",
    "get_3D_corners",
    "compute_projection",
    "compute_transformation",
    "calc_angular_distance",
    "calc_pts_diameter",
    "adi",
    "add_error",
    "fix_corner_order",
    "compute_2d_bb",
    "compute_2d_bb_from_orig_pix",
]


def get_camera_intrinsic(u0: float, v0: float, fx: float, fy: float) -> np.ndarray:
    """3×3 K matrix (reference: ``utils.py:37-38``)."""
    return np.array([[fx, 0.0, u0], [0.0, fy, v0], [0.0, 0.0, 1.0]])


def get_3D_corners(vertices: np.ndarray) -> np.ndarray:
    """Axis-aligned bbox corners of a (4×N or 3×N) vertex array, homogeneous 4×8.

    Corner ordering matches the reference exactly (``utils.py:66-84``):
    (min_x,min_y,min_z), (min_x,min_y,max_z), (min_x,max_y,min_z), ... —
    z fastest, then y, then x.
    """
    v = np.asarray(vertices)
    min_x, max_x = v[0, :].min(), v[0, :].max()
    min_y, max_y = v[1, :].min(), v[1, :].max()
    min_z, max_z = v[2, :].min(), v[2, :].max()
    corners = np.array([
        [min_x, min_y, min_z],
        [min_x, min_y, max_z],
        [min_x, max_y, min_z],
        [min_x, max_y, max_z],
        [max_x, min_y, min_z],
        [max_x, min_y, max_z],
        [max_x, max_y, min_z],
        [max_x, max_y, max_z],
    ])
    return np.concatenate((corners.T, np.ones((1, 8))), axis=0)


def compute_projection(points_3D, transformation, internal_calibration):
    """K [R|t] X with perspective divide → (2, N) (reference: ``utils.py:40-45``)."""
    cam = internal_calibration @ transformation @ points_3D
    return cam[:2] / cam[2:3]


def compute_transformation(points_3D, transformation):
    """[R|t] X (reference: ``utils.py:47-48``)."""
    return transformation @ points_3D


def calc_angular_distance(gt_rot, pr_rot):
    """Geodesic angle (degrees) between two rotations, or two stacks of
    them (reference: ``utils.py:31-35``); numpy."""
    rot_diff = gt_rot @ np.swapaxes(pr_rot, -1, -2)
    trace = np.trace(rot_diff) if rot_diff.ndim == 2 else \
        np.trace(rot_diff, axis1=-2, axis2=-1)
    cos = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
    return np.rad2deg(np.arccos(cos))


def calc_pts_diameter(pts: np.ndarray, chunk: int = 512) -> float:
    """Max pairwise vertex distance, O(n²) but blocked/vectorized (the
    reference loops per-point in Python, ``utils.py:50-58``)."""
    pts = np.asarray(pts, dtype=np.float64)
    n = pts.shape[0]
    diameter = -1.0
    for i in range(0, n, chunk):
        a = pts[i:i + chunk]
        # only need the upper triangle; compare block a against pts[i:]
        d2 = np.sum((a[:, None, :] - pts[None, i:, :]) ** 2, axis=-1)
        m = float(d2.max())
        if m > diameter:
            diameter = m
    return float(np.sqrt(diameter))


def add_error(pts: np.ndarray, Rt_gt: np.ndarray, Rt_pr: np.ndarray) -> float:
    """ADD metric: mean 3D vertex distance under the two poses.

    ``pts`` is homogeneous 4×N; Rt are 3×4."""
    a = Rt_gt @ pts
    b = Rt_pr @ pts
    return float(np.mean(np.linalg.norm(a - b, axis=0)))


_FIX_ORDER = np.array([0, 1, 3, 5, 7, 2, 4, 6, 8])


def fix_corner_order(corners2D_gt: np.ndarray) -> np.ndarray:
    """OCCLUSION GT corner permutation (reference: ``utils.py:197-208``)."""
    return np.asarray(corners2D_gt, dtype=np.float32)[_FIX_ORDER]


def compute_2d_bb(pts):
    """[cx, cy, w, h] of a (2,N) point set (reference: ``utils.py:120-131``)."""
    min_x, max_x = pts[0, :].min(), pts[0, :].max()
    min_y, max_y = pts[1, :].min(), pts[1, :].max()
    return [(max_x + min_x) / 2.0, (max_y + min_y) / 2.0, max_x - min_x, max_y - min_y]


def compute_2d_bb_from_orig_pix(pts, size):
    """Pixel-space points → grid-scaled [cx,cy,w,h] using the LINEMOD 640×480
    frame (reference: ``utils.py:133-144``)."""
    min_x = pts[0, :].min() / 640.0
    max_x = pts[0, :].max() / 640.0
    min_y = pts[1, :].min() / 480.0
    max_y = pts[1, :].max() / 480.0
    w, h = max_x - min_x, max_y - min_y
    cx, cy = (max_x + min_x) / 2.0, (max_y + min_y) / 2.0
    return [cx * size, cy * size, w * size, h * size]


def get_2d_bb(box, size):
    """[cx·size, cy·size, w·size, h·size] from a flat keypoint list whose
    first pair is the centroid (reference: ``utils.py:102-112``)."""
    pts = np.reshape(np.asarray(box, dtype=np.float64), [-1, 2])
    w = pts[:, 0].max() - pts[:, 0].min()
    h = pts[:, 1].max() - pts[:, 1].min()
    return [float(box[0]) * size, float(box[1]) * size, w * size, h * size]


def scale_bboxes(bboxes, width, height):
    """Scale normalized [x, y, w, h, ...] boxes to pixels
    (reference: ``utils.py:360-368``); input is not mutated."""
    out = [list(b) for b in bboxes]
    for b in out:
        b[0] *= width
        b[1] *= height
        b[2] *= width
        b[3] *= height
    return out


def adi(pts_est: np.ndarray, pts_gt: np.ndarray, device="cpu",
        chunk: int = 1024) -> float:
    """Symmetric-object error (reference ``utils.py:60-64``): the mean over
    ``pts_gt`` (N, 3) of the distance to the nearest point of ``pts_est``
    (M, 3).  The JAX package queries a scipy KD-tree; here f64 pairwise
    distances on ``device`` (exact differences, no matmul expansion), their
    row minima taken ``chunk`` query rows at a time."""
    est = torch.as_tensor(np.asarray(pts_est), dtype=torch.float64,
                          device=device)
    gt = torch.as_tensor(np.asarray(pts_gt), dtype=torch.float64,
                         device=device)
    nearest = torch.cat([
        torch.cdist(gt[i:i + chunk], est,
                    compute_mode="donot_use_mm_for_euclid_dist").amin(dim=1)
        for i in range(0, gt.shape[0], chunk)])
    return float(nearest.mean())
