"""Geometry primitives the port's evaluation uses: camera intrinsics, 3D
bbox corners, object diameter.

The port's own copy of the functions of ``singleshotpose_tpu/utils/geometry.py``
that ``evaluate.py`` calls (numpy only), so the port imports nothing of the
JAX package; ``tests/test_torch_host.py`` holds them equal to the originals.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_camera_intrinsic", "get_3D_corners", "calc_pts_diameter"]


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
