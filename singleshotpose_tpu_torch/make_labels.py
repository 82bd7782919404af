"""Label-file creation for custom datasets.

The reference only *documents* this workflow (``label_file_creation.md``:
get the model's 3D bbox, project centroid + 8 corners with the ground-truth
[R|t] and intrinsics, append the 2D extents); every user with a custom
object has to reimplement it. Here it is an actual tool:

    python -m singleshotpose_tpu_torch.cli make-labels --mesh obj.ply \
        --poses poses.npz --out labels/

``poses.npz`` holds ``R`` (M,3,3), ``t`` (M,3) object-to-camera transforms,
``K`` (3,3) intrinsics (or (M,3,3) per-frame), optional ``names`` (M image
stems) and optional ``width``/``height`` scalars. One ``<name>.txt`` per
frame is written in the exact 21-float format the readers expect
(``docs/labels.md``; reference readers ``utils.py:299-315``), so the output
drops straight into a ``labels/`` directory next to ``JPEGImages/``.

Corner ordering matches ``get_3D_corners`` (the reference's ``utils.py:
66-84`` sign pattern) — the same order every decoder, metric, and
``fix_corner_order`` in this framework assumes.

The port's own copy of ``singleshotpose_tpu/make_labels.py`` (numpy only),
its behaviour kept as written there; ``tests/test_torch_host_api.py`` holds
its rows and files to the original's.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from .utils.geometry import get_3D_corners, compute_projection
from .utils.meshply import MeshPly

__all__ = ["label_rows_for_poses", "write_label_files", "main"]


def label_rows_for_poses(vertices: np.ndarray, R: np.ndarray, t: np.ndarray,
                         K: np.ndarray, im_width: int, im_height: int,
                         class_id: int = 0) -> np.ndarray:
    """(M, 21) label rows for M ground-truth poses of one object.

    vertices: (N, 3) or (3, N) mesh vertices in the object frame (meters —
    the same convention as the LINEMOD .ply files read by ``MeshPly``).
    R: (M, 3, 3) rotations, t: (M, 3) translations (object → camera),
    K: (3, 3) shared or (M, 3, 3) per-frame intrinsics.

    Row layout (label_file_creation.md step 5): class, centroid x0 y0,
    corners x1 y1 … x8 y8 (normalized by image size), x-range, y-range —
    the ranges fitted tight to the 9 projected keypoints, which is what the
    reference does in practice (step 4: "we fit a tight bounding box to the
    8 corners of the projected 3D bounding box").
    """
    v = np.asarray(vertices, np.float64)
    if v.ndim != 2:
        raise ValueError(f"vertices must be 2-D, got {v.shape}")
    if v.shape[0] != 3:
        v = v.T
    if v.shape[0] != 3:
        raise ValueError(f"vertices must be (N,3) or (3,N), got {v.shape}")
    R = np.asarray(R, np.float64).reshape(-1, 3, 3)
    t = np.asarray(t, np.float64).reshape(-1, 3)
    if len(R) != len(t):
        raise ValueError(f"{len(R)} rotations vs {len(t)} translations")
    K = np.asarray(K, np.float64)
    Ks = np.broadcast_to(K, (len(R), 3, 3)) if K.ndim == 2 else K
    if len(Ks) != len(R):
        raise ValueError(f"{len(Ks)} intrinsics vs {len(R)} poses")

    corners = get_3D_corners(np.vstack([v, np.ones((1, v.shape[1]))]))
    # centroid first, then the 8 bbox corners — homogeneous (4, 9)
    pts = np.concatenate(
        [np.array([[0.0], [0.0], [0.0], [1.0]]), corners], axis=1)

    rows = np.empty((len(R), 21), np.float64)
    rows[:, 0] = class_id
    scale = np.array([im_width, im_height], np.float64)[:, None]
    for i in range(len(R)):
        Rt = np.concatenate([R[i], t[i][:, None]], axis=1)
        uv = compute_projection(pts, Rt, Ks[i]) / scale       # (2, 9)
        rows[i, 1:19] = uv.T.reshape(-1)
        rows[i, 19] = uv[0].max() - uv[0].min()
        rows[i, 20] = uv[1].max() - uv[1].min()
    return rows


def write_label_files(rows: np.ndarray, out_dir: str,
                      names: Optional[Sequence[str]] = None) -> list:
    """Write one ``<name>.txt`` per row; returns the paths written.

    Values are printed with the reference readers' full precision
    (``%.6f`` — the LINEMOD labels ship 6 decimals)."""
    os.makedirs(out_dir, exist_ok=True)
    if names is None:
        names = [f"{i:06d}" for i in range(len(rows))]
    if len(names) != len(rows):
        raise ValueError(f"{len(names)} names vs {len(rows)} rows")
    paths = []
    for name, row in zip(names, rows):
        path = os.path.join(out_dir, f"{os.path.splitext(name)[0]}.txt")
        with open(path, "w") as f:
            f.write(" ".join(f"{x:.6f}" for x in row) + "\n")
        paths.append(path)
    return paths


def main(argv: Sequence[str]) -> int:
    import argparse
    p = argparse.ArgumentParser(
        prog="singleshotpose_tpu_torch.cli make-labels",
        description="Create 21-float label files from a mesh + GT poses "
                    "(the reference's label_file_creation.md recipe as a "
                    "tool)")
    p.add_argument("--mesh", required=True, help=".ply object model")
    p.add_argument("--poses", required=True,
                   help=".npz with R (M,3,3), t (M,3), K (3,3) or (M,3,3); "
                        "optional names (M stems), width, height")
    p.add_argument("--out", required=True, help="output labels directory")
    p.add_argument("--class_id", type=int, default=0)
    p.add_argument("--width", type=int, default=None,
                   help="image width (default: npz width, else 640)")
    p.add_argument("--height", type=int, default=None,
                   help="image height (default: npz height, else 480)")
    args = p.parse_args(argv)

    mesh = MeshPly(args.mesh)
    vertices = np.array(mesh.vertices, np.float64)
    data = np.load(args.poses, allow_pickle=False)
    for key in ("R", "t", "K"):
        if key not in data:
            raise SystemExit(f"--poses is missing array {key!r}")
    width = args.width if args.width else (
        int(data["width"]) if "width" in data else 640)
    height = args.height if args.height else (
        int(data["height"]) if "height" in data else 480)
    names = [str(n) for n in data["names"]] if "names" in data else None
    rows = label_rows_for_poses(vertices, data["R"], data["t"], data["K"],
                                width, height, class_id=args.class_id)
    paths = write_label_files(rows, args.out, names)
    print(f"wrote {len(paths)} label files to {args.out} "
          f"({width}x{height}, class {args.class_id})")
    return 0
