"""Shaded synthetic LINEMOD generator: depth-buffered, face-colored,
Lambertian-lit box frames at known poses.

The port's own copy of ``singleshotpose_tpu/data/shaded.py`` (numpy only;
PIL is imported inside :func:`make_shaded_linemod`), so the port imports
nothing of the JAX package; ``tests/test_torch_shaded.py`` holds every
render equal to the original, bit for bit, at fixed seeds.

The reference's de-facto acceptance test is the 6D metric suite on real
LINEMOD (reference ``valid.py:203-209``), which cannot be downloaded here.
This renderer is the strongest accuracy stand-in available: the pose is NOT
painted into the image — the network must infer it from the projected box
geometry (silhouette, face visibility, shading), exactly the cue structure
of the real task.  Frames are rendered with a painter's/z-buffer hybrid
(far-to-near splat sort + per-splat depth test), per-face albedo, and a
per-frame light direction so every face's brightness varies with pose.

Used by ``scripts/shaded_accuracy.py`` (held-out-pose generalization: train
on one set of poses, evaluate on disjoint ones) and by ``chip_smoke.py``'s
device-data phase.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

__all__ = ["render_frame", "render_scene_multi", "make_shaded_linemod",
           "BOX_HALF_EXTENTS"]

# camera + label conventions shared with the LINEMOD fixtures
K = np.array([[572.4114, 0, 325.2611], [0, 573.5704, 242.0489],
              [0, 0, 1]], np.float32)
IM_W, IM_H = 640, 480
BOX_HALF_EXTENTS = (0.045, 0.035, 0.04)
# 9 keypoints: centroid + 8 box corners (label codec order, docs/labels.md)
_HX, _HY, _HZ = BOX_HALF_EXTENTS
PTS = np.array([[0, 0, 0]] + [[sx * _HX, sy * _HY, sz * _HZ]
                for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
               np.float32)
# outward unit normals per face id (0:+z 1:-z 2:+y 3:-y 4:+x 5:-x)
_NORMALS = np.array([[0, 0, 1], [0, 0, -1], [0, 1, 0],
                     [0, -1, 0], [1, 0, 0], [-1, 0, 0]], np.float32)


def _random_pose(rng: np.random.RandomState, tx: float = 0.0):
    w = rng.randn(3) * .5
    th = max(np.linalg.norm(w), 1e-6)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + np.sin(th) / th * Kx + \
        (1 - np.cos(th)) / th ** 2 * Kx @ Kx
    t = np.array([tx + rng.uniform(-.06, .06), rng.uniform(-.05, .05),
                  rng.uniform(.55, .8)])
    return R.astype(np.float32), t.astype(np.float32)


def _surface_points(rng: np.random.RandomState, n: int,
                    ext: Tuple[float, float, float] = BOX_HALF_EXTENTS):
    """n random points on the box surface; returns (n,3) points + face ids."""
    hx, hy, hz = ext
    u = rng.uniform(-1, 1, n).astype(np.float32)
    v = rng.uniform(-1, 1, n).astype(np.float32)
    face = rng.randint(0, 6, n)
    p = np.empty((n, 3), np.float32)
    zsel = face < 2
    p[zsel] = np.stack([u[zsel] * hx, v[zsel] * hy,
                        np.where(face[zsel] == 0, hz, -hz)], -1)
    ysel = (face >= 2) & (face < 4)
    p[ysel] = np.stack([u[ysel] * hx,
                        np.where(face[ysel] == 2, hy, -hy),
                        v[ysel] * hz], -1)
    xsel = face >= 4
    p[xsel] = np.stack([np.where(face[xsel] == 4, hx, -hx),
                        u[xsel] * hy, v[xsel] * hz], -1)
    return p, face


def box_points(ext: Tuple[float, float, float]) -> np.ndarray:
    """Centroid + 8 corners for the given half-extents (label codec order)."""
    hx, hy, hz = ext
    return np.array([[0, 0, 0]] + [[sx * hx, sy * hy, sz * hz]
                     for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                    np.float32)


def render_scene_multi(rng: np.random.RandomState, palettes: np.ndarray,
                       extents: np.ndarray, classes,
                       *, n_splats: int = 2200, splat: int = 6):
    """One multi-object shaded scene with correct inter-object occlusion.

    ``palettes``: (n_classes, 6, 3) u8 per-face albedo per class (face
    identity + palette are the class cues, as face color is on real
    textured objects); ``extents``: (n_classes, 3) per-class box
    half-extents (geometry is the second cue); ``classes``: the class ids
    to place (objects spread across x lanes like the reference's OCCLUSION
    scenes, with jitter).

    All objects' splats are depth-sorted into ONE global far→near painter
    pass (vectorized fancy assignment — last write per pixel wins, which in
    far→near order is the nearest surface), so objects occlude each other
    correctly.  Labels follow the reference convention: keypoints of
    occluded objects are still labeled (LINEMOD-style).

    Returns (img u8 (480,640,3), [(cls, label21, pix9x2), ...]).
    """
    n = len(classes)
    light = rng.randn(3).astype(np.float32)
    light /= max(np.linalg.norm(light), 1e-6)

    all_xy, all_z, all_col = [], [], []
    gts = []
    lane0 = -0.12 * (n - 1) / 2.0
    for slot, cls in enumerate(classes):
        R, t = _random_pose(rng, tx=lane0 + 0.12 * slot)
        pts = box_points(extents[cls])
        cam_k = pts @ R.T + t
        pix = cam_k @ K.T
        pix = pix[:, :2] / pix[:, 2:3]
        lab = np.zeros(21, np.float32)
        lab[0] = cls
        lab[1:19:2] = pix[:, 0] / IM_W
        lab[2:19:2] = pix[:, 1] / IM_H
        lab[19:21] = [np.ptp(pix[:, 0]) / IM_W, np.ptp(pix[:, 1]) / IM_H]
        gts.append((int(cls), lab, pix.astype(np.float32)))

        # splat density ∝ projected area (extent² / depth²), so big or near
        # boxes stay solid instead of speckled
        dens = (float(np.mean(extents[cls])) / 0.04) ** 2 * (0.675 / t[2]) ** 2
        p, face = _surface_points(rng, max(n_splats // 4,
                                           int(n_splats * dens)),
                                  tuple(extents[cls]))
        cam = p @ R.T + t
        uvw = cam @ K.T
        all_xy.append(np.stack([uvw[:, 0] / uvw[:, 2],
                                uvw[:, 1] / uvw[:, 2]], -1))
        all_z.append(cam[:, 2])
        n_cam = _NORMALS @ R.T
        lam = 0.35 + 0.65 * np.maximum(n_cam @ light, 0.0)
        all_col.append(np.clip(palettes[cls].astype(np.float32)[face] *
                               lam[face, None], 0, 255).astype(np.uint8))

    xy = np.concatenate(all_xy)
    z = np.concatenate(all_z)
    col = np.concatenate(all_col)
    x = xy[:, 0].astype(np.int32)
    y = xy[:, 1].astype(np.int32)
    ok = (x >= 0) & (x < IM_W - splat) & (y >= 0) & (y < IM_H - splat)
    order = np.argsort(-z[ok])          # far first; later writes are nearer
    x, y, col = x[ok][order], y[ok][order], col[ok][order]

    img = np.zeros((IM_H, IM_W, 3), np.uint8)
    img[:] = rng.randint(20, 90, 3)
    dy, dx = np.mgrid[0:splat, 0:splat]
    yy = (y[:, None, None] + dy).ravel()
    xx = (x[:, None, None] + dx).ravel()
    img[yy, xx] = np.repeat(col, splat * splat, axis=0)
    return img, gts


def render_frame(rng: np.random.RandomState, colors: np.ndarray, *,
                 n_splats: int = 900, splat: int = 6,
                 bg_level: Optional[Tuple[int, int]] = (20, 90),
                 ext: Tuple[float, float, float] = BOX_HALF_EXTENTS,
                 cls: int = 0):
    """One shaded frame.  Returns (img u8 (480,640,3), mask u8 (480,640),
    label (21,) f32, R (3,3), t (3,)).

    ``colors``: (6,3) u8 per-face albedo (fixed per object so the network can
    learn face identity).  ``ext``/``cls``: per-class box half-extents and
    the class id written to label[0] (multi-object corpora).  Rendering:
    splats sorted far→near (painter's order) with a per-splat z-test,
    Lambertian shading ``0.35 + 0.65·max(n·l, 0)`` under a per-frame random
    light.
    """
    R, t = _random_pose(rng)
    cam_pts = box_points(ext) @ R.T + t
    pix = cam_pts @ K.T
    pix = pix[:, :2] / pix[:, 2:3]

    img = np.zeros((IM_H, IM_W, 3), np.uint8)
    if bg_level is not None:
        img[:] = rng.randint(*bg_level, 3)
    mask = np.zeros((IM_H, IM_W), np.uint8)

    p, face = _surface_points(rng, n_splats, ext)
    cam = p @ R.T + t                      # (n,3)
    uvw = cam @ K.T
    x = (uvw[:, 0] / uvw[:, 2]).astype(np.int32)
    y = (uvw[:, 1] / uvw[:, 2]).astype(np.int32)
    z = cam[:, 2]

    light = rng.randn(3).astype(np.float32)
    light /= max(np.linalg.norm(light), 1e-6)
    n_cam = _NORMALS @ R.T                 # face normals in camera frame
    lam = 0.35 + 0.65 * np.maximum(n_cam @ light, 0.0)      # (6,)
    shaded = np.clip(colors.astype(np.float32)[face] *
                     lam[face, None], 0, 255).astype(np.uint8)

    order = np.argsort(-z)                 # far first (painter's order)
    depth = np.full((IM_H, IM_W), 1e9, np.float32)
    s = splat
    for i in order:
        xi, yi = x[i], y[i]
        if 0 <= xi < IM_W - s and 0 <= yi < IM_H - s and z[i] < depth[yi, xi]:
            img[yi:yi + s, xi:xi + s] = shaded[i]
            mask[yi:yi + s, xi:xi + s] = 255
            depth[yi:yi + s, xi:xi + s] = z[i]

    lab = np.zeros(21, np.float32)
    lab[0] = cls
    lab[1:19:2] = pix[:, 0] / IM_W
    lab[2:19:2] = pix[:, 1] / IM_H
    lab[19:21] = [np.ptp(pix[:, 0]) / IM_W, np.ptp(pix[:, 1]) / IM_H]
    return img, mask, lab, R, t


def make_shaded_linemod(root: str, *, n_train: int = 16, n_test: int = 16,
                        seed: int = 0, quality: int = 95,
                        n_splats: int = 900) -> str:
    """Write a LINEMOD-format dataset under ``root`` with DISJOINT train and
    test poses (one rng stream: the first ``n_train`` poses train, the next
    ``n_test`` evaluate — held-out-pose generalization, not memorization).
    Returns the ``.data`` config path (``valid`` points at ``test.txt``)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    colors = rng.randint(60, 255, (6, 3))
    obj = os.path.join(root, "obj")
    for d in ("JPEGImages", "mask", "labels"):
        os.makedirs(os.path.join(obj, d), exist_ok=True)

    splits = [("train.txt", n_train, 0), ("test.txt", n_test, n_train)]
    for listname, n, base in splits:
        paths = []
        for j in range(n):
            img, mask, lab, _, _ = render_frame(rng, colors,
                                                n_splats=n_splats)
            name = f"00{base + j:04d}"
            p = os.path.join(obj, "JPEGImages", f"{name}.jpg")
            Image.fromarray(img).save(p, quality=quality)
            # mask path rule: JPEGImages→mask, /00→/, .jpg→.png
            Image.fromarray(mask).save(
                os.path.join(obj, "mask", f"{name[2:]}.png"))
            np.savetxt(os.path.join(obj, "labels", f"{name}.txt"), lab[None])
            paths.append(p)
        with open(os.path.join(root, listname), "w") as f:
            f.write("\n".join(paths) + "\n")

    v = PTS[1:]
    ply = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
           "property float x", "property float y", "property float z",
           "element face 0", "property list uchar int vertex_indices",
           "end_header"] + [f"{a} {b} {c}" for a, b, c in v]
    with open(os.path.join(root, "obj.ply"), "w") as f:
        f.write("\n".join(ply) + "\n")

    diam = float(2 * np.linalg.norm(BOX_HALF_EXTENTS))
    datacfg = os.path.join(root, "shaded.data")
    with open(datacfg, "w") as f:
        f.write(f"train = {root}/train.txt\n"
                f"valid = {root}/test.txt\n"
                f"backup = {root}/backup\n"
                f"mesh = {root}/obj.ply\n"
                f"name = shadedbox\ndiam = {diam:.4f}\ngpus = 0\n"
                "num_workers = 2\nwidth = 640\nheight = 480\n"
                "fx = 572.4114\nfy = 573.5704\nu0 = 325.2611\n"
                "v0 = 242.0489\n")
    return datacfg
