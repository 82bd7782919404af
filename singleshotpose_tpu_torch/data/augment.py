"""Host-side image augmentation — vectorized numpy, PIL only for file decode.

The port's own copy of ``singleshotpose_tpu/data/augment.py`` (numpy only),
so the port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds every function equal to the original, bit for bit.

Re-derivation of the reference's PIL-based augmentation
(reference: ``image.py:8-143``) with the same geometry/label algebra but
array math instead of per-pixel ``Image.point`` lambdas.  Parity is
by-metric, not by-pixel (PIL's integer HSV tables round differently).

Documented divergences from the reference (deliberate fixes):
  * crop extent: the reference crops ``(pleft, ptop, pleft+swidth-1,
    ptop+sheight-1)`` — a (swidth-1)×(sheight-1) crop — while computing the
    label transform with swidth/sheight (``image.py:66-71``), a sub-pixel
    off-by-one misalignment.  We crop the full swidth×sheight so labels and
    pixels agree exactly.
  * horizontal flip: drawn but never applied in the single-object reference
    (``image.py:64-65``) and never label-mirrored; kept OFF here too.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rand_scale", "distort_hsv", "random_distort", "crop_resize",
           "change_background", "transform_truths", "data_augmentation",
           "resize_indices", "resize_nearest", "rgb_to_hsv_u8", "hsv_to_rgb_u8"]


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------


def rgb_to_hsv_u8(img: np.ndarray) -> np.ndarray:
    """RGB uint8 (H,W,3) → HSV uint8 with PIL's 0..255 hue scaling."""
    rgb = img.astype(np.float32) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    d = mx - mn
    safe = np.where(d == 0, 1.0, d)
    h = np.where(mx == r, (g - b) / safe % 6.0,
                 np.where(mx == g, (b - r) / safe + 2.0,
                          (r - g) / safe + 4.0))
    h = np.where(d == 0, 0.0, h) / 6.0
    s = np.where(mx == 0, 0.0, d / np.where(mx == 0, 1.0, mx))
    return np.stack([h * 255.0, s * 255.0, mx * 255.0], -1).astype(np.uint8)


def hsv_to_rgb_u8(hsv: np.ndarray) -> np.ndarray:
    """HSV uint8 (PIL scaling) → RGB uint8."""
    h = hsv[..., 0].astype(np.float32) * 6.0 / 255.0
    s = hsv[..., 1].astype(np.float32) / 255.0
    v = hsv[..., 2].astype(np.float32) / 255.0
    i = np.floor(h) % 6
    f = h - np.floor(h)
    p, q, t = v * (1 - s), v * (1 - s * f), v * (1 - s * (1 - f))
    r = np.choose(i.astype(np.int32), [v, q, p, p, t, v])
    g = np.choose(i.astype(np.int32), [t, v, v, q, p, p])
    b = np.choose(i.astype(np.int32), [p, p, t, v, v, q])
    return np.clip(np.stack([r, g, b], -1) * 255.0, 0, 255).astype(np.uint8)


def distort_hsv(img: np.ndarray, dhue: float, dsat: float,
                dexp: float) -> np.ndarray:
    """Hue shift + saturation/value scaling in HSV space.

    Matches ``distort_image`` (``image.py:14-31``): sat/val multiplied and
    clipped; hue shifted by ``dhue*255`` with a single wraparound.
    """
    hsv = rgb_to_hsv_u8(img).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * dsat, 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * dexp, 0, 255)
    h = hsv[..., 0] + dhue * 255.0
    h = np.where(h > 255.0, h - 255.0, h)
    h = np.where(h < 0.0, h + 255.0, h)
    hsv[..., 0] = h
    return hsv_to_rgb_u8(hsv.astype(np.uint8))


def rand_scale(rng: np.random.RandomState, s: float) -> float:
    """Uniform in [1, s], inverted with prob 1/2 (``image.py:33-37``)."""
    scale = rng.uniform(1.0, s)
    return scale if rng.randint(2) else 1.0 / scale


def random_distort(rng: np.random.RandomState, img: np.ndarray, hue: float,
                   saturation: float, exposure: float) -> np.ndarray:
    return distort_hsv(img, rng.uniform(-hue, hue),
                       rand_scale(rng, saturation), rand_scale(rng, exposure))


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------


def resize_indices(n_in: int, n_out: int) -> np.ndarray:
    """The source row (or column) of each of ``n_out`` outputs: the center
    sample of the nearest-neighbor resize."""
    return np.minimum((np.arange(n_out) + 0.5) * n_in / n_out,
                      n_in - 1).astype(np.int64)


def resize_nearest(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Center-sample nearest-neighbor resize (PIL ``resize`` default filter)."""
    h, w = img.shape[:2]
    return img[resize_indices(h, out_h)][:, resize_indices(w, out_w)]


def crop_resize(img: np.ndarray, pleft: int, ptop: int, swidth: int,
                sheight: int, out_w: int, out_h: int) -> np.ndarray:
    """Zero-padded crop of size (sheight, swidth) at (ptop, pleft), then
    nearest resize to (out_h, out_w) — PIL ``crop`` + ``resize`` semantics."""
    h, w = img.shape[:2]
    out = np.zeros((sheight, swidth) + img.shape[2:], img.dtype)
    y0, y1 = max(ptop, 0), min(ptop + sheight, h)
    x0, x1 = max(pleft, 0), min(pleft + swidth, w)
    if y1 > y0 and x1 > x0:
        out[y0 - ptop:y1 - ptop, x0 - pleft:x1 - pleft] = img[y0:y1, x0:x1]
    return resize_nearest(out, out_w, out_h)


def change_background(img: np.ndarray, mask: np.ndarray,
                      bg: np.ndarray) -> np.ndarray:
    """Composite foreground over a (resized) background via the mask.

    ``out = img·(mask/255) + bg·(1 − mask/255)`` — the reference's ImageMath
    blend (``image.py:110-127``); LINEMOD masks are binary so this is a hard
    paste."""
    h, w = img.shape[:2]
    bgr = resize_nearest(bg, w, h).astype(np.float32)
    alpha = mask.astype(np.float32) / 255.0
    if alpha.ndim == 2:
        alpha = alpha[..., None]
    return (img.astype(np.float32) * alpha + bgr * (1.0 - alpha)).astype(np.uint8)


def data_augmentation(rng: np.random.RandomState, img: np.ndarray,
                      out_w: int, out_h: int, jitter: float, hue: float,
                      saturation: float, exposure: float):
    """Random crop-jitter + resize + HSV distortion
    (``data_augmentation``, ``image.py:46-74``).

    Returns (img, flip, dx, dy, sx, sy) with the reference's meaning:
    label transform is ``x' = x/sx − dx`` (the caller passes 1/sx as the
    fill-truth scale, ``image.py:139-141``)."""
    oh, ow = img.shape[:2]
    dw, dh = int(ow * jitter), int(oh * jitter)
    pleft = rng.randint(-dw, dw + 1)
    pright = rng.randint(-dw, dw + 1)
    ptop = rng.randint(-dh, dh + 1)
    pbot = rng.randint(-dh, dh + 1)
    swidth = ow - pleft - pright
    sheight = oh - ptop - pbot
    sx = swidth / ow
    sy = sheight / oh
    flip = bool(rng.randint(2))  # drawn, never applied — reference parity
    cropped = crop_resize(img, pleft, ptop, swidth, sheight, out_w, out_h)
    dx = (pleft / ow) / sx
    dy = (ptop / oh) / sy
    out = random_distort(rng, cropped, hue, saturation, exposure)
    return out, flip, dx, dy, sx, sy


# ---------------------------------------------------------------------------
# labels
# ---------------------------------------------------------------------------


def transform_truths(truths: np.ndarray, dx: float, dy: float, sx: float,
                     sy: float, num_keypoints: int = 9,
                     max_num_gt: int = 50,
                     recompute_extents: bool = False) -> np.ndarray:
    """Apply the crop transform to label rows and pad to the 50-slot tensor.

    Vectorized ``fill_truth_detection`` (``image.py:76-108``): every keypoint
    maps ``x' = x·sx − dx`` (the caller passes the *reciprocal* crop scale as
    ``sx``); only the centroid (keypoint 0) is clamped to [0, 0.999].
    ``recompute_extents=True`` additionally rewrites the trailing x/y-range
    fields as max−min of the transformed keypoints (the multi-object variant,
    ``image_multi.py:152-157``).  Returns the flat (max_num_gt·(2K+3),) array.
    """
    K = num_keypoints
    nl = 2 * K + 3
    label = np.zeros((max_num_gt, nl), np.float32)
    if truths.size:
        bs = truths.reshape(-1, nl)[:max_num_gt].astype(np.float32).copy()
        xs = bs[:, 1:2 * K + 1:2] * sx - dx
        ys = bs[:, 2:2 * K + 1:2] * sy - dy
        xs[:, 0] = np.clip(xs[:, 0], 0.0, 0.999)
        ys[:, 0] = np.clip(ys[:, 0], 0.0, 0.999)
        bs[:, 1:2 * K + 1:2] = xs
        bs[:, 2:2 * K + 1:2] = ys
        if recompute_extents:
            bs[:, nl - 2] = xs.max(1) - xs.min(1)
            bs[:, nl - 1] = ys.max(1) - ys.min(1)
        label[:bs.shape[0]] = bs
    return label.reshape(-1)
