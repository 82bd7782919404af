"""Multi-object scene synthesis for OCCLUSION training.

The port's own copy of ``singleshotpose_tpu/data/synth_multi.py``, so the
port imports nothing of the JAX package; ``tests/test_torch_multi_host.py``
holds its numpy scenes and labels, and the loader batches built from them,
bit for bit to the JAX package's ``SynthConfig(native="off")``, and
``tests/test_torch_native.py`` its native ones (``native="auto"``: the C++
pixel core of ``native/``, the same draws) to JAX's.

A rebuild of the reference's object-pasting pipeline (reference:
``multi_obj_pose_estimation/image_multi.py:8-383``): LINEMOD single-object
frames are composited into multi-object scenes — the base object is
mask-cropped and randomly shifted, then its companion objects (a fixed
per-object co-occurrence list, up to 8 of them for eggbox) are drawn from
their own LINEMOD train lists and pasted wherever their mask overlaps < 20%
with already-placed pixels; finally a random VOC background fills the rest.

Semantics kept from the reference:
  * per-object companion lists (``get_add_objs``, ``image_multi.py:8-36``),
  * wrap-around ±80 px shift of the base object after resize (ImageChops
    offset ≡ ``np.roll``; dx/dy corrected in output-shape units — the
    active "FIX HERE" branch at ``image_multi.py:206-207``),
  * rejection sampling on mask-intersection ratio < 0.2 over a >200
    pixel-threshold binarization (``image_multi.py:340-353``),
  * paste order: companions over base, then the base object re-pasted last
    so it is always fully visible (``image_multi.py:367``),
  * 2D-extent label fields recomputed from transformed keypoints,
  * no HSV distortion — the reference passes hue/sat/exp down but its
    with-mask augmenters never apply them (``image_multi.py:184-260``).

Divergences, as in the JAX package:
  * horizontal flip: the reference flips image+mask 50% of the time but
    never mirrors labels; default here is ``flip="off"``,
    ``flip="reference"`` replicates.
  * the reference's rejection loop runs forever if a companion can never be
    placed; attempts per companion are capped and it is dropped
    (``max_attempts``).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Tuple

import numpy as np

from ..utils.labels import (label_path_from_image, mask_path_from_image,
                            read_truths)
from . import augment
from .pipeline import load_image

__all__ = ["ADD_OBJS", "OCCLUSION_CLASSES", "SynthConfig",
           "MultiObjectSynthesizer", "mask_foreground", "superimpose",
           "superimpose_masks", "shifted_augment_with_mask",
           "augment_with_mask"]

# Fixed companion lists per base object (image_multi.py:8-36).
ADD_OBJS: Dict[str, Tuple[str, ...]] = {
    "ape": ("can", "cat", "duck", "glue", "holepuncher", "iron", "phone"),
    "benchvise": ("ape", "can", "cat", "driller", "duck", "glue",
                  "holepuncher"),
    "cam": ("ape", "benchvise", "can", "cat", "driller", "duck",
            "holepuncher"),
    "can": ("ape", "benchvise", "cat", "driller", "duck", "eggbox",
            "holepuncher"),
    "cat": ("ape", "can", "duck", "glue", "holepuncher", "eggbox", "phone"),
    "driller": ("ape", "benchvise", "can", "cat", "duck", "glue",
                "holepuncher"),
    "duck": ("ape", "can", "cat", "eggbox", "glue", "holepuncher", "phone"),
    "eggbox": ("ape", "benchvise", "cam", "can", "cat", "duck", "glue",
               "holepuncher"),
    "glue": ("ape", "benchvise", "cam", "driller", "duck", "eggbox",
             "holepuncher"),
    "holepuncher": ("benchvise", "cam", "can", "cat", "driller", "duck",
                    "eggbox"),
    "iron": ("ape", "benchvise", "can", "cat", "driller", "duck", "glue"),
    "lamp": ("ape", "benchvise", "can", "driller", "eggbox", "holepuncher",
             "iron"),
    "phone": ("ape", "benchvise", "cam", "can", "driller", "duck",
              "holepuncher"),
}

# 13-class ordering used by the OCCLUSION label files.
OCCLUSION_CLASSES: Tuple[str, ...] = (
    "ape", "benchvise", "cam", "can", "cat", "driller", "duck", "eggbox",
    "glue", "holepuncher", "iron", "lamp", "phone")


def mask_foreground(img: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Zero the background: ``img · mask/255`` (``mask_background``,
    ``image_multi.py:40-52``)."""
    alpha = mask.astype(np.float32) / 255.0
    if alpha.ndim == 2:
        alpha = alpha[..., None]
    return (img.astype(np.float32) * alpha).astype(np.uint8)


def superimpose(fg: np.ndarray, fg_mask: np.ndarray,
                canvas: np.ndarray) -> np.ndarray:
    """Paste ``fg`` over ``canvas`` where its mask is set
    (``superimpose_masked_imgs``, ``image_multi.py:265-280``)."""
    alpha = fg_mask.astype(np.float32) / 255.0
    if alpha.ndim == 2:
        alpha = alpha[..., None]
    return (fg.astype(np.float32) * alpha
            + canvas.astype(np.float32) * (1.0 - alpha)).astype(np.uint8)


def superimpose_masks(mask: np.ndarray, total: np.ndarray) -> np.ndarray:
    """Accumulate coverage: ``mask + total·(1 − mask/255)`` clipped to u8
    (``superimpose_masks``, ``image_multi.py:282-297``)."""
    m = mask.astype(np.float32)
    return np.clip(m + total.astype(np.float32) * (1.0 - m / 255.0),
                   0, 255).astype(np.uint8)


def _draw_crop(rng: np.random.RandomState, ow: int, oh: int, jitter: float):
    """The crop-jitter + flip draws shared by both augmenters."""
    dw, dh = int(ow * jitter), int(oh * jitter)
    pleft = rng.randint(-dw, dw + 1)
    pright = rng.randint(-dw, dw + 1)
    ptop = rng.randint(-dh, dh + 1)
    pbot = rng.randint(-dh, dh + 1)
    swidth = ow - pleft - pright
    sheight = oh - ptop - pbot
    flip = bool(rng.randint(2))
    return pleft, ptop, swidth, sheight, swidth / ow, sheight / oh, flip


def shifted_augment_with_mask(rng: np.random.RandomState, img: np.ndarray,
                              mask: np.ndarray, out_w: int, out_h: int,
                              jitter: float, shift: int = 80,
                              apply_flip: bool = False):
    """Crop-jitter + resize + wrap-around random shift of image AND mask
    (``shifted_data_augmentation_with_mask``, ``image_multi.py:184-228``).

    Returns (img, mask, flip, dx, dy, sx, sy)."""
    oh, ow = img.shape[:2]
    pleft, ptop, swidth, sheight, sx, sy, flip = _draw_crop(rng, ow, oh,
                                                            jitter)
    shift_x = rng.randint(-shift, shift + 1)
    shift_y = rng.randint(-shift, shift + 1)
    dx = (pleft / ow) / sx - shift_x / out_w
    dy = (ptop / oh) / sy - shift_y / out_h

    sized = augment.crop_resize(img, pleft, ptop, swidth, sheight,
                                out_w, out_h)
    mask_sized = augment.crop_resize(mask, pleft, ptop, swidth, sheight,
                                     out_w, out_h)
    sized = np.roll(sized, (shift_y, shift_x), axis=(0, 1))
    mask_sized = np.roll(mask_sized, (shift_y, shift_x), axis=(0, 1))
    if flip and apply_flip:
        sized = sized[:, ::-1]
        mask_sized = mask_sized[:, ::-1]
    return sized, mask_sized, flip, dx, dy, sx, sy


def augment_with_mask(rng: np.random.RandomState, img: np.ndarray,
                      mask: np.ndarray, out_w: int, out_h: int,
                      jitter: float, apply_flip: bool = False):
    """Crop-jitter + resize of image AND mask, no shift
    (``data_augmentation_with_mask``, ``image_multi.py:230-260``)."""
    oh, ow = img.shape[:2]
    pleft, ptop, swidth, sheight, sx, sy, flip = _draw_crop(rng, ow, oh,
                                                            jitter)
    dx = (pleft / ow) / sx
    dy = (ptop / oh) / sy
    sized = augment.crop_resize(img, pleft, ptop, swidth, sheight,
                                out_w, out_h)
    mask_sized = augment.crop_resize(mask, pleft, ptop, swidth, sheight,
                                     out_w, out_h)
    if flip and apply_flip:
        sized = sized[:, ::-1]
        mask_sized = mask_sized[:, ::-1]
    return sized, mask_sized, flip, dx, dy, sx, sy


@dataclasses.dataclass
class SynthConfig:
    linemod_root: str                 # dir containing <obj>/train.txt
    jitter: float = 0.1               # dataset_multi.py:62
    shift: int = 80                   # image_multi.py:203-204
    pixel_threshold: int = 200        # image_multi.py:302
    max_intersection: float = 0.2     # image_multi.py:353
    max_attempts: int = 30            # divergence: reference loops forever
    flip: str = "off"                 # "off" | "reference" (image-only flip)
    num_keypoints: int = 9
    max_num_gt: int = 50
    # "auto": the C++ pixel core (native/ssp_native.cpp) when it builds —
    # bit-identical output, the same rng stream (the draws stay in Python);
    # "off" forces the numpy ops; "on" raises if the library is unavailable
    native: str = "auto"


class MultiObjectSynthesizer:
    """Callable plugged into ``PoseDataset(synthesizer=...)``: builds one
    composite scene + 50-slot label tensor (``augment_objects`` +
    ``load_data_detection``, ``image_multi.py:299-383``)."""

    def __init__(self, cfg: SynthConfig):
        self.cfg = cfg
        self._train_lists: Dict[str, List[str]] = {}
        if cfg.native not in ("auto", "on", "off"):
            raise ValueError(f"SynthConfig.native must be auto, on or off, "
                             f"not {cfg.native!r}")
        self._native = None
        if cfg.native != "off":
            from ..native import NativeSynthOps
            try:
                self._native = NativeSynthOps()
            except RuntimeError:
                if cfg.native == "on":
                    raise

    def _train_list(self, obj: str) -> List[str]:
        if obj not in self._train_lists:
            path = os.path.join(self.cfg.linemod_root, obj, "train.txt")
            try:
                with open(path) as f:
                    lines = [ln.strip() for ln in f if ln.strip()]
            except FileNotFoundError:
                # companion object not on disk: skip it rather than crash
                # (divergence: the reference assumes all 13 objects exist)
                self._train_lists[obj] = []
                return []
            # reference resolves paths relative to the parent of LINEMOD/
            base = os.path.dirname(self.cfg.linemod_root.rstrip("/"))
            self._train_lists[obj] = [
                ln if os.path.isabs(ln) else os.path.join(base, ln)
                for ln in lines]
        return self._train_lists[obj]

    def _load_truths(self, imgpath: str) -> np.ndarray:
        labpath = label_path_from_image(imgpath)
        if os.path.exists(labpath) and os.path.getsize(labpath):
            return read_truths(labpath, self.cfg.num_keypoints)
        return np.zeros((0,), np.float32)

    def __call__(self, dataset, imgpath: str, shape: Tuple[int, int],
                 rng: np.random.RandomState):
        cfg = self.cfg
        out_w, out_h = shape
        K, nl = cfg.num_keypoints, 2 * cfg.num_keypoints + 3
        apply_flip = cfg.flip == "reference"

        objname = os.path.basename(os.path.dirname(os.path.dirname(imgpath)))
        add_objs = list(ADD_OBJS.get(objname, ()))
        rng.shuffle(add_objs)

        # honour the dataset's decoded-image cache: scene synthesis re-reads
        # companion frames constantly
        decode = getattr(dataset, "_decode_cached", None)
        load = (lambda p: decode(p, load_image)) if decode else load_image

        img = load(imgpath)
        mask = load(mask_path_from_image(imgpath))
        if self._native is not None and img.ndim == 3:
            return self._call_native(dataset, imgpath, img, mask, add_objs,
                                     load, out_w, out_h, rng)
        img, mask, flip, dx, dy, sx, sy = shifted_augment_with_mask(
            rng, img, mask, out_w, out_h, cfg.jitter, cfg.shift, apply_flip)
        total_label = augment.transform_truths(
            self._load_truths(imgpath), dx, dy, 1.0 / sx, 1.0 / sy, K,
            cfg.max_num_gt, recompute_extents=True).reshape(-1, nl)

        base_masked = mask_foreground(img, mask)
        total_mask = mask
        canvas = base_masked
        count = 1

        for obj in add_objs:
            lines = self._train_list(obj)
            if not lines:
                continue
            for _attempt in range(cfg.max_attempts):
                opath = lines[rng.randint(len(lines))]
                try:
                    oimg = load(opath)
                    omask = load(mask_path_from_image(opath))
                except (FileNotFoundError, OSError):
                    continue
                omasked = mask_foreground(oimg, omask)
                omasked, omask, oflip, odx, ody, osx, osy = augment_with_mask(
                    rng, omasked, omask, out_w, out_h, cfg.jitter, apply_flip)

                xx = (np.asarray(omask).max(-1) if omask.ndim == 3
                      else omask) > cfg.pixel_threshold
                yy = (np.asarray(total_mask).max(-1) if total_mask.ndim == 3
                      else total_mask) > cfg.pixel_threshold
                area = float(xx.sum())
                if area < 1:
                    continue
                if float((xx & yy).sum()) / area < cfg.max_intersection:
                    olabel = augment.transform_truths(
                        self._load_truths(opath), odx, ody, 1.0 / osx,
                        1.0 / osy, K, cfg.max_num_gt,
                        recompute_extents=True).reshape(-1, nl)
                    total_mask = superimpose_masks(omask, total_mask)
                    canvas = superimpose(omasked, omask, canvas)
                    if count < cfg.max_num_gt:
                        total_label[count] = olabel[0]
                        count += 1
                    break
            # unplaceable companion dropped after max_attempts (divergence)

        # base object re-pasted last: always fully visible
        canvas = superimpose(base_masked, mask, canvas)

        # VOC background behind everything
        if dataset.bg_file_names:
            bg = load_image(dataset.bg_file_names[
                rng.randint(len(dataset.bg_file_names))])
            canvas = augment.change_background(canvas, total_mask, bg)
        return canvas, total_label.reshape(-1)

    def _call_native(self, dataset, imgpath: str, img: np.ndarray,
                     mask: np.ndarray, add_objs: List[str], load,
                     out_w: int, out_h: int, rng: np.random.RandomState):
        """The same scene synthesis through the C++ pixel core.

        Control flow, label algebra, and every rng draw are identical to the
        numpy path above (the shared ``_draw_crop`` consumes the stream in
        the same order); only the pixel passes run natively, to the same
        bytes.
        """
        cfg = self.cfg
        K, nl = cfg.num_keypoints, 2 * cfg.num_keypoints + 3
        apply_flip = cfg.flip == "reference"
        nat = self._native

        def as3(m):
            # a 2-D mask broadcasts per channel in the numpy path; three
            # equal channels are bit-equivalent
            return np.repeat(m[:, :, None], 3, 2) if m.ndim == 2 else m

        oh, ow = img.shape[:2]
        pleft, ptop, sw, sh, sx, sy, flip = _draw_crop(rng, ow, oh,
                                                       cfg.jitter)
        shift_x = rng.randint(-cfg.shift, cfg.shift + 1)
        shift_y = rng.randint(-cfg.shift, cfg.shift + 1)
        dx = (pleft / ow) / sx - shift_x / out_w
        dy = (ptop / oh) / sy - shift_y / out_h
        base_masked, mask_sized = nat.masked_resize(
            img, as3(mask), pleft, ptop, sw, sh, out_w, out_h,
            shift_x=shift_x, shift_y=shift_y, flip=flip and apply_flip)
        total_label = augment.transform_truths(
            self._load_truths(imgpath), dx, dy, 1.0 / sx, 1.0 / sy, K,
            cfg.max_num_gt, recompute_extents=True).reshape(-1, nl)

        canvas = base_masked.copy()       # composites mutate in place; the
        total_mask = mask_sized.copy()    # base pair is re-pasted at the end
        count = 1

        for obj in add_objs:
            lines = self._train_list(obj)
            if not lines:
                continue
            for _attempt in range(cfg.max_attempts):
                opath = lines[rng.randint(len(lines))]
                try:
                    oimg = load(opath)
                    omask = load(mask_path_from_image(opath))
                except (FileNotFoundError, OSError):
                    continue
                ooh, oow = oimg.shape[:2]
                opl, opt, osw, osh, osx, osy, oflip = _draw_crop(
                    rng, oow, ooh, cfg.jitter)
                omasked_s, omask_s, area, inter = nat.masked_resize(
                    oimg, as3(omask), opl, opt, osw, osh, out_w, out_h,
                    flip=oflip and apply_flip, total=total_mask,
                    thresh=cfg.pixel_threshold)
                if area < 1:
                    continue
                if float(inter) / area < cfg.max_intersection:
                    olabel = augment.transform_truths(
                        self._load_truths(opath), (opl / oow) / osx,
                        (opt / ooh) / osy, 1.0 / osx, 1.0 / osy, K,
                        cfg.max_num_gt, recompute_extents=True).reshape(
                            -1, nl)
                    nat.composite(omasked_s, omask_s, canvas, total_mask)
                    if count < cfg.max_num_gt:
                        total_label[count] = olabel[0]
                        count += 1
                    break

        # base object re-pasted last: always fully visible
        nat.composite(base_masked, mask_sized, canvas)

        if dataset.bg_file_names:
            bg = load_image(dataset.bg_file_names[
                rng.randint(len(dataset.bg_file_names))])
            nat.change_background(canvas, total_mask, bg)
        return canvas, total_label.reshape(-1)
