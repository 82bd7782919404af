"""On-device multi-object scene synthesis: the OCCLUSION data path on the
card, from a device-resident frame bank.

The port's counterpart of ``singleshotpose_tpu/data/device_synth.py``.  The
host synthesizer (``data/synth_multi.py``, a rebuild of the reference's
``multi_obj_pose_estimation/image_multi.py:299-383``) decodes and composites
in the loader's threads: per scene it reads the base frame, up to 8
companion frames with masks and a background, and runs rejection sampling
in numpy.  Here the whole training corpus is decoded once and parked in
device memory (:class:`DeviceSceneBank`, LINEMOD's 13 objects × ~190 frames
≈ 3 GB), and a batch of scenes is PyTorch ops over the whole batch on the
bank's device: crop-jitter gathers, the mask-overlap rejection as a
fixed-width propose-A-then-pick, the composite, and 50-slot labels.

The random draws are split from the synthesis: :func:`draw_synth` draws a
batch's integers (crops, shifts, the companion order, the background, each
proposal's frame and crop) with a ``torch.Generator`` on the bank's device,
from the integer ranges the JAX package draws from, and
:func:`synthesize_batch` is a deterministic function of (bank, indices,
draws).  The JAX package draws with threefry keys instead; given JAX's own
draws, the port's scenes and labels equal JAX's bit for bit
(``tests/test_torch_device_synth.py``).

Semantics kept from the host path (and the JAX package's device path):
  * base frame: crop-jitter + nearest resize + a wrap-around ±``shift`` px
    roll (here folded into the gather's row and column indices);
    companions: crop-jitter + resize, no shift,
  * rejection on the mask-intersection ratio < ``max_intersection`` over a
    ``pixel_threshold`` binarization; the first acceptable of ``attempts``
    proposals wins (the host tries them one after another),
  * paste order: companions over the base, the base re-pasted last (always
    fully visible), a background behind everything,
  * labels: ``x' = x/sx − dx``, the centroid clamped, 2D extents recomputed.

Divergences, as in the JAX package: the bank stores each frame's first
label row; backgrounds are a seeded sample of ``max_backgrounds``,
pre-resized to the frame size; ``attempts`` parallel proposals per
companion (with ``attempts == max_attempts`` the drop law (1−p)^attempts is
the host's); with ``propose_scale > 1`` the overlap test runs on a coarser
grid; ``flip="off"`` only.

Rounding as the JAX package's compiled program rounds it
(``data/device_augment.py``'s module docstring): a division by a constant
is a multiply by the constant's f32 reciprocal, a division by a computed
value is a true division, and the label transform's multiply-subtract is
one fused multiply-add, as are the composites (XLA's CPU compiler contracts
them; :func:`~.device_augment.fma` rounds once in f64).  The crop reads u8
levels; the winner's ``floor(img·mask/255)`` is computed on the gathered
pixels only, the same values as JAX's full-frame product, since a nearest
resample selects source pixels.  Where every mask value is 0 or 255
(LINEMOD's PNG masks, the shaded renders: :func:`binary_masks`), every
composite is a select, so ``synthesize_batch(binary=True)`` composites on
u8 levels and scales to [0, 1] once, with the same bits and without the f64
passes.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..utils.labels import (label_path_from_image, mask_path_from_image,
                            read_truths)
from .augment import resize_nearest
from .device_augment import INV255, crop_index, fma, gather, recip
from .synth_multi import ADD_OBJS, OCCLUSION_CLASSES, SynthConfig

__all__ = ["DeviceSceneBank", "DeviceSynthStatic", "SynthDraws",
           "binary_masks", "build_scene_bank", "draw_synth",
           "synthesize_batch"]

_MAX_COMPANIONS = max(len(v) for v in ADD_OBJS.values())  # 8


@dataclasses.dataclass(frozen=True)
class DeviceSynthStatic:
    """Static synthesis parameters, from ``SynthConfig``."""
    jitter: float = 0.1
    shift: int = 80
    pixel_threshold: float = 200.0 / 255.0
    max_intersection: float = 0.2
    attempts: int = 30           # parallel proposals per companion; at the
    num_keypoints: int = 9       # host's max_attempts (30) the drop law
    max_num_gt: int = 50         # (1−p)^attempts is the host's
    propose_scale: int = 1       # the overlap test's resolution divisor: 1
                                 # is the host's full-resolution ratio; the
                                 # winner is always resampled at full
                                 # resolution

    @classmethod
    def from_config(cls, cfg: SynthConfig, attempts: Optional[int] = None,
                    propose_scale: int = 4) -> "DeviceSynthStatic":
        """``attempts=None`` → ``cfg.max_attempts`` (the host's drop law)."""
        if cfg.flip != "off":
            raise ValueError(
                f"device_synth implements flip='off' only (got "
                f"{cfg.flip!r}); use the host backend for flip='reference'")
        return cls(jitter=cfg.jitter, shift=cfg.shift,
                   pixel_threshold=cfg.pixel_threshold / 255.0,
                   max_intersection=cfg.max_intersection,
                   attempts=cfg.max_attempts if attempts is None else attempts,
                   num_keypoints=cfg.num_keypoints,
                   max_num_gt=cfg.max_num_gt, propose_scale=propose_scale)


class DeviceSceneBank(NamedTuple):
    """Device-resident LINEMOD corpus: every train frame, mask and label row
    (tensors; placed with :meth:`device_put`):

      images (N, H, W, 3) u8   masks (N, H, W) u8   labels (N, 2K+3) f32
      obj_start/obj_count (13,) i32 — per-class contiguous frame ranges
      companions (14, 8) i32    — ADD_OBJS as class ids, −1 padded; row 13
                                  is an all −1 sentinel for base frames
                                  outside the OCCLUSION class set
      bgs (NB, H, W, 3) u8      — pre-resized backgrounds (≥1 row; zeros
                                  when no backgrounds were given)
      base_index/base_class (len(ds),) i32 — dataset line → bank row/class
    """
    images: torch.Tensor
    masks: torch.Tensor
    labels: torch.Tensor
    obj_start: torch.Tensor
    obj_count: torch.Tensor
    companions: torch.Tensor
    bgs: torch.Tensor
    base_index: torch.Tensor
    base_class: torch.Tensor

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]     # (H, W)

    def device_put(self, device="cuda", group=None) -> "DeviceSceneBank":
        """The bank on ``device``, after the memory preflight
        (:func:`~singleshotpose_tpu_torch.utils.memory.check_hbm_budget`;
        ``group``: every rank of its grid places a bank, each card charged
        for all of its ranks')."""
        from ..utils.memory import check_hbm_budget
        device = torch.device(device)
        check_hbm_budget(self.nbytes(), "device_synth scene bank",
                         device=device, group=group)
        return DeviceSceneBank(*(t.to(device) for t in self))

    def nbytes(self) -> int:
        """The bytes of the frames, masks, labels and backgrounds, from the
        tensors' metadata alone."""
        return sum(t.numel() * t.element_size() for t in
                   (self.images, self.masks, self.labels, self.bgs))


def _load_frame(path: str, num_keypoints: int, decode) -> Tuple[
        np.ndarray, np.ndarray, np.ndarray]:
    """(image u8 HWC, mask u8 HW, first label row f32) for one frame."""
    img = np.asarray(decode(path), np.uint8)
    mask = np.asarray(decode(mask_path_from_image(path)))
    if mask.ndim == 3:
        mask = mask.max(-1)
    mask = mask.astype(np.uint8)
    nl = 2 * num_keypoints + 3
    row = np.zeros(nl, np.float32)
    labpath = label_path_from_image(path)
    if os.path.exists(labpath) and os.path.getsize(labpath):
        truths = read_truths(labpath, num_keypoints)
        if truths.size:
            row = truths.reshape(-1, nl)[0].astype(np.float32)
    return img, mask, row


def build_scene_bank(cfg: SynthConfig, base_paths: Sequence[str],
                     bg_paths: Sequence[str] = (), *,
                     decode=None,
                     max_frames_per_obj: Optional[int] = None,
                     max_backgrounds: int = 256) -> DeviceSceneBank:
    """Decode the corpus once on the host and assemble the bank (CPU
    tensors; call ``.device_put()`` to park it on the card).

    ``base_paths``: the training list (each line a LINEMOD single frame);
    every base frame is in the bank, even if absent from its object's
    ``train.txt``.  Per-object companion pools come from
    ``<linemod_root>/<obj>/train.txt``, as the host synthesizer reads them;
    a missing object gets an empty pool.
    """
    from .pipeline import load_image
    decode = decode or load_image

    pools: Dict[str, List[str]] = {}
    base = os.path.dirname(cfg.linemod_root.rstrip("/"))
    for obj in OCCLUSION_CLASSES:
        path = os.path.join(cfg.linemod_root, obj, "train.txt")
        try:
            with open(path) as f:
                lines = [ln.strip() for ln in f if ln.strip()]
        except FileNotFoundError:
            pools[obj] = []
            continue
        lines = [ln if os.path.isabs(ln) else os.path.join(base, ln)
                 for ln in lines]
        if max_frames_per_obj is not None:
            lines = lines[:max_frames_per_obj]
        pools[obj] = lines

    # the union of the pools and the base paths, contiguous per object
    index: Dict[str, int] = {}
    frames: List[str] = []
    obj_start = np.zeros(len(OCCLUSION_CLASSES), np.int32)
    obj_count = np.zeros(len(OCCLUSION_CLASSES), np.int32)
    for ci, obj in enumerate(OCCLUSION_CLASSES):
        obj_start[ci] = len(frames)
        for p in pools[obj]:
            if p not in index:
                index[p] = len(frames)
                frames.append(p)
        obj_count[ci] = len(frames) - obj_start[ci]
        if obj_count[ci] == 0:
            # an empty class: its (never accepted) range parked at row 0,
            # so no index reaches one past the end of the bank
            obj_start[ci] = 0
    for p in base_paths:
        ap = os.path.abspath(p)
        if ap not in index and p not in index:
            index[p] = len(frames)
            frames.append(p)

    imgs, msks, rows = [], [], []
    shape = None
    for p in frames:
        img, mask, row = _load_frame(p, cfg.num_keypoints, decode)
        if shape is None:
            shape = img.shape
        elif img.shape != shape:
            raise ValueError(
                f"bank frames must share one native size; {p} is "
                f"{img.shape} vs {shape} (LINEMOD is uniformly 640x480)")
        imgs.append(img)
        msks.append(mask)
        rows.append(row)
    if not frames:
        raise ValueError("empty scene bank: no train frames found")
    H, W = shape[:2]

    # a sentinel row of −1s at the end: a base frame whose directory is not
    # an OCCLUSION class gets no companions (the host synthesizer's
    # ADD_OBJS.get(obj, ()))
    comp = np.full((len(OCCLUSION_CLASSES) + 1, _MAX_COMPANIONS), -1,
                   np.int32)
    cls_of = {o: i for i, o in enumerate(OCCLUSION_CLASSES)}
    for obj, names in ADD_OBJS.items():
        for j, n in enumerate(names):
            comp[cls_of[obj], j] = cls_of[n]

    base_index = np.array(
        [index[p if p in index else os.path.abspath(p)]
         for p in base_paths], np.int32)
    base_class = np.zeros(len(base_paths), np.int32)
    for i, p in enumerate(base_paths):
        obj = os.path.basename(os.path.dirname(os.path.dirname(p)))
        base_class[i] = cls_of.get(obj, len(OCCLUSION_CLASSES))

    if bg_paths:
        # a seeded sample, not the first N: the host draws from the whole
        # background list per scene
        sel = list(bg_paths)
        if len(sel) > max_backgrounds:
            pick = np.random.RandomState(0).choice(
                len(sel), max_backgrounds, replace=False)
            sel = [sel[i] for i in sorted(pick)]
        bgs = np.stack([resize_nearest(
            np.asarray(decode(p), np.uint8), W, H) for p in sel])
    else:
        bgs = np.zeros((1, H, W, 3), np.uint8)

    return DeviceSceneBank(*(torch.from_numpy(a) for a in (
        np.stack(imgs), np.stack(msks), np.stack(rows, 0).astype(np.float32),
        obj_start, obj_count, comp, bgs, base_index, base_class)))


class SynthDraws(NamedTuple):
    """A batch's random integers (int64 tensors on the bank's device).

      base_crop (B, 4)       — the base frame's crop: pleft, ptop, swidth,
                               sheight
      shift (B, 2)           — the base frame's roll: x, y
      perm (B, 8)            — the order of the companion slots
      bg (B,)                — the background row
      offset (B, 8, A)       — each proposal's frame within its class's
                               range (slot order, after ``perm``)
      crop (B, 8, A, 4)      — each proposal's crop, as ``base_crop``
    """
    base_crop: torch.Tensor
    shift: torch.Tensor
    perm: torch.Tensor
    bg: torch.Tensor
    offset: torch.Tensor
    crop: torch.Tensor


def _slot_classes(bank: DeviceSceneBank, base_cls: torch.Tensor,
                  perm: torch.Tensor) -> torch.Tensor:
    """(B, 8) companion class ids in slot order (−1: an empty slot)."""
    return bank.companions[base_cls].long().gather(1, perm)


def draw_synth(generator: torch.Generator, B: int, bank: DeviceSceneBank,
               base_cls: torch.Tensor, st: DeviceSynthStatic, W: int,
               H: int) -> SynthDraws:
    """Draw a batch of ``B`` scenes' integers with ``generator`` (on the
    bank's device), from the ranges the JAX package draws from: four
    independent crop offsets U{−d..d} per crop (d = ⌊size·jitter⌋), the
    shift U{−shift..shift}, a uniform permutation of the 8 slots, the
    background U{0..NB−1}, and each proposal's frame U{0..n−1} in its
    class's n frames (n ≥ 1).  ``base_cls``: (B,) the base frames' class
    ids (``bank.base_class`` at the dataset lines)."""
    dev = bank.images.device
    A = st.attempts

    def ints(lo: int, hi: int, *shape) -> torch.Tensor:
        return torch.randint(lo, hi, shape, generator=generator, device=dev)

    def crops(*shape) -> torch.Tensor:
        dw, dh = max(int(W * st.jitter), 0), max(int(H * st.jitter), 0)
        pleft, pright = ints(-dw, dw + 1, *shape), ints(-dw, dw + 1, *shape)
        ptop, pbot = ints(-dh, dh + 1, *shape), ints(-dh, dh + 1, *shape)
        return torch.stack([pleft, ptop, W - pleft - pright,
                            H - ptop - pbot], -1)

    base_crop = crops(B)
    shift = ints(-st.shift, st.shift + 1, B, 2)
    perm = torch.rand(B, _MAX_COMPANIONS, generator=generator,
                      device=dev).argsort(1)
    bg = ints(0, bank.bgs.shape[0], B)
    # an empty slot (−1) draws from class 0's range; it is never pasted
    cls = _slot_classes(bank, base_cls.long(), perm).clamp(min=0)
    n = bank.obj_count[cls].long().clamp(min=1)
    offset = ints(0, 2 ** 31 - 1, B, _MAX_COMPANIONS, A) % n[..., None]
    return SynthDraws(base_crop, shift, perm, bg, offset,
                      crops(B, _MAX_COMPANIONS, A))


def _unit(levels: torch.Tensor) -> torch.Tensor:
    """u8 levels in [0, 1], as JAX's compiled ``/ 255.0``: times
    f32(1/255)."""
    return levels.float() * INV255


def _crop_index(crop: torch.Tensor, ih: int, iw: int, out_w: int,
                out_h: int, roll: Optional[torch.Tensor] = None):
    """Where output (y, x) reads its source frame for crops ``crop`` (N, 4)
    nearest-resized to (out_h, out_w), then rolled by ``roll`` (N, 2) (x, y)
    when given: (rows (N, out_h), columns (N, out_w), inside (N, out_h,
    out_w)) as ``device_augment.crop_index`` gives them."""
    rows, cols, inside = crop_index(crop.t().float(), ih, iw, out_w, out_h)
    if roll is not None:
        # jnp.roll: output (y, x) reads (y − shift_y, x − shift_x), wrapped
        ry = (torch.arange(out_h, device=crop.device)[None, :]
              - roll[:, 1:2]) % out_h
        rx = (torch.arange(out_w, device=crop.device)[None, :]
              - roll[:, 0:1]) % out_w
        rows, cols = rows.gather(1, ry), cols.gather(1, rx)
        inside = inside.gather(1, ry[:, :, None].expand_as(inside)).gather(
            2, rx[:, None, :].expand_as(inside))
    return rows, cols, inside


def _read(src: torch.Tensor, which: torch.Tensor, index) -> torch.Tensor:
    """``src[which[n]]`` read at ``index`` (:func:`_crop_index`): (N,
    out_h, out_w, ...) of ``src``'s dtype, 0 where a read falls outside the
    frame."""
    rows, cols, inside = index
    v = gather(src, which, rows, cols)
    return torch.where(inside.view(inside.shape + (1,) * (v.dim() - 3)), v,
                       0)


def _blend(fg: torch.Tensor, alpha: torch.Tensor, bg: torch.Tensor
           ) -> torch.Tensor:
    """``fg·alpha + bg·(1 − alpha)``, the first product fused into the
    sum as XLA's CPU compiler contracts it."""
    return fma(fg, alpha, bg * (1.0 - alpha))


def binary_masks(bank: DeviceSceneBank) -> bool:
    """Whether every mask value of ``bank`` is 0 or 255 (LINEMOD's PNG
    masks and the shaded renders are); a bank on the card is read back to
    answer, so ask it of the host bank."""
    m = bank.masks
    return bool(((m == 0) | (m == 255)).all())


def _transform_rows(rows: torch.Tensor, crop: torch.Tensor, W: int, H: int,
                    K: int, shift: Optional[torch.Tensor] = None,
                    out_w: int = 1, out_h: int = 1) -> torch.Tensor:
    """The label rows (B, 2K+3) of frames cropped by ``crop`` (B, 4) (and
    rolled by ``shift`` (B, 2)): ``x' = x·(1/sx) − dx`` with ``sx = swidth/W``
    and ``dx = (pleft/W)/sx`` (less ``shift_x/out_w``), the centroid clamped
    to [0, 0.999], the 2D extents recomputed; a zero source row stays
    zero."""
    crop = crop.float()
    out = torch.zeros_like(rows)
    out[:, 0] = rows[:, 0]
    for first, size, n_out, c0, c1 in ((1, W, out_w, 0, 2),
                                       (2, H, out_h, 1, 3)):
        s = crop[:, c1] * recip(size)
        d = crop[:, c0] * recip(size) / s
        if shift is not None:
            d = fma(-shift[:, c0].float(), torch.full_like(d, recip(n_out)),
                    d)
        v = fma(rows[:, first:2 * K + 1:2], torch.reciprocal(s)[:, None],
                -d[:, None])
        v[:, 0] = v[:, 0].clamp(0.0, 0.999)
        out[:, first:2 * K + 1:2] = v
        out[:, 2 * K + first] = v.amax(1) - v.amin(1)
    real = (rows[:, 1:2 * K + 1] != 0).any(1, keepdim=True)
    return torch.where(real, out, 0.0)


def synthesize_batch(bank: DeviceSceneBank, base_idx, draws: SynthDraws, *,
                     out_w: int, out_h: int, st: DeviceSynthStatic,
                     binary: bool = False, rows: Optional[slice] = None):
    """A batch of composite scenes on the bank's device, from ``draws``
    (:func:`draw_synth`).

    Args:
      bank: a :class:`DeviceSceneBank` (on the card after ``device_put``).
      base_idx: (B,) indices into ``bank.base_index`` (dataset lines), a
        tensor or a numpy array.
      binary: every mask value is 0 or 255 (:func:`binary_masks`).  Every
        composite is then a select, and the scene is composited on u8
        levels, scaled to [0, 1] once at the end: the bits of the f32
        composite, in a fraction of its passes.
      rows: only these scenes of the batch (a data-parallel rank's,
        ``parallel.sharding.batch_rows``), from those rows of ``base_idx``
        and of every field of ``draws``: every scene is computed alone, so
        they are those rows of the whole batch, bit for bit.
    Returns (images (B, out_h, out_w, 3) f32 in [0, 1], labels (B,
    max_num_gt·(2K+3)) f32).
    """
    if rows is not None:
        base_idx = base_idx[rows]
        draws = SynthDraws(*(d[rows] for d in draws))
    ps = st.propose_scale
    if out_w % ps or out_h % ps:
        raise ValueError(f"propose_scale={ps} must divide the scene size "
                         f"({out_w}x{out_h})")
    dev = bank.images.device
    H, W = bank.frame_shape
    N = bank.images.shape[0]
    K, nl = st.num_keypoints, 2 * st.num_keypoints + 3
    thr = st.pixel_threshold
    base_idx = torch.as_tensor(np.asarray(base_idx) if not isinstance(
        base_idx, torch.Tensor) else base_idx).to(dev).long()
    B, A = base_idx.shape[0], st.attempts
    if tuple(draws.offset.shape) != (B, _MAX_COMPANIONS, A):
        raise ValueError(f"draws for {tuple(draws.offset.shape)} proposals, "
                         f"not ({B}, {_MAX_COMPANIONS}, {A})")
    every = torch.arange(B, device=dev)
    rows = bank.base_index[base_idx].long()
    # the companion row comes from the dataset line's class, not the bank
    # row's: the two index spaces differ
    cls = bank.base_class[base_idx].long()

    # ---- base frame: crop-jitter + resize + wrap-around shift ------------
    index = _crop_index(draws.base_crop, H, W, out_w, out_h, draws.shift)
    img_l = _read(bank.images, rows, index)
    mask_l = _read(bank.masks, rows, index)[..., None]
    if binary:
        # levels: the base where its mask is set, and the coverage
        canvas, total = torch.where(mask_l == 255, img_l, 0), mask_l
    else:
        img_s, mask_s = _unit(img_l), _unit(mask_l)
        base_masked = img_s * mask_s
        canvas, total = base_masked, mask_s
    count = torch.ones(B, dtype=torch.int64, device=dev)

    # the overlap test on u8 levels: a level passes where its value in
    # [0, 1] is above the threshold (the same f32 comparison, on the host:
    # a read from the card would wait for its queue)
    thr_level = int((_unit(torch.arange(256)) > thr).to(torch.uint8).argmax())
    slot_cls = _slot_classes(bank, cls, draws.perm)
    cw, ch = out_w // ps, out_h // ps
    winners, crops_won, writes = [], [], []

    # ---- companions: A proposals each, the first acceptable one wins ------
    for s in range(_MAX_COMPANIONS):
        c = slot_cls[:, s]
        c0 = c.clamp(min=0)
        fis = (bank.obj_start[c0].long()[:, None]
               + draws.offset[:, s]).clamp(0, N - 1)             # (B, A)
        crops = draws.crop[:, s]                                 # (B, A, 4)
        coarse = _read(bank.masks, fis.reshape(-1),
                       _crop_index(crops.reshape(-1, 4), H, W, cw, ch))
        xx = (coarse >= thr_level).view(B, A, ch, cw)
        # the running coverage at the coarse cells' centres (exact when
        # propose_scale is 1)
        covered = total[:, ps // 2::ps, ps // 2::ps, 0]
        occupied = covered >= thr_level if binary else covered > thr
        area = xx.sum((2, 3)).float()
        inter = (xx & occupied[:, None]).sum((2, 3)).float()
        ok = (area >= 1.0) & (inter / area.clamp(min=1.0)
                              < st.max_intersection)
        win = ok.to(torch.uint8).argmax(1)                  # first acceptable
        found = ok.any(1) & (c >= 0) & (bank.obj_count[c0] > 0)

        fi = fis[every, win]
        crop = crops[every, win]
        index = _crop_index(crop, H, W, out_w, out_h)
        om = _read(bank.masks, fi, index)[..., None]
        oi = _read(bank.images, fi, index)
        keep = found[:, None, None, None]
        if binary:
            paste = keep & (om == 255)
            canvas = torch.where(paste, oi, canvas)
            total = torch.where(paste, 255, total)
        else:
            # floor(img·mask/255), the host's mask_foreground truncation
            omask_r = _unit(om)
            omasked_r = _unit((oi.int() * om.int()) // 255)
            rest = 1.0 - omask_r
            canvas = torch.where(keep, fma(canvas, rest, omasked_r * omask_r),
                                 canvas)
            total = torch.where(keep, fma(total, rest, omask_r).clamp(0.0, 1.0),
                                total)
        write = found & (count < st.max_num_gt)
        winners.append(fi)
        crops_won.append(crop)
        writes.append(write)
        count = count + write.long()

    # ---- labels: the base's, then each pasted companion's in slot order ---
    labels = torch.zeros((B, st.max_num_gt + 1, nl), dtype=torch.float32,
                         device=dev)
    labels[:, 0] = _transform_rows(bank.labels[rows], draws.base_crop, W, H,
                                   K, draws.shift, out_w, out_h)
    fi = torch.stack(winners, 1).reshape(-1)
    won = _transform_rows(bank.labels[fi], torch.stack(crops_won, 1)
                          .reshape(-1, 4), W, H, K).view(B, -1, nl)
    write = torch.stack(writes, 1)
    # a written row goes to the next free slot; the rest to a spare row
    slot = torch.where(write, write.long().cumsum(1), st.max_num_gt)
    labels[every[:, None], slot] = won
    labels = labels[:, :st.max_num_gt]

    # ---- the base re-pasted last, the background behind everything --------
    whole = torch.zeros((B, 4), dtype=torch.int64, device=dev)
    whole[:, 2], whole[:, 3] = W, H
    bg_l = _read(bank.bgs, draws.bg.long(),
                 _crop_index(whole, H, W, out_w, out_h))
    if binary:
        scene = torch.where(total == 255, torch.where(mask_l == 255, img_l,
                                                      canvas), bg_l)
        return _unit(scene), labels.reshape(B, -1)
    canvas = _blend(base_masked, mask_s, canvas)
    return _blend(canvas, total, _unit(bg_l)), labels.reshape(B, -1)
