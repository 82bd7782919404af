"""On-device single-object augmentation from a device-resident frame bank.

The port's counterpart of ``singleshotpose_tpu/data/device_bank.py``.  The
single-object train pipeline (reference ``image.py:46-127`` via
``data/augment.py``) runs bg-composite → crop-jitter → HSV per sample.  The
``python`` backend does it on the host and the ``device`` backend on the
card from host-decoded frames, but both move every batch's native-size
pixels, so a weak host still bounds training throughput.

A LINEMOD object's train split is small (~190 frames × 640·480 ≈ 230 MB
with masks), so this backend **decodes the whole corpus once and parks it in
device memory** (:class:`DeviceFrameBank`, plus a seeded sample of VOC
backgrounds).  Each batch is then a function of (bank, indices, host-drawn
params): gather → crop-resize → composite → HSV → label transform, all on
the card, with no per-batch image traffic from the host.

Exactness: the images are **bit-identical to the ``device`` backend's**,
because the per-sample program is the device backend's: a hard u8 select
composite (LINEMOD masks are binary, so select ≡ the reference's alpha
blend), the same exact u8 gather, the same HSV chain.  The select commutes
with the gather, so the bank gathers image, mask and background at output
size and composites there.  Every intermediate before the HSV chain is an
exact integer.

Divergences (the ones the JAX package's bank carries):
  * crops are normalized affine samples, ≤1 px from PIL rounding
    (parity by metric),
  * backgrounds come from a seeded random sample of ``max_backgrounds``
    rows pre-resized to the frame size (the host draws from the full VOC
    list per sample); the host-drawn bg index is mapped onto the bank
    sample with a modulo, keeping the rng stream identical to the
    ``device`` backend's,
  * the label transform runs on the device in f32 as the JAX package's
    does, its multiply-subtract fused (:func:`device_augment.fma`); the host
    path computes the reciprocal scales in f64 before rounding.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.labels import mask_path_from_image
from .augment import resize_nearest
from .device_augment import (AugmentParams, augment_u8, crop_index, fma,
                             gather, params_on, recip, upload)

__all__ = ["DeviceFrameBank", "build_frame_bank", "augment_bank_batch"]


class DeviceFrameBank(NamedTuple):
    """Device-resident single-object train corpus (tensors; placed with
    :meth:`device_put`):

      images (N, H, W, 3) u8    masks (N, H, W) u8 (255 = keep foreground;
                                all-255 when no backgrounds were given, the
                                ``device`` backend's no-composite behavior)
      truths (N, max_num_gt, 2K+3) f32 — raw label rows at source coords
      n_rows (N,) i32           — real rows per frame (rest are zero pads)
      bgs (NB, H, W, 3) u8      — pre-resized backgrounds (≥1 row; zeros
                                when no backgrounds were given)
    """
    images: torch.Tensor
    masks: torch.Tensor
    truths: torch.Tensor
    n_rows: torch.Tensor
    bgs: torch.Tensor

    @property
    def frame_shape(self) -> Tuple[int, int]:
        return self.images.shape[1], self.images.shape[2]     # (H, W)

    def device_put(self, device="cuda", group=None) -> "DeviceFrameBank":
        """The bank on ``device``, after the memory preflight
        (:func:`~singleshotpose_tpu_torch.utils.memory.check_hbm_budget`;
        ``group``: every rank of its grid places a bank, each card charged
        for all of its ranks')."""
        from ..utils.memory import check_hbm_budget
        device = torch.device(device)
        check_hbm_budget(self.nbytes(), "device_bank frame bank",
                         device=device, group=group)
        return DeviceFrameBank(*(t.to(device) for t in self))

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.images, self.masks, self.truths, self.bgs))


def build_frame_bank(dataset, *, decode=None,
                     max_backgrounds: int = 256) -> DeviceFrameBank:
    """Decode a train ``PoseDataset``'s corpus once (host tensors; call
    ``.device_put()`` to park it on the card).

    Uses the dataset's own lines / label-path rule / max_num_gt, so the
    bank sees exactly what the host backends see.  ``decode`` (path → u8
    array) defaults to the PIL loader.
    """
    from .pipeline import load_image
    decode = decode or load_image

    K, max_gt = dataset.num_keypoints, dataset.max_num_gt
    nl = 2 * K + 3
    composite = bool(dataset.bg_file_names)

    imgs, msks = [], []
    truths = np.zeros((len(dataset.lines), max_gt, nl), np.float32)
    n_rows = np.zeros(len(dataset.lines), np.int32)
    shape = None
    for i, path in enumerate(dataset.lines):
        img = np.asarray(decode(path), np.uint8)
        if shape is None:
            shape = img.shape
        elif img.shape != shape:
            raise ValueError(
                f"bank frames must share one native size; {path} is "
                f"{img.shape} vs {shape} (LINEMOD is uniformly 640x480)")
        imgs.append(img)
        if composite:
            mask = np.asarray(decode(mask_path_from_image(path)))
            if mask.ndim == 3:
                # channel 0, as the device backend takes it (masks are
                # binary; channels are equal for real data)
                mask = mask[..., 0]
            msks.append(mask.astype(np.uint8))
        else:
            # no backgrounds → the device backend skips compositing by
            # forcing a full mask
            msks.append(np.full(img.shape[:2], 255, np.uint8))
        rows = dataset._read_truths_full(path)
        if rows.size:
            rows = rows.reshape(-1, nl)[:max_gt].astype(np.float32)
            truths[i, :rows.shape[0]] = rows
            n_rows[i] = rows.shape[0]
    if not imgs:
        raise ValueError("empty frame bank: dataset has no lines")
    H, W = shape[:2]

    if composite:
        sel = list(dataset.bg_file_names)
        if len(sel) > max_backgrounds:
            pick = np.random.RandomState(0).choice(
                len(sel), max_backgrounds, replace=False)
            sel = [sel[i] for i in sorted(pick)]
        bgs = np.stack([resize_nearest(
            np.asarray(decode(p), np.uint8), W, H) for p in sel])
    else:
        bgs = np.zeros((1, H, W, 3), np.uint8)

    return DeviceFrameBank(*(torch.from_numpy(a) for a in (
        np.stack(imgs), np.stack(msks), truths, n_rows, bgs)))


def _transform_rows(rows, n_rows, p, W: int, H: int, K: int):
    """Device ``augment.transform_truths`` as the JAX package computes it:
    ``x' = x·(1/sx) − dx`` per keypoint (multiply-subtract fused), centroid
    clamped to [0, 0.999], trailing extent fields untouched (single-object
    semantics — no recompute), pad rows zero.  ``rows`` (B, G, 2K+3); ``p``
    the (7, B) parameter rows."""
    sx = p[2] * recip(W)
    sy = p[3] * recip(H)
    dx = p[0] * recip(W) / sx
    dy = p[1] * recip(H) / sy
    out = rows.clone()
    for first, s, d in ((1, sx, dx), (2, sy, dy)):
        v = rows[:, :, first:2 * K + 1:2]
        inv = torch.reciprocal(s)[:, None, None].expand_as(v)
        v = fma(v, inv, -d[:, None, None])
        v[:, :, 0] = v[:, :, 0].clamp(0.0, 0.999)
        out[:, :, first:2 * K + 1:2] = v
    real = torch.arange(rows.shape[1], device=rows.device)[None, :] \
        < n_rows[:, None]
    return torch.where(real[..., None], out, 0.0)


def augment_bank_batch(bank: DeviceFrameBank, idxs, bg_idxs,
                       params: AugmentParams, *, out_w: int, out_h: int,
                       K: int = 9, rows: Optional[slice] = None):
    """One augmented train batch, on the bank's device.

    Args:
      bank: device-placed :class:`DeviceFrameBank`.
      idxs: (B,) frame rows; bg_idxs: (B,) background rows (numpy int
        arrays or tensors).
      params: host-drawn :class:`AugmentParams` (``draw_params`` — the same
        rng stream as the ``device`` backend).
      rows: only these rows of the batch (a data-parallel rank's,
        ``parallel.sharding.batch_rows``): every sample is computed alone,
        so they are those rows of the whole batch, bit for bit.
    Returns (images (B, out_h, out_w, 3) **uint8** — JAX's f32 batch is
    these levels times f32(1/255), bit for bit, what the train step computes
    from them —, labels (B, max_num_gt·(2K+3)) f32).
    """
    if rows is not None:
        idxs, bg_idxs = idxs[rows], bg_idxs[rows]
        params = AugmentParams(*(p[rows] for p in params))
    device = bank.images.device
    H, W = bank.frame_shape
    idxs, bg_idxs = (a.to(device).long() if isinstance(a, torch.Tensor)
                     else upload(np.asarray(a, np.int64), device)
                     for a in (idxs, bg_idxs))
    p = params_on(params, device)
    rows, cols, inside = crop_index(p, H, W, out_w, out_h)
    img = gather(bank.images, idxs, rows, cols)
    keep = gather(bank.masks, idxs, rows, cols) >= 128
    bg = gather(bank.bgs, bg_idxs, rows, cols)
    crop = torch.where((keep & inside)[..., None], img,
                       torch.where(inside[..., None], bg, 0))
    images = augment_u8(crop, p)
    labels = _transform_rows(bank.truths[idxs], bank.n_rows[idxs], p, W, H, K)
    return images, labels.reshape(labels.shape[0], -1)
