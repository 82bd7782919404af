"""Host data pipeline: dataset, multi-scale schedule, thread-pooled loader.

The port's own copy of ``singleshotpose_tpu/data/pipeline.py``, cut to what
the single-object drivers run, so the port imports nothing of the JAX
package; ``tests/test_torch_host.py`` holds its batches equal, bit for bit,
to the JAX package's ``Loader(backend="python")``.  Left out: the
scene-synthesis hook, the decoded-image cache, the native C++ decoder's
sampling plan and the ``native``/``device``/``device_bank``/``device_synth``
backends with their ``out_yuv420`` and ``mesh`` options — the loader here
has the Python backend only, and a caller that passes one of those options
gets a ``TypeError``.

Rebuild of ``listDataset`` + torch ``DataLoader`` (reference:
``dataset.py:14-141``, ``train.py:56-65``):

  * the multi-scale schedule is a pure function of a single authoritative
    ``seen`` counter owned by the loader — the reference instead lets every
    DataLoader worker bump a private copy by ``num_workers`` per sample
    (``dataset.py:138``), racy-by-design; here the schedule is deterministic
    given (seen, rng).
  * widths are drawn from the same staged 32-px buckets
    (``dataset.py:66-90``).
  * samples are decoded/augmented by a thread pool (PIL/numpy release the
    GIL for the heavy parts) and batches are yielded as host numpy.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np

from ..utils.labels import (label_path_from_image, mask_path_from_image,
                            read_truths, read_truths_args)
from . import augment

__all__ = ["MultiScaleSchedule", "SINGLE_SCHEDULE", "AugmentConfig",
           "PoseDataset", "Loader", "load_image"]


def load_image(path: str) -> np.ndarray:
    """Decode an image file to RGB uint8 (H,W,3)."""
    from PIL import Image
    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))


# ---------------------------------------------------------------------------
# multi-scale schedule
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MultiScaleSchedule:
    """Staged random input widths in ``cell_size`` multiples.

    ``stages`` = ((epoch_limit, base_cells, span_cells), ...) — while
    ``seen < limit·nbatches·batch_size`` the width is
    ``(base + U{0..span})·cell_size``; the last stage is open-ended.
    """
    stages: Tuple[Tuple[int, int, int], ...]
    cell_size: int = 32

    def draw(self, rng: np.random.RandomState, seen: int, nbatches: int,
             batch_size: int) -> int:
        for limit, base, span in self.stages[:-1]:
            if seen < limit * nbatches * batch_size:
                return (base + (rng.randint(0, span + 1) if span else 0)) \
                    * self.cell_size
        _, base, span = self.stages[-1]
        return (base + (rng.randint(0, span + 1) if span else 0)) * self.cell_size

    @property
    def all_widths(self) -> Tuple[int, ...]:
        ws = set()
        for _, base, span in self.stages:
            for k in range(span + 1):
                ws.add((base + k) * self.cell_size)
        return tuple(sorted(ws))


# reference: dataset.py:66-90 — 416 fixed, then progressively wider brackets
SINGLE_SCHEDULE = MultiScaleSchedule((
    (10, 13, 0), (20, 13, 7), (30, 12, 9), (40, 11, 11),
    (50, 10, 13), (60, 9, 15), (70, 8, 17), (0, 7, 19)))


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    jitter: float = 0.2      # reference hard-codes these (dataset.py:94-97)
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5


class PoseDataset:
    """Image-list dataset (one line per image path).

    Train mode: VOC background substitution via the object mask + crop-jitter
    + HSV distortion, labels transformed accordingly.  Test mode: resize
    only, labels read raw into the padded 50-slot tensor.
    """

    def __init__(self, listfile: str, *, train: bool,
                 bg_file_names: Optional[Sequence[str]] = None,
                 aug: AugmentConfig = AugmentConfig(),
                 num_keypoints: int = 9, max_num_gt: int = 50,
                 label_path_fn: Callable[[str], str] = label_path_from_image):
        with open(listfile) as f:
            self.lines = [ln.strip() for ln in f if ln.strip()]
        self.train = train
        self.bg_file_names = list(bg_file_names or [])
        self.aug = aug
        self.num_keypoints = num_keypoints
        self.max_num_gt = max_num_gt
        self.label_path_fn = label_path_fn

    def __len__(self) -> int:
        return len(self.lines)

    def _read_truths_full(self, imgpath: str) -> np.ndarray:
        """(n, 2K+3) rows for training (reference reads all 21 fields,
        ``image.py:81-84``)."""
        labpath = self.label_path_fn(imgpath)
        if os.path.exists(labpath) and os.path.getsize(labpath):
            return read_truths(labpath, self.num_keypoints)
        return np.zeros((0,), np.float32)

    def _read_truths_test(self, imgpath: str) -> np.ndarray:
        """Flat [class, x0..y8] per object — the reference test path drops
        the trailing x/y-range fields (``dataset.py:121``→``utils.py:309``)."""
        labpath = self.label_path_fn(imgpath)
        if os.path.exists(labpath) and os.path.getsize(labpath):
            return read_truths_args(labpath, self.num_keypoints)
        return np.zeros((0,), np.float32)

    def get_test_label(self, index: int) -> np.ndarray:
        """Flat padded label tensor for the test path.

        Divergence (reference bug not copied): the reference packs truncated
        19-field rows CONTIGUOUSLY into the 21-stride tensor
        (``dataset.py:121-127``) and then reads them back at stride 21
        (``valid.py:124``) — correct only because its test label files
        happen to contain exactly one object.  Here each 19-field row is
        padded to the 21-float stride (trailing extent fields 0), so
        multi-GT test frames decode correctly; single-GT frames are
        bit-identical.
        """
        K = self.num_keypoints
        nl = 2 * K + 3
        truths = self._read_truths_test(self.lines[index]).reshape(-1)
        label = np.zeros((self.max_num_gt, nl), np.float32)
        if truths.size:
            rows = truths.reshape(-1, 2 * K + 1)[:self.max_num_gt]
            label[:rows.shape[0], :2 * K + 1] = rows
        return label.reshape(-1)

    def get_test(self, index: int, shape: Tuple[int, int]):
        """(img f32 HWC in [0,1], flat padded label) at fixed test shape."""
        img = load_image(self.lines[index])
        w, h = shape
        img = augment.resize_nearest(img, w, h)
        return img.astype(np.float32) / 255.0, self.get_test_label(index)

    def get_train(self, index: int, shape: Tuple[int, int],
                  rng: np.random.RandomState, as_uint8: bool = False):
        """One augmented train sample.  ``as_uint8`` skips the final /255
        (the augmentation pipeline is uint8 throughout) so batches transfer
        at 1/4 the bytes and normalize on device — bit-identical values."""
        imgpath = self.lines[index]
        img = load_image(imgpath)
        mask = load_image(mask_path_from_image(imgpath))
        if self.bg_file_names:
            bg = load_image(
                self.bg_file_names[rng.randint(len(self.bg_file_names))])
            img = augment.change_background(img, mask, bg)
        w, h = shape
        img, _flip, dx, dy, sx, sy = augment.data_augmentation(
            rng, img, w, h, self.aug.jitter, self.aug.hue,
            self.aug.saturation, self.aug.exposure)
        truths = self._read_truths_full(imgpath)
        label = augment.transform_truths(truths, dx, dy, 1.0 / sx, 1.0 / sy,
                                         self.num_keypoints, self.max_num_gt)
        if as_uint8:
            return np.ascontiguousarray(img, np.uint8), label
        return img.astype(np.float32) / 255.0, label


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


class Loader:
    """Batched, shuffled, thread-pooled iterator over a PoseDataset.

    One authoritative ``seen`` counter drives the multi-scale schedule; each
    batch uses a single width so the stacked array is rectangular.  Yields
    (images (B,H,W,3) f32 — or u8 with ``out_uint8`` —, labels
    (B, 50·(2K+3)) f32).
    """

    def __init__(self, dataset: PoseDataset, batch_size: int, *,
                 shuffle: bool = True, seen: int = 0,
                 schedule: Optional[MultiScaleSchedule] = SINGLE_SCHEDULE,
                 fixed_shape: Optional[Tuple[int, int]] = None,
                 num_workers: int = 8, seed: int = 0,
                 drop_last: bool = True, out_uint8: bool = False):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seen = seen
        self.schedule = schedule
        self.fixed_shape = fixed_shape
        self.rng = np.random.RandomState(seed)
        self.pool = ThreadPoolExecutor(max_workers=num_workers) \
            if num_workers > 0 else None
        self.drop_last = drop_last
        # yield uint8 images (normalized on the device): 4x lighter
        # host→device copies, bit-identical values (u8/255 either side)
        self.out_uint8 = out_uint8

    @property
    def nbatches(self) -> int:
        return len(self.ds) // self.batch_size

    def _batch_shape(self) -> Tuple[int, int]:
        if self.fixed_shape is not None or not self.ds.train:
            if self.fixed_shape is None:
                raise ValueError("test-mode Loader requires fixed_shape")
            return self.fixed_shape
        w = self.schedule.draw(self.rng, self.seen, max(self.nbatches, 1),
                               self.batch_size)
        return (w, w)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            self.rng.shuffle(order)
        end = self.nbatches * self.batch_size if self.drop_last else len(order)
        for start in range(0, end, self.batch_size):
            idxs = order[start:start + self.batch_size]
            shape = self._batch_shape()
            if self.ds.train:
                seeds = self.rng.randint(0, 2 ** 31 - 1, size=len(idxs))
                def one(args):
                    i, s = args
                    return self.ds.get_train(int(i), shape,
                                             np.random.RandomState(int(s)),
                                             as_uint8=self.out_uint8)
                work = list(zip(idxs, seeds))
            else:
                def one(i):
                    img, lab = self.ds.get_test(int(i), shape)
                    if self.out_uint8:
                        img = (img * 255.0).astype(np.uint8)
                    return img, lab
                work = list(idxs)

            if self.pool is not None:
                results = list(self.pool.map(one, work))
            else:
                results = [one(wk) for wk in work]
            imgs = np.stack([r[0] for r in results])
            labels = np.stack([r[1] for r in results])
            self.seen += len(idxs)
            yield imgs, labels
