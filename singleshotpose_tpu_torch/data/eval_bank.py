"""Device-resident eval bank: the test split decoded ONCE into device memory.

The port's counterpart of ``singleshotpose_tpu/data/eval_bank.py``.  The
reference re-reads and re-decodes the full test split from disk on every
in-training eval epoch (reference: ``train.py:133-146`` rebuilds its
DataLoader each call; ``valid.py:94-101``).  Here the split is decoded and
resized once to eval-size u8 frames, parked on the card batch-major, and
every later eval pass is device compute alone: no host decode, no
per-frame copy.  Eval pixels are bit-identical to the ``transfer="rgb"``
path (the bank stores exactly the u8 batches that path would ship).

Memory: u8 at eval size — 416×416×3 = 0.52 MB a frame, so a 1k-frame
LINEMOD test split is ~0.5 GB.  A small LRU (``_CACHE_SLOTS = 8`` banks,
sized for the 6-object occlusion sweep) keeps repeat evals from rebuilding
while bounding the footprint.

Usage: ``run_validation(..., transfer="bank")`` (drivers.py) or
``TrainRunConfig.eval_transfer = "bank"`` for the in-training cadence,
where the decode cost amortizes across every eval epoch.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Hashable, Iterator, Tuple

import numpy as np
import torch

__all__ = ["EvalBank", "build_eval_bank", "get_eval_bank", "clear_cache"]


@dataclasses.dataclass
class EvalBank:
    """Device-resident eval batches.

    ``images``: (nbatches, B, H, W, 3) u8 on the device, batch-major so
    batch i is a leading-axis view.  ``labels``: (nbatches, B, 50·(2K+3))
    f32 on the HOST — the metric suite is host-side.  Frames past the true
    split length are zero rows; zero labels never enter the metrics (the GT
    gather masks on label[..., 1] != 0).
    """
    images: torch.Tensor
    labels: np.ndarray
    n: int                      # true frame count (<= nbatches*B)

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
        for i in range(self.images.shape[0]):
            yield self.images[i], self.labels[i]

    def nbytes(self) -> int:
        return self.images.numel()  # u8: 1 byte/element


def build_eval_bank(dataset, out_shape: Tuple[int, int], batch_size: int, *,
                    num_workers: int = 8, device="cuda") -> EvalBank:
    """Decode ``dataset`` (test mode) at ``out_shape`` into an EvalBank on
    ``device``.

    Decode reuses the Loader, so bank pixels are bit-identical to what
    ``transfer="rgb"`` would ship per batch.
    """
    from .pipeline import Loader

    if dataset.train:
        raise ValueError("EvalBank is a test-mode construct")
    loader = Loader(dataset, batch_size, shuffle=False, schedule=None,
                    fixed_shape=out_shape, num_workers=num_workers,
                    drop_last=False, out_uint8=True)
    imgs, labs = [], []
    for im, lb in loader:
        imgs.append(im)
        labs.append(lb)
    if not imgs:
        raise ValueError("empty eval dataset")
    images = np.concatenate(imgs, axis=0)
    labels = np.concatenate(labs, axis=0).astype(np.float32)
    n = images.shape[0]
    pad = (-n) % batch_size
    if pad:
        images = np.concatenate(
            [images, np.zeros((pad,) + images.shape[1:], images.dtype)])
        labels = np.concatenate(
            [labels, np.zeros((pad,) + labels.shape[1:], labels.dtype)])
    nb = images.shape[0] // batch_size
    images = images.reshape((nb, batch_size) + images.shape[1:])
    labels = labels.reshape((nb, batch_size) + labels.shape[1:])
    return EvalBank(images=torch.from_numpy(images).to(device),
                    labels=labels, n=n)


# LRU of built banks: the in-training eval cadence calls run_validation with
# a fresh Loader every eval epoch; the bank must outlive the call.  8 slots
# cover the multi trainer's 6-object occlusion sweep (reference
# ``train_multi.py:277-297``) without thrash.  Lower the module variable (or
# ``clear_cache()``) if the budget is tight.
_CACHE: "OrderedDict[Hashable, EvalBank]" = OrderedDict()
_CACHE_SLOTS = 8


def get_eval_bank(dataset, out_shape: Tuple[int, int], batch_size: int, *,
                  cache_key: Hashable, num_workers: int = 8,
                  device="cuda") -> EvalBank:
    """LRU-cached :func:`build_eval_bank` (the key must capture the label
    source and the device too — the occlusion sweep reuses images under
    per-object labels)."""
    bank = _CACHE.get(cache_key)
    if bank is None:
        bank = build_eval_bank(dataset, out_shape, batch_size,
                               num_workers=num_workers, device=device)
        _CACHE[cache_key] = bank
        while len(_CACHE) > _CACHE_SLOTS:
            _CACHE.popitem(last=False)
    else:
        _CACHE.move_to_end(cache_key)
    return bank


def clear_cache() -> None:
    _CACHE.clear()
