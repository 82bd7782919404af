"""Label-file codec and path-derivation rules.

The port's own copy of the functions of ``singleshotpose_tpu/utils/labels.py``
that its loader and training driver call (plain Python and numpy), so the
port imports nothing of the JAX package; ``tests/test_torch_host.py`` holds
them equal to the originals.

Reference semantics: 21 floats per object — class, x0 y0 (centroid), x1..y8
(8 corners), x-range, y-range, all normalized by image W/H
(``label_file_creation.md:1-13``, readers ``utils.py:299-315``).  Paths are
derived from image paths by string substitution (``dataset.py:116``,
``image.py:130-131``).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["num_label_floats", "label_path_from_image", "mask_path_from_image",
           "read_truths", "read_truths_args", "get_all_files"]


def num_label_floats(num_keypoints: int = 9) -> int:
    """class + 2K coords + x-range + y-range."""
    return 2 * num_keypoints + 3


def label_path_from_image(imgpath: str) -> str:
    """images→labels, JPEGImages→labels, .jpg/.png→.txt (``dataset.py:116``)."""
    return (imgpath.replace("images", "labels")
            .replace("JPEGImages", "labels")
            .replace(".jpg", ".txt").replace(".png", ".txt"))


def mask_path_from_image(imgpath: str) -> str:
    """JPEGImages→mask, '/00'→'/', .jpg→.png (``image.py:131``)."""
    return (imgpath.replace("JPEGImages", "mask")
            .replace("/00", "/").replace(".jpg", ".png"))


def read_truths(lab_path: str, num_keypoints: int = 9) -> np.ndarray:
    """(nGT, 2K+3) float array; empty (0,) array for empty files
    (reference: ``utils.py:299-307``)."""
    nl = num_label_floats(num_keypoints)
    if os.path.getsize(lab_path):
        truths = np.loadtxt(lab_path)
        return truths.reshape(truths.size // nl, nl)
    return np.array([])


def read_truths_args(lab_path: str, num_keypoints: int = 9) -> np.ndarray:
    """Flat per-object [class, x0..y8] (first 2K+1 fields of each row),
    concatenated (reference: ``utils.py:309-315``)."""
    nl = 2 * num_keypoints + 1
    truths = read_truths(lab_path, num_keypoints)
    if truths.size == 0:
        return np.array([])
    return truths[:, :nl].reshape(-1)


def get_all_files(directory: str):
    """Recursive file listing (reference: ``utils.py:21-29``)."""
    files = []
    for f in sorted(os.listdir(directory)):
        p = os.path.join(directory, f)
        if os.path.isfile(p):
            files.append(p)
        else:
            files.extend(get_all_files(p))
    return files
