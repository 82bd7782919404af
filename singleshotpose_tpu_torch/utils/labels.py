"""Label-file codec and path-derivation rules.

The port's own copy of ``singleshotpose_tpu/utils/labels.py`` (plain Python
and numpy), so the port imports nothing of the JAX package;
``tests/test_torch_host.py`` and ``tests/test_torch_host_api.py`` hold it
equal to the original.

Reference semantics: 21 floats per object — class, x0 y0 (centroid), x1..y8
(8 corners), x-range, y-range, all normalized by image W/H
(``label_file_creation.md:1-13``, readers ``utils.py:299-315``).  Paths are
derived from image paths by string substitution (``dataset.py:116``,
``image.py:130-131``).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = [
    "get_image_size",
    "num_label_floats",
    "label_path_from_image",
    "mask_path_from_image",
    "read_truths",
    "read_truths_args",
    "read_pose",
    "pack_test_labels",
    "get_all_files",
    "file_lines",
    "load_class_names",
]


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


def read_pose(lab_path: str) -> np.ndarray:
    """Raw loadtxt of a pose/label file (reference: ``utils.py:317-323``)."""
    if os.path.getsize(lab_path):
        return np.loadtxt(lab_path)
    return np.array([])


def pack_test_labels(truths_flat: np.ndarray, num_keypoints: int = 9,
                     max_num_gt: int = 50) -> np.ndarray:
    """Zero-padded test-label tensor of ``max_num_gt * (2K+3)`` floats.

    Mirrors the reference test path (``dataset.py:123-133``): the flattened
    (2K+1)-stride truths are copied verbatim into the front of a
    (2K+3)-stride-sized zero buffer.  (Yes — the strides differ; the eval
    consumer reads back with the 21-float stride, so objects beyond the first
    straddle field boundaries.  The reference behaves identically and LINEMOD
    test images have exactly one object, so slot 0 is always well-formed.)
    """
    nl = num_label_floats(num_keypoints)
    label = np.zeros(max_num_gt * nl, dtype=np.float32)
    t = np.asarray(truths_flat, dtype=np.float32).reshape(-1)
    n = min(t.size, label.size)
    label[:n] = t[:n]
    return label


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


def file_lines(path: str) -> int:
    """Newline count (reference: ``utils.py:391-400``)."""
    count = 0
    with open(path, "rb") as fp:
        while True:
            buf = fp.read(8192 * 1024)
            if not buf:
                break
            count += buf.count(b"\n")
    return count


def load_class_names(namesfile: str):
    with open(namesfile, "r") as fp:
        return [line.rstrip() for line in fp]


def get_image_size(fname: str):
    """(width, height) from the image header without a full decode
    (reference: ``utils.py:381-414``; PIL lazy-open reads only the header)."""
    from PIL import Image
    with Image.open(fname) as im:
        return im.size
