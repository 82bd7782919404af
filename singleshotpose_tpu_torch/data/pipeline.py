"""Host data pipeline: dataset, multi-scale schedule, thread-pooled loader.

The port's own copy of ``singleshotpose_tpu/data/pipeline.py``, so the port
imports nothing of the JAX package; ``tests/test_torch_host.py`` and
``tests/test_torch_multi_host.py`` hold its ``python`` batches equal, bit for
bit, to the JAX package's ``Loader(backend="python")``, the multi-object
scene synthesizer's (``synthesizer=``) included,
``tests/test_torch_native.py`` its ``native`` and ``auto`` batches to JAX's,
``tests/test_torch_device_data.py`` its ``device`` and ``device_bank``
batches to JAX's, and ``tests/test_torch_device_synth.py`` its
``device_synth`` scenes to JAX's from the same draws.  Backends: ``native``
(the C++ fused decode and augment of ``native/``, train and test, and the
test split's yuv420 planes with ``out_yuv420``), ``python`` (host decode and
augment with PIL and numpy), ``auto`` (``native`` when its library builds
and the dataset has no scene synthesizer, else ``python``; the choice is
logged), ``device`` (host decode, augment on the card:
``data/device_augment.py``), ``device_bank`` (the train split decoded once
into device memory: ``data/device_bank.py``) and ``device_synth`` (the
multi-object corpus in device memory, scenes synthesized on the card:
``data/device_synth.py``).  The ``device`` and ``device_bank`` backends
decode with the native decoder when it builds, as JAX's do.  JAX's ``mesh``
option is ``group`` here: a data-parallel rank's rows of the bank backends'
global batches.

Rebuild of ``listDataset`` + torch ``DataLoader`` (reference:
``dataset.py:14-141``, ``train.py:56-65``):

  * the multi-scale schedule is a pure function of a single authoritative
    ``seen`` counter owned by the loader — the reference instead lets every
    DataLoader worker bump a private copy by ``num_workers`` per sample
    (``dataset.py:138``), racy-by-design; here the schedule is deterministic
    given (seen, rng).
  * widths are drawn from the same staged 32-px buckets
    (``dataset.py:66-90`` single, ``dataset_multi.py:43-58`` multi).
  * samples are decoded/augmented by a thread pool (PIL/numpy release the
    GIL for the heavy parts) and batches are yielded as host numpy.
"""

from __future__ import annotations

import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..tracing import span
from ..utils.labels import (label_path_from_image, mask_path_from_image,
                            read_truths, read_truths_args)
from . import augment

__all__ = ["MultiScaleSchedule", "SINGLE_SCHEDULE", "MULTI_SCHEDULE",
           "AugmentConfig", "PoseDataset", "Loader", "load_image"]


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

# reference: dataset_multi.py:43-58 — milder brackets
MULTI_SCHEDULE = MultiScaleSchedule((
    (20, 13, 0), (40, 13, 3), (60, 12, 5), (80, 11, 7), (0, 10, 9)))


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    jitter: float = 0.2      # reference hard-codes these (dataset.py:94-97)
    hue: float = 0.1
    saturation: float = 1.5
    exposure: float = 1.5

    @classmethod
    def multi(cls) -> "AugmentConfig":
        return cls(jitter=0.1, hue=0.05)  # dataset_multi.py:62-65


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
                 label_path_fn: Callable[[str], str] = label_path_from_image,
                 synthesizer: Optional[Callable] = None,
                 cache_decoded: bool = False):
        with open(listfile) as f:
            self.lines = [ln.strip() for ln in f if ln.strip()]
        self.train = train
        self.bg_file_names = list(bg_file_names or [])
        self.aug = aug
        self.num_keypoints = num_keypoints
        self.max_num_gt = max_num_gt
        self.label_path_fn = label_path_fn
        self.synthesizer = synthesizer  # multi-object scene synthesis hook
        # RAM cache of decoded image/mask arrays: LINEMOD-sized train sets
        # (~200-1200 640×480 frames ≈ 0.2-1.1 GB) decode once, then every
        # later epoch runs at augment speed
        self.cache_decoded = cache_decoded
        self._img_cache: dict = {}

    def _decode_cached(self, path: str, decode: Callable[[str], np.ndarray]
                       ) -> np.ndarray:
        if not self.cache_decoded:
            return decode(path)
        arr = self._img_cache.get(path)
        if arr is None:
            arr = decode(path)
            self._img_cache[path] = arr
        return arr

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

    def plan_train_sample(self, index: int, rng: np.random.RandomState):
        """Draw augmentation parameters for the native fused path.

        Consumes the SAME rng stream in the SAME order as :meth:`get_train`
        (bg pick → crop jitter → flip → HSV), so the two backends are
        parameter-identical given equal seeds.  Returns
        (imgpath, maskpath|None, bgpath|None, crop(pleft,ptop,cw,ch),
        hsv(dhue,dsat,dexp), flat label).
        """
        from PIL import Image
        imgpath = self.lines[index]
        with Image.open(imgpath) as im:
            ow, oh = im.size
        bgpath = None
        if self.bg_file_names:
            bgpath = self.bg_file_names[rng.randint(len(self.bg_file_names))]
        dw, dh = int(ow * self.aug.jitter), int(oh * self.aug.jitter)
        pleft = rng.randint(-dw, dw + 1)
        pright = rng.randint(-dw, dw + 1)
        ptop = rng.randint(-dh, dh + 1)
        pbot = rng.randint(-dh, dh + 1)
        swidth = ow - pleft - pright
        sheight = oh - ptop - pbot
        sx, sy = swidth / ow, sheight / oh
        _flip = bool(rng.randint(2))     # drawn, never applied (parity)
        dhue = rng.uniform(-self.aug.hue, self.aug.hue)
        dsat = augment.rand_scale(rng, self.aug.saturation)
        dexp = augment.rand_scale(rng, self.aug.exposure)
        dx = (pleft / ow) / sx
        dy = (ptop / oh) / sy
        label = augment.transform_truths(
            self._read_truths_full(imgpath), dx, dy, 1.0 / sx, 1.0 / sy,
            self.num_keypoints, self.max_num_gt)
        mask = mask_path_from_image(imgpath) if bgpath else None
        return (imgpath, mask, bgpath, (pleft, ptop, swidth, sheight),
                (dhue, dsat, dexp), label)

    def get_train(self, index: int, shape: Tuple[int, int],
                  rng: np.random.RandomState, as_uint8: bool = False):
        """One augmented train sample.  ``as_uint8`` skips the final /255
        (the augmentation pipeline is uint8 throughout) so batches transfer
        at 1/4 the bytes and normalize on device — bit-identical values."""
        imgpath = self.lines[index]
        if self.synthesizer is not None:
            img, label = self.synthesizer(self, imgpath, shape, rng)
        else:
            img = self._decode_cached(imgpath, load_image)
            mask = self._decode_cached(mask_path_from_image(imgpath),
                                       load_image)
            if self.bg_file_names:
                bg = load_image(
                    self.bg_file_names[rng.randint(len(self.bg_file_names))])
                img = augment.change_background(img, mask, bg)
            w, h = shape
            img, _flip, dx, dy, sx, sy = augment.data_augmentation(
                rng, img, w, h, self.aug.jitter, self.aug.hue,
                self.aug.saturation, self.aug.exposure)
            truths = self._read_truths_full(imgpath)
            label = augment.transform_truths(truths, dx, dy, 1.0 / sx,
                                             1.0 / sy, self.num_keypoints,
                                             self.max_num_gt)
        if as_uint8:
            return np.ascontiguousarray(img, np.uint8), label
        return img.astype(np.float32) / 255.0, label


# ---------------------------------------------------------------------------
# loader
# ---------------------------------------------------------------------------


_BACKENDS = ("python", "native", "device", "device_bank", "device_synth")


def _native_decoder(num_workers: int):
    """The native library's ``NativeLoader``, or None with the reason it
    is unavailable."""
    from ..native import NativeLoader, native_error
    try:
        return NativeLoader(nthreads=max(num_workers, 0)), None
    except RuntimeError:
        return None, native_error()


class Loader:
    """Batched, shuffled, thread-pooled iterator over a PoseDataset.

    One authoritative ``seen`` counter drives the multi-scale schedule; each
    batch uses a single width so the stacked array is rectangular.  Yields
    (images (B,H,W,3), labels (B, 50·(2K+3)) f32): on the ``python`` and
    ``native`` backends host arrays, images f32 — or u8 with
    ``out_uint8``, or with ``out_yuv420`` (test mode, ``native``) the
    native-size planes ``(y (B,H,W), cbcr (B,H/2,W/2,2))`` u8, which
    ``ops/yuv.py`` converts on the device; on the ``device`` backend u8
    images on ``device`` and host labels; on the ``device_bank`` backend
    both on ``device``; on the ``device_synth`` backend f32 images in
    [0, 1] and labels, both on ``device``.  While a torch profiler records,
    making each batch is the span ``ssp.loader.batch``.

    ``backend="auto"`` is ``native`` when the native library builds and the
    dataset has no scene synthesizer, else ``python``, as in JAX; it logs
    its choice.  ``native`` and ``out_yuv420`` raise when the library does
    not build, with g++'s error.  ``device`` (default the card) is where
    the device backends put their batches; a CUDA device without CUDA
    raises.  ``synth_attempts`` and ``synth_propose_scale``:
    ``device_synth``'s placement proposals per companion (None: the
    synthesizer's ``max_attempts``) and its overlap test's resolution
    divisor (``DeviceSynthStatic.from_config``).

    ``group`` (a ``parallel.sharding.DPGroup``; the bank backends only):
    JAX's ``mesh=``.  Every rank builds the whole bank on its device, in
    the constructor (the bank's preflight is a collective over the grid,
    ``utils/memory.check_hbm_budget``), and draws the whole global batch's
    host stream (``device_bank``: the background picks, then
    ``draw_params``; ``device_synth``: the generator's seed and its
    draws), so the ranks' streams stay in lockstep; each then computes
    only its data rows of the batch (``parallel.sharding.batch_rows``;
    model peers the same rows), those rows of the one-process batch bit
    for bit.  ``batch_size`` and
    ``seen`` are global, so the multi-scale widths agree across ranks.
    """

    def __init__(self, dataset: PoseDataset, batch_size: int, *,
                 shuffle: bool = True, seen: int = 0,
                 schedule: Optional[MultiScaleSchedule] = SINGLE_SCHEDULE,
                 fixed_shape: Optional[Tuple[int, int]] = None,
                 num_workers: int = 8, seed: int = 0,
                 drop_last: bool = True, backend: str = "auto",
                 out_uint8: bool = False, out_yuv420: bool = False,
                 device="cuda", synth_attempts: Optional[int] = None,
                 synth_propose_scale: int = 4, group=None):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seen = seen
        self.schedule = schedule
        self.fixed_shape = fixed_shape
        self.rng = np.random.RandomState(seed)
        self.drop_last = drop_last
        # yield uint8 images (normalized on the device): 4x lighter
        # host→device copies (the python and native backends; the device
        # backends yield u8 always)
        self.out_uint8 = out_uint8
        # test mode, native: the frames' native-size YUV 4:2:0 planes,
        # 1.5 B/px; the device converts and resizes (ops/yuv.py)
        self.out_yuv420 = out_yuv420
        if out_yuv420 and (dataset.train or dataset.synthesizer is not None
                           or backend not in ("auto", "native")):
            raise ValueError("out_yuv420 is a test-mode native-loader option")
        self._native = None
        if backend in ("auto", "native"):
            if dataset.synthesizer is not None:
                if backend == "native":
                    raise ValueError("native backend does not cover the "
                                     "scene-synthesis path")
                why = "the dataset synthesizes scenes"
            else:
                self._native, err = _native_decoder(num_workers)
                if self._native is None and (backend == "native"
                                             or out_yuv420):
                    raise RuntimeError(f"native library unavailable: {err}")
                why = (f"the native library is unavailable: {err}"
                       if self._native is None else
                       "the native library built")
            if backend == "auto":
                backend = "python" if self._native is None else "native"
                print(f"Loader backend auto: {backend} ({why})", flush=True)
        if backend not in _BACKENDS:
            raise ValueError(f"unknown loader backend {backend!r}")
        if group is not None and backend not in ("device_bank",
                                                 "device_synth"):
            raise ValueError(
                f"group= splits the bank backends' batches; the {backend} "
                "loader under data parallelism reads its rank's shard of the "
                "dataset instead (drivers._local_shard)")
        self.backend = backend
        self.group = group
        if backend not in ("python", "native"):
            if backend == "device_synth":
                if getattr(dataset.synthesizer, "cfg", None) is None:
                    raise ValueError(
                        "the device_synth backend needs a PoseDataset with a "
                        "MultiObjectSynthesizer (its SynthConfig seeds the "
                        "scene bank)")
            elif dataset.synthesizer is not None:
                raise ValueError(f"the {backend} backend does not cover the "
                                 "scene-synthesis path")
            if not dataset.train:
                raise ValueError(f"{backend} is a train-mode backend")
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(f"loader backend {backend!r} on "
                                   f"{self.device}, but CUDA is not available")
            self._frame_bank = self._synth_bank = None
            self._synth_attempts = synth_attempts
            self._synth_propose_scale = synth_propose_scale
            self._synth_static = None
        if backend in ("device", "device_bank"):
            # the host decode of these backends: the native decoder when it
            # builds, else PIL, as in JAX
            dec, err = _native_decoder(num_workers)
            self._decode = dec.decode if dec is not None else load_image
            print(f"Loader backend {backend}: decoding with "
                  + ("the native decoder" if dec is not None else
                     f"PIL (the native library is unavailable: {err})"),
                  flush=True)
        # the bank backends' batches are device work alone, and the native
        # backend runs its own threads: no host workers
        self.pool = ThreadPoolExecutor(max_workers=num_workers) \
            if num_workers > 0 and backend in ("python", "device") else None
        if group is not None:
            # the bank's memory preflight is a collective over the grid: it
            # runs here, on the thread that makes the run's collectives and
            # at the point every rank makes its loader, not on a prefetch
            # thread at the first batch
            self._build_bank()

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
            with span("ssp.loader.batch"):
                batch = self._batch(idxs, self._batch_shape())
            yield batch

    def _batch(self, idxs: np.ndarray, shape: Tuple[int, int]):
        if self.backend == "device_synth":
            return self._device_synth_batch(idxs, shape)
        if self.backend == "device_bank":
            return self._device_bank_batch(idxs, shape)
        if self.backend == "device":
            return self._device_batch(idxs, shape)
        if self.backend == "native":
            return self._native_batch(idxs, shape)
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
        return imgs, labels

    def _rows(self, B: int) -> Optional[slice]:
        """This rank's rows of a global batch of ``B`` under ``group``."""
        if self.group is None:
            return None
        from ..parallel.sharding import batch_rows
        return batch_rows(B, self.group)

    def _bg_rows(self, B: int) -> np.ndarray:
        """One background draw per sample over the full list (the device
        backends' rng stream: these draws, then ``draw_params``)."""
        n = len(self.ds.bg_file_names)
        return np.array([self.rng.randint(n) for _ in range(B)], np.int64)

    def _draw(self, B: int, iw: int, ih: int):
        from .device_augment import draw_params
        aug = self.ds.aug
        return draw_params(self.rng, B, iw, ih, jitter=aug.jitter,
                           hue=aug.hue, saturation=aug.saturation,
                           exposure=aug.exposure)

    def _build_bank(self) -> None:
        """Decode the corpus into the backend's device-resident bank, once
        (``device_bank``: a ``DeviceFrameBank``, ``data/device_bank.py``;
        ``device_synth``: a ``DeviceSceneBank``, ``data/device_synth.py``),
        after the memory preflight, and log its size and build time."""
        if self.backend == "device_bank" and self._frame_bank is None:
            from .device_bank import build_frame_bank
            t0 = time.time()
            bank = build_frame_bank(self.ds, decode=self._decode)
            self._frame_bank = bank.device_put(self.device, self.group)
            print(f"device_bank: {bank.images.shape[0]} frames, "
                  f"{bank.nbytes() / 1e6:.0f} MB on {self.device} "
                  f"({time.time() - t0:.1f}s to build)", flush=True)
        elif self.backend == "device_synth" and self._synth_bank is None:
            from . import device_synth as DS
            scfg = self.ds.synthesizer.cfg
            t0 = time.time()
            bank = DS.build_scene_bank(scfg, self.ds.lines,
                                       self.ds.bg_file_names)
            self._synth_binary = DS.binary_masks(bank)
            self._synth_bank = bank.device_put(self.device, self.group)
            self._synth_static = DS.DeviceSynthStatic.from_config(
                scfg, attempts=self._synth_attempts,
                propose_scale=self._synth_propose_scale)
            print(f"device_synth bank: {bank.images.shape[0]} frames, "
                  f"{bank.nbytes() / 1e6:.0f} MB on {self.device} "
                  f"({time.time() - t0:.1f}s to build)", flush=True)

    def _device_synth_batch(self, idxs, shape):
        """One multi-object batch synthesized on the device.

        The first call (under ``group``, the constructor) decodes the whole
        LINEMOD corpus into a device-resident ``DeviceSceneBank``
        (:meth:`_build_bank`); afterwards each batch is device work
        on (bank, indices, draws), the draws from a ``torch.Generator`` on
        the device seeded from the loader's host stream.  Yields device
        tensors (images f32 in [0, 1], labels f32)."""
        from . import device_synth as DS
        from .device_augment import upload

        self._build_bank()
        bank, st = self._synth_bank, self._synth_static
        w, h = shape
        ih, iw = bank.frame_shape
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(self.rng.randint(2 ** 31 - 1)))
        base_idx = upload(np.asarray(idxs, np.int64), self.device)
        draws = DS.draw_synth(gen, len(idxs), bank,
                              bank.base_class[base_idx].long(), st, iw, ih)
        imgs, labels = DS.synthesize_batch(bank, base_idx, draws, out_w=w,
                                           out_h=h, st=st,
                                           binary=self._synth_binary,
                                           rows=self._rows(len(idxs)))
        self.seen += len(idxs)
        return imgs, labels

    def _device_bank_batch(self, idxs, shape):
        """One single-object train batch from the device frame bank.

        The first call (under ``group``, the constructor) decodes the
        corpus into a device-resident ``DeviceFrameBank``
        (:meth:`_build_bank`); afterwards each batch is device work on
        (bank, indices, host-drawn params).  The rng stream matches the
        ``device`` backend draw for draw (bg picks then ``draw_params``),
        so given equal seeds the two backends yield bit-identical images.
        Yields device tensors (images u8, labels f32)."""
        from .device_bank import augment_bank_batch

        self._build_bank()
        bank = self._frame_bank
        w, h = shape
        B = len(idxs)
        ih, iw = bank.frame_shape
        if self.ds.bg_file_names:
            # folded onto the bank's sampled rows
            bg_rows = self._bg_rows(B) % bank.bgs.shape[0]
        else:
            bg_rows = np.zeros(B, np.int64)
        params, _ = self._draw(B, iw, ih)
        imgs, labels = augment_bank_batch(
            bank, np.asarray(idxs, np.int64), bg_rows, params, out_w=w,
            out_h=h, K=self.ds.num_keypoints, rows=self._rows(B))
        self.seen += B
        return imgs, labels

    def _device_batch(self, idxs, shape):
        """Decode on the host, augment on the device.

        Yields (u8 images (B,h,w,3) on ``device``, host labels).  All source
        images must share one native size (true for LINEMOD)."""
        from .device_augment import augment_batch, upload

        w, h = shape

        def one(i):
            imgpath = self.ds.lines[int(i)]
            img = self.ds._decode_cached(imgpath, self._decode)
            mask = self.ds._decode_cached(mask_path_from_image(imgpath),
                                          self._decode)
            return img, mask if mask.ndim == 3 else mask[..., None]

        work = list(idxs)
        if self.pool is not None:
            decoded = list(self.pool.map(one, work))
        else:
            decoded = [one(i) for i in work]
        # all u8: the three native-size buffers copy at 1/4 the float bytes
        imgs = np.stack([d[0] for d in decoded])
        ih, iw = imgs.shape[1:3]
        masks = np.stack([d[1][..., :1] for d in decoded])

        B = len(work)
        if self.ds.bg_file_names:
            bgs = np.stack([
                augment.resize_nearest(
                    self._decode(self.ds.bg_file_names[r]), iw, ih)
                for r in self._bg_rows(B)])
        else:
            bgs = np.zeros_like(imgs)
            masks = np.full_like(masks, 255)

        params, lab_tf = self._draw(B, iw, ih)
        out = augment_batch(upload(imgs, self.device),
                            upload(masks, self.device),
                            upload(bgs, self.device), params, w, h)
        labels = np.stack([
            augment.transform_truths(
                self.ds._read_truths_full(self.ds.lines[int(i)]),
                lab_tf[b, 0], lab_tf[b, 1],
                1.0 / lab_tf[b, 2], 1.0 / lab_tf[b, 3],
                self.ds.num_keypoints, self.ds.max_num_gt)
            for b, i in enumerate(work)])
        self.seen += B
        return out, labels

    def _native_batch(self, idxs, shape):
        """One batch through the C++ fused decode/augment thread pool: a
        train batch from :meth:`PoseDataset.plan_train_sample`'s draws (the
        ``python`` backend's rng stream), a test batch decoded and resized,
        or its yuv420 planes."""
        w, h = shape
        if self.ds.train:
            seeds = self.rng.randint(0, 2 ** 31 - 1, size=len(idxs))
            plans = [self.ds.plan_train_sample(int(i),
                                               np.random.RandomState(int(s)))
                     for i, s in zip(idxs, seeds)]
            batch_fn = self._native.train_batch_u8 if self.out_uint8 \
                else self._native.train_batch
            imgs = batch_fn(
                [p[0] for p in plans], [p[1] for p in plans],
                [p[2] for p in plans],
                np.array([p[3] for p in plans], np.int32),
                np.array([p[4] for p in plans], np.float32), w, h)
            labels = np.stack([p[5] for p in plans])
        else:
            paths = [self.ds.lines[int(i)] for i in idxs]
            if self.out_yuv420:
                imgs = self._native.test_batch_yuv420(paths)  # (y, cbcr)
            elif self.out_uint8:
                imgs = self._native.test_batch_u8(paths, w, h)
            else:
                imgs = self._native.test_batch(paths, w, h)
            labels = np.stack([self.ds.get_test_label(int(i))
                               for i in idxs])
        self.seen += len(idxs)
        return imgs, labels
