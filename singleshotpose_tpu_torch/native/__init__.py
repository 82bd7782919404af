"""ctypes binding for the native data-loader core (``ssp_native.cpp``).

The port's counterpart of ``singleshotpose_tpu/native/__init__.py``, over
its own copy of the C++ source: the same entry points (``NativeLoader``:
fused decode, composite, crop and HSV of a train batch, the test batch's
decode and resize, the yuv420 planes; ``NativeSynthOps``: the pixel core
of the multi-object scene synthesizer), so both packages yield the same
bytes (``tests/test_torch_native.py``).

The library is built at first use, never at import, with g++ (``-O3 -fPIC
-shared -std=c++17 -ljpeg -lpng -lpthread``: it needs the libjpeg and
libpng headers and libraries) into ``singleshotpose_tpu_torch/_build/``,
keyed on the hash of the source and the flags.  Each build writes a
temporary file and renames it into place, so processes that build at once
never load a half-written library.  When the build fails,
:func:`load_native` returns None and ``NativeLoader``/``NativeSynthOps``
raise ``RuntimeError`` with g++'s first error line (:func:`native_error`);
only the loader's ``backend="auto"`` falls back to the Python path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence

import numpy as np

__all__ = ["load_native", "native_available", "native_error",
           "NativeLoader", "NativeSynthOps", "library_path"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ssp_native.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")
GXX_LIBS = ("-ljpeg", "-lpng", "-lpthread")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_error: Optional[str] = None        # why the library is unavailable


def library_path() -> str:
    """``_build/libssp_native_<hash>.so``; the hash covers the source's
    bytes and the g++ flags."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS + GXX_LIBS).encode())
    with open(_SRC, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR,
                        f"libssp_native_{digest.hexdigest()[:16]}.so")


def _first_error(output: str) -> str:
    """g++'s first error line (a missing header, a library the linker
    cannot find), else its first line."""
    lines = [ln.strip() for ln in output.splitlines() if ln.strip()]
    for ln in lines:
        if "error" in ln or "cannot find" in ln:
            return ln
    return lines[0] if lines else "no output"


def _build(so: str) -> Optional[str]:
    """Compile the source into ``so``; None on success, else the error.
    The temporary file lies in ``so``'s own directory, so the rename never
    crosses a file system."""
    os.makedirs(os.path.dirname(so), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(so))
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *GXX_FLAGS, _SRC, "-o", tmp, *GXX_LIBS],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            return f"g++ failed: {_first_error(proc.stderr + proc.stdout)}"
        os.replace(tmp, so)         # atomic: concurrent builds agree
        return None
    except FileNotFoundError:
        return "g++ not found"
    except subprocess.TimeoutExpired:
        return "g++ timed out after 300 s"
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> None:
    """``argtypes`` and ``restype`` of every entry point the wrappers
    call."""
    i, l_ = ctypes.c_int, ctypes.c_long
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    fp = ctypes.POINTER(ctypes.c_float)
    sp = ctypes.POINTER(ctypes.c_char_p)
    sigs = {
        "ssp_decode_rgb": (i, [ctypes.c_char_p, u8p, l_, ip, ip]),
        "ssp_image_dims": (i, [ctypes.c_char_p, ip, ip]),
        "ssp_bg_cache_limit": (None, [l_]),
        "ssp_bg_cache_clear": (None, []),
        "ssp_train_batch": (None, [i, sp, sp, sp, ip, fp, i, i, fp, ip, i]),
        "ssp_train_batch_u8": (None, [i, sp, sp, sp, ip, fp, i, i, u8p, ip,
                                      i]),
        "ssp_test_batch": (None, [i, sp, i, i, fp, ip, i]),
        "ssp_test_batch_u8": (None, [i, sp, i, i, u8p, ip, i]),
        "ssp_test_batch_yuv420": (None, [i, sp, i, i, u8p, u8p, ip, i]),
        "ssp_synth_masked_resize": (None, [
            u8p, u8p, i, i, i, i, i, i, i, i, i, i, i, u8p, u8p, u8p, i,
            ctypes.POINTER(l_), ctypes.POINTER(l_)]),
        "ssp_synth_composite": (None, [u8p, u8p, u8p, u8p, l_]),
        "ssp_change_background_buf": (None, [u8p, u8p, i, i, u8p, i, i]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = res, args


def load_native() -> Optional[ctypes.CDLL]:
    """The native library, built first if need be; None if it cannot be
    built or loaded (:func:`native_error` says why).  Tried once per
    process."""
    global _lib, _error
    with _lock:
        if _lib is not None or _error is not None:
            return _lib
        so = library_path()
        if not os.path.exists(so):
            _error = _build(so)
            if _error is not None:
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError as e:
            _error = f"cannot load {so}: {e}"
            return None
        _bind(lib)
        _lib = lib
        return _lib


def native_available() -> bool:
    return load_native() is not None


def native_error() -> Optional[str]:
    """Why the library is unavailable (g++'s first error line), or None
    when it loads."""
    load_native()
    return _error


def _require() -> ctypes.CDLL:
    lib = load_native()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_error}")
    return lib


def _ptr(a: np.ndarray, ctype=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


class NativeSynthOps:
    """Fused pixel core for multi-object scene synthesis.

    Bit-exact against the numpy ops in ``data/synth_multi.py`` (the same
    f32 formulas and truncation; crop/resize/roll/flip fold into one gather
    and the foreground product commutes with selection).  All rng draws
    stay in Python, so this path is draw-identical to the numpy path.
    ctypes releases the GIL during calls: loader worker threads scale.
    """

    def __init__(self):
        self.lib = _require()

    def masked_resize(self, img: np.ndarray, mask: np.ndarray, pleft: int,
                      ptop: int, cw: int, ch: int, out_w: int, out_h: int,
                      shift_x: int = 0, shift_y: int = 0, flip: bool = False,
                      total: Optional[np.ndarray] = None, thresh: int = 200):
        """(masked_sized, mask_sized[, area, inter]): fused
        ``mask_foreground`` + ``crop_resize`` (+ roll/flip) of image AND
        mask; with ``total`` also the rejection test's overlap counts."""
        img = np.ascontiguousarray(img, np.uint8)
        mask = np.ascontiguousarray(mask, np.uint8)
        h, w = img.shape[:2]
        if mask.shape != img.shape or img.ndim != 3 or img.shape[2] != 3:
            # the C kernel indexes mask with the image's (h, w, 3) strides;
            # another shape would read out of bounds silently
            raise ValueError(f"mask shape {mask.shape} != image {img.shape}"
                             " (both (h, w, 3))")
        if total is not None and (total.shape != (out_h, out_w, 3) or
                                  total.dtype != np.uint8 or
                                  not total.flags.c_contiguous):
            raise ValueError("total must be a contiguous u8 "
                             f"{(out_h, out_w, 3)} array")
        msized = np.empty((out_h, out_w, 3), np.uint8)
        ksized = np.empty((out_h, out_w, 3), np.uint8)
        area = ctypes.c_long()
        inter = ctypes.c_long()
        self.lib.ssp_synth_masked_resize(
            _ptr(img), _ptr(mask), h, w, pleft, ptop, cw, ch,
            shift_x, shift_y, int(flip), out_w, out_h,
            _ptr(msized), _ptr(ksized),
            _ptr(total) if total is not None else None, thresh,
            ctypes.byref(area), ctypes.byref(inter))
        if total is None:
            return msized, ksized
        return msized, ksized, int(area.value), int(inter.value)

    def composite(self, fg: np.ndarray, mask: np.ndarray, canvas: np.ndarray,
                  total: Optional[np.ndarray] = None) -> None:
        """In place: ``superimpose`` into canvas (+ ``superimpose_masks``
        into total when given)."""
        arrays = [fg, mask, canvas] + ([total] if total is not None else [])
        if any(a.shape != fg.shape or a.dtype != np.uint8 or
               not a.flags.c_contiguous for a in arrays):
            raise ValueError("composite operands must be contiguous u8 "
                             "arrays of one shape")
        self.lib.ssp_synth_composite(
            _ptr(fg), _ptr(mask), _ptr(canvas),
            _ptr(total) if total is not None else None, fg.size)

    def change_background(self, canvas: np.ndarray, mask: np.ndarray,
                          bg: np.ndarray) -> None:
        """In place: ``augment.change_background`` on decoded buffers."""
        if mask.shape != canvas.shape or canvas.ndim != 3 or \
                not (canvas.flags.c_contiguous and mask.flags.c_contiguous):
            raise ValueError(f"mask shape {mask.shape} != canvas "
                             f"{canvas.shape} (both contiguous (h, w, 3))")
        bg = np.ascontiguousarray(bg, np.uint8)
        if bg.ndim != 3 or bg.shape[2] != 3:
            raise ValueError(f"background shape {bg.shape} is not (h, w, 3)")
        self.lib.ssp_change_background_buf(
            _ptr(canvas), _ptr(mask), canvas.shape[0], canvas.shape[1],
            _ptr(bg), bg.shape[0], bg.shape[1])


def _cstr_array(paths: Sequence[Optional[str]]):
    arr = (ctypes.c_char_p * len(paths))()
    for i, p in enumerate(paths):
        arr[i] = p.encode() if p is not None else None
    return arr


def _check(status: np.ndarray, paths: Sequence[str], what: str) -> None:
    bad = np.nonzero(status)[0]
    if bad.size:
        raise IOError(f"native {what} failed for "
                      f"{[paths[i] for i in bad]} (codes "
                      f"{status[bad].tolist()})")


class NativeLoader:
    """Batch decode/augment on the native thread pool (``nthreads`` 0: one
    thread per core)."""

    def __init__(self, nthreads: int = 0):
        self.lib = _require()
        self.nthreads = nthreads

    def set_bg_cache_limit(self, nbytes: int) -> None:
        """Cap (and flush) the process-wide background-image LRU cache.

        The train path decodes one random VOC background per sample;
        repeats hit the cache instead.  Default 1 GiB; 0 disables caching.
        Large sources are decoded at DCT scale toward the compositing dims
        (libjpeg ``scale_denom``) before caching.
        """
        self.lib.ssp_bg_cache_limit(nbytes)

    def clear_bg_cache(self) -> None:
        self.lib.ssp_bg_cache_clear()

    def decode(self, path: str) -> np.ndarray:
        """Decode one image to RGB uint8 (H,W,3)."""
        w = ctypes.c_int()
        h = ctypes.c_int()
        cap = 16 * 1024 * 1024
        buf = np.empty(cap, np.uint8)
        rc = self.lib.ssp_decode_rgb(path.encode(), _ptr(buf), cap,
                                     ctypes.byref(w), ctypes.byref(h))
        if rc == -2:
            cap = w.value * h.value * 3
            buf = np.empty(cap, np.uint8)
            rc = self.lib.ssp_decode_rgb(path.encode(), _ptr(buf), cap,
                                         ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"decode failed ({rc}): {path}")
        return buf[:w.value * h.value * 3].reshape(h.value, w.value, 3).copy()

    def _train(self, fn, dtype, ctype, imgpaths, maskpaths, bgpaths, crops,
               hsv, out_w, out_h) -> np.ndarray:
        n = len(imgpaths)
        if not (len(maskpaths) == len(bgpaths) == n):
            raise ValueError("one mask and one background path per image")
        crops = np.ascontiguousarray(crops, np.int32)
        hsv = np.ascontiguousarray(hsv, np.float32)
        if crops.shape != (n, 4) or hsv.shape != (n, 3):
            raise ValueError(f"crops {crops.shape} / hsv {hsv.shape} are not "
                             f"({n}, 4) / ({n}, 3)")
        out = np.empty((n, out_h, out_w, 3), dtype)
        status = np.zeros(n, np.int32)
        fn(n, _cstr_array(list(imgpaths)), _cstr_array(list(maskpaths)),
           _cstr_array(list(bgpaths)), _ptr(crops, ctypes.c_int),
           _ptr(hsv, ctypes.c_float), out_w, out_h, _ptr(out, ctype),
           _ptr(status, ctypes.c_int), self.nthreads)
        _check(status, imgpaths, "train batch")
        return out

    def train_batch(self, imgpaths: Sequence[str],
                    maskpaths: Sequence[Optional[str]],
                    bgpaths: Sequence[Optional[str]],
                    crops: np.ndarray, hsv: np.ndarray,
                    out_w: int, out_h: int) -> np.ndarray:
        """Fused decode+composite+crop+HSV for a batch.

        crops: int32 (n,4) [pleft, ptop, cropw, croph]; hsv: float32 (n,3)
        [dhue, dsat, dexp].  Returns float32 (n, out_h, out_w, 3) in [0,1].
        """
        return self._train(self.lib.ssp_train_batch, np.float32,
                           ctypes.c_float, imgpaths, maskpaths, bgpaths,
                           crops, hsv, out_w, out_h)

    def train_batch_u8(self, imgpaths: Sequence[str],
                       maskpaths: Sequence[Optional[str]],
                       bgpaths: Sequence[Optional[str]],
                       crops: np.ndarray, hsv: np.ndarray,
                       out_w: int, out_h: int) -> np.ndarray:
        """uint8 variant of :meth:`train_batch`: 1/4 the host→device
        bytes; the device's ``u8 · f32(1/255)`` is what the step uses."""
        return self._train(self.lib.ssp_train_batch_u8, np.uint8,
                           ctypes.c_uint8, imgpaths, maskpaths, bgpaths,
                           crops, hsv, out_w, out_h)

    def _test(self, fn, dtype, ctype, imgpaths, out_w, out_h) -> np.ndarray:
        n = len(imgpaths)
        out = np.empty((n, out_h, out_w, 3), dtype)
        status = np.zeros(n, np.int32)
        fn(n, _cstr_array(list(imgpaths)), out_w, out_h, _ptr(out, ctype),
           _ptr(status, ctypes.c_int), self.nthreads)
        _check(status, imgpaths, "test batch")
        return out

    def test_batch(self, imgpaths: Sequence[str], out_w: int,
                   out_h: int) -> np.ndarray:
        """Decode + nearest resize, float32 (n, out_h, out_w, 3) in
        [0, 1]."""
        return self._test(self.lib.ssp_test_batch, np.float32,
                          ctypes.c_float, imgpaths, out_w, out_h)

    def test_batch_u8(self, imgpaths: Sequence[str], out_w: int,
                      out_h: int) -> np.ndarray:
        """Decode + nearest resize, uint8 out: 1/4 the host→device
        bytes."""
        return self._test(self.lib.ssp_test_batch_u8, np.uint8,
                          ctypes.c_uint8, imgpaths, out_w, out_h)

    def image_dims(self, path: str):
        """(width, height) from the header only (no pixel decode)."""
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self.lib.ssp_image_dims(path.encode(), ctypes.byref(w),
                                     ctypes.byref(h))
        if rc != 0:
            raise IOError(f"cannot read image dims: {path}")
        return w.value, h.value

    def test_batch_yuv420(self, imgpaths: Sequence[str]):
        """Decode a batch to native-resolution YUV 4:2:0 planes.

        Returns (y (n,H,W) u8, cbcr (n,H/2,W/2,2) u8): 1.5 bytes a pixel,
        JPEG's own colorspace, chroma 2×2 box-averaged; the device
        upsamples chroma, applies the BT.601 matrix and nearest-resizes
        (``ops/yuv.py``).  All images must share one native size.
        """
        n = len(imgpaths)
        w, h = self.image_dims(imgpaths[0])
        y = np.empty((n, h, w), np.uint8)
        cbcr = np.empty((n, h // 2, w // 2, 2), np.uint8)
        status = np.zeros(n, np.int32)
        self.lib.ssp_test_batch_yuv420(
            n, _cstr_array(list(imgpaths)), w, h, _ptr(y), _ptr(cbcr),
            _ptr(status, ctypes.c_int), self.nthreads)
        _check(status, imgpaths, "yuv420 batch")
        return y, cbcr
