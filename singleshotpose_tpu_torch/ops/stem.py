"""The folded serving stem: conv 3×3 3→32 + bias + leaky + 2×2/2 max pool.

Mirrors the serving half of ``singleshotpose_tpu/ops/stem.py``
(``stem_conv_pool_infer``, whose Pallas kernel is ``_k_serve``).  On a CUDA
tensor :func:`stem_conv_pool_infer` launches the hand-written Hopper kernel
in ``csrc/stem_serve.cu``; on a CPU tensor it runs
:func:`stem_conv_pool_infer_reference`, the plain PyTorch version with the
same rounding points.  There is no fallback from the one to the other: a
CUDA tensor runs the kernel or raises.

The kernel is compiled with ``nvcc`` into a plain-C shared library at first
use, keyed on the source's content, under ``singleshotpose_tpu_torch/_build/``,
and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import torch
import torch.nn.functional as F

from ..models import layers as L

__all__ = ["stem_conv_pool_infer", "stem_conv_pool_infer_reference",
           "build_library"]

_CO = 32
_CI = 3
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "stem_serve.cu")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _check_args(images: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    if images.dim() != 4 or images.shape[-1] != _CI:
        raise ValueError(f"images must be (B, H, W, 3), got {tuple(images.shape)}")
    if tuple(w.shape) != (_CO, _CI, 3, 3):
        raise ValueError(f"w must be OIHW (32, 3, 3, 3), got {tuple(w.shape)}")
    if tuple(bias.shape) != (_CO,):
        raise ValueError(f"bias must be (32,), got {tuple(bias.shape)}")
    for name, t in (("images", images), ("w", w), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != images.device:
            raise ValueError(f"{name} is on {t.device}, images on {images.device}")


def stem_conv_pool_infer_reference(images: torch.Tensor, w: torch.Tensor,
                                   bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch serving stem: ``F.conv2d`` in f32 on bf16-rounded
    operands, rounded to bf16, plus the f32 bias, rounded to bf16, leaky with
    the bf16 slope, 2×2/2 max pool.  NHWC (B, H, W, 3) f32 → (B, H/2, W/2, 32)
    bf16, contiguous NHWC.  The value the kernel must reproduce."""
    _check_args(images, w, bias)
    x = images.permute(0, 3, 1, 2).to(torch.bfloat16).float()
    y = F.conv2d(x, w.to(torch.bfloat16).float(), padding=1).to(torch.bfloat16)
    z = (y.float() + L.per_channel(bias, y)).to(torch.bfloat16)
    pooled = L.max_pool(L.leaky_relu(z), 2, 2)
    return pooled.permute(0, 2, 3, 1).contiguous()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "serving-stem CUDA kernel cannot be built")
    return found


def build_library() -> str:
    """Compile ``csrc/stem_serve.cu`` for sm_90a into ``_build/`` unless a
    library built from the same source and flags is there; returns its path.
    Raises ``RuntimeError`` when ``nvcc`` is absent or fails."""
    nvcc = _nvcc()
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libstem_serve_{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)       # atomic: concurrent builds agree
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build_library())
    fn = lib.stem_conv_pool_infer_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def stem_conv_pool_infer(images: torch.Tensor, w: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """Fused folded-serving stem forward.

    Args:
      images: (B, H, W, 3) f32 NHWC in [0, 1].
      w: (32, 3, 3, 3) f32 OIHW conv weights with BN folded in.
      bias: (32,) f32 folded bias.

    Returns (B, H//2, W//2, 32) bf16, contiguous NHWC —
    ``max_pool(leaky(bf16(bf16(conv(x, w)) + b)), 2, 2)``.

    A CPU tensor takes :func:`stem_conv_pool_infer_reference`; a CUDA tensor
    launches the kernel (counted in ``stem_conv_pool_infer.launches``) or
    raises.
    """
    if images.device.type == "cpu":
        return stem_conv_pool_infer_reference(images, w, bias)
    if images.device.type != "cuda":
        raise ValueError(f"no serving-stem kernel for device {images.device}")
    _check_args(images, w, bias)
    for name, t in (("images", images), ("w", w), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous for the CUDA kernel")
    B, H, W, _ = images.shape
    out = torch.empty((B, H // 2, W // 2, _CO), dtype=torch.bfloat16,
                      device=images.device)
    lib = _library()
    with torch.cuda.device(images.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.stem_conv_pool_infer_launch(
            images.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            B, H, W, stream)
    if err != 0:
        raise RuntimeError(f"stem_serve kernel launch failed: CUDA error {err}")
    stem_conv_pool_infer.launches += 1
    return out


stem_conv_pool_infer.launches = 0
