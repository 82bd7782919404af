"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own
with ``nvcc`` for sm_90a into a shared library under
``singleshotpose_tpu_torch/_build/``, keyed on the hash of that source and
the flags, at first use; the library is then bound with ``ctypes``.  Nothing
is built when a module is imported.  :func:`build_libraries` starts one
``nvcc`` per missing library, all at once, and waits for them together.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import List, Sequence

__all__ = ["build_libraries", "build_library", "load_library", "CSRC_DIR",
           "BUILD_DIR", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    found = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.isfile(found):
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the "
            "port's CUDA kernels cannot be built")
    return found


def _library_path(name: str) -> str:
    """``_build/lib<name>_<hash>.so`` for ``csrc/<name>.cu``; the hash
    covers the source's bytes and the flags."""
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build_libraries(names: Sequence[str]) -> List[str]:
    """Compile ``csrc/<name>.cu`` for every name whose library is not built
    yet, one ``nvcc`` process per source, all started together; returns the
    libraries' paths in the order of ``names``.  Raises ``RuntimeError`` when
    ``nvcc`` is absent or any build fails (after every build has ended)."""
    libs = [_library_path(n) for n in names]
    todo = [(n, lib) for n, lib in zip(names, libs) if not os.path.exists(lib)]
    if not todo:
        return libs
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    running = []
    try:
        for name, lib in todo:
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp,
                 os.path.join(CSRC_DIR, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            running.append((name, lib, tmp, proc))
        errors = []
        for name, lib, tmp, proc in running:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed on {name}.cu "
                              f"({proc.returncode}):\n{out}")
            else:
                os.replace(tmp, lib)       # atomic: concurrent builds agree
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for _, _, tmp, proc in running:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
    return libs


def build_library(name: str) -> str:
    """:func:`build_libraries` for one source."""
    return build_libraries([name])[0]


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, built first if need be;
    loaded once per process."""
    return ctypes.CDLL(build_library(name))
