"""The port's serving stem (singleshotpose_tpu_torch/ops/stem.py) vs the JAX
package's, and its dispatch rules.

On the CPU the wrapper runs the plain PyTorch version, which is held here
against the JAX Pallas kernel (in interpret mode, as tests/test_stem.py runs
it) and against the JAX unfused folded path.  Bound: max|d| ≤ 1e-2·max|ref| +
1e-3 (tests/test_stem.py:145), with at least 99% of elements exactly equal —
the conv sums run in another order, so a few bf16 roundings go the other
way.  The CUDA kernel itself is compared with the plain version only on a
card: tests/test_torch_cuda.py, and ``python3 chip_smoke.py`` at full size.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singleshotpose_tpu.models import layers as JL
from singleshotpose_tpu.ops import stem as jstem

from singleshotpose_tpu_torch.ops import cuda_build
from singleshotpose_tpu_torch.ops import stem as tstem

import torch_port_helpers  # noqa: F401  (caps torch threads)


@pytest.fixture
def _interpret():
    jstem.FORCE_INTERPRET = True
    yield
    jstem.FORCE_INTERPRET = False


def _inputs(B=2, H=32, W=64, seed=0):
    rng = np.random.RandomState(seed)
    img = rng.rand(B, H, W, 3).astype(np.float32)
    w = (rng.randn(3, 3, 3, 32) * 0.2).astype(np.float32)        # HWIO
    b = (rng.randn(32) * 0.2).astype(np.float32)
    return img, w, b


def _port(img, w_hwio, b):
    return tstem.stem_conv_pool_infer(
        torch.from_numpy(img),
        torch.from_numpy(np.ascontiguousarray(w_hwio.transpose(3, 2, 0, 1))),
        torch.from_numpy(b))


def _check(got, ref):
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    d = np.abs(got - ref)
    assert d.max() <= 1e-2 * np.abs(ref).max() + 1e-3, d.max()
    assert (d == 0).mean() >= 0.99, (d == 0).mean()


def test_plain_stem_matches_jax_pallas_kernel(_interpret):
    img, w, b = _inputs(seed=1)
    got = _port(img, w, b)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    ref = jstem.stem_conv_pool_infer(jnp.asarray(img), jnp.asarray(w),
                                     jnp.asarray(b))
    _check(got, ref)


def test_plain_stem_matches_jax_unfused_folded_path():
    img, w, b = _inputs(B=3, H=64, W=32, seed=2)
    got = _port(img, w, b)
    y = (JL.conv2d(jnp.asarray(img, jnp.bfloat16),
                   jnp.asarray(w, jnp.bfloat16), 1, 1, preferred_dtype=None)
         + jnp.asarray(b)).astype(jnp.bfloat16)
    _check(got, JL.max_pool(JL.leaky_relu(y), 2, 2))


def test_cpu_tensor_takes_plain_version_and_launches_nothing():
    img, w, b = _inputs(seed=3)
    before = tstem.stem_conv_pool_infer.launches
    got = _port(img, w, b)
    ref = tstem.stem_conv_pool_infer_reference(
        torch.from_numpy(img),
        torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1))),
        torch.from_numpy(b))
    assert torch.equal(got, ref)
    assert tstem.stem_conv_pool_infer.launches == before


def test_wrapper_rejects_bad_arguments():
    img, w, b = _inputs(seed=4)
    timg, tb = torch.from_numpy(img), torch.from_numpy(b)
    tw = torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))
    with pytest.raises(ValueError):
        tstem.stem_conv_pool_infer(timg[..., :2], tw, tb)
    with pytest.raises(ValueError):
        tstem.stem_conv_pool_infer(timg, tw[:16], tb)
    with pytest.raises(TypeError):
        tstem.stem_conv_pool_infer(timg.double(), tw, tb)
    with pytest.raises(ValueError):
        tstem.stem_conv_pool_infer(timg.to("meta"), tw.to("meta"),
                                   tb.to("meta"))


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    """No compiler, no kernel: the build raises, it returns no stand-in."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        cuda_build.build_library("stem_serve")
