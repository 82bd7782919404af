"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These run only where there is an NVIDIA card (``cuda`` marker); elsewhere
each skips with its reason — a CUDA kernel has no CPU mode.  The file imports
no jax, so it runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU tests and
imports jax.)  Bound, as for the CPU parity of the plain version: max|d| ≤
1e-2·max|ref| + 1e-3 with at least 99% of elements exactly equal.
"""

import pytest
import torch

from singleshotpose_tpu_torch.models.darknet import (DarknetSpec, Darknet,
                                                     apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import stem

from torch_port_helpers import TINY_BLOCKS


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _check(got, ref):
    d = (got.float() - ref.float()).abs()
    assert float(d.max()) <= 1e-2 * float(ref.float().abs().max()) + 1e-3
    assert float((d == 0).float().mean()) >= 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(1, 32, 32), (2, 64, 96), (3, 34, 18),
                                   (1, 416, 416)])
def test_stem_kernel_matches_plain_version(dev, B, H, W):
    g = torch.Generator(device=dev).manual_seed(B * H + W)
    img = torch.rand((B, H, W, 3), generator=g, device=dev)
    w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.3
    b = torch.randn((32,), generator=g, device=dev) * 0.3
    before = stem.stem_conv_pool_infer.launches
    got = stem.stem_conv_pool_infer(img, w, b)
    torch.cuda.synchronize()
    assert stem.stem_conv_pool_infer.launches == before + 1
    assert got.shape == (B, H // 2, W // 2, 32) and got.dtype == torch.bfloat16
    _check(got, stem.stem_conv_pool_infer_reference(img, w, b))


@pytest.mark.cuda
def test_stem_kernel_rejects_what_it_cannot_take(dev):
    img = torch.rand((1, 32, 32, 3), device=dev)
    w, b = torch.randn((32, 3, 3, 3), device=dev), torch.randn(32, device=dev)
    with pytest.raises(TypeError):
        stem.stem_conv_pool_infer(img.half(), w, b)
    with pytest.raises(ValueError):
        stem.stem_conv_pool_infer(img, w.cpu(), b)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_conv_pool_infer(img.transpose(1, 2), w, b)


@pytest.mark.cuda
def test_folded_forward_runs_the_stem_kernel(dev):
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(0), device=dev)
    folded = fold_batchnorm(model)
    img = torch.rand((2, 64, 64, 3), device=dev)
    before = stem.stem_conv_pool_infer.launches
    with torch.inference_mode():
        head = apply_folded(spec, folded, img, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert stem.stem_conv_pool_infer.launches == before + 1
        ref = apply_folded(spec, {k: {n: t.cpu() for n, t in v.items()}
                                  for k, v in folded.items()},
                           img.cpu(), compute_dtype=torch.bfloat16)
    assert head.shape == (2, 4, 4, 20)
    scale = float(ref.abs().max())
    assert float((head.cpu() - ref).abs().max()) <= 2e-2 * scale
