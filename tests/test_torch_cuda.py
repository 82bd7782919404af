"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These run only where there is an NVIDIA card (``cuda`` marker); elsewhere
each skips with its reason — a CUDA kernel has no CPU mode.  The file imports
no jax, so it runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU tests and
imports jax.)  Bounds, as for the CPU parity of each plain version: the
serving stem max|d| ≤ 1e-2·max|ref| + 1e-3 with at least 99% of elements
exactly equal; the max corner confidence rtol 1e-5, atol 1e-6, with the
same cells above the 0.6 silencing threshold.
"""

import pytest
import torch

from singleshotpose_tpu_torch.models.darknet import (DarknetSpec, Darknet,
                                                     apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import max_corner_confidence as mcc
from singleshotpose_tpu_torch.ops import stem
from singleshotpose_tpu_torch.ops.targets import build_targets

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


def _corners(dev, B, G, S, seed):
    """GT slots and predictions near them (confidences spread over (0, 1))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    gt = torch.rand((B, G, 18), generator=g, device=dev)
    valid = torch.rand((B, G), generator=g, device=dev) < 0.3
    pred = torch.rand((B, S, 18), generator=g, device=dev)
    if G:
        pick = torch.randint(0, G, (B, S), generator=g, device=dev)
        pred = torch.gather(gt, 1, pick[:, :, None].expand(B, S, 18)) \
            + torch.randn((B, S, 18), generator=g, device=dev) * 0.03
    return gt, valid, pred


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,S", [(2, 50, 169), (3, 50, 845), (1, 7, 130),
                                   (8, 50, 676), (2, 0, 5)])
def test_max_corner_confidence_kernel_matches_plain_version(dev, B, G, S):
    gt, valid, pred = _corners(dev, B, G, S, seed=B * S + G)
    before = mcc.max_corner_confidence.launches
    got = mcc.max_corner_confidence(gt, valid, pred)
    torch.cuda.synchronize()
    assert mcc.max_corner_confidence.launches == before + 1
    assert got.shape == (B, S) and got.dtype == torch.float32
    ref = mcc.max_corner_confidence_reference(gt, valid, pred) if G else \
        torch.zeros((B, S), device=dev)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got > 0.6, ref > 0.6)
    none = mcc.max_corner_confidence(gt, torch.zeros_like(valid), pred)
    assert not none.any()
    # a float validity takes the same path
    torch.testing.assert_close(
        mcc.max_corner_confidence(gt, valid.float(), pred), got, rtol=0, atol=0)


@pytest.mark.cuda
def test_max_corner_confidence_kernel_rejects_what_it_cannot_take(dev):
    gt, valid, pred = _corners(dev, 2, 50, 169, seed=0)
    with pytest.raises(ValueError, match="9 keypoints"):
        mcc.max_corner_confidence(gt[..., :16], valid, pred[..., :16])
    with pytest.raises(ValueError, match="contiguous"):
        mcc.max_corner_confidence(gt, valid, pred.transpose(0, 1)
                                  .contiguous().transpose(0, 1))
    with pytest.raises(ValueError):
        mcc.max_corner_confidence(gt, valid, pred.cpu())


@pytest.mark.cuda
def test_build_targets_on_the_card_equals_the_cpu(dev):
    gt, valid, pred = _corners(dev, 4, 50, 169, seed=5)
    target = torch.zeros((4, 50, 21), device=dev)
    target[:, :, 1:19] = gt * valid[:, :, None]
    target[:, :, 19:21] = 0.3
    target = target.reshape(4, -1)
    kw = dict(num_keypoints=9, num_anchors=1, nH=13, nW=13,
              noobject_scale=1.0, object_scale=5.0, sil_thresh=0.6)
    before = mcc.max_corner_confidence.launches
    got = build_targets(pred, target, **kw)
    assert mcc.max_corner_confidence.launches == before + 1
    want = build_targets(pred.cpu(), target.cpu(), **kw)
    for name, a, b in zip(got._fields, got, want):
        if a.is_floating_point():
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-6,
                                       msg=name)
        else:
            assert torch.equal(a.cpu(), b), name
