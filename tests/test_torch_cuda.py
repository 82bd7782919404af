"""CUDA kernels of the PyTorch port against their plain PyTorch versions.

These run only where there is an NVIDIA card (``cuda`` marker); elsewhere
each skips with its reason — a CUDA kernel has no CPU mode.  The file imports
no jax, so it runs on the card's machine, which has none:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up the JAX package's CPU tests and
imports jax.)  Bounds, as for the CPU parity of each plain version: the
serving stem max|d| ≤ 1e-2·max|ref| + 1e-3 with at least 99% of elements
exactly equal (its tensor cores sum the conv in another order than
``F.conv2d``, so an output near a bf16 rounding boundary may round the
other way); the max corner confidence rtol 1e-5, atol 1e-6, with the
same cells above the 0.6 silencing threshold.  The train stem's kernels
(K3–K6) and their plain versions use the same formulas with f32 sums in
another order: y and pooled as the serving stem (K3 runs the serving
stem's tensor-core conv); the sums of K3 and K5 rel 1e-5 of max|ref|; K6's
dW rel 1e-4 of max|ref|.  The captured paths (a data-parallel step over an NCCL group of one
among them, and, with two cards, a dp=1 × mp=2 grid's step over NCCL) hold
the CUDA graphs to the eager calls bit for bit; there the kernels' ``launches`` counters count
captures (a wrapper runs while a graph records it, not when it replays).
The device-resident data paths (plain PyTorch ops: the frame bank, the
augment, the eval bank, the scene synth) hold the card's batches to the
CPU's bits.  The int8 conv equals its plain twin bit for bit (integer sums
are exact), in int32 mode and with its epilogue (the twin's plain ops round
where the kernel does), and so does the int8 serve built on each.
"""

import json
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from singleshotpose_tpu_torch.drivers import (TrainRunConfig, _ProfileWindow,
                                              _precompile_buckets, _to_device,
                                              loss_config_from_spec)
from singleshotpose_tpu_torch.models.darknet import (DarknetSpec, Darknet,
                                                     apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import max_corner_confidence as mcc
from singleshotpose_tpu_torch.models import quantize
from singleshotpose_tpu_torch.ops import int8_conv, stem
from singleshotpose_tpu_torch import tracing
from singleshotpose_tpu_torch.ops.targets import build_targets
from singleshotpose_tpu_torch.training import (capture_train_step,
                                               init_train_state,
                                               make_train_step)
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.serving import (MicroBatcher, aot_serving,
                                              make_serving_fn)

from torch_port_helpers import (K2_PATTERNS, TINY_BLOCKS, TINY_MULTI_BLOCKS,
                                k2_inputs, k2_valid)


@pytest.fixture
def dev():
    """The card, with TF32 off for cuDNN and cuBLAS while the test runs: the
    plain versions' f32 convs (the train stem's weight gradient among them)
    are references.  With TF32 on, the plain dW at batch 8, 416² was 2.5e-4
    of max|dW| off the kernel's; with it off, 2.3e-6."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: a CUDA kernel has no CPU mode")
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = \
        saved


def _check(got, ref):
    d = (got.float() - ref.float()).abs()
    assert float(d.max()) <= 1e-2 * float(ref.float().abs().max()) + 1e-3
    assert float((d == 0).float().mean()) >= 0.99


def _serve_weights(dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.3,
            torch.randn((32,), generator=g, device=dev) * 0.3)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(1, 32, 32), (2, 64, 96), (3, 34, 18),
                                   (1, 416, 416), (2, 36, 40)])
def test_stem_kernel_matches_plain_version(dev, B, H, W):
    """(3, 34, 18): odd pooled rows, W % 4 != 0 (the 4-byte halo copies);
    (2, 36, 40): a pooled grid of 18 x 20, no multiple of K1's 8 x 16 tiles
    in either dimension, with the 16-byte copies."""
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
def test_stem_kernel_on_a_misaligned_image(dev):
    """A contiguous view one float into its storage: W % 4 == 0, but the
    image is not 16-byte aligned, so the kernel takes the 4-byte copies."""
    B, H, W = 2, 64, 96
    flat = torch.rand(1 + B * H * W * 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(11))
    img = flat[1:].view(B, H, W, 3)
    assert img.is_contiguous() and img.data_ptr() % 16 != 0
    w, b = _serve_weights(dev, 12)
    got = stem.stem_conv_pool_infer(img, w, b)
    _check(got, stem.stem_conv_pool_infer_reference(img, w, b))


@pytest.mark.cuda
def test_stem_kernel_on_a_flat_image(dev):
    """A flat image: every inner pool window ties.  Its values and weights
    on a grid of 1/64 make every conv sum exact in f32, whatever its order,
    so the kernel must give the plain version's bits everywhere."""
    B, H, W = 2, 64, 96
    img = torch.tensor([0.25, 0.5, 0.75], device=dev).expand(B, H, W, 3) \
        .contiguous()
    w, b = _serve_weights(dev, 13)
    w = torch.round(w * 64) / 64
    got = stem.stem_conv_pool_infer(img, w, b)
    ref = stem.stem_conv_pool_infer_reference(img, w, b)
    _check(got, ref)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_stem_kernel_gives_the_same_bits_twice(dev):
    """(8, 416, 416): 2,704 tiles, several a block of the persistent grid."""
    img = torch.rand((8, 416, 416, 3), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(14))
    w, b = _serve_weights(dev, 15)
    first = stem.stem_conv_pool_infer(img, w, b)
    assert torch.equal(stem.stem_conv_pool_infer(img, w, b), first)


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
    ref = mcc.max_corner_confidence_reference(gt, valid, pred)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got > 0.6, ref > 0.6)
    none = mcc.max_corner_confidence(gt, torch.zeros_like(valid), pred)
    assert not none.any()
    # a float validity takes the same path
    torch.testing.assert_close(
        mcc.max_corner_confidence(gt, valid.float(), pred), got, rtol=0, atol=0)


def _k2_case(dev, pattern, B, G, S, seed):
    """A pattern of tests/torch_port_helpers.py's K2_PATTERNS and its
    inputs, on the card: (gt, valid, pred)."""
    rng = np.random.RandomState(seed)
    valid = k2_valid(pattern, B, G, rng)
    gt, pred = k2_inputs(valid, S, rng)
    return (torch.from_numpy(gt).to(dev), torch.from_numpy(valid).to(dev),
            torch.from_numpy(pred).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("B,G,S", [(8, 50, 169), (2, 50, 676), (2, 300, 169),
                                   (2, 600, 40), (3, 257, 7)])
@pytest.mark.parametrize("pattern", K2_PATTERNS)
def test_max_corner_confidence_kernel_on_valid_patterns(dev, pattern, B, G, S):
    """The patterns the kernel packs differently (1, 8, all slots, no
    prefix, an image with none), also past 256 slots, where the kernel takes
    the slots in rounds of 256."""
    gt, valid, pred = _k2_case(dev, pattern, B, G, S, seed=B * S + G)
    got = mcc.max_corner_confidence(gt, valid, pred)
    ref = mcc.max_corner_confidence_reference(gt, valid, pred)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got > 0.6, ref > 0.6)
    assert not got[~valid.any(1)].any()
    assert (got > 0.6).any()


@pytest.mark.cuda
@pytest.mark.parametrize("S", [845, 1805])
def test_max_corner_confidence_kernel_on_multi_object_frames(dev, S):
    """The multi-object step's traffic: batch 32, nine valid slots an image
    (an eggbox scene: the base object and its 8 companions), 5 anchors on
    the 416² grid (845 cells) and on the 608² one (1805)."""
    gt, valid, pred = _k2_case(dev, "prefix9", 32, 50, S, seed=S)
    got = mcc.max_corner_confidence(gt, valid, pred)
    ref = mcc.max_corner_confidence_reference(gt, valid, pred)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert torch.equal(got > 0.6, ref > 0.6)
    assert (got > 0.6).any()


@pytest.mark.cuda
def test_max_corner_confidence_kernel_packing_keeps_each_pairs_bits(dev):
    """The max over all slots equals the max of the one-slot outputs, bit
    for bit: a pair's mean does not depend on how many pairs share the
    block."""
    gt, valid, pred = _k2_case(dev, "all", 4, 50, 169, seed=9)
    got = mcc.max_corner_confidence(gt, valid, pred)
    one = torch.eye(50, dtype=torch.bool, device=dev)
    each = torch.stack([mcc.max_corner_confidence(
        gt, one[k].expand(4, 50).contiguous(), pred) for k in range(50)])
    assert torch.equal(got, each.amax(0))


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["at", "inside"])
def test_max_corner_confidence_kernel_at_the_80px_threshold(dev, where):
    """x 80 px from the GT at every keypoint (c = 0) or one ulp closer."""
    gt = torch.full((1, 2, 18), 0.5, device=dev)
    px = torch.tensor(0.375)
    if where == "inside":
        px = torch.nextafter(px, torch.tensor(1.0))
    pred = torch.full((1, 2, 18), 0.5, device=dev)
    pred[0, 0, 0::2] = px.to(dev)
    valid = torch.tensor([[True, False]], device=dev)
    got = mcc.max_corner_confidence(gt, valid, pred)
    ref = mcc.max_corner_confidence_reference(gt, valid, pred)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert (got[0, 0] == 0) if where == "at" else (0 < got[0, 0] < 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("th,sharpness,size", [
    (80.0, 2.0, 640.0), (40.0, 1.0, 640.0), (120.0, 3.0, 640.0),
    (2.0 ** 21, 2.0, 2.0 ** 24)])
def test_max_corner_confidence_kernel_at_other_parameters(dev, th, sharpness,
                                                          size):
    """build_targets' th and sharpness and others, up to a threshold of
    2^21 px on a 2^24-px image."""
    gt, valid, pred = _k2_case(dev, "scattered", 2, 50, 169, seed=12)
    kw = dict(th=th, sharpness=sharpness, im_width=size, im_height=size)
    got = mcc.max_corner_confidence(gt, valid, pred, **kw)
    ref = mcc.max_corner_confidence_reference(gt, valid, pred, **kw)
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-6)
    assert (got > 0.1).any()


@pytest.mark.cuda
def test_max_corner_confidence_kernel_with_two_slots_tied(dev):
    valid = np.zeros((2, 8), bool)
    valid[:, [2, 5]] = True                 # slots 2 and 5, holding one GT
    gt, pred = k2_inputs(valid, 40, np.random.RandomState(3))
    gt[:, 5] = gt[:, 2]
    gt, valid, pred = (torch.from_numpy(a).to(dev) for a in (gt, valid, pred))
    one = valid.clone()
    one[:, 5] = False
    got = mcc.max_corner_confidence(gt, valid, pred)
    assert torch.equal(got, mcc.max_corner_confidence(gt, one, pred))
    torch.testing.assert_close(
        got, mcc.max_corner_confidence_reference(gt, valid, pred), rtol=1e-5,
        atol=1e-6)


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


# ---------------------------------------------------------------------------
# the train stem, K3-K6
# ---------------------------------------------------------------------------


def _rel(got, ref):
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def _stem_inputs(dev, B, H, W, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    img = torch.rand((B, H, W, 3), generator=g, device=dev)
    w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.3
    scale = torch.rand((32,), generator=g, device=dev) + 0.5
    scale[3] = -0.7
    bias = torch.randn((32,), generator=g, device=dev) * 0.1
    return img, w, scale, bias


def _glue(sums, n, scale, bias):
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    inv = scale * torch.rsqrt(var + 1e-4)
    return mean, var, inv, bias - mean * inv


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W", [(2, 32, 64), (8, 416, 416), (8, 832, 832),
                                   (3, 34, 70), (2, 36, 40), (32, 320, 320)])
def test_train_stem_kernels_match_plain_versions(dev, B, H, W):
    """(3, 34, 70): a pooled grid of 17 x 35, odd and not a multiple of K6's
    2 x 16 tiles, so every edge tile is ragged; K3 takes its 4-byte halo
    copies (W % 4 != 0).  (2, 36, 40): 18 x 20, no multiple of K3's 8 x 16
    tiles in either dimension, with K3's 16-byte copies.  (32, 320, 320):
    the multi-object step's batch at MULTI_SCHEDULE's narrowest width."""
    img, w, scale, bias = _stem_inputs(dev, B, H, W, seed=B + H)
    n = torch.full((), float(B * H * W), device=dev)
    before = [stem.stem_conv_stats.launches, stem.stem_bn_pool.launches,
              stem.stem_bwd_sums.launches, stem.stem_bwd_dw.launches]
    y, sums = stem.stem_conv_stats(img, w)
    y_ref, sums_ref = stem.stem_conv_stats_reference(img, w)
    torch.cuda.synchronize()
    assert y.shape == (B, H // 2, W // 2, 4, 32) and y.dtype == torch.bfloat16
    _check(y, y_ref)
    assert _rel(sums, sums_ref) <= 1e-5
    # the rest from one set of inputs, the plain version's
    mean, var, inv, shift = _glue(sums_ref, n, scale, bias)
    pooled = stem.stem_bn_pool(y_ref, inv, shift)
    _check(pooled, stem.stem_bn_pool_reference(y_ref, inv, shift))
    assert pooled.shape == (B, H // 2, W // 2, 32) and pooled.is_contiguous()
    g = (torch.randn(pooled.shape, generator=torch.Generator(device=dev)
                     .manual_seed(1), device=dev)).to(torch.bfloat16)
    rstd = torch.rsqrt(var + 1e-4)
    s = stem.stem_bwd_sums(y_ref, g, inv, shift, mean, rstd)
    s_ref = stem.stem_bwd_sums_reference(y_ref, g, inv, shift, mean, rstd)
    assert _rel(s[0], s_ref[0]) <= 1e-5 and _rel(s[1], s_ref[1]) <= 1e-5
    c1, c2 = inv * s_ref[0] / n, inv * s_ref[1] / n
    dw = stem.stem_bwd_dw(y_ref, g, img, inv, shift, mean, rstd, c1, c2)
    dw_ref = stem.stem_bwd_dw_reference(y_ref, g, img, inv, shift, mean, rstd,
                                        c1, c2)
    torch.cuda.synchronize()
    assert dw.shape == (32, 3, 3, 3) and _rel(dw, dw_ref) <= 1e-4
    after = [stem.stem_conv_stats.launches, stem.stem_bn_pool.launches,
             stem.stem_bwd_sums.launches, stem.stem_bwd_dw.launches]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
    # the same bits from run to run: no float atomics in the sums
    y2, sums2 = stem.stem_conv_stats(img, w)
    assert torch.equal(y2, y) and torch.equal(sums2, sums)
    assert torch.equal(stem.stem_bwd_dw(y_ref, g, img, inv, shift, mean, rstd,
                                        c1, c2), dw)


@pytest.mark.cuda
def test_train_stem_conv_kernel_on_a_misaligned_image(dev):
    """K3 on a contiguous view one float into its storage: W % 4 == 0, but
    the image is not 16-byte aligned, so K3 takes its 4-byte copies."""
    B, H, W = 2, 64, 96
    flat = torch.rand(1 + B * H * W * 3, device=dev,
                      generator=torch.Generator(device=dev).manual_seed(16))
    img = flat[1:].view(B, H, W, 3)
    assert img.is_contiguous() and img.data_ptr() % 16 != 0
    w = _stem_inputs(dev, B, H, W, seed=17)[1]
    y, sums = stem.stem_conv_stats(img, w)
    y_ref, sums_ref = stem.stem_conv_stats_reference(img, w)
    _check(y, y_ref)
    assert _rel(sums, sums_ref) <= 1e-5


@pytest.mark.cuda
def test_train_stem_conv_kernel_on_a_flat_image(dev):
    """K3 on a flat image with weights on a grid of 1/64: every conv sum is
    exact in f32, whatever its order, so y must be the plain version's bits
    everywhere (the sums still add in another order: rel 1e-5)."""
    B, H, W = 2, 64, 96
    img = torch.tensor([0.25, 0.5, 0.75], device=dev).expand(B, H, W, 3) \
        .contiguous()
    w = torch.round(_stem_inputs(dev, B, H, W, seed=18)[1] * 64) / 64
    y, sums = stem.stem_conv_stats(img, w)
    y_ref, sums_ref = stem.stem_conv_stats_reference(img, w)
    assert torch.equal(y, y_ref)
    assert _rel(sums, sums_ref) <= 1e-5


@pytest.mark.cuda
def test_train_stem_dw_kernel_on_a_flat_image(dev):
    """K6 on a flat image: every inner pool window is tied and routes its
    gradient to the first position.  g grows across the image and x differs
    by channel, so dW's (tap, co) entries are all distinct and a tap or
    channel mixed up in the kernel's operands shows."""
    B, H, W = 2, 64, 96
    _, w, scale, bias = _stem_inputs(dev, B, H, W, seed=6)
    img = torch.tensor([0.25, 0.5, 0.75], device=dev).expand(B, H, W, 3) \
        .contiguous()
    n = torch.full((), float(B * H * W), device=dev)
    y, sums = stem.stem_conv_stats_reference(img, w)
    mean, var, inv, shift = _glue(sums, n, scale, bias)
    rstd = torch.rsqrt(var + 1e-4)
    Hp, Wp = H // 2, W // 2
    ramp = (1 + 3 * torch.arange(Hp, device=dev)[:, None, None] / Hp) \
        * (1 + 2 * torch.arange(Wp, device=dev)[None, :, None] / Wp)
    g = (torch.randn((B, Hp, Wp, 32), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(2))
         * ramp).to(torch.bfloat16)
    s = stem.stem_bwd_sums_reference(y, g, inv, shift, mean, rstd)
    c1, c2 = inv * s[0] / n, inv * s[1] / n
    dw = stem.stem_bwd_dw(y, g, img, inv, shift, mean, rstd, c1, c2)
    dw_ref = stem.stem_bwd_dw_reference(y, g, img, inv, shift, mean, rstd,
                                        c1, c2)
    torch.cuda.synchronize()
    assert torch.unique(dw_ref).numel() == dw_ref.numel()
    assert _rel(dw, dw_ref) <= 1e-4
    assert torch.equal(stem.stem_bwd_dw(y, g, img, inv, shift, mean, rstd,
                                        c1, c2), dw)


@pytest.mark.cuda
def test_train_stem_function_on_the_card_matches_the_cpu(dev):
    """The autograd.Function with its kernels against itself with the plain
    versions: a bf16 y that rounds the other way can move a window's
    maximum, and so the gradients are held at tests/test_stem.py's bounds
    (dscale, dbias rel 1e-3; dW rel 3e-2)."""
    img, w, scale, bias = _stem_inputs(dev, 2, 64, 96, seed=3)
    cot = torch.randn((2, 32, 48, 32), device=dev)
    grads = []
    for d in (dev, torch.device("cpu")):
        leaves = [t.to(d).clone().requires_grad_() for t in (w, scale, bias)]
        pooled, mean, var = stem.stem_conv_bn_pool_train(img.to(d), *leaves)
        (pooled.float() * cot.to(d)).sum().backward()
        grads.append([pooled.detach().cpu(), mean.cpu(), var.cpu()]
                     + [t.grad.cpu() for t in leaves])
    card, cpu = grads
    _check(card[0], cpu[0])
    for name, a, b, tol in zip(("mean", "var", "dw", "dscale", "dbias"),
                               card[1:], cpu[1:],
                               (1e-5, 1e-5, 3e-2, 1e-3, 1e-3)):
        assert _rel(a, b) <= tol, (name, _rel(a, b))


@pytest.mark.cuda
def test_train_stem_kernels_reject_what_they_cannot_take(dev):
    img, w, scale, bias = _stem_inputs(dev, 2, 32, 64, seed=4)
    with pytest.raises(ValueError, match="even"):
        stem.stem_conv_stats(img[:, :31], w)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_conv_stats(img.transpose(1, 2).contiguous().transpose(1, 2),
                             w)
    with pytest.raises(ValueError):
        stem.stem_conv_stats(img, w.cpu())
    y, _ = stem.stem_conv_stats(img, w)
    ones, zeros = torch.ones(32, device=dev), torch.zeros(32, device=dev)
    with pytest.raises(ValueError):
        stem.stem_bn_pool(y.float(), ones, zeros)
    with pytest.raises(ValueError):
        stem.stem_bn_pool(y, ones.cpu(), zeros)
    g = torch.zeros((2, 16, 32, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(TypeError):
        stem.stem_bwd_sums(y, g.float(), ones, zeros, zeros, ones)
    with pytest.raises(ValueError, match="contiguous"):
        stem.stem_bwd_sums(y, g.transpose(1, 2).contiguous().transpose(1, 2),
                           ones, zeros, zeros, ones)
    with pytest.raises(ValueError, match="do not match"):
        stem.stem_bwd_dw(y, g, img[:, :, :32].contiguous(), ones, zeros,
                         zeros, ones, zeros, zeros)


@pytest.mark.cuda
def test_fused_train_step_runs_the_four_kernels(dev):
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(0),
                    device=dev)
    state = init_train_state(model, weight_decay=1e-3, momentum=0.9)
    target = torch.zeros((2, 50, 21), device=dev)
    target[:, 0, 1:19] = 0.5
    target[:, 0, 19:21] = 0.3
    imgs = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                         device=dev)
    fns = (stem.stem_conv_stats, stem.stem_bn_pool, stem.stem_bwd_sums,
           stem.stem_bwd_dw)
    before = [f.launches for f in fns]
    stats = make_train_step(RegionLossConfig(), fused_stem=True)(
        state, imgs, target.reshape(2, -1), 1e-3, 16)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1, 1, 1, 1]
    assert bool(torch.isfinite(stats["loss"]))


def _scribble(dev):
    """Fill freed memory the allocator keeps with NaNs, so that a graph
    reading a tensor nothing holds any more computes NaNs."""
    import gc
    gc.collect()
    junk = [torch.full((n,), float("nan"), device=dev)
            for n in (1, 64, 4096, 1 << 18) for _ in range(64)]
    del junk


def _tiny_train_state(dev):
    model = Darknet(DarknetSpec(TINY_BLOCKS),
                    generator=torch.Generator().manual_seed(7), device=dev)
    return init_train_state(model, weight_decay=1e-3, momentum=0.9)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


@pytest.mark.cuda
def test_captured_steps_equal_eager_steps_bit_for_bit(dev):
    """Two widths' graphs in one pool, replayed interleaved and across the
    pretrain gate, give the eager steps' losses, weights, BN statistics and
    momentum buffers bit for bit; the fused stem's kernels are recorded once
    a graph (their ``launches`` count captures) and replays run no
    wrapper.  Only the captured step holds the step it recorded."""
    step = make_train_step(RegionLossConfig(), fused_stem=True)
    eager, cap = _tiny_train_state(dev), _tiny_train_state(dev)
    g = torch.Generator().manual_seed(8)
    widths = (64, 96, 64, 96, 96, 64)
    epochs = (15, 15, 15, 16, 16, 16)
    batches = []
    for w in widths:
        target = torch.zeros((2, 50, 21))
        target[:, 0, 1:19] = torch.rand((2, 18), generator=g) * 0.6 + 0.2
        target[:, 0, 19:21] = 0.3
        batches.append((torch.randint(0, 256, (2, w, w, 3), generator=g,
                                      dtype=torch.uint8).to(dev),
                        target.reshape(2, -1).to(dev)))
    before = stem.stem_conv_stats.launches
    captured = capture_train_step(
        make_train_step(RegionLossConfig(), fused_stem=True), cap, (64, 96),
        2, 50 * 21)
    _scribble(dev)
    # the warm-up steps launch it too; each graph recorded it once more
    assert stem.stem_conv_stats.launches - before == 2 * 3
    assert cap.seen == 0
    counted = (stem.stem_conv_stats, mcc.max_corner_confidence)
    before = [f.launches for f in counted]
    losses = []
    for (x, t), e in zip(batches, epochs):
        got = captured(cap, x, t, 1e-3, e)["loss"]
        want = step(eager, x, t, 1e-3, e)["loss"]
        losses.append((got, want))
    torch.cuda.synchronize()
    assert captured.replays == len(widths) and cap.seen == eager.seen == 12
    # the eager steps launched, the replays ran no wrapper
    assert [f.launches - b for f, b in zip(counted, before)] == [6, 6]
    for got, want in losses:
        assert torch.equal(_bits(got), _bits(want))
    for (k, a), b in zip(cap.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(_bits(a), _bits(b)), k
    for p, q in zip(cap.model.parameters(), eager.model.parameters()):
        assert torch.equal(_bits(cap.optimizer.state[p]["momentum_buffer"]),
                           _bits(eager.optimizer.state[q]["momentum_buffer"]))
    with pytest.raises(ValueError, match="no graph captured"):
        captured(cap, batches[0][0][:1], batches[0][1][:1], 1e-3, 16)


@pytest.mark.cuda
def test_precompiled_buckets_fed_as_the_trainers_feed_them(dev, tmp_path):
    """``drivers._precompile_buckets`` on the card returns the captured step;
    fed host batches through ``drivers._to_device`` (pinned, non-blocking,
    no sync between steps) over interleaved widths it gives the eager
    steps' losses and weights bit for bit, and the trainers' profiler
    window traces its replays' kernels and its ``ssp.train.*`` spans, one
    of each a step of the window."""
    step = make_train_step(RegionLossConfig(), fused_stem=True)
    eager, cap = _tiny_train_state(dev), _tiny_train_state(dev)
    captured = _precompile_buckets(
        make_train_step(RegionLossConfig(), fused_stem=True), cap, (64, 96),
        2, 9)
    _scribble(dev)
    assert captured.replays == 0 and cap.seen == 0
    rng = np.random.RandomState(11)
    batches = []
    for w in (96, 64, 64, 96, 64, 96):
        target = np.zeros((2, 50, 21), np.float32)
        target[:, 0, 1:19] = rng.rand(2, 18) * 0.6 + 0.2
        target[:, 0, 19:21] = 0.3
        batches.append((rng.randint(0, 256, (2, w, w, 3)).astype(np.uint8),
                        target.reshape(2, -1)))
    window = _ProfileWindow(TrainRunConfig(profile_dir=str(tmp_path),
                                           profile_steps=(1, 4)), dev)
    tracing.reset()
    losses = []
    for i, (x, t) in enumerate(batches):
        window.before(i)
        got = captured(cap, _to_device(x, dev), _to_device(t, dev), 1e-3,
                       15 + i // 3)["loss"]
        window.after(i + 1)
        want = step(eager, _to_device(x, dev), _to_device(t, dev), 1e-3,
                    15 + i // 3)["loss"]
        losses.append((got, want))
    torch.cuda.synchronize()
    assert captured.replays == len(batches)
    for got, want in losses:
        assert torch.equal(_bits(got), _bits(want))
    for (k, a), b in zip(cap.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(_bits(a), _bits(b)), k
    with open(tmp_path / "train_steps_1_4.json") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    for name in ("ssp.train.copy_in", "ssp.train.replay",
                 "ssp.train.stats_clone"):
        assert sum(r.name == name for r in tracing.records()) == 3, name
        assert sum(e.get("name") == name and e.get("cat") == "user_annotation"
                   for e in events) == 3, name
    tracing.reset()


@pytest.mark.cuda
def test_captured_nccl_group_of_one_equals_eager(dev):
    """``--dp 1``'s NCCL group: its data-parallel step captured per width
    (the sync-BN, gradient and stats all-reduces inside each graph, the
    communicator made by the warm-up steps) gives the eager steps of the
    same group bit for bit over interleaved widths and the pretrain gate;
    each replay counts the global batch in ``seen``."""
    import torch.distributed as dist
    from singleshotpose_tpu_torch.parallel.sharding import make_dp_group
    group = make_dp_group(1, device=dev)
    try:
        assert group.backend == "nccl"
        step = make_train_step(RegionLossConfig(), fused_stem=True,
                               group=group)
        eager, cap = _tiny_train_state(dev), _tiny_train_state(dev)
        captured = capture_train_step(
            make_train_step(RegionLossConfig(), fused_stem=True,
                            group=group), cap, (64, 96), 2, 50 * 21)
        _scribble(dev)
        g = torch.Generator().manual_seed(12)
        losses = []
        for w, e in zip((96, 64, 64, 96, 64), (15, 15, 16, 16, 16)):
            target = torch.zeros((2, 50, 21))
            target[:, 0, 1:19] = torch.rand((2, 18), generator=g) * 0.6 + 0.2
            target[:, 0, 19:21] = 0.3
            x = torch.randint(0, 256, (2, w, w, 3), generator=g,
                              dtype=torch.uint8).to(dev)
            t = target.reshape(2, -1).to(dev)
            losses.append((captured(cap, x, t, 1e-3, e)["loss"],
                           step(eager, x, t, 1e-3, e)["loss"]))
        torch.cuda.synchronize()
        assert captured.replays == 5 and cap.seen == eager.seen == 10
        for got, want in losses:
            assert torch.equal(_bits(got), _bits(want))
        for (k, a), b in zip(cap.model.state_dict().items(),
                             eager.model.state_dict().values()):
            assert torch.equal(_bits(a), _bits(b)), k
        for p, q in zip(cap.model.parameters(), eager.model.parameters()):
            assert torch.equal(
                _bits(cap.optimizer.state[p]["momentum_buffer"]),
                _bits(eager.optimizer.state[q]["momentum_buffer"]))
    finally:
        dist.destroy_process_group()


GRID_WIDTHS = (96, 64, 64, 96, 64)
GRID_EPOCHS = (15, 15, 16, 16, 16)


def _grid_steps(dev, grid) -> dict:
    """The tiny net's split step on ``grid`` captured by
    ``drivers._precompile_buckets`` at 64² and 96² and run over
    GRID_WIDTHS against the same grid's eager steps from the same state:
    what this rank saw.  The graphs are freed when it returns."""
    from singleshotpose_tpu_torch.training import (CapturedTrainStep,
                                                   shard_train_state)
    eager, cap = (shard_train_state(grid, _tiny_train_state(dev))
                  for _ in range(2))
    step = make_train_step(RegionLossConfig(), fused_stem=True, group=grid)
    captured = _precompile_buckets(
        make_train_step(RegionLossConfig(), fused_stem=True, group=grid),
        cap, (64, 96), 2, 9)
    _scribble(dev)
    g = torch.Generator().manual_seed(13)
    losses = []
    for w, e in zip(GRID_WIDTHS, GRID_EPOCHS):
        target = torch.zeros((2, 50, 21))
        target[:, 0, 1:19] = torch.rand((2, 18), generator=g) * 0.6 + 0.2
        target[:, 0, 19:21] = 0.3
        x = torch.randint(0, 256, (2, w, w, 3), generator=g,
                          dtype=torch.uint8).to(dev)
        t = target.reshape(2, -1).to(dev)
        losses.append((captured(cap, x, t, 1e-3, e)["loss"],
                       step(eager, x, t, 1e-3, e)["loss"]))
    torch.cuda.synchronize()
    tensors = [(a, b) for a, b in zip(cap.model.state_dict().values(),
                                      eager.model.state_dict().values())]
    tensors += [(cap.optimizer.state[p]["momentum_buffer"],
                 eager.optimizer.state[q]["momentum_buffer"])
                for p, q in zip(cap.model.parameters(),
                                eager.model.parameters())]
    return {"captured": isinstance(captured, CapturedTrainStep),
            "backend": grid.backend, "mp": grid.mp,
            "split": cap.model.model_shards,
            "replays": getattr(captured, "replays", None),
            "seen": (cap.seen, eager.seen),
            "losses": [float(got) for got, _ in losses],
            "same_losses": all(torch.equal(_bits(a), _bits(b))
                               for a, b in losses),
            "same_state": all(torch.equal(_bits(a), _bits(b))
                              for a, b in tensors),
            "tensors": len(tensors)}


def _grid_rank(rank: int, port: int, out: str) -> None:
    """Rank ``rank`` (on cuda:<rank>) of a dp=1 × mp=2 grid over NCCL:
    :func:`_grid_steps`, its result to ``out<rank>.pt``.  The process
    group is destroyed once the graphs are freed: with a live graph of
    the grid's communicators ProcessGroupNCCL's destroy waits forever."""
    import datetime
    import torch.distributed as dist
    from singleshotpose_tpu_torch.parallel.multihost import (
        initialize_distributed)
    from singleshotpose_tpu_torch.parallel.sharding import make_dp_group
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    initialize_distributed(backend="nccl",
                           init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank, device=dev,
                           timeout=datetime.timedelta(seconds=120))
    result = _grid_steps(dev, make_dp_group(1, 2, device=dev))
    dist.destroy_process_group()
    torch.save(result, f"{out}{rank}.pt")


@pytest.mark.cuda
def test_precompiled_buckets_on_an_nccl_grid_equal_eager(dev, tmp_path):
    """A dp=1 × mp=2 grid over NCCL, one rank a card: the trainers'
    ``_precompile_buckets`` returns a ``CapturedTrainStep`` of the split
    step (the model group's channel gathers and input-gradient sums
    recorded with the other collectives), and its replays over
    interleaved widths and the pretrain gate give the eager grid steps'
    losses, split parameters, BN statistics and momentum buffers bit for
    bit on both ranks; the two ranks' losses agree."""
    import time
    from singleshotpose_tpu_torch.parallel.sharding import free_port
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards: NCCL takes one rank a card, and a "
                    "gloo grid's step cannot be captured")
    ctx = torch.multiprocessing.start_processes(
        _grid_rank, args=(free_port(), str(tmp_path / "rank")), nprocs=2,
        join=False, start_method="spawn")
    deadline = time.monotonic() + 180
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the grid's ranks did not finish in 180 s")
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    for r in ranks:
        assert r["captured"] and r["backend"] == "nccl"
        assert r["mp"] == r["split"] == 2
        assert r["replays"] == len(GRID_WIDTHS)
        assert r["seen"] == (2 * len(GRID_WIDTHS),) * 2
        assert r["same_losses"] and r["same_state"] and r["tensors"] > 0
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(np.isfinite(ranks[0]["losses"]))


@pytest.mark.cuda
def test_captured_gloo_step_is_refused_on_the_card(dev):
    """A gloo group's collectives run on the host: its step on the card is
    refused before any capture, with the reason."""
    import torch.distributed as dist
    from singleshotpose_tpu_torch.parallel.sharding import DPGroup, free_port
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://localhost:{free_port()}")
    try:
        step = make_train_step(RegionLossConfig(), fused_stem=True,
                               group=DPGroup(dev))
        with pytest.raises(ValueError, match="gloo group cannot be captured"):
            capture_train_step(step, _tiny_train_state(dev), (64,), 2,
                               50 * 21)
    finally:
        dist.destroy_process_group()


def _tiny_folded(dev):
    model = Darknet(DarknetSpec(TINY_BLOCKS),
                    generator=torch.Generator().manual_seed(9), device=dev)
    return DarknetSpec(TINY_BLOCKS), fold_batchnorm(model)


@pytest.mark.cuda
def test_aot_serving_result_survives_a_later_call(dev):
    """The graph's outputs are cloned out: an answer not yet read keeps its
    values after the next replay; each equals the eager serve bit for bit,
    whether its frames came from the host (staged through the pinned slots)
    or were on the card already (copied straight in, not staged)."""
    spec, folded = _tiny_folded(dev)
    fn = aot_serving(spec, folded, batch=2, width=64, height=64)
    _scribble(dev)
    serve = make_serving_fn(spec, folded, pick=("best",))
    g = torch.Generator().manual_seed(10)
    x1, x2, x3 = (torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                                dtype=torch.uint8) for _ in range(3))
    a = fn(x1)
    b = fn(x2.to(dev))
    c = fn(x3.numpy())
    torch.cuda.synchronize()
    assert fn.replays == 3 and fn.staged == 2 and fn.slot_waits == 0
    assert torch.equal(a, serve(x1)) and torch.equal(b, serve(x2))
    assert torch.equal(c, serve(x3))
    assert not torch.equal(a, b) and not torch.equal(b, c)
    with pytest.raises(ValueError, match="takes"):
        fn(x1[:1])


@pytest.mark.cuda
@pytest.mark.parametrize("as_numpy", [True, False])
def test_aot_serving_takes_the_frames_before_it_returns(dev, as_numpy):
    """Eight calls launched back to back on four batches, none read or
    synchronised between them, the caller's frames overwritten in place
    after each call: every answer is the eager serve's on the frames as
    they were at the call, bit for bit.  So a call has copied its frames
    out of the caller's memory before it returns, and no pinned slot is
    refilled while its copy to the card runs."""
    spec, folded = _tiny_folded(dev)
    fn = aot_serving(spec, folded, batch=2, width=64, height=64)
    _scribble(dev)
    serve = make_serving_fn(spec, folded, pick=("best",))
    g = torch.Generator().manual_seed(11)
    batches = [torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                             dtype=torch.uint8) for _ in range(4)]
    frames = torch.empty((2, 64, 64, 3), dtype=torch.uint8)
    caller = frames.numpy() if as_numpy else frames
    answers = []
    for i in range(8):
        frames.copy_(batches[i % 4])
        answers.append(fn(caller))
        frames.fill_(i)              # the caller reuses its buffer at once
    torch.cuda.synchronize()
    assert fn.staged == 8 and fn.replays == 8
    for i, got in enumerate(answers):
        assert torch.equal(got, serve(batches[i % 4])), i
    assert not torch.equal(answers[0], answers[1])


@pytest.mark.cuda
def test_aot_serving_behind_a_batcher_with_concurrent_clients(dev):
    """Two graph serves, buckets 1 and 2, behind one MicroBatcher, fed by
    four client threads at once: each batch the batcher formed is answered
    as the eager serve answers it, bit for bit, every frame gets its row of
    its batch, and every call took the staged way in."""
    spec, folded = _tiny_folded(dev)
    fns = {b: aot_serving(spec, folded, batch=b, width=64, height=64)
           for b in (1, 2)}
    _scribble(dev)
    serve = make_serving_fn(spec, folded, pick=("best",))
    frames = torch.randint(0, 256, (16, 64, 64, 3),
                           generator=torch.Generator().manual_seed(12),
                           dtype=torch.uint8).numpy()
    ran = []

    def recorded(b):
        def fn(imgs):
            out = fns[b](imgs)
            ran.append((imgs.copy(), out))
            return out
        return fn

    answers = [None] * len(frames)
    mb = MicroBatcher({b: recorded(b) for b in fns}, height=64, width=64,
                      buckets=(1, 2), max_delay_ms=1.0, start=False)
    with mb:
        def client(c):
            for i in range(c, len(frames), 4):
                answers[i] = mb.infer(frames[i], timeout=60)
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sum(fn.staged for fn in fns.values()) == len(ran)
    assert sum(fn.replays for fn in fns.values()) == len(ran)
    rows = {}
    for imgs, out in ran:
        want = serve(imgs).cpu()
        assert torch.equal(out.cpu(), want)
        for j, img in enumerate(imgs):
            rows.setdefault(img.tobytes(), []).append(want[j])
    for frame, got in zip(frames, answers):
        assert any(torch.equal(got, w) for w in rows[frame.tobytes()])


@pytest.mark.cuda
def test_aot_serving_refuses_to_capture_while_a_batcher_runs(dev):
    """A capture while another thread may use the card would fail in CUDA's
    global capture mode: aot_serving refuses while a MicroBatcher runs, and
    captures once it has closed; a batcher made with ``start=False`` does
    not count until it starts."""
    spec, folded = _tiny_folded(dev)
    serve = make_serving_fn(spec, folded, pick=("best",))
    idle = MicroBatcher(serve, height=64, width=64, buckets=(1,),
                        start=False)
    with MicroBatcher(serve, height=64, width=64, buckets=(1,)) as mb:
        mb.infer(np.zeros((64, 64, 3), np.uint8), timeout=60)
        with pytest.raises(RuntimeError, match="MicroBatcher"):
            aot_serving(spec, folded, batch=1, width=64, height=64)
    fn = aot_serving(spec, folded, batch=1, width=64, height=64)
    idle.close()
    assert fn(np.zeros((1, 64, 64, 3), np.uint8)).shape == (1, 21)


# ---------------------------------------------------------------------------
# the device-resident data path: plain PyTorch ops, held to the CPU's bits
# ---------------------------------------------------------------------------


def _frame_bank(dev, seed=0, N=5, H=48, W=64, NB=3):
    from singleshotpose_tpu_torch.data.device_bank import DeviceFrameBank
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (N, H, W, 3), np.uint8)
    imgs[:, ::3] = imgs[:, ::3, :, :1]                  # grey: saturation 0
    imgs[:, 1::7] = 0                                   # black: value 0
    masks = ((rng.rand(N, H, W) > 0.4) * 255).astype(np.uint8)
    truths = np.zeros((N, 50, 21), np.float32)
    n_rows = np.array([1, 2, 0, 1, 3][:N], np.int32)
    for i in range(N):
        truths[i, :n_rows[i]] = rng.uniform(0.05, 0.95, (n_rows[i], 21))
    bgs = rng.randint(0, 256, (NB, H, W, 3), np.uint8)
    bank = DeviceFrameBank(*map(torch.from_numpy,
                                (imgs, masks, truths, n_rows, bgs)))
    return bank, bank.device_put(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("ow,oh,jitter,hue", [
    (96, 96, 0.2, 0.1),      # the trainers' augmentation
    (61, 47, 0.45, 0.5),     # a width not divisible by 4; crops partly out
    (416, 416, 0.3, 1.0)])   # of the frame; hue shifts of both signs
def test_bank_batch_on_the_card_equals_the_cpu(dev, ow, oh, jitter, hue):
    """The bank's batch (images u8, labels f32) has the CPU's bits: every
    op rounds on its own, divisions are true IEEE divisions on both, and the
    fused multiply-adds are emulated exactly in f64."""
    from singleshotpose_tpu_torch.data.device_augment import draw_params
    from singleshotpose_tpu_torch.data.device_bank import augment_bank_batch
    host, card = _frame_bank(dev)
    B = 8
    rng = np.random.RandomState(ow)
    idxs, bg_idxs = rng.randint(0, 5, B), rng.randint(0, 3, B)
    params, _ = draw_params(rng, B, 64, 48, jitter=jitter, hue=hue,
                            saturation=1.5, exposure=1.5)
    assert (params.dhue < 0).any() and (params.dhue > 0).any()
    assert (params.pleft < 0).any()
    want = augment_bank_batch(host, idxs, bg_idxs, params, out_w=ow, out_h=oh)
    got = augment_bank_batch(card, idxs, bg_idxs, params, out_w=ow, out_h=oh)
    assert got[0].is_cuda and got[0].dtype == torch.uint8
    assert torch.equal(got[0].cpu(), want[0])
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].view(torch.int32))


@pytest.mark.cuda
def test_device_augment_on_the_card_equals_the_cpu(dev):
    """``augment_batch``'s u8 path and its float alpha-blend path."""
    from singleshotpose_tpu_torch.data.device_augment import (augment_batch,
                                                              draw_params)
    rng = np.random.RandomState(5)
    B, H, W = 4, 48, 64
    imgs = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), np.uint8))
    masks = torch.from_numpy(((rng.rand(B, H, W, 1) > 0.5) * 255)
                             .astype(np.uint8))
    bgs = torch.from_numpy(rng.randint(0, 256, (B, H, W, 3), np.uint8))
    params, _ = draw_params(rng, B, W, H, jitter=0.4, hue=0.5,
                            saturation=1.5, exposure=1.5)
    for args in ((imgs, masks, bgs),
                 (imgs.float() / 255, torch.from_numpy(
                     rng.rand(B, H, W, 1).astype(np.float32)),
                  bgs.float() / 255)):
        want = augment_batch(*args, params, 61, 47)
        got = augment_batch(*(a.to(dev) for a in args), params, 61, 47)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_eval_bank_on_the_card_holds_the_rgb_batches(dev, tmp_path):
    from PIL import Image
    from singleshotpose_tpu_torch.data.eval_bank import build_eval_bank
    from singleshotpose_tpu_torch.data.pipeline import Loader, PoseDataset
    rng = np.random.RandomState(2)
    paths = []
    for i in range(5):
        p = tmp_path / f"{i:06d}.png"
        Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(p)
        paths.append(str(p))
    lst = tmp_path / "test.txt"
    lst.write_text("\n".join(paths) + "\n")
    ds = PoseDataset(str(lst), train=False)
    bank = build_eval_bank(ds, (40, 32), 2, num_workers=0, device=dev)
    assert bank.images.is_cuda and bank.n == 5
    host = list(Loader(ds, 2, shuffle=False, schedule=None, fixed_shape=(40, 32),
                       num_workers=0, drop_last=False, out_uint8=True))
    for (bi, _), (hi, _) in zip(bank, host):
        assert torch.equal(bi[:len(hi)].cpu(), torch.from_numpy(hi))


# ---------------------------------------------------------------------------
# on-device multi-object scene synthesis: plain PyTorch ops, held to the
# CPU's bits
# ---------------------------------------------------------------------------


def _scene_bank(seed=2, N=12, H=48, W=64, binary=False):
    """12 frames of 6 classes with soft masks (every composite product
    matters to the bits; ``binary``: 0 or 255), each class with 7
    companions (7 of them empty), and 3 backgrounds, on the CPU."""
    from singleshotpose_tpu_torch.data.device_synth import DeviceSceneBank
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (N, H, W, 3)).astype(np.uint8)
    masks = np.zeros((N, H, W), np.uint8)
    labels = np.zeros((N, 21), np.float32)
    for i in range(N):
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        hh, ww = rng.randint(8, H // 2), rng.randint(8, W // 2)
        masks[i, y0:y0 + hh, x0:x0 + ww] = rng.randint(0, 256, (hh, ww))
        labels[i, 0] = i // 2
        labels[i, 1:19] = rng.uniform(0.0, 1.0, 18)
    if binary:
        masks = ((masks > 127) * 255).astype(np.uint8)
    obj_start = np.zeros(13, np.int32)
    obj_count = np.zeros(13, np.int32)
    obj_start[:6], obj_count[:6] = np.arange(6) * 2, 2
    comp = np.full((14, 8), -1, np.int32)
    for c in range(13):
        comp[c, :7] = [o for o in range(13) if o != c][:7]
    return DeviceSceneBank(*map(torch.from_numpy, (
        imgs, masks, labels, obj_start, obj_count, comp,
        rng.randint(0, 256, (3, H, W, 3)).astype(np.uint8),
        np.arange(N, dtype=np.int32), (np.arange(N) // 2).astype(np.int32))))


@pytest.mark.cuda
@pytest.mark.parametrize("binary", [False, True], ids=["soft", "binary"])
@pytest.mark.parametrize("ps,attempts,ow,oh", [
    (4, 30, 96, 96), (1, 6, 64, 48), (4, 3, 416, 416)])
def test_scene_synthesis_on_the_card_equals_the_cpu(dev, ps, attempts, ow,
                                                    oh, binary):
    """Draws made on the card by a card generator, copied to the CPU: the
    card's scenes and labels have the CPU's f32 composite's bits (true
    divisions on both, the fused multiply-adds emulated exactly in f64); on
    binary masks the card composites on u8 levels."""
    from singleshotpose_tpu_torch.data.device_synth import (
        DeviceSynthStatic, SynthDraws, binary_masks, draw_synth,
        synthesize_batch)
    host = _scene_bank(binary=binary)
    assert binary_masks(host) == binary
    card = host.device_put(dev)
    st = DeviceSynthStatic(jitter=0.1, shift=20, attempts=attempts,
                           propose_scale=ps)
    idx = torch.tensor([0, 3, 7, 10, 11, 5], device=dev)
    draws = draw_synth(torch.Generator(device=dev).manual_seed(ow), 6, card,
                       card.base_class[idx].long(), st, 64, 48)
    assert draws.offset.is_cuda
    got = synthesize_batch(card, idx, draws, out_w=ow, out_h=oh, st=st,
                           binary=binary)
    want = synthesize_batch(host, idx.cpu(), SynthDraws(
        *(d.cpu() for d in draws)), out_w=ow, out_h=oh, st=st)
    assert got[0].is_cuda and got[0].dtype == torch.float32
    assert torch.equal(got[0].cpu().view(torch.int32),
                       want[0].view(torch.int32))
    assert torch.equal(got[1].cpu().view(torch.int32),
                       want[1].view(torch.int32))
    assert int((want[1].view(6, 50, 21)[:, :, 1:].abs().sum(-1) > 0)
               .sum()) > 6                    # companions were pasted


@pytest.mark.cuda
def test_captured_f32_steps_equal_eager_steps(dev):
    """Graphs captured for f32 scenes from the synthesizer (as the multi
    trainer captures them for ``device_synth``) replay the eager steps' bits;
    a u8 batch finds no graph."""
    from singleshotpose_tpu_torch.data.device_synth import (
        DeviceSynthStatic, draw_synth, synthesize_batch)
    spec = DarknetSpec(TINY_MULTI_BLOCKS)
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=0, im_width=640,
                                im_height=480, multi=True)

    def state():
        return init_train_state(
            Darknet(spec, generator=torch.Generator().manual_seed(3),
                    device=dev), weight_decay=1e-3, momentum=0.9)

    eager, cap = state(), state()
    bank = _scene_bank().device_put(dev)
    st = DeviceSynthStatic(jitter=0.1, shift=20, attempts=8, propose_scale=4)
    gen = torch.Generator(device=dev).manual_seed(4)
    batches = []
    for i in range(4):
        idx = torch.arange(2, device=dev) + 2 * i
        batches.append(synthesize_batch(
            bank, idx, draw_synth(gen, 2, bank, bank.base_class[idx].long(),
                                  st, 64, 48), out_w=64, out_h=64, st=st))
    captured = capture_train_step(make_train_step(cfg, fused_stem=True), cap,
                                  (64,), 2, 50 * 21,
                                  image_dtype=torch.float32)
    _scribble(dev)
    step = make_train_step(cfg, fused_stem=True)
    for x, t in batches:
        got = captured(cap, x, t, 1e-3, 1)["loss"]
        want = step(eager, x, t, 1e-3, 1)["loss"]
        assert torch.equal(_bits(got), _bits(want))
    torch.cuda.synchronize()
    for (k, a), b in zip(cap.model.state_dict().items(),
                         eager.model.state_dict().values()):
        assert torch.equal(_bits(a), _bits(b)), k
    for p, q in zip(cap.model.parameters(), eager.model.parameters()):
        assert torch.equal(_bits(cap.optimizer.state[p]["momentum_buffer"]),
                           _bits(eager.optimizer.state[q]["momentum_buffer"]))
    with pytest.raises(ValueError, match="no graph captured"):
        captured(cap, (batches[0][0] * 255).to(torch.uint8), batches[0][1],
                 1e-3, 1)


# ---------------------------------------------------------------------------
# the int8 conv (csrc/int8_conv.cu) and the int8 serve: integer sums are
# exact, so the kernel equals its plain twin bit for bit in any order
# ---------------------------------------------------------------------------


def _int8_case(dev, B, H, W, C, N, k, offset, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    flat = torch.randint(-127, 128, (B * H * W * C + 16,), generator=g,
                         device=dev, dtype=torch.int32).to(torch.int8)
    x = flat[offset:offset + B * H * W * C].view(B, H, W, C)
    wq = torch.randint(-127, 128, (k, k, C, N), generator=g, device=dev,
                       dtype=torch.int32).to(torch.int8)
    return x, int8_conv.pack_weights(wq)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,N,k,stride,pad,offset,vec", [
    (2, 9, 7, 4, 32, 3, 1, 1, 0, 4),        # C_in 3 padded to 4: 4 bytes
    (8, 42, 42, 4, 32, 3, 1, 1, 0, 4),
    (1, 21, 21, 512, 1024, 3, 1, 1, 0, 16),
    (2, 42, 42, 512, 64, 1, 1, 0, 0, 16),   # 1x1, N below the block's 64
    (1, 10, 10, 1280, 1024, 3, 1, 1, 0, 16),
    (2, 8, 8, 32, 64, 3, 2, 1, 0, 16),      # stride 2
    (3, 17, 13, 36, 96, 3, 1, 1, 0, 4),     # the 4-byte copies
    (2, 11, 9, 64, 64, 3, 1, 1, 4, 4),      # misaligned by 4 bytes
    (2, 11, 9, 64, 64, 3, 1, 1, 8, 4),      # misaligned by 8 bytes
    (1, 5, 6, 16, 7, 3, 1, 1, 0, 16)])      # an odd C_out: scalar stores
def test_int8_conv_kernel_matches_twin(dev, B, H, W, C, N, k, stride, pad,
                                       offset, vec):
    x, wk = _int8_case(dev, B, H, W, C, N, k, offset, seed=B * H + C)
    assert int8_conv.copy_width(x) == vec
    before = int8_conv.int8_conv.launches
    got = int8_conv.int8_conv(x, wk, k, stride, pad)
    ref = int8_conv.int8_conv_reference(x, wk, k, stride, pad)
    torch.cuda.synchronize()
    assert int8_conv.int8_conv.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == ref.shape
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_int8_conv_kernel_rejects_what_it_cannot_take(dev):
    x, wk = _int8_case(dev, 1, 8, 8, 32, 64, 3, 0, seed=1)
    with pytest.raises(ValueError, match="contiguous"):
        int8_conv.int8_conv(x.transpose(1, 2), wk, 3, 1, 1)
    with pytest.raises(ValueError, match="packs to"):
        int8_conv.int8_conv(x, wk, 1, 1, 0)
    with pytest.raises(ValueError, match="is on"):
        int8_conv.int8_conv(x, wk.cpu(), 3, 1, 1)
    # no byte-by-byte copies: C_in 3, or an input 1 byte off alignment
    x3, wk3 = _int8_case(dev, 1, 8, 8, 3, 32, 3, 0, seed=2)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_conv.int8_conv(x3, wk3, 3, 1, 1)
    x1, wk1 = _int8_case(dev, 1, 8, 8, 32, 64, 3, 1, seed=3)
    with pytest.raises(ValueError, match="multiples of 4"):
        int8_conv.int8_conv(x1, wk1, 3, 1, 1)


def _outputs_equal(got, want):
    """(value, int8) pairs equal bit for bit (a float's bits as integers)."""
    def bits(t):
        width = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
        return t.view(width[t.dtype]) if t.dtype in width else t
    return all((a is None) == (b is None) and (a is None or (
        a.dtype == b.dtype and torch.equal(bits(a), bits(b))))
        for a, b in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,N,k,stride,pad,offset", [
    (2, 37, 23, 4, 32, 3, 1, 1, 0),          # the first conv, padded C_in
    (2, 20, 20, 64, 200, 3, 1, 1, 0),        # several N tiles, a ragged one
    (1, 10, 10, 1280, 1024, 3, 1, 1, 0),     # deep K
    (2, 11, 9, 64, 64, 3, 1, 1, 4),          # misaligned: 4-byte copies
    (1, 9, 7, 16, 7, 1, 1, 0, 0)])           # an odd C_out
@pytest.mark.parametrize("writes", ["int8", "compute", "both"])
def test_int8_conv_fused_epilogue_matches_twin(dev, B, H, W, C, N, k, stride,
                                               pad, offset, writes):
    """The epilogue in the kernel — the exact FMA, the compute dtype, leaky
    and the next conv's quantizer — equals the twin's plain ops bit for bit
    in bf16 and f32, per-channel and scalar quantizers, both forms."""
    x, wk = _int8_case(dev, B, H, W, C, N, k, offset, seed=B * W + C)
    y = int8_conv.int8_conv_reference(x, wk, k, stride, pad)
    g = torch.Generator(device=dev).manual_seed(N)
    sd = float(y.float().std()) + 1.0
    before = (int8_conv.int8_conv.launches,
              int8_conv.int8_conv.fused_launches)
    n_cases = 0
    for dtype in (torch.bfloat16, None):
        for per_channel in (True, False):
            for divide in (True, False):
                q = torch.rand(N if per_channel else 1, generator=g,
                               device=dev) * 40 + 10
                ep = int8_conv.Epilogue(
                    torch.rand(N, generator=g, device=dev) * 2 / sd,
                    torch.randn(N, generator=g, device=dev) * 0.5,
                    dtype=dtype,
                    quant=None if writes == "compute" else
                    (1 / q if divide else q),
                    divide=divide, value=writes != "int8")
                got = int8_conv.int8_conv(x, wk, k, stride, pad, epilogue=ep)
                want = int8_conv.int8_conv_reference(x, wk, k, stride, pad,
                                                     epilogue=ep)
                torch.cuda.synchronize()
                assert _outputs_equal(got, want), (dtype, per_channel, divide)
                n_cases += 1
    assert (int8_conv.int8_conv.launches - before[0],
            int8_conv.int8_conv.fused_launches - before[1]) == (n_cases,) * 2


def _tiny_int8(dev):
    spec, folded = _tiny_folded(dev)
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(11))
    amax = quantize.calibrate_activations(spec, folded, x.to(dev),
                                          per_channel=True)
    return spec, quantize.quantize_folded(spec, folded, amax)


@pytest.mark.cuda
def test_int8_serve_runs_the_kernel_and_equals_the_twin(dev):
    """The int8 serve on the card launches the int8 conv once a quantized
    conv, and equals the same serve with the twin in its place bit for bit
    (the same cuDNN head conv); its boxes are within JAX's 0.05 of the bf16
    folded serve's."""
    spec, qp = _tiny_int8(dev)
    u8 = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(12))
    serve = make_serving_fn(spec, qp, pick=("best",))
    before = (int8_conv.int8_conv.launches,
              int8_conv.int8_conv.fused_launches)
    got = serve(u8)
    torch.cuda.synchronize()
    n_q = sum("wq" in v for v in qp.values())
    assert int8_conv.int8_conv.launches - before[0] == n_q == 7
    assert int8_conv.int8_conv.fused_launches - before[1] == n_q
    with mock.patch.object(quantize, "int8_conv",
                           int8_conv.int8_conv_reference):
        twin = make_serving_fn(spec, qp, pick=("best",))(u8)
    assert torch.equal(_bits(got), _bits(twin))
    _, folded = _tiny_folded(dev)
    bf16 = make_serving_fn(spec, folded, pick=("best",))(u8)
    assert float((got[:, :18] - bf16[:, :18]).abs().max()) < 0.05
    assert float((got[:, 18] - bf16[:, 18]).abs().max()) < 0.05


@pytest.mark.cuda
def test_int8_aot_serving_equals_eager(dev):
    """The graph of the int8 serve holds its scales and packed weights: after
    the memory the capture freed is scribbled over, its answers equal the
    eager serve's bit for bit; the wrapper ran while it recorded, not at
    replay."""
    spec, qp = _tiny_int8(dev)
    before = int8_conv.int8_conv.launches
    fn = aot_serving(spec, qp, batch=2, width=64, height=64)
    recorded = int8_conv.int8_conv.launches - before
    _scribble(dev)
    serve = make_serving_fn(spec, qp, pick=("best",))
    g = torch.Generator().manual_seed(13)
    for _ in range(2):
        x = torch.randint(0, 256, (2, 64, 64, 3), generator=g,
                          dtype=torch.uint8)
        mark = int8_conv.int8_conv.launches
        got = fn(x)
        assert int8_conv.int8_conv.launches == mark
        assert torch.equal(_bits(got), _bits(serve(x)))
    assert fn.replays == fn.staged == 2
    assert recorded == 2 * 7                        # warm-up and capture


@pytest.mark.cuda
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("constants", [False, True])
def test_int8_forward_on_the_card_equals_the_cpu(dev, per_channel, constants):
    """quantize_folded from the same ranges gives the CPU's bits on the
    card (true divisions, as JAX's eager ones), and with every conv int8
    and the f32 dequant the whole forward does too, in both rounding forms
    and on u8 frames: the int8 conv, the exact FMA and the quantizer round
    alike on both."""
    spec, folded = _tiny_folded(dev)
    cpu_folded = {k: {f: t.cpu() for f, t in d.items()}
                  for k, d in folded.items()}
    x = torch.rand((2, 64, 64, 3), generator=torch.Generator().manual_seed(14))
    amax = quantize.calibrate_activations(spec, cpu_folded, x,
                                          compute_dtype=None,
                                          per_channel=per_channel)
    q_dev = quantize.quantize_folded(spec, folded, amax, skip_layers=())
    q_cpu = quantize.quantize_folded(spec, cpu_folded, amax, skip_layers=())
    for k, d in q_cpu.items():
        for f, t in d.items():
            assert torch.equal(_bits(q_dev[k][f].cpu()), _bits(t)), (k, f)
    u8 = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                       generator=torch.Generator().manual_seed(15))
    for images, scale in ((x, None), (u8.float(), 1 / 255)):
        got = quantize.apply_quantized(spec, q_dev, images.to(dev),
                                       compute_dtype=None,
                                       scales_as_constants=constants,
                                       input_scale=scale)
        want = quantize.apply_quantized(spec, q_cpu, images,
                                        compute_dtype=None,
                                        scales_as_constants=constants,
                                        input_scale=scale)
        assert torch.equal(_bits(got.cpu()), _bits(want))
