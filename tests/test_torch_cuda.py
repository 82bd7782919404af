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
dW rel 1e-4 of max|ref|.
"""

import pytest
import torch

from singleshotpose_tpu_torch.models.darknet import (DarknetSpec, Darknet,
                                                     apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import max_corner_confidence as mcc
from singleshotpose_tpu_torch.ops import stem
from singleshotpose_tpu_torch.ops.targets import build_targets
from singleshotpose_tpu_torch.training import init_train_state, make_train_step
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig

from torch_port_helpers import TINY_BLOCKS


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
                                   (3, 34, 70), (2, 36, 40)])
def test_train_stem_kernels_match_plain_versions(dev, B, H, W):
    """(3, 34, 70): a pooled grid of 17 x 35, odd and not a multiple of K6's
    2 x 16 tiles, so every edge tile is ragged; K3 takes its 4-byte halo
    copies (W % 4 != 0).  (2, 36, 40): 18 x 20, no multiple of K3's 8 x 16
    tiles in either dimension, with K3's 16-byte copies."""
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
