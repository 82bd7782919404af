"""PyTorch port vs the JAX package: the region loss and its target
assignment (singleshotpose_tpu_torch/ops/{confidence,max_corner_confidence,
targets,losses}.py).

The same numpy inputs go through both packages on the CPU.  Where the JAX
side reaches the Pallas kernel of pass 1 it runs in interpret mode, as
tests/test_pallas_kernels.py runs it.  Tolerances: the confidences and
their max-over-GT reduction rtol 1e-5, atol 1e-6 (the JAX kernel test's own
bound: the two libraries' exp and mean round differently in the last ulp);
masks and class targets exactly equal, offsets and rescoring targets atol
1e-6; the loss, its stats and its gradient w.r.t. the head rel 1e-5.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu.ops import confidence as JC
from singleshotpose_tpu.ops import losses as JLo
from singleshotpose_tpu.ops import targets as JT
from singleshotpose_tpu.ops.pallas_kernels import \
    max_corner_confidence as jax_max_corner_confidence

from singleshotpose_tpu_torch.ops import confidence as TC
from singleshotpose_tpu_torch.ops import losses as TLo
from singleshotpose_tpu_torch.ops import max_corner_confidence as TK
from singleshotpose_tpu_torch.ops import targets as TT

import torch_port_helpers  # noqa: F401  (caps torch's threads)

K = 9
ANCHORS5 = (1.08, 1.19, 3.42, 4.41, 6.63, 11.38, 9.42, 5.11, 16.62, 10.52)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_corner_confidences_matches_jax():
    rng = np.random.RandomState(0)
    gt = rng.uniform(0, 1, (3, 7, 2 * K)).astype(np.float32)
    # predictions near the GT so the confidences spread over (0, 1), and some
    # beyond the 80 px threshold
    pr = (gt + rng.randn(3, 7, 2 * K) * 0.04).astype(np.float32)
    got = TC.corner_confidences(_t(gt), _t(pr)).numpy()
    want = np.asarray(JC.corner_confidences(jnp.asarray(gt), jnp.asarray(pr)))
    assert 0.05 < got.mean() < 0.95
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # other image size and threshold, broadcast over a new axis
    got = TC.corner_confidences(_t(gt[:, :, None]), _t(pr[:, None]), th=40.0,
                                im_width=320.0, im_height=240.0).numpy()
    want = np.asarray(JC.corner_confidences(
        jnp.asarray(gt[:, :, None]), jnp.asarray(pr[:, None]), th=40.0,
        im_width=320.0, im_height=240.0))
    assert got.shape == (3, 7, 7)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("B,G,S", [(2, 50, 169), (3, 50, 845), (1, 7, 130)])
def test_max_corner_confidence_plain_matches_pallas_kernel(B, G, S):
    rng = np.random.RandomState(B * S)
    gt = rng.uniform(0, 1, (B, G, 2 * K)).astype(np.float32)
    valid = rng.rand(B, G) < 0.3
    # every cell near some GT slot, so the max spreads over (0, 1)
    near = gt[np.arange(B)[:, None], rng.randint(0, G, (B, S))]
    pred = (near + rng.randn(B, S, 2 * K) * 0.03).astype(np.float32)
    want = np.asarray(jax_max_corner_confidence(
        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(pred),
        interpret=True))
    before = TK.max_corner_confidence.launches
    got = TK.max_corner_confidence(_t(gt), _t(valid), _t(pred)).numpy()
    assert TK.max_corner_confidence.launches == before   # no kernel on CPU
    ref = TK.max_corner_confidence_reference(_t(gt), _t(valid), _t(pred))
    np.testing.assert_array_equal(got, ref.numpy())
    assert got.shape == (B, S) and got.dtype == np.float32
    assert (got > 0.6).any() and (got[got > 0] < 0.6).any()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # no valid slot in the batch: zeros
    none = TK.max_corner_confidence(_t(gt), torch.zeros(B, G, dtype=torch.bool),
                                    _t(pred))
    assert not none.any()


def test_max_corner_confidence_rejects_what_it_cannot_take():
    gt, valid = torch.rand(2, 5, 18), torch.ones(2, 5, dtype=torch.bool)
    pred = torch.rand(2, 30, 18)
    with pytest.raises(ValueError):
        TK.max_corner_confidence(gt, valid[:1], pred)
    with pytest.raises(ValueError):
        TK.max_corner_confidence(gt, valid, pred[..., :16])
    with pytest.raises(TypeError):
        TK.max_corner_confidence(gt.double(), valid, pred.double())
    with pytest.raises(ValueError):      # no kernel for this device
        TK.max_corner_confidence(gt.to("meta"), valid.to("meta"),
                                 pred.to("meta"))


def _targets(B, nA, nH, nW, seed, num_classes=1):
    """Padded labels with the cases that matter: two GTs in one cell (the
    later slot wins), a zero-x0 slot that ends the list, an image with no
    GT; and predictions near the GTs."""
    rng = np.random.RandomState(seed)
    G, nl = 50, 2 * K + 3
    t = np.zeros((B, G, nl), np.float32)
    for b in range(B - 1):            # the last image has no GT
        n = 3 + b
        for g in range(n):
            t[b, g, 0] = (b + g) % num_classes
            t[b, g, 1:19] = rng.uniform(0.1, 0.9, 18)
            t[b, g, 19:21] = rng.uniform(0.1, 0.6, 2)
        # slot 1 shares slot 0's centroid cell
        t[b, 1, 1:3] = t[b, 0, 1:3] + 0.1 / max(nW, nH)
        t[b, 1, 1:3] = np.clip(t[b, 1, 1:3], 0.01, 0.99)
        t[b, 1, 1] = (int(t[b, 0, 1] * nW) + 0.5) / nW
        t[b, 1, 2] = (int(t[b, 0, 2] * nH) + 0.5) / nH
        # a zero x0 ends the list: the slots after it are ignored
        t[b, n, 1] = 0.0
        t[b, n + 1, 0:21] = t[b, 0, 0:21]
    S = nA * nH * nW
    cells = rng.randint(0, S, (B, S))
    gts = t[:, :, 1:19]
    pred = gts[np.arange(B)[:, None], np.minimum(cells % 3, 2)] \
        + rng.randn(B, S, 18) * 0.03
    return t.reshape(B, -1), pred.astype(np.float32)


@pytest.mark.parametrize("nA,nH,nW", [(1, 13, 13), (5, 6, 5)],
                         ids=["single", "anchors5"])
def test_build_targets_matches_jax(nA, nH, nW):
    target, pred = _targets(4, nA, nH, nW, seed=nA)
    kw = dict(num_keypoints=K, num_anchors=nA, nH=nH, nW=nW,
              noobject_scale=1.0, object_scale=5.0, sil_thresh=0.6,
              anchors=ANCHORS5 if nA > 1 else ())
    got = TT.build_targets(_t(pred), _t(target), **kw)
    want = JT.build_targets(jnp.asarray(pred), jnp.asarray(target),
                            use_pallas=False, **kw)
    for name in ("coord_mask", "conf_mask", "cls_mask", "tcls", "num_gt",
                 "num_correct"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("txs", "tys", "tconf"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)),
                                   rtol=0, atol=1e-6, err_msg=name)
    # the cases are there: GTs counted up to the break only, a collision
    # resolved to one responsible cell, silenced and object cells both set
    assert int(got.num_gt) == 3 + 4 + 5
    assert int(got.coord_mask.sum()) < int(got.num_gt)
    assert (got.conf_mask == 0).any() and (got.conf_mask == 5.0).any()
    assert not got.coord_mask[-1].any()


def _loss_inputs(B, H, W, nA, C, seed):
    rng = np.random.RandomState(seed)
    head = (rng.randn(B, H, W, nA * (2 * K + 1 + C)) * 0.8).astype(np.float32)
    target, _ = _targets(B, nA, H, W, seed=seed, num_classes=max(C, 1))
    return head, target


@pytest.mark.parametrize("epoch", [3, 15, 16], ids=["pretrain", "at-gate",
                                                    "past-gate"])
@pytest.mark.parametrize("variant", ["single", "multi"])
def test_region_loss_and_grad_match_jax(variant, epoch):
    if variant == "single":
        nA, C, H, W = 1, 1, 13, 13
        extra = {}
    else:
        nA, C, H, W = 5, 3, 6, 5
        extra = dict(num_classes=C, num_anchors=nA, anchors=ANCHORS5,
                     with_class_loss=True)
    head, target = _loss_inputs(4, H, W, nA, C, seed=7 + nA)
    jcfg = JLo.RegionLossConfig(use_pallas=False, **extra)
    tcfg = TLo.RegionLossConfig(**extra)

    def jloss(h):
        return JLo.region_loss(h, jnp.asarray(target), epoch, jcfg)

    (jl, jstats), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(head))
    th = _t(head).requires_grad_(True)
    tl, tstats = TLo.region_loss(th, _t(target), epoch, tcfg)
    tl.backward()
    assert set(tstats) == set(jstats)
    for k in jstats:
        want = float(np.asarray(jstats[k]))
        got = float(tstats[k].detach())
        assert abs(got - want) <= 1e-5 * max(abs(want), 1.0), (k, got, want)
    if epoch <= 15:
        s = {k: float(v.detach()) for k, v in tstats.items()}
        assert s["loss"] == pytest.approx(
            s["loss_x"] + s["loss_y"] + s["loss_cls"], rel=1e-6)
        assert s["loss_conf"] > 0
    if variant == "multi":
        assert float(tstats["loss_cls"]) > 0
    g, jg = th.grad.numpy(), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= 1e-5 * np.abs(jg).max()


def test_region_loss_detaches_the_predicted_corners():
    head, target = _loss_inputs(2, 13, 13, 1, 1, seed=3)
    xs, ys, conf, _, pred = TLo.activate_head(
        _t(head).requires_grad_(True), K, 1, 1)
    assert xs.requires_grad and conf.requires_grad
    assert not pred.requires_grad
    _, _, _, _, jpred = JLo.activate_head(jnp.asarray(head), K, 1, 1)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), rtol=1e-6,
                               atol=1e-7)
