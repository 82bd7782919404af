"""PyTorch port vs the JAX package: the multi-object box picks and their
serving modes (singleshotpose_tpu_torch/ops/decode.py, serving.py).

The picks are gathers and comparisons, so they are held bit for bit: the
same decoded grid (nA = 5, C = 13 on a 6×5 grid) goes through both
packages' ``best_boxes_per_class`` and ``best_box_for_class`` (a scalar and
a per-image class), with thresholds that send every (image, class) pair to
the reference's sequential fallback fold, none of them, or some; and with
det_conf and prob values drawn from a few levels, so that the fold's strict
comparisons meet ties.  ``bbox_iou``/``bbox_ious``, ``nms`` and
``multi_region_boxes_np`` are held on the same inputs.  Through the tiny
multi spec's serving function the picks are held at
``test_serving_fn_matches_jax``'s tolerance (f32 1e-5), and the
``MicroBatcher`` hands each request its (C, 2K+3) row.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import serving as JS
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.ops import decode as JD

from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.models.darknet import Darknet, fold_batchnorm
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops import decode as TD

from torch_port_helpers import TINY_MULTI_BLOCKS, jax_params

B, H, W, NA, C, K = 3, 5, 6, 5, 13, 9
S = NA * H * W

# conf_thresh per regime; "none" and "all" are checked on the grid below
THRESHOLDS = {"fallback_everywhere": 2.0, "fallback_nowhere": -1.0,
              "fallback_on_some": 0.3}


def _grid(ties: bool, seed: int = 0):
    """A decoded grid (corners, det_conf, cls_probs) as numpy f32, the
    probs a softmax of logits; every class is the argmax of some cell of
    every image, and the cells of the odd classes have det_conf ≤ 0.1, so
    at a threshold of 0.3 those classes fall back.  ``ties``: det_conf from
    4 levels and logits rounded to halves, so equal values recur across
    cells."""
    rng = np.random.RandomState(seed)
    corners = rng.rand(B, S, 2 * K).astype(np.float32)
    if ties:
        det = rng.choice(np.array([0.2, 0.4, 0.6, 0.8], np.float32), (B, S))
        logits = np.round(rng.randn(B, S, C) * 2) / 2
    else:
        det = rng.rand(B, S).astype(np.float32)
        logits = rng.randn(B, S, C)
    logits[:, np.arange(S), np.arange(S) % C] += 6.0
    det[:, np.arange(S) % C % 2 == 1] *= 0.1
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits, jnp.float32), -1))
    return corners, det, probs


def _both(grid):
    return (JD.DecodedGrid(*map(jnp.asarray, grid)),
            TD.DecodedGrid(*(torch.from_numpy(np.array(a)) for a in grid)))


def _fallback_pairs(grid, th):
    """(B, C) True where no cell keeps the class: the fold decides."""
    _, det, probs = grid
    keep = (det * probs.max(-1) > th)[:, None, :] & \
        (probs.argmax(-1)[:, None, :] == np.arange(C)[None, :, None])
    return ~keep.any(-1)


@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("regime", sorted(THRESHOLDS))
def test_best_boxes_per_class_matches_jax(regime, ties, seed):
    grid = _grid(ties, seed)
    th = THRESHOLDS[regime]
    fb = _fallback_pairs(grid, th)
    if regime == "fallback_everywhere":
        assert fb.all()
    elif regime == "fallback_nowhere":
        assert not fb.any()
    else:
        assert fb.any() and not fb.all(), fb.mean()
    jg, tg = _both(grid)
    want = np.asarray(JD.best_boxes_per_class(jg, th))
    got = TD.best_boxes_per_class(tg, th).numpy()
    assert got.shape == want.shape == (B, C, 2 * K + 3)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("cls", ["scalar", "per_image"])
@pytest.mark.parametrize("regime", sorted(THRESHOLDS))
def test_best_box_for_class_matches_jax(regime, cls, ties):
    grid = _grid(ties, seed=1)
    th = THRESHOLDS[regime]
    c = 7 if cls == "scalar" else np.array([0, 7, 12])
    jg, tg = _both(grid)
    want = np.asarray(JD.best_box_for_class(jg, jnp.asarray(c), th))
    got = TD.best_box_for_class(tg, torch.as_tensor(c), th).numpy()
    assert got.shape == want.shape == (B, 2 * K + 3)
    np.testing.assert_array_equal(got, want)
    # one class of the per-class picks, the same bits
    per = TD.best_boxes_per_class(tg, th).numpy()
    np.testing.assert_array_equal(got, per[np.arange(B), np.broadcast_to(c, B)])


def _sequential_fold(det, prob):
    """The reference's fold as a Python loop (``utils_multi.py:312-370``)."""
    bd, bc, bi = -np.inf, -np.inf, 0
    for s in range(len(det)):
        if det[s] > bd and prob[s] > bc:
            bd, bc, bi = det[s], prob[s], s
    return bi, bd, bc


@pytest.mark.parametrize("n", [1, 2, 3, 64, 65, 150])
def test_fallback_fold_follows_long_chains(n):
    """Rising det_conf and probs adopt every cell: the longest chain the
    doubling has to follow (⌈log2 n⌉ squarings); a random row with a NaN
    cell and a falling row led by a −inf prob agree with the Python fold
    too."""
    rng = np.random.RandomState(n)
    rise = np.linspace(0.01, 0.99, n, dtype=np.float32)
    noisy = rng.rand(n).astype(np.float32)
    dets = np.stack([rise, noisy, rise])
    probs = np.stack([rise, rng.rand(n).astype(np.float32),
                      rise[::-1].copy()])
    probs[2, 0] = -np.inf               # the first live cell is the second
    if n > 2:
        dets[1, 1] = np.nan
    idx, det, prob = TD._fallback_fold(torch.from_numpy(dets),
                                       torch.from_numpy(probs)[:, None])
    for b in range(3):
        bi, bd, bc = _sequential_fold(dets[b], probs[b])
        assert int(idx[b, 0]) == bi, (b, int(idx[b, 0]), bi)
        assert float(det[b, 0]) == bd and float(prob[b, 0]) == bc
    assert int(idx[0, 0]) == n - 1


def test_fallback_fold_with_no_live_cell():
    dets = torch.tensor([[0.5, 0.7]])
    probs = torch.full((1, 1, 2), float("-inf"))
    idx, det, prob = TD._fallback_fold(dets, probs)
    assert int(idx) == 0 and float(det) == float(prob) == float("-inf")


def test_decode_grid_multi_matches_jax():
    head = np.random.RandomState(2).randn(B, H, W, NA * (2 * K + 1 + C)) \
        .astype(np.float32)
    want = JD.decode_grid(jnp.asarray(head), K, C, NA)
    got = TD.decode_grid(torch.from_numpy(head), K, C, NA)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6)


def test_bbox_iou_matches_jax():
    rng = np.random.RandomState(3)
    boxes = rng.uniform(0.1, 0.9, (12, 4)).astype(np.float32)
    boxes[:, 2:] *= 0.5
    corner = np.concatenate([boxes[:, :2], boxes[:, :2] + boxes[:, 2:]], 1)
    for a in range(12):
        for b in range(12):
            for form, bx in ((False, boxes), (True, corner)):
                assert TD.bbox_iou(bx[a], bx[b], form) == \
                    JD.bbox_iou(bx[a], bx[b], form)
    for form, bx in ((False, boxes), (True, corner)):
        want = np.asarray(JD.bbox_ious(jnp.asarray(bx[:, None]),
                                       jnp.asarray(bx[None]), form))
        got = TD.bbox_ious(torch.from_numpy(bx[:, None]),
                           torch.from_numpy(bx[None]), form).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0 < (got > 0).mean() < 1


def test_nms_matches_jax():
    rng = np.random.RandomState(4)
    boxes = [np.concatenate([rng.uniform(0.3, 0.7, 2), rng.uniform(0.1, 0.3, 2),
                             [c]]) for c in rng.choice([0.2, 0.5, 0.9], 20)]
    want = JD.nms(boxes, 0.3)
    got = TD.nms(boxes, 0.3)
    assert 1 < len(got) == len(want) < len(boxes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert TD.nms([], 0.3) == []


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_multi_region_boxes_np_matches_jax(ties):
    grid = _grid(ties, seed=5)
    jg, tg = _both(grid)
    for th, cls, only_obj in ((0.3, 3, True), (0.3, 4, False),
                              (2.0, 0, True)):
        want = JD.multi_region_boxes_np(jg, th, cls, only_obj)
        got = TD.multi_region_boxes_np(tg, th, cls, only_obj)
        assert [len(g) for g in got] == [len(w) for w in want]
        for gb, wb in zip(got, want):
            for g, w in zip(gb, wb):
                np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------------------
# the serving modes on the tiny multi spec
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_multi():
    jspec, tspec = JSpec(TINY_MULTI_BLOCKS), TSpec(TINY_MULTI_BLOCKS)
    params, stats = jax_params(jspec, seed=21)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    imgs = np.random.RandomState(22).randint(0, 256, (4, 64, 64, 3), np.uint8)
    return jspec, tspec, jfold(jspec, params, stats), fold_batchnorm(model), imgs


@pytest.mark.parametrize("pick", [("per_class", 0.05), ("per_class", 2.0),
                                  ("for_class", 4, 0.05),
                                  ("for_class", 9, 2.0)],
                         ids=["per_class", "per_class_fallback",
                              "for_class", "for_class_fallback"])
def test_serving_fn_class_picks_match_jax(tiny_multi, pick):
    jspec, tspec, jfolded, tfolded, imgs = tiny_multi
    want = np.asarray(jax.jit(JS.make_serving_fn(
        jspec, jfolded, pick=pick, compute_dtype=jnp.float32))(
            jnp.asarray(imgs)))
    got = TS.make_serving_fn(tspec, tfolded, pick=pick,
                             compute_dtype=None)(imgs).numpy()
    shape = (4, 13, 21) if pick[0] == "per_class" else (4, 21)
    assert got.shape == want.shape == shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if pick[0] == "for_class":
        per = TS.make_serving_fn(tspec, tfolded, pick=("per_class", pick[2]),
                                 compute_dtype=None)(imgs).numpy()
        np.testing.assert_array_equal(got, per[:, pick[1]])


def test_microbatcher_hands_back_per_class_rows(tiny_multi):
    _, tspec, _, tfolded, imgs = tiny_multi
    serve = TS.make_serving_fn(tspec, tfolded, pick=("per_class", 0.05),
                               compute_dtype=None)
    direct = serve(imgs).numpy()
    with TS.MicroBatcher(serve, height=64, width=64, buckets=(1, 2, 4),
                         max_delay_ms=5.0) as mb:
        got = [mb.submit(im) for im in imgs]
        got = np.stack([f.result(timeout=60).numpy() for f in got])
    assert got.shape == (4, 13, 21)
    np.testing.assert_allclose(got, direct, rtol=0, atol=1e-5)
