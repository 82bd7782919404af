"""PyTorch port vs the JAX package: grid decode, box pick, PnP and the 6D
metrics (singleshotpose_tpu_torch/ops/decode.py, ops/pnp.py, evaluate.py).

Tolerances: decode to atol 1e-6 (sigmoid and softmax are separate
implementations) with identical picked cells, ties included; PnP within 2 mm
and 0.2° of the truth, as tests/test_pnp.py holds the JAX solver; metrics on
well-posed corners (truth plus ≤ 2 px noise) with equal accuracies and mean
errors to rtol 1e-3 (two f32 solvers land on one optimum, not one bit
pattern).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from singleshotpose_tpu import evaluate as JE
from singleshotpose_tpu.ops import decode as JD
from singleshotpose_tpu.ops.pnp import pnp_batched as jpnp
from singleshotpose_tpu.utils.geometry import (calc_angular_distance,
                                               calc_pts_diameter,
                                               get_camera_intrinsic)

from singleshotpose_tpu_torch import evaluate as TE
from singleshotpose_tpu_torch.ops import decode as TD
from singleshotpose_tpu_torch.ops.pnp import pnp, pnp_batched, so3_exp

import torch_port_helpers  # noqa: F401  (caps torch threads)

K = get_camera_intrinsic(325.2611, 242.0489, 572.4114, 573.5704)


def _head(nA, C, seed, tie=True):
    rng = np.random.RandomState(seed)
    E = 2 * 9 + 1 + C
    head = rng.randn(3, 5, 6, nA * E).astype(np.float32) * 2
    if tie:
        # image 0: two cells share the top confidence → the first one wins;
        # image 2: every cell ties
        a = nA - 1
        head[0, 1, 2, a * E + 18] = head[0, 3, 4, 0 * E + 18] = 9.0
        head[2, ..., [a * E + 18 for a in range(nA)]] = 3.0
    return head


@pytest.mark.parametrize("nA,C", [(1, 1), (5, 13)])
def test_decode_and_best_boxes_match_jax(nA, C):
    head = _head(nA, C, seed=nA)
    got = TD.decode_grid(torch.from_numpy(head), 9, C, nA)
    ref = JD.decode_grid(jnp.asarray(head), 9, C, nA)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)
    for only_obj in (True, False):
        gi = torch.argmax(got.det_conf if only_obj else
                          got.det_conf * got.cls_probs.amax(-1), -1)
        ri = jnp.argmax(ref.det_conf if only_obj else
                        ref.det_conf * ref.cls_probs.max(-1), -1)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(ri))
        np.testing.assert_allclose(
            TD.best_boxes(got, only_obj).numpy(),
            np.asarray(JD.best_boxes(ref, only_obj)), rtol=0, atol=1e-6)
    # the ties: the first cell in anchor-major order wins
    first = torch.argmax(got.det_conf, -1)
    assert int(first[2]) == 0
    if nA == 1:
        assert int(first[0]) == 1 * 6 + 2


def test_split_activate_cell_order_matches_jax():
    head = _head(5, 13, seed=7, tie=False)
    got = TD.split_activate(torch.from_numpy(head), 9, 13, 5)
    ref = JD.split_activate(jnp.asarray(head), 9, 13, 5)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    ext = rng.uniform(0.3, 1.0, 3) * 0.1
    X = np.array([[0, 0, 0]] + [[sx * ext[0], sy * ext[1], sz * ext[2]]
                                for sx in (-1, 1) for sy in (-1, 1)
                                for sz in (-1, 1)])
    Rs = so3_exp(torch.from_numpy(rng.randn(n, 3) * 0.8)).numpy()
    ts = np.stack([rng.uniform(-.1, .1, n), rng.uniform(-.1, .1, n),
                   rng.uniform(.5, 1.5, n)], axis=1)
    uvw = (np.einsum("bij,nj->bni", Rs, X) + ts[:, None]) @ K.T
    return X, Rs, ts, uvw[..., :2] / uvw[..., 2:]


def test_so3_exp_matches_jax():
    from singleshotpose_tpu.ops.pnp import so3_exp as jexp
    w = np.random.RandomState(8).randn(6, 3).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-7
    got = so3_exp(torch.from_numpy(w)).numpy()
    for i in range(len(w)):
        np.testing.assert_allclose(got[i], np.asarray(jexp(jnp.asarray(w[i]))),
                                   rtol=0, atol=1e-6)


def test_pnp_batched_matches_truth_and_jax():
    X, Rs, ts, px = _poses(16, seed=9)
    X32, px32 = X.astype(np.float32), px.astype(np.float32)
    R, t = pnp_batched(X32, px32, K)
    Rj, tj = jpnp(X32, px32, K)
    for i in range(len(Rs)):
        assert calc_angular_distance(Rs[i], R[i].double().numpy()) < 0.2
        assert np.linalg.norm(t[i].numpy() - ts[i]) < 2e-3
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-4)
    np.testing.assert_allclose(t.numpy(), np.asarray(tj), atol=1e-4)
    R0, t0 = pnp(X32, px32[3], K)
    np.testing.assert_allclose(R0.numpy(), R[3].numpy(), atol=1e-5)
    np.testing.assert_allclose(t0.numpy(), t[3].numpy(), atol=1e-5)


def test_pose_metrics_match_jax():
    X, _, _, px = _poses(24, seed=10)
    rng = np.random.RandomState(11)
    pr = px + rng.uniform(-2, 2, px.shape)
    corners = X[1:]
    verts = np.concatenate([corners, np.ones((8, 1))], axis=1).T
    fields = (X.astype(np.float32), verts.astype(np.float32),
              K.astype(np.float32), calc_pts_diameter(corners), 640, 480)
    tctx, jctx = TE.EvalContext(*fields), JE.EvalContext(*fields)
    got = TE.pose_metrics(px, pr, tctx, device="cpu")
    ref = JE.pose_metrics(px, pr, jctx)
    te, je = TE.PoseErrors(), JE.PoseErrors()
    te.extend(got)
    je.extend(ref)
    ts = TE.accuracy_summary(te, tctx.diam)
    js = JE.accuracy_summary(je, jctx.diam)
    assert ts.keys() == js.keys() and ts["n_samples"] == js["n_samples"] == 24
    for k in ts:
        if k.startswith("acc_"):
            assert ts[k] == js[k], (k, ts[k], js[k])
        else:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    # some frames pass and some fail the 5 px test, so the accuracy is tested
    assert 0 < ts["acc_2d_proj"] < 100
