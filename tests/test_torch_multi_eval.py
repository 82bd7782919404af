"""PyTorch port vs the JAX package: the OCCLUSION metrics and eval drivers
(singleshotpose_tpu_torch/evaluate.py, drivers.py, cli.py).

``truths_length``, ``gt_corner_boxes`` and ``multi_accuracy_table`` are
held exactly; ``pose_metrics(fix_gt_corners=True)`` as
``test_pose_metrics_match_jax`` holds it (accuracies equal, the rest at
rel 1e-3).  ``run_validation_multi`` — with the ``class_id`` of the
per-object ``.data`` and with per-class picks — and
``run_validation_multi_sweep`` run in f32 on the OCCLUSION labels of
``tests/linemod_fixture.py`` (class ids set to their objects', the tiny
multi net's weights from a seed) in both packages: the same sample count
and accuracy table; the mean 2D error at rel 1e-3; behind them, the GT
corners equal and the predicted corners within 1e-4 of the normalized
coordinate, as the single-object driver test holds them.
"""

import os

import numpy as np
import pytest
import torch

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import evaluate as JE
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.zoo import LINEMOD_OBJECTS, occlusion_datacfg

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import evaluate as TE
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.config import (data_config_from_options,
                                             read_data_cfg)
from singleshotpose_tpu_torch.models.darknet import Darknet
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.utils.geometry import calc_pts_diameter

from linemod_fixture import make_linemod_fixture, write_random_weights
from test_torch_pose import K, _poses
from torch_port_helpers import TINY_MULTI_BLOCKS, TINY_MULTI_CFG

SWEEP = ("ape", "can", "cat", "driller", "duck", "glue", "holepuncher")


def _label_rows(rng, n):
    lab = np.zeros((50, 21), np.float32)
    lab[:n] = rng.uniform(0.05, 0.95, (n, 21))
    lab[:n, 0] = rng.randint(0, 13, n)
    return lab.reshape(-1)


@pytest.mark.parametrize("n", [0, 1, 9, 50])
def test_truths_length_and_gt_corner_boxes_match_jax(n):
    row = _label_rows(np.random.RandomState(n), n)
    if n == 9:
        row.reshape(50, 21)[11, 1] = 0.5   # a slot after the first empty one
    assert TE.truths_length(row) == JE.truths_length(row) == n
    np.testing.assert_array_equal(TE.gt_corner_boxes(row),
                                  JE.gt_corner_boxes(row))
    assert TE.gt_corner_boxes(row).shape == (n, 18)


def test_multi_accuracy_table_matches_jax():
    errs = np.random.RandomState(1).uniform(0, 60, 37)
    got = TE.multi_accuracy_table(errs)
    assert got == JE.multi_accuracy_table(errs)
    assert list(got) == list(range(5, 55, 5))
    assert 0 < got[5] < got[50] <= 100
    assert TE.multi_accuracy_table([]) == JE.multi_accuracy_table([])


def test_pose_metrics_with_fixed_gt_corners_match_jax():
    X, _, _, px = _poses(24, seed=12)
    # OCCLUSION GT corners come in another order; fix_corner_order undoes it
    gt = px[:, np.argsort([0, 1, 3, 5, 7, 2, 4, 6, 8])]
    pr = px + np.random.RandomState(13).uniform(-2, 2, px.shape)
    corners = X[1:]
    verts = np.concatenate([corners, np.ones((8, 1))], axis=1).T
    fields = (X.astype(np.float32), verts.astype(np.float32),
              K.astype(np.float32), calc_pts_diameter(corners), 640, 480)
    tctx, jctx = TE.EvalContext(*fields), JE.EvalContext(*fields)
    got = TE.pose_metrics(gt, pr, tctx, fix_gt_corners=True, device="cpu")
    ref = JE.pose_metrics(gt, pr, jctx, fix_gt_corners=True)
    # the corner error needs no PnP: the permuted GT, to f32 rounding
    np.testing.assert_allclose(got["err_corner2d"], ref["err_corner2d"],
                               rtol=1e-6)
    te, je = TE.PoseErrors(), JE.PoseErrors()
    te.extend(got)
    je.extend(ref)
    ts, js = TE.accuracy_summary(te, tctx.diam), JE.accuracy_summary(je,
                                                                      jctx.diam)
    for k in ts:
        if k.startswith("acc_"):
            assert ts[k] == js[k], (k, ts[k], js[k])
        else:
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    assert 0 < ts["acc_2d_proj"] < 100
    # without the permutation the same frames are far off
    assert TE.pose_metrics(gt, pr, tctx)["err_corner2d"].min() > 5


@pytest.fixture(scope="module")
def occlusion(tmp_path_factory):
    """The fixture's OCCLUSION tree (benchvise frames, labels_occlusion for
    the sweep's 7 objects, class ids set), the per-object and the combined
    ``.data`` files, the tiny multi cfg and its seeded weights."""
    root = str(tmp_path_factory.mktemp("occ"))
    lm = make_linemod_fixture(root, ("benchvise",) + SWEEP, n_frames=3,
                              occlusion_objects=SWEEP, seed=40)
    for obj in SWEEP:
        lo = os.path.join(lm, obj, "labels_occlusion")
        for name in os.listdir(lo):
            lab = np.loadtxt(os.path.join(lo, name), ndmin=2)
            lab[:, 0] = LINEMOD_OBJECTS.index(obj)
            np.savetxt(os.path.join(lo, name), lab)
    datacfgs = {}
    for obj in SWEEP:
        datacfgs[obj] = os.path.join(root, f"{obj}_occlusion.data")
        with open(datacfgs[obj], "w") as f:
            f.write(occlusion_datacfg(obj, linemod_root=lm,
                                      backup_root=os.path.join(root, "bk")))
    occ = os.path.join(root, "occlusion.data")
    with open(occ, "w") as f:
        f.write(occlusion_datacfg(linemod_root=lm,
                                  backup_root=os.path.join(root, "bk")))
    cfg = os.path.join(root, "tiny_multi.cfg")
    with open(cfg, "w") as f:
        f.write(TINY_MULTI_CFG)
    wfile = os.path.join(root, "w", "tiny_multi.weights")
    write_random_weights(JSpec(TINY_MULTI_BLOCKS), wfile, seed=41)
    return datacfgs, occ, cfg, wfile


def _assert_results_match(got, want):
    assert got["name"] == want["name"]
    assert got["n_samples"] == want["n_samples"] == 3
    assert got["acc_table"] == want["acc_table"]
    np.testing.assert_allclose(got["mean_err_2d"], want["mean_err_2d"],
                               rtol=1e-3)


@pytest.mark.parametrize("pick", ["class_id", "per_class"])
def test_run_validation_multi_matches_jax(occlusion, pick):
    datacfgs, _, cfg, wfile = occlusion
    kw = dict(batch_size=2, num_workers=0, compute_dtype=None, verbose=False)
    for obj in ("ape", "duck"):
        tdc = jdc = datacfgs[obj]
        if pick == "per_class":     # a DataConfig has no class_id key
            tdc = data_config_from_options(read_data_cfg(tdc))
            jdc = _jax_dcfg(jdc)
        got = TDr.run_validation_multi(tdc, cfg, wfile, device="cpu", **kw)
        want = JDr.run_validation_multi(jdc, cfg, wfile, **kw)
        _assert_results_match(got, want)
        assert np.isfinite(got["mean_err_2d"])


def _jax_dcfg(path):
    from singleshotpose_tpu.config import (data_config_from_options as jdco,
                                           read_data_cfg as jread)
    return jdco(jread(path))


def test_per_class_eval_pass_matches_jax(occlusion):
    """The corners behind the numbers: each GT paired with the box of its
    own class, in both packages."""
    from singleshotpose_tpu.data.pipeline import Loader, PoseDataset
    datacfgs, _, cfg, wfile = occlusion
    dcfg = _jax_dcfg(datacfgs["cat"])
    jspec, tspec = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)

    def loader():
        ds = PoseDataset(dcfg.valid, train=False, label_path_fn=lambda p: (
            p.replace("benchvise", "cat").replace("JPEGImages",
                                                  "labels_occlusion")
            .replace(".jpg", ".txt")))
        return Loader(ds, 2, shuffle=False, schedule=None, fixed_shape=(64, 64),
                      num_workers=0, drop_last=False, out_uint8=True)

    _, params, stats = JW.load_weights(jspec, wfile)
    pick = ("per_class", 0.05)
    _, jart = JDr._eval_pass(jspec, params, stats, loader(),
                             JDr.EvalContext.from_data_config(dcfg),
                             pick=pick, num_keypoints=9, fix_gt_corners=True,
                             compute_dtype=None)
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, wfile)[1])
    _, tart = TDr._eval_pass(tspec, model, loader(),
                             TDr.EvalContext.from_data_config(dcfg),
                             compute_dtype=None, device="cpu", pick=pick,
                             fix_gt_corners=True)
    np.testing.assert_array_equal(tart["image_idx"], jart["image_idx"])
    np.testing.assert_array_equal(tart["corners_gt"], jart["corners_gt"])
    np.testing.assert_allclose(tart["corners_pr"] / [640, 480],
                               jart["corners_pr"] / [640, 480], rtol=0,
                               atol=1e-4)


def test_run_validation_multi_sweep_matches_jax(occlusion):
    _, occ, cfg, wfile = occlusion
    kw = dict(batch_size=3, num_workers=0, compute_dtype=None, verbose=False)
    got = TDr.run_validation_multi_sweep(occ, cfg, wfile, device="cpu", **kw)
    want = JDr.run_validation_multi_sweep(occ, cfg, wfile, **kw)
    assert [r["name"] for r in got] == [r["name"] for r in want] == list(SWEEP)
    for g, w in zip(got, want):
        _assert_results_match(g, w)


def test_cli_valid_multi_on_cpu(occlusion, capsys):
    datacfgs, occ, cfg, wfile = occlusion
    assert tcli(["valid-multi", "--modelcfg", cfg, "--weightfile", wfile,
                 "--datacfgs", datacfgs["ape"], datacfgs["glue"],
                 "--batch_size", "2", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Testing ape" in out and "Testing glue" in out
    assert out.count("Acc using 50 px 2D Projection") == 2
    assert tcli(["valid-multi", "--modelcfg", cfg, "--weightfile", wfile,
                 "--datacfg", occ, "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("Acc using 5 px 2D Projection") == 7


def test_cli_valid_multi_refuses_missing_cuda(occlusion):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    datacfgs, _, cfg, wfile = occlusion
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli(["valid-multi", "--modelcfg", cfg, "--weightfile", wfile,
              "--datacfgs", datacfgs["ape"]])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDr.run_validation_multi(datacfgs["ape"], cfg, wfile)
