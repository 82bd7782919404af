"""PyTorch port vs the JAX package: the OCCLUSION trainer
(singleshotpose_tpu_torch/drivers.py ``loss_config_from_spec(multi=True)``,
``run_training_multi``; cli.py ``train-multi``).

The multi loss config equals JAX's field by field.  Three f32 steps of the
tiny multi net (13 classes, 5 anchors) on frames with 1–9 GTs of mixed
classes follow JAX's trajectory at the tolerances of
``test_five_step_trajectory_matches_jax`` (loss and class loss rel 1e-4,
the state rel 1e-4).  ``run_training_multi`` runs one epoch on the CPU over
scenes synthesized from ``tests/linemod_fixture.py``'s tree, evaluates at
epoch 0 as the reference does, and writes a ``model.weights`` that both
packages load; ``cli train-multi`` runs with ``--device cpu`` and refuses
a missing CUDA device.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import training as JTr
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.zoo import LINEMOD_OBJECTS, occlusion_datacfg

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import training as TTr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec

from linemod_fixture import make_linemod_fixture
from test_torch_training import (DECAY, LR, MOM, _assert_state_close,
                                 _port_state)
from torch_port_helpers import TINY_MULTI_BLOCKS, TINY_MULTI_CFG, jax_params

B, EPOCH = 2, 16


@pytest.mark.parametrize("multi", [False, True], ids=["single", "multi"])
def test_loss_config_from_spec_matches_jax(multi):
    jspec, tspec = JSpec(TINY_MULTI_BLOCKS), TSpec(TINY_MULTI_BLOCKS)
    kw = dict(pretrain_num_epochs=3, im_width=640, im_height=480, multi=multi)
    got = TDr.loss_config_from_spec(tspec, **kw)
    want = JDr.loss_config_from_spec(jspec, **kw)
    for field in ("num_keypoints", "num_classes", "num_anchors", "anchors",
                  "coord_scale", "noobject_scale", "object_scale",
                  "class_scale", "sil_thresh", "pretrain_num_epochs",
                  "with_class_loss", "im_width", "im_height", "max_num_gt"):
        assert getattr(got, field) == getattr(want, field), field
    assert got.with_class_loss is multi and got.num_anchors == 5


def _multi_batches(n, seed):
    """``n`` (u8 images, padded targets): 1–9 GTs an image, classes 0–12,
    each GT's 8 corners around its centroid, extents from them."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        imgs = rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
        t = np.zeros((B, 50, 21), np.float32)
        for b in range(B):
            for g in range(rng.randint(1, 10)):
                c = rng.uniform(0.15, 0.85, 2)
                pts = np.vstack([c, c + rng.uniform(-0.1, 0.1, (8, 2))])
                t[b, g, 0] = rng.randint(13)
                t[b, g, 1:19] = pts.reshape(-1)
                t[b, g, 19:21] = np.ptp(pts, axis=0)
        out.append((imgs, t.reshape(B, -1)))
    return out


def test_multi_steps_match_jax():
    jspec, tspec = JSpec(TINY_MULTI_BLOCKS), TSpec(TINY_MULTI_BLOCKS)
    params, stats = jax_params(jspec, seed=31)
    kw = dict(pretrain_num_epochs=15, im_width=640, im_height=480, multi=True)
    jstep = JTr.make_train_step(
        jspec, JDr.loss_config_from_spec(jspec, use_pallas=False, **kw),
        weight_decay=DECAY * B, momentum=MOM, compute_dtype=None,
        donate=False)
    jstate = JTr.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, stats))
    state = _port_state(tspec, params, stats)
    step = TTr.make_train_step(TDr.loss_config_from_spec(tspec, **kw),
                               compute_dtype=None)
    for i, (imgs, tgt) in enumerate(_multi_batches(3, seed=32)):
        jstate, jst = jstep(jstate, jnp.asarray(imgs), jnp.asarray(tgt),
                            np.float32(LR), np.int32(EPOCH))
        st = step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR,
                  EPOCH)
        for k in ("loss", "loss_cls", "loss_conf"):
            want = float(jst[k])
            assert abs(float(st[k]) - want) <= 1e-4 * abs(want), (i, k)
        assert int(st["nGT"]) == int(jst["nGT"]) > B
        assert float(st["loss_cls"]) > 0
    _assert_state_close(tspec, state, jstate, 1e-4)


@pytest.fixture(scope="module")
def occ_tree(tmp_path_factory):
    """A multi train list over the fixture's ape and can frames, its
    ``.data``, ape's OCCLUSION eval ``.data`` and the tiny multi cfg."""
    root = str(tmp_path_factory.mktemp("occ_train"))
    lm = make_linemod_fixture(root, ("benchvise", "ape", "can", "cat"),
                              n_frames=2, occlusion_objects=("ape",),
                              seed=50)
    lo = os.path.join(lm, "ape", "labels_occlusion")
    for name in os.listdir(lo):
        lab = np.loadtxt(os.path.join(lo, name), ndmin=2)
        lab[:, 0] = LINEMOD_OBJECTS.index("ape")
        np.savetxt(os.path.join(lo, name), lab)
    train = os.path.join(root, "train_occlusion.txt")
    with open(train, "w") as f:
        f.write("\n".join(os.path.join(lm, o, "JPEGImages", f"00{i:04d}.jpg")
                          for o in ("ape", "can") for i in range(2)) + "\n")
    occ = os.path.join(root, "occlusion.data")
    with open(occ, "w") as f:
        f.write(occlusion_datacfg(linemod_root=lm, train_list=train,
                                  backup_root=os.path.join(root, "bk")))
    ape = os.path.join(root, "ape_occlusion.data")
    with open(ape, "w") as f:
        f.write(occlusion_datacfg("ape", linemod_root=lm))
    cfg = os.path.join(root, "tiny_multi.cfg")
    with open(cfg, "w") as f:
        f.write(TINY_MULTI_CFG)
    return root, lm, occ, ape, cfg


def test_run_training_multi_writes_weights_that_both_packages_load(occ_tree):
    root, lm, occ, ape, cfg = occ_tree
    rc = TDr.TrainRunConfig(eval_every=20, eval_after=-1, num_workers=2,
                            eval_batch_size=2,
                            bg_dir=os.path.join(root, "VOC", "JPEGImages"),
                            log_every=1, max_epochs_override=1,
                            compute_dtype=None, device="cpu",
                            checkpoint_dir=os.path.join(root, "ckpt"))
    result = TDr.run_training_multi(occ, cfg, None, 0, [ape], None, rc)
    hist = result["history"]
    assert len(hist["training_losses"]) == 2          # 4 frames, batch 2
    assert np.isfinite(hist["training_losses"]).all()
    assert hist["testing_iters"] == [2]                # epoch 0 evaluates
    assert np.isfinite(result["best_acc"])
    state = result["state"]
    assert state.seen == 4
    assert Checkpointer(os.path.join(root, "ckpt")).latest_step() == 2

    path = os.path.join(root, "bk", "model.weights")
    assert os.path.exists(os.path.join(root, "bk", "costs.npz"))
    header, params, stats = JW.load_weights(JSpec.from_cfg(cfg), path)
    assert header.seen == 4
    tspec = TSpec.from_cfg(cfg)
    want = TW.params_from_jax(tspec, params, stats)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)
    _, sd = TW.load_weights(tspec, path)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(), k)


def test_cli_train_multi_on_cpu(occ_tree, capsys):
    root, lm, occ, _, cfg = occ_tree
    assert tcli(["train-multi", "--datacfg", occ, "--modelcfg", cfg,
                 "--initweightfile", "", "--linemod_root", lm,
                 "--max_epochs", "1", "--bg_dir", "/nonexistent",
                 "--checkpoint_dir", os.path.join(root, "cli_ckpt"),
                 "--eval_datacfgs", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[multi] epoch 0" in out and "best accuracy: -inf" in out
    assert "no eval ran" in out
    assert Checkpointer(os.path.join(root, "cli_ckpt")).latest_step() == 2


def test_cli_train_multi_refuses_missing_cuda(occ_tree):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, _, occ, _, cfg = occ_tree
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli(["train-multi", "--datacfg", occ, "--modelcfg", cfg,
              "--initweightfile", ""])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDr.run_training_multi(occ, cfg, None, 0, None, None,
                               TDr.TrainRunConfig(device="cuda"))
