"""The port's training driver and ``cli train`` end to end on the CPU
(singleshotpose_tpu_torch/drivers.py, cli.py, checkpoint.py), on the
synthetic LINEMOD-format set that tests/test_drivers.py trains the JAX
package on: 6 frames, the tiny cfg, batch 2.

Checked: one finite loss per batch, the eval cadence writes
``model.weights`` and ``costs.npz``, that file loads in the JAX package bit
for bit and in the port's ``run_validation`` with the right sample count;
``cli train`` starts from it as a backbone, checkpoints, and resumes; and
without CUDA the CLI refuses unless ``--device cpu`` is asked for.
"""

import os

import numpy as np
import pytest
import torch

from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from test_drivers import TINY_CFG, _make_synthetic_linemod


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_synth")
    datacfg, backup = _make_synthetic_linemod(tmp)
    cfgfile = tmp / "tiny.cfg"
    cfgfile.write_text(TINY_CFG)
    return datacfg, str(cfgfile), backup, tmp


def test_run_training_writes_weights_that_both_packages_load(synth):
    datacfg, cfgfile, backup, tmp = synth
    rc = TDr.TrainRunConfig(eval_every=1, eval_after=0, num_workers=2,
                            eval_batch_size=3, bg_dir="/nonexistent",
                            log_every=2, max_epochs_override=2,
                            compute_dtype=None, device="cpu",
                            checkpoint_dir=str(tmp / "ckpt"))
    result = TDr.run_training(datacfg, cfgfile, None, 100, rc)
    hist = result["history"]
    assert len(hist["training_losses"]) == 6          # 3 batches x 2 epochs
    assert np.isfinite(hist["training_losses"]).all()
    assert hist["testing_iters"] == [6]                # epoch 1: 1 % 1, 1 > 0
    assert np.isfinite(result["best_acc"])
    state = result["state"]
    assert state.seen == 12
    assert Checkpointer(str(tmp / "ckpt")).latest_step() == 6

    # the best-model file: bit for bit in the JAX package, with seen
    path = os.path.join(backup, "model.weights")
    assert os.path.exists(os.path.join(backup, "costs.npz"))
    header, params, stats = JW.load_weights(JSpec.from_cfg(cfgfile), path)
    assert header.seen == 12
    tspec = TSpec.from_cfg(cfgfile)
    want = TW.params_from_jax(tspec, params, stats)
    got = state.model.state_dict()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)

    summary = TDr.run_validation(datacfg, cfgfile, path, batch_size=3,
                                 num_workers=0, compute_dtype=None,
                                 device="cpu", verbose=False)
    assert summary["n_samples"] == 6
    assert np.isfinite(summary["mean_err_2d"])


def test_cli_train_from_a_backbone_then_resume(synth, capsys):
    datacfg, cfgfile, backup, tmp = synth
    init = str(tmp / "init.weights")
    TW.save_weights(TSpec.from_cfg(cfgfile), dict(TDr.Darknet(
        TSpec.from_cfg(cfgfile), generator=torch.Generator().manual_seed(3))
        .state_dict()), init, seen=999)
    ckpt = str(tmp / "cli_ckpt")
    args = ["train", "--datacfg", datacfg, "--modelcfg", cfgfile,
            "--initweightfile", init, "--bg_dir", "/nonexistent",
            "--checkpoint_dir", ckpt, "--device", "cpu"]
    assert tcli(args + ["--max_epochs", "1"]) == 0
    out = capsys.readouterr().out
    assert "best accuracy: -inf" in out and "no eval ran" in out
    # the backbone load resets seen: one epoch of 6 samples
    assert Checkpointer(ckpt).latest_step() == 3
    _, st = TW.load_weights(TSpec.from_cfg(cfgfile),
                            os.path.join(backup, "model.weights"))
    assert all(torch.isfinite(v).all() for v in st.values())

    assert tcli(args + ["--max_epochs", "2", "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed from" in out and "seen=6" in out
    assert "epoch 0," not in out and "epoch 1," in out
    assert Checkpointer(ckpt).latest_step() == 6


def test_cli_train_refuses_missing_cuda(synth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    datacfg, cfgfile, _, _ = synth
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli(["train", "--datacfg", datacfg, "--modelcfg", cfgfile,
              "--initweightfile", ""])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TDr.run_training(datacfg, cfgfile, None, 15,
                         TDr.TrainRunConfig(device="cuda"))
