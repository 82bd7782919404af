"""The port's eval bank (``data/eval_bank.py``), ``run_validation(
transfer=)``, ``run_validation_multi(transfer=)``, the trainers'
``eval_transfer="auto"`` preflight and the CLI's ``--transfer``, against the
rgb path and the JAX package.

Tolerances: the bank's pixels and labels equal the rgb Loader's batches bit
for bit (zero rows pad the last batch); metrics through the bank equal the
rgb path's to rtol 1e-6 / atol 1e-5, as the JAX package's own test holds
them (only the padded last batch runs at another batch size), a second bank
pass equals the first exactly, and the accuracies equal JAX's bank run.
"""

import os

import numpy as np
import pytest
import torch

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.zoo import occlusion_datacfg

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.data import eval_bank as EB
from singleshotpose_tpu_torch.data.pipeline import Loader, PoseDataset

from linemod_fixture import make_linemod_fixture, write_random_weights
from test_torch_serving import linemod  # noqa: F401  (fixture)
from torch_port_helpers import TINY_MULTI_BLOCKS, TINY_MULTI_CFG
from test_drivers import TINY_CFG, _make_synthetic_linemod

CPU = torch.device("cpu")
KW = dict(batch_size=3, num_workers=0, compute_dtype=None, verbose=False)


@pytest.fixture(autouse=True)
def _empty_cache():
    EB.clear_cache()
    yield
    EB.clear_cache()


def _assert_same_summary(got, want, exact=False):
    assert got["n_samples"] == want["n_samples"]
    for k in want:
        tol = dict(rtol=0, atol=0) if exact else dict(rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_run_validation_bank_matches_rgb_and_jax(linemod, monkeypatch):  # noqa: F811
    datacfg, cfg, wfile = linemod
    builds = []
    real = EB.build_eval_bank
    monkeypatch.setattr(EB, "build_eval_bank",
                        lambda *a, **k: builds.append(1) or real(*a, **k))
    rgb = TDr.run_validation(datacfg, cfg, wfile, device="cpu", **KW)
    bank = TDr.run_validation(datacfg, cfg, wfile, device="cpu",
                              transfer="bank", **KW)
    again = TDr.run_validation(datacfg, cfg, wfile, device="cpu",
                               transfer="bank", **KW)
    assert len(builds) == 1              # LRU hit: the split decoded once
    assert rgb["n_samples"] == 4
    _assert_same_summary(bank, rgb)
    _assert_same_summary(again, bank, exact=True)
    (key,) = EB._CACHE
    assert key[0] == "single" and key[-1] == "cpu"
    want = JDr.run_validation(datacfg, cfg, wfile, transfer="bank", **KW)
    for k in bank:
        if k.startswith("acc_"):
            assert bank[k] == want[k], (k, bank[k], want[k])


def test_eval_bank_holds_the_rgb_batches(linemod):  # noqa: F811
    datacfg, _, _ = linemod
    from singleshotpose_tpu_torch.config import (data_config_from_options,
                                                 read_data_cfg)
    valid = data_config_from_options(read_data_cfg(datacfg)).valid
    ds = PoseDataset(valid, train=False)
    batches = list(Loader(ds, 3, shuffle=False, schedule=None,
                          fixed_shape=(64, 48), num_workers=0,
                          drop_last=False, out_uint8=True))
    bank = EB.build_eval_bank(ds, (64, 48), 3, num_workers=0, device=CPU)
    assert bank.n == 4 and tuple(bank.images.shape) == (2, 3, 48, 64, 3)
    assert bank.images.dtype == torch.uint8 and bank.nbytes() == 6 * 48 * 64 * 3
    got = list(bank)
    np.testing.assert_array_equal(got[0][0].numpy(), batches[0][0])
    np.testing.assert_array_equal(got[0][1], batches[0][1])
    np.testing.assert_array_equal(got[1][0][:1].numpy(), batches[1][0])
    np.testing.assert_array_equal(got[1][1][:1], batches[1][1])
    assert not got[1][0][1:].any() and not got[1][1][1:].any()
    with pytest.raises(ValueError, match="test-mode"):
        EB.build_eval_bank(PoseDataset(valid, train=True), (64, 48), 3,
                           device=CPU)


def test_eval_bank_lru_keeps_eight(monkeypatch):
    monkeypatch.setattr(EB, "build_eval_bank",
                        lambda ds, shape, b, **kw: EB.EvalBank(
                            torch.zeros((1, b, 2, 2, 3), dtype=torch.uint8),
                            np.zeros((1, b, 1050), np.float32), b))
    banks = [EB.get_eval_bank(None, (2, 2), 1, cache_key=k) for k in range(9)]
    assert list(EB._CACHE) == list(range(1, 9))
    assert EB.get_eval_bank(None, (2, 2), 1, cache_key=5) is banks[5]
    assert list(EB._CACHE)[-1] == 5


_GIB = 1 << 30


@pytest.mark.parametrize("mode,free,cached,want,kept", [
    ("rgb", None, 0, "rgb", True),            # explicit: as given
    ("bank", 0, 0, "bank", True),
    ("auto", None, 0, "bank", True),          # off CUDA: no budget
    ("auto", 8 * _GIB, 1 << 20, "bank", True),          # fits
    ("auto", _GIB + (1 << 20), 512 << 20, "bank", False),   # fits once evicted
    ("auto", _GIB, 1 << 20, "rgb", True),     # does not fit: stream this pass
])
def test_eval_transfer_auto_preflight(monkeypatch, mode, free, cached, want,
                                      kept):
    monkeypatch.setattr(TDr, "hbm_free_bytes", lambda device=None: free)
    if cached:
        EB._CACHE["stale"] = EB.EvalBank(
            torch.zeros(cached, dtype=torch.uint8), np.zeros(0), 0)
    rc = TDr.TrainRunConfig(eval_transfer=mode, device="cpu")
    need = TDr._bank_bytes(100, (416, 416), 16)
    assert need == 112 * 416 * 416 * 3
    assert TDr._resolve_eval_transfer(rc, need, CPU) == want
    assert ("stale" in EB._CACHE) == (kept and bool(cached))


@pytest.mark.parametrize("transfer,match", [("jpeg", "unknown transfer")])
def test_unported_transfers_raise(linemod, transfer, match):  # noqa: F811
    datacfg, cfg, wfile = linemod
    with pytest.raises(ValueError, match=match):
        TDr.run_validation(datacfg, cfg, wfile, device="cpu",
                           transfer=transfer, **KW)


@pytest.fixture(scope="module")
def occlusion(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("occ_bank"))
    objs = ("ape", "duck")
    lm = make_linemod_fixture(root, ("benchvise",) + objs, n_frames=3,
                              occlusion_objects=objs, seed=42)
    datacfgs = []
    for obj in objs:
        path = os.path.join(root, f"{obj}_occlusion.data")
        with open(path, "w") as f:
            f.write(occlusion_datacfg(obj, linemod_root=lm,
                                      backup_root=os.path.join(root, "bk")))
        datacfgs.append(path)
    cfg = os.path.join(root, "tiny_multi.cfg")
    with open(cfg, "w") as f:
        f.write(TINY_MULTI_CFG)
    wfile = os.path.join(root, "w", "tiny_multi.weights")
    write_random_weights(JSpec(TINY_MULTI_BLOCKS), wfile, seed=43)
    return datacfgs, cfg, wfile


def test_run_validation_multi_bank_matches_rgb(occlusion):
    """One bank per object (the sweep reads the same frames under each
    object's labels), each pass equal to the rgb one."""
    datacfgs, cfg, wfile = occlusion
    kw = dict(KW, batch_size=2)
    for dc in datacfgs:
        rgb = TDr.run_validation_multi(dc, cfg, wfile, device="cpu", **kw)
        bank = TDr.run_validation_multi(dc, cfg, wfile, device="cpu",
                                        transfer="bank", **kw)
        assert bank["name"] == rgb["name"] and bank["n_samples"] == 3
        assert bank["acc_table"] == rgb["acc_table"]
        np.testing.assert_allclose(bank["mean_err_2d"], rgb["mean_err_2d"],
                                   rtol=1e-6)
    assert sorted(k[2] for k in EB._CACHE) == ["ape", "duck"]


def test_cli_transfer_bank(linemod, occlusion, capsys):  # noqa: F811
    datacfg, cfg, wfile = linemod
    assert tcli(["valid", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--weightfile", wfile, "--batch_size", "2",
                 "--transfer", "bank", "--device", "cpu"]) == 0
    datacfgs, mcfg, mwfile = occlusion
    assert tcli(["valid-multi", "--modelcfg", mcfg, "--weightfile", mwfile,
                 "--datacfgs", *datacfgs, "--batch_size", "2",
                 "--transfer", "bank", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Acc using 5 px 2D Projection" in out
    assert "Acc using 50 px 2D Projection" in out
    assert {k[0] for k in EB._CACHE} == {"single", "multi"}


def test_trainer_eval_takes_the_bank_under_auto(tmp_path):
    """The in-training eval resolves "auto" to the bank off CUDA and
    builds it once for two eval epochs."""
    datacfg, _ = _make_synthetic_linemod(tmp_path)
    cfgfile = tmp_path / "tiny.cfg"
    cfgfile.write_text(TINY_CFG)
    rc = TDr.TrainRunConfig(eval_every=1, eval_after=-1, num_workers=0,
                            eval_batch_size=4, bg_dir="/nonexistent",
                            max_epochs_override=2, compute_dtype=None,
                            device="cpu")
    result = TDr.run_training(datacfg, str(cfgfile), None, 100, rc)
    assert len(result["history"]["testing_accuracies"]) == 2
    (key,) = EB._CACHE
    assert key[0] == "single" and key[3] == 4
