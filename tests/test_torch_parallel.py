"""PyTorch port: data parallelism on ``torch.distributed``
(singleshotpose_tpu_torch/parallel/, the sync-BN of ``models/layers.py``
and ``models/darknet.py``, the fused stem's group in ``ops/stem.py``, the
train step's gradient all-reduce in ``training.py``, the drivers and
``cli --dp``), on gloo ranks on the CPU, against the JAX package on a
``make_mesh(dp=2, mp=1)`` mesh of its virtual CPU devices (its Pallas stem
in interpret mode) and against the port in one process.

The ranks run in ``tests/torch_parallel_worker.py``, a jax-free worker
(``jax`` and ``singleshotpose_tpu`` blocked there and in every rank it
spawns).  One spawn of 2 ranks covers the step-level checks; the CLI's
``--dp 2`` starts its own ranks.  The tolerances are JAX's own for its
sharded paths (``tests/test_stem.py:171-262``,
``tests/test_training.py:146-175``):

- the stem alone (B=8 → 2×4, 32×64): mean and var atol 1e-5, pooled (bf16)
  within 1 % of its max, dw/dscale/dbias relative error < 2e-3;
- sync-BN ``batch_norm_train`` against the global batch: forward and
  gradients to 1e-5 of each tensor's max (f32 sums in another order);
- the f32 step (tiny cfg, B=8 → 2×4, lr 0.00025, epoch 100): loss rtol
  1e-4, every tensor of the state after one step rtol 1e-4, atol 1e-6;
- the bf16 step through the fused stem: loss rtol 1e-3, conv_1's and
  conv_2's weights atol 6e-4 (JAX's measured bf16 noise floor between its
  sharded and single-device steps), conv_1's running mean atol 1e-5;
- the ranks bit for bit equal after the steps; K2 per rank bit for bit the
  global call's rows; a group of one bit for bit the step with no group;
- ``cli valid --dp 2`` against one process: mean errors to rel 1e-3 (as
  ``tests/test_multihost.py`` holds JAX's multi-host eval; the ranks' convs
  run at half the batch), accuracies within one frame.
"""

import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu.config import parse_cfg as jparse_cfg
from singleshotpose_tpu.data import device_synth as JDS
from singleshotpose_tpu.data.synth_multi import SynthConfig as JSynthConfig
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.ops import stem as jstem
from singleshotpose_tpu.ops.losses import RegionLossConfig as JLossConfig
from singleshotpose_tpu.parallel import multihost as JMH
from singleshotpose_tpu.parallel.sharding import (batch_stats_shardings,
                                                  make_mesh, param_shardings,
                                                  shard_host_batch)
from singleshotpose_tpu.training import TrainState
from singleshotpose_tpu.training import make_train_step as jmake_train_step
from singleshotpose_tpu.zoo import yolo_pose_single as jyolo_single

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.data import device_synth as TDS
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.models import darknet as TD
from singleshotpose_tpu_torch.models import layers as TL
from singleshotpose_tpu_torch.ops import stem as tstem
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.ops.max_corner_confidence import (
    max_corner_confidence)
from singleshotpose_tpu_torch.parallel import multihost as TMH
from singleshotpose_tpu_torch.parallel import sharding as TS
from singleshotpose_tpu_torch.training import (init_train_state,
                                               make_train_step)
from singleshotpose_tpu_torch.utils import memory as TM
from singleshotpose_tpu_torch.zoo import occlusion_datacfg
from singleshotpose_tpu_torch.zoo import yolo_pose_single as tyolo_single

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from test_drivers import TINY_CFG as DRIVER_CFG, _make_synthetic_linemod
from test_stem import _inputs as stem_inputs, _tiny_spec as stem_spec
from test_torch_device_synth import _jax_draws
from test_training import TINY_CFG as STEP_CFG, _tiny_target
from torch_bank_helpers import (bank_references, check_bank_rows,
                                check_synth_rows, synth_reference,
                                write_backgrounds, write_occlusion_tree)
from torch_port_helpers import TINY_MULTI_CFG, rel_err
from linemod_fixture import make_linemod_fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_parallel_worker.py")
WORLD = 2
LR, EPOCH, DECAY, MOMENTUM = 0.00025, 100, 0.002, 0.9
STEPS = 3


def _start(*args):
    """The worker on ``args``, started (one rank's thread each, as the test
    run's workers share the cores)."""
    return subprocess.Popen([sys.executable, WORKER, *args], cwd=REPO,
                            env=dict(os.environ, OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc, timeout=600) -> str:
    try:
        out, _ = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, out[-8000:]
    return out


def _worker(*args) -> str:
    return _finish(_start(*args))


def _blocks(cfg_text, path):
    path.write_text(cfg_text)
    return jparse_cfg(str(path))


def _k2_inputs(rng, B=8, G=50, S=169):
    gt = rng.uniform(0, 1, (B, G, 18)).astype(np.float32)
    valid = np.zeros((B, G), bool)
    valid[:, :3] = True
    valid[1, :] = False
    pred = (gt[:, :1] + rng.normal(0, 0.05, (B, S, 18))).astype(np.float32)
    return gt, valid, pred


def _jax_state(jspec, mesh=None):
    params, stats = jspec.init_params(jax.random.PRNGKey(0))
    mom = jax.tree.map(jnp.zeros_like, params)
    if mesh is not None:
        ps = param_shardings(jspec, mesh)
        params = jax.tree.map(jax.device_put, params, ps)
        stats = jax.tree.map(jax.device_put, stats,
                             batch_stats_shardings(jspec, mesh))
        mom = jax.tree.map(jax.device_put, mom, ps)
    return TrainState(params, stats, mom, jnp.asarray(0, jnp.int32))


def _bf16_target(B=8, K=9):
    tgt = np.zeros((B, 50 * (2 * K + 3)), np.float32)
    rng = np.random.RandomState(0)
    for b in range(B):
        tgt[b, 1:2 * K + 1] = rng.uniform(0.2, 0.8, 2 * K)
        tgt[b, 2 * K + 1:2 * K + 3] = [0.3, 0.4]
    return tgt


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The inputs, the two nets' specs and initial states (JAX's
    ``init_params(PRNGKey(0))``, carried into the port), written for the
    worker."""
    wd = tmp_path_factory.mktemp("dp_steps")
    inp = {}
    img, w, scale, bias = stem_inputs(B=8, H=32, W=64, seed=8)
    inp.update(stem_img=np.asarray(img), stem_w_hwio=np.asarray(w),
               stem_w=np.asarray(w).transpose(3, 2, 0, 1).copy(),
               stem_scale=np.asarray(scale), stem_bias=np.asarray(bias),
               stem_cot=np.random.RandomState(9).randn(8, 16, 32, 32)
               .astype(np.float32))
    rng = np.random.RandomState(11)
    inp.update(bn_x=rng.randn(8, 16, 6, 5).astype(np.float32) * 2 + 0.5,
               bn_scale=rng.uniform(0.5, 1.5, 16).astype(np.float32),
               bn_bias=(rng.randn(16) * 0.1).astype(np.float32),
               bn_cot=rng.randn(8, 16, 6, 5).astype(np.float32))
    inp.update(zip(("k2_gt", "k2_valid", "k2_pred"),
                   _k2_inputs(np.random.RandomState(12))))
    nets = {"f32": JSpec(_blocks(STEP_CFG, wd / "f32.cfg")),
            "bf16": stem_spec()}
    inp.update(f32_images=np.random.RandomState(3).rand(8, 64, 64, 3)
               .astype(np.float32), f32_target=_tiny_target(8),
               bf16_images=np.random.RandomState(3).rand(8, 32, 32, 3)
               .astype(np.float32), bf16_target=_bf16_target())
    for tag, jspec in nets.items():
        (wd / f"{tag}_blocks.json").write_text(json.dumps(jspec.blocks))
        st = _jax_state(jspec)
        torch.save(TW.params_from_jax(
            TD.DarknetSpec(jspec.blocks),
            jax.tree.map(np.asarray, st.params),
            jax.tree.map(np.asarray, st.batch_stats)), wd / f"{tag}.pt")
    np.savez(wd / "inputs.npz", **inp)
    corpus = wd / "corpus"
    corpus.mkdir()
    _make_synthetic_linemod(corpus, n=8)
    (corpus / "tiny.cfg").write_text(DRIVER_CFG.replace("batch=2", "batch=4"))
    write_backgrounds(corpus)
    write_occlusion_tree(wd)
    return wd, inp, nets


@pytest.fixture(scope="module")
def ranks(setup):
    """One spawn of 2 gloo ranks: each rank's npz."""
    wd, _, _ = setup
    assert "WORKER_OK" in _worker("steps", str(wd))
    return [dict(np.load(wd / f"rank{r}.npz")) for r in range(WORLD)]


@pytest.fixture(scope="module")
def bank_refs(setup):
    """The bank backends' one-process batches (``torch_bank_helpers``)."""
    wd = setup[0]
    return bank_references(wd), synth_reference(wd)


@pytest.fixture
def _interpret():
    jstem.FORCE_INTERPRET = True
    yield
    jstem.FORCE_INTERPRET = False


def _mesh():
    return make_mesh(jax.devices()[:WORLD], dp=WORLD, mp=1)


def _gathered(ranks, key):
    return np.concatenate([r[key] for r in ranks])


# ---------------------------------------------------------------------------
# the stem and sync-BN
# ---------------------------------------------------------------------------


def _port_stem(inp):
    w, scale, bias = (torch.tensor(inp[k], requires_grad=True)
                      for k in ("stem_w", "stem_scale", "stem_bias"))
    pooled, mean, var = tstem.stem_conv_bn_pool_train(
        torch.from_numpy(inp["stem_img"]), w, scale, bias)
    (pooled.float() * torch.from_numpy(inp["stem_cot"])).sum().backward()
    return {"pooled": pooled.detach().float().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "dw": w.grad.numpy(),
            "dscale": scale.grad.numpy(), "dbias": bias.grad.numpy()}


def _jax_stem(inp):
    """JAX's sharded stem and the gradient of Σ pooled·cot, forward and
    backward in one jitted program (its interpreted kernels run ~8x faster
    compiled than op by op, with the same results)."""
    mesh = _mesh()
    img, *params = [jnp.asarray(inp[k]) for k in
                    ("stem_img", "stem_w_hwio", "stem_scale", "stem_bias")]
    cot = jnp.asarray(inp["stem_cot"]).astype(jnp.bfloat16)

    def fwd_bwd(w, scale, bias):
        out, vjp = jax.vjp(lambda *p: jstem.stem_conv_bn_pool_train_sharded(
            img, *p, mesh), w, scale, bias)
        return out, vjp((cot, jnp.zeros(32), jnp.zeros(32)))

    (pooled, mean, var), (dw, dscale, dbias) = jax.jit(fwd_bwd)(*params)
    return {"pooled": np.asarray(pooled, np.float32),
            "mean": np.asarray(mean), "var": np.asarray(var),
            "dw": np.asarray(dw).transpose(3, 2, 0, 1),
            "dscale": np.asarray(dscale), "dbias": np.asarray(dbias)}


@pytest.mark.parametrize("ref", ["jax_mesh", "port_one_process"])
def test_stem_on_two_ranks(setup, ranks, _interpret, ref):
    """The fused train stem on 2 gloo ranks (4 rows each, the statistics
    and c1/c2 all-reduced) against JAX's ``stem_conv_bn_pool_train_sharded``
    on a dp=2 mesh and against the port's stem on the whole batch."""
    _, inp, _ = setup
    want = _jax_stem(inp) if ref == "jax_mesh" else _port_stem(inp)
    for r in ranks:
        np.testing.assert_allclose(r["stem_mean"], want["mean"], atol=1e-5)
        np.testing.assert_allclose(r["stem_var"], want["var"], atol=1e-5)
    d = np.abs(_gathered(ranks, "stem_pooled") - want["pooled"]).max()
    assert d <= 0.01 * np.abs(want["pooled"]).max(), d
    for name in ("dw", "dscale", "dbias"):
        for r in ranks:
            assert rel_err(r[f"stem_{name}"], want[name]) < 2e-3, \
                (name, rel_err(r[f"stem_{name}"], want[name]))


def test_sync_batch_norm_on_two_ranks(setup, ranks):
    """``batch_norm_train(group=)`` on 2 ranks = the global batch's: the
    output, the statistics, the input's gradient and the summed scale and
    bias gradients."""
    _, inp, _ = setup
    x = torch.tensor(inp["bn_x"], requires_grad=True)
    scale, bias = (torch.tensor(inp[k], requires_grad=True)
                   for k in ("bn_scale", "bn_bias"))
    y, mean, var = TL.batch_norm_train(x, scale, bias)
    (y * torch.from_numpy(inp["bn_cot"])).sum().backward()
    for key, got, want in (("y", _gathered(ranks, "bn_y"), y),
                           ("dx", _gathered(ranks, "bn_dx"), x.grad)):
        assert rel_err(got, want.detach()) <= 1e-5, (key, rel_err(got, want))
    for r in ranks:
        for key, want in (("mean", mean), ("var", var),
                          ("dscale", scale.grad), ("dbias", bias.grad)):
            got = r[f"bn_{key}"]
            assert rel_err(got, want.detach()) <= 1e-5, \
                (key, rel_err(got, want.detach()))


# ---------------------------------------------------------------------------
# the train steps
# ---------------------------------------------------------------------------


def _jax_step_on_mesh(tag, nets, inp):
    jspec = nets[tag]
    mesh = _mesh()
    bf16 = tag == "bf16"
    step = jmake_train_step(
        jspec, JLossConfig.single(), weight_decay=DECAY, momentum=MOMENTUM,
        compute_dtype=jnp.bfloat16 if bf16 else None, donate=False,
        fused_stem=bf16, stem_mesh=mesh if bf16 else None)
    imgs, tgt = shard_host_batch(mesh, inp[f"{tag}_images"],
                                 inp[f"{tag}_target"])
    state, stats = step(_jax_state(jspec, mesh), imgs, tgt, LR, EPOCH)
    return (float(stats["loss"]),
            TW.params_from_jax(TD.DarknetSpec(jspec.blocks),
                               jax.tree.map(np.asarray, state.params),
                               jax.tree.map(np.asarray, state.batch_stats)))


def _port_step_one_process(tag, setup):
    wd, inp, _ = setup
    model = TD.Darknet(TD.DarknetSpec(json.loads(
        (wd / f"{tag}_blocks.json").read_text())))
    model.load_state_dict(torch.load(wd / f"{tag}.pt", weights_only=True))
    state = init_train_state(model, weight_decay=DECAY, momentum=MOMENTUM)
    bf16 = tag == "bf16"
    step = make_train_step(RegionLossConfig(),
                           compute_dtype=torch.bfloat16 if bf16 else None,
                           fused_stem=bf16)
    stats = step(state, torch.from_numpy(inp[f"{tag}_images"]),
                 torch.from_numpy(inp[f"{tag}_target"]), LR, EPOCH)
    return float(stats["loss"]), model.state_dict()


@pytest.mark.parametrize("ref", ["jax_mesh", "port_one_process"])
@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_train_step_on_two_ranks(setup, ranks, _interpret, tag, ref):
    """One data-parallel step (4 rows a rank) against JAX's step on a dp=2
    mesh (bf16: its fused stem under ``stem_mesh``) and against the port's
    step on the whole batch in one process."""
    _, inp, nets = setup
    loss, want = _jax_step_on_mesh(tag, nets, inp) if ref == "jax_mesh" \
        else _port_step_one_process(tag, setup)
    r = ranks[0]
    if tag == "f32":
        np.testing.assert_allclose(r["f32/losses"][0], loss, rtol=1e-4)
        for k, v in want.items():
            np.testing.assert_allclose(r[f"f32/step1/{k}"], v.numpy(),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
        return
    assert r["bf16/stem_calls"] == STEPS          # the fused stem ran
    np.testing.assert_allclose(r["bf16/losses"][0], loss, rtol=1e-3)
    for k in ("conv_1.weight", "conv_2.weight"):
        np.testing.assert_allclose(r[f"bf16/step1/{k}"], want[k].numpy(),
                                   rtol=0, atol=6e-4, err_msg=k)
    np.testing.assert_allclose(r["bf16/step1/conv_1.running_mean"],
                               want["conv_1.running_mean"].numpy(), atol=1e-5)


@pytest.mark.parametrize("tag", ["f32", "bf16", "train"])
def test_ranks_hold_the_same_bytes(ranks, tag):
    """After the steps (and after ``run_training``'s epoch with its eval)
    every parameter, BN statistic, momentum buffer and ``seen`` is the same
    on both ranks, bit for bit, and so are the losses."""
    keys = [k for k in ranks[0] if k.startswith(f"{tag}/")]
    assert keys
    for k in keys:
        np.testing.assert_array_equal(np.atleast_1d(ranks[0][k]).view(np.uint8),
                                      np.atleast_1d(ranks[1][k]).view(np.uint8),
                                      k)
    if tag != "train":
        assert int(ranks[0][f"{tag}/last/seen"]) == STEPS * 8


def test_run_training_on_two_ranks(ranks):
    """``run_training`` over 2 ranks: 8 frames at a global batch of 4 is 2
    steps, ``seen`` global, and the in-training eval (batches of 3, padded
    to a multiple of 2 and split) gave finite metrics."""
    r = ranks[0]
    assert len(r["train/training_losses"]) == 2
    assert np.isfinite(r["train/training_losses"]).all()
    assert int(r["train/state/seen"]) == 8
    assert len(r["train/testing_errors_pixel"]) == 1
    assert np.isfinite(r["train/testing_errors_pixel"]).all()


def test_ragged_eval_batch_on_two_ranks(ranks):
    """``_eval_pass`` over 2 ranks on 7 frames in batches of 4 (the second
    3 rows, padded to 4 and split 2 + 2, the pad row trimmed after the
    all-gather) = one process serving the same padded rows a rank's share
    at a time: the GT and predicted corners, the frames' order and every
    metric, bit for bit, on both ranks."""
    keys = [k for k in ranks[0] if k.startswith("ragged/alone/")]
    assert len(ranks[0]["ragged/alone/image_idx"]) == 7
    assert np.array_equal(ranks[0]["ragged/alone/image_idx"], np.arange(7))
    # each frame has its own box, so a row out of place would show
    pr = ranks[0]["ragged/alone/corners_pr"]
    assert len(np.unique(pr.reshape(7, -1), axis=0)) == 7
    for r in ranks:
        for k in keys:
            got, want = r[k.replace("/alone/", "/ranks/")], r[k]
            assert got.dtype == want.dtype and got.shape == want.shape, k
            assert got.tobytes() == want.tobytes(), k


def test_k2_rows_per_rank(setup, ranks):
    """Each rank's ``max_corner_confidence`` on its rows = those rows of the
    call on the global batch, bit for bit (no collective)."""
    _, inp, _ = setup
    want = max_corner_confidence(*(torch.from_numpy(inp[k]) for k in
                                   ("k2_gt", "k2_valid", "k2_pred"))).numpy()
    np.testing.assert_array_equal(_gathered(ranks, "k2").view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("rank", range(WORLD))
def test_bank_rows_on_two_ranks(ranks, bank_refs, rank):
    """Each rank's ``Loader(group=, backend="device_bank")`` rows over 2
    ranks against JAX's ``Loader(mesh=make_mesh(dp=2))`` rows and the
    one-process port batch's (``torch_bank_helpers.check_bank_rows``)."""
    check_bank_rows(ranks[rank], bank_refs[0], rank, 2)


@pytest.mark.parametrize("rank", range(WORLD))
def test_synth_rows_on_two_ranks(ranks, bank_refs, rank):
    """Each rank's ``Loader(group=, backend="device_synth")`` rows over 2
    ranks are those rows of the one-process port batch, bit for bit."""
    check_synth_rows(ranks[rank], bank_refs[1], rank, 2)


@pytest.mark.parametrize("rank", range(WORLD))
@pytest.mark.parametrize("backend", ["bank", "synth"])
def test_loader_builds_its_bank_when_made_on_two_ranks(ranks, backend,
                                                       rank):
    """Under a group a bank loader's constructor builds the bank and runs
    its preflight, a collective over the group, once, on the main thread,
    not on the prefetch thread at the first batch."""
    assert ranks[rank][f"built_at_init/rows/{backend}"].tolist() == [1, 1]


@pytest.mark.parametrize("case,want", [
    ("one_card", r"a bank on 2 ranks sharing card needs 200 MB device "
                 r"memory plus 2048 MB activation headroom, but only 1686 MB"),
    ("own_cards", r"^$")])
def test_bank_preflight_counts_both_ranks_on_a_card(ranks, case, want):
    """Two ranks on one card whose free memory holds one and a half banks
    with their headroom: both raise (each alone would pass); on cards of
    their own both pass."""
    for r in ranks:
        assert re.search(want, str(r[f"preflight/{case}"])), \
            str(r[f"preflight/{case}"])


@pytest.fixture(scope="module")
def scene_banks(setup):
    """Both packages' scene banks of the OCCLUSION tree (equal arrays)."""
    occ = setup[0] / "occ"
    lines = (occ / "train_occlusion.txt").read_text().split()
    jbank = JDS.build_scene_bank(
        JSynthConfig(linemod_root=str(occ / "LINEMOD")), lines,
        [str(occ / "VOC" / "JPEGImages" / "bg0.jpg")])
    return jbank, TDS.DeviceSceneBank(*(torch.from_numpy(np.array(a))
                                        for a in jbank))


@pytest.mark.parametrize("rank", range(WORLD))
def test_synth_row_slice_matches_jax(scene_banks, rank):
    """``synthesize_batch(..., rows=)`` on a rank's slice of JAX's draws
    (``_jax_draws``: JAX's own integers from its key) is those rows of
    JAX's ``synthesize_batch`` of the whole batch, bit for bit, images and
    labels, on the tree's binary masks."""
    jbank, tbank = scene_banks
    assert TDS.binary_masks(tbank)
    idx = np.array([0, 1, 2, 3, 1, 0, 3, 2], np.int32)
    kw = dict(jitter=0.1, shift=10, attempts=4, propose_scale=4)
    jst, tst = JDS.DeviceSynthStatic(**kw), TDS.DeviceSynthStatic(**kw)
    key = jax.random.PRNGKey(21)
    ji, jl = JDS.synthesize_batch(jbank, idx, key, out_w=64, out_h=64,
                                  st=jst)
    rows = slice(4 * rank, 4 * rank + 4)
    ti, tl = TDS.synthesize_batch(tbank, idx, _jax_draws(jbank, idx, key,
                                                         jst),
                                  out_w=64, out_h=64, st=tst, binary=True,
                                  rows=rows)
    assert ti.shape[0] == 4
    assert ti.numpy().tobytes() == np.asarray(ji)[rows].tobytes()
    assert tl.numpy().tobytes() == np.asarray(jl)[rows].tobytes()


@pytest.mark.parametrize("entries,fails", [
    ([("a", 3000), ("a", 2000)], [("a", 2, 2000)]),     # two ranks, one card
    ([("a", 3000), ("b", 2500)], []),                    # a card each
    ([("a", 1000), (None, None)], [("a", 1, 1000)]),     # one rank too big
    ([(None, None), (None, None)], [])])                 # the CPU: no budget
def test_shared_budget_charges_every_rank_on_a_card(entries, fails):
    """Each card is charged ``ranks · (bank + headroom)`` against the least
    free memory its ranks read (a bank of 1000 and a headroom of 200
    here)."""
    assert TM.shared_budget_failures(entries, 1000, 200) == fails


def test_group_splits_only_the_bank_backends(setup):
    """``Loader(group=)`` refuses a host backend: under data parallelism it
    reads its rank's shard of the dataset instead."""
    wd = setup[0]
    ds = TP.PoseDataset(str(wd / "corpus" / "train.txt"), train=True)
    with pytest.raises(ValueError, match="group= splits the bank backends"):
        TP.Loader(ds, 4, backend="python", group=object())


@pytest.mark.parametrize("tag", ["f32", "bf16"])
def test_group_of_one_is_the_ungrouped_step(ranks, tag):
    """A step with a group of one rank (``--dp 1``'s) = the step with no
    group, bit for bit: the state and the loss."""
    for r in ranks:
        assert bool(r[f"{tag}/group_of_one_equal"])


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,nproc", [(100, 4), (103, 4), (16, 2), (7, 3)])
def test_process_local_indices_match_jax(n, nproc):
    for pid in range(nproc):
        np.testing.assert_array_equal(
            TMH.process_local_indices(n, process_id=pid,
                                      num_processes=nproc),
            JMH.process_local_indices(n, process_id=pid,
                                      num_processes=nproc))


def test_initialize_distributed_is_a_noop_at_world_one(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    TMH.initialize_distributed()
    TMH.initialize_distributed(world_size=1)
    assert not torch.distributed.is_initialized()


# tests/test_stem.py:265-275's cases and more: (global B, data shards)
@pytest.mark.parametrize("B,shards", [(128, 4), (128, 1), (6, 4), (2, 4),
                                      (8, 2), (126, 2), (64, 1), (3, 3)])
def test_stem_gate_judges_the_per_rank_batch(_interpret, B, shards):
    shape = (B, 416, 416, 3)
    want = jstem.stem_supported(jyolo_single(), jnp.bfloat16, shape,
                                data_shards=shards)
    assert TD.stem_supported(tyolo_single(), torch.bfloat16, shape,
                             data_shards=shards) == want
    assert want == (B % shards == 0 and 0 < B // shards < 64)


def test_grid_must_cover_the_process_group(monkeypatch):
    """``make_dp_group(dp, mp)`` takes exactly the process group's ranks:
    with nothing initialised only dp = mp = 1 (a group of one made here),
    and over a group of one any other dp·mp raises with the sizes."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="dp=1, mp=2: torch.distributed "
                       "is not initialised"):
        TS.make_dp_group(1, mp=2, device="cpu")
    group = TS.make_dp_group(1, mp=1, device="cpu")
    try:
        assert (group.world, group.mp, group.model_pg) == (1, 1, None)
        for dp, mp in ((1, 2), (2, 1), (2, 2)):
            with pytest.raises(ValueError, match=f"dp={dp} × mp={mp} = "
                               f"{dp * mp} but the process group has 1 "
                               "ranks"):
                TS.make_dp_group(dp, mp=mp, device="cpu")
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture
def group_of_one():
    """A gloo group of this process alone (``--dp 1``'s), torn down after."""
    group = TS.make_dp_group(1, device="cpu")
    yield group
    torch.distributed.destroy_process_group()


def test_captured_steps_refuse_a_group(group_of_one, tmp_path):
    """No fallback: a data-parallel step over gloo (whose collectives run
    on the host) is never captured — not by ``capture_train_step`` nor by
    ``run_training(precompile_buckets=True)`` (which refuses before it would
    reach the CPU's eager no-op)."""
    from singleshotpose_tpu_torch.training import capture_train_step
    step = make_train_step(RegionLossConfig(), group=group_of_one)
    spec = TD.DarknetSpec(json.loads(json.dumps(stem_spec().blocks)))
    state = init_train_state(TD.Darknet(spec), weight_decay=0.0,
                             momentum=0.9)
    with pytest.raises(ValueError, match="data-parallel"):
        capture_train_step(step, state, [32], 2, 1050)
    rc = TDr.TrainRunConfig(group=group_of_one, precompile_buckets=True,
                            device="cpu")
    with pytest.raises(ValueError, match="precompile_buckets"):
        TDr.run_training(str(tmp_path / "none.data"), spec, None, 0, rc)


def test_dp_on_cards_that_are_not_there(tmp_path, monkeypatch):
    """``--dp 2 --device cuda`` raises without CUDA, and with fewer cards
    than ranks; ``--dp`` takes ``cuda`` or ``cpu`` only."""
    data = tmp_path / "x.data"
    data.write_text("")
    argv = ["train", "--datacfg", str(data), "--initweightfile", "",
            "--dp", "2"]
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA is not available"):
            tcli(argv + ["--device", "cuda"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="needs 2 cards; 1 visible"):
        tcli(argv + ["--device", "cuda"])
    with pytest.raises(SystemExit, match="--device cuda or cpu"):
        tcli(argv + ["--device", "cuda:1"])
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(SystemExit, match="WORLD_SIZE=4"):
        tcli(argv + ["--device", "cpu"])


# ---------------------------------------------------------------------------
# the CLI on 2 ranks
# ---------------------------------------------------------------------------


_LOSS_LINE = re.compile(r"\[rank (\d)/2\] (epoch \d+ iter \d+: loss .*)$")


def _per_rank(out: str, pattern=_LOSS_LINE):
    lines = {0: [], 1: []}
    for line in out.splitlines():
        m = pattern.search(line)
        if m:
            lines[int(m.group(1))].append(m.group(2))
    return lines


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """``cli train --dp 2`` (2 epochs with checkpoints, then a resume to 3),
    ``cli train-multi --dp 2`` (1 epoch with its epoch-0 eval) and ``cli
    valid --dp 2`` on the final weights, all ``--device cpu``, each starting
    its own 2 ranks."""
    tmp = tmp_path_factory.mktemp("dp_cli")
    datacfg, backup = _make_synthetic_linemod(tmp, n=16)
    cfg = tmp / "tiny.cfg"
    cfg.write_text(DRIVER_CFG.replace("batch=2", "batch=8"))
    ckpt = str(tmp / "ckpt")
    train = ["train", "--datacfg", datacfg, "--modelcfg", str(cfg),
             "--initweightfile", "", "--bg_dir", "/nonexistent",
             "--checkpoint_dir", ckpt, "--dp", "2", "--device", "cpu"]

    root = str(tmp / "occ")
    lm = make_linemod_fixture(root, ("benchvise", "ape", "can"), n_frames=2,
                              occlusion_objects=("ape",), seed=50)
    occ, ape = os.path.join(root, "occlusion.data"), \
        os.path.join(root, "ape_occlusion.data")
    train_list = os.path.join(root, "train_occlusion.txt")
    with open(train_list, "w") as f:
        f.write("\n".join(os.path.join(lm, o, "JPEGImages", f"00{i:04d}.jpg")
                          for o in ("ape", "can") for i in range(2)) + "\n")
    with open(occ, "w") as f:
        f.write(occlusion_datacfg(linemod_root=lm, train_list=train_list,
                                  backup_root=os.path.join(root, "bk")))
    with open(ape, "w") as f:
        f.write(occlusion_datacfg("ape", linemod_root=lm))
    mcfg = os.path.join(root, "tiny_multi.cfg")
    with open(mcfg, "w") as f:
        f.write(TINY_MULTI_CFG)

    # the bank backends' runs, each with a backup directory of its own
    bank_data = tmp / "bank.data"
    bank_data.write_text(re.sub(r"backup = .*", f"backup = {tmp / 'bk_bank'}",
                                open(datacfg).read()))
    occ_synth = os.path.join(root, "occlusion_synth.data")
    with open(occ_synth, "w") as f:
        f.write(occlusion_datacfg(linemod_root=lm, train_list=train_list,
                                  backup_root=os.path.join(root, "bk_synth")))
    banks = {
        "bank": _start("cli", "train", "--datacfg", str(bank_data),
                       "--modelcfg", str(cfg), "--initweightfile", "",
                       "--bg_dir", "/nonexistent", "--loader_backend",
                       "device_bank", "--max_epochs", "1", "--dp", "2",
                       "--device", "cpu"),
        "synth": _start("cli", "train-multi", "--datacfg", occ_synth,
                        "--modelcfg", mcfg, "--initweightfile", "",
                        "--linemod_root", lm, "--max_epochs", "1",
                        "--bg_dir", "/nonexistent", "--loader_backend",
                        "device_synth", "--synth_attempts", "4", "--dp", "2",
                        "--device", "cpu")}

    # the independent runs side by side: train with multi, then the resume
    # with the eval of train's weights (a copy: the resume rewrites them)
    out = {}
    multi = _start("cli", "train-multi", "--datacfg", occ, "--modelcfg",
                   mcfg, "--initweightfile", "", "--linemod_root", lm,
                   "--max_epochs", "1", "--bg_dir", "/nonexistent",
                   "--checkpoint_dir", os.path.join(root, "ckpt"),
                   "--eval_datacfgs", ape, "--dp", "2", "--device", "cpu")
    out["train"] = _worker("cli", *train, "--max_epochs", "2")
    out["steps_after_train"] = Checkpointer(ckpt).steps()
    out["files_after_train"] = sorted(os.listdir(backup))
    weights = os.path.join(backup, "model.weights")
    trained = str(tmp / "trained.weights")
    shutil.copy(weights, trained)
    resume = _start("cli", *train, "--max_epochs", "3", "--resume")
    out["valid"] = _worker("cli", "valid", "--datacfg", datacfg,
                           "--modelcfg", str(cfg), "--weightfile", trained,
                           "--batch_size", "16", "--dp", "2", "--device",
                           "cpu")
    out["multi"] = _finish(multi)
    out["multi_ckpt"] = Checkpointer(os.path.join(root, "ckpt")).steps()
    out["multi_backup"] = os.path.join(root, "bk")
    out["resume"] = _finish(resume)
    out["trained"] = trained
    for k, proc in banks.items():
        out[k] = _finish(proc)
    return tmp, datacfg, str(cfg), ckpt, backup, weights, out


def test_cli_train_on_two_ranks_then_resume(cli_runs):
    """The same losses on both ranks; rank 0 alone writes (its checkpoints,
    its final weights); ``seen`` global through the resume."""
    _, _, cfg, ckpt, backup, weights, out = cli_runs
    for run, n in (("train", 2), ("resume", 1)):
        lines = _per_rank(out[run])
        assert len(lines[0]) == n and lines[0] == lines[1], lines
        saves = re.findall(r"\[rank (\d)/2\] no eval ran; saving final",
                           out[run])
        assert saves == ["0"], saves
    assert out["steps_after_train"] == [2, 4]      # 2 global batches/epoch
    assert out["files_after_train"] == ["model.weights"]
    assert sorted(re.findall(r"\[rank (\d)/2\] resumed from .* at seen=32",
                             out["resume"])) == ["0", "1"]
    assert Checkpointer(ckpt).latest_step() == 6
    assert torch.load(os.path.join(ckpt, "6.pt"),
                      weights_only=True)["seen"] == 48
    assert TW.load_weights(TD.DarknetSpec.from_cfg(cfg), weights)[0].seen \
        == 48
    assert out["train"].count("best accuracy: -inf") == 1


def test_cli_train_multi_on_two_ranks(cli_runs):
    """One epoch of 2 global batches (one scene a rank), the same losses on
    both ranks, the epoch-0 eval over the ranks, rank 0's files."""
    out = cli_runs[-1]
    lines = _per_rank(out["multi"])
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    assert out["multi_ckpt"] == [2]
    assert sorted(os.listdir(out["multi_backup"])) == ["costs.npz",
                                                       "model.weights"]
    assert sorted(re.findall(r"\[rank (\d)/2\] \[multi\] best model so far",
                             out["multi"])) == ["0", "1"]


@pytest.mark.parametrize("run,bank", [
    ("bank", r"^device_bank: 16 frames"),
    ("synth", r"^device_synth bank: \d+ frames")])
def test_cli_bank_backends_on_two_ranks(cli_runs, run, bank):
    """``train --dp 2 --loader_backend device_bank`` (2 global batches of
    8) and ``train-multi --dp 2 --loader_backend device_synth`` (2 of 2)
    run: each rank builds the whole bank and trains on its rows, the same
    finite loss logged on both ranks."""
    out = cli_runs[-1][run]
    assert len(re.findall(bank, out, re.M)) == 2, out[-3000:]
    lines = _per_rank(out)
    assert len(lines[0]) == 1 and lines[0] == lines[1], lines
    loss = float(re.search(r"loss (\S+)", lines[0][0]).group(1))
    assert np.isfinite(loss), lines


def _summary_lines(out: str):
    """The eval's logged numbers (rank 0 alone logs them)."""
    nums = {}
    for key, pat in (("acc_2d", r"Acc using 5 px 2D Projection = ([\d.]+)%"),
                     ("acc_add", r"3D Transformation = ([\d.]+)%"),
                     ("mean_err_2d", r"Mean 2D pixel error is ([\d.e+-]+)"),
                     ("mean_err_3d", r"Mean vertex error is ([\d.e+-]+)")):
        found = re.findall(pat, out)
        assert len(found) == 1, (key, found)
        nums[key] = float(found[0])
    return nums


@pytest.mark.parametrize("batch", [8, 16])
def test_cli_valid_on_two_ranks_is_the_one_process_summary(cli_runs, batch):
    """``valid --dp 2 --batch_size 16`` serves 8 rows a rank: the summary
    one process logs at batch 8 (the same frames in each serve), and
    within the module's tolerance of one process at batch 16."""
    _, datacfg, cfg, _, _, _, out = cli_runs
    assert re.search(r"\[rank 0/2\] +Number of test samples: 16",
                     out["valid"])
    got = _summary_lines(out["valid"])
    want = TDr.run_validation(datacfg, cfg, out["trained"], batch_size=batch,
                              num_workers=0, device="cpu", verbose=False)
    assert want["n_samples"] == 16
    pairs = (("mean_err_2d", "mean_err_2d"), ("mean_err_3d", "mean_err_3d"),
             ("acc_2d", "acc_2d_proj"), ("acc_add", "acc_add_0.1d"))
    if batch == 8:
        # the log's rounding of the one-process summary
        assert got == _summary_lines("\n".join(
            [f"Acc using 5 px 2D Projection = {want['acc_2d_proj']:.2f}%",
             f"3D Transformation = {want['acc_add_0.1d']:.2f}%",
             f"Mean 2D pixel error is {want['mean_err_2d']:f}",
             f"Mean vertex error is {want['mean_err_3d']:f}"]))
        return
    for key, wkey in pairs[:2]:
        assert abs(got[key] - want[wkey]) <= 1e-3 * max(abs(want[wkey]), 1.0)
    for key, wkey in pairs[2:]:
        assert abs(got[key] - want[wkey]) <= 100.0 / 16 + 0.01


def test_cli_valid_from_a_checkpoint_is_the_weightfile_summary(
        cli_runs, monkeypatch, capsys):
    """``valid --checkpoint_dir`` (the latest step and ``--step``) gives the
    summary ``--weightfile`` gives on the weights of the same state."""
    _, datacfg, cfg, ckpt, _, weights, _ = cli_runs
    got = []
    real = TDr.run_validation
    monkeypatch.setattr(TDr, "run_validation",
                        lambda *a, **k: got.append(real(*a, **k)) or got[-1])
    base = ["valid", "--datacfg", datacfg, "--modelcfg", cfg,
            "--batch_size", "8", "--device", "cpu"]
    assert tcli(base + ["--weightfile", weights]) == 0
    assert tcli(base + ["--checkpoint_dir", ckpt]) == 0
    assert tcli(base + ["--checkpoint_dir", ckpt, "--step", "6"]) == 0
    assert "evaluating checkpoint step 6" in capsys.readouterr().out
    assert len(got) == 3
    for s in got[1:]:
        assert s.keys() == got[0].keys()
        for k in s:
            assert s[k] == got[0][k] or (np.isnan(s[k]) and
                                         np.isnan(got[0][k])), k
    with pytest.raises(SystemExit, match="no checkpoints"):
        tcli(base + ["--checkpoint_dir", str(cli_runs[0] / "nothing")])


def test_cli_valid_dp_1_runs_in_this_process(cli_runs, monkeypatch):
    """``valid --dp 1`` outside ``torchrun`` runs its group of one in this
    process (no rank is spawned): ``run_validation`` gets a gloo group of
    one rank and gives the summary of the run with no group, bit for bit;
    the process group is torn down after."""
    _, datacfg, cfg, _, _, weights, _ = cli_runs
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)

    def no_spawn(*a, **k):
        raise AssertionError("--dp 1 spawned a rank")

    monkeypatch.setattr(torch.multiprocessing, "spawn", no_spawn)
    got = []
    real = TDr.run_validation
    monkeypatch.setattr(
        TDr, "run_validation",
        lambda *a, **k: got.append((k["group"], real(*a, **k))) or got[-1][1])
    base = ["valid", "--datacfg", datacfg, "--modelcfg", cfg,
            "--weightfile", weights, "--batch_size", "8", "--device", "cpu"]
    assert tcli(base + ["--dp", "1"]) == 0
    assert not torch.distributed.is_initialized()
    assert tcli(base) == 0
    (group, s1), (none, s0) = got
    assert none is None and group.world == 1 and group.backend == "gloo"
    assert s1.keys() == s0.keys()
    for k in s0:
        assert np.float64(s1[k]).tobytes() == np.float64(s0[k]).tobytes(), k
