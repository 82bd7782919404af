"""The port's training options and training-side public names against the
JAX package's, on the CPU: ``loss_config_from_spec(honor_cfg_scales=)``,
``init_train_state(decay_bn_bias=False)`` with ``no_decay_mask_for``,
``TrainRunConfig.save_best_metric``, ``drivers.load_spec``,
``training.make_eval_forward``, and which data-parallel steps
``capture_train_step`` and ``run_training(precompile_buckets=True)`` take.

Tolerances: the configs and the mask exactly; the inference forward rel
1e-4 of max|ref| and a 3-step f32 trajectory rel 1e-4 (the ones
``tests/test_torch_training.py`` states for the eval forward and the
trajectory); which evaluations write ``model.weights`` exactly, NaN metrics
included.
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import training as JTr
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu import zoo as JZ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.ops import losses as JLo

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import training as TTr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch import zoo as TZ
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.parallel import sharding as TS

from torch_port_helpers import (TINY_BLOCKS, TINY_MULTI_BLOCKS, _cfg_text,
                                jax_params, rel_err)
from test_drivers import TINY_CFG, _make_synthetic_linemod
from test_torch_training import B, IMG, _batches
LR, MOM = 1e-3, 0.9
EPOCH = 16


@pytest.fixture(scope="module")
def tiny():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=31)
    return jspec, tspec, params, stats


def _port_model(tspec, params, stats):
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    return model


# ---------------------------------------------------------------------------
# loss_config_from_spec(honor_cfg_scales=)
# ---------------------------------------------------------------------------


def _region_blocks():
    """The tiny net with a [region] block whose scales and thresh all
    differ from the defaults."""
    blocks = [dict(b) for b in TINY_BLOCKS]
    blocks[-1].update(object_scale="3.5", noobject_scale="0.25",
                      class_scale="2", coord_scale="1.5", thresh="0.45")
    return blocks


_NETS = {"tiny_region": _region_blocks, "multi": lambda: TINY_MULTI_BLOCKS,
         "pretrain": lambda: JZ.yolo_pose_pretrain().blocks}


@pytest.mark.parametrize("honor", [False, True])
@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("net", sorted(_NETS))
def test_loss_config_from_spec_matches_jax(net, multi, honor):
    blocks = _NETS[net]()
    kw = dict(pretrain_num_epochs=7, im_width=640, im_height=480,
              multi=multi, honor_cfg_scales=honor)
    got = dataclasses.asdict(TDr.loss_config_from_spec(TSpec(blocks), **kw))
    want = dataclasses.asdict(JDr.loss_config_from_spec(JSpec(blocks), **kw))
    want.pop("use_pallas")
    want.pop("mesh")
    assert got == want
    if honor and net == "tiny_region":
        assert (got["object_scale"], got["sil_thresh"]) == (3.5, 0.45)
    if not honor:
        assert (got["object_scale"], got["sil_thresh"]) == (5.0, 0.6)


# ---------------------------------------------------------------------------
# load_spec and make_eval_forward
# ---------------------------------------------------------------------------


def test_load_spec_matches_jax(tmp_path):
    path = tmp_path / "tiny.cfg"
    path.write_text(_cfg_text(TINY_BLOCKS))
    got, want = TDr.load_spec(str(path)), JDr.load_spec(str(path))
    assert got.blocks == want.blocks
    assert got.format_network() == want.format_network()
    assert TDr.load_spec(got) is got


@pytest.mark.parametrize("folded", [False, True], ids=["running", "folded"])
def test_make_eval_forward_matches_jax(tmp_path, tiny, folded):
    """The head of ``make_eval_forward`` on a spec from ``load_spec``
    against JAX's ``make_eval_forward`` on JAX's ``load_spec``."""
    path = tmp_path / "tiny.cfg"
    path.write_text(_cfg_text(TINY_BLOCKS))
    _, _, params, stats = tiny
    jspec, tspec = JDr.load_spec(str(path)), TDr.load_spec(str(path))
    img = np.random.RandomState(17).rand(B, IMG, IMG, 3).astype(np.float32)
    jfwd = JTr.make_eval_forward(jspec, compute_dtype=None, folded=folded)
    want = jfwd(jfold(jspec, params, stats), jnp.asarray(img)) if folded \
        else jfwd(params, stats, jnp.asarray(img))
    model = _port_model(tspec, params, stats)
    model.train()
    fwd = TTr.make_eval_forward(model, compute_dtype=None, folded=folded)
    got = fwd(torch.from_numpy(img))
    assert model.training                 # its mode is left as it was
    assert not got.requires_grad
    assert tuple(got.shape) == want.shape
    assert rel_err(got.numpy(), want) <= 1e-4
    # the folded forward is the serving forward of the model's parameters
    if folded:
        for dtype in (None, torch.bfloat16):
            ref = apply_folded(tspec, fold_batchnorm(model),
                               torch.from_numpy(img), compute_dtype=dtype)
            out = TTr.make_eval_forward(model, compute_dtype=dtype,
                                        folded=True)(torch.from_numpy(img))
            assert torch.equal(out, ref)


# ---------------------------------------------------------------------------
# decay_bn_bias=False
# ---------------------------------------------------------------------------


def test_no_decay_mask_marks_jax_parameters(tiny):
    jspec, tspec, params, _ = tiny
    jmask = JTr.no_decay_mask_for(jspec, params)
    names = {"w": "weight", "scale": "scale", "bias": "bias", "b": "bias"}
    want = {f"{layer}.{names[k]}": v for layer, d in jmask.items()
            for k, v in d.items()}
    got = TTr.no_decay_mask_for(Darknet(tspec))
    assert got == want
    assert sum(got.values()) and not all(got.values())


def test_no_decay_trajectory_matches_jax(tiny):
    """3 f32 steps of ``init_train_state(decay_bn_bias=False)`` against
    JAX's ``make_train_step(decay_bn_bias=False)``.  The weight decay is
    large enough that decaying the BN terms would show: JAX's step with the
    decay on everything lies well outside the tolerance."""
    jspec, tspec, params, stats = tiny
    wd = 5.0
    batches = _batches(3, seed=8)
    jcfg = JLo.RegionLossConfig.single(use_pallas=False)
    jstates = {}
    for decay in (False, True):
        jstep = JTr.make_train_step(jspec, jcfg, weight_decay=wd,
                                    momentum=MOM, compute_dtype=None,
                                    decay_bn_bias=decay, donate=False)
        js = JTr.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, stats))
        for imgs, tgt in batches:
            js, _ = jstep(js, jnp.asarray(imgs), jnp.asarray(tgt),
                          np.float32(LR), np.int32(EPOCH))
        jstates[decay] = js
    state = TTr.init_train_state(_port_model(tspec, params, stats),
                                 weight_decay=wd, momentum=MOM,
                                 decay_bn_bias=False)
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == \
        [wd, 0.0]
    step = TTr.make_train_step(RegionLossConfig(), compute_dtype=None)
    for imgs, tgt in batches:
        step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR, EPOCH)
    got = state.model.state_dict()
    for decay, tol_ok in ((False, True), (True, False)):
        js = jstates[decay]
        want = TW.params_from_jax(tspec, jax.tree.map(np.asarray, js.params),
                                  jax.tree.map(np.asarray, js.batch_stats))
        errs = {k: rel_err(got[k], want[k]) for k in want}
        if tol_ok:
            assert max(errs.values()) <= 1e-4, errs
            jm = TW.params_from_jax(tspec,
                                    jax.tree.map(np.asarray, js.momentum))
            for name, p in state.model.named_parameters():
                buf = state.optimizer.state[p]["momentum_buffer"]
                assert rel_err(buf, jm[name]) <= 1e-4, name
        else:
            assert errs["conv_1.scale"] > 1e-3, errs["conv_1.scale"]
    assert state.seen == 3 * B


def test_no_decay_state_checkpoints(tiny, tmp_path):
    """Two parameter groups go through a checkpoint and the captured
    step's state walk unchanged."""
    from singleshotpose_tpu_torch.checkpoint import Checkpointer
    _, tspec, params, stats = tiny
    state = TTr.init_train_state(_port_model(tspec, params, stats),
                                 weight_decay=1.0, momentum=MOM,
                                 decay_bn_bias=False)
    step = TTr.make_train_step(RegionLossConfig(), compute_dtype=None)
    (imgs, tgt), = _batches(1, seed=9)
    step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR, EPOCH)
    Checkpointer(str(tmp_path)).save(1, state)
    again = TTr.init_train_state(Darknet(tspec), weight_decay=1.0,
                                 momentum=MOM, decay_bn_bias=False)
    Checkpointer(str(tmp_path)).restore(again)
    for a, b in zip(state.model.parameters(), again.model.parameters()):
        assert torch.equal(a, b)
        assert torch.equal(state.optimizer.state[a]["momentum_buffer"],
                           again.optimizer.state[b]["momentum_buffer"])
    one_group = TTr.init_train_state(Darknet(tspec), weight_decay=1.0,
                                     momentum=MOM)
    with pytest.raises(ValueError, match="parameter groups"):
        Checkpointer(str(tmp_path)).restore(one_group)


# ---------------------------------------------------------------------------
# save_best_metric
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("options_synth")
    datacfg, _ = _make_synthetic_linemod(tmp)
    cfgfile = tmp / "tiny.cfg"
    cfgfile.write_text(TINY_CFG)
    return datacfg, str(cfgfile), tmp


_KEYS = ("loss", "loss_x", "loss_y", "loss_conf", "loss_cls", "nGT",
         "nCorrect", "nProposals")


def _trace_run(monkeypatch, drivers, weights, run, metric, values, other):
    """``run()`` with the trainer's train step a no-op and its evaluations
    scripted (``metric`` takes ``values`` in turn, the other metric
    ``other``); returns after which evaluation each ``model.weights`` was
    written (0: before any) and the run's result."""
    evals, saves = [], []

    def summary(*a, **k):
        i = len(evals)
        evals.append(i)
        s = {"acc_2d_proj": other[i], "mean_err_2d": other[i],
             "mean_err_angle": 0.0, "n_samples": 6}
        s[metric] = values[i]
        return s

    monkeypatch.setattr(drivers, "run_validation", summary)
    monkeypatch.setattr(weights, "save_weights",
                        lambda *a, **k: saves.append(len(evals)))
    result = run()
    return saves, result


def _jax_noop_step(*a, **k):
    def step(state, images, target, lr, epoch):
        return state, {key: np.float32(0) for key in _KEYS}
    return step


def _port_noop_step(*a, **k):
    def step(state, images, target, lr, epoch):
        state.seen += images.shape[0]
        return {key: torch.zeros(()) for key in _KEYS}
    return step


@pytest.mark.parametrize("metric,values", [
    ("mean_err_2d", [math.nan, 3.0, 2.0, 5.0]),
    ("acc_2d_proj", [50.0, math.nan, 40.0, 60.0]),
    ("acc_2d_proj", [math.nan] * 4),
    ("mean_err_2d", [2.0, 2.0, 1.0, 3.0]),
])
def test_save_best_metric_writes_as_jax(synth, monkeypatch, tmp_path,
                                        metric, values):
    """``model.weights`` is written after the same evaluations as the JAX
    trainer writes it, for the metric ``save_best_metric`` names: a new
    best is ``acc > best``, so a NaN is never one, and a run whose every
    metric was NaN writes its final weights at the end, as one that never
    evaluated."""
    datacfg, cfgfile, _ = synth
    other = [10.0, 90.0, 95.0, 20.0]
    common = dict(eval_every=1, eval_after=-1, num_workers=0,
                  bg_dir="/nonexistent", max_epochs_override=4,
                  compute_dtype=None, loader_backend="python",
                  eval_transfer="rgb", save_best_metric=metric)
    monkeypatch.setattr(JDr, "make_train_step", _jax_noop_step)
    monkeypatch.setattr(TDr, "make_train_step", _port_noop_step)
    jsaves, jres = _trace_run(
        monkeypatch, JDr, JW, lambda: JDr.run_training(
            datacfg, cfgfile, None, 100, JDr.TrainRunConfig(**common)),
        metric, values, other)
    tsaves, tres = _trace_run(
        monkeypatch, TDr, TW, lambda: TDr.run_training(
            datacfg, cfgfile, None, 100,
            TDr.TrainRunConfig(device="cpu", **common)),
        metric, values, other)
    assert tsaves == jsaves
    assert tres["history"]["testing_accuracies"] == pytest.approx(
        jres["history"]["testing_accuracies"], nan_ok=True)
    assert tres["best_acc"] == pytest.approx(jres["best_acc"], nan_ok=True)
    if all(math.isnan(v) for v in values):
        assert tsaves == [4]              # the final weights, after 4 evals


# ---------------------------------------------------------------------------
# data-parallel steps: NCCL captured, gloo refused
# ---------------------------------------------------------------------------


@pytest.fixture
def gloo_group():
    group = TS.make_dp_group(1, device="cpu")
    yield group
    torch.distributed.destroy_process_group()


def _nccl_stub(world=1):
    """What the capture and the drivers read of an NCCL group (NCCL needs
    a card)."""
    return types.SimpleNamespace(backend="nccl", world=world, rank=0, mp=1,
                                 device=torch.device("cpu"))


def _grid_stub(backend, dp, mp):
    """What the capture and the drivers read of a data × model grid: the
    data axis's ``world`` and ``rank``, the model axis's ``mp``."""
    return types.SimpleNamespace(backend=backend, world=dp, rank=0, mp=mp,
                                 model_rank=0, device=torch.device("cpu"))


GRID_SHAPES = [(1, 2), (2, 2), (1, 4)]


def _state(tspec):
    return TTr.init_train_state(Darknet(tspec), weight_decay=0.0,
                                momentum=0.9)


def test_gloo_steps_are_refused_with_the_reason(gloo_group, tmp_path):
    tspec = TSpec(TINY_BLOCKS)
    step = TTr.make_train_step(RegionLossConfig(), group=gloo_group)
    with pytest.raises(ValueError, match="gloo group cannot be captured: "
                                         "its collectives run on the host"):
        TTr.capture_train_step(step, _state(tspec), [64], 2, 1050)
    rc = TDr.TrainRunConfig(group=gloo_group, precompile_buckets=True,
                            device="cpu")
    with pytest.raises(ValueError, match="gloo group cannot be captured"):
        TDr._check_dp_options(rc)
    with pytest.raises(ValueError, match="gloo group cannot be captured"):
        TDr.run_training_multi(str(tmp_path / "none.data"), tspec, None, 0,
                               [], None, rc)


def test_nccl_steps_are_not_refused_on_the_option():
    """An NCCL group with ``precompile_buckets`` passes the drivers' check
    (whatever the train loader: the check no longer reads it), and
    ``capture_train_step`` takes its step: on the CPU it stops only at the
    device, as it does for a step with no group."""
    for world in (1, 2):
        rc = TDr.TrainRunConfig(group=_nccl_stub(world),
                                precompile_buckets=True)
        TDr._check_dp_options(rc)
    step = TTr.make_train_step(RegionLossConfig(), group=_nccl_stub())
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TTr.capture_train_step(step, _state(TSpec(TINY_BLOCKS)), [64], 2,
                               1050)


@pytest.mark.parametrize("dp,mp", GRID_SHAPES)
def test_nccl_grid_steps_are_not_refused(dp, mp):
    """An NCCL data × model grid with ``precompile_buckets`` passes the
    drivers' check, and ``capture_train_step`` takes its step: on the CPU
    it stops only at the device, as for a step with no group."""
    rc = TDr.TrainRunConfig(group=_grid_stub("nccl", dp, mp),
                            precompile_buckets=True)
    TDr._check_dp_options(rc)
    step = TTr.make_train_step(RegionLossConfig(),
                               group=_grid_stub("nccl", dp, mp))
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TTr.capture_train_step(step, _state(TSpec(TINY_BLOCKS)), [64], 2,
                               1050)


@pytest.mark.parametrize("dp,mp", GRID_SHAPES)
def test_gloo_grid_steps_are_refused_with_the_gloo_reason(dp, mp):
    """A gloo grid's captured step is refused by name, for gloo (its
    collectives run on the host), by the drivers' check and by
    ``capture_train_step``; no reason names the grid."""
    rc = TDr.TrainRunConfig(group=_grid_stub("gloo", dp, mp),
                            precompile_buckets=True)
    with pytest.raises(ValueError, match=r"^precompile_buckets: a "
                       "data-parallel step over a gloo group cannot be "
                       r"captured \(its collectives run on the host"):
        TDr._check_dp_options(rc)
    step = TTr.make_train_step(RegionLossConfig(),
                               group=_grid_stub("gloo", dp, mp))
    with pytest.raises(ValueError, match="^a data-parallel train step over "
                       "a gloo group cannot be captured: its collectives "
                       "run on the host"):
        TTr.capture_train_step(step, _state(TSpec(TINY_BLOCKS)), [64], 2,
                               1050)


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_captured_grid_step_counts_the_global_batch(dp, mp):
    """On a grid a replay adds the data rank's rows times the data ranks
    to ``seen`` — the global batch, JAX's count under ``make_mesh(dp,
    mp)`` — not times every rank of the grid."""
    state = _state(TSpec(TINY_BLOCKS))
    step = TTr.make_train_step(RegionLossConfig(),
                               group=_grid_stub("nccl", dp, mp))
    images = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    graph = types.SimpleNamespace(replay=lambda: None)
    captured = TTr.CapturedTrainStep(
        step, state, {tuple(images.shape): (graph, images, {})},
        torch.zeros((2, 1050)), torch.zeros(()),
        torch.zeros((), dtype=torch.int64), {})
    captured(state, images, torch.zeros((2, 1050)), 1e-3, 3)
    captured(state, images, torch.zeros((2, 1050)), 1e-3, 3)
    assert captured.replays == 2 and state.seen == 2 * 2 * dp


@pytest.mark.parametrize("world", [None, 1, 2])
def test_captured_step_counts_the_global_batch(world):
    """A replay adds the global batch to ``seen``: the rank's rows times
    the group's ranks (the eager step's count)."""
    tspec = TSpec(TINY_BLOCKS)
    state = _state(tspec)
    step = TTr.make_train_step(
        RegionLossConfig(), group=None if world is None else _nccl_stub(world))
    images = torch.zeros((2, 64, 64, 3), dtype=torch.uint8)
    replays = []
    graph = types.SimpleNamespace(replay=lambda: replays.append(1))
    stats = {"loss": torch.ones(())}
    captured = TTr.CapturedTrainStep(
        step, state, {tuple(images.shape): (graph, images, stats)},
        torch.zeros((2, 1050)), torch.zeros(()),
        torch.zeros((), dtype=torch.int64), {})
    out = captured(state, images, torch.zeros((2, 1050)), 1e-3, 3)
    assert replays == [1] and captured.replays == 1
    assert state.seen == 2 * (world or 1)
    assert torch.equal(out["loss"], stats["loss"]) and \
        out["loss"] is not stats["loss"]
