"""PyTorch port: output-channel tensor parallelism — the data × model grid
of ``parallel/sharding.make_dp_group(dp, mp)``, convs split by output
channel (``models/darknet.py``), the train step and the eval passes on the
grid — on gloo ranks on the CPU, against the JAX package's step on a
``make_mesh(dp, mp)`` mesh of its virtual CPU devices (its Pallas stem in
interpret mode) and against the port in one process.

The ranks run in ``tests/torch_tp_worker.py``, a jax-free worker (``jax``
and ``singleshotpose_tpu`` blocked there and in every rank it spawns), one
spawn per grid shape: 2×2 and 1×4 (held against JAX) and 1×2 (the card
phase's shape).  The nets: the JAX step test's ``TINY_CFG`` (``f32``), a
narrow net with a ``route`` and a ``reorg`` and convs of 10 and 5 filters,
replicated beside the split ones (``route``), the fused-stem spec of
``tests/test_stem.py`` in bf16 (``bf16``) and the tiny multi-object net
(``multi``).  The tolerances are JAX's own for its sharded paths:

- the f32 step (B=8, lr 0.00025, epoch 100): loss rtol 1e-4, every
  parameter and BN statistic of the gathered state rtol 1e-4, atol 1e-6
  (``tests/test_training.py:146-208``); the momentum — the step's
  gradient — to 1e-4 of each tensor's largest value (the port's bound for
  f32 gradients, ``tests/test_torch_training.py``: summed in another
  order, small entries of a large sum have no relative bound);
- the bf16 fused-stem step: loss rtol 1e-3, conv_1's and conv_2's weights
  atol 6e-4, conv_1's running mean atol 1e-5 (``tests/test_torch_parallel.py``);
- ``run_validation`` and ``run_validation_multi`` on the grid against one
  process: rtol 1e-4, atol 1e-5 (``tests/test_drivers.py:221-250``);
- the trainers (``run_training`` on 1×4 with the python loader and on 2×2
  with ``device_bank``, f32, the drivers' tiny cfg at batch 4: one epoch of
  2 steps from JAX's initial state) against JAX's ``run_training`` on the
  same mesh: each step's loss rtol 1e-4, the final state rtol 1e-4, atol
  1e-6, its momentum to 1e-4 of each tensor's max — the step's bounds, not
  widened for the second step;
- bit for bit: the device banks' rows (``Loader(group=)``) against JAX's
  ``Loader(mesh=)`` rows (``device_bank``) and the one-process port
  batch's rows (``device_synth``); checkpoints from the grid read in one
  process and one process's restored on the grid; a grid run failed at a
  step on every rank and resumed against the unbroken run (the loader's
  batches made a function of the epoch in the worker, ``_EpochLoader``:
  the loader, as JAX's, restarts its stream on resume).
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu.config import parse_cfg as jparse_cfg
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.ops import stem as jstem
from singleshotpose_tpu.ops.losses import RegionLossConfig as JLossConfig
from singleshotpose_tpu.parallel.sharding import (batch_stats_shardings,
                                                  make_mesh, param_shardings,
                                                  shard_host_batch)
from singleshotpose_tpu.training import TrainState
from singleshotpose_tpu.training import make_train_step as jmake_train_step

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.models import darknet as TD
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.parallel.sharding import shards_channels
from singleshotpose_tpu_torch.training import (init_train_state,
                                               make_train_step)
from singleshotpose_tpu_torch.zoo import yolo_pose_multi, yolo_pose_single

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from test_drivers import TINY_CFG as DRIVER_CFG, _make_synthetic_linemod
from test_stem import _tiny_spec as stem_spec
from test_torch_parallel import _bf16_target
from test_training import TINY_CFG as STEP_CFG, _tiny_target
from torch_bank_helpers import (bank_references, check_bank_rows,
                                check_synth_rows, synth_reference,
                                write_backgrounds, write_occlusion_tree)
from torch_port_helpers import (TINY_BLOCKS, TINY_MULTI_BLOCKS,
                                TINY_MULTI_CFG, _cfg_text)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_tp_worker.py")
LR, EPOCH, DECAY, MOMENTUM = 0.00025, 100, 0.002, 0.9
STEPS = 2
B = 8
GRIDS = ((2, 2), (1, 4), (1, 2))
JAX_GRIDS = ((2, 2), (1, 4))
TAGS = ("f32", "route", "bf16", "multi")
MULTI_LOSS = dict(pretrain_num_epochs=15, im_width=640, im_height=480)

# TINY_BLOCKS with its 16-filter conv at 10 and its 1x1 passthrough conv at
# 5: at mp 2 the 5-filter conv is replicated, at mp 4 both are
ROUTE_BLOCKS = [dict(b) for b in TINY_BLOCKS]
ROUTE_BLOCKS[3]["filters"] = "10"
ROUTE_BLOCKS[12]["filters"] = "5"


def _gid(grid):
    return f"{grid[0]}x{grid[1]}"


def _multi_batch(seed=32):
    """u8 images and padded targets: 1–9 GTs an image, classes 0–12, each
    GT's 8 corners around its centroid, extents from them."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (B, 64, 64, 3)).astype(np.uint8)
    t = np.zeros((B, 50, 21), np.float32)
    for b in range(B):
        for g in range(rng.randint(1, 10)):
            c = rng.uniform(0.15, 0.85, 2)
            pts = np.vstack([c, c + rng.uniform(-0.1, 0.1, (8, 2))])
            t[b, g, 0] = rng.randint(13)
            t[b, g, 1:19] = pts.reshape(-1)
            t[b, g, 19:21] = np.ptp(pts, axis=0)
    return imgs, t.reshape(B, -1)


def _nets(wd):
    return {"f32": JSpec(jparse_cfg(_write(wd / "f32.cfg", STEP_CFG))),
            "route": JSpec(ROUTE_BLOCKS), "bf16": stem_spec(),
            "multi": JSpec(TINY_MULTI_BLOCKS)}


def _write(path, text):
    path.write_text(text)
    return str(path)


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


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The nets' blocks and initial states (JAX's ``init_params(PRNGKey(0))``
    carried into the port), the batches and the eval corpus, written for
    the worker."""
    wd = tmp_path_factory.mktemp("tp")
    nets = _nets(wd)
    rng = np.random.RandomState(3)
    inp = {"f32_images": rng.rand(B, 64, 64, 3).astype(np.float32),
           "f32_target": _tiny_target(B),
           "route_images": rng.rand(B, 64, 64, 3).astype(np.float32),
           "route_target": _tiny_target(B),
           "bf16_images": rng.rand(B, 32, 32, 3).astype(np.float32),
           "bf16_target": _bf16_target()}
    inp["multi_images"], inp["multi_target"] = _multi_batch()
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
    # the multi eval reads labels_occlusion/ beside JPEGImages/
    obj = corpus / "obj"
    (obj / "labels_occlusion").mkdir()
    for f in (obj / "labels").iterdir():
        (obj / "labels_occlusion" / f.name).write_bytes(f.read_bytes())
    (corpus / "tiny.cfg").write_text(_cfg_text(ROUTE_BLOCKS))
    (corpus / "tiny_multi.cfg").write_text(TINY_MULTI_CFG)
    _trainer_files(wd)
    write_occlusion_tree(wd)
    return wd, inp, nets


# the trainer runs, each with a .data of its own (its own backup directory):
# the grid's and JAX's
TRAIN_RUNS = {"python": (1, 4), "bank": (2, 2)}
RUN_DATA = ("1x4_python", "2x2_bank", "2x2_unbroken", "2x2_fail",
            "jax_python", "jax_bank")


def _trainer_files(wd):
    """The trainers' inputs: two backgrounds, the drivers' tiny cfg at
    batch 4 (8 frames: 2 steps an epoch), a .data per run, JAX's initial
    state (``init_params(PRNGKey(0))``, what JAX's ``run_training`` starts
    from) as a one-process checkpoint of step 0, and a one-process
    checkpoint after one step (its momentum nonzero)."""
    corpus = wd / "corpus"
    write_backgrounds(corpus)
    rng = np.random.RandomState(11)
    (corpus / "trainer.cfg").write_text(DRIVER_CFG.replace("batch=2",
                                                           "batch=4"))
    data = (corpus / "synth.data").read_text()
    for run in RUN_DATA:
        (corpus / f"{run}.data").write_text(re.sub(
            r"backup = .*", f"backup = {corpus / ('backup_' + run)}", data))
    cfg = str(corpus / "trainer.cfg")
    tspec = TD.DarknetSpec.from_cfg(cfg)
    params, stats = JSpec(jparse_cfg(cfg)).init_params(jax.random.PRNGKey(0))
    model = TD.Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(
        tspec, jax.tree.map(np.asarray, params),
        jax.tree.map(np.asarray, stats)))
    net = tspec.net
    state = init_train_state(model, weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    Checkpointer(str(wd / "trainer_init")).save(0, state)
    step = make_train_step(RegionLossConfig(), compute_dtype=None)
    step(state, torch.from_numpy(rng.rand(4, 64, 64, 3).astype(np.float32)),
         torch.from_numpy(_tiny_target(4)), LR, EPOCH)
    Checkpointer(str(wd / "one_process")).save(1, state)


def _jax_step(tag, nets, inp, grid):
    """One step of JAX's train step on a ``make_mesh(dp, mp)`` mesh: the
    loss and the state (parameters and statistics; momentum) in the port's
    form."""
    jspec = nets[tag]
    mesh = make_mesh(jax.devices()[:grid[0] * grid[1]], dp=grid[0],
                     mp=grid[1])
    bf16 = tag == "bf16"
    cfg = JDr.loss_config_from_spec(jspec, use_pallas=False, multi=True,
                                    **MULTI_LOSS) if tag == "multi" \
        else JLossConfig.single()
    step = jmake_train_step(
        jspec, cfg, weight_decay=DECAY, momentum=MOMENTUM,
        compute_dtype=jnp.bfloat16 if bf16 else None, donate=False,
        fused_stem=bf16, stem_mesh=mesh if bf16 else None)
    imgs, tgt = shard_host_batch(mesh, inp[f"{tag}_images"],
                                 inp[f"{tag}_target"])
    state, stats = step(_jax_state(jspec, mesh), imgs, tgt, LR, EPOCH)
    tspec = TD.DarknetSpec(jspec.blocks)
    sd = TW.params_from_jax(tspec, jax.tree.map(np.asarray, state.params),
                            jax.tree.map(np.asarray, state.batch_stats))
    mom = TW.params_from_jax(tspec, jax.tree.map(np.asarray, state.momentum))
    return float(stats["loss"]), sd, mom


def _port_steps(tag, setup):
    """STEPS steps of the port's step in one process on the whole batch:
    the losses and the state after the first and after the last step."""
    wd, inp, _ = setup
    spec = TD.DarknetSpec(json.loads((wd / f"{tag}_blocks.json").read_text()))
    model = TD.Darknet(spec)
    model.load_state_dict(torch.load(wd / f"{tag}.pt", weights_only=True))
    state = init_train_state(model, weight_decay=DECAY, momentum=MOMENTUM)
    bf16 = tag == "bf16"
    cfg = TDr.loss_config_from_spec(spec, multi=True, **MULTI_LOSS) \
        if tag == "multi" else RegionLossConfig()
    step = make_train_step(cfg, compute_dtype=torch.bfloat16 if bf16
                           else None, fused_stem=bf16)
    losses, states = [], []
    for _ in range(STEPS):
        losses.append(float(step(state, torch.from_numpy(
            inp[f"{tag}_images"]), torch.from_numpy(inp[f"{tag}_target"]),
            LR, EPOCH)["loss"]))
        sd = {k: v.clone() for k, v in model.state_dict().items()}
        for name, p in model.named_parameters():
            sd[f"momentum/{name}"] = \
                state.optimizer.state[p]["momentum_buffer"].clone()
        states.append(sd)
    return losses, states


def _jax_train(wd, run):
    """JAX's ``run_training`` of the trainer cfg for one epoch on the run's
    mesh (1×4: the python loader; 2×2: ``device_bank``), evals off: the
    losses and the final state in the port's form."""
    dp, mp = TRAIN_RUNS[run]
    corpus = wd / "corpus"
    rc = JDr.TrainRunConfig(
        mesh=make_mesh(jax.devices()[:dp * mp], dp=dp, mp=mp),
        loader_backend="python" if run == "python" else "device_bank",
        num_workers=0, log_every=1, bg_dir=str(corpus / "bg"),
        eval_every=100, eval_after=100, max_epochs_override=1)
    rc.compute_dtype = None
    cfg = str(corpus / "trainer.cfg")
    r = JDr.run_training(str(corpus / f"jax_{run}.data"), cfg, None, 100, rc)
    tspec = TD.DarknetSpec.from_cfg(cfg)
    st = r["state"]
    sd = TW.params_from_jax(tspec, jax.tree.map(np.asarray, st.params),
                            jax.tree.map(np.asarray, st.batch_stats))
    mom = TW.params_from_jax(tspec, jax.tree.map(np.asarray, st.momentum))
    return np.asarray(r["history"]["training_losses"]), sd, mom


@pytest.fixture(scope="module")
def runs(setup):
    """One spawn per grid shape, started together; JAX's mesh steps while
    the ranks run.  Returns ({grid: [rank npz]}, {(grid, tag): JAX's})."""
    wd, inp, nets = setup
    procs = {g: subprocess.Popen(
        [sys.executable, WORKER, str(wd), str(g[0]), str(g[1])], cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for g in GRIDS}
    jstem.FORCE_INTERPRET = True
    try:
        jax_refs = {(g, tag): _jax_step(tag, nets, inp, g)
                    for g in JAX_GRIDS for tag in TAGS}
        jax_refs.update({("train", run): _jax_train(wd, run)
                         for run in TRAIN_RUNS})
        jax_refs["bank_rows"] = bank_references(wd)
        jax_refs["synth"] = synth_reference(wd)
    finally:
        jstem.FORCE_INTERPRET = False
        outs = {}
        for g, proc in procs.items():
            try:
                outs[g], _ = proc.communicate(timeout=600)
            finally:
                if proc.poll() is None:
                    proc.kill()
    for g, proc in procs.items():
        assert proc.returncode == 0 and "WORKER_OK" in outs[g], \
            outs[g][-8000:]
    ranks = {g: [dict(np.load(wd / f"grid{_gid(g)}" / f"rank{r}.npz"))
                 for r in range(g[0] * g[1])] for g in GRIDS}
    return ranks, jax_refs


@pytest.fixture(scope="module")
def port_refs(setup):
    return {tag: _port_steps(tag, setup) for tag in TAGS}


def _split_keys(spec: TD.DarknetSpec, mp: int):
    """The state-dict keys of the convs split at ``mp``."""
    return {f"{l.name}.{t}" for l in spec.conv_specs()
            if shards_channels(l.filters, mp)
            for t in ("weight", "scale", "bias", "running_mean",
                      "running_var")}


def _spec(setup, tag):
    wd = setup[0]
    return TD.DarknetSpec(json.loads((wd / f"{tag}_blocks.json").read_text()))


def ranks_of(runs, grid):
    return runs[0][grid]


# ---------------------------------------------------------------------------
# the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_rank_layout(runs, grid):
    """Global rank r at data coordinate r // mp and model coordinate
    r % mp; ``rank``/``world`` are the data axis's."""
    dp, mp = grid
    for r, out in enumerate(ranks_of(runs, grid)):
        assert out["layout"].tolist() == [r, r // mp, dp, r % mp, mp]


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------


def _check_step(got_loss, got, want_loss, want, tag):
    """``got`` (a rank's gathered state, keys ``<tag>/step1/...``) against
    a reference's loss, state dict and momentum, to the module's
    tolerances."""
    sd, mom = want
    if tag == "bf16":
        np.testing.assert_allclose(got_loss, want_loss, rtol=1e-3)
        for k in ("conv_1.weight", "conv_2.weight"):
            np.testing.assert_allclose(got[f"bf16/step1/{k}"], sd[k].numpy(),
                                       rtol=0, atol=6e-4, err_msg=k)
        np.testing.assert_allclose(got["bf16/step1/conv_1.running_mean"],
                                   sd["conv_1.running_mean"].numpy(),
                                   atol=1e-5)
        return
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)
    assert set(sd) == {k.split("/", 2)[2] for k in got
                       if k.startswith(f"{tag}/step1/")
                       and "/momentum/" not in k and not k.endswith("seen")}
    for k, v in sd.items():
        np.testing.assert_allclose(got[f"{tag}/step1/{k}"], v.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    for k, v in mom.items():
        d = np.abs(got[f"{tag}/step1/momentum/{k}"] - v.numpy()).max()
        assert d <= 1e-4 * np.abs(v.numpy()).max(), (k, d)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("grid", JAX_GRIDS, ids=_gid)
def test_step_matches_jax_mesh(runs, grid, tag):
    """One step on the grid (the state gathered) against JAX's step on a
    ``make_mesh(dp, mp)`` mesh from the same state and batch."""
    ranks, jax_refs = runs
    loss, sd, mom = jax_refs[(grid, tag)]
    for r in ranks[grid]:
        _check_step(r[f"{tag}/losses"][0], r, loss, (sd, mom), tag)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_steps_match_one_process(runs, port_refs, grid, tag):
    """Each step on the grid against the port's step on the whole batch in
    one process: the losses, the state after the first step and after the
    last (gathered), ``seen`` the global batch's.  bf16's bounds are one
    step's from one state (the second step starts from states 6e-4
    apart): after the second its loss is held."""
    losses, states = port_refs[tag]
    for r in ranks_of(runs, grid):
        got = {k.replace("/last/", "/step1/"): v for k, v in r.items()
               if k.startswith(f"{tag}/last/")}
        for i, (want_loss, want) in enumerate(zip(losses, states)):
            if tag == "bf16" and i > 0:
                np.testing.assert_allclose(r[f"{tag}/losses"][i], want_loss,
                                           rtol=1e-3)
                continue
            state = r if i == 0 else got
            sd = {k: v for k, v in want.items()
                  if not k.startswith("momentum/")}
            mom = {k[len("momentum/"):]: v for k, v in want.items()
                   if k.startswith("momentum/")}
            _check_step(r[f"{tag}/losses"][i], state, want_loss, (sd, mom),
                        tag)
        assert int(r[f"{tag}/last/seen"]) == STEPS * B


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_fused_stem_ran_on_the_grid(runs, grid):
    """The bf16 step took the fused train stem (K3–K6's plain versions
    here) at every step, on conv_1's gathered weight."""
    for r in ranks_of(runs, grid):
        assert int(r["bf16/stem_calls"]) == STEPS


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_rank_holds_its_slices(setup, runs, grid, tag):
    """Each rank's parameter and momentum bytes are its slices': 1/mp of
    every split conv's tensors and the whole of every replicated one (the
    route net keeps its 5-filter conv whole at mp 2, and its 10-filter one
    too at mp 4)."""
    spec, mp = _spec(setup, tag), grid[1]
    model = TD.Darknet(spec)
    split = _split_keys(spec, mp)
    want = sum(p.numel() * 4 // (mp if n in split else 1)
               for n, p in model.named_parameters())
    for r in ranks_of(runs, grid):
        params, momentum, whole = r[f"{tag}/bytes"].tolist()
        assert params == momentum == want and whole == sum(
            p.numel() * 4 for p in model.parameters())
    if tag == "route":
        replicated = {k for k in dict(model.named_parameters())} - split
        assert {"conv_6.weight"} <= replicated
        assert ("conv_2.weight" in replicated) == (mp == 4)


@pytest.mark.parametrize("net", ["single", "multi"])
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_full_width_rank_holds_1_over_mp(runs, grid, net):
    """At full width every conv of ``yolo_pose_single`` and
    ``yolo_pose_multi`` divides by 2 and by 4 (32 … 1024 filters, heads 20
    and 160): a rank holds 1/mp of the model's parameter and of its
    momentum bytes."""
    spec = yolo_pose_single() if net == "single" else yolo_pose_multi()
    assert all(shards_channels(l.filters, grid[1])
               for l in spec.conv_specs())
    for r in ranks_of(runs, grid):
        params, momentum, whole = r[f"full_width/{net}"].tolist()
        print(f"{net} at {_gid(grid)}: a rank holds {params} of {whole} "
              f"parameter bytes and {momentum} momentum bytes "
              f"({params / whole:.4f})")
        assert params == momentum and params * grid[1] == whole


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_peers_hold_the_same_bytes(setup, runs, grid, tag):
    """After the steps every rank of a data group holds the same bytes in
    every tensor; the ranks of a model group hold the same bytes in every
    replicated tensor; every rank gathers the same whole state."""
    dp, mp = grid
    ranks = ranks_of(runs, grid)
    split = _split_keys(_spec(setup, tag), mp)
    pre = f"{tag}/local/"
    keys = [k for k in ranks[0] if k.startswith(pre)]
    assert keys
    for r, out in enumerate(ranks):
        data_peer = ranks[r % mp]
        model_peer = ranks[(r // mp) * mp]
        for k in keys:
            assert out[k].tobytes() == data_peer[k].tobytes(), (r, k)
            name = k[len(pre):].replace("momentum/", "")
            if name not in split:
                assert out[k].tobytes() == model_peer[k].tobytes(), (r, k)
        for k in (k for k in out if k.startswith(f"{tag}/last/")):
            assert out[k].tobytes() == ranks[0][k].tobytes(), (r, k)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_gathered_state_is_the_slices_in_model_order(setup, runs, grid, tag):
    """``gather_train_state``: each split tensor is the model group's slices
    concatenated in model-rank order, bit for bit, and each replicated one
    the rank's own."""
    dp, mp = grid
    ranks = ranks_of(runs, grid)
    split = _split_keys(_spec(setup, tag), mp)
    for d in range(dp):
        group = ranks[d * mp:(d + 1) * mp]
        for k in (k for k in group[0] if k.startswith(f"{tag}/last/")):
            name = k[len(f"{tag}/last/"):]
            local = k.replace("/last/", "/local/")
            if name.replace("momentum/", "") in split:
                want = np.concatenate([g[local] for g in group])
            else:
                want = group[0][local]
            assert group[0][k].tobytes() == want.tobytes(), k


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_mp_1_grid_is_the_dp_step(runs, grid):
    """``make_dp_group(dp, 1)`` over every rank is the data-parallel group
    as it was: its step gives the state and loss of a step over
    ``DPGroup(device)`` bit for bit, and it makes no subgroup and gathers
    nothing."""
    for r in ranks_of(runs, grid):
        assert bool(r["mp1/equal"])
        assert int(r["mp1/model_collectives"]) == 0


# ---------------------------------------------------------------------------
# the refusals
# ---------------------------------------------------------------------------


REFUSALS = {
    "precompile_buckets": r"ValueError: precompile_buckets: a data-parallel "
                          r"step over a gloo group cannot be captured \(its "
                          r"collectives run on the host",
    "capture": r"ValueError: a data-parallel train step over a gloo group "
               r"cannot be captured: its collectives run on the host",
    "grid_size": r"ValueError: dp=\d+ × mp=1 = \d+ but the process group "
                 r"has \d ranks",
    "grid_shape": r"ValueError: dp=\d × mp=\d = \d+ but the process group "
                  r"has \d ranks",
    "shard_twice": r"ValueError: shard_train_state takes a whole state",
    "restore_split": r"ValueError: restore loads a whole state: restore into "
                     r"a whole model, then split it",
    "no_grid": r"ValueError: the model is split over \d model ranks but "
               r"runs on a group of mp=1",
    "whole_on_grid": r"ValueError: the model is split over 1 model ranks "
                     r"but runs on a group of mp=\d",
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_refusals_name_their_reason(runs, grid, name):
    """What the grid does not run raises with the reason: a captured step
    over gloo, by ``capture_train_step`` and by the trainers'
    ``precompile_buckets`` (a CPU grid's group is gloo, whose collectives
    run on the host; an NCCL grid's step is captured); and so do a dp·mp
    that is not the process group's size, a split state split again or
    restored into, a split model run without its grid and a whole one on
    it."""
    for r in ranks_of(runs, grid):
        msg = str(r[f"refusal/{name}"])
        assert re.match(REFUSALS[name], msg), msg


# ---------------------------------------------------------------------------
# the eval passes
# ---------------------------------------------------------------------------


EVALS = ("f32", "f32_split", "bank", "int8", "bf16")


@pytest.mark.parametrize("run", EVALS)
@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_run_validation_on_the_grid(runs, grid, run):
    """``run_validation`` on the grid (8 frames in batches of 3: the last
    ragged, zero-padded to a multiple of dp) against one process: from a
    whole model (split on the grid) and from a split one, with the eval
    bank, int8 (whole int8 params on every rank) and bf16 (the serving
    stem on conv_1's gathered folded weights), rtol 1e-4, atol 1e-5."""
    for r in ranks_of(runs, grid):
        keys = [k for k in r if k.startswith(f"eval/{run}/alone/")]
        assert len(keys) > 5
        assert float(r[f"eval/{run}/alone/n_samples"]) == 8
        for k in keys:
            np.testing.assert_allclose(r[k.replace("/alone/", "/grid/")],
                                       r[k], rtol=1e-4, atol=1e-5,
                                       err_msg=k)


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_run_validation_multi_on_the_grid(runs, grid):
    """``run_validation_multi`` on the grid against one process: the
    accuracy table, the mean pixel error and the count."""
    for r in ranks_of(runs, grid):
        assert int(r["eval/multi/alone/n_samples"]) == 8
        for k in ("acc", "mean_err_2d", "n_samples"):
            np.testing.assert_allclose(r[f"eval/multi/grid/{k}"],
                                       r[f"eval/multi/alone/{k}"],
                                       rtol=1e-4, atol=1e-5, err_msg=k)


# ---------------------------------------------------------------------------
# the trainers and their checkpoints on the grid
# ---------------------------------------------------------------------------


def _final(r, run):
    """A rank's gathered final state of a trainer run: (state dict,
    momentum by parameter name, seen)."""
    pre = f"trainer/{run}/final/"
    sd = {k[len(pre):]: v for k, v in r.items()
          if k.startswith(pre) and "/momentum/" not in k
          and not k.endswith("/seen")}
    mom = {k[len(pre) + len("momentum/"):]: v for k, v in r.items()
           if k.startswith(pre + "momentum/")}
    return sd, mom, int(r[pre + "seen"])


def _trainer_spec(setup):
    return TD.DarknetSpec.from_cfg(str(setup[0] / "corpus" / "trainer.cfg"))


def _file_state(path, spec):
    """A checkpoint file's state dict, momentum by parameter name, seen and
    step."""
    payload = torch.load(path, weights_only=True)
    names = [n for n, _ in TD.Darknet(spec).named_parameters()]
    opt = payload["optimizer"]
    order = [i for g in opt["param_groups"] for i in g["params"]]
    mom = {names[i]: opt["state"][i]["momentum_buffer"].numpy()
           for i in order if i in opt["state"]}
    sd = {k: v.numpy() for k, v in payload["model"].items()}
    return sd, mom, payload["seen"], payload["step"]


def _same_bytes(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), k


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_run_training_matches_jax_mesh(runs, run):
    """``run_training`` on the grid (1×4 with the python loader, 2×2 with
    ``device_bank``) against JAX's ``run_training`` on the same mesh from
    the same state and data: each step's loss rtol 1e-4; the final state
    rtol 1e-4, atol 1e-6; its momentum to 1e-4 of each tensor's max."""
    ranks, refs = runs
    want_losses, want_sd, want_mom = refs[("train", run)]
    assert len(want_losses) == 2
    for r in ranks[TRAIN_RUNS[run]]:
        np.testing.assert_allclose(r[f"trainer/{run}/losses"], want_losses,
                                   rtol=1e-4)
        sd, mom, seen = _final(r, run)
        assert seen == 8 and set(sd) == set(want_sd)
        for k, v in want_sd.items():
            np.testing.assert_allclose(sd[k], v.numpy(), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
        for k, v in want_mom.items():
            d = np.abs(mom[k] - v.numpy()).max()
            assert d <= 1e-4 * np.abs(v.numpy()).max(), (k, d)


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_grid_checkpoint_loads_in_one_process(setup, runs, run):
    """The grid's final checkpoint is the one-process format: its model,
    momentum and ``seen`` are the gathered state bit for bit, and a whole
    model in one process restores it."""
    wd = setup[0]
    grid = TRAIN_RUNS[run]
    spec = _trainer_spec(setup)
    ckpt = wd / f"grid{_gid(grid)}" / f"ckpt_{run}"
    sd, mom, seen, step = _file_state(ckpt / "2.pt", spec)
    assert (seen, step) == (8, 2)
    for r in ranks_of(runs, grid):
        got_sd, got_mom, got_seen = _final(r, run)
        _same_bytes(got_sd, sd)
        _same_bytes(got_mom, mom)
        assert got_seen == seen
    state = init_train_state(TD.Darknet(spec), weight_decay=DECAY,
                             momentum=MOMENTUM)
    assert Checkpointer(str(ckpt)).restore(state) == 2
    _same_bytes({k: v.numpy() for k, v in state.model.state_dict().items()},
                sd)


@pytest.mark.parametrize("run", sorted(TRAIN_RUNS))
def test_model_weights_are_the_gathered_state(setup, runs, run):
    """``model.weights`` (the final save: no eval ran) is the gathered
    state's weights and BN statistics bit for bit, ``seen`` the global
    samples."""
    grid = TRAIN_RUNS[run]
    spec = _trainer_spec(setup)
    header, sd = TW.load_weights(spec, str(
        setup[0] / "corpus" / f"backup_{_gid(grid)}_{run}" /
        "model.weights"))
    assert header.seen == 8
    got, _, _ = _final(ranks_of(runs, grid)[0], run)
    _same_bytes({k: got[k] for k in sd}, {k: v.numpy() for k, v in
                                          sd.items()})


# each grid's writes on its writer (global rank 0): checkpoints and weights
# files.  1×4: the python run's epoch-0 and final checkpoints, its final
# weights.  2×2: the bank run's 2 and 1; the unbroken run's 3 (two epochs
# and the final) and 1; the failing run's failure save; the resumed run's
# final checkpoint and weights; the multi run's 2 and its best weights.
WRITES = {(1, 4): [2, 1], (2, 2): [9, 4]}


@pytest.mark.parametrize("grid", sorted(WRITES), ids=_gid)
def test_one_rank_writes(runs, grid):
    """Every checkpoint and weights file of the trainers' runs was written
    by one rank, the writer (data and model coordinate 0)."""
    for g, r in enumerate(ranks_of(runs, grid)):
        want = WRITES[grid] if g == 0 else [0, 0]
        assert r["trainer/writes"].tolist() == want, g


@pytest.mark.parametrize("grid", GRIDS, ids=_gid)
def test_one_process_checkpoint_restores_on_the_grid(setup, runs, grid):
    """A one-process checkpoint (after a step: nonzero momentum) restored on
    the grid and split: each rank's tensors are its slices of the file's
    (the model rank's rows of a split conv, the whole of the rest), bit for
    bit, momentum too, and ``seen`` the file's."""
    spec = _trainer_spec(setup)
    sd, mom, seen, step = _file_state(setup[0] / "one_process" / "1.pt",
                                      spec)
    split = _split_keys(spec, grid[1])
    for r in ranks_of(runs, grid):
        m, mp = r["layout"][3], r["layout"][4]

        def mine(k, v):
            if k not in split:
                return v
            per = len(v) // mp
            return v[m * per:(m + 1) * per]
        assert int(r["restore/step"]) == step
        assert int(r["restore/local/seen"]) == seen
        for k, v in sd.items():
            assert r[f"restore/local/{k}"].tobytes() == \
                mine(k, v).tobytes(), k
        for k, v in mom.items():
            assert r[f"restore/local/momentum/{k}"].tobytes() == \
                mine(k, v).tobytes(), k


def test_failure_save_when_every_rank_raises(setup, runs):
    """A 2×2 run whose third step raises on every rank: the error goes on
    from every rank, and the failure save (its periodic saves off) wrote
    step 2 — the state after two steps, gathered — the unbroken run's
    step-2 checkpoint bit for bit."""
    wd = setup[0]
    spec = _trainer_spec(setup)
    for r in ranks_of(runs, (2, 2)):
        assert str(r["trainer/fail/error"]) == "step 3 fails on every rank"
    got = _file_state(wd / "grid2x2" / "ckpt_fail" / "2.pt", spec)
    want = _file_state(wd / "grid2x2" / "ckpt_unbroken" / "2.pt", spec)
    assert got[2:] == want[2:] == (8, 2)
    _same_bytes(got[0], want[0])
    _same_bytes(got[1], want[1])


def test_resumed_grid_run_equals_the_unbroken_one(runs):
    """The failed run resumed from its failure save for its second epoch
    ends with the state of the unbroken two-epoch run, bit for bit, on
    every rank."""
    for r in ranks_of(runs, (2, 2)):
        got, want = _final(r, "resumed"), _final(r, "unbroken")
        _same_bytes(got[0], want[0])
        _same_bytes(got[1], want[1])
        assert got[2] == want[2] == 16


def test_run_training_multi_on_the_grid(runs):
    """``run_training_multi`` on 2×2 fed by ``device_synth``: one epoch of
    2 steps, finite losses, the same bits on every rank, its epoch-0 eval a
    finite best, and the ranks' gathered states the same bytes."""
    ranks = ranks_of(runs, (2, 2))
    first = ranks[0]["trainer/multi/losses"]
    assert len(first) == 2 and np.isfinite(first).all()
    assert np.isfinite(float(ranks[0]["trainer/multi/best_acc"]))
    for r in ranks:
        assert r["trainer/multi/losses"].tobytes() == first.tobytes()
        assert float(r["trainer/multi/best_acc"]) == \
            float(ranks[0]["trainer/multi/best_acc"])
        assert int(r["trainer/multi/final/seen"]) == 4
        for k in (k for k in r if k.startswith("trainer/multi/final/")):
            assert r[k].tobytes() == ranks[0][k].tobytes(), k


# ---------------------------------------------------------------------------
# the device banks' rows under the grid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rank", range(4))
def test_bank_rows_match_jax_mesh(runs, rank):
    """Each rank's ``device_bank`` rows on 2×2 (an epoch: 2 batches of 4 at
    the drawn multi-scale widths, 416² here) against JAX's ``Loader(mesh=
    make_mesh(dp=2))`` rows and the one-process port batch's
    (``torch_bank_helpers.check_bank_rows``)."""
    ranks, refs = runs
    check_bank_rows(ranks[(2, 2)][rank], refs["bank_rows"], rank // 2, 2)


@pytest.mark.parametrize("rank", range(4))
def test_synth_rows_match_one_process(runs, rank):
    """Each rank's ``device_synth`` rows on 2×2 are those rows of the
    one-process port batch from the same seed, bit for bit."""
    ranks, refs = runs
    check_synth_rows(ranks[(2, 2)][rank], refs["synth"], rank // 2, 2)


@pytest.mark.parametrize("rank", range(4))
@pytest.mark.parametrize("backend", ["bank", "synth"])
def test_grid_loader_builds_its_bank_when_made(runs, backend, rank):
    """Under the grid a bank loader's constructor builds the bank and runs
    its preflight, a collective over the grid, once, on the main thread
    (the thread of the run's other collectives), not on the prefetch
    thread at the first batch."""
    got = ranks_of(runs, (2, 2))[rank][f"built_at_init/rows/{backend}"]
    assert got.tolist() == [1, 1]


def test_model_peers_hold_the_same_rows(runs):
    """The ranks of one data coordinate make the same rows."""
    ranks = ranks_of(runs, (2, 2))
    for d in range(2):
        a, b = ranks[2 * d], ranks[2 * d + 1]
        keys = [k for k in a if k.startswith("rows/")]
        assert len(keys) > 4
        for k in keys:
            assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("case,want", [
    ("one_card", r"a bank on 4 ranks sharing card needs 400 MB device "
                 r"memory plus 4096 MB activation headroom, but only 1686 MB"),
    ("own_cards", r"^$")])
def test_bank_preflight_counts_the_ranks_on_a_card(runs, case, want):
    """The banks' preflight under the grid charges a card for every rank on
    it: four ranks on one card whose free memory holds one and a half
    banks with their headroom all raise; on cards of their own they
    pass."""
    for r in ranks_of(runs, (2, 2)):
        assert re.search(want, str(r[f"preflight/{case}"])), \
            str(r[f"preflight/{case}"])
