"""A jax-free worker for tests/test_torch_tensor_parallel.py: the port's
data × model grid on gloo ranks on the CPU.

    python torch_tp_worker.py WORKDIR DP MP
        DP·MP spawned gloo ranks make ``make_dp_group(DP, MP)`` and run the
        checks on the nets and inputs under WORKDIR; each writes
        WORKDIR/grid<DP>x<MP>/rank<r>.npz.  The trainers' runs write their
        checkpoints and weights under WORKDIR/grid<DP>x<MP>/ too.

``jax`` and ``singleshotpose_tpu`` are blocked before anything is imported,
here and in every spawned rank (a spawned child runs this module's top level
again as its ``__mp_main__``), so the grid's paths are shown to run without
them.
"""

import dataclasses
import json
import os
import shutil
import sys
import threading

sys.modules["jax"] = None                  # any `import jax` now raises
sys.modules["singleshotpose_tpu"] = None   # and so does the JAX package
_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(1)     # the ranks share the test run's cores

import torch.distributed as dist  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

from singleshotpose_tpu_torch import drivers  # noqa: E402
from singleshotpose_tpu_torch import weights as W  # noqa: E402
from singleshotpose_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from singleshotpose_tpu_torch.data import pipeline  # noqa: E402
from singleshotpose_tpu_torch.data.synth_multi import (  # noqa: E402
    MultiObjectSynthesizer, SynthConfig)
from singleshotpose_tpu_torch.utils import memory  # noqa: E402
from singleshotpose_tpu_torch.models.darknet import (Darknet,  # noqa: E402
                                                     DarknetSpec)
from singleshotpose_tpu_torch.ops import stem  # noqa: E402
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig  # noqa: E402
from singleshotpose_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed)
from singleshotpose_tpu_torch.parallel.sharding import (  # noqa: E402
    DPGroup, free_port, make_dp_group, pad_rows, shard_host_batch)
from singleshotpose_tpu_torch.training import (  # noqa: E402
    capture_train_step, gather_train_state, init_train_state,
    make_train_step, shard_train_state)
from singleshotpose_tpu_torch.zoo import (yolo_pose_multi,  # noqa: E402
                                          yolo_pose_single)

LR, EPOCH, DECAY, MOMENTUM = 0.00025, 100, 0.002, 0.9
STEPS = 2
# (tag, compute dtype, fused stem, multi-object loss)
NETS = (("f32", None, False, False), ("route", None, False, False),
        ("bf16", torch.bfloat16, True, False), ("multi", None, False, True))
MULTI_LOSS = dict(pretrain_num_epochs=15, im_width=640, im_height=480)


def _spec(workdir, tag) -> DarknetSpec:
    with open(os.path.join(workdir, f"{tag}_blocks.json")) as f:
        return DarknetSpec(json.load(f))


def _state(workdir, tag):
    model = Darknet(_spec(workdir, tag))
    model.load_state_dict(torch.load(os.path.join(workdir, f"{tag}.pt"),
                                     weights_only=True))
    return init_train_state(model, weight_decay=DECAY, momentum=MOMENTUM)


def _loss_cfg(spec, multi):
    if not multi:
        return RegionLossConfig()
    return drivers.loss_config_from_spec(spec, multi=True, **MULTI_LOSS)


def _flat_state(state, prefix: str) -> dict:
    """Every tensor of the state — parameters, BN statistics, momentum —
    and ``seen``, keyed under ``prefix``."""
    out = {f"{prefix}/{k}": v.clone()
           for k, v in state.model.state_dict().items()}
    for name, p in state.model.named_parameters():
        out[f"{prefix}/momentum/{name}"] = \
            state.optimizer.state[p]["momentum_buffer"].clone()
    out[f"{prefix}/seen"] = torch.tensor(state.seen)
    return out


def _nbytes(state) -> list:
    """[parameter bytes, momentum bytes] this rank holds."""
    params = list(state.model.parameters())
    bufs = [state.optimizer.state[p].get("momentum_buffer") for p in params]
    return [sum(p.numel() * p.element_size() for p in params),
            sum(b.numel() * b.element_size() for b in bufs if b is not None)]


def _steps(inp, workdir, grid, out) -> None:
    """Per net: the whole state split over the grid, its bytes, STEPS
    steps on the data rank's rows (the state gathered after the first and
    after the last), the rank's own tensors, the fused stem's calls."""
    calls = []
    real = stem.stem_conv_bn_pool_train
    stem.stem_conv_bn_pool_train = \
        lambda *a, **k: calls.append(1) or real(*a, **k)
    try:
        for tag, dtype, fused, multi in NETS:
            state = _state(workdir, tag)
            whole = sum(p.numel() * p.element_size()
                        for p in state.model.parameters())
            shard_train_state(grid, state)
            out[f"{tag}/bytes"] = torch.tensor(_nbytes(state) + [whole])
            step = make_train_step(_loss_cfg(state.model.spec, multi),
                                   compute_dtype=dtype, fused_stem=fused,
                                   group=grid)
            images, target = shard_host_batch(
                grid, torch.from_numpy(inp[f"{tag}_images"]),
                torch.from_numpy(inp[f"{tag}_target"]))
            del calls[:]
            losses = []
            for i in range(STEPS):
                losses.append(step(state, images, target, LR, EPOCH)["loss"])
                if i == 0:
                    out.update(_flat_state(gather_train_state(grid, state),
                                           f"{tag}/step1"))
            out.update(_flat_state(gather_train_state(grid, state),
                                   f"{tag}/last"))
            out.update(_flat_state(state, f"{tag}/local"))
            out[f"{tag}/losses"] = torch.stack(losses)
            out[f"{tag}/stem_calls"] = torch.tensor(len(calls))
    finally:
        stem.stem_conv_bn_pool_train = real


def _full_width_bytes(grid, out) -> None:
    """The zoo nets at full width split over the grid: each rank's
    parameter and momentum bytes against the whole model's."""
    for name, spec in (("single", yolo_pose_single()),
                       ("multi", yolo_pose_multi())):
        state = init_train_state(Darknet(spec), weight_decay=DECAY,
                                 momentum=MOMENTUM)
        whole = sum(p.numel() * p.element_size()
                    for p in state.model.parameters())
        shard_train_state(grid, state)
        out[f"full_width/{name}"] = torch.tensor(_nbytes(state) + [whole])


def _mp1_step(inp, workdir, grid, out) -> None:
    """A grid of mp 1 (``make_dp_group(dp·mp, 1)`` over every rank) against
    the data-parallel group as it was made before the grid
    (``DPGroup(device)``): the f32 step's state and loss, bit for bit,
    with no model collective issued."""
    world = dist.get_world_size()
    results, model_calls = [], []
    real = dist.all_gather, dist.new_group
    dist.all_gather = lambda *a, **k: model_calls.append(1) or real[0](*a, **k)
    dist.new_group = lambda *a, **k: model_calls.append(1) or real[1](*a, **k)
    try:
        for group in (make_dp_group(world, 1, device="cpu"),
                      DPGroup("cpu")):
            state = _state(workdir, "f32")
            shard_train_state(group, state)
            step = make_train_step(RegionLossConfig(), compute_dtype=None,
                                   group=group)
            images, target = shard_host_batch(
                group, torch.from_numpy(inp["f32_images"]),
                torch.from_numpy(inp["f32_target"]))
            stats = step(state, images, target, LR, EPOCH)
            results.append(_flat_state(state, "s") | {"loss": stats["loss"]})
    finally:
        dist.all_gather, dist.new_group = real
    out["mp1/equal"] = torch.tensor(all(
        torch.equal(results[0][k].reshape(-1).view(torch.uint8),
                    results[1][k].reshape(-1).view(torch.uint8))
        for k in results[0]))
    out["mp1/model_collectives"] = torch.tensor(len(model_calls))


def _refusals(workdir, grid, dp, mp_, out) -> None:
    """Each refusal's message ("" when nothing was raised)."""
    state = _state(workdir, "f32")
    shard_train_state(grid, state)
    step = make_train_step(RegionLossConfig(), compute_dtype=None, group=grid)
    corpus = os.path.join(workdir, "corpus")
    rc = drivers.TrainRunConfig(group=grid, device="cpu", num_workers=0,
                                bg_dir="/nonexistent")
    cases = {
        "precompile_buckets": lambda: drivers.run_training(
            os.path.join(corpus, "synth.data"),
            os.path.join(corpus, "tiny.cfg"), None, 100,
            dataclasses.replace(rc, precompile_buckets=True)),
        "capture": lambda: capture_train_step(step, state, [64], 2, 1050),
        "grid_size": lambda: make_dp_group(dp * mp_ + 1, 1, device="cpu"),
        "grid_shape": lambda: make_dp_group(dp, mp_ + 1, device="cpu"),
        "shard_twice": lambda: shard_train_state(grid, state),
        "restore_split": lambda: Checkpointer(
            os.path.join(workdir, "one_process")).restore(state),
        "no_grid": lambda: state.model(torch.zeros(1, 64, 64, 3)),
        "whole_on_grid": lambda: _state(workdir, "f32").model(
            torch.zeros(1, 64, 64, 3), group=grid),
    }
    for name, fn in cases.items():
        try:
            fn()
            msg = ""
        except (ValueError, RuntimeError) as e:
            msg = f"{type(e).__name__}: {e}"
        out[f"refusal/{name}"] = np.array(msg)


def _eval_model(spec, seed: int) -> Darknet:
    """Random weights and BN statistics: each frame then has its own box
    (a fresh net's head gives every frame the same one)."""
    model = Darknet(spec)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for t in model.state_dict().values():
            t.copy_(torch.randn(t.shape, generator=gen) * 0.5)
        for l in spec.conv_specs():
            if l.batch_normalize:
                getattr(model, l.name).running_var.abs_().add_(0.5)
    return model


def _rows_alone(dp: int):
    """``drivers.make_serving_fn`` whose serve takes each batch as the grid's
    data ranks take it: zero-padded to a multiple of ``dp`` and served a
    rank's rows a call, the pad rows dropped.  One process then runs every
    conv on the batches the grid's ranks run it on (cuDNN and oneDNN pick
    their algorithms by batch)."""
    real = drivers.make_serving_fn

    def make(*a, **k):
        serve = real(*a, **k)
        return lambda images: torch.cat(
            [serve(c) for c in pad_rows(torch.as_tensor(images),
                                        dp).chunk(dp)])[:len(images)]

    return make


def _evals(workdir, grid, out) -> None:
    """``run_validation`` and ``run_validation_multi`` over the grid and in
    this process alone, serving the same rows a call (:func:`_rows_alone`):
    f32 from a whole model (split here) and from a split one, the bank
    transfer, int8 (``quantize=True``: whole int8 params) and bf16 (the
    serving stem on conv_1's gathered weights)."""
    corpus = os.path.join(workdir, "corpus")
    data = os.path.join(corpus, "synth.data")
    spec = DarknetSpec.from_cfg(os.path.join(corpus, "tiny.cfg"))
    mspec = DarknetSpec.from_cfg(os.path.join(corpus, "tiny_multi.cfg"))
    model = _eval_model(spec, 7)
    split = _eval_model(spec, 7)
    split_state = init_train_state(split, weight_decay=DECAY,
                                   momentum=MOMENTUM)
    shard_train_state(grid, split_state)
    kw = dict(batch_size=3, num_workers=0, device="cpu", verbose=False)
    runs = {
        "f32": dict(model=model, compute_dtype=None),
        "f32_split": dict(model=split, compute_dtype=None),
        "bank": dict(model=split, compute_dtype=None, transfer="bank"),
        "int8": dict(model=split, compute_dtype=None, quantize=True),
        "bf16": dict(model=split, compute_dtype=torch.bfloat16),
    }
    real = drivers.make_serving_fn
    mmodel = _eval_model(mspec, 8)
    for tag, g in (("grid", grid), ("alone", None)):
        drivers.make_serving_fn = real if g is not None \
            else _rows_alone(grid.world)
        try:
            for name, args in runs.items():
                if g is None:
                    args = dict(args, model=model)
                s = drivers.run_validation(data, spec, group=g, **args, **kw)
                for k, v in s.items():
                    out[f"eval/{name}/{tag}/{k}"] = np.float64(v)
            s = drivers.run_validation_multi(data, mspec, model=mmodel,
                                             compute_dtype=None, group=g,
                                             **kw)
        finally:
            drivers.make_serving_fn = real
        out[f"eval/multi/{tag}/acc"] = np.array(list(s["acc_table"].values()))
        out[f"eval/multi/{tag}/mean_err_2d"] = np.float64(s["mean_err_2d"])
        out[f"eval/multi/{tag}/n_samples"] = np.int64(s["n_samples"])


# ---------------------------------------------------------------------------
# the bank backends' rows and the trainers on the grid
# ---------------------------------------------------------------------------


def _bank_rows(workdir, grid, out, prefix: str = "rows") -> None:
    """An epoch of ``Loader(group=grid)`` on the device banks: this rank's
    rows of each global batch (``device_bank`` over the corpus with its
    backgrounds, the multi-scale widths drawn; ``device_synth`` over the
    OCCLUSION tree at a fixed 64²)."""
    corpus = os.path.join(workdir, "corpus")
    bgs = sorted(os.path.join(corpus, "bg", f)
                 for f in os.listdir(os.path.join(corpus, "bg")))
    ds = pipeline.PoseDataset(os.path.join(corpus, "train.txt"), train=True,
                              bg_file_names=bgs)
    loader = _made_with_its_bank(
        out, f"built_at_init/{prefix}/bank", lambda: pipeline.Loader(
            ds, 4, seed=3, num_workers=0, backend="device_bank",
            device="cpu", group=grid))
    for i, (images, labels) in enumerate(loader):
        out[f"{prefix}/bank/{i}/images"] = images
        out[f"{prefix}/bank/{i}/labels"] = labels
    out[f"{prefix}/bank/seen"] = torch.tensor(loader.seen)
    occ = os.path.join(workdir, "occ")
    lm = os.path.join(occ, "LINEMOD")
    ds = pipeline.PoseDataset(
        os.path.join(occ, "train_occlusion.txt"), train=True,
        bg_file_names=[os.path.join(occ, "VOC", "JPEGImages", "bg0.jpg")],
        aug=pipeline.AugmentConfig.multi(),
        synthesizer=MultiObjectSynthesizer(SynthConfig(linemod_root=lm)))
    loader = _made_with_its_bank(
        out, f"built_at_init/{prefix}/synth", lambda: pipeline.Loader(
            ds, 4, seed=5, num_workers=0, fixed_shape=(64, 64),
            backend="device_synth", device="cpu", synth_attempts=4,
            group=grid))
    for i, (images, labels) in enumerate(loader):
        out[f"{prefix}/synth/{i}/images"] = images
        out[f"{prefix}/synth/{i}/labels"] = labels


def _made_with_its_bank(out, key: str, make):
    """``make()`` (a bank loader under a group), recording under ``key``
    how many bank preflights its construction ran and how many of those
    ran on the main thread: the preflight is a collective, so the
    constructor, not the first batch, builds the bank."""
    real, calls = memory.check_hbm_budget, []

    def spy(*a, **k):
        calls.append(threading.current_thread() is threading.main_thread())
        return real(*a, **k)

    memory.check_hbm_budget = spy
    try:
        loader = make()
    finally:
        memory.check_hbm_budget = real
    out[key] = np.array([len(calls), sum(calls)])
    return loader


def _preflight(grid, out, prefix: str = "preflight") -> None:
    """The device banks' preflight under the grid, with the free memory and
    the card each rank reads stubbed: every rank on one card, where one
    rank's bank and headroom fit but not two ranks', then each rank on a
    card of its own.  Each case's message ("" when nothing was raised)."""
    need, room = 100 << 20, memory.DEFAULT_HEADROOM
    real = memory.hbm_free_bytes, memory.card_key
    memory.hbm_free_bytes = lambda device=None: 3 * (need + room) // 2
    try:
        for case, key in (("one_card", lambda d: "card"),
                          ("own_cards", lambda d: f"card{dist.get_rank()}")):
            memory.card_key = key
            try:
                memory.check_hbm_budget(need, "a bank", device="cpu",
                                        group=grid)
                msg = ""
            except RuntimeError as e:
                msg = str(e)
            out[f"{prefix}/{case}"] = np.array(msg)
    finally:
        memory.hbm_free_bytes, memory.card_key = real


class _EpochLoader(pipeline.Loader):
    """The port's loader with its stream reseeded from (seed, epoch) at each
    pass, the epoch read from ``seen``: an epoch's batches then depend on
    the epoch alone, so a resumed run sees the batches the unbroken run saw
    (the loader itself, as JAX's, restarts its stream on resume)."""

    def __init__(self, *a, seed: int = 0, **k):
        super().__init__(*a, seed=seed, **k)
        self._seed = seed

    def __iter__(self):
        epoch = self.seen // (self.nbatches * self.batch_size)
        self.rng = np.random.RandomState([self._seed, epoch])
        return super().__iter__()


def _failing_steps(at: int):
    """``drivers.make_train_step`` whose steps raise at the ``at``-th call,
    on every rank, before the step runs."""
    real = drivers.make_train_step

    def make(*a, **k):
        step, calls = real(*a, **k), [0]

        def failing(*args):
            calls[0] += 1
            if calls[0] == at:
                raise RuntimeError(f"step {at} fails on every rank")
            return step(*args)
        return failing
    return make


def _train_run(workdir, grid, gid, run, *, backend, epochs=1,
               ckpt_every=1, init=True):
    """``run_training`` of the trainer cfg on the grid, resumed from the
    one-process checkpoint of JAX's initial state (``init``: copied into
    the run's checkpoint directory by the writer first), evals off."""
    corpus = os.path.join(workdir, "corpus")
    ckpt = os.path.join(workdir, f"grid{gid}", f"ckpt_{run}")
    if init and grid.leader:
        os.makedirs(ckpt, exist_ok=True)
        shutil.copy(os.path.join(workdir, "trainer_init", "0.pt"), ckpt)
    grid.barrier()
    rc = drivers.TrainRunConfig(
        group=grid, device="cpu", num_workers=0, log_every=1,
        bg_dir=os.path.join(corpus, "bg"), compute_dtype=None,
        eval_every=100, eval_after=100, max_epochs_override=epochs,
        checkpoint_dir=ckpt, checkpoint_every_epochs=ckpt_every,
        resume=True, loader_backend=backend)
    return drivers.run_training(
        os.path.join(corpus, f"{gid}_{run}.data"),
        os.path.join(corpus, "trainer.cfg"), None, 100, rc)


def _trainers(workdir, grid, dp, mp_, out) -> None:
    """The trainers on the grid: ``run_training`` from JAX's initial state
    for one epoch (1×4: the python loader; 2×2: ``device_bank``), each run's
    losses and gathered final state; on 2×2 an unbroken two-epoch run, the
    same run failing at its third step on every rank, and that run resumed
    (batches a function of the epoch: ``_EpochLoader``), and
    ``run_training_multi`` on ``device_synth`` with its epoch-0 eval.  The
    checkpoint and weights writes are counted on every rank."""
    gid = f"{dp}x{mp_}"
    writes = {"checkpoint": 0, "weights": 0}
    real_write, real_weights = Checkpointer._write, W.save_weights

    def count(kind, fn):
        def wrapped(*a, **k):
            writes[kind] += 1
            return fn(*a, **k)
        return wrapped

    Checkpointer._write = count("checkpoint", real_write)
    W.save_weights = count("weights", real_weights)
    real_loader, real_make = drivers.Loader, drivers.make_train_step
    try:
        runs = {(1, 4): ("python", "python"), (2, 2): ("bank", "device_bank")}
        if (dp, mp_) in runs:
            run, backend = runs[(dp, mp_)]
            r = _train_run(workdir, grid, gid, run, backend=backend)
            out[f"trainer/{run}/losses"] = torch.tensor(
                r["history"]["training_losses"], dtype=torch.float64)
            out.update(_flat_state(gather_train_state(grid, r["state"]),
                                   f"trainer/{run}/final"))
        if (dp, mp_) == (2, 2):
            drivers.Loader = _EpochLoader
            r = _train_run(workdir, grid, gid, "unbroken",
                           backend="device_bank", epochs=2)
            out.update(_flat_state(gather_train_state(grid, r["state"]),
                                   "trainer/unbroken/final"))
            drivers.make_train_step = _failing_steps(3)
            try:
                _train_run(workdir, grid, gid, "fail", backend="device_bank",
                           epochs=2, ckpt_every=0)
                out["trainer/fail/error"] = np.array("")
            except RuntimeError as e:
                out["trainer/fail/error"] = np.array(str(e))
            drivers.make_train_step = real_make
            r = _train_run(workdir, grid, gid, "fail", backend="device_bank",
                           epochs=2, ckpt_every=0, init=False)
            out.update(_flat_state(gather_train_state(grid, r["state"]),
                                   "trainer/resumed/final"))
            drivers.Loader = real_loader
            _train_multi(workdir, grid, gid, out)
    finally:
        Checkpointer._write, W.save_weights = real_write, real_weights
        drivers.Loader, drivers.make_train_step = real_loader, real_make
    out["trainer/writes"] = torch.tensor([writes["checkpoint"],
                                          writes["weights"]])


def _train_multi(workdir, grid, gid, out) -> None:
    """``run_training_multi`` on the grid for one epoch of the OCCLUSION
    tree (4 frames, global batch 2: one scene a data rank) fed by
    ``device_synth``, with its epoch-0 eval over ape."""
    occ = os.path.join(workdir, "occ")
    rc = drivers.TrainRunConfig(
        group=grid, device="cpu", num_workers=0, log_every=1,
        bg_dir=os.path.join(occ, "VOC", "JPEGImages"), compute_dtype=None,
        eval_every=20, eval_after=-1, eval_batch_size=2,
        max_epochs_override=1, loader_backend="device_synth",
        synth_attempts=4,
        checkpoint_dir=os.path.join(workdir, f"grid{gid}", "ckpt_multi"))
    r = drivers.run_training_multi(
        os.path.join(occ, f"occlusion_{gid}.data"),
        os.path.join(occ, "tiny_multi.cfg"), None, 0,
        [os.path.join(occ, "ape_occlusion.data")], None, rc)
    out["trainer/multi/losses"] = torch.tensor(
        r["history"]["training_losses"], dtype=torch.float64)
    out["trainer/multi/best_acc"] = torch.tensor(r["best_acc"],
                                                 dtype=torch.float64)
    out.update(_flat_state(gather_train_state(grid, r["state"]),
                           "trainer/multi/final"))


def _restore_on_grid(workdir, grid, out) -> None:
    """A one-process checkpoint (with momentum) restored whole on every rank
    of the grid, then split: this rank's tensors and ``seen``."""
    spec = DarknetSpec.from_cfg(os.path.join(workdir, "corpus",
                                             "trainer.cfg"))
    state = init_train_state(Darknet(spec), weight_decay=DECAY,
                             momentum=MOMENTUM)
    ckpt = Checkpointer(os.path.join(workdir, "one_process"), group=grid)
    out["restore/step"] = torch.tensor(ckpt.restore(state))
    shard_train_state(grid, state)
    out.update(_flat_state(state, "restore/local"))


def _rank(rank: int, port: int, workdir: str, dp: int, mp_: int) -> None:
    torch.set_num_threads(1)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=dp * mp_, rank=rank)
    grid = make_dp_group(dp, mp_, device="cpu")
    out = {"layout": torch.tensor([dist.get_rank(), grid.rank, grid.world,
                                   grid.model_rank, grid.mp])}
    inp = np.load(os.path.join(workdir, "inputs.npz"))
    _steps(inp, workdir, grid, out)
    _full_width_bytes(grid, out)
    _evals(workdir, grid, out)
    _refusals(workdir, grid, dp, mp_, out)
    _mp1_step(inp, workdir, grid, out)
    _restore_on_grid(workdir, grid, out)
    _trainers(workdir, grid, dp, mp_, out)
    if (dp, mp_) == (2, 2):
        _bank_rows(workdir, grid, out)
        _preflight(grid, out)
    dest = os.path.join(workdir, f"grid{dp}x{mp_}")
    os.makedirs(dest, exist_ok=True)
    np.savez(os.path.join(dest, f"rank{rank}.npz"),
             **{k: v.detach().numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})
    dist.destroy_process_group()


def main(argv) -> int:
    workdir, dp, mp_ = argv[0], int(argv[1]), int(argv[2])
    for attempt in range(3):
        try:
            mp.spawn(_rank, args=(free_port(), workdir, dp, mp_),
                     nprocs=dp * mp_, join=True)
            break
        except mp.ProcessRaisedException as e:
            if attempt == 2 or "Address already in use" not in str(e):
                raise
    print("WORKER_OK")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
