#!/usr/bin/env python3
"""The train step and an eval batch on a dp=2 × mp=2 grid of four cards,
and the trainer on it.

    python3 scripts/tp_check.py --out RESULT.json          # 4 cards, NCCL
    python3 scripts/tp_check.py --dtype f32 --out F32.json # f32, TF32 off
    python3 scripts/tp_check.py --trainer --out TRAIN.json # run_training
    python3 scripts/tp_check.py --captured --out CAP.json  # CUDA graphs
    python3 scripts/tp_check.py --captured --trainer       # and trainers
    python3 scripts/tp_check.py --device cpu --tiny --steps 2 \\
        --size 64 --eval_size 64 [--trainer] [--captured]  # a CPU rehearsal

Spawns four ranks — rank r on cuda:r over NCCL (gloo with ``--device
cpu``) — that make ``make_dp_group(2, 2)``: rank r at data coordinate
r // 2 and model coordinate r % 2, each holding half of every conv's
output channels.  From ``chip_smoke.py``'s seeded random
``yolo_pose_single`` (``--tiny``: a stem, one conv and the head) each
rank runs ``--steps`` fused bf16 train steps on its data coordinate's 4
rows of the seeded batch-8 ``--size``² batches, each step timed with CUDA
events; the state is gathered after the first and after the last step,
and each rank hashes its own.  Then the seeded model's folded forward on
the grid serves a batch of 8 at ``--eval_size``² (4 rows a data rank, its
decoded grid gathered over the data group).  The parent runs the same
steps and the same batch on one card with no group and holds: each
rank's parameter and momentum bytes half the model's; data peers' states
the same bytes; the first step's loss rel 1e-3, conv_1's and conv_2's
weights atol 6e-4 and conv_1's running mean atol 1e-5 (the JAX package's
bf16 bounds, one step from one state); every cell of the eval batch
within 0.05.  The later steps are printed, not held: bf16 states drift
apart step by step.  ``--dtype f32`` runs the steps in f32 (the unfused
stem; TF32 is off throughout) and holds each step alone: at every step
each rank runs one grid step and one one-card step from the same
one-card state (rank 0's, broadcast), and holds the grid's loss to rel
1e-5 of the one card's and every tensor of the gathered state —
parameters, BN statistics, momentum buffers — to 1e-5 of that tensor's
largest value.  Beside each step's gaps it prints the one card's own,
from the same state with cuDNN off (its convs summed in another order)
and with conv_1's first weight one ulp up, and the step with f64 convs
against both: the yardsticks that tell the grid's error from the step's
own sensitivity to rounding.  The trajectories' gaps (the grid and one
card each carrying on from its own state) are printed beside the one-ulp
run of ``--sensitivity``, not held: any two orders of summation drift
apart as fast.

``--sensitivity`` (one card, no grid): the ``--dtype`` steps twice, from
the seeded state and from it with conv_1's first weight one ulp up; each
step's loss gap and the last state's largest gap (to each tensor's max):
how fast this training amplifies a rounding difference by itself, the
yardstick for the grid's gap to one card.

``--captured``: each rank captures its split step per width with
``drivers._precompile_buckets`` (chip_smoke.py's ``_dp_captured``: 3
widths of ``SINGLE_SCHEDULE``, as ``run_training(precompile_buckets=
True)`` captures them: the model group's channel gathers and
input-gradient sums, the data group's all-reduces and the broadcast of
the replicated gradients recorded in each graph, counted) and runs the
same 10 fused bf16 steps across the widths and the pretrain gate twice
from one seeded state, replayed and eager.  Holds, on every rank: K2–K6
recorded once a graph, the collectives of an eager step recorded in each
graph, the replayed losses and split state the eager ones bit for bit,
and the gathered states the same SHA-256 on every rank, captured and
eager.  Prints each width's capture seconds and the GiB reserved, and
times both at 416² with CUDA events in turns (captured, eager, eager,
captured; median, min and max of 10 steps each).  With ``--trainer``: ``run_training(precompile_buckets=True)``
as below against the same runs eager — the losses, the checkpoints, the
gathered state and ``model.weights`` bit for bit —, then a third run
resumed for epoch 3 whose loader fails after one step on every rank (the
failure save over the rescue group: step 5 in both modes, the same bytes
restored), and ``run_training_multi`` for one batch-32 step of
``yolo_pose_multi`` fed by ``device_synth``, eager and captured, the same
loss and gathered state.

``--trainer``: ``run_training`` on the grid as a user runs it
(``TrainRunConfig(group=make_dp_group(2, 2))``) fed by ``device_bank``
over ``chip_smoke.py``'s phase 14 renders (16 frames: 2 global batch-8
steps an epoch, 4 rows a data rank): one epoch with its checkpoint, then
a second ``run_training`` resumed from it for a second epoch with the
in-training eval (its best saves ``model.weights``).  Holds: the ranks'
losses the same bits, ``seen`` the global samples, checkpoints at steps
2 and 4, ``model.weights`` = the gathered state's weights bit for bit, and
the last checkpoint restored in one process = the gathered state (its
SHA-256).  Prints one JSON object on the last line (and writes it to
``--out``).  Imports no jax.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import shutil
import statistics
import sys
import tempfile
import time
from unittest import mock

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from singleshotpose_tpu_torch import drivers  # noqa: E402
from singleshotpose_tpu_torch import weights as W  # noqa: E402
from singleshotpose_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from singleshotpose_tpu_torch.drivers import (  # noqa: E402
    TrainRunConfig, run_training, run_training_multi)
from singleshotpose_tpu_torch.models.darknet import (  # noqa: E402
    Darknet, DarknetSpec, fold_batchnorm, shard_folded)
from singleshotpose_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed)
from singleshotpose_tpu_torch.parallel.sharding import (  # noqa: E402
    DPGroup, all_gather_rows, broadcast_, free_port, make_dp_group,
    shard_host_batch)
from singleshotpose_tpu_torch.serving import make_serving_fn  # noqa: E402
from singleshotpose_tpu_torch.training import (  # noqa: E402
    gather_train_state, init_train_state, make_train_step,
    shard_train_state)
from singleshotpose_tpu_torch.zoo import yolo_pose_single  # noqa: E402

DP, MP = 2, 2
HELD = ("conv_1.weight", "conv_2.weight", "conv_1.running_mean")

TINY = [
    {"type": "net", "batch": "8", "channels": "3", "height": "64",
     "width": "64", "decay": "0.0005", "momentum": "0.9",
     "learning_rate": "0.001", "steps": "-1", "scales": "1"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "32",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "64",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "0", "filters": "20",
     "size": "1", "stride": "1", "pad": "0", "activation": "linear"},
    {"type": "region", "anchors": "", "classes": "1", "coords": "18",
     "num": "1"},
]


def _spec(args) -> DarknetSpec:
    return DarknetSpec(TINY) if args.tiny else yolo_pose_single()


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _whole(state) -> dict:
    return {k: v.detach().cpu().clone()
            for k, v in state.model.state_dict().items()}


def _steps(spec, dev, args, group=None, nudge=False):
    """``args.steps`` steps (``--dtype``: fused bf16, or f32) from the
    seeded state (``nudge``: with conv_1's first weight one ulp up; on a
    grid:
    split, on the data coordinate's rows).  Returns (losses, per-step ms
    — CUDA events on a card —, the whole state after the first and after
    the last step, the state)."""
    net = spec.net
    state = init_train_state(C._dp_model(spec, dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    if nudge:
        with torch.no_grad():
            w = state.model.conv_1.weight.view(-1)
            w[0] = torch.nextafter(w[0], w[0] + 1)
    if group is not None:
        shard_train_state(group, state)
    cfg = C.loss_config_from_spec(spec, pretrain_num_epochs=15,
                                  im_width=C.IM_W, im_height=C.IM_H)
    bf16 = args.dtype == "bf16"
    step = make_train_step(cfg, compute_dtype=torch.bfloat16 if bf16
                           else None, fused_stem=bf16, group=group)
    losses, ms, first = [], [], None
    for i, (frames, labels) in enumerate(C._train_batches(
            dev, args.steps, C.DP_SEED + 1, size=args.size)):
        if group is not None:
            frames, labels = shard_host_batch(group, frames, labels)
        if dev.type == "cuda":
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
        else:
            t = time.perf_counter()
        losses.append(float(step(state, frames, labels, C._lr(spec, i),
                                 C.TRAIN_EPOCH)["loss"]))
        if dev.type == "cuda":
            t1.record()
            _sync(dev)
            ms.append(t0.elapsed_time(t1))
        else:
            ms.append((time.perf_counter() - t) * 1e3)
        if i == 0:
            first = _whole(state if group is None
                           else gather_train_state(group, state))
    last = _whole(state if group is None else gather_train_state(group, state))
    return losses, ms, first, last, state


def _eval(spec, dev, args, group=None) -> dict:
    """The seeded model's folded forward on the eval batch, decoded: every
    cell's corners and confidence (on a grid: the data coordinate's rows
    served, gathered over the data group)."""
    folded = fold_batchnorm(C._dp_model(spec, dev))
    frames = C._train_batches(dev, 1, C.DP_SEED + 5,
                              size=args.eval_size)[0][0]
    if group is not None:
        folded = shard_folded(spec, folded, group)
        frames = shard_host_batch(group, frames, frames)[0]
    decoded = make_serving_fn(spec, folded, pick=("grid",),
                              group=group)(frames)
    out = {"corners": decoded.corners, "det_conf": decoded.det_conf}
    if group is not None:
        out = {k: all_gather_rows(v, group).flatten(0, 1)
               for k, v in out.items()}
    _sync(dev)
    return {k: v.cpu() for k, v in out.items()}


def _copy_state(state, spec, dev):
    """A new whole train state with ``state``'s values: parameters, BN
    statistics, momentum buffers and ``seen``."""
    net = spec.net
    copy = init_train_state(Darknet(spec, device=dev),
                            weight_decay=net.decay * net.batch,
                            momentum=net.momentum)
    copy.model.load_state_dict(state.model.state_dict())
    for p, q in zip(state.model.parameters(), copy.model.parameters()):
        copy.optimizer.state[q]["momentum_buffer"] = \
            state.optimizer.state[p]["momentum_buffer"].clone()
    copy.seen = state.seen
    return copy


def _tensors(state) -> dict:
    """A whole state's parameters, BN statistics and momentum buffers by
    name, on its device."""
    out = dict(state.model.state_dict())
    out.update({f"momentum {n}": state.optimizer.state[p]["momentum_buffer"]
                for n, p in state.model.named_parameters()})
    return out


def _per_step(spec, dev, args, grid) -> dict:
    """``--dtype f32``'s hold: at each of ``args.steps`` f32 steps, rank
    0's one-card state on every rank (broadcast over all of them), split
    onto the grid and stepped there on the data rank's rows, and stepped
    on this card alone on the whole batch; the loss gap and every
    tensor's largest gap over its largest value, the grid's gathered
    state against the one card's.  The one card's state carries on."""
    net = spec.net
    ref = init_train_state(C._dp_model(spec, dev),
                           weight_decay=net.decay * net.batch,
                           momentum=net.momentum)
    params = list(ref.model.parameters())
    for p in params:       # what the first step would make
        ref.optimizer.state[p]["momentum_buffer"] = torch.zeros_like(p)
    live = [*(p.data for p in params), *ref.model.buffers(),
            *(ref.optimizer.state[p]["momentum_buffer"] for p in params)]
    everyone = DPGroup(dev)
    cfg = C.loss_config_from_spec(spec, pretrain_num_epochs=15,
                                  im_width=C.IM_W, im_height=C.IM_H)
    one = make_train_step(cfg, compute_dtype=None)
    split = make_train_step(cfg, compute_dtype=None, group=grid)
    wide = make_train_step(cfg, compute_dtype=torch.float64)
    out = {"loss_grid": [], "loss_one": [], "loss_rel": [], "worst": [],
           "parts": [], "f64": [], "yardsticks": []}
    for i, (frames, labels) in enumerate(C._train_batches(
            dev, args.steps, C.DP_SEED + 1, size=args.size)):
        broadcast_(live, everyone)
        state = shard_train_state(grid, _copy_state(ref, spec, dev))
        start = _copy_state(ref, spec, dev) if grid.leader else None
        lr = C._lr(spec, i)
        lg = float(split(state, *shard_host_batch(grid, frames, labels), lr,
                         C.TRAIN_EPOCH)["loss"])
        l1 = float(one(ref, frames, labels, lr, C.TRAIN_EPOCH)["loss"])
        got, want = _tensors(gather_train_state(grid, state)), _tensors(ref)
        del state
        gaps = _gaps(got, want)
        worst = max(gaps, key=gaps.get)
        out["loss_grid"].append(lg)
        out["loss_one"].append(l1)
        out["loss_rel"].append(abs(lg - l1) / abs(l1))
        out["worst"].append((worst, gaps[worst]))
        out["parts"].append(_parts(got, want, gaps))
        if start is None:
            continue
        # what the one card's step gives from the same state when only the
        # rounding moves: conv_1's first weight one ulp up, and every conv
        # summed in another order (cuDNN off: ATen's own convs)
        marks = {}
        for name in ("one ulp", "cudnn off"):
            other = _copy_state(start, spec, dev)
            if name == "one ulp":
                with torch.no_grad():
                    w = other.model.conv_1.weight.view(-1)
                    w[0] = torch.nextafter(w[0], w[0] + 1)
            with torch.backends.cudnn.flags(enabled=name != "cudnn off"):
                lo = float(one(other, frames, labels, lr,
                               C.TRAIN_EPOCH)["loss"])
            theirs = _tensors(other)
            marks[name] = {"loss_rel": abs(lo - l1) / abs(l1),
                           **_parts(theirs, want, _gaps(theirs, want))}
            del other, theirs
        out["yardsticks"].append(marks)
        # the same step with the convs in f64 from the same state (BN's
        # statistics stay f32, as batch_norm_train takes them, and the
        # loss's head f32, as region_loss takes it)
        start.model.double()
        for buf in start.optimizer.state.values():
            buf["momentum_buffer"] = buf["momentum_buffer"].double()
        wide(start, frames, labels, lr, C.TRAIN_EPOCH)
        exact = _tensors(start)
        to_grid, to_one = _gaps(got, exact), _gaps(want, exact)
        out["f64"].append({"grid": max(to_grid.items(), key=lambda kv: kv[1]),
                           "one_card": max(to_one.items(),
                                           key=lambda kv: kv[1]),
                           "at_worst": [to_grid[worst], to_one[worst]]})
        del start, exact, got
    return out


def _gaps(got: dict, want: dict) -> dict:
    """Each float tensor's largest gap over its largest value in ``want``
    (the gap itself where that is 0)."""
    return {k: _gap(got[k], w) / (float(w.abs().max()) or 1.0)
            for k, w in want.items() if w.is_floating_point()}


def _parts(got: dict, want: dict, gaps: dict) -> dict:
    """The worst gap among the state dict's tensors (parameters and BN
    statistics) and among the momentum buffers, each with the share of
    that tensor's elements more than 1e-5 of its max off."""
    out = {}
    for part, keys in (("state", [k for k in gaps if "momentum" not in k]),
                       ("momentum", [k for k in gaps if "momentum" in k])):
        k = max(keys, key=gaps.get)
        w = want[k]
        off = (got[k].float() - w.float()).abs() > \
            1e-5 * float(w.abs().max())
        out[part] = (k, gaps[k], float(off.float().mean()))
    return out


def _rank(rank: int, port: int, root: str, args) -> None:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if args.device == "cuda" \
        else torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(1)
    initialize_distributed(backend="nccl" if dev.type == "cuda" else "gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=DP * MP, rank=rank, device=dev,
                           timeout=datetime.timedelta(seconds=300))
    grid = make_dp_group(DP, MP, device=dev)
    spec = _spec(args)
    if args.trainer or args.captured:
        if not args.trainer:
            # chip_smoke.py's captured step against its eager steps, on
            # this rank's rows of the grid
            out = C._to_cpu(C._dp_captured(spec, dev, grid, timed=True,
                                           ops=C.GRID_COLLECTIVES))
        elif not args.captured:
            out = {"eager": _trainer(spec, dev, grid, root, rank)}
        else:
            out = {mode: _trainer(spec, dev, grid, root, rank, mode,
                                  fail=True)
                   for mode in ("eager", "captured")}
            tree = C._tp_synth_tree(f"{root}/synth{rank}")
            out["multi"] = {mode: _multi(dev, grid, root, tree, mode)
                            for mode in ("eager", "captured")}
        dist.destroy_process_group()
        torch.save(out, f"{root}/rank{rank}.pt")
        return
    losses, ms, first, last, state = _steps(spec, dev, args, grid)
    out = {"layout": [dist.get_rank(), grid.rank, grid.world,
                      grid.model_rank, grid.mp],
           "backend": grid.backend, "losses": losses, "ms": ms,
           "first": first, "last": last, "bytes": C._state_bytes(state),
           "sha": C._state_sha(state), "seen": state.seen}
    del state
    out["eval"] = _eval(spec, dev, args, grid)
    if args.dtype == "f32":
        out["per_step"] = _per_step(spec, dev, args, grid)
    dist.destroy_process_group()
    torch.save(out, f"{root}/rank{rank}.pt")


def _failing_prefetch(real):
    """``drivers.prefetch`` whose batches stop with an error after the
    first, on every rank alike."""
    def prefetch(loader):
        batches = real(loader)
        yield next(batches)
        batches.close()
        raise RuntimeError("the loader failed after one batch")
    return prefetch


def _trainer(spec, dev, grid, root: str, rank: int, mode: str = "eager",
             fail: bool = False) -> dict:
    """``run_training`` on the grid fed by ``device_bank`` (``mode``
    ``captured``: with ``precompile_buckets``): one epoch with its
    checkpoint, then resumed for a second with the in-training eval; the
    losses, ``seen``, the checkpoints' steps, the gathered state's SHA-256
    and (the writer) ``model.weights`` against it.  ``fail``: then resumed
    for a third epoch whose loader fails after one step (the failure
    save's checkpoint)."""
    base = f"{root}/{mode}"
    datacfg, _, bgs, frames = C._tp_corpus(f"{base}/corpus{rank}")
    out = {"layout": [dist.get_rank(), grid.rank, grid.world,
                      grid.model_rank, grid.mp], "backend": grid.backend,
           "losses": [], "seconds": []}

    def run(epochs: int):
        rc = TrainRunConfig(group=grid, loader_backend="device_bank",
                            max_epochs_override=epochs, num_workers=0,
                            log_every=2, bg_dir=os.path.dirname(bgs[0]),
                            eval_every=1, eval_after=0,
                            eval_batch_size=C.TRAIN_BATCH,
                            checkpoint_dir=f"{base}/ckpt",
                            checkpoint_every_epochs=1, resume=epochs > 1,
                            precompile_buckets=mode == "captured",
                            device=str(dev))
        with C._reading_renders(frames):
            return run_training(datacfg, spec, None, 15, rc)

    for epochs in (1, 2):
        t = time.perf_counter()
        result = run(epochs)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t)
        out["losses"] += result["history"]["training_losses"]
    out["testing"] = result["history"]["testing_accuracies"]
    out["seen"] = result["state"].seen
    out["steps"] = Checkpointer(f"{base}/ckpt").steps()
    whole = gather_train_state(grid, result["state"])
    out["sha"] = C._state_sha(whole)
    if grid.leader:
        _, sd = W.load_weights(spec, f"{base}/corpus0/backup/model.weights")
        got = whole.model.state_dict()
        out["weights_equal"] = all(C._same_bits(v, got[k].cpu())
                                   for k, v in sd.items())
    del result, whole
    if dev.type == "cuda":
        C._free()
    if fail:
        with mock.patch.object(drivers, "prefetch",
                                 _failing_prefetch(drivers.prefetch)):
            try:
                run(3)
                out["failure"] = "no error"
            except RuntimeError as e:
                out["failure"] = str(e)
        out["steps_after_failure"] = Checkpointer(f"{base}/ckpt").steps()
        if dev.type == "cuda":
            C._free()
    return out


def _multi(dev, grid, root: str, tree, mode: str) -> dict:
    """``run_training_multi`` on the grid for one step of the full-width
    ``yolo_pose_multi`` at batch 32 fed by ``device_synth`` over
    chip_smoke.py's phase 15 renders (``tree``: ``C._tp_synth_tree``'s),
    eager or (``mode`` ``captured``) with ``precompile_buckets``: its
    losses, ``seen`` and the gathered state's SHA-256."""
    datacfg, _, _, frames = tree
    rc = TrainRunConfig(group=grid, loader_backend="device_synth",
                        max_epochs_override=1, num_workers=0, log_every=1,
                        bg_dir=f"{root}/no_bg", eval_every=20, eval_after=-1,
                        precompile_buckets=mode == "captured")
    t = time.perf_counter()
    with C._reading_renders(frames):
        result = run_training_multi(datacfg, C.yolo_pose_multi(), None, 0,
                                    None, os.path.dirname(datacfg), rc)
    _sync(dev)
    out = {"losses": result["history"]["training_losses"],
           "seen": result["state"].seen,
           "sha": C._state_sha(gather_train_state(grid, result["state"])),
           "seconds": time.perf_counter() - t}
    del result
    if dev.type == "cuda":
        C._free()
    return out


def _restored(spec, dev, directory: str, step: int):
    """Checkpoint ``step`` under ``directory`` restored in one process on
    ``dev``: (the step, the state's SHA-256)."""
    net = spec.net
    state = init_train_state(Darknet(spec, device=dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    got = Checkpointer(directory).restore(state, step)
    return got, C._state_sha(state)


def _trainer_checks(rs, spec, dev, directory: str) -> dict:
    """One mode's trainer checks over the ranks ``rs``, its step-4
    checkpoint restored in one process on ``dev``."""
    r0 = rs[0]
    steps = 2 * C.TP_TRAIN_FRAMES // C.TRAIN_BATCH
    last, sha = _restored(spec, dev, directory, steps)
    return {
        "losses_finite_and_equal": all(
            len(r["losses"]) == steps and r["losses"] == r0["losses"]
            for r in rs) and all(map(math.isfinite, r0["losses"])),
        "seen": all(r["seen"] == steps * C.TRAIN_BATCH for r in rs),
        "checkpoints": r0["steps"] == [steps // 2, steps] and last == steps,
        "eval_ran": all(len(r["testing"]) == 1 for r in rs),
        "model_weights_gathered": r0.get("weights_equal") is True,
        "restored_in_one_process": all(r["sha"] == sha for r in rs)}


def _trainer_result(ranks, spec, dev, root: str) -> dict:
    """The trainer runs' checks: each mode's (:func:`_trainer_checks`)
    and, with ``--captured``, the captured runs against the eager ones —
    the losses, the gathered state, the checkpoints, the failure save's
    checkpoint restored in one process, the multi step — bit for bit."""
    modes = [m for m in ("eager", "captured") if m in ranks[0]]
    checks = {"layout": [r["eager"]["layout"] for r in ranks] ==
              [[r, r // MP, DP, r % MP, MP] for r in range(DP * MP)]}
    for m in modes:
        checks.update({f"{m}: {k}": v for k, v in _trainer_checks(
            [r[m] for r in ranks], spec, dev, f"{root}/{m}/ckpt").items()})
    r0 = ranks[0]["eager"]
    result = {"grid": f"dp={DP} x mp={MP}", "backend": r0["backend"],
              "trainer": "run_training, device_bank, 2 epochs (1 + resumed)",
              "losses": r0["losses"], "testing": r0["testing"],
              "checkpoints": r0["steps"]}
    for m in modes:
        result[f"seconds_per_run_{m}"] = [r[m]["seconds"] for r in ranks]
    if "captured" in modes:
        steps = 2 * C.TP_TRAIN_FRAMES // C.TRAIN_BATCH
        pairs = [(r["eager"], r["captured"]) for r in ranks]
        fail = {m: _restored(spec, dev, f"{root}/{m}/ckpt", steps + 1)
                for m in modes}
        multi = [(r["multi"]["eager"], r["multi"]["captured"])
                 for r in ranks]
        m0 = multi[0][0]
        checks.update({
            "captured = eager: losses": all(
                C._same_bits(torch.tensor(e["losses"]),
                             torch.tensor(c["losses"])) for e, c in pairs),
            "captured = eager: gathered state": all(
                e["sha"] == c["sha"] for e, c in pairs),
            "captured = eager: checkpoints": all(
                e["steps"] == c["steps"] for e, c in pairs),
            "failure saved at step 5": all(
                ranks[0][m]["steps_after_failure"] ==
                [steps // 2, steps, steps + 1] and all(
                    r[m]["failure"] == "the loader failed after one batch"
                    for r in ranks) for m in modes),
            "captured = eager: failure save": fail["eager"] ==
            fail["captured"] and fail["eager"][0] == steps + 1,
            "multi: finite, ranks equal": all(
                len(e["losses"]) == 1 and math.isfinite(e["losses"][0])
                and e["losses"] == m0["losses"] and e["sha"] == m0["sha"]
                and e["seen"] == C.MULTI_TRAIN_BATCH for e, _ in multi),
            "multi: captured = eager": all(
                C._same_bits(torch.tensor(e["losses"]),
                             torch.tensor(c["losses"]))
                and e["sha"] == c["sha"] and e["seen"] == c["seen"]
                for e, c in multi)})
        result.update(
            losses_captured=ranks[0]["captured"]["losses"],
            sha=[r0["sha"], ranks[0]["captured"]["sha"]],
            failure_sha=[fail[m][1] for m in modes],
            multi_losses=[m0["losses"], multi[0][1]["losses"]],
            multi_sha=[m0["sha"], multi[0][1]["sha"]],
            multi_seconds=[[e["seconds"], c["seconds"]] for e, c in multi])
    result.update(checks=checks, ok=all(checks.values()))
    return result


def _captured_result(ranks) -> dict:
    """``--captured``'s checks over the ranks (``C._dp_captured``'s
    results) and its figures."""
    n = len(C.DP_CAPTURED_WIDTHS)
    steps = len(C.DP_CAPTURED_SEQUENCE)
    r0 = ranks[0]
    checks = {
        "k2_k6_once_a_graph": all(r["per_graph"] == [[1] * 5] * n
                                  for r in ranks),
        "collectives_recorded": all(
            C._grid_collectives_recorded(r, n) for r in ranks),
        "replays": all(r["replays"] == r["replays_step"] == steps
                       and r["wrapped"] == [0] * 5 for r in ranks),
        "losses_bit_for_bit": all(
            r["same_losses"] and r["finite"] and not r["diffs"]
            and C._same_bits(r["losses"], r0["losses"]) for r in ranks),
        "gathered_state_bit_for_bit": all(
            r["sha"] == [r0["sha"][0]] * 2 for r in ranks),
        "seen": all(r["seen"] == (steps * C.TRAIN_BATCH,) * 2
                    for r in ranks)}
    return {
        "grid": f"dp={DP} x mp={MP}", "captured": True,
        "widths": C.DP_CAPTURED_SEQUENCE, "epochs": C.DP_CAPTURED_EPOCHS,
        "batch": C.TRAIN_BATCH, "rows_a_rank": C.TRAIN_BATCH // DP,
        "per_graph": [r["per_graph"] for r in ranks],
        "collectives_captured": [r["collectives_captured"] for r in ranks],
        "collectives_eager_step": [r["collectives_eager_step"]
                                   for r in ranks],
        "capture_s": [r["capture_s"] for r in ranks],
        "capture_s_per_width": [r["capture_s_per_width"] for r in ranks],
        "reserved_gib": [r["reserved_gib"] for r in ranks],
        "losses": r0["losses"].tolist(), "sha": r0["sha"][0],
        "turns_416_ms_median_min_max": [r["turns"] for r in ranks],
        "timer": "CUDA events", "checks": checks,
        "ok": all(checks.values())}


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _drift(a: dict, b: dict):
    """The four tensors of two whole states furthest apart, each gap over
    the tensor's largest value."""
    gaps = {k: _gap(a[k], b[k]) / float(b[k].abs().max())
            for k in b if b[k].is_floating_point()}
    return sorted(((d, k) for k, d in gaps.items()), reverse=True)[:4]


def _sensitivity(args) -> int:
    """``--sensitivity``: one card's steps from the seeded state and from
    it one ulp off; their loss gap step by step and the last states'."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    spec = _spec(args)
    runs = [_steps(spec, dev, args, nudge=n) for n in (False, True)]
    (la, _, _, last_a, _), (lb, _, _, last_b, _) = runs
    result = {"sensitivity": "one card, conv_1's first weight one ulp up",
              "dtype": args.dtype, "steps": args.steps, "size": args.size,
              "losses": la, "losses_nudged": lb,
              "loss_rel_per_step": [abs(b - a) / abs(a)
                                    for a, b in zip(la, lb)],
              "last_rel_drift_worst": [(k, d) for d, k in
                                       _drift(last_b, last_a)],
              "ok": True}
    return _emit(result, args)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=C.TRAIN_SIZE)
    ap.add_argument("--eval_size", type=int, default=C.SIZE)
    ap.add_argument("--tiny", action="store_true",
                    help="a stem, one conv and the head (CPU rehearsal)")
    ap.add_argument("--dtype", choices=("bf16", "f32"), default="bf16",
                    help="the steps' compute dtype (f32: the unfused stem)")
    ap.add_argument("--trainer", action="store_true",
                    help="run_training on the grid, with a checkpoint and "
                         "a resume, in place of the steps")
    ap.add_argument("--sensitivity", action="store_true",
                    help="one card: the steps from the seeded state and "
                         "from it one ulp off, their gaps step by step")
    ap.add_argument("--captured", action="store_true",
                    help="the grid's step captured per width against its "
                         "eager steps (with --trainer: the trainers with "
                         "precompile_buckets against eager)")
    args = ap.parse_args(argv)
    if args.sensitivity:
        return _sensitivity(args)
    if args.device == "cuda" and torch.cuda.device_count() < DP * MP:
        raise SystemExit(f"needs {DP * MP} cards; "
                         f"{torch.cuda.device_count()} visible")
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_tp_check_")
    try:
        torch.multiprocessing.start_processes(
            _rank, args=(free_port(), root, args), nprocs=DP * MP,
            join=True, start_method="spawn")
        ranks = [torch.load(f"{root}/rank{r}.pt", weights_only=False)
                 for r in range(DP * MP)]
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0) if args.device == "cuda" \
            else torch.device("cpu")
        spec = _spec(args)
        if args.trainer or args.captured:
            result = _trainer_result(ranks, spec, dev, root) \
                if args.trainer else _captured_result(ranks)
            result["grid_s"] = time.perf_counter() - t0
            return _emit(result, args)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grid_s = time.perf_counter() - t0

    losses, ms, first, last, state = _steps(spec, dev, args)
    whole = C._state_bytes(state)
    del state
    ref_eval = _eval(spec, dev, args)

    r0 = ranks[0]
    loss_rel = abs(r0["losses"][0] - losses[0]) / abs(losses[0])
    first_d = {k: _gap(r0["first"][k], first[k]) for k in HELD}
    worst = _drift(r0["last"], last)
    shares = [[b / w for b, w in zip(r["bytes"], whole)] for r in ranks]
    peers = all(ranks[r]["sha"] == ranks[r % MP]["sha"]
                for r in range(DP * MP))
    gathered = all(_gap(r["first"][k], r0["first"][k]) == 0
                   for r in ranks for k in r0["first"])
    eval_gap = {k: max(_gap(r["eval"][k], ref_eval[k]) for r in ranks)
                for k in ref_eval}
    step_ms = [statistics.median(r["ms"][1:] or r["ms"]) for r in ranks]
    loss_rel_steps = [abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                           losses)]
    checks = {
        "layout": [r["layout"] for r in ranks] ==
        [[r, r // MP, DP, r % MP, MP] for r in range(DP * MP)],
        "half_the_bytes": all(s == [1 / MP, 1 / MP] for s in shares),
        "data_peers_same_bytes": peers,
        "gathered_alike": gathered,
        "first_loss": loss_rel <= 1e-3,
        "first_state": first_d["conv_1.weight"] <= 6e-4
        and first_d["conv_2.weight"] <= 6e-4
        and first_d["conv_1.running_mean"] <= 1e-5,
        # f32: every step held alone, from the one card's state
        **({"f32_per_step_loss": all(
            d <= 1e-5 for r in ranks for d in r["per_step"]["loss_rel"]),
            "f32_per_step_state": all(
                d <= 1e-5 for r in ranks for _, d in r["per_step"]["worst"])}
           if args.dtype == "f32" else {}),
        "seen": all(r["seen"] == args.steps * C.TRAIN_BATCH for r in ranks),
        "eval": max(eval_gap.values()) <= 0.05,
    }
    result = {
        "grid": f"dp={DP} x mp={MP}", "backend": r0["backend"],
        "dtype": args.dtype, "loss_rel_per_step": loss_rel_steps,
        "steps": args.steps, "batch": C.TRAIN_BATCH, "size": args.size,
        "eval_size": args.eval_size, "bytes_whole": whole,
        "bytes_rank": [r["bytes"] for r in ranks],
        "loss_rel_first": loss_rel, "first_max_abs": first_d,
        "losses_grid": r0["losses"], "losses_one_card": losses,
        "last_rel_drift_worst": [(k, d) for d, k in worst],
        "eval_max_abs": eval_gap,
        "step_ms_median_per_rank": step_ms,
        "step_ms_one_card_median": statistics.median(ms[1:] or ms),
        "timer": "CUDA events" if args.device == "cuda" else "host clock",
        "grid_s": grid_s, "checks": checks, "ok": all(checks.values())}
    if args.dtype == "f32":
        # the held gaps, each step from one state, beside the trajectory's
        # yardstick: one card against itself one ulp off
        _, _, _, nudged_last, _ = nudged = _steps(spec, dev, args, nudge=True)
        result.update(
            per_step_loss_rel=[max(r["per_step"]["loss_rel"][i]
                                   for r in ranks)
                               for i in range(args.steps)],
            per_step_worst=[max((r["per_step"]["worst"][i] for r in ranks),
                                key=lambda w: w[1])
                            for i in range(args.steps)],
            per_step_losses=[r0["per_step"]["loss_grid"],
                             r0["per_step"]["loss_one"]],
            # each step's worst state-dict tensor and momentum buffer (with
            # the share of its elements over 1e-5 of its max), the one
            # card's own gaps when only its rounding moves, and the grid's
            # and the one card's worst tensor against the step with f64
            # convs, and both at the held worst tensor
            per_step_parts=r0["per_step"]["parts"],
            per_step_yardsticks=r0["per_step"]["yardsticks"],
            per_step_f64=r0["per_step"]["f64"],
            sensitivity_loss_rel_per_step=[
                abs(b - a) / abs(a) for a, b in zip(losses, nudged[0])],
            sensitivity_last_rel_drift_worst=[
                (k, d) for d, k in _drift(nudged_last, last)])
    return _emit(result, args)


def _emit(result: dict, args) -> int:
    """Print ``result`` as the last line (and write it to ``--out``)."""
    if args.device == "cuda":
        import subprocess
        result["cards"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
