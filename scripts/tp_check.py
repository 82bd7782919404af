#!/usr/bin/env python3
"""The train step and an eval batch on a dp=2 × mp=2 grid of four cards,
and the trainer on it.

    python3 scripts/tp_check.py --out RESULT.json          # 4 cards, NCCL
    python3 scripts/tp_check.py --dtype f32 --out F32.json # f32, TF32 off
    python3 scripts/tp_check.py --trainer --out TRAIN.json # run_training
    python3 scripts/tp_check.py --device cpu --tiny --steps 2 \\
        --size 64 --eval_size 64 [--trainer]               # a CPU rehearsal

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
stem; TF32 is off throughout) and holds every step's loss to rel 1e-4 of
one card's and the last state to 1e-4 of each tensor's largest value:
whether the grid follows one card step after step where rounding is not
bf16's.

``--sensitivity`` (one card, no grid): the ``--dtype`` steps twice, from
the seeded state and from it with conv_1's first weight one ulp up; each
step's loss gap and the last state's largest gap (to each tensor's max):
how fast this training amplifies a rounding difference by itself, the
yardstick for the grid's gap to one card.

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

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as C  # noqa: E402
from singleshotpose_tpu_torch import weights as W  # noqa: E402
from singleshotpose_tpu_torch.checkpoint import Checkpointer  # noqa: E402
from singleshotpose_tpu_torch.drivers import (  # noqa: E402
    TrainRunConfig, run_training)
from singleshotpose_tpu_torch.models.darknet import (  # noqa: E402
    Darknet, DarknetSpec, fold_batchnorm, shard_folded)
from singleshotpose_tpu_torch.parallel.multihost import (  # noqa: E402
    initialize_distributed)
from singleshotpose_tpu_torch.parallel.sharding import (  # noqa: E402
    all_gather_rows, free_port, make_dp_group, shard_host_batch)
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
    if args.trainer:
        out = _trainer(spec, dev, grid, root, rank)
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
    dist.destroy_process_group()
    torch.save(out, f"{root}/rank{rank}.pt")


def _trainer(spec, dev, grid, root: str, rank: int) -> dict:
    """``run_training`` on the grid fed by ``device_bank``: one epoch with
    its checkpoint, then resumed for a second with the in-training eval;
    the losses, ``seen``, the checkpoints' steps, the gathered state's
    SHA-256 and (the writer) ``model.weights`` against it."""
    datacfg, _, bgs, frames = C._tp_corpus(f"{root}/corpus{rank}")
    out = {"layout": [dist.get_rank(), grid.rank, grid.world,
                      grid.model_rank, grid.mp], "backend": grid.backend,
           "losses": [], "seconds": []}
    for epochs in (1, 2):
        rc = TrainRunConfig(group=grid, loader_backend="device_bank",
                            max_epochs_override=epochs, num_workers=0,
                            log_every=2, bg_dir=os.path.dirname(bgs[0]),
                            eval_every=1, eval_after=0,
                            eval_batch_size=C.TRAIN_BATCH,
                            checkpoint_dir=f"{root}/ckpt",
                            checkpoint_every_epochs=1, resume=epochs > 1,
                            device=str(dev))
        t = time.perf_counter()
        with C._reading_renders(frames):
            result = run_training(datacfg, spec, None, 15, rc)
        _sync(dev)
        out["seconds"].append(time.perf_counter() - t)
        out["losses"] += result["history"]["training_losses"]
    out["testing"] = result["history"]["testing_accuracies"]
    out["seen"] = result["state"].seen
    out["steps"] = Checkpointer(f"{root}/ckpt").steps()
    whole = gather_train_state(grid, result["state"])
    out["sha"] = C._state_sha(whole)
    if grid.leader:
        _, sd = W.load_weights(spec, f"{root}/corpus0/backup/model.weights")
        got = whole.model.state_dict()
        out["weights_equal"] = all(C._same_bits(v, got[k].cpu())
                                   for k, v in sd.items())
    return out


def _trainer_result(ranks, spec, dev, root: str) -> dict:
    """The trainer run's checks, the last checkpoint restored in one
    process on ``dev``."""
    net = spec.net
    state = init_train_state(Darknet(spec, device=dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    last = Checkpointer(f"{root}/ckpt").restore(state)
    r0 = ranks[0]
    steps = 2 * C.TP_TRAIN_FRAMES // C.TRAIN_BATCH
    checks = {
        "layout": [r["layout"] for r in ranks] ==
        [[r, r // MP, DP, r % MP, MP] for r in range(DP * MP)],
        "losses_finite_and_equal": all(
            len(r["losses"]) == steps and r["losses"] == r0["losses"]
            for r in ranks) and all(map(math.isfinite, r0["losses"])),
        "seen": all(r["seen"] == steps * C.TRAIN_BATCH for r in ranks),
        "checkpoints": r0["steps"] == [steps // 2, steps] and last == steps,
        "eval_ran": all(len(r["testing"]) == 1 for r in ranks),
        "model_weights_gathered": r0.get("weights_equal") is True,
        "restored_in_one_process": all(r["sha"] == C._state_sha(state)
                                       for r in ranks)}
    return {"grid": f"dp={DP} x mp={MP}", "backend": r0["backend"],
            "trainer": "run_training, device_bank, 2 epochs (1 + resumed)",
            "losses": r0["losses"], "testing": r0["testing"],
            "checkpoints": r0["steps"], "seconds_per_run": r0["seconds"],
            "checks": checks, "ok": all(checks.values())}


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
        if args.trainer:
            result = _trainer_result(ranks, spec, dev, root)
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
    drift_max = worst[0][0] if worst else 0.0
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
        # f32: every step held, not the first alone
        **({"f32_every_step_loss": max(loss_rel_steps) <= 1e-4,
            "f32_last_state": drift_max <= 1e-4}
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
