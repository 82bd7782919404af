#!/usr/bin/env python3
"""The train step and an eval batch on a dp=2 × mp=2 grid of four cards.

    python3 scripts/tp_check.py --out RESULT.json          # 4 cards, NCCL
    python3 scripts/tp_check.py --device cpu --tiny --steps 2 \\
        --size 64 --eval_size 64                           # a CPU rehearsal

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
apart step by step.  Prints one JSON object on the last line (and writes
it to ``--out``).  Imports no jax.
"""

from __future__ import annotations

import argparse
import datetime
import json
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
from singleshotpose_tpu_torch.models.darknet import (  # noqa: E402
    DarknetSpec, fold_batchnorm, shard_folded)
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


def _steps(spec, dev, args, group=None):
    """``args.steps`` fused bf16 steps from the seeded state (on a grid:
    split, on the data coordinate's rows).  Returns (losses, per-step ms
    — CUDA events on a card —, the whole state after the first and after
    the last step, the state)."""
    net = spec.net
    state = init_train_state(C._dp_model(spec, dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    if group is not None:
        shard_train_state(group, state)
    cfg = C.loss_config_from_spec(spec, pretrain_num_epochs=15,
                                  im_width=C.IM_W, im_height=C.IM_H)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16,
                           fused_stem=True, group=group)
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


def _gap(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--size", type=int, default=C.TRAIN_SIZE)
    ap.add_argument("--eval_size", type=int, default=C.SIZE)
    ap.add_argument("--tiny", action="store_true",
                    help="a stem, one conv and the head (CPU rehearsal)")
    args = ap.parse_args(argv)
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
    finally:
        shutil.rmtree(root, ignore_errors=True)
    grid_s = time.perf_counter() - t0

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0) if args.device == "cuda" \
        else torch.device("cpu")
    spec = _spec(args)
    losses, ms, first, last, state = _steps(spec, dev, args)
    whole = C._state_bytes(state)
    del state
    ref_eval = _eval(spec, dev, args)

    r0 = ranks[0]
    loss_rel = abs(r0["losses"][0] - losses[0]) / abs(losses[0])
    first_d = {k: _gap(r0["first"][k], first[k]) for k in HELD}
    drift = {k: _gap(r0["last"][k], last[k]) / float(last[k].abs().max())
             for k in last if last[k].is_floating_point()}
    worst = sorted(((d, k) for k, d in drift.items()), reverse=True)[:4]
    shares = [[b / w for b, w in zip(r["bytes"], whole)] for r in ranks]
    peers = all(ranks[r]["sha"] == ranks[r % MP]["sha"]
                for r in range(DP * MP))
    gathered = all(_gap(r["first"][k], r0["first"][k]) == 0
                   for r in ranks for k in r0["first"])
    eval_gap = {k: max(_gap(r["eval"][k], ref_eval[k]) for r in ranks)
                for k in ref_eval}
    step_ms = [statistics.median(r["ms"][1:] or r["ms"]) for r in ranks]
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
        "seen": all(r["seen"] == args.steps * C.TRAIN_BATCH for r in ranks),
        "eval": max(eval_gap.values()) <= 0.05,
    }
    result = {
        "grid": f"dp={DP} x mp={MP}", "backend": r0["backend"],
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
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
