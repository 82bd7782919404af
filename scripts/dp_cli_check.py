#!/usr/bin/env python3
"""``cli train --dp N`` under ``torchrun``, eager against captured.

    python3 scripts/dp_cli_check.py --out RESULT.json     # N = 2 cards
    python3 scripts/dp_cli_check.py --device cpu --modes eager \\
        --frames 8 --batch 4 --size 64                    # a CPU rehearsal

Renders a small LINEMOD-format corpus (``data/shaded.py``: ``--frames``
640x480 shaded frames as JPEG files, PNG masks, labels, a mesh and a
``.data``), then trains the full ``yolo_pose_single`` from seeded random
weights for ``--epochs`` epochs with ``python -m
singleshotpose_tpu_torch.cli train --dp N`` started by ``torchrun
--standalone --nproc_per_node N`` — one process a rank, rank r on cuda:r,
NCCL (gloo with ``--device cpu``) — once eagerly and once with
``--precompile_buckets`` (every multi-scale width captured as a CUDA graph
with the step's collectives).  Each rank records the SHA-256 of its final
train state (parameters, BN statistics, momentum buffers, ``seen``) and its
losses.  Holds: within each run the ranks' states are the same bytes; the
captured run's states and losses are the eager run's bit for bit.  Prints
the result as one JSON object on the last line.  Imports no jax.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def write_corpus(root: str, frames: int, seed: int = 50) -> str:
    """``frames`` shaded frames as files under ``root``: JPEG images (quality
    92), PNG masks, label files, the train list (every frame), a test list
    (the first two), the box mesh and a ``.data``.  Returns its path."""
    from PIL import Image

    from singleshotpose_tpu_torch.data.shaded import (BOX_HALF_EXTENTS, PTS,
                                                      render_frame)
    rng = np.random.RandomState(seed)
    colors = rng.randint(60, 255, (6, 3))
    for d in ("JPEGImages", "mask", "labels"):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    paths = []
    for i in range(frames):
        img, mask, lab, _, _ = render_frame(rng, colors)
        path = f"{root}/JPEGImages/00{i:04d}.jpg"
        Image.fromarray(img).save(path, quality=92)
        Image.fromarray(mask).save(f"{root}/mask/{i:04d}.png")
        np.savetxt(f"{root}/labels/00{i:04d}.txt", lab[None])
        paths.append(path)
    for name, part in (("train", paths), ("test", paths[:2])):
        with open(f"{root}/{name}.txt", "w") as f:
            f.write("\n".join(part) + "\n")
    verts = PTS[1:]
    with open(f"{root}/obj.ply", "w") as f:
        f.write("\n".join(
            ["ply", "format ascii 1.0", f"element vertex {len(verts)}",
             "property float x", "property float y", "property float z",
             "element face 0", "property list uchar int vertex_indices",
             "end_header"] + [f"{a} {b} {c}" for a, b, c in verts]) + "\n")
    diam = float(2 * np.linalg.norm(BOX_HALF_EXTENTS))
    with open(f"{root}/obj.data", "w") as f:
        f.write(f"train = {root}/train.txt\nvalid = {root}/test.txt\n"
                f"backup = {root}/backup\nmesh = {root}/obj.ply\n"
                f"name = shaded\ndiam = {diam:.4f}\nwidth = 640\n"
                "height = 480\nfx = 572.4114\nfy = 573.5704\n"
                "u0 = 325.2611\nv0 = 242.0489\n")
    return f"{root}/obj.data"


def _state_sha(state) -> str:
    """SHA-256 of every tensor of a train state and ``seen``."""
    import torch
    h = hashlib.sha256(str(state.seen).encode())
    tensors = list(state.model.state_dict().values()) + [
        state.optimizer.state[p]["momentum_buffer"]
        for p in state.model.parameters()]
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def rank_main(out: str, argv) -> int:
    """One rank under ``torchrun``: ``cli.main(argv)``, the rank's final
    state hashed into ``out`` + ``.rank<r>.json``."""
    from singleshotpose_tpu_torch import cli, drivers
    real = drivers.run_training

    def run_training(*args, **kwargs):
        result = real(*args, **kwargs)
        rank = int(os.environ["RANK"])
        with open(f"{out}.rank{rank}.json", "w") as f:
            json.dump({"sha": _state_sha(result["state"]),
                       "seen": result["state"].seen,
                       "losses": result["history"]["training_losses"]}, f)
        return result

    drivers.run_training = run_training
    return cli.main(argv)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default: the cfg's, 8)")
    ap.add_argument("--size", type=int, default=None,
                    help="the net's width and height (default: the cfg's)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--modes", nargs="+", default=["eager", "captured"],
                    choices=["eager", "captured"])
    ap.add_argument("--timeout", type=float, default=1200.0,
                    help="seconds a torchrun may take")
    ap.add_argument("--out", default=None, help="write the result here")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < args.dp:
            raise SystemExit(f"--dp {args.dp} needs {args.dp} cards; "
                             f"{torch.cuda.device_count()} visible")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    else:
        card = ["CPU"]
    root = tempfile.mkdtemp(prefix="ssp_dp_cli_")
    result = {"dp": args.dp, "device": args.device, "cards": card,
              "frames": args.frames, "epochs": args.epochs, "runs": {}}
    try:
        t = time.perf_counter()
        datacfg = write_corpus(root, args.frames)
        cfg = "yolo-pose"
        if args.batch or args.size:
            from singleshotpose_tpu_torch.zoo import yolo_pose_blocks
            kw = {}
            if args.batch:
                kw["batch"] = args.batch
            if args.size:
                kw.update(train_size=args.size, test_size=args.size)
            blocks = yolo_pose_blocks(**kw)
            cfg = f"{root}/net.cfg"
            with open(cfg, "w") as f:
                f.write("\n".join("[{}]\n{}\n".format(b["type"], "\n".join(
                    f"{k}={v}" for k, v in b.items() if k != "type"))
                    for b in blocks))
        print(f"corpus of {args.frames} frames in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        for mode in args.modes:
            out = f"{root}/{mode}"
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", f"--nproc_per_node={args.dp}",
                   os.path.abspath(__file__), "--rank_of", out, "--",
                   "train", "--datacfg", datacfg, "--modelcfg", cfg,
                   "--initweightfile", "", "--pretrain_num_epochs", "0",
                   "--max_epochs", str(args.epochs), "--bg_dir",
                   f"{root}/no_bg", "--loader_backend", "python",
                   "--dp", str(args.dp), "--device", args.device]
            if mode == "captured":
                cmd.append("--precompile_buckets")
            t = time.perf_counter()
            r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                               timeout=args.timeout)
            seconds = time.perf_counter() - t
            log = r.stdout + r.stderr
            with open(f"{out}.log", "w") as f:
                f.write(log)
            print(f"--- {mode}: torchrun exit {r.returncode} in "
                  f"{seconds:.1f} s; the log's end:\n{log[-3000:]}",
                  flush=True)
            if r.returncode:
                raise SystemExit(f"the {mode} run failed ({r.returncode})")
            ranks = []
            for rank in range(args.dp):
                with open(f"{out}.rank{rank}.json") as f:
                    ranks.append(json.load(f))
            result["runs"][mode] = {"seconds": seconds, "ranks": ranks}
        runs = result["runs"]
        same_ranks = {m: all(r["sha"] == v["ranks"][0]["sha"] and
                             r["losses"] == v["ranks"][0]["losses"]
                             for r in v["ranks"])
                      for m, v in runs.items()}
        result["ranks_equal"] = same_ranks
        if len(runs) == 2:
            e, c = runs["eager"]["ranks"][0], runs["captured"]["ranks"][0]
            result["captured_equals_eager"] = \
                e["sha"] == c["sha"] and e["losses"] == c["losses"]
        ok = all(same_ranks.values()) and \
            result.get("captured_equals_eager", True)
        result["ok"] = ok
    finally:
        shutil.rmtree(root, ignore_errors=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "--rank_of":
        sep = sys.argv.index("--")
        sys.exit(rank_main(sys.argv[2], sys.argv[sep + 1:]))
    sys.exit(main())
