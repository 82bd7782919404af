#!/usr/bin/env python3
"""``cli train --dp N`` and ``cli train-multi --dp N`` under ``torchrun``,
eager against captured, and fed by the device banks.

    python3 scripts/dp_cli_check.py --out RESULT.json     # N = 2 cards
    python3 scripts/dp_cli_check.py --modes bank multi_eager multi_captured
    python3 scripts/dp_cli_check.py --device cpu --modes eager bank \\
        --frames 8 --batch 4 --size 64                    # a CPU rehearsal

Renders a small LINEMOD-format corpus (``data/shaded.py``: ``--frames``
640x480 shaded frames as JPEG files, PNG masks, labels, a mesh and a
``.data``), then trains the full ``yolo_pose_single`` from seeded random
weights for ``--epochs`` epochs with ``python -m
singleshotpose_tpu_torch.cli train --dp N`` started by ``torchrun
--standalone --nproc_per_node N`` — one process a rank, rank r on cuda:r,
NCCL (gloo with ``--device cpu``) — once eagerly and once with
``--precompile_buckets`` (every multi-scale width captured as a CUDA graph
with the step's collectives).  Mode ``bank`` trains the same way fed by
``--loader_backend device_bank`` (every rank holds the bank and computes
its rows of the global batch).  Modes ``multi_eager`` and
``multi_captured`` train the full ``yolo_pose_multi`` with ``cli
train-multi --dp N --loader_backend device_synth`` (``--precompile_buckets``
for the second) over an OCCLUSION tree of ``--multi_frames`` shaded renders
a class (``scripts/shaded_accuracy_multi.py``'s scene bank written as
files).  Each rank records the SHA-256 of its final train state
(parameters, BN statistics, momentum buffers, ``seen``) and its losses.
Holds: within each run the ranks' states are the same bytes and the losses
finite; each captured run's states and losses are its eager run's bit for
bit.  Prints the result as one JSON object on the last line.  Imports no
jax.
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


def write_multi_corpus(root: str, frames_per_class: int) -> str:
    """An OCCLUSION tree of ``frames_per_class`` shaded renders a class
    under ``root`` (images as JPEG, quality 92; PNG masks; labels), its
    train list of every frame and ``occlusion.data``.  Returns its
    path."""
    from PIL import Image

    import chip_smoke as C
    mod = C._script("shaded_accuracy_multi")
    host = mod.shaded_scene_bank(frames_per_class,
                                 *mod.palettes_and_extents())
    datacfg, _, _, frames = C._synth_tree(host, root)
    for path, a in frames.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(a).save(path, **({} if path.endswith(".png")
                                         else {"quality": 92}))
    return datacfg


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

    def recording(real):
        def run(*args, **kwargs):
            result = real(*args, **kwargs)
            rank = int(os.environ["RANK"])
            with open(f"{out}.rank{rank}.json", "w") as f:
                json.dump({"sha": _state_sha(result["state"]),
                           "seen": result["state"].seen,
                           "losses": result["history"]["training_losses"]},
                          f)
            return result
        return run

    drivers.run_training = recording(drivers.run_training)
    drivers.run_training_multi = recording(drivers.run_training_multi)
    return cli.main(argv)


# mode: (the cli command, its train loader, --precompile_buckets)
_MODES = {"eager": ("train", "python", False),
          "captured": ("train", "python", True),
          "bank": ("train", "device_bank", False),
          "multi_eager": ("train-multi", "device_synth", False),
          "multi_captured": ("train-multi", "device_synth", True)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dp", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--batch", type=int, default=None,
                    help="the global batch (default: the cfgs', 8 and 32)")
    ap.add_argument("--size", type=int, default=None,
                    help="the nets' width and height (default: the cfgs')")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--modes", nargs="+", default=["eager", "captured"],
                    choices=list(_MODES))
    ap.add_argument("--multi_frames", type=int, default=3,
                    help="shaded renders a class of the multi modes' tree "
                         "(3: 39 frames, one global batch of 32)")
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
        cfg, multi_cfg = "yolo-pose", "yolo-pose-multi"
        if args.batch or args.size:
            from singleshotpose_tpu_torch.zoo import (yolo_pose_blocks,
                                                      yolo_pose_multi)
            kw = {}
            if args.batch:
                kw["batch"] = args.batch
            if args.size:
                kw.update(train_size=args.size, test_size=args.size)
            cfg, multi_cfg = f"{root}/net.cfg", f"{root}/multi.cfg"
            for path, blocks in ((cfg, yolo_pose_blocks(**kw)),
                                 (multi_cfg, yolo_pose_multi(**kw).blocks)):
                with open(path, "w") as f:
                    f.write("\n".join("[{}]\n{}\n".format(
                        b["type"], "\n".join(f"{k}={v}" for k, v in
                                             b.items() if k != "type"))
                        for b in blocks))
        print(f"corpus of {args.frames} frames in "
              f"{time.perf_counter() - t:.1f} s", flush=True)
        if any(m.startswith("multi") for m in args.modes):
            t = time.perf_counter()
            multi_data = write_multi_corpus(f"{root}/occ", args.multi_frames)
            print(f"OCCLUSION tree of {args.multi_frames} frames a class in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
        for mode in args.modes:
            out = f"{root}/{mode}"
            command, backend, captured = _MODES[mode]
            if command == "train":
                data = ["--datacfg", datacfg, "--modelcfg", cfg,
                        "--pretrain_num_epochs", "0"]
            else:
                data = ["--datacfg", multi_data, "--modelcfg", multi_cfg,
                        "--linemod_root", f"{root}/occ"]
            cmd = [sys.executable, "-m", "torch.distributed.run",
                   "--standalone", f"--nproc_per_node={args.dp}",
                   os.path.abspath(__file__), "--rank_of", out, "--",
                   command, *data, "--initweightfile", "",
                   "--max_epochs", str(args.epochs), "--bg_dir",
                   f"{root}/no_bg", "--loader_backend", backend,
                   "--dp", str(args.dp), "--device", args.device]
            if captured:
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
                      and all(np.isfinite(v["ranks"][0]["losses"]))
                      for m, v in runs.items()}
        result["ranks_equal"] = same_ranks
        pairs = {}
        for eager, captured in (("eager", "captured"),
                                ("multi_eager", "multi_captured")):
            if eager in runs and captured in runs:
                e, c = runs[eager]["ranks"][0], runs[captured]["ranks"][0]
                pairs[captured] = e["sha"] == c["sha"] and \
                    e["losses"] == c["losses"]
        result["captured_equals_eager"] = pairs
        result["ok"] = all(same_ranks.values()) and all(pairs.values())
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
