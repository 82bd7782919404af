#!/usr/bin/env python3
"""Held-out-pose accuracy of the PyTorch port on shaded renders.

    python3 scripts/shaded_accuracy.py                     # full size, card
    python3 scripts/shaded_accuracy.py --out RESULT.json   # and keep the result
    python3 scripts/shaded_accuracy.py --n_train 4 --n_eval 2 --epochs 4 \\
        --batch 2 --size 64 --device cpu                   # a CPU rehearsal

The JAX package's shaded stand-in for LINEMOD (``bench.py:1198``
``bench_acc_shaded``), with the port: ``data/shaded.py`` renders a
depth-buffered, face-coloured, Lambertian-lit box at random poses (seed 11,
2,200 splats, a fixed gradient background), 1,024 frames to train and the
next 512, at disjoint poses, to evaluate.  The full ``yolo_pose_single``
trains from seeded random weights for 250 epochs at batch 64, 416², bf16,
through ``Loader(backend="device_bank")`` (the train split decoded once into
device memory, augmented on the card) and one CUDA graph of the step for
the 416² shape, with ``bench_acc_shaded``'s recipe: per-sample lr 5e-6 for
epochs 0–2, then 2.5e-5, 5e-6 from 60 % of the epochs and 1e-6 from 88 %;
the confidence term off (epoch flag 0) for the first 20 % of the epochs,
then on (100, past ``pretrain_num_epochs`` 15); weight decay 0, momentum
0.9.  Then ``run_validation(transfer="bank")`` scores the held-out frames
in bf16: 2D reprojection within 5 px, ADD within 0.1 of the diameter, 5 cm
5°, and the mean pixel error; and again with ``quantize=True``, the int8
column (``models/quantize.py``: per-channel activation scales calibrated
on the first eval batch, as the JAX package's ``run_validation`` does; on a
card the int8 conv kernel).

Frames go through a JPEG round trip (quality 92) as the JAX recipe's do,
when Pillow imports; without it they never touch disk — the loader's image
decoder reads the in-memory renders — and the result says the JPEG round
trip was skipped.  This is an accuracy run, not a benchmark: a stand-in, not
parity (the initial weights and the random streams differ from the JAX
run's).  It prints the mean loss of every epoch, so a run that is cut still
shows how far it got, and the result as one JSON object on the last line.
Imports no jax.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from singleshotpose_tpu_torch.data import pipeline  # noqa: E402
from singleshotpose_tpu_torch.data.pipeline import (Loader,  # noqa: E402
                                                    PoseDataset)
from singleshotpose_tpu_torch.data.shaded import (  # noqa: E402
    BOX_HALF_EXTENTS, PTS, render_frame)
from singleshotpose_tpu_torch.drivers import (TrainRunConfig,  # noqa: E402
                                              _precompile_buckets,
                                              _resolve_fused_stem,
                                              run_validation)
from singleshotpose_tpu_torch.models.darknet import (Darknet,  # noqa: E402
                                                     stem_supported)
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig  # noqa: E402
from singleshotpose_tpu_torch.training import (init_train_state,  # noqa: E402
                                               make_train_step)
from singleshotpose_tpu_torch.zoo import yolo_pose_single  # noqa: E402

DIAMETER = float(2 * np.linalg.norm(BOX_HALF_EXTENTS))


def _log(msg: str) -> None:
    print(f"[shaded] {msg}", flush=True)


def render_dataset(base: str, n_train: int, n_eval: int, *, jpeg: bool,
                   seed: int = 11, n_splats: int = 2200):
    """``bench.py:_gen_shaded_dataset`` under ``base``: LINEMOD-format
    labels, lists, mesh and ``.data``; with ``jpeg`` the frames (quality
    92), masks (PNG) and the background as files.  Returns (the ``.data``
    path, the in-memory frames by path: images, masks and the background)."""
    rng = np.random.RandomState(seed)
    for d in ("JPEGImages", "labels", "mask"):
        os.makedirs(f"{base}/obj/{d}", exist_ok=True)
    yy, xx = np.mgrid[0:480, 0:640]
    bgimg = np.stack([(xx / 640 * 60 + 25), (yy / 480 * 60 + 30),
                      np.full_like(xx, 45.0)], axis=-1).astype(np.uint8)
    colors = rng.randint(60, 255, (6, 3))
    frames = {f"{base}/bg.jpg": bgimg}
    paths = []
    for i in range(n_train + n_eval):
        img, m, lab, _, _ = render_frame(rng, colors, bg_level=None,
                                         n_splats=n_splats)
        img = np.where(m[..., None] > 0, img, bgimg)
        name = f"00{i:04d}"
        path = f"{base}/obj/JPEGImages/{name}.jpg"
        frames[path] = img
        frames[f"{base}/obj/mask/{name[2:]}.png"] = m
        np.savetxt(f"{base}/obj/labels/{name}.txt", lab[None])
        paths.append(path)
    if jpeg:
        from PIL import Image
        for path, a in frames.items():
            Image.fromarray(a).save(path, **({} if path.endswith(".png")
                                             else {"quality": 92}))
    with open(f"{base}/train.txt", "w") as f:
        f.write("\n".join(paths[:n_train]) + "\n")
    with open(f"{base}/test.txt", "w") as f:
        f.write("\n".join(paths[n_train:]) + "\n")
    v = PTS[1:]
    ply = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
           "property float x", "property float y", "property float z",
           "element face 0", "property list uchar int vertex_indices",
           "end_header"] + [f"{a} {b} {c}" for a, b, c in v]
    with open(f"{base}/obj.ply", "w") as f:
        f.write("\n".join(ply) + "\n")
    with open(f"{base}/synth.data", "w") as f:
        f.write(f"train = {base}/train.txt\nvalid = {base}/test.txt\n"
                f"backup = {base}/backup\nmesh = {base}/obj.ply\n"
                f"name = shaded\ndiam = {DIAMETER:.4f}\nwidth = 640\n"
                "height = 480\nfx = 572.4114\nfy = 573.5704\n"
                "u0 = 325.2611\nv0 = 242.0489\n")
    return f"{base}/synth.data", frames


def learning_rate(epoch: int, n_epochs: int) -> float:
    """``bench_acc_shaded``'s per-sample lr: a short warm-up, then a 3-step
    decay."""
    if epoch < 3:
        return 5e-6
    frac = epoch / n_epochs
    return 2.5e-5 if frac < 0.6 else (5e-6 if frac < 0.88 else 1e-6)


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not measured (no nvidia-smi)"


def run(n_train: int = 1024, n_eval: int = 512, epochs: int = 250,
        batch: int = 64, size: int = 416, seed: int = 0,
        device: str = "cuda") -> dict:
    """Render, train and evaluate; returns the result's fields."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("shaded_accuracy: --device cuda but CUDA is not "
                         "available (pass --device cpu for a rehearsal)")
    try:
        import PIL  # noqa: F401
        jpeg = True
    except ImportError:
        jpeg = False
    t0 = time.perf_counter()
    base = tempfile.mkdtemp(prefix="ssp_shaded_")
    try:
        datacfg, frames = render_dataset(base, n_train, n_eval, jpeg=jpeg)
        _log(f"rendered {n_train} train and {n_eval} held-out frames in "
             f"{time.perf_counter() - t0:.1f} s; JPEG round trip "
             + ("(quality 92) done" if jpeg else
                "SKIPPED (no Pillow): frames read from memory"))
        # without Pillow the loader's decoder reads the renders in memory
        # (and the native decoder, which reads files, is not used)
        decode = contextlib.nullcontext() if jpeg else mock.patch.multiple(
            pipeline, load_image=frames.__getitem__,
            _native_decoder=lambda n: (None, "frames read from memory"))
        with decode:
            result = _train_and_eval(datacfg, base, n_train, epochs, batch,
                                     size, seed, device)
    finally:
        shutil.rmtree(base, ignore_errors=True)
    result.update(jpeg_round_trip=jpeg, n_train=n_train, n_eval=n_eval,
                  wall_s=time.perf_counter() - t0, device=str(device),
                  card=_card() if device.type == "cuda" else "cpu")
    return result


def _train_and_eval(datacfg, base, n_train, epochs, batch, size, seed,
                    device) -> dict:
    spec = yolo_pose_single(test_size=size)
    model = Darknet(spec, generator=torch.Generator().manual_seed(seed),
                    device=device)
    state = init_train_state(model, weight_decay=0.0, momentum=0.9)
    fused = _resolve_fused_stem(TrainRunConfig(), device)
    ran_fused = fused and stem_supported(spec, torch.bfloat16,
                                         (batch, size, size, 3))
    stem = "fused (K3-K6)" if ran_fused else (
        "unfused: the fused stem's gate takes batches below 64" if fused
        else "unfused (off the card)")
    step = make_train_step(RegionLossConfig(pretrain_num_epochs=15),
                           compute_dtype=torch.bfloat16, fused_stem=fused)
    ds = PoseDataset(f"{base}/train.txt", train=True,
                     bg_file_names=[f"{base}/bg.jpg"])
    loader = Loader(ds, batch, schedule=None, fixed_shape=(size, size),
                    num_workers=0, seed=seed, backend="device_bank",
                    device=device)
    step = _precompile_buckets(step, state, [size], batch, 9)
    _log(f"yolo_pose_single {size}² batch {batch} bf16, stem {stem}; "
         f"{epochs} epochs of {n_train // batch} steps")
    t_train = time.perf_counter()
    losses = []
    for ep in range(epochs):
        flag = 0 if ep < epochs * 0.2 else 100
        lr = learning_rate(ep, epochs)
        total = torch.zeros((), device=device)
        n = 0
        for imgs, labels in loader:
            total += step(state, imgs, labels, lr, flag)["loss"]
            n += 1
        losses.append(float(total) / max(n, 1))
        _log(f"epoch {ep} lr {lr:g} flag {flag}: mean loss {losses[-1]:.6g} "
             f"({time.perf_counter() - t_train:.1f} s)")
    train_s = time.perf_counter() - t_train
    summary = run_validation(datacfg, spec, model=state.model,
                             batch_size=batch, num_workers=2,
                             compute_dtype=torch.bfloat16, device=device,
                             transfer="bank", verbose=False)
    int8 = run_validation(datacfg, spec, model=state.model,
                          batch_size=batch, num_workers=2,
                          compute_dtype=torch.bfloat16, device=device,
                          transfer="bank", quantize=True, verbose=False)
    for tag, res in (("bf16", summary), ("int8", int8)):
        _log(f"held out, {tag}, eval bank: 2D@5px {res['acc_2d_proj']:.2f}%, "
             f"ADD-0.1d {res['acc_add_0.1d']:.2f}%, 5cm5° "
             f"{res['acc_5cm5deg']:.2f}%, mean px error "
             f"{res['mean_err_2d']:.4f} over {res['n_samples']} frames")
    return {"acc_2d_5px": summary["acc_2d_proj"],
            "acc_add_0.1d": summary["acc_add_0.1d"],
            "acc_5cm5deg": summary["acc_5cm5deg"],
            "mean_px_err": summary["mean_err_2d"],
            "int8_acc_2d_5px": int8["acc_2d_proj"],
            "int8_acc_add_0.1d": int8["acc_add_0.1d"],
            "int8_acc_5cm5deg": int8["acc_5cm5deg"],
            "int8_mean_px_err": int8["mean_err_2d"],
            "eval_n": summary["n_samples"], "stem": stem,
            "epoch_losses": losses, "train_s": train_s, "epochs": epochs,
            "batch": batch, "size": size}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n_train", type=int, default=1024)
    ap.add_argument("--n_eval", type=int, default=512)
    ap.add_argument("--epochs", type=int, default=250)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args(argv)
    result = run(args.n_train, args.n_eval, args.epochs, args.batch,
                 args.size, args.seed, args.device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
