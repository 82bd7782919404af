#!/usr/bin/env python3
"""Held-out-scene accuracy of the PyTorch port's multi-object net on shaded
renders.

    python3 scripts/shaded_accuracy_multi.py                     # full size, card
    python3 scripts/shaded_accuracy_multi.py --out RESULT.json   # and keep it
    python3 scripts/shaded_accuracy_multi.py --frames_per_class 2 --steps 3 \\
        --batch 2 --size 64 --n_eval 2 --n_splats 300 --device cpu   # CPU

The JAX package's multi-object shaded stand-in for OCCLUSION
(``bench.py:1324`` ``_shaded_scene_bank``, ``:1367``
``bench_acc_shaded_multi``), with the port.  A corpus of 13 classes × 160
single-object renders (``data/shaded.py``: per-class face palettes from seed
11 and box extents from 0.7× to 1.3× one box, 2,200 splats, seed 3) and 16
gradient backgrounds is assembled straight into a ``DeviceSceneBank`` on the
device, the role LINEMOD's singles play for the OCCLUSION trainer.  The full
``yolo_pose_multi`` trains from seeded random weights for 9,000 batch-32
416² bf16 steps on scenes synthesized fresh every step by
``data/device_synth.py`` (``propose_scale`` 4, the other knobs the host
synthesizer's defaults; the base frames taken in bank order, 32 a step),
through one CUDA graph of the step for its f32 input on the card, with
``bench_acc_shaded_multi``'s recipe: in chunks of 150 steps, per-sample lr
5e-6 for the first chunk, then 2.5e-5, 5e-6 from 60 % of the steps and 1e-6
from 88 %; the confidence term off (epoch flag 0) for the first 20 %, then
on (100, past ``pretrain_num_epochs`` 15); weight decay 0, momentum 0.9.
Then 64 unseen scenes, each 3 objects of distinct classes rendered with
true occlusion (``render_scene_multi``, seed 900), go through the bf16
serving function at batch 64 (one box per class, confidence 0.05), and each
object's box for its class is scored with the per-class ``pose_metrics``:
2D reprojection within 5 and 10 px, and the mean pixel error, over the 192
instances.  Then the int8 column on the same scenes: the net quantized as
``run_validation(quantize=True)`` quantizes it (``models/quantize.py``:
per-channel activation scales calibrated on the batch it then serves, the
eval driver's rounding; on a card the int8 conv kernel), served and scored
the same way.

An accuracy run, not a benchmark, and a stand-in, not parity (the initial
weights and the random streams differ from the JAX run's).  It prints the
mean loss of every chunk, so a run that is cut still shows how far it got,
and the result as one JSON object on the last line.  Imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from singleshotpose_tpu_torch.data.augment import resize_nearest  # noqa: E402
from singleshotpose_tpu_torch.data.device_synth import (  # noqa: E402
    DeviceSceneBank, DeviceSynthStatic, binary_masks, draw_synth,
    synthesize_batch)
from singleshotpose_tpu_torch.data.shaded import (  # noqa: E402
    K, box_points, render_frame, render_scene_multi)
from singleshotpose_tpu_torch.data.synth_multi import (  # noqa: E402
    ADD_OBJS, OCCLUSION_CLASSES)
from singleshotpose_tpu_torch.drivers import (  # noqa: E402
    TrainRunConfig, _precompile_buckets, _resolve_fused_stem,
    loss_config_from_spec)
from singleshotpose_tpu_torch.evaluate import (EvalContext,  # noqa: E402
                                               pose_metrics)
from singleshotpose_tpu_torch.models.darknet import (  # noqa: E402
    Darknet, fold_batchnorm, stem_supported)
from singleshotpose_tpu_torch.models.quantize import (  # noqa: E402
    calibrate_activations, quantize_folded)
from singleshotpose_tpu_torch.serving import make_serving_fn  # noqa: E402
from singleshotpose_tpu_torch.training import (  # noqa: E402
    init_train_state, make_train_step)
from singleshotpose_tpu_torch.zoo import yolo_pose_multi  # noqa: E402

BASE_EXTENT = np.array([.045, .035, .04], np.float32)
N_CLASSES, N_BACKGROUNDS, CHUNK, CONF = 13, 16, 150, 0.05


def _log(msg: str) -> None:
    print(f"[shaded multi] {msg}", flush=True)


def palettes_and_extents():
    """Per-class face palettes (13, 6, 3) and box half-extents (13, 3)."""
    palettes = np.random.RandomState(11).randint(60, 255, (N_CLASSES, 6, 3))
    extents = np.stack([BASE_EXTENT * f
                        for f in np.linspace(0.7, 1.3, N_CLASSES)])
    return palettes, extents


def shaded_scene_bank(frames_per_class: int, palettes, extents, *,
                      n_splats: int = 2200, seed: int = 3
                      ) -> DeviceSceneBank:
    """``bench.py:_shaded_scene_bank``: 13 classes × ``frames_per_class``
    640×480 single-object renders (masks from the renderer), their labels,
    ADD_OBJS as companions and 16 gradient backgrounds, as a
    ``DeviceSceneBank`` of CPU tensors (``.device_put()`` parks it)."""
    rng = np.random.RandomState(seed)
    n = N_CLASSES * frames_per_class
    imgs = np.zeros((n, 480, 640, 3), np.uint8)
    masks = np.zeros((n, 480, 640), np.uint8)
    labels = np.zeros((n, 21), np.float32)
    for c in range(N_CLASSES):
        for j in range(frames_per_class):
            i = c * frames_per_class + j
            imgs[i], masks[i], labels[i], _, _ = render_frame(
                rng, palettes[c], n_splats=n_splats, bg_level=(20, 90),
                ext=tuple(extents[c]), cls=c)
    comp = np.full((N_CLASSES + 1, 8), -1, np.int32)
    cls_of = {o: i for i, o in enumerate(OCCLUSION_CLASSES)}
    for obj, names in ADD_OBJS.items():
        for j, name in enumerate(names):
            comp[cls_of[obj], j] = cls_of[name]
    yy, xx = np.mgrid[0:480, 0:640]
    bgs = np.stack([np.stack(
        [(xx / 640 * 60 + rng.randint(10, 50)),
         (yy / 480 * 60 + rng.randint(10, 50)),
         np.full_like(xx, float(rng.randint(20, 70)))],
        axis=-1).astype(np.uint8) for _ in range(N_BACKGROUNDS)])
    return DeviceSceneBank(*(torch.from_numpy(a) for a in (
        imgs, masks, labels,
        (np.arange(N_CLASSES) * frames_per_class).astype(np.int32),
        np.full(N_CLASSES, frames_per_class, np.int32), comp, bgs,
        np.arange(n, dtype=np.int32),
        np.repeat(np.arange(N_CLASSES), frames_per_class).astype(np.int32))))


def eval_scenes(n: int, size: int, palettes, extents, *, seed: int,
                n_splats: int = 2200):
    """``n`` unseen 3-object scenes (distinct classes, true occlusion),
    nearest-resized to ``size``²: (u8 (n, size, size, 3), per scene the
    [(class, pixel keypoints (9, 2))] of its objects)."""
    rng = np.random.RandomState(seed)
    imgs = np.zeros((n, size, size, 3), np.uint8)
    gts = []
    for i in range(n):
        img, g = render_scene_multi(
            rng, palettes, extents, rng.choice(N_CLASSES, 3, replace=False),
            n_splats=n_splats)
        imgs[i] = resize_nearest(img, size, size)
        gts.append([(cls, pix) for cls, _lab, pix in g])
    return imgs, gts


def schedule(step: int, steps: int, chunk: int):
    """``bench_acc_shaded_multi``'s per-sample lr and epoch flag, set at
    the start of each chunk of ``chunk`` steps."""
    it0 = step // chunk * chunk
    frac = it0 / steps
    lr = 2.5e-5 if frac < 0.6 else (5e-6 if frac < 0.88 else 1e-6)
    if it0 == 0:
        lr = 5e-6                        # the warm-up chunk
    return lr, 0 if frac < 0.2 else 100


def _card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return "not measured (no nvidia-smi)"


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(frames_per_class: int = 160, steps: int = 9000, batch: int = 32,
        size: int = 416, n_eval: int = 64, n_splats: int = 2200,
        seed: int = 0, device: str = "cuda") -> dict:
    """Render, train and evaluate; returns the result's fields."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("shaded_accuracy_multi: --device cuda but CUDA is "
                         "not available (pass --device cpu for a rehearsal)")
    t0 = time.perf_counter()
    palettes, extents = palettes_and_extents()
    eimgs, egts = eval_scenes(n_eval, size, palettes, extents,
                              seed=seed + 900, n_splats=n_splats)
    host_bank = shaded_scene_bank(frames_per_class, palettes, extents,
                                  n_splats=n_splats)
    render_s = time.perf_counter() - t0
    binary = binary_masks(host_bank)
    t = time.perf_counter()
    bank = host_bank.device_put(device)
    _sync(device)
    put_s = time.perf_counter() - t
    _log(f"rendered {bank.images.shape[0]} bank frames and {n_eval} eval "
         f"scenes in {render_s:.1f} s; bank {bank.nbytes()} bytes on "
         f"{device} in {put_s:.2f} s; binary masks {binary}")

    spec = yolo_pose_multi()
    model = Darknet(spec, generator=torch.Generator().manual_seed(seed),
                    device=device)
    state = init_train_state(model, weight_decay=0.0, momentum=0.9)
    fused = _resolve_fused_stem(TrainRunConfig(), device)
    ran_fused = fused and stem_supported(spec, torch.bfloat16,
                                         (batch, size, size, 3))
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=15, im_width=640,
                                im_height=480, multi=True)
    step = _precompile_buckets(
        make_train_step(cfg, compute_dtype=torch.bfloat16, fused_stem=fused),
        state, [size], batch, spec.num_keypoints, image_dtype=torch.float32)
    st = DeviceSynthStatic(propose_scale=4)
    H, W = bank.frame_shape
    n_frames = bank.images.shape[0]
    chunk = min(CHUNK, steps)
    _log(f"yolo_pose_multi {size}² batch {batch} bf16, fused stem "
         f"{ran_fused}; {steps} steps of device_synth scenes (attempts "
         f"{st.attempts}, propose_scale {st.propose_scale})")

    gen = torch.Generator(device=device).manual_seed(seed)
    idx = torch.arange(batch, device=device)
    total = torch.zeros((), device=device)
    objects = torch.zeros((), dtype=torch.int64, device=device)
    chunk_losses = []
    t_train = time.perf_counter()
    for i in range(steps):
        lr, flag = schedule(i, steps, chunk)
        draws = draw_synth(gen, batch, bank, bank.base_class[idx].long(), st,
                           W, H)
        imgs, labels = synthesize_batch(bank, idx, draws, out_w=size,
                                        out_h=size, st=st, binary=binary)
        total += step(state, imgs, labels, lr, flag)["loss"]
        objects += (labels.view(batch, -1, 21)[:, :, 1:].abs().sum(-1) > 0
                    ).sum()
        idx = (idx + batch) % n_frames
        if (i + 1) % chunk == 0 or i + 1 == steps:
            n = (i % chunk) + 1
            chunk_losses.append(float(total) / n)
            total.zero_()
            _log(f"steps {i + 1 - n}-{i} lr {lr:g} flag {flag}: mean loss "
                 f"{chunk_losses[-1]:.6g} ({time.perf_counter() - t_train:.1f}"
                 f" s)")
    _sync(device)
    train_s = time.perf_counter() - t_train

    folded = fold_batchnorm(state.model)
    errs = _score(make_serving_fn(spec, folded, pick=("per_class", CONF)),
                  eimgs, egts, extents)
    eimgs_dev = torch.as_tensor(eimgs).to(device)
    int8 = quantize_folded(spec, folded, calibrate_activations(
        spec, folded, eimgs_dev.float() / torch.full((), 255.0,
                                                     device=device),
        per_channel=True))
    errs8 = _score(make_serving_fn(spec, int8, pick=("per_class", CONF),
                                   scales_as_constants=False),
                   eimgs_dev, egts, extents)
    result = {"acc_2d_5px": 100.0 * float((errs <= 5).mean()),
              "acc_2d_10px": 100.0 * float((errs <= 10).mean()),
              "mean_px_err": float(errs.mean()), "eval_n": int(errs.size),
              "int8_acc_2d_5px": 100.0 * float((errs8 <= 5).mean()),
              "int8_acc_2d_10px": 100.0 * float((errs8 <= 10).mean()),
              "int8_mean_px_err": float(errs8.mean()),
              "objects_per_scene": float(objects) / (steps * batch),
              "chunk_losses": chunk_losses, "train_s": train_s,
              "ms_per_step": 1e3 * train_s / steps, "steps": steps,
              "batch": batch, "size": size,
              "frames_per_class": frames_per_class,
              "bank_bytes": bank.nbytes(), "render_s": render_s,
              "bank_put_s": put_s, "fused_stem": ran_fused,
              "wall_s": time.perf_counter() - t0, "device": str(device),
              "card": _card() if device.type == "cuda" else "cpu"}
    _log(f"held out, bf16: 2D@5px {result['acc_2d_5px']:.2f}%, 2D@10px "
         f"{result['acc_2d_10px']:.2f}%, mean px error "
         f"{result['mean_px_err']:.4f} over {result['eval_n']} objects")
    _log(f"held out, int8: 2D@5px {result['int8_acc_2d_5px']:.2f}%, 2D@10px "
         f"{result['int8_acc_2d_10px']:.2f}%, mean px error "
         f"{result['int8_mean_px_err']:.4f}")
    return result


def _score(serve, eimgs, egts, extents) -> np.ndarray:
    """The 2D reprojection error of each held-out object's box of its
    class, served by ``serve`` (one box per class)."""
    boxes = serve(eimgs).float().cpu().numpy()              # (n, 13, 21)
    by_cls = {}
    for b, scene in enumerate(egts):
        for cls, pix in scene:
            by_cls.setdefault(cls, []).append(
                (pix, boxes[b, cls, :18].reshape(9, 2) * [640, 480]))
    errs = []
    for cls, pairs in sorted(by_cls.items()):
        pts = box_points(extents[cls])
        ctx = EvalContext(pts, np.concatenate(
            [pts[1:].T, np.ones((1, 8), np.float32)]), K,
            float(2 * np.linalg.norm(extents[cls])), 640, 480)
        m = pose_metrics(np.stack([p[0] for p in pairs]).astype(np.float32),
                         np.stack([p[1] for p in pairs]).astype(np.float32),
                         ctx)
        errs.extend(np.atleast_1d(m["err_2d"]).tolist())
    return np.asarray(errs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames_per_class", type=int, default=160)
    ap.add_argument("--steps", type=int, default=9000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=int, default=416)
    ap.add_argument("--n_eval", type=int, default=64)
    ap.add_argument("--n_splats", type=int, default=2200)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", help="also write the result JSON here")
    args = ap.parse_args(argv)
    result = run(args.frames_per_class, args.steps, args.batch, args.size,
                 args.n_eval, args.n_splats, args.seed, args.device)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
