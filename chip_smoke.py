#!/usr/bin/env python3
"""Smoke run of the PyTorch port (singleshotpose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                    # from the root of the repository
    python3 chip_smoke.py --profile OUT_DIR  # and where the serve's time goes

Drives the single-object serving path at full width — ``yolo_pose_single``,
~50.6 M parameters, 672² frames, random weights from a seed — through the
entry points a user calls, in phases; any failure propagates and the exit
code is nonzero:

  1. device: the card's name and power limit; TF32 off for convs and matmuls;
  2. build: the serving-stem CUDA kernel from ``csrc/stem_serve.cu``;
  3. kernel against plain: the kernel vs its plain PyTorch version at the
     serving shapes, error and time of both;
  4. model: fold BN, bf16 forward at batch 8; the stem went through the
     kernel, and the head equals the forward with the plain stem;
  5. serve: ``make_serving_fn`` behind a ``MicroBatcher`` answering 16
     frames from 4 client threads, held to one direct batch-16 call;
     batch-1 latency and batch-8 frames per second;
  6. pose: batched PnP on 64 synthetic LINEMOD poses, and the 6D metrics.

The line before the last is the kernel summary (JSON); the last line is
``{"ok": true, "device": {...}}``.  Needs one CUDA card; without one it exits
nonzero before any result.  Reads no image files (the card's machine may lack
Pillow) and imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch

from singleshotpose_tpu_torch.evaluate import (EvalContext, PoseErrors,
                                               accuracy_summary, pose_metrics)
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import stem
from singleshotpose_tpu_torch.ops.pnp import pnp_batched, so3_exp
from singleshotpose_tpu_torch.serving import MicroBatcher, make_serving_fn
from singleshotpose_tpu_torch.zoo import yolo_pose_single

STEM_SHAPES = ((1, 416, 416), (8, 416, 416), (8, 672, 672))
SIZE = 672            # yolo_pose_single's test size
MODEL_BATCH = 8
N_FRAMES, N_CLIENTS, BUCKETS = 16, 4, (1, 2, 4, 8)
N_POSES = 64
# LINEMOD camera (singleshotpose_tpu/zoo.py:152-157) and image size
LINEMOD_K = np.array([[572.4114, 0.0, 325.2611],
                      [0.0, 573.5704, 242.0489],
                      [0.0, 0.0, 1.0]])
IM_W, IM_H = 640, 480
PROFILE_CALLS = 10


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of ``fn()`` in ms over ``iters`` runs, with CUDA
    events around each run after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on an NVIDIA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    name = torch.cuda.get_device_name(0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
          f"{name}, {torch.cuda.device_count()} card(s); "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    return smi


def phase_build() -> None:
    t0 = time.perf_counter()
    path = stem.build_library()
    stem._library()
    print(f"[build] {path} in {time.perf_counter() - t0:.2f} s")


def phase_kernel(dev, card: str):
    """Kernel vs plain version at the serving shapes.  Returns the numbers
    of the largest (the main path's batch-8 672² shape)."""
    g = torch.Generator(device=dev).manual_seed(0)
    result = None
    for B, H, W in STEM_SHAPES:
        img = torch.rand((B, H, W, 3), generator=g, device=dev)
        w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.2
        b = torch.randn((32,), generator=g, device=dev) * 0.2
        got = stem.stem_conv_pool_infer(img, w, b)
        ref = stem.stem_conv_pool_infer_reference(img, w, b)
        torch.cuda.synchronize()
        d = (got.float() - ref.float()).abs()
        max_d = float(d.max())
        bound = 1e-2 * float(ref.float().abs().max()) + 1e-3
        exact = float((d == 0).float().mean())
        ms = _time_ms(lambda: stem.stem_conv_pool_infer(img, w, b))
        plain_ms = _time_ms(lambda: stem.stem_conv_pool_infer_reference(img, w, b))
        print(f"[kernel] stem ({B},{H},{W}): max|d|={max_d:.6g} "
              f"(bound {bound:.6g}), exactly equal {exact:.6%}; "
              f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
        _check(max_d <= bound, f"stem kernel max|d| {max_d} > {bound}")
        _check(exact >= 0.99, f"stem kernel exact share {exact} < 0.99")
        result = {"max_abs_err": max_d, "ms": ms, "plain_ms": plain_ms}
    return result


def _random_model(spec, dev, seed: int = 0) -> Darknet:
    """Full-width net with He-scaled random weights and non-trivial BN
    affine terms and running statistics, from a seeded generator.

    The head conv (the one without BN) is scaled down 10× so its raw
    outputs are O(1), as a trained net's keypoint offsets (a few cells) are:
    the head conv's output is bf16, and at |head| ≈ 16 one bf16 ulp (0.0625)
    is already 3e-3 of a corner on the 21-cell grid, above the serve check's
    1e-3."""
    gen = torch.Generator().manual_seed(seed)
    model = Darknet(spec, generator=gen, device=dev)
    with torch.no_grad():
        for m in model.children():
            w = m.weight
            gain = 1.0 if m.spec.batch_normalize else 0.1
            w.copy_(torch.randn(w.shape, generator=gen)
                    * gain * (2.0 / w[0].numel()) ** 0.5)
            n = w.shape[0]
            m.bias.copy_(torch.randn(n, generator=gen) * 0.1)
            if m.spec.batch_normalize:
                m.scale.copy_(torch.rand(n, generator=gen) + 0.5)
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)
    return model


def phase_model(spec, folded, dev) -> None:
    g = torch.Generator(device=dev).manual_seed(1)
    imgs = torch.rand((MODEL_BATCH, SIZE, SIZE, 3), generator=g, device=dev)
    before = stem.stem_conv_pool_infer.launches
    with torch.inference_mode():
        head = apply_folded(spec, folded, imgs, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        ran = stem.stem_conv_pool_infer.launches - before
        # the same forward with the plain stem in place of the kernel
        with mock.patch.object(stem, "stem_conv_pool_infer",
                               stem.stem_conv_pool_infer_reference):
            ref = apply_folded(spec, folded, imgs, compute_dtype=torch.bfloat16)
    want = (MODEL_BATCH, SIZE // 32, SIZE // 32, 20)
    _check(tuple(head.shape) == want, f"head shape {tuple(head.shape)} != {want}")
    _check(bool(torch.isfinite(head).all()), "head has non-finite values")
    d = float((head.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    print(f"[model] yolo_pose_single {SIZE}² batch {MODEL_BATCH} bf16: head "
          f"{tuple(head.shape)}, max|head|={scale:.6g}, stem kernel launches "
          f"{ran}, max|head - head(plain stem)|={d:.6g} (bound {2e-2 * scale:.6g})")
    _check(ran >= 1, "the folded forward did not launch the stem kernel")
    _check(d <= 2e-2 * scale, f"head vs plain-stem head {d} > {2e-2 * scale}")


def phase_serve(spec, folded, dev, card: str) -> np.ndarray:
    """Returns the direct batch-16 boxes (16, 21) on the host."""
    serve = make_serving_fn(spec, folded, pick=("best",))
    gen = torch.Generator().manual_seed(2)
    frames = torch.randint(0, 256, (N_FRAMES, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    direct = serve(frames).cpu().numpy()
    _check(direct.shape == (N_FRAMES, 21), f"boxes shape {direct.shape}")
    _check(bool(np.isfinite(direct).all()), "boxes have non-finite values")

    answers = [None] * N_FRAMES
    with MicroBatcher(serve, height=SIZE, width=SIZE, buckets=BUCKETS) as mb:
        def client(k):
            for i in range(k, N_FRAMES, N_CLIENTS):
                answers[i] = mb.infer(frames[i], timeout=300)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        _check(not any(t.is_alive() for t in threads), "client threads hung")
    got = np.stack([a.numpy() for a in answers])
    conf_d = np.abs(got[:, 18] - direct[:, 18]).max()
    corner_d = np.abs(got[:, :18] - direct[:, :18]).max(axis=1)
    n_close = int((corner_d <= 1e-3).sum())
    print(f"[serve] MicroBatcher {N_CLIENTS} clients x {N_FRAMES} frames vs one "
          f"batch-{N_FRAMES} call: max|d det_conf|={conf_d:.6g}, corners within "
          f"1e-3 for {n_close}/{N_FRAMES} frames (max|d| per frame "
          f"{np.array2string(corner_d, precision=3)})")
    _check(conf_d <= 1e-2, f"det_conf differs by {conf_d}")
    _check(n_close >= N_FRAMES - 1, f"corners close for {n_close} frames only")

    x1 = torch.from_numpy(frames[:1]).to(dev)
    x8 = torch.from_numpy(frames[:8]).to(dev)
    ms1 = _time_ms(lambda: serve(x1))
    ms8 = _time_ms(lambda: serve(x8))
    print(f"[serve] u8 frames on the card -> best boxes, {SIZE}², CUDA events: "
          f"batch 1 {ms1:.4f} ms; batch 8 {ms8:.4f} ms = "
          f"{8e3 / ms8:.1f} frames/s [{card}]")
    return direct


def _box_points():
    """Centroid + 8 corners of an ape-sized box (m), its corners as a
    homogeneous (4, 8) vertex array, and its diameter (the box diagonal)."""
    ext = np.array([0.045, 0.035, 0.04])
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * ext
    pts = np.concatenate([np.zeros((1, 3)), corners]).astype(np.float32)
    verts = np.concatenate([corners, np.ones((8, 1))], axis=1).T
    return pts, verts.astype(np.float32), float(np.linalg.norm(2 * ext))


def phase_pose(dev, served: np.ndarray) -> None:
    rng = np.random.RandomState(3)
    pts, verts, diam = _box_points()
    Rs = so3_exp(torch.from_numpy(rng.randn(N_POSES, 3) * 0.8)).numpy()
    ts = np.stack([rng.uniform(-0.1, 0.1, N_POSES),
                   rng.uniform(-0.1, 0.1, N_POSES),
                   rng.uniform(0.5, 1.5, N_POSES)], axis=1)
    cam = np.einsum("bij,nj->bni", Rs, pts.astype(np.float64)) + ts[:, None]
    uvw = cam @ LINEMOD_K.T
    px = (uvw[..., :2] / uvw[..., 2:]).astype(np.float32)      # (64, 9, 2)

    R, t = pnp_batched(pts, torch.from_numpy(px).to(dev), LINEMOD_K)
    torch.cuda.synchronize()
    R, t = R.double().cpu().numpy(), t.double().cpu().numpy()
    cos = (np.einsum("bij,bij->b", Rs, R) - 1.0) / 2.0
    ang = np.degrees(np.arccos(np.clip(cos, -1.0, 1.0)))
    td = np.linalg.norm(t - ts, axis=1)
    print(f"[pose] pnp_batched on the card, {N_POSES} poses: max angle err "
          f"{ang.max():.6g} deg, max translation err {td.max() * 1e3:.6g} mm")
    _check(ang.max() <= 0.2 and td.max() <= 2e-3, "PnP off the truth")

    ctx = EvalContext(pts, verts, LINEMOD_K.astype(np.float32), diam,
                      IM_W, IM_H)
    errors = PoseErrors()
    errors.extend(pose_metrics(px, px, ctx, device=dev))
    summary = accuracy_summary(errors, ctx.diam)
    print(f"[pose] metrics with the truth as prediction: {summary}")
    for errs, thr in ((errors.errs_2d, 5.0), (errors.errs_3d, 0.1 * ctx.diam),
                      (errors.errs_trans, 0.05), (errors.errs_angle, 5.0),
                      (errors.errs_corner2d, 5.0)):
        _check(bool((np.asarray(errs) <= thr).all()),
               "an accuracy is below 100% on the truth")

    scale = np.tile(np.array([IM_W, IM_H], np.float32), 9)
    pr = (served[:, :18] * scale).reshape(-1, 9, 2)
    m = pose_metrics(px[:len(pr)], pr, ctx, device=dev)
    finite = all(np.isfinite(m[k]).all() for k in
                 ("err_2d", "err_3d", "err_trans", "err_angle", "err_corner2d"))
    print(f"[pose] metrics on the {len(pr)} served boxes (random net): "
          f"mean 2D err {np.mean(m['err_2d']):.6g} px, finite={finite}")
    _check(finite, "metrics on the served boxes are not finite")


def _host_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Median host-clock time of ``fn()`` plus a device sync, in ms."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def _family(name: str) -> str:
    """The serving path's family of a device kernel, from its name."""
    if "stem_serve_kernel" in name:
        return "K1 stem"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "cuDNN layout transposes"
    if any(k in name for k in ("xmma", "nvjet", "cutlass", "gemm", "splitKreduce")):
        return "convs (cuDNN, cuBLAS)"
    if "max_pool" in name:
        return "max pool"
    if "compare_scalar_kernel" in name or "where_kernel" in name or (
            "MulFunctor" in name and "c10::BFloat16" in name):
        return "leaky (ge, mul, where)"
    if "CUDAFunctor_add<float>" in name:
        return "f32 adds (conv bias)"
    if "bfloat16_copy_kernel" in name or "direct_copy_kernel" in name:
        return "dtype casts, copies"
    return "decode, cat, fills, memcpy"


def _device_time(trace_path: str):
    """(device µs by family, busy µs) of a torch.profiler chrome trace; busy
    is the union of the device intervals."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_family = collections.Counter()
    for e in dev:
        by_family[_family(e["name"])] += e["dur"]
    busy, end = 0.0, float("-inf")
    for e in sorted(dev, key=lambda e: e["ts"]):
        stop = e["ts"] + e["dur"]
        if stop > end:
            busy += stop - max(e["ts"], end)
            end = stop
    return by_family, busy


def phase_profile(spec, folded, dev, card: str, out_dir: str) -> None:
    """Where the serve's time goes (``--profile``): device time by kernel
    family over PROFILE_CALLS profiled calls, the device's idle share against
    the unprofiled host-clock median, and the serve with K1 against the same
    serve with the plain stem, in turns.  Every unprofiled timing comes
    before the first profiled call, since the profiler's tracing may slow
    the launches after it.  Chrome traces go to ``out_dir``."""
    serve = make_serving_fn(spec, folded, pick=("best",))
    gen = torch.Generator().manual_seed(4)
    frames = {B: torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=gen,
                               dtype=torch.uint8).to(dev)
              for B in (1, MODEL_BATCH)}
    plain_stem = functools.partial(mock.patch.object, stem, "stem_conv_pool_infer",
                                   stem.stem_conv_pool_infer_reference)
    host_ms = {}
    for B, x in frames.items():
        host_ms[B] = _host_ms(lambda: serve(x))
        turns = {"K1": [], "plain stem": []}
        for which in ("K1", "plain stem", "plain stem", "K1") * 2:
            with (plain_stem() if which == "plain stem"
                  else contextlib.nullcontext()):
                turns[which].append(_time_ms(lambda: serve(x)))
        print(f"[profile] serve batch {B}, CUDA events, median of 20 per turn, "
              f"turns K1/plain/plain/K1 x2: " + "; ".join(
                  f"{k} " + " ".join(f"{t:.4f}" for t in v)
                  for k, v in turns.items()) + f" ms [{card}]")

    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for B, x in frames.items():
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(PROFILE_CALLS):
                serve(x)
            torch.cuda.synchronize()
        path = os.path.join(out_dir, f"serve_trace_b{B}.json")
        prof.export_chrome_trace(path)
        by_family, busy = _device_time(path)
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        print(f"[profile] serve batch {B}, {SIZE}²: host clock {host_ms[B]:.4f} "
              f"ms/call (median of 30, sync each call); device busy "
              f"{busy_ms:.4f} ms/call over {PROFILE_CALLS} profiled calls; "
              f"idle share {1 - busy_ms / host_ms[B]:.4f}; trace {path} [{card}]")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/call "
                  f"({us / total:.2%} of device time)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                 "on one NVIDIA card.")
    ap.add_argument("--profile", metavar="OUT_DIR",
                    help="after the phases, profile the serve: device time "
                         "by kernel family, idle share, and K1 against the "
                         "plain stem in turns; chrome traces go to OUT_DIR")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    stem_numbers = phase_kernel(dev, card)

    spec = yolo_pose_single()
    model = _random_model(spec, dev)
    n_params = sum(t.numel() for t in model.state_dict().values())
    folded = fold_batchnorm(model)
    print(f"[model] yolo_pose_single: {n_params} parameters and BN statistics")
    # the main path: every launch counted from here on came from it
    stem.stem_conv_pool_infer.launches = 0
    phase_model(spec, folded, dev)
    served = phase_serve(spec, folded, dev, card)
    launches = stem.stem_conv_pool_infer.launches
    _check(launches > 0, "the serving path launched no stem kernel")
    phase_pose(dev, served)
    if args.profile:
        phase_profile(spec, folded, dev, card, args.profile)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    print(json.dumps({"kernels": [{
        "name": "stem_conv_pool_infer", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/stem_serve.cu",
        "replaces": "singleshotpose_tpu/ops/stem.py:545",
        "launches": launches, **stem_numbers}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
