#!/usr/bin/env python3
"""Smoke run of the PyTorch port (singleshotpose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                    # from the root of the repository
    python3 chip_smoke.py --profile OUT_DIR  # and where the serve's and the
                                             # train step's time goes

Drives the single-object serving and training paths at full width —
``yolo_pose_single``, ~50.6 M parameters, random weights from a seed —
through the entry points a user calls, in phases; any failure propagates
and the exit code is nonzero:

  1. device: the card's name and power limit; TF32 off for convs and matmuls;
  2. build: the three CUDA sources, one nvcc each, started together
     (``csrc/stem_serve.cu``, ``csrc/max_corner_confidence.cu``,
     ``csrc/stem_train.cu``); K1's, K3's and K6's SASS hold HMMA
     instructions (their products run on the tensor cores);
  3. kernels against plain: each kernel (K1 the serving stem, K2 the max
     corner confidence, K3–K6 the train stem) vs its plain PyTorch version
     at the main paths' shapes (K3–K6 also at a ragged one), error and
     time of both, and its bound; K1's and K3's share of outputs equal to
     the plain version's and their largest difference in bf16 ulps;
  4. model: fold BN, bf16 forward at batch 8, 672²; the stem went through
     the kernel, and the head equals the forward with the plain stem;
  5. serve: ``make_serving_fn`` behind a ``MicroBatcher`` answering 16
     frames from 4 client threads, held to one direct batch-16 call;
     batch-1 latency and batch-8 frames per second;
  6. pose: batched PnP on 64 synthetic LINEMOD poses, and the 6D metrics;
  7. train: ``make_train_step`` at batch 8, 416², bf16, with the fused
     train stem resolved as ``drivers.run_training`` resolves it (on, on a
     card), 20 steps on synthetic frames with labels projected from seeded
     poses; K2–K6 each ran once per step, the loss equals the loss with the
     plain reduction and the loss through the unfused forward; 5 unfused
     steps (the stem's plain PyTorch path, no K3–K6); the fused and the
     unfused step timed in turns; one fixed batch overfits in 30 fused
     steps;
  8. train → serve: the trained weights through the darknet codec, BN fold
     and the serving function; a checkpoint saved and restored on the card.

Phases 4–5 are the serving path and phase 7's fused steps the training
path: each kernel's launch count is set to 0 just before its path and read
just after.  The line before the last is the kernel summary (JSON: each
kernel's launches, error, kernel and plain ms, bound and what sets it); the
last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card;
without one it exits nonzero before any result.  Reads no image files (the
card's machine may lack Pillow) and imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import functools
import itertools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from singleshotpose_tpu_torch import weights as W
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.drivers import (TrainRunConfig,
                                              _resolve_fused_stem,
                                              loss_config_from_spec)
from singleshotpose_tpu_torch.evaluate import (EvalContext, PoseErrors,
                                               accuracy_summary, pose_metrics)
from singleshotpose_tpu_torch.models import darknet
from singleshotpose_tpu_torch.models import layers as L
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import cuda_build, stem, targets
from singleshotpose_tpu_torch.ops import max_corner_confidence as mcc
from singleshotpose_tpu_torch.ops.losses import region_loss
from singleshotpose_tpu_torch.ops.pnp import pnp_batched, so3_exp
from singleshotpose_tpu_torch.serving import MicroBatcher, make_serving_fn
from singleshotpose_tpu_torch.training import (init_train_state,
                                               make_train_step, schedule_lr)
from singleshotpose_tpu_torch.zoo import yolo_pose_single

STEM_SHAPES = ((1, 416, 416), (8, 416, 416), (8, 672, 672))
SIZE = 672            # yolo_pose_single's test size
MODEL_BATCH = 8
N_FRAMES, N_CLIENTS, BUCKETS = 16, 4, (1, 2, 4, 8)
N_POSES = 64
# K2 (B, G, S): the batch-8 416² train step (13² cells), the 832² bucket of
# multi-scale training (26²), the multi-object batch-32 step (13²·5 anchors)
K2_SHAPES = ((8, 50, 169), (8, 50, 676), (32, 50, 845))
TRAIN_SIZE, TRAIN_BATCH = 416, 8      # yolo-pose.cfg's width and batch
TRAIN_STEPS, OVERFIT_STEPS, UNFUSED_STEPS = 20, 30, 5
# K3-K6 (B, H, W): the batch-8 416² train step, the 832² bucket (the
# largest of the multi-scale schedule), and a ragged shape whose 17 x 35
# pooled grid is odd and no multiple of K6's 2 x 16 tiles
TRAIN_STEM_SHAPES = ((8, 416, 416), (8, 832, 832), (3, 34, 70))
GATE_BATCH = 64       # the JAX package's batch gate for the fused stem
TRAIN_EPOCH = 16      # past the 15-epoch pretrain gate: every loss term counts
BATCHES_PER_EPOCH = 125   # ~1,000 LINEMOD training frames / batch 8
# LINEMOD camera (singleshotpose_tpu/zoo.py:152-157) and image size
LINEMOD_K = np.array([[572.4114, 0.0, 325.2611],
                      [0.0, 573.5704, 242.0489],
                      [0.0, 0.0, 1.0]])
IM_W, IM_H = 640, 480
PROFILE_CALLS = 10
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


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


def _bound(nbytes: float, flops: float, peak: float) -> dict:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over ``peak`` (their type's rate), in ms,
    and which of the two sets it."""
    t_bytes, t_ops = nbytes / HBM_BPS * 1e3, flops / peak * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def _sass_report(lib: str, kernel: str):
    """For each compiled instance of ``kernel`` in the built library
    ``lib`` (a template has one for each of its arguments): the start of its
    mangled name, its number of HMMA instructions and its resource usage
    line, read with the toolkit's cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, check=True).stdout

    sections = dump("--dump-sass").split("Function : ")[1:]
    hmma = {sec.split("\n", 1)[0].strip(): sec.count("HMMA")
            for sec in sections if kernel in sec.split("\n", 1)[0]}
    lines = dump("--dump-resource-usage").splitlines()
    usage = {line.split("Function", 1)[1].strip(" :"): lines[i + 1].strip()
             for i, line in enumerate(lines[:-1])
             if "Function" in line and kernel in line}
    return [(name[name.index(kernel):][:len(kernel) + 8], hmma[name],
             usage.get(name, "not found")) for name in sorted(hmma)]


def phase_build() -> None:
    t0 = time.perf_counter()
    paths = cuda_build.build_libraries(
        ["stem_serve", "max_corner_confidence", "stem_train"])
    stem._library()
    mcc._library()
    stem._train_library()
    print(f"[build] {', '.join(paths)} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc per source, in parallel)")
    for tag, lib, kernel in (("K1", paths[0], "stem_serve_kernel"),
                             ("K3", paths[2], "stem_conv_stats_kernel"),
                             ("K6", paths[2], "stem_bwd_dw_kernel")):
        report = _sass_report(lib, kernel)
        for name, hmma, usage in report:
            print(f"[build] {tag} {name}: {hmma} HMMA instructions in its "
                  f"SASS; {usage}")
        _check(report and all(hmma > 0 for _, hmma, _ in report),
               f"{tag}'s product does not run on the tensor cores")


def _bf16_ulps(got: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """|got - ref| in ulps of the bf16 reference: a reference value in
    [2^(e-1), 2^e) has a bf16 ulp of 2^(e-8) (0 takes the smallest, 2^-133).
    A conv output one ulp off becomes many ulps of a small biased output."""
    ref = ref.float()
    _, e = torch.frexp(ref)
    e = torch.where(ref == 0, -125, e.clamp_min(-125))
    return (got.double() - ref.double()).abs() * torch.exp2(8.0 - e.double())


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
        ulps = _bf16_ulps(got, ref)
        ms = _time_ms(lambda: stem.stem_conv_pool_infer(img, w, b))
        plain_ms = _time_ms(lambda: stem.stem_conv_pool_infer_reference(img, w, b))
        print(f"[kernel] stem ({B},{H},{W}): max|d|={max_d:.6g} "
              f"(bound {bound:.6g}), exactly equal {exact:.6%} "
              f"({int((d > 0).sum())} of {d.numel()} differ, "
              f"{int((ulps > 1).sum())} by more than one ulp of the "
              f"reference; at most {float(ulps.max()):.6g} ulps); kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
        _check(max_d <= bound, f"stem kernel max|d| {max_d} > {bound}")
        _check(exact >= 0.99, f"stem kernel exact share {exact} < 0.99")
        # conv MACs on bf16 operands: the tensor cores' rate
        result = {"max_abs_err": max_d, "ms": ms, "plain_ms": plain_ms,
                  **_bound(_nbytes(img, w, b, got), 2 * 27 * 32 * B * H * W,
                           BF16_FLOPS)}
    return result


def _corners_near_gt(dev, B, G, S, gen):
    """GT slots (the first ``n`` of each image valid, as the break rule
    reads them) and per-cell predictions = a slot's GT + noise, so the
    confidences spread over (0, 1)."""
    gt = torch.rand((B, G, 18), generator=gen, device=dev) * 0.8 + 0.1
    n = torch.randint(1, G + 1, (B, 1), generator=gen, device=dev)
    valid = torch.arange(G, device=dev)[None, :] < n
    pick = torch.randint(0, G, (B, S), generator=gen, device=dev) % n
    pred = torch.gather(gt, 1, pick[:, :, None].expand(B, S, 18)) \
        + torch.randn((B, S, 18), generator=gen, device=dev) * 0.03
    return gt, valid, pred


def phase_k2(dev, card: str):
    """K2 vs its plain version.  Returns the numbers of the first shape
    (the main path's batch-8 416² train step)."""
    g = torch.Generator(device=dev).manual_seed(7)
    result = None
    for B, G, S in K2_SHAPES:
        gt, valid, pred = _corners_near_gt(dev, B, G, S, g)
        got = mcc.max_corner_confidence(gt, valid, pred)
        ref = mcc.max_corner_confidence_reference(gt, valid, pred)
        torch.cuda.synchronize()
        d = (got - ref).abs()
        max_d = float(d.max())
        within = bool((d <= 1e-6 + 1e-5 * ref.abs()).all())
        same_mask = bool(torch.equal(got > 0.6, ref > 0.6))
        spread = float(((ref > 0.05) & (ref < 0.95)).float().mean())
        ms = _time_ms(lambda: mcc.max_corner_confidence(gt, valid, pred))
        plain_ms = _time_ms(
            lambda: mcc.max_corner_confidence_reference(gt, valid, pred))
        print(f"[kernel] K2 ({B},{G},{S}): max|d|={max_d:.6g} (rtol 1e-5, "
              f"atol 1e-6: {within}), silenced-cell mask (> 0.6) equal: "
              f"{same_mask}, {float((ref > 0.6).float().mean()):.4f} of cells "
              f"silenced, {spread:.4f} in (0.05, 0.95); kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms [{card}]")
        _check(within, f"K2 off its plain version by {max_d}")
        _check(same_mask, "K2 silences other cells than its plain version")
        if result is None:
            # ~16 f32 operations per (valid slot, cell, keypoint): the
            # distance, its test, the confidence and the running sum
            flops = 16 * 9 * S * float(valid.sum())
            result = {"max_abs_err": max_d, "ms": ms, "plain_ms": plain_ms,
                      **_bound(_nbytes(gt, valid, pred, got), flops,
                               F32_FLOPS)}
    return result


_STEM_KERNELS = (("K3", "stem_conv_stats", "singleshotpose_tpu/ops/stem.py:182"),
                 ("K4", "stem_bn_pool", "singleshotpose_tpu/ops/stem.py:229"),
                 ("K5", "stem_bwd_sums", "singleshotpose_tpu/ops/stem.py:267"),
                 ("K6", "stem_bwd_dw", "singleshotpose_tpu/ops/stem.py:297"))


def _rel(got, ref) -> float:
    return float((got.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-30))


def _stem_bounds(img, w, y, sums, pooled, g, s) -> dict:
    """K3-K6's bounds (``_bound``) for one call on these tensors: K3's
    inputs and outputs, K4-K6's on K3's y, K4's pooled, the gradient g and
    K5's sums."""
    vec, conv = 32 * 4, 2 * 27 * 32 * img.shape[0] * img.shape[1] * \
        img.shape[2]
    return {"stem_conv_stats": _bound(_nbytes(img, w, y, sums), conv,
                                      BF16_FLOPS),
            "stem_bn_pool": _bound(_nbytes(y, pooled) + 2 * vec,
                                   6 * y.numel(), F32_FLOPS),
            "stem_bwd_sums": _bound(_nbytes(y, g, s) + 4 * vec,
                                    16 * y.numel(), F32_FLOPS),
            "stem_bwd_dw": _bound(_nbytes(y, g, img) + 6 * vec + 27 * 32 * 4,
                                  conv, BF16_FLOPS)}


def phase_train_stem(dev, card: str):
    """K3–K6 against their plain versions at TRAIN_STEM_SHAPES: K3 on the
    images, K4–K6 on the plain K3's output with a seeded bf16 gradient.
    Bounds: y and pooled as K1 (≥ 99% equal, max|d| ≤ 1e-2·max|ref| +
    1e-3); the sums of K3 and K5 rel 1e-5 and K6's dW rel 1e-4 of
    max|ref| (the same formulas, f32 sums in another order); K3's y and
    sums and K6's dW the same bits in a second run.  Returns {kernel name:
    numbers} at the main path's shape, the first."""
    results = {}
    for B, H, W in TRAIN_STEM_SHAPES:
        g0 = torch.Generator(device=dev).manual_seed(B + H)
        img = torch.rand((B, H, W, 3), generator=g0, device=dev)
        w = torch.randn((32, 3, 3, 3), generator=g0, device=dev) * 0.3
        scale = torch.rand((32,), generator=g0, device=dev) + 0.5
        bias = torch.randn((32,), generator=g0, device=dev) * 0.1
        n = torch.full((), float(B * H * W), device=dev)
        y_ref, sums_ref = stem.stem_conv_stats_reference(img, w)
        mean = sums_ref[0] / n
        var = sums_ref[1] / n - mean * mean
        inv = scale * torch.rsqrt(var + 1e-4)
        shift = bias - mean * inv
        rstd = torch.rsqrt(var + 1e-4)
        pooled_ref = stem.stem_bn_pool_reference(y_ref, inv, shift)
        g = torch.randn(pooled_ref.shape, generator=g0, device=dev) \
            .to(torch.bfloat16)
        s_ref = stem.stem_bwd_sums_reference(y_ref, g, inv, shift, mean, rstd)
        c1, c2 = inv * s_ref[0] / n, inv * s_ref[1] / n
        bounds = _stem_bounds(img, w, y_ref, sums_ref, pooled_ref, g, s_ref)
        calls = {
            "stem_conv_stats": (
                lambda: stem.stem_conv_stats(img, w),
                lambda: stem.stem_conv_stats_reference(img, w)),
            "stem_bn_pool": (
                lambda: stem.stem_bn_pool(y_ref, inv, shift),
                lambda: stem.stem_bn_pool_reference(y_ref, inv, shift)),
            "stem_bwd_sums": (
                lambda: stem.stem_bwd_sums(y_ref, g, inv, shift, mean, rstd),
                lambda: stem.stem_bwd_sums_reference(y_ref, g, inv, shift,
                                                     mean, rstd)),
            "stem_bwd_dw": (
                lambda: stem.stem_bwd_dw(y_ref, g, img, inv, shift, mean,
                                         rstd, c1, c2),
                lambda: stem.stem_bwd_dw_reference(y_ref, g, img, inv, shift,
                                                   mean, rstd, c1, c2))}
        for tag, name, _ in _STEM_KERNELS:
            kernel, plain = calls[name]
            got, ref = kernel(), plain()
            torch.cuda.synchronize()
            if name == "stem_conv_stats":
                (y, sums), (y_r, sums_r) = got, ref
                d = (y.float() - y_r.float()).abs()
                exact = float((d == 0).float().mean())
                ulps = _bf16_ulps(y, y_r)
                bound = 1e-2 * float(y_r.float().abs().max()) + 1e-3
                err, rel = float(d.max()), _rel(sums, sums_r)
                y2, sums2 = kernel()
                again = torch.equal(y2, y) and torch.equal(sums2, sums)
                # a plain y of exactly 0 (a sum that cancels in F.conv2d's
                # order) makes any residual ~2^133 ulps: counted apart
                zero = y_r == 0
                what = (f"y max|d|={err:.6g} (bound {bound:.6g}), exactly "
                        f"equal {exact:.6%} ({int((d > 0).sum())} of "
                        f"{d.numel()} differ, {int((ulps > 1).sum())} by more "
                        f"than one ulp of the reference, "
                        f"{int((zero & (d > 0)).sum())} of them where it is "
                        f"0; at most {float(ulps[~zero].max()):.6g} ulps "
                        f"where it is not); sums rel {rel:.3g} "
                        f"(bound 1e-5); y and sums the same bits in a second "
                        f"run: {again}")
                ok = err <= bound and exact >= 0.99 and rel <= 1e-5 and again
            elif name == "stem_bn_pool":
                d = (got.float() - ref.float()).abs()
                exact = float((d == 0).float().mean())
                bound = 1e-2 * float(ref.float().abs().max()) + 1e-3
                err = float(d.max())
                what = (f"pooled max|d|={err:.6g} (bound {bound:.6g}), "
                        f"exactly equal {exact:.6%}")
                ok = err <= bound and exact >= 0.99
            else:
                err = float((got - ref).abs().max())
                rel = max(_rel(a, b) for a, b in zip(got, ref)) \
                    if name == "stem_bwd_sums" else _rel(got, ref)
                tol = 1e-5 if name == "stem_bwd_sums" else 1e-4
                what = f"max|d|={err:.6g}, rel {rel:.3g} of max|ref| " \
                       f"(bound {tol:g})"
                ok = rel <= tol
                if name == "stem_bwd_dw":
                    ok = ok and torch.equal(kernel(), got)
            ms = _time_ms(kernel)
            plain_ms = _time_ms(plain)
            print(f"[kernel] {tag} {name} ({B},{H},{W}): {what}; kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms [{card}]")
            _check(ok, f"{tag} {name} off its plain version at ({B},{H},{W})")
            if name not in results:
                results[name] = {"max_abs_err": err, "ms": ms,
                                 "plain_ms": plain_ms, **bounds[name]}
    return results


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


def _train_batches(dev, n: int, seed: int, batch: Optional[int] = None):
    """``n`` batches of synthetic u8 frames (batch, 416, 416, 3) on the
    card, with padded labels (batch, 50·21): one object per frame, its 9
    keypoints projected from a seeded pose with the LINEMOD camera,
    normalized by 640×480.  ``batch`` defaults to TRAIN_BATCH."""
    batch = batch or TRAIN_BATCH
    rng = np.random.RandomState(seed)
    pts, _, _ = _box_points()
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        Rs = so3_exp(torch.from_numpy(rng.randn(batch, 3) * 0.8)).numpy()
        ts = np.stack([rng.uniform(-0.1, 0.1, batch),
                       rng.uniform(-0.1, 0.1, batch),
                       rng.uniform(0.5, 1.5, batch)], axis=1)
        cam = np.einsum("bij,nj->bni", Rs, pts.astype(np.float64)) + ts[:, None]
        uvw = cam @ LINEMOD_K.T
        px = uvw[..., :2] / uvw[..., 2:] / [IM_W, IM_H]          # (B, 9, 2)
        lab = np.zeros((batch, 50, 21), np.float32)
        lab[:, 0, 1:19] = px.reshape(batch, 18)
        lab[:, 0, 19] = np.ptp(px[..., 0], axis=1)
        lab[:, 0, 20] = np.ptp(px[..., 1], axis=1)
        frames = torch.randint(0, 256, (batch, TRAIN_SIZE, TRAIN_SIZE, 3),
                               generator=gen, dtype=torch.uint8)
        out.append((frames.to(dev), torch.from_numpy(
            lab.reshape(batch, -1)).to(dev)))
    return out


def _train_setup(spec, dev, seed: int, fused_stem: bool):
    """A fresh train state, the loss config and a bf16 train step with the
    fused train stem on or off."""
    net = spec.net
    state = init_train_state(_random_model(spec, dev, seed),
                             weight_decay=net.decay * TRAIN_BATCH,
                             momentum=net.momentum)
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=15,
                                im_width=IM_W, im_height=IM_H)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16,
                           fused_stem=fused_stem)
    return state, cfg, step


_TRAIN_COUNTED = (mcc.max_corner_confidence, stem.stem_conv_stats,
                  stem.stem_bn_pool, stem.stem_bwd_sums, stem.stem_bwd_dw)


def _launches():
    """K2–K6's launch counts, in that order."""
    return [f.launches for f in _TRAIN_COUNTED]


def _lr(spec, processed: int) -> float:
    """The darknet schedule's lr for this batch, divided by the batch."""
    net = spec.net
    steps = [s * BATCHES_PER_EPOCH for s in net.steps]
    return schedule_lr(net.learning_rate, processed, steps,
                       net.scales) / TRAIN_BATCH


def _step_ms(step, state, batches, spec, n: int) -> float:
    """Median host-clock ms of ``n`` steps, a sync after each."""
    times = []
    for i in range(n):
        frames, labels = batches[i % len(batches)]
        t = time.perf_counter()
        step(state, frames, labels, _lr(spec, 0), TRAIN_EPOCH)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def phase_train(spec, dev, card: str):
    """The training path: TRAIN_STEPS steps of the full-width net at batch 8,
    416², bf16, with the fused train stem resolved as ``run_training``
    resolves it.  Returns (the trained state, K2–K6's launches in those
    steps, the median step ms)."""
    fused = _resolve_fused_stem(TrainRunConfig(), dev)
    _check(fused, "run_training does not resolve the fused stem on for bf16 "
                  "on a card")
    state, cfg, step = _train_setup(spec, dev, seed=5, fused_stem=fused)
    batches = _train_batches(dev, TRAIN_STEPS, seed=8)
    losses, times = [], []
    copies = stem.stem_conv_bn_pool_train.grad_copies
    torch.cuda.synchronize()
    # the main path: every K2-K6 launch counted from here on came from it
    for f in _TRAIN_COUNTED:
        f.launches = 0
    for i, (frames, labels) in enumerate(batches):
        t = time.perf_counter()
        stats = step(state, frames, labels, _lr(spec, i), TRAIN_EPOCH)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(stats["loss"]))
    launches = _launches()
    copies = stem.stem_conv_bn_pool_train.grad_copies - copies
    step_ms = statistics.median(times[3:])
    print(f"[train] yolo_pose_single {TRAIN_SIZE}² batch {TRAIN_BATCH} bf16, "
          f"fused train stem {fused}, {TRAIN_STEPS} steps, lr "
          f"{_lr(spec, 0):.6g} (darknet lr / batch): losses {losses[0]:.6g} "
          f"... {losses[-1]:.6g}, launches K2-K6 {launches}, incoming-"
          f"gradient copies {copies}, seen {state.seen}; step median "
          f"{step_ms:.4f} ms (host clock, sync each step, steps "
          f"4-{TRAIN_STEPS}), first step {times[0]:.1f} ms [{card}]")
    _check(all(np.isfinite(losses)), f"a train loss is not finite: {losses}")
    _check(launches == [TRAIN_STEPS] * 5,
           f"K2-K6 launched {launches} times in {TRAIN_STEPS} train steps")
    _check(state.seen == TRAIN_STEPS * TRAIN_BATCH, f"seen {state.seen}")

    # one batch's loss: the train-mode head with K2 and with the plain
    # reduction; and through the fused and the unfused forward, whose stem
    # outputs are compared first
    frames, labels = batches[-1]
    with torch.no_grad():
        state.model.train()
        x = frames.float() / 255.0
        c0 = getattr(state.model, spec.layers[0].name)
        pooled, mean, var = stem.stem_conv_bn_pool_train(x, c0.weight,
                                                         c0.scale, c0.bias)
        y = F.conv2d(x.permute(0, 3, 1, 2).to(torch.bfloat16),
                     c0.weight.to(torch.bfloat16), padding=1)
        z, mean_u, var_u = L.batch_norm_train(y, c0.scale, c0.bias)
        pooled_u = L.max_pool(L.leaky_relu(z), 2, 2).permute(0, 2, 3, 1)
        head = state.model(x, torch.bfloat16, fused_stem=True)
        loss_k2, st = region_loss(head, labels, TRAIN_EPOCH, cfg)
        with mock.patch.object(targets, "max_corner_confidence",
                               mcc.max_corner_confidence_reference):
            loss_plain, _ = region_loss(head, labels, TRAIN_EPOCH, cfg)
        loss_unfused, _ = region_loss(
            state.model(x, torch.bfloat16, fused_stem=False), labels,
            TRAIN_EPOCH, cfg)
    d = (pooled.float() - pooled_u.float()).abs()
    same = float((d == 0).float().mean())
    bound = 1e-2 * float(pooled_u.float().abs().max()) + 1e-3
    d_stats = max(float((mean - mean_u).abs().max()),
                  float((var - var_u).abs().max()))
    rel = abs(float(loss_k2) - float(loss_plain)) / abs(float(loss_plain))
    rel_stem = abs(float(loss_k2) - float(loss_unfused)) / \
        abs(float(loss_unfused))
    print(f"[train] stem output, fused vs unfused: exactly equal {same:.6%}, "
          f"max|d|={float(d.max()):.6g} (bound {bound:.6g}), batch mean and "
          f"var max|d|={d_stats:.3g} (f32 sums in another order)")
    print(f"[train] loss with K2 {float(loss_k2):.8g}, with the plain "
          f"reduction {float(loss_plain):.8g}: rel {rel:.3g} (bound 1e-5); "
          f"through the unfused forward {float(loss_unfused):.8g}: rel "
          f"{rel_stem:.3g} (bound 1e-2: bf16 roundings that flip with the "
          f"statistics' last bits, carried through 22 more bf16 layers); nGT "
          f"{int(st['nGT'])}, nCorrect {int(st['nCorrect'])}")
    _check(float(d.max()) <= bound and same >= 0.99,
           "the fused stem's output is off the unfused one")
    _check(rel <= 1e-5, f"K2 loss vs plain-reduction loss rel {rel}")
    _check(rel_stem <= 1e-2, f"fused vs unfused forward loss rel {rel_stem}")

    # the unfused path: the stem's plain PyTorch ops, no K3-K6
    unfused = make_train_step(cfg, compute_dtype=torch.bfloat16,
                              fused_stem=False)
    before = _launches()
    ul = [float(unfused(state, f, l, _lr(spec, 0), TRAIN_EPOCH)["loss"])
          for f, l in batches[:UNFUSED_STEPS]]
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(_launches(), before)]
    print(f"[train] unfused stem, {UNFUSED_STEPS} steps: losses "
          f"{ul[0]:.6g} ... {ul[-1]:.6g}, launches K2-K6 {ran}")
    _check(np.isfinite(ul).all(), f"an unfused loss is not finite: {ul}")
    _check(ran == [UNFUSED_STEPS, 0, 0, 0, 0],
           f"the unfused steps launched K2-K6 {ran} times")

    # the two steps' times in turns, on one state
    turns = {"fused": [], "unfused": []}
    for which in ("fused", "unfused", "unfused", "fused") * 2:
        turns[which].append(_step_ms(step if which == "fused" else unfused,
                                     state, batches, spec, 5))
    print("[train] step ms in turns fused/unfused/unfused/fused x2, median of "
          "5 steps each (host clock, sync each step): " + "; ".join(
              f"{k} " + " ".join(f"{t:.4f}" for t in v)
              for k, v in turns.items()) + f" [{card}]")

    # overfit one fixed batch from a fresh model, stem on
    fit_state, _, fit_step = _train_setup(spec, dev, seed=6, fused_stem=fused)
    frames, labels = batches[0]
    lr = _lr(spec, 0)
    fit = [float(fit_step(fit_state, frames, labels, lr, TRAIN_EPOCH)["loss"])
           for _ in range(OVERFIT_STEPS)]
    print(f"[train] overfit one batch, fused stem, {OVERFIT_STEPS} steps at lr "
          f"{lr:.6g}: loss {fit[0]:.6g} -> {fit[-1]:.6g} (min {min(fit):.6g})")
    _check(np.isfinite(fit).all() and fit[-1] < fit[0],
           f"one batch did not overfit: {fit[0]} -> {fit[-1]}")
    return state, launches, step_ms


def phase_train_to_serve(spec, state, dev) -> None:
    """The trained weights serve; a checkpoint round-trips on the card."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.weights")
        W.save_weights(spec, state.model.state_dict(), path, seen=state.seen)
        header, sd = W.load_weights(spec, path)
        model = Darknet(spec, device=dev)
        model.load_state_dict(sd)
        serve = make_serving_fn(spec, fold_batchnorm(model), pick=("best",))
        gen = torch.Generator().manual_seed(9)
        frames = torch.randint(0, 256, (MODEL_BATCH, TRAIN_SIZE, TRAIN_SIZE, 3),
                               generator=gen, dtype=torch.uint8).to(dev)
        boxes = serve(frames)
        torch.cuda.synchronize()
        print(f"[train->serve] weights file seen={header.seen}; boxes "
              f"{tuple(boxes.shape)}, finite {bool(torch.isfinite(boxes).all())}")
        _check(header.seen == state.seen, "seen lost in the weights file")
        _check(tuple(boxes.shape) == (MODEL_BATCH, 21)
               and bool(torch.isfinite(boxes).all()),
               "the trained weights give no finite boxes")

        ckpt = Checkpointer(os.path.join(tmp, "ckpt"))
        ckpt.save(TRAIN_STEPS, state)
        back, _, _ = _train_setup(spec, dev, seed=11, fused_stem=True)
        step = ckpt.restore(back)
        same = all(torch.equal(a, b) for a, b in zip(
            state.model.state_dict().values(),
            back.model.state_dict().values()))
        bufs = [(state.optimizer.state[p]["momentum_buffer"],
                 back.optimizer.state[q]["momentum_buffer"])
                for p, q in zip(state.model.parameters(),
                                back.model.parameters())]
        same_m = all(torch.equal(a, b) for a, b in bufs)
        print(f"[train->serve] checkpoint step {step}: model equal {same}, "
              f"momentum equal {same_m}, seen {back.seen}")
        _check(step == TRAIN_STEPS and same and same_m
               and back.seen == state.seen, "the checkpoint did not round-trip")


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
    """The family of a device kernel of the serve or the train step, from
    its name (the first rule that matches)."""
    if "stem_serve_kernel" in name:
        return "K1 stem"
    if "max_corner_confidence_kernel" in name:
        return "K2 max corner confidence"
    for kernel, family in (("stem_conv_stats_kernel", "K3 train stem conv"),
                           ("stem_bn_pool_kernel", "K4 train stem BN + pool"),
                           ("stem_bwd_sums_kernel", "K5 train stem sums"),
                           ("stem_bwd_dw_kernel", "K6 train stem dW"),
                           ("reduce_partials_kernel",
                            "K3/K5/K6 partial-sum pass")):
        if kernel in name:
            return family
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "cuDNN layout transposes"
    if any(k in name for k in ("xmma", "nvjet", "cutlass", "gemm",
                               "splitKreduce", "convolve", "dgrad", "wgrad")):
        return "convs (cuDNN, cuBLAS), forward and backward"
    if "max_pool" in name:
        return "max pool, forward and backward"
    if "multi_tensor_apply" in name:
        return "SGD update (foreach)"
    if "reduce_kernel" in name:
        return "reductions (BN statistics, loss sums)"
    if any(k in name for k in ("scatter", "gather", "index")):
        return "scatter, gather, index (targets)"
    if "compare_scalar_kernel" in name or "where_kernel" in name or (
            "MulFunctor" in name and "c10::BFloat16" in name):
        return "leaky (ge, mul, where)"
    if "CUDAFunctor_add<float>" in name:
        return "f32 adds (conv bias)"
    if "CUDAFunctor_add<c10::BFloat16>" in name:
        return "bf16 adds (gradient accumulation)"
    if any(k in name for k in ("BinaryFunctor<float", "UnaryFunctor<float",
                               "MulFunctor<float>", "DivFunctor<float",
                               "pow_tensor", "rsqrt", "sqrt")):
        return "f32 elementwise (BN normalize and its backward, loss)"
    if "bfloat16_copy_kernel" in name or "direct_copy_kernel" in name \
            or "Memcpy DtoD" in name:
        return "dtype casts, copies"
    return "other elementwise, decode, cat, fills, memcpy"


def _device_time(trace_path: str, by_name=None):
    """(device µs by family, busy µs) of a torch.profiler chrome trace; busy
    is the union of the device intervals.  ``by_name``, a Counter, also
    gets the device µs of each kernel name."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    by_family = collections.Counter()
    for e in dev:
        by_family[_family(e["name"])] += e["dur"]
        if by_name is not None:
            by_name[e["name"]] += e["dur"]
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


def phase_profile_k2(dev, card: str, out_dir: str) -> None:
    """K2 and its plain version on the device alone (``--profile``): the
    device time per call from a trace of PROFILE_CALLS calls, beside the
    CUDA-event time per call of phase 3, which also counts the host's work
    when the host is the slower of the two."""
    g = torch.Generator(device=dev).manual_seed(7)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(out_dir, exist_ok=True)
    for B, G, S in K2_SHAPES:
        gt, valid, pred = _corners_near_gt(dev, B, G, S, g)
        for name, fn in (("K2", mcc.max_corner_confidence),
                         ("plain", mcc.max_corner_confidence_reference)):
            fn(gt, valid, pred)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=acts) as prof:
                for _ in range(PROFILE_CALLS):
                    fn(gt, valid, pred)
                torch.cuda.synchronize()
            path = os.path.join(out_dir, f"k2_{name}_{B}_{G}_{S}.json")
            prof.export_chrome_trace(path)
            by_family, busy = _device_time(path)
            print(f"[profile] {name} ({B},{G},{S}): device "
                  f"{sum(by_family.values()) / PROFILE_CALLS:.2f} µs/call in "
                  f"kernels, busy {busy / PROFILE_CALLS:.2f} µs/call [{card}]")


def _profile(fn, calls: int, path: str):
    """Device time by family and busy time of ``calls`` calls of ``fn``
    under torch.profiler (chrome trace to ``path``); also by kernel name."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    by_name = collections.Counter()
    by_family, busy = _device_time(path, by_name)
    return by_family, busy, by_name


def phase_profile_train(spec, dev, card: str, out_dir: str) -> None:
    """Where the train step's time goes (``--profile``), for the fused step
    and, from the same state, the unfused one: the host-clock medians of 20
    steps (sync each step) first, then device time by kernel family over
    PROFILE_CALLS profiled steps and the device's idle share.  Chrome traces
    to ``out_dir``."""
    state, cfg, fused = _train_setup(spec, dev, seed=12, fused_stem=True)
    steps = {"fused": fused, "unfused": make_train_step(
        cfg, compute_dtype=torch.bfloat16, fused_stem=False)}
    batches = itertools.cycle(_train_batches(dev, 4, seed=13))

    def one(step):
        frames, labels = next(batches)
        step(state, frames, labels, _lr(spec, 0), TRAIN_EPOCH)

    host = {k: _host_ms(functools.partial(one, step), iters=20)
            for k, step in steps.items()}
    os.makedirs(out_dir, exist_ok=True)
    for which, step in steps.items():
        path = os.path.join(out_dir, f"train_trace_{which}_b{TRAIN_BATCH}.json")
        by_family, busy, by_name = _profile(functools.partial(one, step),
                                            PROFILE_CALLS, path)
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        print(f"[profile] {which} train step batch {TRAIN_BATCH}, "
              f"{TRAIN_SIZE}², bf16: host clock {host[which]:.4f} ms/step "
              f"(median of 20, sync each step); device busy {busy_ms:.4f} "
              f"ms/step over {PROFILE_CALLS} profiled steps; idle share "
              f"{1 - busy_ms / host[which]:.4f}; trace {path} [{card}]")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/step "
                  f"({us / total:.2%} of device time)")
        if which == "fused":
            for name, us in by_name.most_common(15):
                print(f"[profile]   kernel {us / 1e3 / PROFILE_CALLS:.4f} "
                      f"ms/step [{_family(name)}] {name[:110]}")


def phase_profile_stem(dev, card: str, out_dir: str) -> None:
    """K1 and K3–K6 on the device alone (``--profile``): device µs per call
    of each wrapper (its kernel and, for K3, K5 and K6, the partial-sum
    pass) from a trace of PROFILE_CALLS calls at its main path's shape
    (K1 the serve's batch 8, 672²; K3–K6 the train step's batch 8, 416²),
    beside the kernel's bound and the share of it reached, and the same for
    the plain version."""
    os.makedirs(out_dir, exist_ok=True)
    g0 = torch.Generator(device=dev).manual_seed(21)

    def report(tag, name, which, shape, fn, bound):
        fn()
        torch.cuda.synchronize()
        path = os.path.join(out_dir, f"{name}_{which}.json")
        by_family, busy, _ = _profile(fn, PROFILE_CALLS, path)
        us = sum(by_family.values()) / PROFILE_CALLS
        share = f"{bound['bound_ms'] * 1e3 / us:.2%}" if us else "not measured"
        print(f"[profile] {tag} {name} {which} {shape}: device {us:.2f} "
              f"µs/call in kernels, busy {busy / PROFILE_CALLS:.2f} µs/call; "
              f"bound {bound['bound_ms'] * 1e3:.2f} µs ({bound['bound_by']}),"
              f" {share} of it [{card}]")

    B, H, W = STEM_SHAPES[-1]
    args = (torch.rand((B, H, W, 3), generator=g0, device=dev),
            torch.randn((32, 3, 3, 3), generator=g0, device=dev) * 0.2,
            torch.randn((32,), generator=g0, device=dev) * 0.2)
    out = stem.stem_conv_pool_infer(*args)
    bound = _bound(_nbytes(*args, out), 2 * 27 * 32 * B * H * W, BF16_FLOPS)
    for which, fn in (("kernel", stem.stem_conv_pool_infer),
                      ("plain", stem.stem_conv_pool_infer_reference)):
        report("K1", "stem_conv_pool_infer", which, (B, H, W),
               functools.partial(fn, *args), bound)
    B, H, W = TRAIN_STEM_SHAPES[0]
    img = torch.rand((B, H, W, 3), generator=g0, device=dev)
    w = torch.randn((32, 3, 3, 3), generator=g0, device=dev) * 0.3
    n = torch.full((), float(B * H * W), device=dev)
    y, sums = stem.stem_conv_stats(img, w)
    mean = sums[0] / n
    var = sums[1] / n - mean * mean
    inv = torch.rsqrt(var + 1e-4)
    shift = -mean * inv
    g = torch.randn((B, H // 2, W // 2, 32), generator=g0, device=dev) \
        .to(torch.bfloat16)
    s = stem.stem_bwd_sums(y, g, inv, shift, mean, inv)
    c1, c2 = inv * s[0] / n, inv * s[1] / n
    bounds = _stem_bounds(img, w, y, sums, stem.stem_bn_pool(y, inv, shift),
                          g, s)
    for tag, name, _ in _STEM_KERNELS:
        args = {"stem_conv_stats": (img, w), "stem_bn_pool": (y, inv, shift),
                "stem_bwd_sums": (y, g, inv, shift, mean, inv),
                "stem_bwd_dw": (y, g, img, inv, shift, mean, inv, c1,
                                c2)}[name]
        for which, fn in (("kernel", getattr(stem, name)),
                          ("plain", getattr(stem, name + "_reference"))):
            report(tag, name, which, (B, H, W), functools.partial(fn, *args),
                   bounds[name])


def phase_profile_gate(spec, dev, card: str) -> None:
    """Does the JAX package's batch gate for the fused stem (B < 64) mean
    anything on this card?  The fused and the unfused train step at batch
    GATE_BATCH, 416², in turns; the fused one with the gate lifted for this
    measurement only."""
    state, cfg, fused = _train_setup(spec, dev, seed=14, fused_stem=True)
    unfused = make_train_step(cfg, compute_dtype=torch.bfloat16,
                              fused_stem=False)
    batches = _train_batches(dev, 2, seed=15, batch=GATE_BATCH)
    gate = darknet.stem_supported
    no_batch_gate = functools.partial(
        mock.patch.object, darknet, "stem_supported",
        lambda spec, dtype, shape=None: gate(spec, dtype))
    before = _launches()[1]
    turns = {"fused": [], "unfused": []}
    for which in ("fused", "unfused", "unfused", "fused"):
        with (no_batch_gate() if which == "fused"
              else contextlib.nullcontext()):
            _step_ms(fused if which == "fused" else unfused, state, batches,
                     spec, 1)
            turns[which].append(_step_ms(fused if which == "fused"
                                         else unfused, state, batches, spec,
                                         4))
    ran = _launches()[1] - before
    print(f"[profile] train step batch {GATE_BATCH}, {TRAIN_SIZE}², bf16, "
          f"turns fused/unfused/unfused/fused, median of 4 steps each (host "
          f"clock, sync each step): " + "; ".join(
              f"{k} " + " ".join(f"{t:.4f}" for t in v)
              for k, v in turns.items()) + f" ms; K3 launches {ran} [{card}]")
    _check(ran == 10, f"the fused steps at batch {GATE_BATCH} launched K3 "
                      f"{ran} times, not 10")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                 "on one NVIDIA card.")
    ap.add_argument("--profile", metavar="OUT_DIR",
                    help="after the phases, profile the serve and the fused "
                         "train step: device time by kernel family, idle "
                         "share, K1 against the plain stem in turns, K2-K6 "
                         "and their plain versions on the device, and the "
                         "fused against the unfused step at batch 64; "
                         "chrome traces go to OUT_DIR")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    stem_numbers = phase_kernel(dev, card)
    k2_numbers = phase_k2(dev, card)
    train_stem_numbers = phase_train_stem(dev, card)

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
    state, train_launches, _ = phase_train(spec, dev, card)
    phase_train_to_serve(spec, state, dev)
    if args.profile:
        phase_profile(spec, folded, dev, card, args.profile)
        phase_profile_k2(dev, card, args.profile)
        phase_profile_stem(dev, card, args.profile)
        phase_profile_train(spec, dev, card, args.profile)
        phase_profile_gate(spec, dev, card)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    # no single PyTorch call computes any of these functions: library_ms null
    kernels = [{
        "name": "stem_conv_pool_infer", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/stem_serve.cu",
        "replaces": "singleshotpose_tpu/ops/stem.py:545",
        "launches": launches, **stem_numbers, "library_ms": None}, {
        "name": "max_corner_confidence", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/max_corner_confidence.cu",
        "replaces": "singleshotpose_tpu/ops/pallas_kernels.py:44",
        "launches": train_launches[0], **k2_numbers, "library_ms": None}]
    for (_, name, replaces), n in zip(_STEM_KERNELS, train_launches[1:]):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "singleshotpose_tpu_torch/csrc/stem_train.cu",
            "replaces": replaces, "launches": n, **train_stem_numbers[name],
            "library_ms": None})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
