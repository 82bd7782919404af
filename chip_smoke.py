#!/usr/bin/env python3
"""Smoke run of the PyTorch port (singleshotpose_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py                    # from the root of the repository
    python3 chip_smoke.py --profile OUT_DIR  # and where the serves' and the
                                             # train steps' time goes, eager
                                             # and captured

Drives the single-object serving and training paths at full width —
``yolo_pose_single``, ~50.6 M parameters, random weights from a seed — and
then the multi-object (OCCLUSION) ones — ``yolo_pose_multi``, 13 classes, 5
anchors, the same backbone — through the entry points a user calls, in
phases; any failure propagates and the exit code is nonzero:

  1. device: the card's name and power limit; TF32 off for convs and matmuls;
  2. build: the four CUDA sources, one nvcc each, started together
     (``csrc/stem_serve.cu``, ``csrc/max_corner_confidence.cu``,
     ``csrc/stem_train.cu``, ``csrc/int8_conv.cu``); K1's, K3's and K6's
     SASS hold HMMA instructions and the int8 conv's IGMMA (their products
     run on the tensor cores, the int8 conv's on wgmma);
  3. kernels against plain: each kernel (K1 the serving stem, K2 the max
     corner confidence, K3–K6 the train stem) vs its plain PyTorch version
     at the main paths' shapes (K1 also at the multi-object serve's batch
     16, 416², and at a rank's batch 4, 672², of phase 18's eval; K3–K6
     also at a ragged shape, at the multi-object step's batch 32, 320² and
     608², and at a rank's batch 4, 416², of phase 18's step; K2 on the train step's own labels, one valid
     slot an image, on nine valid slots an image at the multi-object step's
     416² and 608² shapes, then with 1..50 at three shapes), error and time
     of both, and its bound; K1's and K3's share of outputs equal to the
     plain version's and their largest difference in bf16 ulps; K2's share
     of outputs with the plain version's bits and a SHA-256 of its output;
  4. model: fold BN, bf16 forward at batch 8, 672²; the stem went through
     the kernel, and the head equals the forward with the plain stem;
     ``training.make_eval_forward(model, folded=True)`` gives the same head
     bit for bit, K1 once;
  5. serve: ``make_serving_fn`` behind a ``MicroBatcher`` answering 16
     frames from 4 client threads, held to one direct batch-16 call;
     batch-1 latency and batch-8 frames per second;
  6. pose: batched PnP on 64 synthetic LINEMOD poses, and the 6D metrics;
  7. train: ``make_train_step`` at batch 8, 416², bf16, with the fused
     train stem resolved as ``drivers.run_training`` resolves it (on, on a
     card), 20 steps on synthetic frames with labels projected from seeded
     poses; K2–K6 each ran once per step; K2 on the inputs the last step
     gave it against its plain version, as in phase 3; the loss equals the
     loss with the plain reduction and the loss through the unfused
     forward; 5 unfused steps (the stem's plain PyTorch path, no K3–K6);
     the fused and the unfused step timed in turns; one fixed batch
     overfits in 30 fused steps;
  8. train → serve: the trained weights through the darknet codec, BN fold
     and the serving function; a checkpoint saved and restored on the card;
  9. multi serve: ``make_serving_fn(pick=("per_class", 0.05))`` behind a
     ``MicroBatcher`` at batch 16, 416², u8 frames, a (13, 21) row a
     request; the picks equal a numpy fold of the decoded grid on the host
     (the fallback forced with higher thresholds), and ``("for_class", c,
     th)`` equals ``per_class[:, c]``;
 10. multi train: ``make_train_step`` with ``loss_config_from_spec(
     multi=True)`` at batch 32, bf16, fused stem on, 10 steps at 416² and
     one each at 320² and 608², on frames with 8 or 9 GTs of their classes
     as the scene synthesizer pairs them; K2–K6 once a step; K2 on the
     step's own inputs; the loss checks of phase 7 and a class loss > 0;
 11. captured train: ``drivers._precompile_buckets``, as ``run_training``
     calls it with ``precompile_buckets``, over all 20 ``SINGLE_SCHEDULE``
     widths at batch 8, bf16, fused stem on; capture time and memory
     reserved; K2–K6 recorded once in each graph; from one state 20
     captured steps over widths that change 8 times (416², 224², 832² among
     them) and across the pretrain gate, each batch from host memory
     through ``drivers._to_device``'s pinned, non-blocking copy as the
     trainers feed it, equal 20 eager steps bit for bit (losses and every
     weight, BN statistic and momentum buffer), and a second eager run says
     whether the eager step is deterministic; captured and eager 416²
     steps timed in turns;
 12. captured multi train: the same for ``yolo_pose_multi`` at batch 32
     over the 10 ``MULTI_SCHEDULE`` widths, on phase 10's widths;
 13. aot serve: ``aot_serving`` per bucket of phase 5 behind a
     ``MicroBatcher({bucket: fn}, start=False)``, K1 recorded once in each
     graph, every batch the batcher formed equal bit for bit to the eager
     serve of that batch; batch-1 and batch-8 latency, graph against eager;
     the multi-object per-class serve's graph at batch 16 equal to the eager
     call bit for bit;
 14. device data: a LINEMOD-size corpus rendered in memory (192 640x480
     frames and masks, ~236 MB, and 16 backgrounds; ``data/shaded.py``),
     the loader's image decoder reading the renders: the frame bank on the
     card; 20 batches of 8 through ``Loader(backend="device_bank")`` over
     SINGLE_SCHEDULE's last stage equal to the same draws on the CPU bit for
     bit, images and labels; a 416² bank batch (host clock with a sync, and
     CUDA events) against the host Python backend's on the same frames as
     JPEG files; 10 captured batch-8 416² steps fed from the bank equal to
     10 eager steps on the same batches bit for bit (K2–K6 once a step);
     ``run_validation(transfer="bank")`` equal to ``"rgb"`` on a held-out
     split (K1 once a batch); ``scripts/shaded_accuracy.py`` at 128 train and
     64 held-out frames, 3 epochs;
 15. device synth: a multi-object corpus (13 classes x 16 shaded 640x480
     renders, ~256 MB, 16 backgrounds; ``scripts/shaded_accuracy_multi.py``
     builds it) in a scene bank on the card; batch-32 416² scenes drawn on
     the card, composited on u8 levels (the masks are binary) and in f32,
     equal the CPU's f32 composite from the same draws bit for bit (images
     and labels) at two (attempts, propose_scale); the synth's ms per batch
     (CUDA events, 10 repeats) and objects per scene at attempts 30/16/6 x
     propose_scale 1/4; 10 captured f32 ``yolo_pose_multi`` steps fed from
     it (``drivers._precompile_buckets(image_dtype=float32)``) equal to 10
     eager steps on the same scenes bit for bit (K2–K6 once a step); the
     synth-fed captured step against the captured step on scenes in memory,
     in turns; ``run_training_multi(loader_backend="device_synth",
     precompile_buckets=True)`` for one epoch on the frames as a LINEMOD
     tree (f32 graphs, K2–K6 once in each); the host synthesizer's batch on
     the same frames as files;
 16. int8: the int8 conv (``csrc/int8_conv.cu``) against its plain twin
     (``F.unfold`` + ``torch._int_mm``, then the epilogue's plain ops) bit
     for bit at four odd shapes (the first conv's C_in padded to 4 at an odd
     width, the 4-byte copies, a misaligned input, an odd C_out) in every
     epilogue mode (int32; int8, compute dtype or both; per-channel and
     scalar quantizers, multiply and divide forms, bf16 and f32), a C_in of
     3 refused, and at every int8 conv's shape of the single-object serve at
     batch 8 and 1, 672², and of the multi serve at batch 16, 416², in
     int32 mode and in the layer's epilogue mode; per layer the product's,
     the fused kernel's, the fused twin's and ``_int_mm``'s device ms (a
     CUDA graph of 10 calls) and both bounds; then ``make_serving_fn`` and
     ``aot_serving`` on
     the int8 pytree (``models/quantize.py``, per-channel scales calibrated
     on the batch served): boxes at batch 8 and 1, 672², and the multi
     per-class boxes at batch 16 equal the twin-fed serve's bit for bit,
     eager and graph, every int8 conv launch fused; within JAX's 0.05 of
     the bf16 serve's at its picked cells; int8 and bf16 serves timed in
     turns; ``cli quantize`` on a rendered held-out split, its ``.npz`` =
     the in-memory pytree (tensors and boxes), and
     ``run_validation(quantize=the .npz / True)`` on the card;
 17. export: ``export_serving`` → ``save_exported`` → ``load_serving``
     (``torch.export``; the kernels are the custom ops
     ``ssp::stem_conv_pool_infer`` and ``ssp::int8_conv``):
     ``yolo_pose_single`` bf16 at 672², symbolic batch, best box, exported
     on the card and, the same weights, on the CPU and loaded with
     ``device="cuda"``; ``cli export --quantized`` on phase 16's ``.npz``;
     the multi per-class serve at 416², symbolic batch.  Every loaded
     artifact's boxes at batch 8 and 1 (multi: 16) equal the eager serve's
     bit for bit, the CPU export's the card export's, K1 launched once a
     bf16 call and the int8 conv 22 times a call, all fused; the same in a
     fresh subprocess with jax and the JAX package blocked; the bf16
     artifact behind a ``MicroBatcher`` of one bucket of 16 = one direct
     call bit for bit; export s, MB, load s, and ms a call against the
     eager serve in turns;
 18. data parallel (``parallel/``, spawned ranks): two gloo ranks sharing
     the card (NCCL refuses two ranks on one card), 4 rows each of the
     batch-8 416² bf16 fused step, against one process on the whole batch
     (the first step to the JAX package's bf16 bounds, the ranks the same
     bytes after 3 steps, K2–K6 once a rank a step, the DP step's ms —
     not a DP speed); the stem alone at (8, 416, 416) over the ranks; K2
     on each rank's rows = the global launch's rows bit for bit;
     ``run_validation`` over the ranks at 672² (K1 on each rank) on phase
     14's held-out renders = one process at the ranks' batch bit for bit;
     a batch of 8 of them served whole and as its halves: K1 the same bits,
     the decoded heads before the pick within 0.05, the cells picked and
     the boxes' gap printed; beside them one NCCL rank of ``--dp 1``: its
     step = the step with no group bit for bit; its step captured by
     ``drivers._precompile_buckets`` at three widths (K2–K6 and the step's
     all-reduces recorded once in each graph; capture s and GiB reserved)
     = its eager steps bit for bit over 10 steps across the widths and the
     pretrain gate, by default and with ``init_train_state(decay_bn_bias=
     False)``; the captured and the eager step timed in turns (CUDA
     events) once the gloo ranks are done; ``run_training(group=...,
     precompile_buckets=True)`` for one epoch of phase 14's renders (all
     20 widths captured, every step a replay); ``cli valid --dp 1`` (in
     process) = ``cli valid``.
 20. tensor parallel (run right after 18): two gloo ranks sharing the
     card as a dp=1 × mp=2 grid (``make_dp_group(1, 2)``), each holding
     half of every conv's output channels of ``yolo_pose_single`` (its
     parameter and momentum bytes printed: half the model's); 3 fused
     bf16 steps at batch 8, 416² against one process (the first step to
     the JAX package's bf16 bounds, the state gathered; K2–K6 once a rank
     a step); the folded forward at batch 8, 672², on the grid (K1 on
     conv_1's gathered folded weights) against one process (every cell's
     decoded corners and confidence within 0.05); then the trainers on the
     grid: ``run_training`` for 2 epochs of 2 steps fed by ``device_bank``
     over phase 14's renders (a checkpoint after each epoch, the
     in-training eval after the last; K2–K6 once a rank a step, K1 once a
     rank an eval batch), ``model.weights`` = the gathered state's weights
     and the grid's last checkpoint restored in one process = the gathered
     state, bit for bit; a one-process checkpoint restored on the grid =
     each rank's slices bit for bit; ``run_training_multi`` for 1 step of
     the full-width ``yolo_pose_multi`` at batch 32 fed by ``device_synth``
     over phase 15's renders (finite, the ranks' losses the same bits);
     beside them two gloo ranks as dp=2 × mp=1: each rank's rows of
     ``Loader(group=)``'s ``device_bank`` batches (416², 8) and
     ``device_synth`` batches (416², 32) = those rows of the one-process
     batches on the card, bit for bit; then, where two cards are visible,
     the captured grid: two NCCL ranks on cuda:0 and cuda:1 as a dp=1 ×
     mp=2 grid, the split step captured per width
     (``drivers._precompile_buckets`` at 3 widths; K2–K6 and every
     all-reduce, channel gather and broadcast of an eager step recorded in
     each graph) = the grid's eager steps bit for bit over 10 steps across
     the widths and the pretrain gate; on one card it prints that it did
     not run and why (NCCL takes one rank a card; a gloo grid's step
     cannot be captured);
 19. native: a small corpus written as files (64 train and 16 held-out
     640x480 shaded renders as JPEG, PNG masks, 8 JPEG backgrounds); the
     native C++ decoder (``singleshotpose_tpu_torch/native``) built with
     g++ and its build time printed.  Where it builds: native against
     python train batches of 8 at 416² (host clock, 8 workers; labels
     equal, images within ``tests/test_native.py``'s bounds),
     ``run_training(loader_backend="native")`` for one epoch of eager
     full-width steps (K2–K6 once a step, counted), the frame bank built
     with the native decoder and with PIL (seconds each).  Where it does
     not: g++'s error, ``Loader(backend="native")`` raising it and ``auto``
     resolving to ``python``.  Either way ``run_validation`` at 672² with
     ``transfer="rgb"`` and ``"yuv420"`` (K1 counted in each; without the
     library the planes are encoded from the decoded frames with numpy and
     fed in place of ``drivers._eval_loader``'s); the yuv420 input
     converted on the card = the CPU's conversion bit for bit and within
     the luma/PSNR gate of the rgb input; bytes a batch, and the copy and
     the serve timed both ways in turns.

Phases 4–5 and 9 are the serving paths and phase 7's fused steps and phase
10 the training paths: each kernel's launch count is set to 0 just before
its path and read just after; so are phase 14's eager steps fed from the
bank (K2–K6) and its two evals (K1), and phase 15's eager steps fed from
the synth (K2–K6), phase 16's int8 serves and evals (the int8
conv), phase 17's calls of the loaded artifacts (K1, the int8
conv), in phase 18 each rank's DP steps (K2–K6) and its share of the
DP eval (K1) (and the NCCL rank's graphs: captures and replays), in phase
20 each grid rank's steps (K2–K6) and its eval batch (K1) (and, with two
cards, the captured grid's graphs and replays a rank), and in
phase 19 the native-fed steps (K2–K6) and each
eval (K1).  On the captured paths (11–13) a kernel's
wrapper runs only while a graph records it, so what is counted there is
captures: the graphs that recorded it (and their replays, each of which
launches it once).  The line before the last is the kernel summary (JSON:
each kernel's launches on the single-object and the multi-object paths, its
captures and replays on the captured ones, error, kernel and plain ms,
bound and what sets it);
the last line is ``{"ok": true, "device": {...}}``.  Needs one CUDA card;
without one it exits nonzero before any result.  Reads image files only in
phases 14 and 15, and only when Pillow imports there (to time the host
loader and the host synthesizer, and the shaded script's JPEG round trip),
and in phase 19, which needs Pillow; imports no jax.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import datetime
import functools
import gc
import hashlib
import itertools
import json
import os
import shutil
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
import torch.distributed as dist
import torch.nn.functional as F

from singleshotpose_tpu_torch import weights as W
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.data import pipeline
from singleshotpose_tpu_torch.data.device_synth import (DeviceSynthStatic,
                                                        SynthDraws,
                                                        binary_masks,
                                                        draw_synth,
                                                        synthesize_batch)
from singleshotpose_tpu_torch.data.pipeline import Loader, PoseDataset
from singleshotpose_tpu_torch.data.shaded import BOX_HALF_EXTENTS
from singleshotpose_tpu_torch.data.shaded import PTS as SHADED_PTS
from singleshotpose_tpu_torch.data.shaded import render_frame
from singleshotpose_tpu_torch.data.synth_multi import ADD_OBJS, OCCLUSION_CLASSES
from singleshotpose_tpu_torch.utils.labels import mask_path_from_image
from singleshotpose_tpu_torch.drivers import (TrainRunConfig, _ProfileWindow,
                                              _precompile_buckets,
                                              _resolve_fused_stem,
                                              _to_device,
                                              loss_config_from_spec,
                                              run_training_multi,
                                              run_validation)
from singleshotpose_tpu_torch.evaluate import (EvalContext, PoseErrors,
                                               accuracy_summary, pose_metrics)
from singleshotpose_tpu_torch.models import darknet
from singleshotpose_tpu_torch.models import layers as L
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm,
                                                     shard_folded)
from singleshotpose_tpu_torch.ops import cuda_build, int8_conv, stem, targets
from singleshotpose_tpu_torch.ops import max_corner_confidence as mcc
from singleshotpose_tpu_torch.ops.decode import (DecodedGrid, best_boxes,
                                                 best_boxes_per_class)
from singleshotpose_tpu_torch.ops.losses import region_loss
from singleshotpose_tpu_torch.ops.pnp import pnp_batched, so3_exp
from singleshotpose_tpu_torch.parallel.multihost import initialize_distributed
from singleshotpose_tpu_torch.parallel.sharding import (all_reduce_grads,
                                                        channel_rows,
                                                        free_port,
                                                        make_dp_group,
                                                        shard_host_batch)
from singleshotpose_tpu_torch.data.pipeline import (MULTI_SCHEDULE,
                                                    SINGLE_SCHEDULE)
from singleshotpose_tpu_torch.serving import (MicroBatcher, aot_serving,
                                              make_serving_fn)
from singleshotpose_tpu_torch.training import (gather_train_state,
                                               init_train_state,
                                               make_eval_forward,
                                               make_train_step, schedule_lr,
                                               shard_train_state)
from singleshotpose_tpu_torch.zoo import (occlusion_datacfg, yolo_pose_multi,
                                          yolo_pose_single)

# K1 (B, H, W): the last is the single-object serve's, (16, 416, 416) the
# multi-object serve's, (4, 672, 672) a rank's of phase 18's two-rank eval
STEM_SHAPES = ((1, 416, 416), (8, 416, 416), (16, 416, 416), (4, 672, 672),
               (8, 672, 672))
SIZE = 672            # yolo_pose_single's test size
MODEL_BATCH = 8
N_FRAMES, N_CLIENTS, BUCKETS = 16, 4, (1, 2, 4, 8)
N_POSES = 64
# K2 (B, G, S) with n uniform in 1..G valid slots an image, after the main
# path's own row and the multi-object rows (_k2_rows): the batch-8 416² train
# step (13² cells), the 832² bucket of multi-scale training (26²), the
# multi-object batch-32 step (13²·5 anchors)
K2_SHAPES = ((8, 50, 169), (8, 50, 676), (32, 50, 845))
# the most valid slots a synthesized multi-object frame has: its base object
# and its companions in singleshotpose_tpu/data/synth_multi.py:ADD_OBJS,
# which are 8 for eggbox
MULTI_SLOTS = 9
# K2 (B, G, S) of the multi-object batch-32 step: 5 anchors on the 416² grid
# and on the 608² one, MULTI_SCHEDULE's widest bucket
K2_MULTI_SHAPES = ((32, 50, 845), (32, 50, 1805))
TRAIN_SIZE, TRAIN_BATCH = 416, 8      # yolo-pose.cfg's width and batch
TRAIN_STEPS, OVERFIT_STEPS, UNFUSED_STEPS = 20, 30, 5
# K3-K6 (B, H, W): the batch-8 416² train step, the 832² bucket (the
# largest of the multi-scale schedule), a ragged shape whose 17 x 35 pooled
# grid is odd and no multiple of K6's 2 x 16 tiles, the multi-object
# batch-32 step at MULTI_SCHEDULE's narrowest and widest buckets, and a
# rank's rows of phase 18's two-rank batch-8 step
TRAIN_STEM_SHAPES = ((8, 416, 416), (8, 832, 832), (3, 34, 70),
                     (32, 320, 320), (32, 608, 608), (4, 416, 416))
GATE_BATCH = 64       # the JAX package's batch gate for the fused stem
TRAIN_EPOCH = 16      # past the 15-epoch pretrain gate: every loss term counts
BATCHES_PER_EPOCH = 125   # ~1,000 LINEMOD training frames / batch 8
# LINEMOD camera (singleshotpose_tpu/zoo.py:152-157) and image size
LINEMOD_K = np.array([[572.4114, 0.0, 325.2611],
                      [0.0, 573.5704, 242.0489],
                      [0.0, 0.0, 1.0]])
IM_W, IM_H = 640, 480
# yolo_pose_multi: eval at its width with the reference's eval batch, behind
# a MicroBatcher that pads every batch to it; train at its batch, 416² for
# MULTI_TRAIN_STEPS steps, then one step at each of MULTI_WIDTHS
MULTI_SIZE, MULTI_SERVE_BATCH, MULTI_BUCKETS = 416, 16, (16,)
MULTI_TRAIN_BATCH, MULTI_TRAIN_STEPS, MULTI_WIDTHS = 32, 10, (320, 608)
PROFILE_CALLS = 10
# the captured train phases: every bucket of the trainers' schedules
# captured; then one step a width of a sequence that changes width, across
# the pretrain gate (yolo-pose's 15 epochs; the multi trainer's 0).  Single:
# 416², 224², 832² among 8 changes; multi: phase 10's widths.  The first
# width's captured and eager steps are timed in turns, TIMED_STEPS each.
CAPTURED_SEQUENCE = ((416,) * 4 + (224,) * 2 + (832,) * 2 + (416,) * 3 +
                     (320,) * 2 + (608,) * 2 + (224, 832) + (416,) * 3)
CAPTURED_EPOCHS = (15,) * 10 + (16,) * 10
MULTI_CAPTURED_SEQUENCE = (MULTI_SIZE,) * MULTI_TRAIN_STEPS + MULTI_WIDTHS
MULTI_CAPTURED_EPOCHS = (0,) * 6 + (1,) * 6
TIMED_STEPS = 10
# H100 SXM peaks (NVIDIA's data sheet, dense, at 700 W): HBM bytes/s, bf16
# tensor-core FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _reading_renders(frames):
    """The loaders' decoders reading ``frames`` (path → array) from memory:
    ``pipeline.load_image`` answers from it, and no native decoder is
    found (it reads files)."""
    return mock.patch.multiple(
        pipeline, load_image=frames.__getitem__,
        _native_decoder=lambda n: (None, "the frames are read from memory"))


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


def _sass_report(lib: str, kernel: str, op: str = "HMMA"):
    """For each compiled instance of ``kernel`` in the built library
    ``lib`` (a template has one for each of its arguments): the start of its
    mangled name, its number of ``op`` instructions (HMMA: bf16 tensor-core
    products; IGMMA: int8 warpgroup ones) and its resource usage line, read
    with the
    toolkit's cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")

    def dump(flag):
        return subprocess.run([tool, flag, lib], capture_output=True,
                              text=True, check=True).stdout

    sections = dump("--dump-sass").split("Function : ")[1:]
    hmma = {sec.split("\n", 1)[0].strip(): sec.count(op)
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
        ["stem_serve", "max_corner_confidence", "stem_train", "int8_conv"])
    stem._library()
    mcc._library()
    stem._train_library()
    int8_conv._library()
    print(f"[build] {', '.join(paths)} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc per source, in parallel)")
    for tag, lib, kernel, op in (
            ("K1", paths[0], "stem_serve_kernel", "HMMA"),
            ("K3", paths[2], "stem_conv_stats_kernel", "HMMA"),
            ("K6", paths[2], "stem_bwd_dw_kernel", "HMMA"),
            ("int8 conv", paths[3], "int8_conv_kernel", "IGMMA")):
        report = _sass_report(lib, kernel, op)
        for name, hmma, usage in report:
            print(f"[build] {tag} {name}: {hmma} {op} instructions in its "
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


def _corners_near_gt(dev, B, G, S, gen, n: Optional[int] = None):
    """GT slots (the first ``n`` of each image valid, as the break rule
    reads them; ``n`` uniform in 1..G where None) and per-cell predictions
    = a slot's GT + noise, so the confidences spread over (0, 1)."""
    gt = torch.rand((B, G, 18), generator=gen, device=dev) * 0.8 + 0.1
    n = torch.randint(1, G + 1, (B, 1), generator=gen, device=dev) \
        if n is None else torch.full((B, 1), n, device=dev)
    valid = torch.arange(G, device=dev)[None, :] < n
    pick = torch.randint(0, G, (B, S), generator=gen, device=dev) % n
    pred = torch.gather(gt, 1, pick[:, :, None].expand(B, S, 18)) \
        + torch.randn((B, S, 18), generator=gen, device=dev) * 0.03
    return gt, valid, pred


def _k2_rows(dev):
    """K2's inputs, (label, gt, valid, pred) a row.  First the main path's
    own: the batch-8 416² train step's labels, one LINEMOD object a frame
    (:func:`_linemod_labels`, one valid slot an image, a prefix as
    ``build_targets`` reads it), each of the 13² cells' predictions that GT
    plus noise; then K2_MULTI_SHAPES with MULTI_SLOTS valid slots an image
    (seeds 18, 19); then K2_SHAPES with n uniform in 1..G (seed 7).  The
    inputs the train steps themselves give K2 come from
    :func:`_k2_step_inputs`."""
    lab = torch.from_numpy(_linemod_labels(np.random.RandomState(16),
                                           TRAIN_BATCH)).to(dev)
    gt = lab[:, :, 1:19].contiguous()
    valid = torch.cumprod((lab[:, :, 1] != 0).to(torch.int32), dim=1).bool()
    S = (TRAIN_SIZE // 32) ** 2
    g = torch.Generator(device=dev).manual_seed(17)
    pred = gt[:, :1] + torch.randn((TRAIN_BATCH, S, 18), generator=g,
                                   device=dev) * 0.03
    rows = [("one slot an image", gt, valid, pred)]
    for seed, shape in enumerate(K2_MULTI_SHAPES, start=18):
        g = torch.Generator(device=dev).manual_seed(seed)
        rows.append((f"{MULTI_SLOTS} slots an image",
                     *_corners_near_gt(dev, *shape, g, n=MULTI_SLOTS)))
    g = torch.Generator(device=dev).manual_seed(7)
    for B, G, S in K2_SHAPES:
        rows.append(("n uniform in 1..G", *_corners_near_gt(dev, B, G, S, g)))
    return rows


def _k2_bound(gt, valid, pred, out) -> dict:
    """K2's bound: ~16 f32 operations per (valid slot, cell, keypoint) —
    the distance, its test, the confidence and the running sum — over
    this run's valid slots, against its inputs' and output's bytes."""
    flops = 16 * 9 * pred.shape[1] * float(valid.sum())
    return _bound(_nbytes(gt, valid, pred, out), flops, F32_FLOPS)


def _k2_report(label: str, gt, valid, pred, card: str) -> dict:
    """K2 vs its plain version on one row: error, the silenced-cell mask,
    the share of outputs with the plain version's bits, a SHA-256 of the
    output's bytes (the same seed gives the same inputs in any tree, so two
    trees' kernels compare by it), kernel and plain ms and the bound.
    Returns the numbers of the kernel summary."""
    B, G, _ = gt.shape
    S = pred.shape[1]
    got = mcc.max_corner_confidence(gt, valid, pred)
    ref = mcc.max_corner_confidence_reference(gt, valid, pred)
    torch.cuda.synchronize()
    d = (got - ref).abs()
    max_d = float(d.max())
    within = bool((d <= 1e-6 + 1e-5 * ref.abs()).all())
    same_mask = bool(torch.equal(got > 0.6, ref > 0.6))
    spread = float(((ref > 0.05) & (ref < 0.95)).float().mean())
    exact = float((got == ref).float().mean())
    sha = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
    ms = _time_ms(lambda: mcc.max_corner_confidence(gt, valid, pred))
    plain_ms = _time_ms(
        lambda: mcc.max_corner_confidence_reference(gt, valid, pred))
    bound = _k2_bound(gt, valid, pred, got)
    print(f"[kernel] K2 ({B},{G},{S}) {label}, {int(valid.sum())} valid "
          f"slots: max|d|={max_d:.6g} (rtol 1e-5, atol 1e-6: {within}), "
          f"silenced-cell mask (> 0.6) equal: {same_mask}, "
          f"{float((ref > 0.6).float().mean()):.4f} of cells silenced, "
          f"{spread:.4f} in (0.05, 0.95), {exact:.6%} with the plain "
          f"version's bits; output sha256 {sha}; kernel {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms; bound {bound['bound_ms'] * 1e3:.4f} "
          f"µs ({bound['bound_by']}) [{card}]")
    _check(within, f"K2 off its plain version by {max_d}")
    _check(same_mask, "K2 silences other cells than its plain version")
    return {"max_abs_err": max_d, "ms": ms, "plain_ms": plain_ms, **bound}


def phase_k2(dev, card: str) -> None:
    """K2 vs its plain version (:func:`_k2_report`) on :func:`_k2_rows`."""
    for row in _k2_rows(dev):
        _k2_report(*row, card)


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


def phase_model(spec, model, folded, dev) -> None:
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
        # the same forward through training.make_eval_forward
        before = stem.stem_conv_pool_infer.launches
        fwd_head = make_eval_forward(model, compute_dtype=torch.bfloat16,
                                     folded=True)(imgs)
        torch.cuda.synchronize()
        fwd_ran = stem.stem_conv_pool_infer.launches - before
    want = (MODEL_BATCH, SIZE // 32, SIZE // 32, 20)
    _check(tuple(head.shape) == want, f"head shape {tuple(head.shape)} != {want}")
    _check(bool(torch.isfinite(head).all()), "head has non-finite values")
    d = float((head.float() - ref.float()).abs().max())
    scale = float(ref.float().abs().max())
    print(f"[model] yolo_pose_single {SIZE}² batch {MODEL_BATCH} bf16: head "
          f"{tuple(head.shape)}, max|head|={scale:.6g}, stem kernel launches "
          f"{ran}, max|head - head(plain stem)|={d:.6g} (bound {2e-2 * scale:.6g}); "
          f"make_eval_forward(folded=True): the same head bit for bit "
          f"{_same_bits(fwd_head, head)}, stem kernel launches {fwd_ran}")
    _check(ran >= 1, "the folded forward did not launch the stem kernel")
    _check(_same_bits(fwd_head, head) and fwd_ran == 1,
           f"make_eval_forward(folded=True) is not the folded forward "
           f"({fwd_ran} K1 launches)")
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


def _linemod_labels(rng, batch: int) -> np.ndarray:
    """Padded labels (batch, 50, 21): one object per frame, its 9 keypoints
    projected from a pose drawn from ``rng`` with the LINEMOD camera,
    normalized by 640×480; the other 49 slots empty."""
    pts, _, _ = _box_points()
    Rs = so3_exp(torch.from_numpy(rng.randn(batch, 3) * 0.8)).numpy()
    ts = np.stack([rng.uniform(-0.1, 0.1, batch),
                   rng.uniform(-0.1, 0.1, batch),
                   rng.uniform(0.5, 1.5, batch)], axis=1)
    cam = np.einsum("bij,nj->bni", Rs, pts.astype(np.float64)) + ts[:, None]
    uvw = cam @ LINEMOD_K.T
    px = uvw[..., :2] / uvw[..., 2:] / [IM_W, IM_H]              # (B, 9, 2)
    lab = np.zeros((batch, 50, 21), np.float32)
    lab[:, 0, 1:19] = px.reshape(batch, 18)
    lab[:, 0, 19] = np.ptp(px[..., 0], axis=1)
    lab[:, 0, 20] = np.ptp(px[..., 1], axis=1)
    return lab


def _multi_labels(rng, batch: int) -> np.ndarray:
    """Padded labels (batch, 50, 21) of synthesized OCCLUSION frames, as
    ``data/synth_multi.py`` composes them: a base object of the 13 classes
    (frame 0: eggbox) and every one of its ADD_OBJS companions in a
    shuffled order, since the synthesizer tries each of them and drops one
    only when 30 placements all overlap the scene; so 8 GTs a frame, and
    MULTI_SLOTS for an eggbox frame.  Base first, each with its class id
    and its 9 keypoints projected from a pose drawn from ``rng`` over the
    frame, normalized by 640×480."""
    pts, _, _ = _box_points()
    lab = np.zeros((batch, 50, 21), np.float32)
    for b in range(batch):
        base = "eggbox" if b == 0 else OCCLUSION_CLASSES[rng.randint(13)]
        companions = list(ADD_OBJS[base])
        rng.shuffle(companions)
        objs = [base] + companions
        n = len(objs)
        Rs = so3_exp(torch.from_numpy(rng.randn(n, 3) * 0.8)).numpy()
        ts = np.stack([rng.uniform(-0.25, 0.25, n),
                       rng.uniform(-0.18, 0.18, n),
                       rng.uniform(0.7, 1.2, n)], axis=1)
        cam = np.einsum("bij,nj->bni", Rs, pts.astype(np.float64)) \
            + ts[:, None]
        uvw = cam @ LINEMOD_K.T
        px = uvw[..., :2] / uvw[..., 2:] / [IM_W, IM_H]          # (n, 9, 2)
        lab[b, :n, 0] = [OCCLUSION_CLASSES.index(o) for o in objs]
        lab[b, :n, 1:19] = px.reshape(n, 18)
        lab[b, :n, 19] = np.ptp(px[..., 0], axis=1)
        lab[b, :n, 20] = np.ptp(px[..., 1], axis=1)
    return lab


def _train_batches(dev, n: int, seed: int, batch: Optional[int] = None,
                   size: int = TRAIN_SIZE, labels=_linemod_labels):
    """``n`` batches of synthetic u8 frames (batch, size, size, 3) on the
    card, with padded labels (batch, 50·21) from ``labels(rng, batch)``.
    ``batch`` defaults to TRAIN_BATCH."""
    batch = batch or TRAIN_BATCH
    rng = np.random.RandomState(seed)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(n):
        lab = labels(rng, batch)
        frames = torch.randint(0, 256, (batch, size, size, 3),
                               generator=gen, dtype=torch.uint8)
        out.append((frames.to(dev), torch.from_numpy(
            lab.reshape(batch, -1)).to(dev)))
    return out


def _train_setup(spec, dev, seed: int, fused_stem: bool, multi: bool = False):
    """A fresh train state, the loss config and a bf16 train step with the
    fused train stem on or off; ``multi``: the multi-object trainer's loss
    (the class term, no confidence pretrain)."""
    net = spec.net
    state = init_train_state(_random_model(spec, dev, seed),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=0 if multi else 15,
                                im_width=IM_W, im_height=IM_H, multi=multi)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16,
                           fused_stem=fused_stem)
    return state, cfg, step


def _k2_step_inputs(state, cfg, frames, labels):
    """The (gt, valid, pred) that ``build_targets`` hands K2 in the fused
    train step on this batch: the loss on the train-mode fused forward's
    head, with K2's call recorded (and answered by the plain version)."""
    record = []

    def k2(gt, valid, pred, **kw):
        record.append((gt, valid, pred))
        return mcc.max_corner_confidence_reference(gt, valid, pred, **kw)

    with torch.no_grad(), mock.patch.object(targets, "max_corner_confidence",
                                            k2):
        state.model.train()
        head = state.model(frames.float() / 255.0, torch.bfloat16,
                           fused_stem=True)
        region_loss(head, labels, TRAIN_EPOCH, cfg)
    (row,) = record
    return row


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
                       net.scales) / net.batch


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


def _check_losses(spec, state, cfg, frames, labels, tag: str):
    """One batch's loss: the train-mode head with K2 and with the plain
    reduction (rel 1e-5); and through the fused and the unfused forward
    (rel 1e-2), whose stem outputs are compared first.  Returns the stats of
    the loss with K2."""
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
    print(f"[{tag}] stem output, fused vs unfused: exactly equal {same:.6%}, "
          f"max|d|={float(d.max()):.6g} (bound {bound:.6g}), batch mean and "
          f"var max|d|={d_stats:.3g} (f32 sums in another order)")
    print(f"[{tag}] loss with K2 {float(loss_k2):.8g}, with the plain "
          f"reduction {float(loss_plain):.8g}: rel {rel:.3g} (bound 1e-5); "
          f"through the unfused forward {float(loss_unfused):.8g}: rel "
          f"{rel_stem:.3g} (bound 1e-2: bf16 roundings that flip with the "
          f"statistics' last bits, carried through 22 more bf16 layers); "
          f"class loss {float(st['loss_cls']):.6g}; nGT {int(st['nGT'])}, "
          f"nCorrect {int(st['nCorrect'])}")
    _check(float(d.max()) <= bound and same >= 0.99,
           "the fused stem's output is off the unfused one")
    _check(rel <= 1e-5, f"K2 loss vs plain-reduction loss rel {rel}")
    _check(rel_stem <= 1e-2, f"fused vs unfused forward loss rel {rel_stem}")
    return st


def phase_train(spec, dev, card: str):
    """The training path: TRAIN_STEPS steps of the full-width net at batch 8,
    416², bf16, with the fused train stem resolved as ``run_training``
    resolves it.  Returns (the trained state, K2–K6's launches in those
    steps, the median step ms, K2's numbers on the inputs the last step gave
    it and those inputs)."""
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
    k2_inputs = _k2_step_inputs(state, cfg, *batches[-1])
    k2_numbers = _k2_report("the train step's own inputs", *k2_inputs, card)
    _check_losses(spec, state, cfg, *batches[-1], "train")

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
    return state, launches, step_ms, k2_numbers, k2_inputs


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


def _host_class_picks(decoded, th: float):
    """The per-class picks of a decoded grid, in numpy on the host, in the
    reference's order (``valid_multi.py:118-123``, ``utils_multi.py:
    312-370``): among the cells whose conf (det_conf · max prob) is above
    ``th`` and whose argmax class is the class, the first of highest
    det_conf; where there is none, the sequential fold over the cells that
    adopts a cell when its det_conf and its prob of the class both exceed
    the last adopted cell's.  Returns ((B, C, 2K+3) boxes, (B, C) True
    where a cell was kept)."""
    corners, det, probs = (t.float().cpu().numpy() for t in decoded)
    B, S, C = probs.shape
    cls_max, cls_id = probs.max(-1), probs.argmax(-1)
    conf = det * cls_max
    out = np.empty((B, C, corners.shape[-1] + 3), np.float32)
    kept = np.zeros((B, C), bool)
    for b in range(B):
        bd = np.full(C, -np.inf, np.float32)
        bc = np.full(C, -np.inf, np.float32)
        bi = np.zeros(C, np.int64)
        for i in range(S):
            upd = (det[b, i] > bd) & (probs[b, i] > bc)
            bd = np.where(upd, det[b, i], bd)
            bc = np.where(upd, probs[b, i], bc)
            bi = np.where(upd, i, bi)
        for c in range(C):
            keep = np.flatnonzero((conf[b] > th) & (cls_id[b] == c))
            kept[b, c] = keep.size > 0
            if kept[b, c]:
                i = keep[np.argmax(det[b, keep])]
                out[b, c] = [*corners[b, i], det[b, i], cls_max[b, i], c]
            else:
                out[b, c] = [*corners[b, bi[c]], bd[c], bc[c], c]
    return out, kept


def phase_multi_serve(spec, folded, dev, card: str) -> None:
    """The multi-object serve: ``make_serving_fn(pick=("per_class",
    conf_thresh))`` behind a MicroBatcher that pads every batch to
    MULTI_SERVE_BATCH, on u8 frames at MULTI_SIZE²; each request gets its
    (C, 2K+3) row.  The picks equal the host's fold of the decoded grid at
    the spec's conf_thresh, at a threshold that keeps a cell for a few
    (image, class) pairs only, and at one above every conf (the fallback
    everywhere), and ``("for_class", c, th)`` equals ``per_class[:, c]``."""
    conf_thresh = spec.net.conf_thresh
    serve = make_serving_fn(spec, folded, pick=("per_class", conf_thresh))
    gen = torch.Generator().manual_seed(30)
    frames = torch.randint(0, 256, (MULTI_SERVE_BATCH, MULTI_SIZE, MULTI_SIZE,
                                    3), generator=gen,
                           dtype=torch.uint8).numpy()
    direct = serve(frames).cpu().numpy()
    C, D = spec.num_classes, 2 * spec.num_keypoints + 3
    _check(direct.shape == (MULTI_SERVE_BATCH, C, D),
           f"per-class boxes shape {direct.shape}")
    _check(bool(np.isfinite(direct).all()), "per-class boxes not finite")

    answers = [None] * MULTI_SERVE_BATCH
    with MicroBatcher(serve, height=MULTI_SIZE, width=MULTI_SIZE,
                      buckets=MULTI_BUCKETS) as mb:
        def client(k):
            for i in range(k, MULTI_SERVE_BATCH, N_CLIENTS):
                answers[i] = mb.infer(frames[i], timeout=300)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        _check(not any(t.is_alive() for t in threads), "client threads hung")
    got = np.stack([a.numpy() for a in answers])
    same = int((got == direct).all(-1).sum())
    print(f"[multi serve] yolo_pose_multi {MULTI_SIZE}², MicroBatcher "
          f"(buckets {MULTI_BUCKETS}) {N_CLIENTS} clients x "
          f"{MULTI_SERVE_BATCH} frames, a (C, 2K+3) = {got.shape[1:]} row "
          f"each: {same} of {got.shape[0] * C} (frame, class) boxes equal to "
          f"one batch-{MULTI_SERVE_BATCH} call's")
    _check(got.shape == direct.shape and same == got.shape[0] * C,
           "the MicroBatcher's per-class rows differ from the direct call's")

    x = torch.from_numpy(frames).to(dev)
    decoded = make_serving_fn(spec, folded)(x)
    conf = (decoded.det_conf * decoded.cls_probs.amax(-1)).flatten()
    sparse = float(torch.sort(conf).values[-MULTI_SERVE_BATCH])
    n_kept = n_fallback = 0
    for th in (conf_thresh, sparse, 1.0):
        on_card = best_boxes_per_class(decoded, th).cpu().numpy()
        host, kept = _host_class_picks(decoded, th)
        served = make_serving_fn(spec, folded, pick=("per_class", th))(x) \
            .cpu().numpy()
        one = {c: make_serving_fn(spec, folded, pick=("for_class", c, th))(x)
               .cpu().numpy() for c in (0, 7, C - 1)}
        cls = torch.arange(MULTI_SERVE_BATCH, device=dev) % C
        per_image = make_serving_fn(spec, folded,
                                    pick=("for_class", cls, th))(x)
        n_kept += int(kept.sum())
        n_fallback += int((~kept).sum())
        same = {"host": np.array_equal(on_card, host),
                "served": np.array_equal(served, on_card),
                "for_class": all(np.array_equal(v, served[:, c])
                                 for c, v in one.items()),
                "a class an image": np.array_equal(
                    per_image.cpu().numpy(),
                    served[np.arange(MULTI_SERVE_BATCH), cls.cpu().numpy()])}
        print(f"[multi serve] picks at conf_thresh {th:.6g}: {int(kept.sum())} "
              f"(image, class) pairs kept a cell, {int((~kept).sum())} took "
              f"the fallback fold; on the card = the host's fold: "
              f"{same['host']}; served = on the card: {same['served']}; "
              f"for_class = per_class[:, c] for c in {sorted(one)}: "
              f"{same['for_class']}, and for a class an image: "
              f"{same['a class an image']}")
        _check(all(same.values()),
               f"per-class picks at {th}: equal to the host's fold, the "
               f"served ones, for_class: {same}")
    _check(n_kept > 0 and n_fallback > 0,
           "the picks never kept a cell, or never fell back")

    ms = _time_ms(lambda: serve(x))
    pick_ms = _time_ms(lambda: best_boxes_per_class(decoded, conf_thresh))
    print(f"[multi serve] u8 frames on the card -> per-class boxes, batch "
          f"{MULTI_SERVE_BATCH}, {MULTI_SIZE}², CUDA events: {ms:.4f} ms = "
          f"{MULTI_SERVE_BATCH * 1e3 / ms:.1f} frames/s, the per-class pick "
          f"alone {pick_ms:.4f} ms [{card}]")


def phase_multi_train(spec, dev, card: str):
    """The multi-object training path: ``make_train_step`` with the multi
    loss (``loss_config_from_spec(multi=True)``: the class term) on the
    full-width ``yolo_pose_multi``, bf16, the fused stem resolved as the
    trainers resolve it, MULTI_TRAIN_STEPS steps at batch 32, 416², then
    one at each of MULTI_WIDTHS, on frames whose labels carry 8 or 9 GTs
    (:func:`_multi_labels`).  K2–K6 launch once a step; K2 on the inputs
    the last 416² step gave it against its plain version; the loss checks
    of :func:`_check_losses`, and a class loss above 0.  Returns (K2–K6's
    launches in those steps, the median 416² step ms, K2's numbers and its
    inputs)."""
    fused = _resolve_fused_stem(TrainRunConfig(), dev)
    state, cfg, step = _train_setup(spec, dev, seed=31, fused_stem=fused,
                                    multi=True)
    _check(cfg.with_class_loss and cfg.num_anchors == 5,
           "the multi loss config has no class term or not 5 anchors")
    batches = _train_batches(dev, MULTI_TRAIN_STEPS, seed=32,
                             batch=MULTI_TRAIN_BATCH, size=MULTI_SIZE,
                             labels=_multi_labels)
    wide = [_train_batches(dev, 1, seed=33 + i, batch=MULTI_TRAIN_BATCH,
                           size=w, labels=_multi_labels)[0]
            for i, w in enumerate(MULTI_WIDTHS)]
    losses, cls_losses, times = [], [], []
    torch.cuda.synchronize()
    # the multi main path: every K2-K6 launch counted from here came from it
    for f in _TRAIN_COUNTED:
        f.launches = 0
    for i, (frames, labels) in enumerate(batches + wide):
        t = time.perf_counter()
        stats = step(state, frames, labels, _lr(spec, i), TRAIN_EPOCH)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t) * 1e3)
        losses.append(float(stats["loss"]))
        cls_losses.append(float(stats["loss_cls"]))
    launches = _launches()
    n = MULTI_TRAIN_STEPS + len(MULTI_WIDTHS)
    step_ms = statistics.median(times[3:MULTI_TRAIN_STEPS])
    print(f"[multi train] yolo_pose_multi batch {MULTI_TRAIN_BATCH} bf16, "
          f"fused train stem {fused}, {MULTI_TRAIN_STEPS} steps at "
          f"{MULTI_SIZE}² and one at each of {MULTI_WIDTHS}, lr "
          f"{_lr(spec, 0):.6g}: losses {losses[0]:.6g} ... {losses[-1]:.6g}, "
          f"class losses {cls_losses[0]:.6g} ... {cls_losses[-1]:.6g}, "
          f"launches K2-K6 {launches}, seen {state.seen}; {MULTI_SIZE}² step "
          f"median {step_ms:.4f} ms (host clock, sync each step, steps "
          f"4-{MULTI_TRAIN_STEPS}), first step {times[0]:.1f} ms, " +
          " / ".join(f"{w}² {t:.1f} ms" for w, t in
                     zip(MULTI_WIDTHS, times[MULTI_TRAIN_STEPS:])) +
          f" (first steps at those widths) [{card}]")
    _check(all(np.isfinite(losses)),
           f"a multi train loss is not finite: {losses}")
    _check(all(np.isfinite(cls_losses)) and min(cls_losses) > 0,
           f"a class loss is not finite and positive: {cls_losses}")
    _check(launches == [n] * 5,
           f"K2-K6 launched {launches} times in {n} multi train steps")
    _check(state.seen == n * MULTI_TRAIN_BATCH, f"seen {state.seen}")
    k2_inputs = _k2_step_inputs(state, cfg, *batches[-1])
    slots = k2_inputs[1].sum(1)
    _check(int(slots.min()) == MULTI_SLOTS - 1
           and int(slots.max()) == MULTI_SLOTS,
           f"the multi step gave K2 {slots.tolist()} valid slots an image")
    k2_numbers = _k2_report("the multi step's own inputs", *k2_inputs, card)
    st = _check_losses(spec, state, cfg, *batches[-1], "multi train")
    _check(float(st["loss_cls"]) > 0, "the class term is 0")
    return launches, step_ms, k2_numbers, k2_inputs


_ALL_COUNTED = (stem.stem_conv_pool_infer, *_TRAIN_COUNTED)


class _CountingGraph(torch.cuda.CUDAGraph):
    """A CUDA graph that notes, for each of its captures, how many times
    each kernel's wrapper (K1-K6) ran while it recorded: those launches
    went into the graph, and each of its replays launches them again
    without the wrapper.  ``captured`` holds one K1-K6 list a capture;
    ``replays`` counts the replays of every such graph."""

    captured = []
    replays = 0

    def capture_begin(self, *args, **kwargs):
        self._before = [f.launches for f in _ALL_COUNTED]
        super().capture_begin(*args, **kwargs)

    def capture_end(self):
        super().capture_end()
        _CountingGraph.captured.append(
            [f.launches - b for f, b in zip(_ALL_COUNTED, self._before)])

    def replay(self):
        _CountingGraph.replays += 1
        super().replay()


def _counting_captures():
    """While active, every CUDA graph made through ``torch.cuda.CUDAGraph``
    counts what it recorded (:class:`_CountingGraph`)."""
    _CountingGraph.captured.clear()
    _CountingGraph.replays = 0
    return mock.patch.object(torch.cuda, "CUDAGraph", _CountingGraph)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A float tensor's bits as integers of its width (-0.0 is not 0.0)."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[
        t.element_size()])


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and a.dtype == b.dtype and \
        torch.equal(_bits(a), _bits(b))


def _state_diffs(a, b):
    """Every tensor of two train states whose bits differ — parameters, BN
    running statistics, momentum buffers — as (name, elements differing,
    max|d|), and the number of tensors compared."""
    sa, sb = a.model.state_dict(), b.model.state_dict()
    pairs = [(k, sa[k], sb[k]) for k in sa] + [
        (f"momentum {n}", a.optimizer.state[p]["momentum_buffer"],
         b.optimizer.state[q]["momentum_buffer"])
        for (n, p), q in zip(a.model.named_parameters(), b.model.parameters())]
    diffs = [(name, int((_bits(x) != _bits(y)).sum()),
              float((x.float() - y.float()).abs().max()))
             for name, x, y in pairs if not _same_bits(x, y)]
    return diffs, len(pairs)


def _scribble(dev) -> None:
    """Fill freed memory the allocator keeps with NaNs: a graph that reads
    a tensor nothing holds any more then computes NaNs, where it might
    otherwise still find the old values."""
    gc.collect()
    junk = [torch.full((n,), float("nan"), device=dev)
            for n in (1, 64, 4096, 1 << 18, 1 << 22) for _ in range(64)]
    del junk


def _run_steps(step, state, batches, epochs, spec, dev) -> torch.Tensor:
    """``step`` over host ``batches``, each copied to the card as the
    trainers copy it (``drivers._to_device``: pinned, non-blocking, no
    sync between steps), with the darknet lr of each batch and ``epochs``;
    the losses, on the card."""
    return torch.stack([
        step(state, _to_device(frames, dev), _to_device(labels, dev),
             _lr(spec, i), epoch)["loss"]
        for i, ((frames, labels), epoch) in enumerate(zip(batches, epochs))])


def phase_captured_train(spec, dev, card: str, tag: str, *, seed: int,
                         batch: int, widths, sequence, epochs, labels,
                         multi: bool = False) -> dict:
    """The train step captured per multi-scale bucket by
    ``drivers._precompile_buckets``, as ``run_training`` builds it with
    ``precompile_buckets``, against the eager step, on full-width ``spec``,
    bf16, the fused stem on: one graph for each of ``widths``, K2–K6
    recorded once in each; then from one state the captured steps, the
    eager steps and the eager steps again over ``sequence`` (one width a
    step) and ``epochs`` (across the pretrain gate), with the same host
    batches through ``drivers._to_device`` and the same lr.  The captured
    steps' losses and every weight, BN statistic and momentum buffer must
    have the eager steps' bits; the second eager run says whether the eager
    step itself is deterministic.  Then the captured and the eager step at
    ``sequence[0]`` in turns.  Returns the numbers of the kernel summary:
    captures and replays."""
    fused = _resolve_fused_stem(TrainRunConfig(), dev)
    (cap_state, _, cap_step), (eager_state, _, step), (again_state, _, _) = \
        (_train_setup(spec, dev, seed, fused, multi) for _ in range(3))
    host = torch.device("cpu")
    batches = [tuple(t.numpy() for t in _train_batches(
        host, 1, seed=seed * 100 + i, batch=batch, size=w, labels=labels)[0])
               for i, w in enumerate(sequence)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    with _counting_captures():
        captured = _precompile_buckets(cap_step, cap_state, widths, batch,
                                       spec.num_keypoints)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    # as run_training leaves it: only the captured step holds the step
    del cap_step
    _scribble(dev)
    per_graph = [c[1:] for c in _CountingGraph.captured]
    reserved = torch.cuda.memory_reserved(dev)
    each = sorted(captured.capture_seconds.values())
    print(f"[{tag}] {len(widths)} widths {min(widths)}-{max(widths)} captured "
          f"at batch {batch} in {capture_s:.2f} s ({each[0]:.3f}-{each[-1]:.3f}"
          f" s a width: warm-up steps and capture); memory reserved "
          f"{reserved / 2**30:.2f} GiB, most allocated while capturing "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB; K2-K6 "
          f"recorded in each graph: {per_graph[0]} "
          f"(all {len(per_graph)} alike: "
          f"{all(c == per_graph[0] for c in per_graph)}) [{card}]")
    _check(tuple(captured.capture_seconds) ==
           tuple((batch, w, w, 3) for w in widths),
           f"captured shapes {tuple(captured.capture_seconds)}")
    _check(per_graph == [[1] * 5] * len(widths),
           f"K2-K6 were not recorded once in each graph: {per_graph}")

    for f in _TRAIN_COUNTED:
        f.launches = 0
    cap_losses = _run_steps(captured, cap_state, batches, epochs, spec, dev)
    wrapped = _launches()
    eager_losses = _run_steps(step, eager_state, batches, epochs, spec, dev)
    again_losses = _run_steps(step, again_state, batches, epochs, spec, dev)
    torch.cuda.synchronize()
    replays = captured.replays
    cap_diffs, n_tensors = _state_diffs(cap_state, eager_state)
    eager_diffs, _ = _state_diffs(again_state, eager_state)
    same_losses = _same_bits(cap_losses, eager_losses)
    changes = sum(a != b for a, b in zip(sequence, sequence[1:]))
    print(f"[{tag}] {len(sequence)} steps, {changes} width changes "
          f"({' '.join(map(str, sequence))}), epochs {epochs[0]}->{epochs[-1]}"
          f": {replays} replays (K2-K6 wrappers ran {wrapped} times in them);"
          f" losses {float(cap_losses[0]):.8g} ... "
          f"{float(cap_losses[-1]):.8g}; captured = eager bit for bit: "
          f"losses {same_losses}, {n_tensors - len(cap_diffs)} of {n_tensors}"
          f" state tensors; eager = eager again: losses "
          f"{_same_bits(again_losses, eager_losses)}, "
          f"{n_tensors - len(eager_diffs)} of {n_tensors} tensors [{card}]")
    for name, n, d in cap_diffs[:10]:
        print(f"[{tag}]   captured != eager: {name}: {n} elements, "
              f"max|d| {d:.6g}")
    for name, n, d in eager_diffs[:10]:
        print(f"[{tag}]   eager != eager again: {name}: {n} elements, "
              f"max|d| {d:.6g}")
    if not same_losses:
        d = (cap_losses - eager_losses).abs()
        print(f"[{tag}]   losses differ at steps "
              f"{torch.nonzero(d).flatten().tolist()}, max|d| {float(d.max())}")
    _check(wrapped == [0] * 5, f"a replay ran a kernel's wrapper: {wrapped}")
    _check(replays == len(sequence), f"{replays} replays")
    _check(same_losses and not cap_diffs,
           "the captured steps do not give the eager steps' bits")
    _check(bool(torch.isfinite(cap_losses).all()), "a captured loss is not "
                                                   "finite")

    # the two steps at the first width, in turns, each on its own state
    first = [(_to_device(f, dev), _to_device(t, dev))
             for (f, t), w in zip(batches, sequence) if w == sequence[0]]
    turns = {"captured": [], "eager": []}
    for which in ("captured", "eager", "eager", "captured") * 2:
        turns[which].append(_step_ms(
            captured if which == "captured" else step,
            cap_state if which == "captured" else eager_state, first, spec,
            TIMED_STEPS))
    print(f"[{tag}] {sequence[0]}² step ms in turns captured/eager/eager/"
          f"captured x2, median of {TIMED_STEPS} steps each (host clock, sync "
          f"each step): " + "; ".join(
              f"{k} " + " ".join(f"{t:.4f}" for t in v)
              for k, v in turns.items()) + f" [{card}]")
    return {"captures": len(per_graph), "replays": replays}


def phase_aot_serve(spec, folded, dev, card: str, multi, multi_folded):
    """``aot_serving`` per bucket behind a ``MicroBatcher({bucket: fn},
    start=False)``: at SIZE², one graph for each of BUCKETS, K1 recorded
    once in each; 16 frames from 4 clients, each batch the batcher formed
    equal bit for bit to the eager serve on that batch, and the answers
    held to one eager batch-16 call as phase 5 holds them (cuDNN picks its
    convs by batch size); each graph on its bucket's first frames equal to
    the eager call bit for bit; batch-1 and batch-8 latency, graph against
    eager, in turns.  Then ``yolo_pose_multi``'s per-class serve at
    MULTI_SERVE_BATCH, MULTI_SIZE², behind a batcher of that one bucket,
    equal bit for bit to the eager batch-16 call.  Returns (K1's captures
    and replays on the single-object and on the multi-object serve)."""
    serve = make_serving_fn(spec, folded, pick=("best",))
    with _counting_captures():
        fns = {b: aot_serving(spec, folded, batch=b, width=SIZE, height=SIZE)
               for b in BUCKETS}
    _scribble(dev)
    per_graph = [c[0] for c in _CountingGraph.captured]
    _check(per_graph == [1] * len(BUCKETS),
           f"K1 was not recorded once in each serve graph: {per_graph}")
    gen = torch.Generator().manual_seed(50)
    frames = torch.randint(0, 256, (N_FRAMES, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).numpy()
    ran = []        # (padded batch, the graph's answer) per batcher call

    def recorded(b):
        def fn(imgs):
            out = fns[b](imgs)
            ran.append((imgs.copy(), out))
            return out
        return fn

    answers = [None] * N_FRAMES
    # captured above, before the batcher's threads start
    mb = MicroBatcher({b: recorded(b) for b in BUCKETS}, height=SIZE,
                      width=SIZE, buckets=BUCKETS, start=False)
    with mb:
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
    same = [_same_bits(out, serve(imgs)) for imgs, out in ran]
    got = np.stack([a.numpy() for a in answers])
    direct = serve(frames).cpu().numpy()
    conf_d = np.abs(got[:, 18] - direct[:, 18]).max()
    n_close = int((np.abs(got[:, :18] - direct[:, :18]).max(axis=1)
                   <= 1e-3).sum())
    alone = {}
    for b, fn in fns.items():
        x = torch.from_numpy(frames[:b]).to(dev)
        alone[b] = _same_bits(fn(x), serve(x))
    print(f"[aot serve] yolo_pose_single {SIZE}²: a graph for each of buckets "
          f"{BUCKETS}, K1 recorded once in each ({per_graph}); MicroBatcher "
          f"{N_CLIENTS} clients x {N_FRAMES} frames in batches of "
          f"{[len(imgs) for imgs, _ in ran]}: each graph call = the eager "
          f"serve of its batch bit for bit: {same}; answers vs one eager "
          f"batch-{N_FRAMES} call: bit for bit "
          f"{bool(np.array_equal(got, direct))}, max|d det_conf| {conf_d:.6g}, "
          f"corners within 1e-3 for {n_close}/{N_FRAMES}; each graph on its "
          f"bucket's first frames = eager: {alone}")
    _check(all(same) and all(alone.values()),
           "a serve graph's answer differs from the eager serve's")
    _check(conf_d <= 1e-2 and n_close >= N_FRAMES - 1,
           "the graphs' answers are off the batch-16 call's")

    turns = {}
    for b in (1, 8):
        x = torch.from_numpy(frames[:b]).to(dev)
        turns[b] = {"graph": [], "eager": []}
        for which in ("graph", "eager", "eager", "graph"):
            fn = fns[b] if which == "graph" else serve
            turns[b][which].append(_time_ms(functools.partial(fn, x)))
    print(f"[aot serve] u8 frames on the card -> best boxes, {SIZE}², CUDA "
          f"events, median of 20 per turn, turns graph/eager/eager/graph: " +
          "; ".join(f"batch {b}: " + ", ".join(
              f"{k} " + " ".join(f"{t:.4f}" for t in v)
              for k, v in tv.items()) for b, tv in turns.items()) +
          f" ms [{card}]")

    conf_thresh = multi.net.conf_thresh
    pick = ("per_class", conf_thresh)
    with _counting_captures():
        mfn = aot_serving(multi, multi_folded, batch=MULTI_SERVE_BATCH,
                          width=MULTI_SIZE, height=MULTI_SIZE, pick=pick)
    _scribble(dev)
    _check([c[0] for c in _CountingGraph.captured] == [1],
           "K1 was not recorded once in the multi serve graph")
    mserve = make_serving_fn(multi, multi_folded, pick=pick)
    gen = torch.Generator().manual_seed(51)
    mframes = torch.randint(0, 256, (MULTI_SERVE_BATCH, MULTI_SIZE,
                                     MULTI_SIZE, 3), generator=gen,
                            dtype=torch.uint8).numpy()
    mb = MicroBatcher({MULTI_SERVE_BATCH: mfn}, height=MULTI_SIZE,
                      width=MULTI_SIZE, buckets=MULTI_BUCKETS, start=False)
    futs = [mb.submit(f) for f in mframes]     # queued: one batch of 16
    with mb:
        mgot = torch.stack([f.result(timeout=300) for f in futs])
    mdirect = mserve(mframes).cpu()
    x = torch.from_numpy(mframes).to(dev)
    mturns = {"graph": [], "eager": []}
    for which in ("graph", "eager", "eager", "graph"):
        mturns[which].append(_time_ms(functools.partial(
            mfn if which == "graph" else mserve, x)))
    print(f"[aot serve] yolo_pose_multi per-class {MULTI_SIZE}² batch "
          f"{MULTI_SERVE_BATCH}, one graph (K1 recorded once), MicroBatcher "
          f"of 16 queued frames: = the eager batch-16 call bit for bit: "
          f"{_same_bits(mgot, mdirect)}; CUDA events, turns graph/eager/"
          f"eager/graph: " + ", ".join(
              f"{k} " + " ".join(f"{t:.4f}" for t in v)
              for k, v in mturns.items()) + f" ms [{card}]")
    _check(_same_bits(mgot, mdirect),
           "the multi serve graph's boxes differ from the eager call's")
    return {"captures": len(per_graph),
            "replays": sum(fn.replays for fn in fns.values()),
            "captures_multi": 1, "replays_multi": mfn.replays}


def _free() -> None:
    """Return what the phases before dropped (graphs, their pools, states)
    to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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
    if "int8_conv_kernel" in name:
        return "int8 conv kernel"
    if "<double" in name or "double>" in name:
        return "f64 elementwise (exact FMAs: the int8 dequant, the synth)"
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


def phase_profile_k2(dev, card: str, out_dir: str, step_rows) -> None:
    """K2 and its plain version on the device alone (``--profile``), on the
    train steps' own inputs (``step_rows``, (label, gt, valid, pred) from
    :func:`phase_train` and :func:`phase_multi_train`) and
    :func:`_k2_rows`: the device time per call from a trace of
    PROFILE_CALLS calls and K2's share of its bound, beside the CUDA-event
    time per call of phase 3, which also counts the host's work when the
    host is the slower of the two."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    os.makedirs(out_dir, exist_ok=True)
    rows = [*step_rows, *_k2_rows(dev)]
    for i, (label, gt, valid, pred) in enumerate(rows):
        B, G, _ = gt.shape
        S = pred.shape[1]
        for name, fn in (("K2", mcc.max_corner_confidence),
                         ("plain", mcc.max_corner_confidence_reference)):
            out = fn(gt, valid, pred)
            torch.cuda.synchronize()
            path = os.path.join(out_dir, f"k2_{name}_row{i}_{B}_{G}_{S}.json")
            # a trace can come back without the device's events; take another
            for attempt in range(1, 4):
                with torch.profiler.profile(activities=acts) as prof:
                    for _ in range(PROFILE_CALLS):
                        fn(gt, valid, pred)
                    torch.cuda.synchronize()
                prof.export_chrome_trace(path)
                by_family, busy = _device_time(path)
                if by_family:
                    break
            _check(bool(by_family), f"no device event in 3 traces of {name} "
                                    f"({B},{G},{S}) {label}")
            us = sum(by_family.values()) / PROFILE_CALLS
            bound = _k2_bound(gt, valid, pred, out)
            print(f"[profile] {name} ({B},{G},{S}) {label}: device {us:.2f} "
                  f"µs/call in kernels, busy {busy / PROFILE_CALLS:.2f} "
                  f"µs/call (trace {attempt} of 3); bound "
                  f"{bound['bound_ms'] * 1e3:.4f} µs ({bound['bound_by']}), "
                  f"{bound['bound_ms'] * 1e3 / us:.2%} of it [{card}]")


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
    pass) from a trace of PROFILE_CALLS calls at its main paths' shapes
    (K1 the serve's batch 8, 672², and the multi-object serve's batch 16,
    416²; K3–K6 the train step's batch 8, 416², and the multi-object
    step's batch 32 at 320² and 608²), beside the kernel's bound and the
    share of it reached, and the same for the plain version."""
    os.makedirs(out_dir, exist_ok=True)
    g0 = torch.Generator(device=dev).manual_seed(21)

    def report(tag, name, which, shape, fn, bound):
        fn()
        torch.cuda.synchronize()
        path = os.path.join(out_dir, f"{name}_{which}_" +
                            "_".join(map(str, shape)) + ".json")
        by_family, busy, _ = _profile(fn, PROFILE_CALLS, path)
        us = sum(by_family.values()) / PROFILE_CALLS
        share = f"{bound['bound_ms'] * 1e3 / us:.2%}" if us else "not measured"
        print(f"[profile] {tag} {name} {which} {shape}: device {us:.2f} "
              f"µs/call in kernels, busy {busy / PROFILE_CALLS:.2f} µs/call; "
              f"bound {bound['bound_ms'] * 1e3:.2f} µs ({bound['bound_by']}),"
              f" {share} of it [{card}]")

    for B, H, W in (STEM_SHAPES[-1], (MULTI_SERVE_BATCH, MULTI_SIZE,
                                      MULTI_SIZE)):
        args = (torch.rand((B, H, W, 3), generator=g0, device=dev),
                torch.randn((32, 3, 3, 3), generator=g0, device=dev) * 0.2,
                torch.randn((32,), generator=g0, device=dev) * 0.2)
        out = stem.stem_conv_pool_infer(*args)
        bound = _bound(_nbytes(*args, out), 2 * 27 * 32 * B * H * W,
                       BF16_FLOPS)
        for which, fn in (("kernel", stem.stem_conv_pool_infer),
                          ("plain", stem.stem_conv_pool_infer_reference)):
            report("K1", "stem_conv_pool_infer", which, (B, H, W),
                   functools.partial(fn, *args), bound)
    for B, H, W in (TRAIN_STEM_SHAPES[0], *TRAIN_STEM_SHAPES[3:5]):
        _profile_train_stem(dev, g0, B, H, W, report)


def _profile_train_stem(dev, g0, B, H, W, report) -> None:
    """K3–K6 and their plain versions at (B, H, W) through ``report``."""
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


def phase_profile_multi(spec, folded, dev, card: str, out_dir: str) -> None:
    """Where the multi-object serve's and train step's time goes
    (``--profile``): the per-class serve at batch MULTI_SERVE_BATCH and the
    fused batch-32 416² train step, each its host-clock median (sync each
    call) first, then device time by kernel family over PROFILE_CALLS
    profiled calls and the device's idle share against that median."""
    os.makedirs(out_dir, exist_ok=True)
    serve = make_serving_fn(spec, folded,
                            pick=("per_class", spec.net.conf_thresh))
    gen = torch.Generator().manual_seed(40)
    x = torch.randint(0, 256, (MULTI_SERVE_BATCH, MULTI_SIZE, MULTI_SIZE, 3),
                      generator=gen, dtype=torch.uint8).to(dev)
    state, _, step = _train_setup(spec, dev, seed=41, fused_stem=True,
                                  multi=True)
    batches = itertools.cycle(_train_batches(
        dev, 4, seed=42, batch=MULTI_TRAIN_BATCH, size=MULTI_SIZE,
        labels=_multi_labels))

    def one_step():
        frames, labels = next(batches)
        step(state, frames, labels, _lr(spec, 0), TRAIN_EPOCH)

    calls = {f"per-class serve batch {MULTI_SERVE_BATCH}": lambda: serve(x),
             f"fused train step batch {MULTI_TRAIN_BATCH}": one_step}
    host = {k: _host_ms(fn, iters=20) for k, fn in calls.items()}
    for i, (what, fn) in enumerate(calls.items()):
        path = os.path.join(out_dir, f"multi_trace_{i}.json")
        by_family, busy, by_name = _profile(fn, PROFILE_CALLS, path)
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        print(f"[profile] multi {what}, {MULTI_SIZE}², bf16: host clock "
              f"{host[what]:.4f} ms/call (median of 20, sync each call); "
              f"device busy {busy_ms:.4f} ms/call over {PROFILE_CALLS} "
              f"profiled calls; idle share {1 - busy_ms / host[what]:.4f}; "
              f"trace {path} [{card}]")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/call "
                  f"({us / total:.2%} of device time)")
        for name, us in by_name.most_common(8):
            print(f"[profile]   kernel {us / 1e3 / PROFILE_CALLS:.4f} "
                  f"ms/call [{_family(name)}] {name[:110]}")


def phase_profile_captured(spec, folded, dev, card: str, out_dir: str) -> None:
    """The captured paths' idle share (``--profile``): the batch-8 416² train
    step captured at that width by ``drivers._precompile_buckets`` (from
    phase_profile_train's seeds, so its eager numbers stand beside these)
    and the batch-1 SIZE² graph serve, each its host-clock median (sync each
    call) first, then device time over PROFILE_CALLS profiled calls and the
    device's idle share.  The train step's calls are traced by the trainers'
    own ``drivers._ProfileWindow``, whose trace must hold the replays'
    device events."""
    os.makedirs(out_dir, exist_ok=True)
    state, _, step = _train_setup(spec, dev, seed=12, fused_stem=True)
    batches = itertools.cycle(_train_batches(dev, 4, seed=13))
    captured = _precompile_buckets(step, state, (TRAIN_SIZE,), TRAIN_BATCH,
                                   spec.num_keypoints)

    def one_step():
        frames, labels = next(batches)
        captured(state, frames, labels, _lr(spec, 0), TRAIN_EPOCH)

    serve = aot_serving(spec, folded, batch=1, width=SIZE, height=SIZE)
    gen = torch.Generator().manual_seed(4)
    x = torch.randint(0, 256, (1, SIZE, SIZE, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    step_what = f"captured train step batch {TRAIN_BATCH}, {TRAIN_SIZE}²"
    calls = {step_what: one_step,
             f"graph serve batch 1, {SIZE}²": lambda: serve(x)}
    host = {k: _host_ms(fn, iters=20) for k, fn in calls.items()}
    for i, (what, fn) in enumerate(calls.items()):
        if what == step_what:
            by_family, busy, path = _profile_window(fn, dev, out_dir)
            note = "drivers._ProfileWindow"
        else:
            path = os.path.join(out_dir, f"captured_trace_{i}.json")
            by_family, busy, _ = _profile(fn, PROFILE_CALLS, path)
            note = "torch.profiler"
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        idle = f"{1 - busy_ms / host[what]:.4f}" if by_family else \
            "not measured (no device event in the trace)"
        print(f"[profile] {what}: host clock {host[what]:.4f} ms/call (median "
              f"of 20, sync each call); device busy {busy_ms:.4f} ms/call over "
              f"{PROFILE_CALLS} profiled calls ({note}); idle share {idle}; "
              f"trace {path} [{card}]")
        for fam, us in by_family.most_common(8):
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/call "
                  f"({us / total:.2%} of device time)")


def _profile_window(fn, dev, out_dir: str):
    """``fn`` (a train step) PROFILE_CALLS times inside the trainers'
    profiler window, ``drivers._ProfileWindow``, as ``_run_epoch_batches``
    opens and closes it; (device µs by family, busy µs, trace path).  A
    trace can come back without the device's events: up to three windows,
    and the run fails if none has any."""
    for attempt in range(3):
        first = attempt * PROFILE_CALLS
        rc = TrainRunConfig(profile_dir=out_dir,
                            profile_steps=(first, first + PROFILE_CALLS))
        window = _ProfileWindow(rc, dev)
        for processed in range(first, first + PROFILE_CALLS):
            window.before(processed)
            fn()
            window.after(processed + 1)
        path = os.path.join(
            out_dir, f"train_steps_{first}_{first + PROFILE_CALLS}.json")
        _check(os.path.exists(path), f"the profile window wrote no {path}")
        by_family, busy = _device_time(path)
        if by_family:
            return by_family, busy, path
    _check(False, "no device event in 3 traces of drivers._ProfileWindow")


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


# the device-data phase: one LINEMOD object's train split in memory (~236 MB
# of u8 frames and masks) plus VOC-like backgrounds; a held-out split of
# whole eval batches (the rgb and the bank path then run the same batches);
# the bank's batches held to the CPU's over SINGLE_SCHEDULE's last, widest
# stage; captured and eager steps fed from the bank; and the shaded
# accuracy script at a tiny size
DATA_FRAMES, DATA_BACKGROUNDS, DATA_EVAL_FRAMES = 192, 16, 24
DATA_BATCHES, DATA_STEPS, DATA_TIMED = 20, 10, 20
SHADED_TINY = dict(n_train=128, n_eval=64, epochs=3)


def _script(name: str):
    """``scripts/<name>.py`` as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data_corpus(root: str, n_train: int = DATA_FRAMES,
                 n_eval: int = DATA_EVAL_FRAMES,
                 n_backgrounds: int = DATA_BACKGROUNDS):
    """Render ``n_train`` + ``n_eval`` shaded LINEMOD-size frames
    (``data/shaded.py``) and ``n_backgrounds`` noise backgrounds in memory;
    write the label files, the two lists, the mesh and a ``.data`` under
    ``root``.  Returns (the ``.data`` path, the train list, the background
    paths, the frames by path: images, 2-D masks, backgrounds)."""
    rng = np.random.RandomState(50)
    colors = rng.randint(60, 255, (6, 3))
    os.makedirs(f"{root}/labels", exist_ok=True)
    frames, paths = {}, []
    for i in range(n_train + n_eval):
        img, mask, lab, _, _ = render_frame(rng, colors)
        path = f"{root}/JPEGImages/00{i:04d}.jpg"
        frames[path] = img
        frames[f"{root}/mask/{i:04d}.png"] = mask
        np.savetxt(f"{root}/labels/00{i:04d}.txt", lab[None])
        paths.append(path)
    bgs = []
    for k in range(n_backgrounds):
        bgs.append(f"{root}/bg/{k:04d}.jpg")
        frames[bgs[-1]] = rng.randint(0, 256, (375, 500, 3), np.uint8)
    for name, part in (("train", paths[:n_train]),
                       ("test", paths[n_train:])):
        with open(f"{root}/{name}.txt", "w") as f:
            f.write("\n".join(part) + "\n")
    verts = SHADED_PTS[1:]
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
    return f"{root}/obj.data", f"{root}/train.txt", bgs, frames


def _host_loader_ms(train_list: str, bgs, frames, root: str):
    """The host Python backend's batch of 8 at 416² (PIL decode and numpy
    augment in 8 threads, as the trainer runs it), host clock, median over
    5 batches after one, on the same frames written as JPEGs (quality 92)
    and PNG masks; None without Pillow."""
    try:
        from PIL import Image
    except ImportError:
        print("[device data] host Loader batch: not measured (no Pillow)")
        return None
    with open(train_list) as f:
        lines = [ln.strip() for ln in f][:6 * TRAIN_BATCH]
    masks = [mask_path_from_image(p) for p in lines]
    for path in lines + masks + list(bgs):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(frames[path]).save(path, quality=92)
    with open(f"{root}/host.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    ds = PoseDataset(f"{root}/host.txt", train=True, bg_file_names=bgs)
    loader = Loader(ds, TRAIN_BATCH, fixed_shape=(TRAIN_SIZE, TRAIN_SIZE),
                    seed=23, out_uint8=True, backend="python")
    times, t = [], time.perf_counter()
    for _ in loader:
        times.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
    return statistics.median(times[1:])


def phase_device_data(spec, dev, card: str) -> dict:
    """The device-resident single-object data path (``data/device_bank.py``,
    ``data/eval_bank.py``) on a LINEMOD-size corpus rendered in memory, the
    loader's image decoder reading the renders: the frame bank on the card;
    DATA_BATCHES batches of 8 through ``Loader(backend="device_bank")`` over
    SINGLE_SCHEDULE's last stage (224²-832²) equal to the same draws on the
    CPU bit for bit, images and labels; a 416² bank batch timed against the
    host Python backend's on the same frames; DATA_STEPS captured batch-8
    416² steps fed from the bank (``drivers._precompile_buckets``) equal to
    as many eager steps on the same batches bit for bit (K2–K6 once a step,
    counted); ``run_validation(transfer="bank")`` equal to ``"rgb"`` on a
    held-out split; ``scripts/shaded_accuracy.py`` at a tiny size.  Returns
    K2–K6's launches in the eager steps, and K1's in the two evals."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_device_data_")
    try:
        datacfg, train_list, bgs, frames = _data_corpus(root)
        print(f"[device data] rendered {DATA_FRAMES} train + "
              f"{DATA_EVAL_FRAMES} held-out 640x480 frames and "
              f"{DATA_BACKGROUNDS} backgrounds in "
              f"{time.perf_counter() - t_phase:.1f} s")
        host_ms = _host_loader_ms(train_list, bgs, frames, root)
        with _reading_renders(frames):
            out = _device_data_checks(spec, dev, card, datacfg, train_list,
                                      bgs, host_ms)
        t = time.perf_counter()
        res = _script("shaded_accuracy").run(**SHADED_TINY, device=str(dev))
        print(f"[device data] scripts/shaded_accuracy.py at {SHADED_TINY}: "
              f"{res['stem']}; losses {res['epoch_losses']}; held out "
              f"2D@5px {res['acc_2d_5px']:.2f}% ADD-0.1d "
              f"{res['acc_add_0.1d']:.2f}% 5cm5° {res['acc_5cm5deg']:.2f}% "
              f"mean px {res['mean_px_err']:.4f} over {res['eval_n']} frames, "
              f"JPEG round trip {res['jpeg_round_trip']}, "
              f"{time.perf_counter() - t:.1f} s")
        _check(res["eval_n"] == SHADED_TINY["n_eval"] and
               np.isfinite(res["epoch_losses"]).all() and
               np.isfinite(res["mean_px_err"]),
               f"the shaded accuracy script's tiny run failed: {res}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    print(f"[device data] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _device_data_checks(spec, dev, card, datacfg, train_list, bgs,
                        host_ms) -> dict:
    nb = DATA_FRAMES // TRAIN_BATCH
    deep = dict(seed=21, seen=70 * nb * TRAIN_BATCH, num_workers=0,
                backend="device_bank")
    loaders = [Loader(PoseDataset(train_list, train=True, bg_file_names=bgs),
                      TRAIN_BATCH, device=d, **deep) for d in (dev, "cpu")]
    t = time.perf_counter()
    widths, diffs = [], []
    for i, ((ci, cl), (hi, hl)) in enumerate(zip(*loaders)):
        if i == DATA_BATCHES:
            break
        widths.append(ci.shape[2])
        same = torch.equal(ci.cpu(), hi) and torch.equal(
            cl.cpu().view(torch.int32), hl.view(torch.int32))
        if not same:
            diffs.append((i, int((ci.cpu() != hi).sum()),
                          int((cl.cpu() != hl).sum())))
    bank = loaders[0]._frame_bank
    print(f"[device data] bank on the card: {bank.images.shape[0]} frames "
          f"{tuple(bank.images.shape[1:3])}, {len(bgs)} backgrounds, "
          f"{bank.nbytes() / 2**20:.1f} MiB; {DATA_BATCHES} batches of "
          f"{TRAIN_BATCH} at widths {sorted(set(widths))}: card = CPU bit "
          f"for bit in {DATA_BATCHES - len(diffs)} of {DATA_BATCHES} "
          f"(images and labels); {time.perf_counter() - t:.1f} s with the "
          f"CPU's")
    for d in diffs[:5]:
        print(f"[device data]   batch {d[0]} differs: {d[1]} pixels, "
              f"{d[2]} label values")
    _check(not diffs and len(set(widths)) > 3,
           "the bank's batches on the card are not the CPU's")

    # a 416² bank batch: host clock with a sync, and CUDA events
    fixed = Loader(PoseDataset(train_list, train=True, bg_file_names=bgs),
                   TRAIN_BATCH, fixed_shape=(TRAIN_SIZE, TRAIN_SIZE),
                   seed=22, num_workers=0, backend="device_bank", device=dev)
    it = iter(fixed)
    batches = [next(it) for _ in range(DATA_STEPS)]
    stream = itertools.chain.from_iterable(itertools.repeat(fixed))
    host, events = [], []
    for _ in range(DATA_TIMED):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        start.record()
        next(stream)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3)
        events.append(start.elapsed_time(end))
    bank_ms = statistics.median(host)
    print(f"[device data] {TRAIN_SIZE}² batch of {TRAIN_BATCH}: bank "
          f"{bank_ms:.4f} ms host clock with a sync ({statistics.median(events):.4f} "
          f"ms CUDA events), median of {DATA_TIMED}; host Python backend "
          + (f"{host_ms:.4f} ms (PIL decode + numpy augment, 8 threads, host "
             f"clock, median of 5), {host_ms / bank_ms:.1f}x the bank's"
             if host_ms is not None else "not measured") + f" [{card}]")

    # captured steps fed from the bank against eager steps on the same
    # batches
    fused = _resolve_fused_stem(TrainRunConfig(), dev)
    (cap_state, _, cap_step), (eager_state, _, step) = \
        (_train_setup(spec, dev, 70, fused) for _ in range(2))
    with _counting_captures():
        captured = _precompile_buckets(cap_step, cap_state, [TRAIN_SIZE],
                                       TRAIN_BATCH, spec.num_keypoints)
    del cap_step
    _scribble(dev)
    recorded = [c[1:] for c in _CountingGraph.captured]
    for f in _TRAIN_COUNTED:
        f.launches = 0
    eager_losses = torch.stack([
        step(eager_state, _to_device(im, dev), _to_device(lb, dev),
             _lr(spec, i), TRAIN_EPOCH)["loss"]
        for i, (im, lb) in enumerate(batches)])
    torch.cuda.synchronize()
    launches = _launches()
    cap_losses = torch.stack([
        captured(cap_state, _to_device(im, dev), _to_device(lb, dev),
                 _lr(spec, i), TRAIN_EPOCH)["loss"]
        for i, (im, lb) in enumerate(batches)])
    torch.cuda.synchronize()
    cap_diffs, n_tensors = _state_diffs(cap_state, eager_state)
    same = _same_bits(cap_losses, eager_losses)
    print(f"[device data] {DATA_STEPS} batch-{TRAIN_BATCH} {TRAIN_SIZE}² bf16 "
          f"steps fed from the bank (u8 on the card), fused stem {fused}: "
          f"K2-K6 recorded in the graph {recorded}, launched in the eager "
          f"steps {launches}; losses {float(eager_losses[0]):.6g} ... "
          f"{float(eager_losses[-1]):.6g}; captured = eager bit for bit: "
          f"losses {same}, {n_tensors - len(cap_diffs)} of {n_tensors} state "
          f"tensors [{card}]")
    _check(recorded == [[1] * 5], f"K2-K6 recorded {recorded}")
    _check(launches == [DATA_STEPS] * 5,
           f"K2-K6 launched {launches} times in {DATA_STEPS} eager steps")
    _check(same and not cap_diffs and bool(torch.isfinite(cap_losses).all()),
           "the captured steps fed from the bank are not the eager steps")

    # the eval bank against the rgb path on the held-out split
    stem.stem_conv_pool_infer.launches = 0
    kw = dict(model=eager_state.model, batch_size=TRAIN_BATCH,
              num_workers=4, device=dev, verbose=False)
    rgb = run_validation(datacfg, spec, transfer="rgb", **kw)
    banked = run_validation(datacfg, spec, transfer="bank", **kw)
    k1 = stem.stem_conv_pool_infer.launches
    equal = all(rgb[k] == banked[k] or (np.isnan(rgb[k]) and
                                        np.isnan(banked[k])) for k in rgb)
    print(f"[device data] run_validation on {rgb['n_samples']} held-out "
          f"frames at {spec.net.test_width}², bf16: bank = rgb {equal} "
          f"(2D@5px {banked['acc_2d_proj']:.2f}%, mean px "
          f"{banked['mean_err_2d']:.6g}); K1 launched {k1} times [{card}]")
    _check(equal and rgb["n_samples"] == DATA_EVAL_FRAMES,
           f"the eval bank's metrics differ from rgb: {rgb} vs {banked}")
    _check(k1 == 2 * DATA_EVAL_FRAMES // TRAIN_BATCH,
           f"the evals launched K1 {k1} times")
    return {"launches": launches, "k1_launches": k1, "bank_ms": bank_ms,
            "host_ms": host_ms}


# the device-synth phase: a multi-object corpus (13 classes x 16 shaded
# 640x480 renders, ~256 MB, and 16 backgrounds; scripts/
# shaded_accuracy_multi.py builds it) in a scene bank on the card; batch-32
# 416² scenes held to the CPU's from the same draws at SYNTH_BIT_KNOBS; the
# synth timed at every (attempts, propose_scale) of SYNTH_KNOBS; captured
# f32 multi steps fed from it against eager ones; the host synthesizer's
# batch on the same frames
SYNTH_FRAMES_PER_CLASS = 16
SYNTH_KNOBS = tuple((a, s) for a in (30, 16, 6) for s in (1, 4))
SYNTH_BIT_KNOBS = ((30, 4), (6, 1))
SYNTH_TIMED, SYNTH_WARMUP, SYNTH_STEPS, SYNTH_HOST_BATCHES = 10, 2, 10, 3


def _objects_per_scene(labels: torch.Tensor) -> float:
    rows = labels.view(labels.shape[0], -1, 21)[:, :, 1:]
    return float((rows.abs().sum(-1) > 0).sum(-1).float().mean())


def _synth(bank, idx, gen, st, binary=True):
    """One batch of ``idx``'s scenes at MULTI_SIZE² from ``gen``'s draws,
    on u8 levels (``binary``, the shaded masks are) or in f32: (draws,
    images, labels)."""
    H, W = bank.frame_shape
    draws = draw_synth(gen, len(idx), bank, bank.base_class[idx].long(), st,
                       W, H)
    return (draws, *synthesize_batch(bank, idx, draws, out_w=MULTI_SIZE,
                                     out_h=MULTI_SIZE, st=st, binary=binary))


def _synth_tree(host_bank, root: str):
    """The bank's frames as a LINEMOD tree under ``root``: per class
    ``<obj>/labels/*.txt`` and ``<obj>/train.txt``, a train list of every
    frame and an OCCLUSION ``.data``, and the frames by path (images, masks,
    backgrounds) for a decoder that reads them from memory.  Returns (the
    ``.data`` path, the train list, the background paths, the frames)."""
    nf = host_bank.images.shape[0] // len(OCCLUSION_CLASSES)
    frames, lines = {}, []
    for c, obj in enumerate(OCCLUSION_CLASSES):
        os.makedirs(f"{root}/{obj}/labels", exist_ok=True)
        paths = []
        for j in range(nf):
            i = c * nf + j
            path = f"{root}/{obj}/JPEGImages/00{j:04d}.jpg"
            frames[path] = host_bank.images[i].numpy()
            frames[mask_path_from_image(path)] = host_bank.masks[i].numpy()
            np.savetxt(f"{root}/{obj}/labels/00{j:04d}.txt",
                       host_bank.labels[i].numpy()[None])
            paths.append(path)
        with open(f"{root}/{obj}/train.txt", "w") as f:
            f.write("\n".join(paths) + "\n")
        lines += paths
    bgs = [f"{root}/bg{k:02d}.jpg" for k in range(host_bank.bgs.shape[0])]
    frames.update(zip(bgs, host_bank.bgs.numpy()))
    with open(f"{root}/train_multi.txt", "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(f"{root}/occlusion.data", "w") as f:
        f.write(occlusion_datacfg(linemod_root=root,
                                  train_list=f"{root}/train_multi.txt",
                                  backup_root=f"{root}/backup"))
    return f"{root}/occlusion.data", f"{root}/train_multi.txt", bgs, frames


def _host_synth_ms(train_list: str, bgs, frames, root: str):
    """The host synthesizer's batch of MULTI_TRAIN_BATCH scenes at
    MULTI_SIZE² (``Loader(backend="python")``, PIL decode and numpy
    compositing in 8 threads, as the multi trainer runs it), host clock,
    median over SYNTH_HOST_BATCHES batches after one, on ``_synth_tree``'s
    frames written as files (JPEG quality 92, PNG masks); (ms, objects per
    scene), or None without Pillow."""
    try:
        from PIL import Image
    except ImportError:
        print("[device synth] host synthesizer batch: not measured (no "
              "Pillow)")
        return None
    from singleshotpose_tpu_torch.data.synth_multi import (
        MultiObjectSynthesizer, SynthConfig)
    for path, a in frames.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(a).save(path, **({} if path.endswith(".png")
                                         else {"quality": 92}))
    ds = PoseDataset(train_list, train=True, bg_file_names=bgs,
                     aug=pipeline.AugmentConfig.multi(),
                     synthesizer=MultiObjectSynthesizer(
                         SynthConfig(linemod_root=root)))
    loader = Loader(ds, MULTI_TRAIN_BATCH,
                    fixed_shape=(MULTI_SIZE, MULTI_SIZE), seed=24,
                    out_uint8=True, backend="python")
    times, objs, t = [], [], time.perf_counter()
    for i, (_, labels) in enumerate(loader):
        times.append((time.perf_counter() - t) * 1e3)
        objs.append(_objects_per_scene(torch.from_numpy(labels)))
        if i == SYNTH_HOST_BATCHES:
            break
        t = time.perf_counter()
    return statistics.median(times[1:]), float(np.mean(objs))


def _synth_trainer(multi, dev, card: str, datacfg: str, root: str, frames):
    """``drivers.run_training_multi`` on the tree of ``_synth_tree``, as a
    user runs ``train-multi --loader_backend device_synth
    --precompile_buckets``: the decoder reads the frames from memory, the
    full-width ``yolo_pose_multi`` from seeded weights, one epoch at batch
    32; its graphs are captured for f32 images (a u8 batch would find
    none), K2–K6 recorded once in each.  Returns the epoch's steps."""
    rc = TrainRunConfig(loader_backend="device_synth",
                        precompile_buckets=True, max_epochs_override=1,
                        num_workers=0, log_every=2, bg_dir=f"{root}/no_bg",
                        eval_every=20, eval_after=-1)
    t = time.perf_counter()
    with _reading_renders(frames), \
            _counting_captures():
        result = run_training_multi(datacfg, multi, None, 0, None, root, rc)
    per_graph = [c[1:] for c in _CountingGraph.captured]
    losses = result["history"]["training_losses"]
    steps = len(OCCLUSION_CLASSES) * SYNTH_FRAMES_PER_CLASS \
        // MULTI_TRAIN_BATCH
    print(f"[device synth] run_training_multi(loader_backend='device_synth',"
          f" precompile_buckets=True), yolo_pose_multi batch "
          f"{MULTI_TRAIN_BATCH}, one epoch: {len(losses)} steps, losses "
          + " ".join(f"{x:.6g}" for x in losses) + f"; seen "
          f"{result['state'].seen}; {len(per_graph)} f32 graphs, K2-K6 "
          f"recorded in each {per_graph[0] if per_graph else None}; "
          f"{time.perf_counter() - t:.1f} s [{card}]")
    _check(len(losses) == steps and np.isfinite(losses).all()
           and result["state"].seen == steps * MULTI_TRAIN_BATCH,
           "run_training_multi on device_synth did not train its epoch")
    _check(per_graph == [[1] * 5] * len(MULTI_SCHEDULE.all_widths),
           f"K2-K6 recorded {per_graph}")
    return len(losses)


def phase_device_synth(multi, dev, card: str) -> dict:
    """The multi-object scene synthesis on the card (``data/
    device_synth.py``), on a corpus of 13 classes × SYNTH_FRAMES_PER_CLASS
    shaded renders in a scene bank on the card: batch-32 416² scenes drawn
    on the card, composited on u8 levels (the masks are binary) and in f32,
    equal, bit for bit, the CPU's f32 composite from the same draws (images
    and labels) at SYNTH_BIT_KNOBS; the synth's ms per batch (CUDA events,
    SYNTH_TIMED repeats) and objects per scene at each (attempts,
    propose_scale) of SYNTH_KNOBS on u8 levels, and at the default in f32;
    SYNTH_STEPS captured f32 steps of the
    full-width ``yolo_pose_multi`` fed from the synth (the multi trainer's
    ``device_synth`` knobs: attempts 30, propose_scale 4; graphs from
    ``drivers._precompile_buckets(image_dtype=float32)``) equal to as many
    eager steps on the same scenes (losses and every state tensor; K2–K6
    once a step, counted in the eager steps); the synth-fed captured step
    timed against the captured step on scenes in memory, in turns;
    ``run_training_multi(loader_backend="device_synth",
    precompile_buckets=True)`` for one epoch on the frames as a LINEMOD
    tree; the host synthesizer's batch on the same frames.  Returns K2–K6's
    launches in the eager steps."""
    t_phase = time.perf_counter()
    mod = _script("shaded_accuracy_multi")
    palettes, extents = mod.palettes_and_extents()
    host = mod.shaded_scene_bank(SYNTH_FRAMES_PER_CLASS, palettes, extents)
    render_s = time.perf_counter() - t_phase
    _check(binary_masks(host), "the shaded masks are not binary")
    t = time.perf_counter()
    bank = host.device_put(dev)
    torch.cuda.synchronize()
    put_s = time.perf_counter() - t
    N, B = bank.images.shape[0], MULTI_TRAIN_BATCH
    print(f"[device synth] scene bank: {N} frames "
          f"{tuple(bank.images.shape[1:3])}, {bank.bgs.shape[0]} "
          f"backgrounds, {bank.nbytes()} bytes; rendered in {render_s:.2f} s,"
          f" on the card in {put_s:.4f} s [{card}]")

    for attempts, ps in SYNTH_BIT_KNOBS:
        st = DeviceSynthStatic(attempts=attempts, propose_scale=ps)
        idx = torch.randperm(N, generator=torch.Generator().manual_seed(
            attempts))[:B].to(dev)
        draws, ci, cl = _synth(bank, idx, torch.Generator(
            device=dev).manual_seed(attempts + ps), st)
        t = time.perf_counter()
        hi, hl = synthesize_batch(host, idx.cpu(), SynthDraws(
            *(d.cpu() for d in draws)), out_w=MULTI_SIZE, out_h=MULTI_SIZE,
            st=st)
        cpu_s = time.perf_counter() - t
        fi, fl = synthesize_batch(bank, idx, draws, out_w=MULTI_SIZE,
                                  out_h=MULTI_SIZE, st=st)
        diffs = [(int((a.cpu().view(torch.int32) != hi.view(torch.int32))
                      .sum()), int((b.cpu().view(torch.int32)
                                    != hl.view(torch.int32)).sum()))
                 for a, b in ((ci, cl), (fi, fl))]
        print(f"[device synth] attempts {attempts}, propose_scale {ps}: "
              f"{B} scenes at {MULTI_SIZE}² drawn on the card; the card's "
              f"u8-level composite / its f32 composite = the CPU's f32 "
              f"composite from the same draws: " + " / ".join(
                  f"{hi.numel() - p} of {hi.numel()} pixel values, "
                  f"{hl.numel() - q} of {hl.numel()} label values"
                  for p, q in diffs) +
              f"; {_objects_per_scene(cl):.4f} objects a scene; the CPU's "
              f"batch {cpu_s:.2f} s")
        _check(diffs == [(0, 0), (0, 0)],
               "the card's scenes are not the CPU's from the same draws")
        _check(_objects_per_scene(cl) > 2, "the synth placed no companions")

    synth_ms = {}
    # every knob on u8 levels (the trainers' path on these masks), then the
    # default knob's f32 composite
    for attempts, ps, binary in (*((a, s, True) for a, s in SYNTH_KNOBS),
                                 (30, 4, False)):
        st = DeviceSynthStatic(attempts=attempts, propose_scale=ps)
        gen = torch.Generator(device=dev).manual_seed(90)
        times, objs = [], []
        for r in range(SYNTH_WARMUP + SYNTH_TIMED):
            idx = (torch.arange(B, device=dev) + r * B) % N
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            _, _, labels = _synth(bank, idx, gen, st, binary)
            end.record()
            end.synchronize()
            if r >= SYNTH_WARMUP:
                times.append(start.elapsed_time(end))
                objs.append(_objects_per_scene(labels))
        synth_ms[f"{attempts}/{ps}" + ("" if binary else "/f32")] = \
            statistics.median(times)
        print(f"[device synth] attempts {attempts}, propose_scale {ps}, "
              f"{'u8-level' if binary else 'f32'} composite: "
              f"batch of {B} at {MULTI_SIZE}² (draws + synthesis) "
              f"{statistics.median(times):.4f} ms CUDA events, median of "
              f"{SYNTH_TIMED} (min {min(times):.4f}, max {max(times):.4f}); "
              f"{float(np.mean(objs)):.4f} objects a scene over "
              f"{SYNTH_TIMED * B} scenes [{card}]")

    # captured f32 steps fed from the synth against eager steps on the same
    # scenes
    fused = _resolve_fused_stem(TrainRunConfig(), dev)
    (cap_state, _, cap_step), (eager_state, _, step) = \
        (_train_setup(multi, dev, 80, fused, multi=True) for _ in range(2))
    st = DeviceSynthStatic(propose_scale=4)
    gen = torch.Generator(device=dev).manual_seed(81)
    batches = [_synth(bank, (torch.arange(B, device=dev) + i * B) % N, gen,
                      st)[1:] for i in range(SYNTH_STEPS)]
    with _counting_captures():
        captured = _precompile_buckets(cap_step, cap_state, [MULTI_SIZE], B,
                                       multi.num_keypoints,
                                       image_dtype=torch.float32)
    del cap_step
    _scribble(dev)
    recorded = [c[1:] for c in _CountingGraph.captured]
    torch.cuda.synchronize()
    # the device-synth path: every K2-K6 launch counted from here came
    # from its eager steps
    for f in _TRAIN_COUNTED:
        f.launches = 0
    eager_losses = torch.stack([
        step(eager_state, im, lb, _lr(multi, i), 1)["loss"]
        for i, (im, lb) in enumerate(batches)])
    torch.cuda.synchronize()
    launches = _launches()
    cap_losses = torch.stack([
        captured(cap_state, im, lb, _lr(multi, i), 1)["loss"]
        for i, (im, lb) in enumerate(batches)])
    torch.cuda.synchronize()
    cap_diffs, n_tensors = _state_diffs(cap_state, eager_state)
    same = _same_bits(cap_losses, eager_losses)
    print(f"[device synth] {SYNTH_STEPS} batch-{B} {MULTI_SIZE}² bf16 multi "
          f"steps fed from the synth (f32 on the card), fused stem {fused}: "
          f"K2-K6 recorded in the graph {recorded}, launched in the eager "
          f"steps {launches}; losses {float(eager_losses[0]):.6g} ... "
          f"{float(eager_losses[-1]):.6g}; captured = eager bit for bit: "
          f"losses {same}, {n_tensors - len(cap_diffs)} of {n_tensors} state "
          f"tensors [{card}]")
    for name, n, d in cap_diffs[:10]:
        print(f"[device synth]   captured != eager: {name}: {n} elements, "
              f"max|d| {d:.6g}")
    _check(recorded == [[1] * 5], f"K2-K6 recorded {recorded}")
    _check(launches == [SYNTH_STEPS] * 5,
           f"K2-K6 launched {launches} times in {SYNTH_STEPS} eager steps")
    _check(same and not cap_diffs and bool(torch.isfinite(cap_losses).all()),
           "the captured steps fed from the synth are not the eager steps")

    def fed(i):
        _, im, lb = _synth(bank, (torch.arange(B, device=dev) + i * B) % N,
                           gen, st)
        captured(cap_state, im, lb, _lr(multi, 0), 1)

    def in_memory(i):
        captured(cap_state, *batches[i % len(batches)], _lr(multi, 0), 1)

    turns = {"in memory": [], "synth-fed": []}
    for which in ("in memory", "synth-fed", "synth-fed", "in memory"):
        fn = in_memory if which == "in memory" else fed
        times = []
        for i in range(TIMED_STEPS + 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn(i)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        turns[which].append(statistics.median(times[1:]))
    print(f"[device synth] captured {MULTI_SIZE}² batch-{B} step in turns "
          f"in memory/synth-fed/synth-fed/in memory, median of {TIMED_STEPS} "
          f"steps each (host clock, sync each step; synth-fed: draws, "
          f"synthesis and the step): " + "; ".join(
              f"{k} " + " ".join(f"{x:.4f}" for x in v)
              for k, v in turns.items()) + f" [{card}]")

    del captured, cap_state, eager_state, step, batches
    _free()
    root = tempfile.mkdtemp(prefix="ssp_device_synth_")
    try:
        datacfg, train_list, bgs, frames = _synth_tree(host, root)
        _synth_trainer(multi, dev, card, datacfg, root, frames)
        host_synth = _host_synth_ms(train_list, bgs, frames, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if host_synth is not None:
        print(f"[device synth] host synthesizer: batch of {B} at "
              f"{MULTI_SIZE}² {host_synth[0]:.4f} ms (PIL decode + numpy "
              f"compositing, 8 threads, host clock, median of "
              f"{SYNTH_HOST_BATCHES}), {host_synth[1]:.4f} objects a scene; "
              f"{host_synth[0] / synth_ms['30/4']:.1f}x the card's batch at "
              f"attempts 30, propose_scale 4 [{card}]")
    print(f"[device synth] phase {time.perf_counter() - t_phase:.1f} s")
    return {"launches": launches, "synth_ms": synth_ms}


def phase_profile_synth(dev, card: str, out_dir: str) -> None:
    """Where the scene synth's time goes (``--profile``): a batch of
    MULTI_TRAIN_BATCH scenes at MULTI_SIZE² (attempts 30, propose_scale 4,
    draws and synthesis) on phase 15's bank, composited on u8 levels and in
    f32: each its host-clock median (sync each call) first, then device time
    by kernel family over PROFILE_CALLS profiled calls, the heaviest
    kernels, and the device's idle share against that median."""
    os.makedirs(out_dir, exist_ok=True)
    mod = _script("shaded_accuracy_multi")
    bank = mod.shaded_scene_bank(SYNTH_FRAMES_PER_CLASS,
                                 *mod.palettes_and_extents()).device_put(dev)
    st = DeviceSynthStatic(attempts=30, propose_scale=4)
    gen = torch.Generator(device=dev).manual_seed(91)
    idx = torch.arange(MULTI_TRAIN_BATCH, device=dev)
    calls = {f"{k} composite": functools.partial(_synth, bank, idx, gen, st,
                                                 binary)
             for k, binary in (("u8-level", True), ("f32", False))}
    host = {k: _host_ms(fn, iters=20) for k, fn in calls.items()}
    for i, (what, fn) in enumerate(calls.items()):
        path = os.path.join(out_dir, f"synth_trace_{i}.json")
        by_family, busy, by_name = _profile(fn, PROFILE_CALLS, path)
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        with open(path) as f:
            launches = sum(e.get("cat") == "kernel"
                           for e in json.load(f)["traceEvents"])
        print(f"[profile] synth batch {MULTI_TRAIN_BATCH} at {MULTI_SIZE}², "
              f"{what}: host clock {host[what]:.4f} ms/call (median of 20, "
              f"sync each call); device busy {busy_ms:.4f} ms/call over "
              f"{PROFILE_CALLS} profiled calls; idle share "
              f"{1 - busy_ms / host[what]:.4f}; {launches / PROFILE_CALLS:.1f}"
              f" kernel launches a call, {len(by_name)} distinct kernels; "
              f"trace {path} [{card}]")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/call "
                  f"({us / total:.2%} of device time)")
        for name, us in by_name.most_common(8):
            print(f"[profile]   kernel {us / 1e3 / PROFILE_CALLS:.4f} "
                  f"ms/call [{_family(name)}] {name[:110]}")


# ---------------------------------------------------------------------------
# phase 16: the int8 serving path (models/quantize.py, csrc/int8_conv.cu)
# ---------------------------------------------------------------------------

# int8 tensor cores, dense, H100 SXM at 700 W (NVIDIA's data sheet)
INT8_OPS = 1979e12
INT8_CALIB = 8        # calibration frames, as `cli quantize --calib_images`
INT8_TIMED = 10       # CUDA-event timings a turn
# (batch, size) of each serve whose int8 convs the kernel is held at: the
# single-object serve at batch 8 and 1, 672²; the multi serve at batch 16, 416²
INT8_SERVES = ((MODEL_BATCH, SIZE), (1, SIZE))
# misaligned and odd cases: (B, H, W, C_in, C_out, ksize, stride, pad, byte
# offset of the input): the first conv's C_in (3, padded to 4) at an odd
# width, the 4-byte copies at C_in 36, an input 4 bytes off 16-byte
# alignment (the 4-byte copies), an odd C_out (element-wise stores)
INT8_ODD = ((2, 37, 23, 4, 32, 3, 1, 1, 0), (1, 13, 11, 36, 40, 3, 1, 1, 0),
            (2, 11, 9, 64, 64, 3, 1, 1, 4), (1, 9, 7, 16, 7, 1, 1, 0, 0))


def _int8_layers(spec, size: int):
    """(conv spec, input height, epilogue plan) of each conv that
    ``quantize_folded`` quantizes by default (all but the head), the input
    square at ``size``."""
    from singleshotpose_tpu_torch.models import quantize as Q
    skip = Q.default_skip_layers(spec)
    plan = Q.epilogue_plan(spec, {l.name for l in spec.layers if isinstance(
        l, darknet.ConvSpec) and l.name not in skip})
    heights, h, out = [], size, []
    for lspec in spec.layers:
        if isinstance(lspec, darknet.ConvSpec):
            if lspec.name not in skip:
                out.append((lspec, h, plan[lspec.name]))
            h = (h + 2 * lspec.pad - lspec.size) // lspec.stride + 1
        elif isinstance(lspec, darknet.MaxPoolSpec) and lspec.stride > 1:
            h = (h - lspec.size) // lspec.stride + 1
        elif isinstance(lspec, darknet.ReorgSpec):
            h //= lspec.stride
        elif isinstance(lspec, darknet.RouteSpec):
            h = heights[lspec.layers[0]]
        heights.append(h)
    return out


def _graph_ms(fn, calls: int = 10, reps: int = 5) -> float:
    """Device ms a call of ``fn``: ``calls`` calls recorded in one CUDA
    graph, its replay timed with CUDA events, the median of ``reps``; no
    host work between the calls."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph
    return statistics.median(times)


def _int8_case(dev, g, B, H, W, C, N, ksize, offset=0):
    flat = torch.randint(-127, 128, (B * H * W * C + 16,), generator=g,
                         device=dev, dtype=torch.int32).to(torch.int8)
    x = flat[offset:offset + B * H * W * C].view(B, H, W, C)
    wq = torch.randint(-127, 128, (ksize, ksize, C, N), generator=g,
                       device=dev, dtype=torch.int32).to(torch.int8)
    return x, int8_conv.pack_weights(wq)


def _int8_epilogue(g, y, writes: str, per_channel: bool, divide: bool,
                   dtype=torch.bfloat16):
    """A random epilogue for the int32 sums ``y`` (B, Ho, Wo, N): the
    dequant maps them to about N(0, 1) around a bias, the quantizer (per
    channel or one scalar; ``divide``: v / q, else v · q) to about ±40 —
    some values clamp at ±127; ``writes`` is the plan's "int8", "compute"
    or "both"."""
    N, dev = y.shape[-1], y.device
    sd = float(y.float().std()) + 1.0
    q = torch.rand(N if per_channel else 1, generator=g, device=dev) * 40 + 10
    return int8_conv.Epilogue(
        (torch.rand(N, generator=g, device=dev) * 2 / sd).contiguous(),
        torch.randn(N, generator=g, device=dev) * 0.5, dtype=dtype,
        quant=None if writes == "compute" else (1 / q if divide else q),
        divide=divide, value=writes != "int8")


def _same_outputs(got, want) -> bool:
    """The kernel's (value, int8) equal the twin's bit for bit."""
    return all((a is None) == (b is None) and (a is None or _same_bits(a, b))
               for a, b in zip(got, want))


def _int8_bound(x, c_in: int, outs, ksize, params=()) -> dict:
    """The conv's own work, not the zero channels the port pads in: the
    int8 input's first ``c_in`` channels and its K·N int8 weights in (K =
    ksize²·c_in), the outputs (int32 sums, or the fused epilogue's int8
    and/or bf16) and the epilogue's per-channel parameters out or in, over
    the HBM rate; 2·M·N·K over the int8 tensor cores' rate."""
    y = next(t for t in outs if t is not None)
    M, N = y.numel() // y.shape[-1], y.shape[-1]
    K = ksize * ksize * c_in
    return _bound(x.numel() // x.shape[-1] * c_in + K * N
                  + _nbytes(*(t for t in outs if t is not None), *params),
                  2 * M * N * K, INT8_OPS)


def phase_int8_kernel(spec, multi, dev, card: str) -> dict:
    """The int8 conv against its plain twin, bit for bit: at INT8_ODD in
    every epilogue mode (int32; int8, compute dtype, both), with per-channel
    and scalar quantizers in both rounding forms, in bf16 and f32; a C_in
    of 3 refused; and at every quantized conv's shape of the single-object
    serve (batch 8 and 1, 672²) and the multi serve (batch 16, 416²) in
    int32 mode (the product alone) and in the serve's mode for that layer
    (its epilogue plan, per-channel scales, bf16; the multiply form, and
    where it writes int8 the divide form too).  Per layer the device ms a
    call (:func:`_graph_ms`) of the product, the fused kernel, the fused
    twin and ``torch._int_mm`` (on the twin's im2col matrices; the first
    conv's without its zero channel), and both bounds (of the conv's own
    channels, :func:`_int8_bound`).  Returns the batch-8 672² serve's sums
    (and the others' under ``serves``)."""
    g = torch.Generator(device=dev).manual_seed(160)
    t0 = time.perf_counter()
    worst, checked = 0, 0
    for B, H, W, C, N, ks, st, pad, off in INT8_ODD:
        x, wk = _int8_case(dev, g, B, H, W, C, N, ks, off)
        ref = int8_conv.int8_conv_reference(x, wk, ks, st, pad)
        got = int8_conv.int8_conv(x, wk, ks, st, pad)
        torch.cuda.synchronize()
        same = torch.equal(got, ref)
        modes = 0
        for writes in ("int8", "compute", "both"):
            for per_channel in (True, False):
                for divide in (True, False):
                    for dtype in (torch.bfloat16, None):
                        ep = _int8_epilogue(g, ref, writes, per_channel,
                                            divide, dtype)
                        ok = _same_outputs(
                            int8_conv.int8_conv(x, wk, ks, st, pad, ep),
                            int8_conv.int8_conv_reference(x, wk, ks, st,
                                                          pad, ep))
                        _check(ok, f"int8 conv != twin at ({B},{H},{W},{C})"
                                   f"->{N} {writes} per_channel "
                                   f"{per_channel} divide {divide} {dtype}")
                        modes += 1
        checked += modes + 1
        print(f"[int8] ({B},{H},{W},{C})->{N} {ks}x{ks} offset {off}: copy "
              f"width {int8_conv.copy_width(x)} bytes; kernel = twin bit for "
              f"bit: int32 {same}, and in {modes} epilogue modes (int8 / "
              f"compute / both x per-channel / scalar x v/q / v*q x bf16 / "
              f"f32)")
        _check(same, f"int8 conv != twin at ({B},{H},{W},{C})->{N}")
    x, wk = _int8_case(dev, g, 1, 8, 8, 3, 32, 3)
    try:
        int8_conv.int8_conv(x, int8_conv.pack_weights(
            torch.zeros((3, 3, 3, 32), dtype=torch.int8, device=dev)), 3, 1,
            1)
        refused = False
    except ValueError:
        refused = True
    _check(refused, "the int8 conv took C_in = 3 (the byte path is gone)")
    result, serves = None, {}
    for tag, net, cases in (("yolo_pose_single", spec, INT8_SERVES),
                            ("yolo_pose_multi", multi,
                             ((MULTI_SERVE_BATCH, MULTI_SIZE),))):
        for B, size in cases:
            totals = collections.Counter()
            bound_parts = collections.Counter()
            layers = _int8_layers(net, size)
            for lspec, h, plan in layers:
                ks, C, N = lspec.size, lspec.in_filters, lspec.filters
                cp = -(-C // 4) * 4                # the padded C_in
                x, wk = _int8_case(dev, g, B, h, h, cp, N, ks)
                if cp != C:                         # the zero channels
                    x[..., C:] = 0
                conv = (x, wk, ks, lspec.stride, lspec.pad)
                ref = int8_conv.int8_conv_reference(*conv)
                got = int8_conv.int8_conv(*conv)
                ep = _int8_epilogue(g, ref, plan.writes, True, False)
                fused = int8_conv.int8_conv(*conv, ep)
                torch.cuda.synchronize()
                diff = int((got.long() - ref.long()).abs().max())
                worst = max(worst, diff)
                _check(diff == 0, f"int8 conv != twin at {lspec.name} "
                                  f"({B},{h},{h},{C})")
                _check(_same_outputs(fused, int8_conv.int8_conv_reference(
                    *conv, ep)), f"the fused int8 conv != twin at "
                                 f"{lspec.name} ({B},{h},{h},{C}) "
                                 f"{plan.writes}")
                checked += 2
                if plan.writes != "compute":
                    # the divide form, as run_validation quantizes
                    ep_div = _int8_epilogue(g, ref, plan.writes, True, True)
                    _check(_same_outputs(
                        int8_conv.int8_conv(*conv, ep_div),
                        int8_conv.int8_conv_reference(*conv, ep_div)),
                        f"the fused int8 conv != twin at {lspec.name} "
                        f"({B},{h},{h},{C}) {plan.writes}, v / q")
                    checked += 1
                    del ep_div
                # the library yardstick on the unpadded operands
                lib_conv = conv if cp == C else (
                    x[..., :C].contiguous(), int8_conv.pack_weights(
                        wk[:, :ks * ks * cp].reshape(N, ks, ks, cp)[..., :C]
                        .permute(1, 2, 3, 0).contiguous()),
                    ks, lspec.stride, lspec.pad)
                a, wt = int8_conv.im2col_operands(*lib_conv)
                del lib_conv
                del ref
                product = _graph_ms(lambda: int8_conv.int8_conv(*conv))
                ms = _graph_ms(lambda: int8_conv.int8_conv(*conv, ep))
                plain = _graph_ms(lambda: int8_conv.int8_conv_reference(
                    *conv, ep), calls=3)
                lib = _graph_ms(lambda: torch._int_mm(a, wt))
                pbound = _int8_bound(x, C, (got,), ks)
                bound = _int8_bound(x, C, fused, ks,
                                    (ep.scale, ep.bias) + ((ep.quant,) if
                                                           ep.quant is not
                                                           None else ()))
                totals.update({"ms": ms, "product_ms": product,
                               "plain_ms": plain, "library_ms": lib,
                               "bound_ms": bound["bound_ms"],
                               "product_bound_ms": pbound["bound_ms"]})
                bound_parts[bound["bound_by"]] += bound["bound_ms"]
                tile = int8_conv.tile_for(got.numel() // N, N, ks * ks * cp)
                print(f"[int8] {tag} ({B},{size},{size}) {lspec.name} "
                      f"({B},{h},{h},{cp})->{N} {ks}x{ks} writes "
                      f"{plan.writes}, tile {tile}: = twin "
                      f"bit for bit (int32 and fused, v*q and v/q where it "
                      f"quantizes); device ms a call: "
                      f"product {product:.4f}, fused {ms:.4f}, fused twin "
                      f"{plain:.4f}, _int_mm {lib:.4f}; bound product "
                      f"{pbound['bound_ms']:.4f} ({pbound['bound_by']}), "
                      f"fused {bound['bound_ms']:.4f} ({bound['bound_by']}); "
                      f"product at {pbound['bound_ms'] / product:.1%}, fused "
                      f"at {bound['bound_ms'] / ms:.1%} of its bound [{card}]")
                del x, wk, got, fused, a, wt, ep
            print(f"[int8] {tag} ({B},{size},{size}), {len(layers)} int8 "
                  f"convs: fused {totals['ms']:.4f} ms, product "
                  f"{totals['product_ms']:.4f}, fused twin "
                  f"{totals['plain_ms']:.4f}, _int_mm "
                  f"{totals['library_ms']:.4f}; bound fused "
                  f"{totals['bound_ms']:.4f}, product "
                  f"{totals['product_bound_ms']:.4f} ms [{card}]")
            sums = {k: round(v, 4) for k, v in totals.items()}
            serves[f"{tag} ({B},{size},{size})"] = sums
            if result is None:
                result = {"max_abs_err": worst, **totals,
                          "bound_by": bound_parts.most_common(1)[0][0]}
            _free()
    result["max_abs_err"] = worst
    result["serves"] = serves
    print(f"[int8] kernel phase: {checked} comparisons, all bit for bit; "
          f"{time.perf_counter() - t0:.1f} s")
    return result


def _int8_params(spec, folded, frames):
    """The int8 pytree of ``folded`` with per-channel scales calibrated on
    the u8 ``frames`` / 255, as ``valid --quantize`` calibrates on the batch
    it then serves first."""
    from singleshotpose_tpu_torch.models import quantize as Q
    amax = Q.calibrate_activations(
        spec, folded, frames.float() / torch.full((), 255.0,
                                                  device=frames.device),
        per_channel=True)
    return Q.quantize_folded(spec, folded, amax)


def _gaps_at_picks(grid8, grid16, classes: int = 0):
    """(max|d keypoint|, max|d confidence|) between two decoded grids at
    the cells the bf16 grid picks: each image's most confident cell, or with
    ``classes`` each image's most confident cell of each class — the boxes
    the serve returns, held where a random net's near-tied picks cannot
    fall on different cells.  Also the gaps over every cell."""
    score = grid16.det_conf[:, :, None] * grid16.cls_probs if classes \
        else grid16.det_conf[:, :, None]
    idx = score.argmax(dim=1)                             # (B, C or 1)
    kp = (grid8.corners - grid16.corners).abs().amax(dim=-1)
    conf = (grid8.det_conf - grid16.det_conf).abs()
    return (float(kp.gather(1, idx).max()), float(conf.gather(1, idx).max()),
            float(kp.max()), float(conf.max()))


def _time_spread(fn, iters: int = INT8_TIMED):
    """(median, min, max) ms of ``fn()`` with CUDA events, after 3 calls."""
    for _ in range(3):
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
    return statistics.median(times), min(times), max(times)


def _twin_fed(fn, *args):
    """``fn(*args)`` with the int8 forward's conv the plain twin."""
    from singleshotpose_tpu_torch.models import quantize as Q
    with mock.patch.object(Q, "int8_conv", int8_conv.int8_conv_reference):
        return fn(*args)


def phase_int8_serve(spec, folded, multi, multi_folded, dev, card: str):
    """The int8 serve (``make_serving_fn`` and ``aot_serving`` over the
    int8 pytree): at batch 8 and 1, 672², and the multi per-class serve at
    batch 16, 416²; the boxes equal the twin-fed serve's bit for bit, eager
    and graph; within JAX's 0.05 (normalized keypoints, confidence,
    ``tests/test_quantize.py:97-109``) of the bf16 folded serve's at the
    cells it picks (:func:`_gaps_at_picks`); int8 and bf16 serves timed in
    turns.  Each int8 pytree is calibrated on the batch it serves, as
    ``valid --quantize`` calibrates on its first batch.
    Returns the int8 conv's launches (single, multi) in the eager serves
    and its captures and replays in the graphs."""
    gen = torch.Generator().manual_seed(163)
    frames = torch.randint(0, 256, (MODEL_BATCH, SIZE, SIZE, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
    x = {MODEL_BATCH: frames, 1: frames[:1].clone()}
    q = _int8_params(spec, folded, frames)
    n_q = sum("wq" in v for v in q.values())
    _check(n_q == 22, f"{n_q} quantized convs, not 22")
    serve = make_serving_fn(spec, q, pick=("best",))
    grid8 = make_serving_fn(spec, q)
    bf16 = make_serving_fn(spec, folded, pick=("best",))
    bf16_grid = make_serving_fn(spec, folded)
    # the main path: every int8 conv launch counted from here came from it
    int8_conv.int8_conv.launches = 0
    int8_conv.int8_conv.fused_launches = 0
    boxes = {b: serve(xb) for b, xb in x.items()}
    torch.cuda.synchronize()
    launches = int8_conv.int8_conv.launches
    _check(launches == 2 * n_q, f"the int8 serves launched the int8 conv "
                                f"{launches} times, not {2 * n_q}")
    _check(int8_conv.int8_conv.fused_launches == launches,
           f"{launches - int8_conv.int8_conv.fused_launches} int8 conv "
           f"launches of the serves ran without the epilogue")
    for b, xb in x.items():
        twin = _twin_fed(serve, xb)
        _check(_same_bits(boxes[b], twin),
               f"batch-{b} int8 boxes differ from the twin-fed serve's")
    kp_gap, conf_gap, kp_all, conf_all = _gaps_at_picks(
        grid8(frames), bf16_grid(frames))
    box_gap = (boxes[MODEL_BATCH] - bf16(frames)).abs()
    print(f"[int8 serve] yolo_pose_single {SIZE}²: {n_q} int8 convs (the head "
          f"conv bf16), per-channel scales calibrated on the {MODEL_BATCH} "
          f"served frames; the int8 conv launched {launches} times in a "
          f"batch-8 and a batch-1 serve; boxes = the twin-fed serve's bit for "
          f"bit (batch 8 and 1); against the bf16 serve at its best cells: "
          f"max|d keypoint| {kp_gap:.6g}, max|d confidence| {conf_gap:.6g} "
          f"(JAX's limits 0.05); every cell: {kp_all:.6g}, {conf_all:.6g}; "
          f"the best boxes themselves: max|d keypoint| "
          f"{float(box_gap[:, :18].max()):.6g}, max|d confidence| "
          f"{float(box_gap[:, 18].max()):.6g} [{card}]")
    _check(kp_gap < 0.05 and conf_gap < 0.05,
           f"int8 vs bf16: keypoints {kp_gap}, confidence {conf_gap}")

    before = int8_conv.int8_conv.launches
    fns = {b: aot_serving(spec, q, batch=b, width=SIZE, height=SIZE)
           for b in x}
    captured = int8_conv.int8_conv.launches - before
    _scribble(dev)
    for b, xb in x.items():
        mark = int8_conv.int8_conv.launches
        out = fns[b](xb)
        _check(int8_conv.int8_conv.launches == mark,
               "a graph replay ran the int8 wrapper")
        _check(_same_bits(out, boxes[b]),
               f"the batch-{b} int8 graph's boxes differ from the eager serve")
    _check(captured == 2 * 2 * n_q, f"{captured} int8 wrapper runs in the "
           f"warm-ups and captures of two graphs, not {4 * n_q}")
    times = {}
    for b, xb in x.items():
        for name, fn in (("int8 eager", serve), ("bf16 eager", bf16),
                         ("int8 graph", fns[b])):
            times[(b, name)] = []
        for which in ("int8 eager", "bf16 eager", "int8 graph",
                      "int8 graph", "bf16 eager", "int8 eager"):
            fn = {"int8 eager": serve, "bf16 eager": bf16,
                  "int8 graph": fns[b]}[which]
            times[(b, which)].append(_time_spread(functools.partial(fn, xb)))
    for (b, name), turns in times.items():
        print(f"[int8 serve] {SIZE}² batch {b} {name}: CUDA events, median "
              f"(min-max) of {INT8_TIMED} per turn: " + ", ".join(
                  f"{m:.4f} ({lo:.4f}-{hi:.4f})" for m, lo, hi in turns)
              + f" ms [{card}]")
    replays = sum(fn.replays for fn in fns.values())
    del fns
    _free()

    pick = ("per_class", multi.net.conf_thresh)
    mframes = torch.randint(0, 256, (MULTI_SERVE_BATCH, MULTI_SIZE,
                                     MULTI_SIZE, 3), generator=gen,
                            dtype=torch.uint8).to(dev)
    mq = _int8_params(multi, multi_folded, mframes)
    mserve = make_serving_fn(multi, mq, pick=pick)
    mbf16 = make_serving_fn(multi, multi_folded, pick=pick)
    int8_conv.int8_conv.launches = 0
    int8_conv.int8_conv.fused_launches = 0
    mboxes = mserve(mframes)
    torch.cuda.synchronize()
    launches_multi = int8_conv.int8_conv.launches
    _check(launches_multi == n_q and int8_conv.int8_conv.fused_launches ==
           n_q, f"the multi int8 serve launched the int8 conv "
                f"{launches_multi} times, "
                f"{int8_conv.int8_conv.fused_launches} with the epilogue")
    _check(_same_bits(mboxes, _twin_fed(mserve, mframes)),
           "multi int8 boxes differ from the twin-fed serve's")
    mkp, mconf, mkp_all, mconf_all = _gaps_at_picks(
        make_serving_fn(multi, mq)(mframes),
        make_serving_fn(multi, multi_folded)(mframes), multi.num_classes)
    before = int8_conv.int8_conv.launches
    mfn = aot_serving(multi, mq, batch=MULTI_SERVE_BATCH, width=MULTI_SIZE,
                      height=MULTI_SIZE, pick=pick)
    mcaptured = int8_conv.int8_conv.launches - before
    _scribble(dev)
    _check(_same_bits(mfn(mframes), mboxes),
           "the multi int8 graph's boxes differ from the eager serve's")
    mturns = {"int8 eager": [], "bf16 eager": [], "int8 graph": []}
    for which in ("int8 eager", "bf16 eager", "int8 graph", "int8 graph",
                  "bf16 eager", "int8 eager"):
        fn = {"int8 eager": mserve, "bf16 eager": mbf16,
              "int8 graph": mfn}[which]
        mturns[which].append(_time_spread(functools.partial(fn, mframes)))
    print(f"[int8 serve] yolo_pose_multi per-class {MULTI_SIZE}² batch "
          f"{MULTI_SERVE_BATCH}: the int8 conv launched {launches_multi} "
          f"times; boxes = the twin-fed serve's and the graph's bit for bit; "
          f"against bf16 at its best cell of each class: max|d keypoint| "
          f"{mkp:.6g}, max|d confidence| {mconf:.6g}; every cell: "
          f"{mkp_all:.6g}, {mconf_all:.6g}; CUDA events, median (min-max) of "
          f"{INT8_TIMED} per turn: " + "; ".join(
              f"{k} " + ", ".join(f"{m:.4f} ({lo:.4f}-{hi:.4f})"
                                  for m, lo, hi in v)
              for k, v in mturns.items()) + f" ms [{card}]")
    _check(mkp < 0.05 and mconf < 0.05,
           f"multi int8 vs bf16: keypoints {mkp}, confidence {mconf}")
    out = {"launches": launches, "launches_multi": launches_multi,
           "captures": captured // 2 // n_q, "replays": replays,
           "captures_multi": mcaptured // 2 // n_q,
           "replays_multi": mfn.replays}
    del mfn
    _free()
    return out


def phase_int8_cli(spec, model, dev, card: str, keep: str) -> int:
    """``cli quantize`` on a held-out split rendered in memory, its ``.npz``
    re-loaded: the same tensors and the same boxes as the pytree built in
    memory from the same calibration batch; ``run_validation`` with
    ``quantize=`` that path and ``quantize=True`` (per-channel scales from
    the first batch) on the card.  The ``.npz`` is copied into the
    directory ``keep`` (for phase 17).  Returns the int8 conv's launches in
    the two evals."""
    from singleshotpose_tpu_torch.cli import main as cli_main
    from singleshotpose_tpu_torch.models import quantize as Q
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_int8_")
    try:
        datacfg, _, _, frames = _data_corpus(root)
        wfile, qfile = f"{root}/model.weights", f"{root}/q.npz"
        W.save_weights(spec, model.state_dict(), wfile)
        with _reading_renders(frames):
            _check(cli_main(["quantize", "--datacfg", datacfg, "--modelcfg",
                             "yolo-pose", "--weightfile", wfile, "--out",
                             qfile, "--calib_images", str(INT8_CALIB),
                             "--device", "cuda"]) == 0, "cli quantize failed")
            shutil.copy(qfile, keep)
            from singleshotpose_tpu_torch.config import (
                data_config_from_options, read_data_cfg)
            ds = PoseDataset(data_config_from_options(
                read_data_cfg(datacfg)).valid, train=False)
            images, _ = next(iter(Loader(
                ds, INT8_CALIB, shuffle=False, schedule=None,
                fixed_shape=(SIZE, SIZE), num_workers=2, drop_last=False,
                out_uint8=True)))
            calib = torch.as_tensor(images).to(dev).float() \
                / torch.full((), 255.0, device=dev)
            folded = fold_batchnorm(model)
            mem = Q.quantize_folded(spec, folded, Q.calibrate_activations(
                spec, folded, calib, per_channel=True))
            loaded = Q.load_quantized(qfile, device=dev)
            same = all(_same_bits(loaded[k][f], v) for k, d in mem.items()
                       for f, v in d.items())
            x = torch.as_tensor(images).to(dev)
            b_file = make_serving_fn(spec, loaded, pick=("best",))(x)
            b_mem = make_serving_fn(spec, mem, pick=("best",))(x)
            int8_conv.int8_conv.launches = 0
            int8_conv.int8_conv.fused_launches = 0
            res_file = run_validation(datacfg, "yolo-pose", None,
                                      quantize=qfile, batch_size=8,
                                      num_workers=2, device="cuda",
                                      verbose=False)
            res_true = run_validation(datacfg, "yolo-pose", wfile,
                                      quantize=True, batch_size=8,
                                      num_workers=2, device="cuda",
                                      verbose=False)
            torch.cuda.synchronize()
            launches = int8_conv.int8_conv.launches
            fused = int8_conv.int8_conv.fused_launches
        n = DATA_EVAL_FRAMES
        print(f"[int8 cli] cli quantize on {INT8_CALIB} of {n} held-out "
              f"frames -> q.npz ({os.path.getsize(qfile)} bytes): its tensors "
              f"= the in-memory pytree's bits: {same}; its boxes = the "
              f"in-memory pytree's bit for bit: {_same_bits(b_file, b_mem)}; "
              f"run_validation(quantize=q.npz) / (quantize=True) on {n} "
              f"frames: {res_file['n_samples']} / {res_true['n_samples']} "
              f"samples, mean px {res_file['mean_err_2d']:.4f} / "
              f"{res_true['mean_err_2d']:.4f} (random weights), the int8 conv "
              f"launched {launches} times; {time.perf_counter() - t0:.1f} s "
              f"[{card}]")
        _check(same and _same_bits(b_file, b_mem),
               "the cli's artifact differs from the in-memory pytree")
        _check(res_file["n_samples"] == res_true["n_samples"] == n and
               np.isfinite(res_file["mean_err_2d"]) and
               np.isfinite(res_true["mean_err_2d"]), "the int8 evals failed")
        _check(launches == fused == 2 * 22 * (-(-n // 8)),
               f"the int8 evals launched the int8 conv {launches} times, "
               f"{fused} with the epilogue")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return launches


def phase_profile_int8(spec, folded, dev, card: str, out_dir: str) -> None:
    """The int8 serve's device time by kernel family and its idle share
    (``--profile``), at batch 8 and 1, 672², against the unprofiled host
    clock, as :func:`phase_profile` reads the bf16 serve."""
    gen = torch.Generator().manual_seed(164)
    q = _int8_params(spec, folded, torch.randint(
        0, 256, (MODEL_BATCH, SIZE, SIZE, 3), generator=gen,
        dtype=torch.uint8).to(dev))
    serve = make_serving_fn(spec, q, pick=("best",))
    os.makedirs(out_dir, exist_ok=True)
    for B in (MODEL_BATCH, 1):
        x = torch.randint(0, 256, (B, SIZE, SIZE, 3), generator=gen,
                          dtype=torch.uint8).to(dev)
        host = _host_ms(lambda: serve(x))
        path = os.path.join(out_dir, f"int8_serve_trace_b{B}.json")
        by_family, busy, _ = _profile(lambda: serve(x), PROFILE_CALLS, path)
        busy_ms = busy / 1e3 / PROFILE_CALLS
        total = sum(by_family.values())
        print(f"[profile] int8 serve batch {B}, {SIZE}²: host clock "
              f"{host:.4f} ms/call (median of 30, sync each call); device "
              f"busy {busy_ms:.4f} ms/call over {PROFILE_CALLS} profiled "
              f"calls; idle share {1 - busy_ms / host:.4f}; trace {path} "
              f"[{card}]")
        for fam, us in by_family.most_common():
            print(f"[profile]   {fam}: {us / 1e3 / PROFILE_CALLS:.4f} ms/call "
                  f"({us / total:.2%} of device time)")
        f64 = sum(us for fam, us in by_family.items() if fam.startswith("f64"))
        print(f"[profile]   f64 elementwise in the int8 serve: "
              f"{f64 / 1e3 / PROFILE_CALLS:.4f} ms/call")



# phase 17: the serving artifacts the fresh subprocess loads, with their
# inputs and the eager serve's boxes on each, as .npy files beside them
_EXPORT_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None                   # `import jax` raises
sys.modules["singleshotpose_tpu"] = None    # and so does the JAX package
import numpy as np, torch
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
from singleshotpose_tpu_torch.ops import int8_conv, stem
from singleshotpose_tpu_torch.serving import load_serving
root, cases = sys.argv[1], json.loads(sys.argv[2])
out = {}
for name, batches in cases.items():
    t = time.perf_counter()
    serve = load_serving(f"{root}/{name}.pt2")
    out[name] = {"load_s": time.perf_counter() - t, "calls": []}
    for b in batches:
        x = np.load(f"{root}/{name}_x{b}.npy")
        want = np.load(f"{root}/{name}_want{b}.npy")
        stem.stem_conv_pool_infer.launches = 0
        int8_conv.int8_conv.launches = int8_conv.int8_conv.fused_launches = 0
        got = serve(x).cpu().numpy()
        torch.cuda.synchronize()
        out[name]["calls"].append({
            "batch": b, "same": got.shape == want.shape and bool(
                np.array_equal(got.view(np.uint32), want.view(np.uint32))),
            "k1": stem.stem_conv_pool_infer.launches,
            "int8": int8_conv.int8_conv.launches,
            "fused": int8_conv.int8_conv.fused_launches})
used = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "singleshotpose_tpu") and sys.modules[m] is not None)
print("EXPORT_CHILD " + json.dumps({"cases": out, "jax_modules": used}))
"""
# the batches each artifact serves: the single-object ones at the serve's
# batch and at 1, the multi per-class one at its serve batch
EXPORT_BATCHES = (MODEL_BATCH, 1)


def _export_counts():
    return (stem.stem_conv_pool_infer.launches, int8_conv.int8_conv.launches,
            int8_conv.int8_conv.fused_launches)


def _zero_counts():
    stem.stem_conv_pool_infer.launches = 0
    int8_conv.int8_conv.launches = int8_conv.int8_conv.fused_launches = 0


def phase_export(spec, folded, multi, multi_folded, qfile: str, dev,
                 card: str) -> dict:
    """``export_serving`` → ``save_exported`` → ``load_serving`` on the
    card: ``yolo_pose_single`` bf16 at 672², batch-polymorphic, ``("best",)``
    (phase 4's weights); the same model exported on the CPU and loaded with
    ``device="cuda"``; ``cli export --quantized`` on phase 16's ``cli
    quantize`` ``.npz``; the multi per-class serve at batch 16, 416², with a
    symbolic batch.  Each loaded artifact's boxes equal the eager
    ``make_serving_fn``'s on the same batch bit for bit (cuDNN picks its
    convs by batch size: equal batches are compared), K1 launched once a
    bf16 call and the int8 conv 22 times a call, all fused; the same in a
    fresh subprocess with jax and the JAX package blocked; the bf16 artifact
    behind a ``MicroBatcher`` of one bucket of 16, 16 frames from 4 client
    threads, each answer equal to one direct batch-16 call bit for bit.
    Export s, saved MB and load s on the host clock; the artifacts' ms per
    call against the eager serves', in turns, CUDA events.  Returns the
    kernels' launches in the in-process artifact calls (K1, the int8 conv)
    and the numbers."""
    from singleshotpose_tpu_torch.cli import main as cli_main
    from singleshotpose_tpu_torch.models import quantize as Q
    from singleshotpose_tpu_torch.serving import (export_serving,
                                                  load_serving, save_exported)
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_export_")
    nums = {}
    try:
        gen = torch.Generator().manual_seed(170)
        frames = torch.randint(0, 256, (MODEL_BATCH, SIZE, SIZE, 3),
                               generator=gen, dtype=torch.uint8)
        x = {b: frames[:b].clone() for b in EXPORT_BATCHES}
        mx = torch.randint(0, 256, (MULTI_SERVE_BATCH, MULTI_SIZE, MULTI_SIZE,
                                    3), generator=gen, dtype=torch.uint8)
        pick_m = ("per_class", multi.net.conf_thresh)

        def timed_export(name, fn):
            t = time.perf_counter()
            exported = fn()
            nums[f"{name}_export_s"] = time.perf_counter() - t
            path = f"{root}/{name}.pt2"
            save_exported(path, exported)
            nums[f"{name}_mb"] = os.path.getsize(path) / 1e6
            return path

        timed_export("bf16", lambda: export_serving(
            spec, folded, width=SIZE, height=SIZE))
        folded_cpu = {k: {f: v.cpu() for f, v in d.items()}
                      for k, d in folded.items()}
        timed_export("bf16_cpu", lambda: export_serving(
            spec, folded_cpu, width=SIZE, height=SIZE))
        del folded_cpu
        t = time.perf_counter()
        _check(cli_main(["export", "--modelcfg", "yolo-pose", "--quantized",
                         qfile, "--out", f"{root}/int8.pt2", "--width",
                         str(SIZE), "--height", str(SIZE), "--device",
                         str(dev)]) == 0, "cli export --quantized failed")
        nums["int8_export_s"] = time.perf_counter() - t
        nums["int8_mb"] = os.path.getsize(f"{root}/int8.pt2") / 1e6
        timed_export("multi", lambda: export_serving(
            multi, multi_folded, width=MULTI_SIZE, height=MULTI_SIZE,
            pick=pick_m))

        loaded = {}
        # the card by default; the CPU export moved to the card by name
        for name, kw in (("bf16", {}), ("bf16_cpu", {"device": dev}),
                         ("int8", {}), ("multi", {})):
            t = time.perf_counter()
            loaded[name] = load_serving(f"{root}/{name}.pt2", **kw)
            torch.cuda.synchronize()
            nums[f"{name}_load_s"] = time.perf_counter() - t
        q = Q.load_quantized(qfile, device=dev)
        n_q = sum("wq" in v for v in q.values())
        eager = {"bf16": make_serving_fn(spec, folded, pick=("best",)),
                 "int8": make_serving_fn(spec, q, pick=("best",)),
                 "multi": make_serving_fn(multi, multi_folded, pick=pick_m)}
        eager["bf16_cpu"] = eager["bf16"]
        inputs = {"bf16": x, "bf16_cpu": x, "int8": x,
                  "multi": {MULTI_SERVE_BATCH: mx}}
        # (K1, int8 conv) launches a call
        per_call = {"bf16": (1, 0), "bf16_cpu": (1, 0), "int8": (0, n_q),
                    "multi": (1, 0)}

        # the main path: every launch counted from here came from the
        # loaded artifacts
        _zero_counts()
        got, calls = {}, 0
        for name, fn in loaded.items():
            for b, xb in inputs[name].items():
                before = _export_counts()
                got[(name, b)] = fn(xb)
                torch.cuda.synchronize()
                k1, n8, f8 = (a - c for a, c in zip(_export_counts(), before))
                _check((k1, n8) == per_call[name] and f8 == n8,
                       f"the {name} artifact at batch {b} launched K1 {k1} "
                       f"times and the int8 conv {n8} ({f8} fused), not "
                       f"{per_call[name]}")
                calls += 1
        launches = _export_counts()
        same = {}
        for (name, b), out in got.items():
            want = eager[name](inputs[name][b])
            same[(name, b)] = _same_bits(out, want)
            np.save(f"{root}/{name}_x{b}.npy", inputs[name][b].numpy())
            np.save(f"{root}/{name}_want{b}.npy", want.cpu().numpy())
        cross = all(_same_bits(got[("bf16_cpu", b)], got[("bf16", b)])
                    for b in EXPORT_BATCHES)
        _check(all(same.values()), "artifacts differ from the eager serve: " +
               ", ".join(f"{k}" for k, v in same.items() if not v))
        _check(cross, "the CPU-exported artifact differs on the card from the "
                      "card-exported one")

        # the same three artifacts in a fresh process without jax
        cases = {"bf16": list(EXPORT_BATCHES), "int8": list(EXPORT_BATCHES),
                 "multi": [MULTI_SERVE_BATCH]}
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", _EXPORT_CHILD, root, json.dumps(cases)],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(os.environ, PYTHONPATH=os.path.dirname(
                os.path.abspath(__file__))),
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t
        _check(proc.returncode == 0, f"the export subprocess failed: "
                                     f"{proc.stderr[-3000:]}")
        child = json.loads(next(
            line for line in proc.stdout.splitlines()
            if line.startswith("EXPORT_CHILD "))[len("EXPORT_CHILD "):])
        _check(not child["jax_modules"], f"the subprocess imported "
                                         f"{child['jax_modules']}")
        for name, res in child["cases"].items():
            for c in res["calls"]:
                _check(c["same"], f"the subprocess's {name} artifact at batch "
                                  f"{c['batch']} differs from the eager serve")
                _check((c["k1"], c["int8"]) == per_call[name] and
                       c["fused"] == c["int8"],
                       f"the subprocess's {name} artifact at batch "
                       f"{c['batch']}: K1 {c['k1']}, int8 conv {c['int8']} "
                       f"({c['fused']} fused), not {per_call[name]}")

        # 16 frames from 4 clients through one bucket of 16
        mb_frames = torch.randint(0, 256, (N_FRAMES, SIZE, SIZE, 3),
                                  generator=gen, dtype=torch.uint8).numpy()
        direct = loaded["bf16"](mb_frames).cpu()
        answers = [None] * N_FRAMES
        with MicroBatcher(loaded["bf16"], height=SIZE, width=SIZE,
                          buckets=(N_FRAMES,)) as mb:
            def client(k):
                for i in range(k, N_FRAMES, N_CLIENTS):
                    answers[i] = mb.infer(mb_frames[i], timeout=300)
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(N_CLIENTS)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=600)
            _check(not any(th.is_alive() for th in threads),
                   "client threads hung")
        batched = _same_bits(torch.stack(answers), direct)
        _check(batched, "the MicroBatcher's answers from the artifact differ "
                        "from one direct batch-16 call")

        turns = {}
        for name in ("bf16", "int8"):
            for b in EXPORT_BATCHES:
                xb = x[b].to(dev)
                fns = {"eager": eager[name], "artifact": loaded[name]}
                for which in ("eager", "artifact", "artifact", "eager"):
                    turns.setdefault((name, b, which), []).append(
                        _time_spread(functools.partial(fns[which], xb)))
        nums["turns"] = {f"{n} b{b} {w}": v for (n, b, w), v in turns.items()}

        print(f"[export] yolo_pose_single bf16 {SIZE}², symbolic batch, "
              f"best: export {nums['bf16_export_s']:.2f} s, "
              f"{nums['bf16_mb']:.1f} MB, load {nums['bf16_load_s']:.2f} s; "
              f"exported on the CPU ({nums['bf16_cpu_export_s']:.2f} s, "
              f"{nums['bf16_cpu_mb']:.1f} MB) and loaded with device=cuda "
              f"({nums['bf16_cpu_load_s']:.2f} s): boxes = the card export's "
              f"bit for bit at batch {EXPORT_BATCHES}: {cross}; cli export "
              f"--quantized: {nums['int8_export_s']:.2f} s, "
              f"{nums['int8_mb']:.1f} MB, load {nums['int8_load_s']:.2f} s; "
              f"multi per-class {MULTI_SIZE}²: export "
              f"{nums['multi_export_s']:.2f} s, {nums['multi_mb']:.1f} MB, "
              f"load {nums['multi_load_s']:.2f} s [{card}]")
        print(f"[export] {calls} artifact calls = the eager serves bit for "
              f"bit; K1 launched {launches[0]} times (once a bf16 call), the "
              f"int8 conv {launches[1]} ({launches[2]} fused; {n_q} a "
              f"call); a "
              f"fresh process with jax blocked ({child_s:.1f} s) loaded "
              f"bf16 / int8 / multi in " + " / ".join(
                  f"{child['cases'][n]['load_s']:.2f}" for n in cases)
              + " s, every call = the eager serve bit for bit with the same "
              f"launches; a MicroBatcher of one bucket of {N_FRAMES} over the "
              f"bf16 artifact, {N_CLIENTS} clients x {N_FRAMES} frames = one "
              f"direct batch-{N_FRAMES} call bit for bit: {batched}")
        for (name, b, which), v in turns.items():
            print(f"[export] {name} {SIZE}² batch {b} {which}: CUDA events, "
                  f"median (min-max) of {INT8_TIMED} per turn: " + ", ".join(
                      f"{m:.4f} ({lo:.4f}-{hi:.4f})" for m, lo, hi in v)
                  + f" ms [{card}]")
        print(f"[export] phase {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"k1": launches[0], "int8": launches[1], "numbers": nums}


# the data-parallel phase (phase 18): two gloo ranks sharing cuda:0 (NCCL
# refuses two ranks on one card) and, beside them, one NCCL rank (--dp 1),
# each a spawned process; what every process draws comes from the seeds
# below, on the CPU or from a card generator, so they all hold the same
# model, batches and kernel inputs
DP_WORLD, DP_STEPS, DP_TIMED, DP_SEED = 2, 3, 5, 80
DP_TIMEOUT = datetime.timedelta(seconds=300)   # a lost rank fails the phase
# the NCCL rank's captured step: three of SINGLE_SCHEDULE's widths, and 10
# steps across them and the pretrain gate
DP_CAPTURED_WIDTHS = (320, 416, 608)
DP_CAPTURED_SEQUENCE = (416, 416, 320, 608, 416, 608, 320, 416, 608, 320)
DP_CAPTURED_EPOCHS = (15,) * 5 + (16,) * 5


def _dp_model(spec, dev) -> Darknet:
    return _random_model(spec, dev, DP_SEED)


def _dp_stem_inputs(dev):
    """The stem alone at (TRAIN_BATCH, TRAIN_SIZE, TRAIN_SIZE): images, w,
    scale, bias and a cotangent of pooled, from a CPU generator."""
    g = torch.Generator().manual_seed(DP_SEED + 2)
    B, H = TRAIN_BATCH, TRAIN_SIZE
    out = (torch.rand((B, H, H, 3), generator=g),
           torch.randn((32, 3, 3, 3), generator=g) * 0.3,
           torch.rand((32,), generator=g) + 0.5,
           torch.randn((32,), generator=g) * 0.1,
           torch.randn((B, H // 2, H // 2, 32), generator=g))
    return [t.to(dev) for t in out]


def _dp_stem(inputs, group=None) -> dict:
    """The fused train stem (K3–K6) and the gradients of Σ pooled·cot;
    under ``group`` on this rank's rows, the gradients summed over the
    ranks as the train step sums them."""
    img, w, scale, bias, cot = inputs
    if group is not None:
        img, cot = shard_host_batch(group, img, cot)
    w, scale, bias = (t.clone().requires_grad_(True) for t in (w, scale, bias))
    pooled, mean, var = stem.stem_conv_bn_pool_train(img, w, scale, bias,
                                                     group)
    (pooled.float() * cot).sum().backward()
    if group is not None:
        all_reduce_grads([w, scale, bias], group)
    torch.cuda.synchronize()
    return {"pooled": pooled.detach(), "mean": mean, "var": var,
            "dw": w.grad, "dscale": scale.grad, "dbias": bias.grad}


def _dp_k2_inputs(dev):
    """K2's inputs at the train step's shape, one valid slot an image."""
    g = torch.Generator(device=dev).manual_seed(DP_SEED + 3)
    return _corners_near_gt(dev, TRAIN_BATCH, 50, (TRAIN_SIZE // 32) ** 2, g,
                            n=1)


def _dp_steps(spec, dev, group=None, n: int = DP_STEPS):
    """``n`` fused bf16 steps of the seeded model on the seeded batch-8
    416² batches (under ``group``: this rank's rows, the state first
    broadcast from rank 0 as the drivers do, and on a data × model grid
    split over the model axis).  Returns (state, losses, the whole state
    after the first step — gathered on a grid —, the step)."""
    net = spec.net
    state = init_train_state(_dp_model(spec, dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    if group is not None:
        shard_train_state(group, state)
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=15,
                                im_width=IM_W, im_height=IM_H)
    step = make_train_step(cfg, compute_dtype=torch.bfloat16,
                           fused_stem=True, group=group)
    losses, first = [], None
    for i, (frames, labels) in enumerate(_train_batches(dev, n,
                                                         DP_SEED + 1)):
        if group is not None:
            frames, labels = shard_host_batch(group, frames, labels)
        losses.append(step(state, frames, labels, _lr(spec, i),
                           TRAIN_EPOCH)["loss"])
        if i == 0:
            whole = state if group is None else \
                gather_train_state(group, state)
            first = {k: v.detach().clone()
                     for k, v in whole.model.state_dict().items()}
    torch.cuda.synchronize()
    return state, torch.stack(losses), first, step


def _state_sha(state) -> str:
    """SHA-256 of every tensor of a train state (parameters, BN statistics,
    momentum buffers) and ``seen``."""
    h = hashlib.sha256(str(state.seen).encode())
    tensors = list(state.model.state_dict().values()) + [
        state.optimizer.state[p]["momentum_buffer"]
        for p in state.model.parameters()]
    for t in tensors:
        h.update(t.detach().contiguous().cpu().view(torch.uint8).numpy())
    return h.hexdigest()


def _dp_frames(root: str) -> dict:
    with open(f"{root}/frames.json") as f:
        paths = json.load(f)
    arrays = np.load(f"{root}/frames.npz")
    return {p: arrays[f"f{i}"] for i, p in enumerate(paths)}


def _dp_gloo_rank(spec, dev, rank: int, port: int, root: str) -> dict:
    """One of two gloo ranks on this card: the stem alone on its rows, K2 on
    its rows, DP_STEPS data-parallel steps (K2–K6 counted from 0) and
    DP_TIMED more timed, and ``run_validation`` over the ranks (K1
    counted from 0)."""
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=DP_WORLD, rank=rank, device=dev,
                           timeout=DP_TIMEOUT)
    group = make_dp_group(DP_WORLD, device=dev)
    out = {"stem": _dp_stem(_dp_stem_inputs(dev), group)}
    gt, valid, pred = _dp_k2_inputs(dev)
    gt, valid = shard_host_batch(group, gt, valid)
    pred, _ = shard_host_batch(group, pred, valid)
    out["k2"] = mcc.max_corner_confidence(gt, valid, pred)
    for f in _TRAIN_COUNTED:
        f.launches = 0
    state, losses, first, step = _dp_steps(spec, dev, group)
    out["launches"] = _launches()
    out.update(losses=losses, sha=_state_sha(state), seen=state.seen,
               first={k: first[k] for k in ("conv_1.weight", "conv_2.weight",
                                            "conv_1.running_mean")})
    if rank == 0:
        out["state"] = {k: v.detach().cpu().clone() for k, v in
                        state.model.state_dict().items()}
    frames, labels = shard_host_batch(
        group, *_train_batches(dev, 1, DP_SEED + 1)[0])
    out["step_ms"] = _step_ms(step, state, [(frames, labels)], spec,
                              DP_TIMED)
    del state, step
    stem.stem_conv_pool_infer.launches = 0
    with _reading_renders(_dp_frames(root)):
        out["eval"] = run_validation(
            f"{root}/obj.data", spec, model=_dp_model(spec, dev),
            batch_size=TRAIN_BATCH, num_workers=4, verbose=False,
            group=group)
    torch.cuda.synchronize()
    out["k1"] = stem.stem_conv_pool_infer.launches
    dist.destroy_process_group()
    return out


def _counting_collectives(counts: collections.Counter,
                          ops=("all_reduce",)):
    """While active, each ``torch.distributed`` function named in ``ops``
    counts its calls in ``counts``: under ``"captured"`` those issued while
    the current stream records a CUDA graph (so recorded into it), under
    ``"eager"`` the rest, and under ``"<op> captured"``/``"<op> eager"``
    each op's own."""
    def counting(op, real):
        def fn(*args, **kwargs):
            mode = ("captured" if torch.cuda.is_available() and
                    torch.cuda.is_current_stream_capturing() else "eager")
            counts[mode] += 1
            counts[f"{op} {mode}"] += 1
            return real(*args, **kwargs)
        return fn

    return mock.patch.multiple(dist, **{op: counting(op, getattr(dist, op))
                                        for op in ops})


# what a grid step runs besides the all-reduces: the model group's channel
# gathers and the broadcast of the replicated gradients
GRID_COLLECTIVES = ("all_reduce", "all_gather", "broadcast")


def _dp_captured(spec, dev, group, *, decay_bn_bias: bool = True,
                 timed: bool = False, ops=("all_reduce",)) -> dict:
    """The NCCL group-of-one step captured by ``drivers._precompile_buckets``
    at DP_CAPTURED_WIDTHS, as ``run_training(precompile_buckets=True)``
    builds it for a group, against the eager step of the same group: from
    one seeded state (``init_train_state(decay_bn_bias=)``, broadcast over
    the group and split on a grid), 10 steps over DP_CAPTURED_SEQUENCE and
    DP_CAPTURED_EPOCHS each way on this rank's rows of the same host
    batches through ``drivers._to_device``.
    Records what each graph recorded (K2–K6 and the collectives named in
    ``ops``), the capture's seconds and the memory it reserved, the
    replays, the bits of the losses and of every state tensor (on a data ×
    model grid this rank's split state, and the SHA-256 of each state
    gathered whole); ``timed``: the captured and the eager step at 416² in
    turns, (median, min, max) ms of TIMED_STEPS steps each."""
    net = spec.net
    cfg = loss_config_from_spec(spec, pretrain_num_epochs=15, im_width=IM_W,
                                im_height=IM_H)

    def setup():
        state = init_train_state(_dp_model(spec, dev),
                                 weight_decay=net.decay * net.batch,
                                 momentum=net.momentum,
                                 decay_bn_bias=decay_bn_bias)
        shard_train_state(group, state)
        return state, make_train_step(cfg, compute_dtype=torch.bfloat16,
                                      fused_stem=True, group=group)

    (cap_state, cap_step), (eager_state, step) = setup(), setup()
    host = torch.device("cpu")
    batches = [shard_host_batch(group, *(t.numpy() for t in _train_batches(
        host, 1, seed=DP_SEED * 10 + i, size=w)[0]))
        for i, w in enumerate(DP_CAPTURED_SEQUENCE)]
    counts = collections.Counter()
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    t0 = time.perf_counter()
    with _counting_captures(), _counting_collectives(counts, ops):
        captured = _precompile_buckets(cap_step, cap_state,
                                       DP_CAPTURED_WIDTHS,
                                       TRAIN_BATCH // group.world,
                                       spec.num_keypoints)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
        # as run_training leaves it: only the captured step holds the step
        del cap_step
        _scribble(dev)
        out = {"per_graph": [c[1:] for c in _CountingGraph.captured],
               "reduces_captured": counts["captured"],
               "collectives_captured": {op: counts[f"{op} captured"]
                                        for op in ops},
               "capture_s": capture_s,
               "capture_s_per_width": {shape[2]: t for shape, t in
                                       captured.capture_seconds.items()},
               "reserved_gib": (torch.cuda.memory_reserved(dev) - reserved)
               / 2**30,
               "reserved_total_gib": torch.cuda.memory_reserved(dev) / 2**30}
        for f in _TRAIN_COUNTED:
            f.launches = 0
        cap_losses = _run_steps(captured, cap_state, batches,
                                DP_CAPTURED_EPOCHS, spec, dev)
        out["wrapped"] = _launches()
        counts.clear()
        eager_losses = _run_steps(step, eager_state, batches,
                                  DP_CAPTURED_EPOCHS, spec, dev)
        torch.cuda.synchronize()
        out["reduces_eager_step"] = counts["eager"] / len(batches)
        out["collectives_eager_step"] = {
            op: counts[f"{op} eager"] / len(batches) for op in ops}
        out["replays"] = _CountingGraph.replays
    diffs, n = _state_diffs(cap_state, eager_state)
    if group.mp > 1:
        out["sha"] = [_state_sha(gather_train_state(group, st))
                      for st in (cap_state, eager_state)]
    out.update(replays_step=captured.replays, tensors=n, diffs=diffs[:10],
               same_losses=_same_bits(cap_losses, eager_losses),
               losses=cap_losses, finite=bool(torch.isfinite(
                   cap_losses).all()),
               seen=(cap_state.seen, eager_state.seen))
    if timed:
        frames, labels = [(_to_device(f, dev), _to_device(t, dev))
                          for (f, t), w in zip(batches, DP_CAPTURED_SEQUENCE)
                          if w == TRAIN_SIZE][0]
        turns = {"captured": [], "eager": []}
        # CUDA events on the current stream, which NCCL's stream joins
        # before the step returns
        for which in ("captured", "eager", "eager", "captured"):
            fn, st = (captured, cap_state) if which == "captured" else \
                (step, eager_state)
            turns[which].append(_time_spread(
                lambda: fn(st, frames, labels, _lr(spec, 0), TRAIN_EPOCH),
                iters=TIMED_STEPS))
        out["turns"] = turns
    return out


def _dp_run_training(spec, dev, group, root: str) -> dict:
    """``drivers.run_training(group=..., precompile_buckets=True)`` for one
    epoch of phase 14's renders (the host Python loader, read from memory)
    at ``yolo_pose_single``'s batch 8, no eval: every SINGLE_SCHEDULE width
    captured with the group's collectives, every step a replay."""
    from singleshotpose_tpu_torch.drivers import run_training
    rc = TrainRunConfig(group=group, precompile_buckets=True,
                        max_epochs_override=1, num_workers=8, log_every=4,
                        bg_dir=f"{root}/no_bg", eval_every=1000,
                        eval_after=1000, loader_backend="python")
    for f in _TRAIN_COUNTED:
        f.launches = 0
    t = time.perf_counter()
    with _reading_renders(_dp_frames(root)), _counting_captures():
        result = run_training(f"{root}/obj.data", spec, None, 15, rc)
        torch.cuda.synchronize()
        replays = _CountingGraph.replays
        per_graph = [c[1:] for c in _CountingGraph.captured]
    with open(f"{root}/train.txt") as f:
        frames = sum(1 for ln in f if ln.strip())
    return {"per_graph": per_graph, "replays": replays, "frames": frames,
            "launches": _launches(), "seconds": time.perf_counter() - t,
            "losses": result["history"]["training_losses"],
            "seen": result["state"].seen}


def _wait_for(flag: str, root: str) -> None:
    """Wait until ``flag`` exists; raise once ``root`` is gone (the phase
    failed and cleaned up) or after DP_TIMEOUT."""
    t = time.perf_counter()
    while not os.path.exists(flag):
        if not os.path.isdir(root) or \
                time.perf_counter() - t > DP_TIMEOUT.total_seconds():
            raise RuntimeError(f"{flag} never came")
        time.sleep(0.05)


def _dp_nccl_rank(spec, dev, root: str) -> dict:
    """``--dp 1`` through NCCL: one step with a group of one against the
    step with none, from one state; the group's step captured against its
    eager steps (:func:`_dp_captured`), by default and with
    ``decay_bn_bias=False``; ``run_training`` with the group and
    ``precompile_buckets`` (:func:`_dp_run_training`); then ``cli valid
    --dp 1`` (its group of one in this process, as the CLI runs it outside
    ``torchrun``) against ``cli valid``, the summaries recorded from
    ``drivers.run_validation``."""
    import singleshotpose_tpu_torch.drivers as drivers_mod
    from singleshotpose_tpu_torch import cli
    group = make_dp_group(1, device=dev)
    out = {"backend": group.backend}
    (a, la, _, _), (b, lb, _, _) = (_dp_steps(spec, dev, g, n=1)
                                    for g in (None, group))
    diffs, n = _state_diffs(a, b)
    out.update(step_equal=not diffs and _same_bits(la, lb), tensors=n,
               diffs=diffs[:3], seen=(a.seen, b.seen))
    del a, b
    t = time.perf_counter()
    out["captured_no_decay"] = _dp_captured(spec, dev, group,
                                            decay_bn_bias=False)
    _free()
    out["run_training"] = _dp_run_training(spec, dev, group, root)
    _free()
    # the timed run waits until the gloo ranks are done with the card
    t_wait = time.perf_counter()
    _wait_for(f"{root}/gloo_done", root)
    out["waited_s"] = time.perf_counter() - t_wait
    out["captured"] = _dp_captured(spec, dev, group, timed=True)
    out["captured_s"] = time.perf_counter() - t - out["waited_s"]
    _free()
    dist.destroy_process_group()
    summaries, real = [], drivers_mod.run_validation
    args = ["valid", "--datacfg", f"{root}/obj.data", "--modelcfg",
            "yolo-pose", "--weightfile", f"{root}/dp.weights",
            "--batch_size", str(TRAIN_BATCH), "--device", dev.type]
    with _reading_renders(_dp_frames(root)), \
            mock.patch.object(drivers_mod, "run_validation",
                              lambda *a, **k: summaries.append(
                                  real(*a, **k)) or summaries[-1]):
        _check(cli.main(args + ["--dp", "1"]) == 0, "valid --dp 1")
        _check(cli.main(args) == 0, "valid")
    out["summaries"] = summaries
    return out


def _dp_child(rank: int, backend: str, port: int, root: str,
              device: str) -> None:
    """A spawned process of phase 18 on ``device`` (``backend`` gloo: rank
    ``rank`` of DP_WORLD; nccl: the one rank of ``--dp 1``); its results
    go to ``root/<backend><rank>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    spec = yolo_pose_single()
    if backend == "gloo":
        out = _dp_gloo_rank(spec, dev, rank, port, root)
    else:
        out = _dp_nccl_rank(spec, dev, root)
    torch.save(_to_cpu(out), f"{root}/{backend}{rank}.pt")


def _to_cpu(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x


def _summary_gap(got: dict, want: dict) -> float:
    """The largest relative difference between two eval summaries' values
    (NaN where both are NaN counts as equal)."""
    gap = 0.0
    for k in want:
        a, b = float(got[k]), float(want[k])
        if not (np.isnan(a) and np.isnan(b)):
            gap = max(gap, abs(a - b) / max(abs(b), 1e-30))
    return gap


def _split_serve(spec, folded, batch, dev) -> dict:
    """A batch served whole and as its DP_WORLD parts (the ranks' rows):
    K1 alone on the frames (seeded weights), both ways; the decoded heads
    before the pick (every cell's corners and confidence) and the best
    boxes, both ways; which images pick another cell, the batch-8
    confidence margin between the two cells there, and the boxes' gap
    image by image."""
    g = torch.Generator(device=dev).manual_seed(DP_SEED + 4)
    w = torch.randn((32, 3, 3, 3), generator=g, device=dev) * 0.2
    b = torch.randn((32,), generator=g, device=dev) * 0.2
    img = batch.to(dev).float() / 255
    k1_same = _same_bits(stem.stem_conv_pool_infer(img, w, b), torch.cat(
        [stem.stem_conv_pool_infer(h, w, b) for h in img.chunk(DP_WORLD)]))
    serve, grid = (make_serving_fn(spec, folded, pick=(p,))
                   for p in ("best", "grid"))
    parts = batch.chunk(DP_WORLD)
    box_gap = (serve(batch) - torch.cat([serve(h) for h in parts])) \
        .abs().amax(dim=1)
    whole = grid(batch)
    split = DecodedGrid(*(torch.cat(f) for f in zip(*map(grid, parts))))
    pick_whole = whole.det_conf.argmax(dim=1)
    pick_split = split.det_conf.argmax(dim=1)
    rows = torch.arange(len(batch), device=dev)
    flipped = pick_whole != pick_split
    torch.cuda.synchronize()
    return {
        "k1_same": k1_same,
        "corner_gap": float((whole.corners - split.corners).abs().max()),
        "conf_gap": float((whole.det_conf - split.det_conf).abs().max()),
        "flipped": flipped.nonzero().flatten().tolist(),
        "margin": (whole.det_conf[rows, pick_whole]
                   - whole.det_conf[rows, pick_split])[flipped].tolist(),
        "box_gap": box_gap.tolist(),
        "kept_gap": float(box_gap[~flipped].max()) if (~flipped).any()
        else 0.0}


def phase_dp(spec, dev, card: str) -> dict:
    """Phase 18: data parallel on this card at full width.  Two gloo ranks
    (4 rows each of the batch-8 416² bf16 fused step, spawned) against one
    process on the whole batch: the first step's loss rel 1e-3, conv_1's
    and conv_2's weights atol 6e-4 and conv_1's running mean atol 1e-5 (the
    JAX package's bounds for its sharded bf16 step), the ranks the same
    bytes after DP_STEPS steps (the largest difference from one process
    printed), K2–K6 launched once a rank a step; the stem alone at
    (8, 416, 416) over the ranks against the one-process kernels (mean and
    var atol 1e-5, pooled within 1 % of its max, dW, dscale, dbias rel
    2e-3); K2 on each rank's rows = those rows of the global launch bit for
    bit; ``run_validation`` over the ranks at 672² (K1 on each rank, its
    batches of 8 served 4 rows a rank) on phase 14's held-out renders
    against one process at the ranks' batch of 4 (the same frames in each
    call of the serve): the same summary, bit for bit.  Against one process
    at batch 8 the summary is printed, not held: cuDNN picks its convs by
    batch, so boxes move by an ulp or two (their largest difference is
    printed), and PnP on a random net's corners can turn that into a
    different pose (on an H100 80GB HBM3 at 700 W: mean px 1339.67 over
    the ranks against 1238.84 at batch 8).  Where the boxes move is shown
    on the first 8 frames served whole and as two halves
    (:func:`_split_serve`): K1 the same bits both ways, the decoded heads
    before the pick within 0.05 at every cell, and the images whose pick
    falls on another cell with the margin between the two cells.  Beside
    them one NCCL rank: a step with a group of one = the step with none bit
    for bit; the group's step captured at three widths = its eager steps
    bit for bit, by default and with ``decay_bn_bias=False``, K2–K6 and the
    step's all-reduces recorded once in each graph, the captured and the
    eager step in turns once the gloo ranks are done with the card;
    ``run_training`` with the group and ``precompile_buckets`` for one
    epoch (20 graphs, every step a replay); and ``cli valid --dp 1`` =
    ``cli valid``.  Returns the per-rank launches and the NCCL graphs'
    captures and replays."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_dp_")
    try:
        datacfg, _, _, frames = _data_corpus(root)
        with open(f"{root}/test.txt") as f:
            paths = [ln.strip() for ln in f if ln.strip()]
        # every render: the NCCL rank trains an epoch on the train split
        np.savez(f"{root}/frames.npz",
                 **{f"f{i}": a for i, a in enumerate(frames.values())})
        with open(f"{root}/frames.json", "w") as f:
            json.dump(list(frames), f)
        model = _dp_model(spec, dev)
        W.save_weights(spec, model.state_dict(), f"{root}/dp.weights")
        ctx = torch.multiprocessing.start_processes(
            _dp_child, args=("gloo", free_port(), root, str(dev)),
            nprocs=DP_WORLD, join=False, start_method="spawn")
        nccl = torch.multiprocessing.start_processes(
            _dp_child, args=("nccl", 0, root, str(dev)), nprocs=1,
            join=False, start_method="spawn")
        # the one-process references while the ranks start
        ref_stem = _dp_stem(_dp_stem_inputs(dev))
        gt, valid, pred = _dp_k2_inputs(dev)
        ref_k2 = mcc.max_corner_confidence(gt, valid, pred)
        ref, ref_losses, ref_first, _ = _dp_steps(spec, dev)
        with _reading_renders(frames):
            ref_eval, ref_eval8 = (
                run_validation(datacfg, spec, model=model, batch_size=b,
                               num_workers=4, device=dev, verbose=False)
                for b in (TRAIN_BATCH // DP_WORLD, TRAIN_BATCH))
            batch = torch.from_numpy(np.stack([frames[p]
                                               for p in paths[:TRAIN_BATCH]]))
        batch = torch.nn.functional.interpolate(
            batch.permute(0, 3, 1, 2).float(),
            size=(spec.net.test_height, spec.net.test_width)).round() \
            .to(torch.uint8).permute(0, 2, 3, 1).contiguous()
        split = _split_serve(spec, fold_batchnorm(model), batch, dev)
        while not ctx.join():
            pass
        # the NCCL rank times its steps with the card to itself
        _free()
        open(f"{root}/gloo_done", "w").close()
        while not nccl.join():
            pass
        ranks = [torch.load(f"{root}/gloo{r}.pt", weights_only=False)
                 for r in range(DP_WORLD)]
        one = torch.load(f"{root}/nccl0.pt", weights_only=False)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # the steps
    r0 = ranks[0]
    loss_rel = abs(float(r0["losses"][0]) - float(ref_losses[0])) \
        / abs(float(ref_losses[0]))
    first_d = {k: float((r0["first"][k] - ref_first[k].cpu()).abs().max())
               for k in r0["first"]}
    same = all(r["sha"] == r0["sha"] and _same_bits(r["losses"],
                                                    r0["losses"])
               for r in ranks)
    ref_sd = ref.model.state_dict()
    layer_d = sorted(((_rel(v, ref_sd[k].cpu()), k)
                      for k, v in r0["state"].items()), reverse=True)
    print(f"[dp] two gloo ranks on {dev}, {TRAIN_BATCH // DP_WORLD} rows "
          f"each of the batch-{TRAIN_BATCH} {TRAIN_SIZE}² bf16 fused step: "
          f"first loss {float(r0['losses'][0]):.6g} vs one process "
          f"{float(ref_losses[0]):.6g} (rel {loss_rel:.3g}); after one step "
          f"max|d| conv_1.weight {first_d['conv_1.weight']:.3g}, "
          f"conv_2.weight {first_d['conv_2.weight']:.3g}, conv_1 running "
          f"mean {first_d['conv_1.running_mean']:.3g}; after {DP_STEPS} "
          f"steps the ranks hold the same bytes {same} (seen "
          f"{[r['seen'] for r in ranks]}), largest differences from one "
          f"process, max|d|/max|ref| per tensor, "
          f"{[(k, f'{d:.3g}') for d, k in layer_d[:4]]}; K2-K6 "
          f"launched {[r['launches'] for r in ranks]} [{card}]")
    print(f"[dp] the DP step (two gloo ranks sharing one card: not a DP "
          f"speed) {[round(r['step_ms'], 4) for r in ranks]} ms, host clock "
          f"with a sync, median of {DP_TIMED} [{card}]")
    _check(loss_rel <= 1e-3, f"the DP step's loss is {loss_rel:.3g} off")
    _check(first_d["conv_1.weight"] <= 6e-4 and
           first_d["conv_2.weight"] <= 6e-4 and
           first_d["conv_1.running_mean"] <= 1e-5,
           f"the DP step's state is off one process's: {first_d}")
    _check(same, "the ranks' states differ")
    _check(all(r["launches"] == [DP_STEPS] * 5 for r in ranks),
           f"K2-K6 launched {[r['launches'] for r in ranks]} times in "
           f"{DP_STEPS} DP steps a rank")
    _check(all(r["seen"] == DP_STEPS * TRAIN_BATCH for r in ranks),
           "seen is not the global batch's")

    # the stem alone and K2
    stem_d = {"mean": max(float((r["stem"]["mean"] - ref_stem["mean"].cpu())
                                .abs().max()) for r in ranks),
              "var": max(float((r["stem"]["var"] - ref_stem["var"].cpu())
                               .abs().max()) for r in ranks)}
    pooled = torch.cat([r["stem"]["pooled"] for r in ranks]).float()
    ref_pooled = ref_stem["pooled"].cpu().float()
    stem_d["pooled"] = float((pooled - ref_pooled).abs().max()
                             / ref_pooled.abs().max())
    for k in ("dw", "dscale", "dbias"):
        stem_d[k] = max(_rel(r["stem"][k], ref_stem[k].cpu()) for r in ranks)
    k2 = torch.cat([r["k2"] for r in ranks])
    k2_same = _same_bits(k2, ref_k2.cpu())
    print(f"[dp] the stem alone at ({TRAIN_BATCH}, {TRAIN_SIZE}, "
          f"{TRAIN_SIZE}) over the two ranks vs one process: "
          f"{ {k: f'{v:.3g}' for k, v in stem_d.items()} }; K2 on each "
          f"rank's rows = the global launch's rows bit for bit {k2_same} "
          f"[{card}]")
    _check(stem_d["mean"] <= 1e-5 and stem_d["var"] <= 1e-5 and
           stem_d["pooled"] <= 1e-2 and
           all(stem_d[k] < 2e-3 for k in ("dw", "dscale", "dbias")),
           f"the stem over the ranks is off one process's: {stem_d}")
    _check(k2_same, "K2 on the ranks' rows is not the global launch's")

    # the eval
    gaps = [_summary_gap(r["eval"], ref_eval) for r in ranks]
    print(f"[dp] run_validation over the two ranks on "
          f"{ref_eval['n_samples']} held-out frames at "
          f"{spec.net.test_width}²: = one process at the ranks' batch of "
          f"{TRAIN_BATCH // DP_WORLD} bit for bit {gaps == [0.0] * DP_WORLD} "
          f"(mean px {ranks[0]['eval']['mean_err_2d']!r} vs "
          f"{ref_eval['mean_err_2d']!r}); one process at batch "
          f"{TRAIN_BATCH}: mean px {ref_eval8['mean_err_2d']!r}, largest "
          f"relative difference {_summary_gap(ref_eval, ref_eval8):.3g}; "
          f"K1 launched {[r['k1'] for r in ranks]} times [{card}]")
    print(f"[dp] the first {TRAIN_BATCH} held-out frames served as one "
          f"batch and as its {DP_WORLD} halves: K1 alone the same bits "
          f"{split['k1_same']}; the decoded heads before the pick, every "
          f"cell: max|d corner| {split['corner_gap']:.6g}, max|d "
          f"confidence| {split['conf_gap']:.6g} (bound 0.05 each, JAX's "
          f"limit for a serve's boxes); another cell picked on images "
          f"{split['flipped']} (batch-{TRAIN_BATCH} confidence margin "
          f"between the two cells {[f'{m:.3g}' for m in split['margin']]}); "
          f"the best boxes' max|d| image by image "
          f"{[f'{d:.3g}' for d in split['box_gap']]}, at most "
          f"{split['kept_gap']:.3g} where the pick is the same [{card}]")
    _check(split["k1_same"], "K1 on a batch of 8 differs from K1 on its "
           "halves")
    _check(split["corner_gap"] <= 0.05 and split["conf_gap"] <= 0.05,
           f"the heads of a batch of {TRAIN_BATCH} and of its halves differ: "
           f"{split['corner_gap']}, {split['conf_gap']}")
    _check(gaps == [0.0] * DP_WORLD,
           f"the eval over the ranks is off one process's: "
           f"{ranks[0]['eval']} vs {ref_eval}")
    _check(all(r["k1"] == -(-DATA_EVAL_FRAMES // TRAIN_BATCH) for r in ranks),
           f"K1 launched {[r['k1'] for r in ranks]} times in the DP eval")

    # --dp 1 through NCCL
    s_dp, s_one = one["summaries"]
    valid_same = _summary_gap(s_dp, s_one) == 0.0
    print(f"[dp] --dp 1 through {one['backend']}: the step = the step with "
          f"no group bit for bit {one['step_equal']} ({one['tensors']} "
          f"tensors and the loss; seen {one['seen']}); cli valid --dp 1 = "
          f"cli valid {valid_same} [{card}]")
    _check(one["backend"] == "nccl" and one["step_equal"],
           f"the NCCL group-of-one step differs: {one['diffs']}")
    _check(valid_same, f"valid --dp 1 differs: {s_dp} vs {s_one}")
    captures, replays = _report_dp_captured(one, card)
    print(f"[dp] phase {time.perf_counter() - t_phase:.1f} s, of which the "
          f"NCCL rank's captured steps {one['captured_s']:.1f} s (and "
          f"{one['waited_s']:.1f} s waiting for the gloo ranks) [{card}]")
    return {"launches": [r["launches"] for r in ranks],
            "k1": [r["k1"] for r in ranks], "captures": captures,
            "replays": replays}


# the tensor-parallel phase (phase 20): two gloo ranks sharing cuda:0 as a
# dp=1 × mp=2 grid, each holding half of every conv's output channels
TP_DP, TP_MP = 1, 2


def _state_bytes(state) -> list:
    """[parameter bytes, momentum bytes] a train state holds."""
    params = list(state.model.parameters())
    return [sum(p.numel() * p.element_size() for p in params),
            sum(state.optimizer.state[p]["momentum_buffer"].numel()
                * state.optimizer.state[p]["momentum_buffer"].element_size()
                for p in params)]


def _tp_frames(dev) -> torch.Tensor:
    """The eval batch: seeded u8 frames, (TRAIN_BATCH, SIZE, SIZE, 3)."""
    return _train_batches(dev, 1, DP_SEED + 5, size=SIZE)[0][0]


def _tp_serve(spec, dev, group=None) -> dict:
    """The seeded model's folded forward (BN folded; on a grid this rank's
    split convs) on the eval batch, decoded: every cell's corners and
    confidence, and the best boxes."""
    folded = fold_batchnorm(_dp_model(spec, dev))
    if group is not None:
        folded = shard_folded(spec, folded, group)
    decoded = make_serving_fn(spec, folded, pick=("grid",),
                              group=group)(_tp_frames(dev))
    torch.cuda.synchronize()
    return {"corners": decoded.corners, "det_conf": decoded.det_conf,
            "boxes": best_boxes(decoded)}


def _tp_child(rank: int, port: int, root: str, device: str) -> None:
    """A spawned rank of phase 20: DP_STEPS fused bf16 steps on the
    dp=1 × mp=2 grid (K2–K6 counted from 0), its bytes, then the eval
    batch's folded forward on the grid (K1 counted from 0); the results go
    to ``root/tp<rank>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    spec = yolo_pose_single()
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=TP_DP * TP_MP, rank=rank, device=dev,
                           timeout=DP_TIMEOUT)
    grid = make_dp_group(TP_DP, TP_MP, device=dev)
    for f in _TRAIN_COUNTED:
        f.launches = 0
    t = time.perf_counter()
    state, losses, first, _ = _dp_steps(spec, dev, grid)
    out = {"launches": _launches(), "steps_s": time.perf_counter() - t,
           "bytes": _state_bytes(state), "losses": losses,
           "seen": state.seen, "layout": [grid.rank, grid.world,
                                          grid.model_rank, grid.mp],
           "first": {k: first[k] for k in ("conv_1.weight", "conv_2.weight",
                                           "conv_1.running_mean")}}
    del state
    stem.stem_conv_pool_infer.launches = 0
    out["eval"] = _tp_serve(spec, dev, grid)
    out["k1"] = stem.stem_conv_pool_infer.launches
    _free()
    out["trainer"] = _tp_trainer(spec, dev, grid, root, rank)
    _free()
    out["restore"] = _tp_restore(spec, dev, grid, root)
    _free()
    out["multi"] = _tp_multi(dev, grid, root, rank)
    dist.destroy_process_group()
    torch.save(_to_cpu(out), f"{root}/tp{rank}.pt")


# phase 20's trainers: run_training on the grid over TP_TRAIN_FRAMES of
# phase 14's renders at batch 8 (2 steps an epoch) for TP_EPOCHS, its eval
# over TP_EVAL_FRAMES held-out renders (one batch of 8); run_training_multi
# for one batch-32 step over MULTI_TRAIN_BATCH of phase 15's renders
TP_TRAIN_FRAMES, TP_EVAL_FRAMES, TP_EPOCHS = 16, 8, 2


def _tp_corpus(root: str):
    """Phase 14's renders, the first TP_TRAIN_FRAMES and TP_EVAL_FRAMES of
    them, under ``root`` (each rank its own: the files are written, the
    frames read from memory), the backgrounds as empty files for the
    trainer's directory listing.  Returns ``_data_corpus``'s tuple."""
    datacfg, train_list, bgs, frames = _data_corpus(
        root, n_train=TP_TRAIN_FRAMES, n_eval=TP_EVAL_FRAMES,
        n_backgrounds=4)
    for b in bgs:
        os.makedirs(os.path.dirname(b), exist_ok=True)
        open(b, "wb").close()
    return datacfg, train_list, bgs, frames


def _tp_synth_tree(root: str):
    """Phase 15's renders as a LINEMOD tree under ``root`` (``_synth_tree``)
    and a train list of MULTI_TRAIN_BATCH frames across the classes with
    its ``.data``: one step of the multi trainer.  Returns (the one-step
    ``.data``, the whole train list, the backgrounds, the frames)."""
    mod = _script("shaded_accuracy_multi")
    host = mod.shaded_scene_bank(SYNTH_FRAMES_PER_CLASS,
                                 *mod.palettes_and_extents())
    _, train_list, bgs, frames = _synth_tree(host, root)
    with open(train_list) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    step = lines[::len(lines) // MULTI_TRAIN_BATCH][:MULTI_TRAIN_BATCH]
    with open(f"{root}/train_step.txt", "w") as f:
        f.write("\n".join(step) + "\n")
    with open(f"{root}/step.data", "w") as f:
        f.write(occlusion_datacfg(linemod_root=root,
                                  train_list=f"{root}/train_step.txt",
                                  backup_root=f"{root}/backup"))
    return f"{root}/step.data", train_list, bgs, frames


def _tp_trainer(spec, dev, grid, root: str, rank: int) -> dict:
    """``run_training`` on the grid as a user runs it (``TrainRunConfig(
    group=make_dp_group(1, 2))``): TP_EPOCHS epochs of 2 batch-8 steps fed
    by ``device_bank`` over phase 14's renders, a checkpoint after each
    epoch, the in-training eval after the last (its best saves
    ``model.weights``); K2–K6 and K1 counted from 0.  Then the state
    gathered: its SHA-256, and (the writer) ``model.weights`` against its
    weights and BN statistics, bit for bit."""
    from singleshotpose_tpu_torch.drivers import run_training
    datacfg, _, bgs, frames = _tp_corpus(f"{root}/corpus{rank}")
    rc = TrainRunConfig(group=grid, loader_backend="device_bank",
                        max_epochs_override=TP_EPOCHS, num_workers=0,
                        log_every=2, bg_dir=os.path.dirname(bgs[0]),
                        eval_every=1, eval_after=TP_EPOCHS - 2,
                        eval_batch_size=TRAIN_BATCH,
                        checkpoint_dir=f"{root}/ckpt",
                        checkpoint_every_epochs=1)
    for f in _ALL_COUNTED:
        f.launches = 0
    t = time.perf_counter()
    with _reading_renders(frames):
        result = run_training(datacfg, spec, None, 15, rc)
    torch.cuda.synchronize()
    out = {"launches": _launches(), "k1": stem.stem_conv_pool_infer.launches,
           "seconds": time.perf_counter() - t,
           "losses": result["history"]["training_losses"],
           "testing": result["history"]["testing_accuracies"],
           "seen": result["state"].seen,
           "steps": Checkpointer(f"{root}/ckpt").steps()}
    whole = gather_train_state(grid, result["state"])
    out["sha"] = _state_sha(whole)
    if grid.leader:
        _, sd = W.load_weights(spec, f"{root}/corpus0/backup/model.weights")
        got = whole.model.state_dict()
        out["weights_equal"] = all(_same_bits(v, got[k].cpu())
                                   for k, v in sd.items())
    return out


def _tp_restore(spec, dev, grid, root: str) -> dict:
    """A one-process checkpoint (the parent's state after DP_STEPS steps)
    restored whole on the grid and split (``shard_train_state``), as the
    trainers resume: this rank's tensors against the file's slices —
    model-rank rows of a split conv, the whole of the rest — bit for
    bit."""
    _wait_for(f"{root}/one_done", root)
    net = spec.net
    state = init_train_state(Darknet(spec, device=dev),
                             weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    ckpt = Checkpointer(f"{root}/one", group=grid)
    step = ckpt.restore(state)
    shard_train_state(grid, state)
    payload = torch.load(f"{root}/one/{step}.pt", map_location="cpu",
                         weights_only=True)
    names = [n for n, _ in state.model.named_parameters()]
    opt = payload["optimizer"]["state"]
    want = dict(payload["model"])
    want.update({f"momentum/{names[i]}": v["momentum_buffer"]
                 for i, v in opt.items()})
    got = {k: v for k, v in state.model.state_dict().items()}
    got.update({f"momentum/{n}": state.optimizer.state[p]["momentum_buffer"]
                for n, p in state.model.named_parameters()})
    split = {n for n, m in state.model.named_children()
             if getattr(m, "model_shards", 1) > 1}
    differ = []
    for k, v in want.items():
        layer = k.replace("momentum/", "").split(".")[0]
        if layer in split:
            v = v[channel_rows(len(v), grid)]
        if not _same_bits(got[k].cpu(), v):
            differ.append(k)
    return {"step": step, "seen": state.seen, "tensors": len(want),
            "differ": differ[:3], "n_differ": len(differ)}


def _tp_multi(dev, grid, root: str, rank: int) -> dict:
    """``run_training_multi`` on the grid for one step of the full-width
    ``yolo_pose_multi`` at batch 32 fed by ``device_synth`` over phase 15's
    renders (the scene bank on the card, every rank synthesizing its
    rows); K2–K6 counted from 0."""
    datacfg, _, _, frames = _tp_synth_tree(f"{root}/synth{rank}")
    rc = TrainRunConfig(group=grid, loader_backend="device_synth",
                        max_epochs_override=1, num_workers=0, log_every=1,
                        bg_dir=f"{root}/no_bg", eval_every=20,
                        eval_after=-1)
    for f in _TRAIN_COUNTED:
        f.launches = 0
    t = time.perf_counter()
    with _reading_renders(frames):
        result = run_training_multi(datacfg, yolo_pose_multi(), None, 0,
                                    None, f"{root}/synth{rank}", rc)
    torch.cuda.synchronize()
    return {"launches": _launches(), "seconds": time.perf_counter() - t,
            "losses": torch.tensor(result["history"]["training_losses"],
                                   dtype=torch.float64),
            "seen": result["state"].seen}


def _rows_batches(dev, root: str, group=None) -> dict:
    """The bank backends' batches on the card from fixed seeds: two
    ``device_bank`` batches of 8 at 416² over phase 14's renders and one
    ``device_synth`` batch of 32 at 416² over phase 15's, through
    ``Loader(group=)`` (this rank's rows) or, with no group, whole."""
    _, train_list, bgs, frames = _tp_corpus(f"{root}/bank")
    out = {}
    with _reading_renders(frames):
        loader = Loader(PoseDataset(train_list, train=True,
                                    bg_file_names=bgs),
                        TRAIN_BATCH, fixed_shape=(TRAIN_SIZE, TRAIN_SIZE),
                        seed=33, num_workers=0, backend="device_bank",
                        device=dev, group=group)
        out["bank"] = [(i.cpu(), lab.cpu()) for i, lab in loader]
    from singleshotpose_tpu_torch.data.synth_multi import (
        MultiObjectSynthesizer, SynthConfig)
    _, train_list, bgs, frames = _tp_synth_tree(f"{root}/synth")
    with _reading_renders(frames):
        ds = PoseDataset(train_list, train=True, bg_file_names=bgs,
                         aug=pipeline.AugmentConfig.multi(),
                         synthesizer=MultiObjectSynthesizer(
                             SynthConfig(linemod_root=f"{root}/synth")))
        loader = Loader(ds, MULTI_TRAIN_BATCH,
                        fixed_shape=(MULTI_SIZE, MULTI_SIZE), seed=34,
                        num_workers=0, backend="device_synth", device=dev,
                        group=group)
        batch = next(iter(loader))
        out["synth"] = [(batch[0].cpu(), batch[1].cpu())]
    torch.cuda.synchronize()
    return out


def _rows_child(rank: int, port: int, root: str, device: str) -> None:
    """A spawned rank of phase 20's dp=2 × mp=1 pair: its rows of the bank
    backends' batches (:func:`_rows_batches`) to ``root/rows<rank>.pt``."""
    dev = torch.device(device)
    torch.cuda.set_device(dev)
    initialize_distributed(backend="gloo",
                           init_method=f"tcp://localhost:{port}",
                           world_size=2, rank=rank, device=dev,
                           timeout=DP_TIMEOUT)
    group = make_dp_group(2, 1, device=dev)
    out = _rows_batches(dev, f"{root}/rows{rank}", group)
    dist.destroy_process_group()
    torch.save(out, f"{root}/rows{rank}.pt")


def _tp_captured_child(rank: int, port: int, root: str) -> None:
    """A spawned rank of phase 20's captured grid: rank ``rank`` on
    cuda:<rank> of a dp=1 × mp=2 grid over NCCL, its split step captured
    by ``drivers._precompile_buckets`` against its eager steps
    (:func:`_dp_captured`, the model group's gathers and broadcasts
    counted beside the all-reduces); the result to ``root/tpc<rank>.pt``."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    initialize_distributed(backend="nccl",
                           init_method=f"tcp://localhost:{port}",
                           world_size=TP_DP * TP_MP, rank=rank, device=dev,
                           timeout=DP_TIMEOUT)
    grid = make_dp_group(TP_DP, TP_MP, device=dev)
    out = _dp_captured(yolo_pose_single(), dev, grid, ops=GRID_COLLECTIVES)
    out.update(backend=grid.backend,
               layout=[grid.rank, grid.world, grid.model_rank, grid.mp])
    dist.destroy_process_group()
    torch.save(_to_cpu(out), f"{root}/tpc{rank}.pt")


def _grid_collectives_recorded(c: dict, graphs: int) -> bool:
    """Whether ``graphs`` graphs of a grid step (:func:`_dp_captured`'s
    ``c``) recorded every collective an eager step runs — all-reduces and
    channel gathers at least; a broadcast where a parameter is replicated
    (none is where mp divides every conv's filters)."""
    eager, captured = c["collectives_eager_step"], c["collectives_captured"]
    return eager["all_reduce"] > 0 and eager["all_gather"] > 0 and all(
        captured[op] == eager[op] * graphs for op in GRID_COLLECTIVES)


def _tp_captured(card: str) -> Optional[dict]:
    """Phase 20's captured grid, where two cards are visible: two NCCL
    ranks on cuda:0 and cuda:1 as a dp=1 × mp=2 grid
    (:func:`_tp_captured_child`).  Holds, on each rank: K2–K6 recorded
    once in each of the DP_CAPTURED_WIDTHS graphs; every all-reduce,
    channel gather and broadcast of an eager step recorded in each graph;
    the replays giving the eager steps' losses and split state bit for
    bit, and the states gathered whole the same SHA-256; the two ranks'
    losses the same bits.  On one card it prints why it did not run and
    returns None (NCCL takes one rank a card; a gloo grid's step cannot be
    captured); else K2–K6's graphs and replays a rank."""
    n = torch.cuda.device_count()
    if n < TP_DP * TP_MP:
        print(f"[tp captured] not run: {n} card visible; the captured "
              f"dp={TP_DP} x mp={TP_MP} grid needs {TP_DP * TP_MP} cards "
              "(NCCL takes one rank a card, and a gloo grid's step cannot "
              f"be captured: its collectives run on the host) [{card}]")
        return None
    t = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_tpc_")
    try:
        torch.multiprocessing.start_processes(
            _tp_captured_child, args=(free_port(), root),
            nprocs=TP_DP * TP_MP, join=True, start_method="spawn")
        ranks = [torch.load(f"{root}/tpc{r}.pt", weights_only=False)
                 for r in range(TP_DP * TP_MP)]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out = _report_tp_captured(ranks, card)
    print(f"[tp captured] {time.perf_counter() - t:.1f} s [{card}]")
    return out


def _report_tp_captured(ranks, card: str) -> dict:
    """Print and check the captured grid's ranks (:func:`_tp_captured`);
    returns K2–K6's graphs and replays a rank."""
    n_widths = len(DP_CAPTURED_WIDTHS)
    for r, c in enumerate(ranks):
        print(f"[tp captured] rank {r} of the dp={TP_DP} x mp={TP_MP} grid "
              f"over {c['backend']} on cuda:{r} (layout {c['layout']}): "
              f"{n_widths} widths {DP_CAPTURED_WIDTHS} captured at batch "
              f"{TRAIN_BATCH} in {c['capture_s']:.2f} s, "
              f"{c['reserved_gib']:.2f} GiB more reserved; K2-K6 recorded "
              f"in each graph {c['per_graph']}; recorded in the graphs "
              f"{c['collectives_captured']} (an eager step: "
              f"{c['collectives_eager_step']}); {c['replays']} replays; "
              f"losses {float(c['losses'][0]):.8g} ... "
              f"{float(c['losses'][-1]):.8g}; captured = eager bit for bit: "
              f"losses {c['same_losses']}, "
              f"{c['tensors'] - len(c['diffs'])} of {c['tensors']} split "
              f"state tensors, gathered SHA-256 {c['sha'][0][:16]} / "
              f"{c['sha'][1][:16]}; seen {c['seen']} [{card}]")
        for name, k, d in c["diffs"]:
            print(f"[tp captured]   rank {r} captured != eager: {name}: {k} "
                  f"elements, max|d| {d:.6g}")
        _check(c["backend"] == "nccl", f"rank {r}'s grid is {c['backend']}")
        _check(c["per_graph"] == [[1] * 5] * n_widths,
               f"K2-K6 were not recorded once in each grid graph of rank "
               f"{r}: {c['per_graph']}")
        _check(_grid_collectives_recorded(c, n_widths),
               f"rank {r}'s graphs recorded {c['collectives_captured']}, an "
               f"eager step runs {c['collectives_eager_step']}")
        _check(c["wrapped"] == [0] * 5 and c["replays"] == c["replays_step"]
               == len(DP_CAPTURED_SEQUENCE),
               f"rank {r}: replays {c['replays']}, wrappers {c['wrapped']}")
        _check(c["same_losses"] and not c["diffs"] and c["finite"]
               and c["sha"][0] == c["sha"][1],
               f"rank {r}'s captured grid steps do not give the eager steps' "
               "bits")
        _check(c["seen"] == (len(DP_CAPTURED_SEQUENCE) * TRAIN_BATCH,) * 2,
               f"rank {r}: seen {c['seen']}")
    _check(_same_bits(ranks[0]["losses"], ranks[1]["losses"])
           and ranks[0]["sha"] == ranks[1]["sha"],
           "the model ranks' captured losses or gathered states differ")
    return {"captures": [len(c["per_graph"]) for c in ranks],
            "replays": [c["replays"] for c in ranks]}


def phase_tp(spec, dev, card: str) -> Optional[dict]:
    """Phase 20: tensor parallelism on this card at full width.  Two gloo
    ranks (spawned; NCCL takes one rank a card) as a dp=1 × mp=2 grid
    (``make_dp_group(1, 2)``): each holds half of every conv's output
    channels — its parameter and momentum bytes printed against the
    whole model's, exactly half — and runs DP_STEPS fused bf16 steps on
    the whole batch-8 416² batch (K3–K6 on conv_1's gathered weight, K2
    on the rank's rows), held against one process: the first step's loss
    rel 1e-3, conv_1's and conv_2's weights (gathered) atol 6e-4, conv_1's
    running mean atol 1e-5 (the JAX package's bf16 bounds); the two
    ranks' losses the same bits; K2–K6 once a rank a step.  Then the
    seeded model's folded forward at batch 8, 672², on the grid (K1 on
    conv_1's gathered folded weights, once a rank) against one process:
    every cell's decoded corners and confidence within 0.05 (JAX's limit
    for a serve's boxes) and the best boxes' gap printed.  Then the
    trainers on the grid, the dp=2 pair's bank rows and, where two cards
    are visible, the captured grid over NCCL (:func:`_tp_captured`, whose
    counts it returns; None on one card)."""
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="ssp_tp_")
    try:
        ctx = torch.multiprocessing.start_processes(
            _tp_child, args=(free_port(), root, str(dev)),
            nprocs=TP_DP * TP_MP, join=False, start_method="spawn")
        rows_ctx = torch.multiprocessing.start_processes(
            _rows_child, args=(free_port(), root, str(dev)), nprocs=2,
            join=False, start_method="spawn")
        # the one-process references while the ranks start; the state after
        # DP_STEPS steps is the checkpoint the grid restores
        ref, ref_losses, ref_first, _ = _dp_steps(spec, dev)
        whole = _state_bytes(ref)
        Checkpointer(f"{root}/one").save(DP_STEPS, ref)
        open(f"{root}/one_done", "w").close()
        del ref
        ref_eval = _tp_serve(spec, dev)
        ref_rows = _rows_batches(dev, f"{root}/rows_one")
        while not rows_ctx.join():
            pass
        rows = [torch.load(f"{root}/rows{r}.pt", weights_only=True)
                for r in range(2)]
        while not ctx.join():
            pass
        ranks = [torch.load(f"{root}/tp{r}.pt", weights_only=False)
                 for r in range(TP_DP * TP_MP)]
        # the grid's last checkpoint restored in one process
        net = spec.net
        restored = init_train_state(Darknet(spec, device=dev),
                                    weight_decay=net.decay * net.batch,
                                    momentum=net.momentum)
        last = Checkpointer(f"{root}/ckpt").restore(restored)
        restored_sha = _state_sha(restored)
        del restored
    finally:
        shutil.rmtree(root, ignore_errors=True)

    r0 = ranks[0]
    loss_rel = abs(float(r0["losses"][0]) - float(ref_losses[0])) \
        / abs(float(ref_losses[0]))
    first_d = {k: float((r0["first"][k] - ref_first[k].cpu()).abs().max())
               for k in r0["first"]}
    share = [[b / w for b, w in zip(r["bytes"], whole)] for r in ranks]
    same_loss = all(_same_bits(r["losses"], r0["losses"]) for r in ranks)
    print(f"[tp] a dp={TP_DP} x mp={TP_MP} grid of two gloo ranks on {dev} "
          f"(layouts {[r['layout'] for r in ranks]}: data rank, dp, model "
          f"rank, mp), yolo_pose_single: a rank holds "
          f"{[r['bytes'] for r in ranks]} parameter and momentum bytes of "
          f"the model's {whole} (shares {share}) [{card}]")
    print(f"[tp] the batch-{TRAIN_BATCH} {TRAIN_SIZE}² bf16 fused step on "
          f"the grid: first loss {float(r0['losses'][0]):.6g} vs one "
          f"process {float(ref_losses[0]):.6g} (rel {loss_rel:.3g}); after "
          f"one step max|d| conv_1.weight {first_d['conv_1.weight']:.3g}, "
          f"conv_2.weight {first_d['conv_2.weight']:.3g}, conv_1 running "
          f"mean {first_d['conv_1.running_mean']:.3g}; the ranks' losses "
          f"over {DP_STEPS} steps the same bits {same_loss}; K2-K6 launched "
          f"{[r['launches'] for r in ranks]}; {DP_STEPS} steps took "
          f"{[round(r['steps_s'], 2) for r in ranks]} s a rank (host clock; "
          f"two ranks sharing one card over gloo: not a TP speed) [{card}]")
    _check(all(s == [0.5, 0.5] for s in share),
           f"a rank does not hold half of the model: {share}")
    _check(loss_rel <= 1e-3, f"the grid step's loss is {loss_rel:.3g} off")
    _check(first_d["conv_1.weight"] <= 6e-4 and
           first_d["conv_2.weight"] <= 6e-4 and
           first_d["conv_1.running_mean"] <= 1e-5,
           f"the grid step's state is off one process's: {first_d}")
    _check(same_loss, "the model ranks' losses differ")
    _check(all(r["launches"] == [DP_STEPS] * 5 for r in ranks),
           f"K2-K6 launched {[r['launches'] for r in ranks]} times in "
           f"{DP_STEPS} grid steps a rank")
    _check(all(r["seen"] == DP_STEPS * TRAIN_BATCH for r in ranks),
           "seen is not the global batch's")

    gaps = {k: max(float((r["eval"][k] - ref_eval[k].cpu()).abs().max())
                   for r in ranks) for k in ("corners", "det_conf")}
    box_gap = max(float((r["eval"]["boxes"] - ref_eval["boxes"].cpu())
                        .abs().max()) for r in ranks)
    print(f"[tp] the folded forward at batch {TRAIN_BATCH}, {SIZE}², on the "
          f"grid vs one process: every cell max|d corner| "
          f"{gaps['corners']:.6g}, max|d confidence| {gaps['det_conf']:.6g} "
          f"(bound 0.05 each); the best boxes' max|d| {box_gap:.6g}; K1 "
          f"launched {[r['k1'] for r in ranks]} [{card}]")
    _check(gaps["corners"] <= 0.05 and gaps["det_conf"] <= 0.05,
           f"the grid's folded forward is off one process's: {gaps}")
    _check(all(r["k1"] == 1 for r in ranks),
           f"K1 launched {[r['k1'] for r in ranks]} times in the grid's "
           "eval batch")
    _report_tp_trainers(ranks, last, restored_sha, card)
    _report_tp_rows(rows, ref_rows, card)
    captured = _tp_captured(card)
    print(f"[tp] phase {time.perf_counter() - t_phase:.1f} s [{card}]")
    return captured


def _report_tp_trainers(ranks, last: int, restored_sha: str,
                        card: str) -> None:
    """Print and check phase 20's trainers on the grid
    (:func:`_tp_trainer`, :func:`_tp_restore`, :func:`_tp_multi`)."""
    tr = [r["trainer"] for r in ranks]
    steps = TP_EPOCHS * TP_TRAIN_FRAMES // TRAIN_BATCH
    print(f"[tp trainer] run_training on the dp={TP_DP} x mp={TP_MP} grid, "
          f"yolo_pose_single fed by device_bank, {TP_EPOCHS} epochs of "
          f"{TP_TRAIN_FRAMES // TRAIN_BATCH} batch-8 steps: losses "
          f"{[[round(x, 6) for x in t['losses']] for t in tr]}, eval "
          f"{[t['testing'] for t in tr]}, seen {[t['seen'] for t in tr]}; "
          f"checkpoints at steps {tr[0]['steps']}; K2-K6 launched "
          f"{[t['launches'] for t in tr]}, K1 {[t['k1'] for t in tr]}; "
          f"model.weights = the gathered state {tr[0].get('weights_equal')};"
          f" the last checkpoint (step {last}) restored in one process = the "
          f"gathered state {restored_sha == tr[0]['sha']}; "
          f"{[round(t['seconds'], 2) for t in tr]} s a rank [{card}]")
    _check(all(len(t["losses"]) == steps and np.isfinite(t["losses"]).all()
               and t["losses"] == tr[0]["losses"] for t in tr),
           "the grid's run_training losses are not finite and equal")
    _check(all(t["seen"] == steps * TRAIN_BATCH for t in tr),
           "run_training's seen is not the global samples'")
    _check(tr[0]["steps"] == [steps // TP_EPOCHS * (e + 1)
                              for e in range(TP_EPOCHS)] and last == steps,
           f"checkpoints at {tr[0]['steps']}, restored {last}")
    _check(all(t["launches"] == [steps] * 5 and t["k1"] == 1 for t in tr),
           "K2-K6 not once a rank a step, or K1 not once a rank an eval "
           "batch")
    _check(all(len(t["testing"]) == 1 for t in tr), "no in-training eval")
    _check(tr[0]["weights_equal"] is True,
           "model.weights is not the gathered state")
    _check(all(t["sha"] == tr[0]["sha"] for t in tr)
           and restored_sha == tr[0]["sha"],
           "the grid's checkpoint restored in one process is not the "
           "gathered state")
    rs = [r["restore"] for r in ranks]
    print(f"[tp trainer] a one-process checkpoint (step {rs[0]['step']}, "
          f"seen {rs[0]['seen']}) restored on the grid: "
          f"{[rs_['tensors'] - rs_['n_differ'] for rs_ in rs]} of "
          f"{rs[0]['tensors']} tensors a rank its slices bit for bit "
          f"(differ: {[rs_['differ'] for rs_ in rs]}) [{card}]")
    _check(all(rs_["n_differ"] == 0 and rs_["seen"] == DP_STEPS * TRAIN_BATCH
               for rs_ in rs),
           "a one-process checkpoint restored on the grid is not each "
           "rank's slices")
    mu = [r["multi"] for r in ranks]
    print(f"[tp trainer] run_training_multi on the grid, yolo_pose_multi fed "
          f"by device_synth at batch {MULTI_TRAIN_BATCH}, {MULTI_SIZE}²: "
          f"losses {[m['losses'].tolist() for m in mu]}, seen "
          f"{[m['seen'] for m in mu]}; K2-K6 launched "
          f"{[m['launches'] for m in mu]}; "
          f"{[round(m['seconds'], 2) for m in mu]} s a rank [{card}]")
    _check(all(len(m["losses"]) == 1 and torch.isfinite(m["losses"]).all()
               and _same_bits(m["losses"], mu[0]["losses"])
               and m["seen"] == MULTI_TRAIN_BATCH
               and m["launches"] == [1] * 5 for m in mu),
           "the grid's run_training_multi step is off")


def _report_tp_rows(rows, ref_rows, card: str) -> None:
    """Print and check the dp=2 pair's rows of the bank backends' batches
    against the one-process batches, bit for bit."""
    same = {}
    for kind in ("bank", "synth"):
        ok = []
        for r, got in enumerate(rows):
            for (gi, gl), (wi, wl) in zip(got[kind], ref_rows[kind]):
                per = len(wi) // 2
                sl = slice(r * per, (r + 1) * per)
                ok.append(len(gi) == per and _same_bits(gi, wi[sl])
                          and _same_bits(gl, wl[sl]))
        same[kind] = ok
    print(f"[tp rows] dp=2 x mp=1, two gloo ranks on the card: each rank's "
          f"Loader(group=) rows = those rows of the one-process batch, bit "
          f"for bit, images and labels: device_bank {TRAIN_SIZE}² batch "
          f"{TRAIN_BATCH} x {len(ref_rows['bank'])} {same['bank']}, "
          f"device_synth {MULTI_SIZE}² batch {MULTI_TRAIN_BATCH} "
          f"{same['synth']} [{card}]")
    _check(len(same["bank"]) == 2 * len(ref_rows["bank"]) > 0
           and all(same["bank"]) and len(same["synth"]) == 2
           and all(same["synth"]),
           "a rank's bank rows are not the one-process batch's")


def _report_dp_captured(one: dict, card: str):
    """Print and check the NCCL rank's captured steps (:func:`_dp_captured`,
    :func:`_dp_run_training`).  Returns the graphs that recorded K2–K6 and
    their replays."""
    n_widths = len(DP_CAPTURED_WIDTHS)
    for tag, c in (("default", one["captured"]),
                   ("decay_bn_bias=False", one["captured_no_decay"])):
        per_step = c["reduces_eager_step"]
        print(f"[dp nccl captured, {tag}] {n_widths} widths "
              f"{DP_CAPTURED_WIDTHS} captured at batch {TRAIN_BATCH} in "
              f"{c['capture_s']:.2f} s (warm-up steps and capture), "
              f"{c['reserved_gib']:.2f} GiB more reserved "
              f"({c['reserved_total_gib']:.2f} GiB in all); K2-K6 recorded "
              f"in each graph: {c['per_graph']}; all-reduces issued while "
              f"capturing {c['reduces_captured']} ({per_step:g} an eager "
              f"step); {len(DP_CAPTURED_SEQUENCE)} steps "
              f"({' '.join(map(str, DP_CAPTURED_SEQUENCE))}), epochs "
              f"{DP_CAPTURED_EPOCHS[0]}->{DP_CAPTURED_EPOCHS[-1]}: "
              f"{c['replays']} replays (K2-K6 wrappers ran {c['wrapped']} "
              f"times in them); losses {float(c['losses'][0]):.8g} ... "
              f"{float(c['losses'][-1]):.8g}; captured = eager bit for bit: "
              f"losses {c['same_losses']}, {c['tensors'] - len(c['diffs'])} "
              f"of {c['tensors']} state tensors; seen {c['seen']} [{card}]")
        for name, n, d in c["diffs"]:
            print(f"[dp nccl captured, {tag}]   captured != eager: {name}: "
                  f"{n} elements, max|d| {d:.6g}")
        _check(c["per_graph"] == [[1] * 5] * n_widths,
               f"K2-K6 were not recorded once in each NCCL graph: "
               f"{c['per_graph']}")
        _check(per_step > 0 and c["reduces_captured"] == per_step * n_widths,
               f"{c['reduces_captured']} all-reduces recorded in "
               f"{n_widths} graphs, {per_step} an eager step")
        _check(c["wrapped"] == [0] * 5 and c["replays"] == c["replays_step"]
               == len(DP_CAPTURED_SEQUENCE),
               f"replays {c['replays']}, wrappers {c['wrapped']}")
        _check(c["same_losses"] and not c["diffs"] and c["finite"],
               f"the captured NCCL steps ({tag}) do not give the eager "
               "steps' bits")
        _check(c["seen"] == (len(DP_CAPTURED_SEQUENCE) * TRAIN_BATCH,) * 2,
               f"seen {c['seen']}")
    turns = one["captured"]["turns"]
    print(f"[dp nccl captured] {TRAIN_SIZE}² b{TRAIN_BATCH} step of the "
          f"NCCL group of one, ms in turns captured/eager/eager/captured, "
          f"CUDA events, median (min-max) of {TIMED_STEPS} steps each: "
          + "; ".join(f"{k} " + " ".join(f"{m:.4f} ({lo:.4f}-{hi:.4f})"
                                         for m, lo, hi in v)
                      for k, v in turns.items()) + f" [{card}]")
    r = one["run_training"]
    steps = r["frames"] // TRAIN_BATCH
    n_all = len(SINGLE_SCHEDULE.all_widths)
    print(f"[dp nccl captured] run_training(group=NCCL of one, "
          f"precompile_buckets=True), one epoch of {r['frames']} renders: "
          f"{len(r['per_graph'])} graphs, K2-K6 recorded in each "
          f"{r['per_graph'][0] if r['per_graph'] else None} (all alike: "
          f"{all(g == [1] * 5 for g in r['per_graph'])}), {r['replays']} "
          f"replays for {len(r['losses'])} steps, K2-K6 wrappers ran "
          f"{r['launches']} times (warm-ups and captures), losses "
          + " ".join(f"{x:.6g}" for x in r["losses"][:3]) + " ... "
          f"{r['losses'][-1]:.6g}; seen {r['seen']}; {r['seconds']:.1f} s "
          f"[{card}]")
    _check(r["per_graph"] == [[1] * 5] * n_all,
           f"run_training's NCCL graphs recorded {r['per_graph']}")
    _check(r["replays"] == len(r["losses"]) == steps and
           np.isfinite(r["losses"]).all() and r["seen"] == steps * TRAIN_BATCH,
           f"run_training replayed {r['replays']} times for "
           f"{len(r['losses'])} steps")
    # the trainer's warm-up steps and captures alone ran the wrappers
    _check(r["launches"] == [3 * n_all] * 5,
           f"K2-K6 wrappers ran {r['launches']} times in run_training")
    captures = 2 * n_widths + len(r["per_graph"])
    replays = one["captured"]["replays"] + \
        one["captured_no_decay"]["replays"] + r["replays"]
    return captures, replays


# the native phase (19): a small corpus written as real files (640x480 JPEG
# frames, PNG masks, JPEG backgrounds), read by the native C++ decoder
# (singleshotpose_tpu_torch/native) where its library builds here, and the
# yuv420 eval transfer through K1 either way
NATIVE_FRAMES, NATIVE_EVAL_FRAMES, NATIVE_BACKGROUNDS = 64, 16, 8
NATIVE_EPOCHS = 2            # host train batches: 2 epochs of 8, the first
NATIVE_SERVES = 10           # dropped; serves (and copies) timed a transfer


def _write_files(frames) -> None:
    """``frames`` (path → array) as files: JPEG quality 92, PNG masks."""
    from PIL import Image
    for path, a in frames.items():
        os.makedirs(os.path.dirname(path), exist_ok=True)
        Image.fromarray(a).save(path, **({} if path.endswith(".png")
                                         else {"quality": 92}))


def _yuv420_encode(rgb: np.ndarray):
    """(B,H,W,3) u8 frames → (y (B,H,W), cbcr (B,H/2,W/2,2)) u8 planes, as
    the native decoder gives them: full-range BT.601 (JFIF), each plane
    rounded, chroma the rounded 2×2 mean."""
    f = rgb.astype(np.float64)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]

    def u8(x):
        return np.clip(np.rint(x), 0, 255).astype(np.int32)

    y = u8(0.299 * r + 0.587 * g + 0.114 * b)
    c = np.stack([u8(128 - 0.168735892 * r - 0.331264108 * g + 0.5 * b),
                  u8(128 + 0.5 * r - 0.418687589 * g - 0.081312411 * b)], -1)
    c = (c[:, 0::2, 0::2] + c[:, 1::2, 0::2] + c[:, 0::2, 1::2]
         + c[:, 1::2, 1::2] + 2) >> 2
    return y.astype(np.uint8), c.astype(np.uint8)


def _native_batches(train_list: str, bgs) -> dict:
    """Train batches of TRAIN_BATCH at TRAIN_SIZE², the native backend
    against the python one, 8 workers each, host clock from batch to batch
    over NATIVE_EPOCHS epochs after the first batch; the first batches'
    labels equal and images within ``tests/test_native.py``'s bounds (mean
    difference < 0.01, 97 % of values within 0.1, in [0, 1] units)."""
    times, first = {}, {}
    for backend in ("native", "python"):
        ld = Loader(PoseDataset(train_list, train=True, bg_file_names=bgs),
                    TRAIN_BATCH, fixed_shape=(TRAIN_SIZE, TRAIN_SIZE),
                    seed=25, num_workers=8, out_uint8=True, backend=backend)
        ms, t = [], time.perf_counter()
        for _ in range(NATIVE_EPOCHS):
            for batch in ld:
                ms.append((time.perf_counter() - t) * 1e3)
                first.setdefault(backend, batch)
                t = time.perf_counter()
        times[backend] = ms[1:]
    (ni, nl), (pi, pl) = first["native"], first["python"]
    diff = np.abs(ni.astype(np.float32) - pi.astype(np.float32)) / 255.0
    labels_equal = bool(np.allclose(nl, pl, rtol=1e-6, atol=1e-6))
    nat, py = (statistics.median(times[b]) for b in ("native", "python"))
    print(f"[native] train batch of {TRAIN_BATCH} at {TRAIN_SIZE}², u8, 8 "
          f"workers, host clock, median of {len(times['native'])} (min-max):"
          f" native {nat:.4f} ms ({min(times['native']):.4f}-"
          f"{max(times['native']):.4f}), python {py:.4f} ms "
          f"({min(times['python']):.4f}-{max(times['python']):.4f}), "
          f"{py / nat:.1f}x; first batches: labels equal {labels_equal}, "
          f"image difference mean {diff.mean():.5f}, within 0.1 "
          f"{(diff < 0.1).mean():.5f}")
    _check(labels_equal and diff.mean() < 0.01 and (diff < 0.1).mean() > 0.97,
           "the native batch is not the python batch")
    return {"native_ms": nat, "python_ms": py}


def _native_trainer(spec, dev, card: str, datacfg: str, root: str):
    """``drivers.run_training(loader_backend="native")`` for one epoch of
    eager batch-8 416² steps of the full-width ``yolo_pose_single`` from
    seeded weights, as ``cli train --loader_backend native`` runs it;
    K2–K6 counted from 0 over the epoch, once a step each."""
    from singleshotpose_tpu_torch.drivers import run_training
    rc = TrainRunConfig(loader_backend="native", max_epochs_override=1,
                        num_workers=8, log_every=2, bg_dir=f"{root}/bg",
                        eval_every=1000, eval_after=1000, device=str(dev))
    for f in _TRAIN_COUNTED:
        f.launches = 0
    t = time.perf_counter()
    result = run_training(datacfg, spec, None, 15, rc)
    torch.cuda.synchronize()
    launches = _launches()
    losses = result["history"]["training_losses"]
    steps = NATIVE_FRAMES // TRAIN_BATCH
    print(f"[native] run_training(loader_backend='native'), yolo_pose_single "
          f"batch {TRAIN_BATCH} {TRAIN_SIZE}², one epoch: {len(losses)} "
          f"steps, losses " + " ".join(f"{x:.6g}" for x in losses)
          + f"; K2-K6 launched {launches}; {time.perf_counter() - t:.1f} s "
          f"[{card}]")
    _check(len(losses) == steps and np.isfinite(losses).all(),
           "run_training on the native loader did not train its epoch")
    _check(launches == [steps] * 5,
           f"K2-K6 launched {launches} times in {steps} native-fed steps")
    return launches


def _native_bank(train_list: str, bgs) -> dict:
    """The frame bank's build (``device_bank.build_frame_bank``) on the
    train split, native decode against PIL: seconds each, host clock."""
    from singleshotpose_tpu_torch.data.device_bank import build_frame_bank
    from singleshotpose_tpu_torch.native import NativeLoader
    ds = PoseDataset(train_list, train=True, bg_file_names=bgs)
    t = time.perf_counter()
    nat = build_frame_bank(ds, decode=NativeLoader().decode)
    nat_s = time.perf_counter() - t
    t = time.perf_counter()
    pil = build_frame_bank(ds)
    pil_s = time.perf_counter() - t
    same = float((nat.images == pil.images).float().mean())
    print(f"[native] frame bank of {nat.images.shape[0]} frames and "
          f"{nat.bgs.shape[0]} backgrounds: native decode {nat_s:.3f} s, PIL "
          f"{pil_s:.3f} s; bytes equal {same:.6f}")
    return {"bank_native_s": nat_s, "bank_pil_s": pil_s}


def _native_evals(spec, dev, card: str, datacfg: str, eval_paths, built):
    """``run_validation`` at the test size on the held-out split, rgb and
    yuv420 (the native decoder's planes; where its library does not build,
    planes encoded from the same decoded frames with numpy, fed to the
    eval in place of ``drivers._eval_loader``'s), K1 counted in each; on
    the first batch the yuv420 input converted on the card = the CPU's
    conversion bit for bit and within the luma/PSNR gate of the rgb input;
    bytes a batch, the copy and the serve (copy included) timed in
    turns."""
    import singleshotpose_tpu_torch.drivers as drivers_mod
    from singleshotpose_tpu_torch.ops.yuv import yuv420_to_rgb_resized
    out_shape = (spec.net.test_width, spec.net.test_height)
    model = _random_model(spec, dev, seed=90)
    kw = dict(model=model, batch_size=TRAIN_BATCH, num_workers=8,
              device=dev, verbose=False)
    ds = PoseDataset(eval_paths, train=False)
    if built:
        from singleshotpose_tpu_torch.native import NativeLoader

        def planes_of(paths):
            return NativeLoader().test_batch_yuv420(paths)
        feed = contextlib.nullcontext()
    else:
        def planes_of(paths):
            return _yuv420_encode(np.stack([pipeline.load_image(p)
                                            for p in paths]))
        def batches():
            # decoded and encoded as the pass iterates, as a loader would
            for i in range(0, len(ds), TRAIN_BATCH):
                rows = range(i, min(i + TRAIN_BATCH, len(ds)))
                yield (planes_of([ds.lines[j] for j in rows]),
                       np.stack([ds.get_test_label(j) for j in rows]))
        real = drivers_mod._eval_loader
        feed = mock.patch.object(
            drivers_mod, "_eval_loader",
            lambda *a, **k: batches() if a[4] == "yuv420" else real(*a, **k))
    # in turns, each pass timed on the host clock (decode, serve, PnP and
    # metrics); K1 counted from 0 over each pass
    summaries, k1, secs = {}, {"rgb": [], "yuv420": []}, {"rgb": [],
                                                          "yuv420": []}
    for transfer in ("rgb", "yuv420", "yuv420", "rgb"):
        stem.stem_conv_pool_infer.launches = 0
        t = time.perf_counter()
        with feed if transfer == "yuv420" else contextlib.nullcontext():
            summaries[transfer] = run_validation(datacfg, spec,
                                                 transfer=transfer, **kw)
        torch.cuda.synchronize()
        secs[transfer].append(time.perf_counter() - t)
        k1[transfer].append(stem.stem_conv_pool_infer.launches)
        sm = summaries[transfer]
        print(f"[native] run_validation(transfer='{transfer}') on "
              f"{sm['n_samples']} held-out frames at {out_shape[0]}², bf16: "
              f"2D@5px {sm['acc_2d_proj']:.2f}%, mean px "
              f"{sm['mean_err_2d']:.6g}; K1 launched {k1[transfer][-1]} "
              f"times; {secs[transfer][-1] * 1e3:.1f} ms the pass [{card}]")
    n_serves = -(-NATIVE_EVAL_FRAMES // TRAIN_BATCH)
    _check(all(n == n_serves for t in k1 for n in k1[t]),
           f"the evals launched K1 {k1}")
    _check(all(summaries[t]["n_samples"] == NATIVE_EVAL_FRAMES and
               np.isfinite(summaries[t]["mean_err_2d"]) for t in summaries),
           f"the rgb and yuv420 evals did not score the split: {summaries}")

    # the first batch's two inputs
    rgb = next(iter(Loader(ds, TRAIN_BATCH, shuffle=False, schedule=None,
                           fixed_shape=out_shape, num_workers=8,
                           drop_last=False, out_uint8=True)))[0]
    y, cbcr = planes_of(ds.lines[:TRAIN_BATCH])
    card_in = yuv420_to_rgb_resized(torch.from_numpy(y).to(dev),
                                    torch.from_numpy(cbcr).to(dev),
                                    out_w=out_shape[0], out_h=out_shape[1])
    cpu_in = yuv420_to_rgb_resized(torch.from_numpy(y),
                                   torch.from_numpy(cbcr),
                                   out_w=out_shape[0], out_h=out_shape[1])
    same = torch.equal(card_in.cpu().view(torch.int32),
                       cpu_in.view(torch.int32))
    delta = (card_in.cpu().numpy() - rgb.astype(np.float32) / 255.0) * 255.0
    luma = np.abs(delta @ np.array([0.299, 0.587, 0.114], np.float32))
    psnr = 10 * np.log10(255.0 ** 2 / max(float((delta ** 2).mean()), 1e-12))
    rgb_bytes, yuv_bytes = rgb.nbytes, y.nbytes + cbcr.nbytes
    print(f"[native] yuv420 input of {TRAIN_BATCH} frames ("
          + ("the native decoder's planes" if built else
             "planes encoded with numpy from the PIL-decoded frames")
          + f") converted to {out_shape[0]}² on the card = the CPU's "
          f"conversion bit for bit: {same}; against the rgb input: luma "
          f"drift mean {luma.mean():.4f} max {luma.max():.4f} u8 levels, "
          f"PSNR {psnr:.2f} dB; bytes a batch: rgb u8 {rgb_bytes}, yuv420 "
          f"{yuv_bytes} ({rgb_bytes / yuv_bytes:.2f}x fewer)")
    _check(same, "the yuv420 conversion on the card is not the CPU's")
    _check(luma.mean() < 1.0 and luma.max() < 16.0 and psnr > 27.0,
           "the yuv420 input fails the luma/PSNR gate against rgb")

    folded = fold_batchnorm(model)
    serves = {"rgb": make_serving_fn(spec, folded, pick=("best",)),
              "yuv420": make_serving_fn(spec, folded, pick=("best",),
                                        transfer="yuv420",
                                        out_shape=out_shape)}
    args = {"rgb": (rgb,), "yuv420": (y, cbcr)}
    copy = {"rgb": lambda: torch.from_numpy(rgb).to(dev),
            "yuv420": lambda: (torch.from_numpy(y).to(dev),
                               torch.from_numpy(cbcr).to(dev))}

    def host_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    serve_ms = {t: [] for t in serves}
    copy_ms = {t: [] for t in serves}
    for t in serves:                                   # warm
        serves[t](*args[t])
    for i in range(NATIVE_SERVES):
        for t in (("rgb", "yuv420") if i % 2 == 0 else ("yuv420", "rgb")):
            copy_ms[t].append(host_ms(copy[t]))
            serve_ms[t].append(host_ms(lambda: serves[t](*args[t])))
    med = {t: (statistics.median(copy_ms[t]), statistics.median(serve_ms[t]))
           for t in serves}
    print(f"[native] batch of {TRAIN_BATCH}, host arrays, in turns, median "
          f"of {NATIVE_SERVES} (host clock with a sync): host-to-card copy "
          f"rgb {med['rgb'][0]:.4f} ms, yuv420 {med['yuv420'][0]:.4f} ms; "
          f"serve with its copy rgb {med['rgb'][1]:.4f} ms "
          f"({min(serve_ms['rgb']):.4f}-{max(serve_ms['rgb']):.4f}), yuv420 "
          f"{med['yuv420'][1]:.4f} ms ({min(serve_ms['yuv420']):.4f}-"
          f"{max(serve_ms['yuv420']):.4f}) [{card}]")
    return {"k1": [k1["rgb"][0], k1["yuv420"][0]], "rgb_bytes": rgb_bytes,
            "yuv_bytes": yuv_bytes, "eval_s": secs, "copy_ms": med}


def phase_native(spec, dev, card: str) -> dict:
    """Phase 19: the native C++ decoder and the yuv420 eval transfer on a
    small corpus written as files (NATIVE_FRAMES train and
    NATIVE_EVAL_FRAMES held-out 640x480 shaded renders as JPEG, PNG masks,
    NATIVE_BACKGROUNDS JPEG backgrounds).  The native library is built
    (g++, libjpeg, libpng) and its build time printed.  Where it builds:
    native against python train batches (8 at 416², host clock; labels
    equal, images within bounds), ``run_training(loader_backend="native")``
    for an epoch of eager full-width steps (K2–K6 once a step), the frame
    bank built with both decoders.  Where it does not: g++'s error, that
    ``backend="native"`` raises it and that ``auto`` resolves to
    ``python``.  Either way ``run_validation`` at 672² with ``rgb`` and
    ``yuv420`` (K1 in each) and the yuv420 input's checks
    (:func:`_native_evals`).  Returns the numbers for the summary line."""
    from singleshotpose_tpu_torch import native
    t_phase = time.perf_counter()
    build_dir = native.BUILD_DIR
    root = tempfile.mkdtemp(prefix="ssp_native_")
    try:
        datacfg, train_list, bgs, frames = _data_corpus(
            root, NATIVE_FRAMES, NATIVE_EVAL_FRAMES, NATIVE_BACKGROUNDS)
        _write_files(frames)
        print(f"[native] wrote {NATIVE_FRAMES} train + {NATIVE_EVAL_FRAMES} "
              f"held-out 640x480 JPEG frames, their PNG masks and "
              f"{NATIVE_BACKGROUNDS} JPEG backgrounds in "
              f"{time.perf_counter() - t_phase:.1f} s")
        # the library's first build and load, timed: into the phase's own
        # directory, with the module's load state reset, so an earlier
        # build in the package's _build/ is not reused
        with native._lock:
            native.BUILD_DIR = f"{root}/_build"
            native._lib = native._error = None
        t = time.perf_counter()
        built = native.load_native() is not None
        build_s = time.perf_counter() - t
        error = native.native_error()
        out = {"built": built, "build_s": build_s, "train_launches": None}
        if built:
            print(f"[native] g++ built and loaded the native library in "
                  f"{build_s:.2f} s: {native.library_path()}")
            out.update(_native_batches(train_list, bgs))
            out["train_launches"] = _native_trainer(spec, dev, card,
                                                    datacfg, root)
            out.update(_native_bank(train_list, bgs))
        else:
            print(f"[native] the native library does not build on this "
                  f"machine ({build_s:.2f} s): {error}")
            ds = PoseDataset(train_list, train=True, bg_file_names=bgs)
            try:
                Loader(ds, TRAIN_BATCH, backend="native")
                raised = None
            except RuntimeError as e:
                raised = str(e)
            auto = Loader(ds, TRAIN_BATCH).backend
            print(f"[native] Loader(backend='native') raises: {raised}; "
                  f"Loader(backend='auto') resolves to {auto!r}")
            _check(raised is not None and error in raised,
                   "backend='native' did not raise the build's error")
            _check(auto == "python", f"auto resolved to {auto!r}")
        out.update(_native_evals(spec, dev, card, datacfg,
                                 f"{root}/test.txt", built))
    finally:
        native.BUILD_DIR = build_dir
        shutil.rmtree(root, ignore_errors=True)
    print(f"[native] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _nth(counts, i):
    """``counts[i]``, or None where the counts were not taken."""
    return None if counts is None else counts[i]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch port "
                                 "on one NVIDIA card.")
    ap.add_argument("--profile", metavar="OUT_DIR",
                    help="after the phases, profile the serves and the "
                         "fused train steps: device time by kernel family, "
                         "idle share, K1 against the plain stem in turns, "
                         "K2-K6 and their plain versions on the device, the "
                         "multi-object serve and batch-32 step, the captured "
                         "step's and the batch-1 graph serve's idle share, "
                         "the fused against the unfused step at batch 64, "
                         "the scene synth's batch, and the int8 serve; "
                         "chrome traces go to OUT_DIR")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    card = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    stem_numbers = phase_kernel(dev, card)
    phase_k2(dev, card)
    train_stem_numbers = phase_train_stem(dev, card)

    spec = yolo_pose_single()
    model = _random_model(spec, dev)
    n_params = sum(t.numel() for t in model.state_dict().values())
    folded = fold_batchnorm(model)
    print(f"[model] yolo_pose_single: {n_params} parameters and BN statistics")
    # the main path: every launch counted from here on came from it
    stem.stem_conv_pool_infer.launches = 0
    phase_model(spec, model, folded, dev)
    served = phase_serve(spec, folded, dev, card)
    launches = stem.stem_conv_pool_infer.launches
    _check(launches > 0, "the serving path launched no stem kernel")
    phase_pose(dev, served)
    state, train_launches, _, k2_numbers, k2_inputs = phase_train(spec, dev,
                                                                  card)
    phase_train_to_serve(spec, state, dev)

    multi = yolo_pose_multi()
    multi_model = _random_model(multi, dev, seed=30)
    multi_folded = fold_batchnorm(multi_model)
    n_params = sum(t.numel() for t in multi_model.state_dict().values())
    print(f"[model] yolo_pose_multi: {n_params} parameters and BN statistics")
    # the multi-object serving path: every K1 launch counted from here on
    stem.stem_conv_pool_infer.launches = 0
    phase_multi_serve(multi, multi_folded, dev, card)
    multi_launches = [stem.stem_conv_pool_infer.launches]
    _check(multi_launches[0] > 0, "the multi serve launched no stem kernel")
    train_multi, _, _, multi_k2_inputs = phase_multi_train(multi, dev, card)
    multi_launches += train_multi

    # the captured paths; each phase frees its graphs and states at its end
    _free()
    captured = phase_captured_train(
        spec, dev, card, "captured train", seed=60, batch=TRAIN_BATCH,
        widths=SINGLE_SCHEDULE.all_widths, sequence=CAPTURED_SEQUENCE,
        epochs=CAPTURED_EPOCHS, labels=_linemod_labels)
    _free()
    captured_multi = phase_captured_train(
        multi, dev, card, "captured multi train", seed=61,
        batch=MULTI_TRAIN_BATCH, widths=MULTI_SCHEDULE.all_widths,
        sequence=MULTI_CAPTURED_SEQUENCE, epochs=MULTI_CAPTURED_EPOCHS,
        labels=_multi_labels, multi=True)
    _free()
    aot = phase_aot_serve(spec, folded, dev, card, multi, multi_folded)
    _free()
    # the device-resident data path: K2-K6 counted from 0 over its eager
    # steps, K1 over its two evals
    device_data = phase_device_data(spec, dev, card)
    _free()
    # the multi-object device-synth path: K2-K6 counted from 0 over its
    # eager steps
    device_synth = phase_device_synth(multi, dev, card)
    _free()
    # the int8 serving path: its conv held to the twin at every shape, then
    # the serves (every int8 conv launch counted from 0 in each) and the CLI
    int8_numbers = phase_int8_kernel(spec, multi, dev, card)
    int8_counts = phase_int8_serve(spec, folded, multi, multi_folded, dev,
                                   card)
    keep = tempfile.mkdtemp(prefix="ssp_q_")
    try:
        int8_eval = phase_int8_cli(spec, model, dev, card, keep)
        _free()
        # the serving artifacts: every K1 and int8 conv launch counted from
        # 0 over the loaded artifacts' calls
        export = phase_export(spec, folded, multi, multi_folded,
                              f"{keep}/q.npz", dev, card)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    _free()
    # data parallel: K2-K6 counted from 0 on each rank over its DP steps, K1
    # over its share of the DP eval
    dp = phase_dp(spec, dev, card)
    _free()
    # tensor parallel: K2-K6 counted from 0 on each rank of the dp=1 x mp=2
    # grid over its steps, K1 over its eval batch; with two cards, the grid
    # captured over NCCL
    tp = phase_tp(spec, dev, card)
    _free()
    # the native decoder and the yuv420 transfer: K2-K6 counted from 0 over
    # the native-fed epoch (where the library builds), K1 over each eval
    nat = phase_native(spec, dev, card)
    _free()
    if args.profile:
        phase_profile(spec, folded, dev, card, args.profile)
        phase_profile_k2(dev, card, args.profile, [
            ("the train step's own inputs", *k2_inputs),
            ("the multi step's own inputs", *multi_k2_inputs)])
        phase_profile_stem(dev, card, args.profile)
        phase_profile_train(spec, dev, card, args.profile)
        phase_profile_multi(multi, multi_folded, dev, card, args.profile)
        phase_profile_captured(spec, folded, dev, card, args.profile)
        phase_profile_gate(spec, dev, card)
        phase_profile_synth(dev, card, args.profile)
        phase_profile_int8(spec, folded, dev, card, args.profile)
    print(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")

    # no single PyTorch call computes any of these functions: library_ms
    # null.  launches: the wrapper's launches on the eager single-object
    # path, launches_multi on the multi-object one (K1 the serve, K2-K6 the
    # train step); captures: the CUDA graphs that recorded the kernel on
    # the captured single-object path (K1 the aot serve, K2-K6 the captured
    # train step), captures_multi on the multi-object one; replays(_multi):
    # those graphs' replays in the phase, each launching it once;
    # launches_device_data, launches_device_synth: the eager steps fed from
    # the frame bank (phase 14) and from the scene synth (phase 15);
    # launches_dp: per rank, the two gloo ranks' DP steps (phase 18; K1:
    # launches_dp_eval, their shares of the DP eval); captures_dp_nccl,
    # replays_dp_nccl: the NCCL rank's graphs of its captured DP step (phase
    # 18: 3 + 3 widths and run_training's 20) and their replays;
    # captures_grid, replays_grid: per rank, the graphs of the dp=1 x mp=2
    # grid's captured step over NCCL (phase 20, where two cards are
    # visible; null on one card) and their replays; launches_native_train:
    # the native-fed epoch's eager steps (phase 19; null where the native
    # library does not build), K1's launches_native_eval: the rgb and the
    # yuv420 eval of phase 19
    def captured_counts(c):
        return {"captures": c["captures"], "replays": c["replays"]}

    k1_captured = {**captured_counts(aot),
                   "captures_multi": aot["captures_multi"],
                   "replays_multi": aot["replays_multi"]}
    train_captured = {**captured_counts(captured),
                      "captures_multi": captured_multi["captures"],
                      "replays_multi": captured_multi["replays"],
                      "captures_dp_nccl": dp["captures"],
                      "replays_dp_nccl": dp["replays"],
                      "captures_grid": tp and tp["captures"],
                      "replays_grid": tp and tp["replays"]}
    kernels = [{
        "name": "stem_conv_pool_infer", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/stem_serve.cu",
        "replaces": "singleshotpose_tpu/ops/stem.py:545",
        "launches": launches, "launches_multi": multi_launches[0],
        "launches_eval_bank": device_data["k1_launches"],
        "launches_export": export["k1"], "launches_dp_eval": dp["k1"],
        "launches_native_eval": nat["k1"],
        **k1_captured, **stem_numbers, "library_ms": None}, {
        "name": "max_corner_confidence", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/max_corner_confidence.cu",
        "replaces": "singleshotpose_tpu/ops/pallas_kernels.py:44",
        "launches": train_launches[0], "launches_multi": multi_launches[1],
        "launches_device_data": device_data["launches"][0],
        "launches_device_synth": device_synth["launches"][0],
        "launches_dp": [r[0] for r in dp["launches"]],
        "launches_native_train": _nth(nat["train_launches"], 0),
        **train_captured, **k2_numbers, "library_ms": None}]
    for i, ((_, name, replaces), n, n_multi, n_data, n_synth) in enumerate(
            zip(_STEM_KERNELS, train_launches[1:], multi_launches[2:],
                device_data["launches"][1:], device_synth["launches"][1:]),
            start=1):
        kernels.append({
            "name": name, "route": "cuda",
            "source": "singleshotpose_tpu_torch/csrc/stem_train.cu",
            "replaces": replaces, "launches": n, "launches_multi": n_multi,
            "launches_device_data": n_data, "launches_device_synth": n_synth,
            "launches_dp": [r[i] for r in dp["launches"]],
            "launches_native_train": _nth(nat["train_launches"], i),
            **train_captured, **train_stem_numbers[name],
            "library_ms": None})
    # int8_conv: no Pallas original (JAX leaves its int8 conv to XLA); its
    # numbers are the sums over the 22 int8 convs of the batch-8 672² serve:
    # ms, plain_ms and bound_ms the fused kernel (each layer's epilogue mode),
    # its twin and its bound, product_ms and product_bound_ms the int32 mode
    # (the product alone), library_ms torch._int_mm on the twin's im2col
    # matrices; serves: the same sums at batch 1 and for the multi serve;
    # launches in the eager int8 serves (batch 8 and 1; the multi serve),
    # every one fused, launches_eval in phase 16's two evals,
    # captures/replays in the int8 serve graphs; launches_export (here and
    # K1's) in phase 17's calls of the loaded serving artifacts
    kernels.append({
        "name": "int8_conv", "route": "cuda",
        "source": "singleshotpose_tpu_torch/csrc/int8_conv.cu",
        "replaces": None, **int8_counts, "launches_eval": int8_eval,
        "launches_export": export["int8"],
        **int8_numbers})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
