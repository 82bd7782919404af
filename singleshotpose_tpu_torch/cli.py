"""Command-line entry point of the PyTorch port.

  python -m singleshotpose_tpu_torch.cli train --datacfg D.data --modelcfg M
         [--initweightfile W] [--pretrain_num_epochs N] [--max_epochs N]
         [--bg_dir DIR] [--checkpoint_dir DIR [--resume]]
         [--precompile_buckets] [--profile_dir DIR] [--cache_decoded]
         [--loader_backend auto|python|native|device|device_bank]
         [--eval_transfer auto|rgb|yuv420|bank] [--dp N] [--device cuda]
  python -m singleshotpose_tpu_torch.cli valid --datacfg D.data --modelcfg M
         (--weightfile W.weights | --checkpoint_dir DIR [--step N])
         [--batch_size N] [--transfer rgb|yuv420|bank] [--quantize [Q.npz]]
         [--save] [--add_s] [--dp N] [--device cuda]
  python -m singleshotpose_tpu_torch.cli train-multi --datacfg occlusion.data
         [--modelcfg M] [--initweightfile W] [--linemod_root DIR]
         [--eval_datacfgs D.data ...] [--max_epochs N] [--bg_dir DIR]
         [--checkpoint_dir DIR [--resume]] [--precompile_buckets]
         [--profile_dir DIR] [--cache_decoded]
         [--eval_transfer auto|rgb|yuv420|bank]
         [--loader_backend auto|python|device_synth [--synth_attempts N]
         [--synth_propose_scale N]] [--dp N] [--device cuda]
  python -m singleshotpose_tpu_torch.cli valid-multi --weightfile W.weights
         [--modelcfg M] [--datacfgs D.data ... | --datacfg occlusion.data]
         [--transfer rgb|yuv420|bank] [--quantize] [--device cuda]
  python -m singleshotpose_tpu_torch.cli quantize --datacfg D.data
         --modelcfg M --weightfile W.weights --out Q.npz [--calib_images 32]
         [--act_scales per_channel|scalar] [--device cuda]
  python -m singleshotpose_tpu_torch.cli export --modelcfg M
         (--weightfile W.weights | --quantized Q.npz | --checkpoint_dir DIR
         [--step N]) --out A.pt2 [--width 544] [--height 544] [--batch N]
         [--pick grid|best|per_class|for_class] [--conf_thresh 0.1]
         [--cls 0] [--compute bfloat16|float32] [--float_input]
         [--device cuda]
  python -m singleshotpose_tpu_torch.cli make-labels --mesh M.ply --poses P.npz
         --out labels/ [--class_id 0] [--width 640] [--height 480]
  python -m singleshotpose_tpu_torch.cli print-cfg <cfgfile>

Flags follow ``singleshotpose_tpu/cli.py`` (``train``, ``valid``,
``train-multi``, ``valid-multi``, ``quantize``, ``export``, ``make-labels``,
``print-cfg``, the last two host-only and device-free; the ``.npz`` of
``quantize`` is the JAX package's format, so either package serves the
other's), with ``--checkpoint_dir`` in place of
``--orbax_dir``.  ``export`` has ``--device`` in place of ``--platforms``:
the artifact (``torch.export``) is traced on that device, and
``serving.load_serving(path, device=)`` runs it on any device (the card by
default), its kernels' ops dispatching by device.  ``--modelcfg`` also takes
the zoo names ``yolo-pose``, ``yolo-pose-multi``, ``yolo-pose-pre`` and
``yolov3-pose`` (which trains, quantizes and exports not yet).  The
default device is ``cuda``: without a CUDA device a command fails rather
than run on the CPU; ``--device cpu`` asks for the CPU explicitly.

``--dp N`` (``train``, ``train-multi``, ``valid``): data parallel over N
ranks, one process each (``parallel/``; ``0``, the default, is one process
with no group, ``1`` a group of one).  Under ``torchrun`` (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` set) this process is one rank and
``WORLD_SIZE`` must be N; otherwise ``--dp 1`` runs its group of one in
this process, and a larger N starts N local ranks (spawned, a TCP
rendezvous on a free local port).  Rank r runs on
``cuda:<local rank>`` with NCCL — N cards are needed — or, with ``--device
cpu``, on the CPU with gloo.  A host loader gives each rank its shard of
the dataset; ``device_bank`` and ``device_synth`` give each rank the whole
bank, and each rank makes its rows of every global batch.
``--precompile_buckets`` captures each rank's step with its NCCL
collectives (``--dp 1`` on one card too); over gloo it is refused.  ``valid --checkpoint_dir`` evaluates a
full-state checkpoint (JAX's ``--orbax_dir``): the offline eval of a
data-parallel training run.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def _require_file(path: Optional[str], what: str) -> None:
    if path and not os.path.exists(path):
        raise SystemExit(f"error: {what} not found: {path}")


def _require_device(device: str) -> None:
    import torch
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {device}: CUDA is not "
                         "available (pass --device cpu to run on the CPU)")


_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK")


def _add_dp_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp", type=int, default=0,
                   help="data parallel over N ranks, one process each (0 = "
                        "one process, no group; 1 = a group of one); under "
                        "torchrun WORLD_SIZE must be N, otherwise 1 runs "
                        "in this process and N > 1 local ranks are started "
                        "here, rank r on cuda:r (or the CPU with --device "
                        "cpu)")


def _spawned_rank(rank: int, world: int, port: int, argv: list) -> None:
    """One local rank started by :func:`_run_ranks`: the command again, as
    ``torchrun`` would start it."""
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    code = main(argv)
    if code:
        raise SystemExit(code)


def _as_rank(args, body, device) -> int:
    """``body(args, group)`` with ``--dp``'s group on ``device``, the
    process group torn down after."""
    import torch.distributed as dist

    from .parallel.sharding import make_dp_group
    try:
        return body(args, make_dp_group(args.dp, device=device))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _rank(args, body) -> int:
    """``body(args, group)`` as this process's rank of ``--dp``'s group,
    the rendezvous from the environment (``env://``)."""
    import torch

    from .parallel.multihost import initialize_distributed
    world = int(os.environ["WORLD_SIZE"])
    if world != args.dp:
        raise SystemExit(f"error: --dp {args.dp} but WORLD_SIZE={world}")
    local = int(os.environ["LOCAL_RANK"])
    if args.device == "cpu":
        device = torch.device("cpu")
        # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // world))
    else:
        if local >= torch.cuda.device_count():
            raise SystemExit(f"error: local rank {local} has no card "
                             f"({torch.cuda.device_count()} visible)")
        device = torch.device("cuda", local)
    initialize_distributed(world_size=world, rank=int(os.environ["RANK"]),
                           device=device)
    return _as_rank(args, body, device)


def _run_ranks(argv: Sequence[str], args, body) -> int:
    """Run ``body(args, group)``: with no group at ``--dp 0``; as one rank
    under ``torchrun``; a group of one in this process at ``--dp 1``; else
    on ``--dp`` local ranks started here (spawn, never fork: a forked child
    of a process that used CUDA cannot), whose rendezvous port is bound
    free and handed over — a port lost to another process in between is
    retried on a new one."""
    if args.dp < 0:
        raise SystemExit(f"error: --dp {args.dp} < 0")
    if args.dp == 0:
        return body(args, None)
    if args.device not in ("cuda", "cpu"):
        raise SystemExit(f"error: --dp places rank r on cuda:r or the CPU; "
                         f"pass --device cuda or cpu, not {args.device}")
    if all(k in os.environ for k in _TORCHRUN_ENV):
        return _rank(args, body)
    import torch
    import torch.multiprocessing as mp

    from .parallel.sharding import free_port
    if args.device == "cuda" and torch.cuda.device_count() < args.dp:
        raise SystemExit(f"error: --dp {args.dp} --device cuda needs "
                         f"{args.dp} cards; {torch.cuda.device_count()} "
                         "visible")
    if args.dp == 1:
        return _as_rank(args, body, torch.device(args.device))
    for attempt in range(3):
        try:
            mp.spawn(_spawned_rank, args=(args.dp, free_port(), list(argv)),
                     nprocs=args.dp, join=True)
            return 0
        except mp.ProcessRaisedException as e:
            if attempt == 2 or not any(
                    m in str(e) for m in ("EADDRINUSE",
                                          "Address already in use")):
                raise
    return 1


def _add_train_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max_epochs", type=int, default=None,
                   help="override [net] max_epochs")
    p.add_argument("--bg_dir", type=str,
                   default="VOCdevkit/VOC2012/JPEGImages")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="full-state checkpoints here")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint_dir")
    p.add_argument("--precompile_buckets", action="store_true",
                   help="capture the train step as one CUDA graph per "
                        "multi-scale bucket before epoch 0 (no per-step "
                        "launch cost); nothing on the CPU")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="write a torch.profiler trace of steps 5-10 here")
    p.add_argument("--cache_decoded", action="store_true",
                   help="RAM-cache decoded images across epochs")
    p.add_argument("--loader_backend", type=str, default="auto",
                   choices=["auto", "python", "native", "device",
                            "device_bank", "device_synth"],
                   help="train: native (the C++ fused decode and augment), "
                        "python (PIL and numpy), auto (native when its "
                        "library builds, else python), "
                        "device (host decode, augment on the card) or "
                        "device_bank (the train split decoded once into "
                        "device memory, augmented on the card); train-multi: "
                        "auto/python (host synthesis) or device_synth (the "
                        "corpus in device memory, scenes composited on the "
                        "card)")
    p.add_argument("--synth_attempts", type=int, default=None,
                   help="device_synth: parallel placement proposals per "
                        "companion (default: the host synthesizer's "
                        "max_attempts, its drop law; lower = faster, fewer "
                        "objects in crowded scenes)")
    p.add_argument("--synth_propose_scale", type=int, default=4,
                   help="device_synth: mask-overlap test resolution divisor "
                        "(1 = the host's full-resolution ratio)")
    p.add_argument("--eval_transfer", type=str, default="auto",
                   choices=["auto", "rgb", "yuv420", "bank"],
                   help="in-training eval input: rgb u8 batches from the "
                        "host, yuv420 native-size planes (the native "
                        "decoder's; the device converts), or bank (the test "
                        "split decoded once into "
                        "device memory); auto picks bank when it fits the "
                        "card's free memory, else rgb")
    _add_dp_flag(p)
    p.add_argument("--device", type=str, default="cuda")


def _add_transfer_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--transfer", type=str, default="rgb",
                   choices=["rgb", "yuv420", "bank"],
                   help="input path: rgb u8 batches from the host, yuv420 "
                        "native-size planes (the native decoder's; the "
                        "device converts and resizes), or bank "
                        "(the split decoded once into device memory; "
                        "repeated evals in one process reuse it)")


def _run_config(args, group, **overrides):
    from .drivers import TrainRunConfig
    return TrainRunConfig(group=group, bg_dir=args.bg_dir,
                          max_epochs_override=args.max_epochs,
                          checkpoint_dir=args.checkpoint_dir,
                          resume=args.resume, device=args.device,
                          precompile_buckets=args.precompile_buckets,
                          profile_dir=args.profile_dir,
                          cache_decoded=args.cache_decoded,
                          loader_backend=args.loader_backend,
                          synth_attempts=args.synth_attempts,
                          synth_propose_scale=args.synth_propose_scale,
                          eval_transfer=args.eval_transfer, **overrides)


def cmd_train(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli train")
    p.add_argument("--datacfg", type=str, default="cfg/ape.data")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    p.add_argument("--initweightfile", type=str,
                   default="cfg/darknet19_448.conv.23",
                   help="backbone weights ('' to start from random weights)")
    p.add_argument("--pretrain_num_epochs", type=int, default=15)
    _add_train_flags(p)
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    _require_file(args.initweightfile or None, "initial weight file")
    _require_device(args.device)
    return _run_ranks(["train", *argv], args, _train)


def _train(args, group) -> int:
    from .drivers import run_training
    from .zoo import _resolve_model
    result = run_training(args.datacfg, _resolve_model(args.modelcfg),
                          args.initweightfile or None,
                          args.pretrain_num_epochs, _run_config(args, group))
    if group is None or group.rank == 0:
        print(f"best accuracy: {result['best_acc']}")
    return 0


def cmd_train_multi(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli train-multi")
    p.add_argument("--datacfg", type=str, default="cfg/occlusion.data")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose-multi.cfg")
    p.add_argument("--initweightfile", type=str,
                   default="backup_multi/init.weights",
                   help="backbone weights ('' to start from random weights)")
    p.add_argument("--pretrain_num_epochs", type=int, default=0)
    p.add_argument("--linemod_root", type=str, default=None)
    p.add_argument("--eval_datacfgs", type=str, nargs="*", default=None)
    _add_train_flags(p)
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    _require_file(args.initweightfile or None, "initial weight file")
    _require_device(args.device)
    return _run_ranks(["train-multi", *argv], args, _train_multi)


def _train_multi(args, group) -> int:
    from .drivers import run_training_multi
    from .zoo import _resolve_model
    eval_dcs = args.eval_datacfgs
    if eval_dcs is None:
        # reference sweep: train_multi.py:277-297
        eval_dcs = [f"cfg/{o}_occlusion.data"
                    for o in ("ape", "can", "cat", "duck", "driller", "glue")]
        eval_dcs = [dc for dc in eval_dcs if os.path.exists(dc)]
    result = run_training_multi(
        args.datacfg, _resolve_model(args.modelcfg),
        args.initweightfile or None, args.pretrain_num_epochs, eval_dcs,
        args.linemod_root,
        _run_config(args, group, eval_every=20, eval_after=-1))
    if group is None or group.rank == 0:
        print(f"best accuracy: {result['best_acc']}")
    return 0


def cmd_valid(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli valid")
    p.add_argument("--datacfg", type=str, default="cfg/ape.data")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    p.add_argument("--weightfile", type=str,
                   default="backup/ape/model_backup.weights")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="evaluate a full-state checkpoint instead of "
                        "--weightfile (the offline eval of a data-parallel "
                        "training run)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--save", action="store_true",
                   help="dump per-frame R/t/corners + predictions .mat")
    p.add_argument("--quantize", nargs="?", const=True, default=False,
                   metavar="QNPZ",
                   help="serve the backbone convs in int8 (the int8 conv "
                        "kernel on a card): the bare flag calibrates on the "
                        "first batch; a .npz from `quantize` serves that "
                        "artifact (no --weightfile needed)")
    p.add_argument("--add_s", action="store_true",
                   help="score the 3D-transform metric as ADD-S (nearest-"
                        "neighbour vertex distance), the protocol for "
                        "symmetric objects; default: index-matched ADD, as "
                        "the reference")
    _add_transfer_flag(p)
    _add_dp_flag(p)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    if isinstance(args.quantize, str):
        _require_file(args.quantize, "quantized artifact")
    elif args.checkpoint_dir:
        _require_checkpoint(args.checkpoint_dir)
    else:
        _require_file(args.weightfile, "weight file")
    _require_device(args.device)
    return _run_ranks(["valid", *argv], args, _valid)


def _valid(args, group) -> int:
    from .drivers import run_validation
    from .zoo import _resolve_model
    spec = _resolve_model(args.modelcfg)
    device = args.device if group is None else group.device
    kw = dict(batch_size=args.batch_size, transfer=args.transfer,
              quantize=args.quantize, add_s=args.add_s, save=args.save,
              device=device, group=group)
    if isinstance(args.quantize, str):
        # the int8 .npz is the serving artifact: no float weights
        run_validation(args.datacfg, spec, None, **kw)
    elif args.checkpoint_dir:
        model, step = _restore_checkpoint(spec, args.checkpoint_dir,
                                          args.step, device)
        if group is None or group.rank == 0:
            print(f"evaluating checkpoint step {step} from "
                  f"{args.checkpoint_dir}")
        run_validation(args.datacfg, spec, model=model, **kw)
    else:
        run_validation(args.datacfg, spec, args.weightfile, **kw)
    return 0


def _require_checkpoint(directory: str) -> None:
    from .checkpoint import latest_step
    if latest_step(directory) is None:
        raise SystemExit(f"error: no checkpoints under {directory}")


def _restore_checkpoint(spec, directory: str, step: Optional[int], device):
    """The model of checkpoint ``step`` (the latest when None) under
    ``directory``, on ``device``.  Returns (model, step)."""
    from .checkpoint import Checkpointer
    from .models.darknet import Darknet
    from .training import init_train_state
    model = Darknet(spec, device=device)
    state = init_train_state(model, weight_decay=0.0, momentum=0.0)
    return model, Checkpointer(directory).restore(state, step)


def cmd_valid_multi(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli valid-multi")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose-multi.cfg")
    p.add_argument("--weightfile", type=str,
                   default="backup_multi/model_backup.weights")
    p.add_argument("--datacfgs", type=str, nargs="*", default=None,
                   help="per-object occlusion .data files; default: the "
                        "reference's 6-object sweep under cfg/")
    p.add_argument("--datacfg", type=str, default=None,
                   help="a multi .data with valid<i>/mesh<i>/diam<i> keys "
                        "(e.g. occlusion.data): evals every listed object")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--quantize", action="store_true",
                   help="serve the backbone convs in int8 (first-batch "
                        "calibration per object)")
    _add_transfer_flag(p)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.weightfile, "weight file")
    _require_device(args.device)

    from .drivers import (OCCLUSION_EVAL_OBJECTS, run_validation_multi,
                          run_validation_multi_sweep)
    from .zoo import _resolve_model
    spec = _resolve_model(args.modelcfg)
    kw = dict(batch_size=args.batch_size, transfer=args.transfer,
              quantize=args.quantize, device=args.device)
    if args.datacfg:
        _require_file(args.datacfg, "data config")
        run_validation_multi_sweep(args.datacfg, spec, args.weightfile, **kw)
        return 0
    datacfgs = args.datacfgs or [
        f"cfg/{obj}_occlusion.data" for obj in OCCLUSION_EVAL_OBJECTS]
    for dc in datacfgs:
        _require_file(dc, "data config")
    for dc in datacfgs:
        run_validation_multi(dc, spec, args.weightfile, **kw)
    return 0


def cmd_quantize(argv: Sequence[str]) -> int:
    """Calibrate and quantize a trained net into an int8 ``.npz``
    (``singleshotpose_tpu/cli.py:253-307``)."""
    p = argparse.ArgumentParser(
        prog="singleshotpose_tpu_torch.cli quantize",
        description="calibrate + quantize a trained net to an int8 .npz")
    p.add_argument("--datacfg", type=str, required=True,
                   help=".data whose valid list supplies calibration images")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    p.add_argument("--weightfile", type=str, required=True)
    p.add_argument("--out", type=str, required=True, help="output .npz path")
    p.add_argument("--calib_images", type=int, default=32,
                   help="number of calibration images (one batch)")
    p.add_argument("--act_scales", choices=("per_channel", "scalar"),
                   default="per_channel",
                   help="activation scale granularity: per_channel folds "
                        "per-input-channel ranges into the weights, scalar "
                        "is plain absmax")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    _require_file(args.weightfile, "weight file")
    _require_device(args.device)

    import torch
    from . import weights as W
    from .config import data_config_from_options, read_data_cfg
    from .data.pipeline import Loader, PoseDataset
    from .models.darknet import Darknet, fold_batchnorm
    from .models.quantize import (calibrate_activations, quantize_folded,
                                  save_quantized)
    from .zoo import _resolve_model

    spec = _resolve_model(args.modelcfg)
    model = Darknet(spec, device=args.device)
    model.load_state_dict(W.load_weights(spec, args.weightfile)[1])
    dcfg = data_config_from_options(read_data_cfg(args.datacfg))
    ds = PoseDataset(dcfg.valid, train=False,
                     num_keypoints=spec.num_keypoints)
    n = min(args.calib_images, len(ds))
    loader = Loader(ds, n, shuffle=False, schedule=None,
                    fixed_shape=(spec.net.test_width, spec.net.test_height),
                    num_workers=2, drop_last=False, out_uint8=True)
    images, _ = next(iter(loader))
    # JAX divides eagerly; a device-tensor divisor keeps the card's true
    calib = torch.as_tensor(images).to(args.device).float() \
        / torch.full((), 255.0, device=args.device)
    folded = fold_batchnorm(model)
    amax = calibrate_activations(
        spec, folded, calib, per_channel=args.act_scales == "per_channel")
    qp = quantize_folded(spec, folded, amax)
    save_quantized(args.out, qp)
    nq = sum(1 for v in qp.values() if "wq" in v)
    print(f"quantized {nq}/{len(qp)} conv layers on {n} calibration images "
          f"-> {args.out}")
    return 0


def _parse_pick(pick: str, conf_thresh: float, cls: int):
    """``--pick`` and its thresholds → a ``serving.Pick``."""
    return {"grid": None, "best": ("best",),
            "per_class": ("per_class", conf_thresh),
            "for_class": ("for_class", cls, conf_thresh)}[pick]


def cmd_export(argv: Sequence[str]) -> int:
    """Freeze a trained net — darknet weights, an int8 ``.npz`` or a
    checkpoint — into one serving artifact
    (``singleshotpose_tpu/serving.py:373-441``).  ``--checkpoint_dir`` takes
    the place of ``--orbax_dir``, and ``--device`` that of ``--platforms``:
    the artifact is traced on that device, and ``serving.load_serving`` can
    move it to another."""
    p = argparse.ArgumentParser(
        prog="singleshotpose_tpu_torch.cli export",
        description="freeze a trained net into a torch.export serving "
                    "artifact (weights baked in; loads with torch and this "
                    "package's ops)")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--weightfile", type=str,
                     help="darknet .weights (BN folded at export)")
    src.add_argument("--quantized", type=str,
                     help="int8 .npz from `quantize` (either package's; "
                          "int8 serving)")
    src.add_argument("--checkpoint_dir", type=str,
                     help="export from a full-state checkpoint (training → "
                          "serving with no .weights detour)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: latest)")
    p.add_argument("--out", type=str, required=True)
    p.add_argument("--width", type=int, default=544)
    p.add_argument("--height", type=int, default=544)
    p.add_argument("--batch", type=int, default=None,
                   help="fixed batch (default: batch-polymorphic export)")
    p.add_argument("--pick", type=str, default="best",
                   choices=["grid", "best", "per_class", "for_class"])
    p.add_argument("--conf_thresh", type=float, default=0.1)
    p.add_argument("--cls", type=int, default=0,
                   help="class id for --pick for_class")
    p.add_argument("--compute", type=str, default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--float_input", action="store_true",
                   help="take float [0,1] inputs instead of uint8")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.weightfile, "weight file")
    _require_file(args.quantized, "quantized artifact")
    _require_device(args.device)

    import torch
    from .models.darknet import Darknet, fold_batchnorm
    from .serving import export_serving, save_exported
    from .zoo import _resolve_model
    spec = _resolve_model(args.modelcfg)
    if args.quantized:
        from .models.quantize import load_quantized
        params = load_quantized(args.quantized, device=args.device)
    else:
        if args.checkpoint_dir:
            _require_checkpoint(args.checkpoint_dir)
            model, step = _restore_checkpoint(spec, args.checkpoint_dir,
                                              args.step, args.device)
            print(f"exporting checkpoint step {step} from "
                  f"{args.checkpoint_dir}")
        else:
            from . import weights as W
            model = Darknet(spec, device=args.device)
            model.load_state_dict(W.load_weights(spec, args.weightfile)[1])
        params = fold_batchnorm(model)

    exported = export_serving(
        spec, params, width=args.width, height=args.height, batch=args.batch,
        pick=_parse_pick(args.pick, args.conf_thresh, args.cls),
        compute_dtype=torch.bfloat16 if args.compute == "bfloat16"
        else None,
        input_dtype=torch.float32 if args.float_input else torch.uint8)
    save_exported(args.out, exported)
    size_mb = os.path.getsize(args.out) / 1e6
    kind = "int8" if args.quantized else "bf16-folded"
    bstr = "poly" if args.batch is None else str(args.batch)
    print(f"exported {kind} serving fn ({args.width}x{args.height}, "
          f"batch={bstr}, pick={args.pick}, device={args.device}) -> "
          f"{args.out} ({size_mb:.1f} MB)")
    return 0


def cmd_make_labels(argv: Sequence[str]) -> int:
    """Create 21-float label files from a mesh + GT poses (the recipe the
    reference only documents, ``label_file_creation.md``)."""
    from .make_labels import main as run
    return run(argv)


def cmd_print_cfg(argv: Sequence[str]) -> int:
    from .config import parse_cfg, print_cfg
    if not argv:
        print("usage: ssp print-cfg <cfgfile>", file=sys.stderr)
        return 2
    print_cfg(parse_cfg(argv[0]))
    return 0


COMMANDS = {"train": cmd_train, "valid": cmd_valid,
            "train-multi": cmd_train_multi, "valid-multi": cmd_valid_multi,
            "quantize": cmd_quantize, "export": cmd_export,
            "make-labels": cmd_make_labels, "print-cfg": cmd_print_cfg}


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        return 0 if argv else 2
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        print(f"unknown command {argv[0]!r}; choose from {sorted(COMMANDS)}",
              file=sys.stderr)
        return 2
    return cmd(argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
