"""Command-line entry point of the PyTorch port.

  python -m singleshotpose_tpu_torch.cli train --datacfg D.data --modelcfg M
         [--initweightfile W] [--pretrain_num_epochs N] [--max_epochs N]
         [--bg_dir DIR] [--checkpoint_dir DIR [--resume]] [--device cuda]
  python -m singleshotpose_tpu_torch.cli valid --datacfg D.data --modelcfg M
         --weightfile W.weights [--batch_size N] [--device cuda]

Flags follow ``singleshotpose_tpu/cli.py`` (``train``, ``valid``), with
``--checkpoint_dir`` in place of ``--orbax_dir``; ``--modelcfg`` also takes
the zoo names ``yolo-pose``, ``yolo-pose-multi``, ``yolo-pose-pre``.  The
default device is ``cuda``: without a CUDA device a command fails rather
than run on the CPU; ``--device cpu`` asks for the CPU explicitly.
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


def cmd_train(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli train")
    p.add_argument("--datacfg", type=str, default="cfg/ape.data")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    p.add_argument("--initweightfile", type=str,
                   default="cfg/darknet19_448.conv.23",
                   help="backbone weights ('' to start from random weights)")
    p.add_argument("--pretrain_num_epochs", type=int, default=15)
    p.add_argument("--max_epochs", type=int, default=None,
                   help="override [net] max_epochs")
    p.add_argument("--bg_dir", type=str,
                   default="VOCdevkit/VOC2012/JPEGImages")
    p.add_argument("--checkpoint_dir", type=str, default=None,
                   help="full-state checkpoints here")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint_dir")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    _require_file(args.initweightfile or None, "initial weight file")
    _require_device(args.device)

    from .drivers import TrainRunConfig, run_training
    from .zoo import _resolve_model
    rc = TrainRunConfig(bg_dir=args.bg_dir,
                        max_epochs_override=args.max_epochs,
                        checkpoint_dir=args.checkpoint_dir,
                        resume=args.resume, device=args.device)
    result = run_training(args.datacfg, _resolve_model(args.modelcfg),
                          args.initweightfile or None,
                          args.pretrain_num_epochs, rc)
    print(f"best accuracy: {result['best_acc']}")
    return 0


def cmd_valid(argv: Sequence[str]) -> int:
    p = argparse.ArgumentParser(prog="singleshotpose_tpu_torch.cli valid")
    p.add_argument("--datacfg", type=str, default="cfg/ape.data")
    p.add_argument("--modelcfg", type=str, default="cfg/yolo-pose.cfg")
    p.add_argument("--weightfile", type=str,
                   default="backup/ape/model_backup.weights")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    _require_file(args.datacfg, "data config")
    _require_file(args.weightfile, "weight file")

    _require_device(args.device)
    from .drivers import run_validation
    from .zoo import _resolve_model
    run_validation(args.datacfg, _resolve_model(args.modelcfg),
                   args.weightfile, batch_size=args.batch_size,
                   device=args.device)
    return 0


COMMANDS = {"train": cmd_train, "valid": cmd_valid}


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
