"""Command-line entry point of the PyTorch port.

  python -m singleshotpose_tpu_torch.cli valid --datacfg D.data --modelcfg M
         --weightfile W.weights [--batch_size N] [--device cuda]

Flags follow ``singleshotpose_tpu/cli.py`` (``valid``); ``--modelcfg`` also
takes the zoo names ``yolo-pose``, ``yolo-pose-multi``, ``yolo-pose-pre``.
The default device is ``cuda``: without a CUDA device the command fails
rather than run on the CPU; ``--device cpu`` asks for the CPU explicitly.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Optional, Sequence


def _require_file(path: Optional[str], what: str) -> None:
    if path and not os.path.exists(path):
        raise SystemExit(f"error: {what} not found: {path}")


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

    import torch
    from .drivers import run_validation
    from .zoo import _resolve_model
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device}: CUDA is not "
                         "available (pass --device cpu to run on the CPU)")
    run_validation(args.datacfg, _resolve_model(args.modelcfg),
                   args.weightfile, batch_size=args.batch_size,
                   device=args.device)
    return 0


COMMANDS = {"valid": cmd_valid}


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
