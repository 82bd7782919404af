#!/usr/bin/env python3
"""Readings that set a cell's limits: the numbers the benchmark compares,
for the program and for its control, over several seeds in one process.

    python3 portbench/control.py --workload <cell> --kind <kind> \
        --seeds 11,12,13 [--seconds 2]

``--kind program`` runs the cell as the benchmark does (the lower
readings); ``fp8`` puts the plain reference in the program's place, its
convs' operands rounded to float8 e4m3 at a per-tensor scale (the
precision below the configuration's bfloat16), in the cell's window;
``int8`` serves with the program's own int8 path (``models/quantize``:
activations calibrated on the pool's first batch) in place of the bf16
one.  One JSON line a seed: each number compared with the cell's current
limit; every reading, limited or not, is on standard error (``readings:``).
The benchmark's runs never run this; it needs a card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                             "triton")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import harness  # noqa: E402
from portbench.reference import controls  # noqa: E402


class ControlContext(harness.Context):
    """A run whose program objects come from ``controls.stand_in`` (or the
    program's int8 serve)."""

    def __init__(self, *args, kind: str, **kw):
        super().__init__(*args, **kw)
        self.kind = kind

    def program(self, name, build, **parts):
        if self.kind == "program":
            return build()
        if self.kind == "int8" and name == "serve":
            return _int8_serve(parts)
        return controls.stand_in(self.kind, name, self, build, parts)


def _int8_serve(parts: dict):
    """The program's int8 graph serve of the same weights: activations
    calibrated on ``parts["frames"]``, per-channel int8 weights."""
    import torch
    from singleshotpose_tpu_torch import serving
    from singleshotpose_tpu_torch.models import quantize
    spec, folded, frames = parts["spec"], parts["folded"], parts["frames"]
    B, H, W, _ = frames.shape
    x = torch.as_tensor(frames).to(folded["conv_1"]["w"].device)
    act = quantize.calibrate_activations(spec, folded, x.float() / 255.0)
    q = quantize.quantize_folded(spec, folded, act)
    return serving.aot_serving(spec, q, batch=B, width=W, height=H,
                               pick=parts["pick"])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--kind", choices=("program", "fp8", "int8"),
                   required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 3
    cell = harness.Cell(harness.load_benchmark(ROOT), args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = ControlContext(cell, seed=seed, seconds=args.seconds,
                             trace=False, device=torch.device("cuda"),
                             t_process=harness.process_start(),
                             kind=args.kind)
        out = cell.runner().run(ctx)
        print(json.dumps({"workload": args.workload, "kind": args.kind,
                          "seed": seed, "attempted": out["attempted"],
                          "correct": harness.correct(out),
                          "checks": out["checks"]}), flush=True)
        del out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
