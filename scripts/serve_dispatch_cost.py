#!/usr/bin/env python3
"""Time the port's eager and graph serves in two source trees, in turns, on
one card: what a change to the serving path costs where it runs.

    python3 scripts/serve_dispatch_cost.py --trees OLD NEW [--order 0110]
        [--out FILE]

Each ``--trees`` entry is the root of a checkout of the repository (e.g. a
parent commit unpacked with ``git archive`` beside this one).  Each turn
runs a fresh process that imports ``singleshotpose_tpu_torch`` from one tree
(the kernels built from that tree's sources into its own ``_build/``), on
``yolo_pose_single`` at 672² with random weights from a seed, and times with
CUDA events (median, min and max of 50 calls after 10):

- the bf16 and the int8 eager serves (``make_serving_fn``, best box) at
  batch 1 and 8, u8 frames on the card, the int8 pytree's per-channel
  scales calibrated on the batch-8 frames;
- the bf16 and the int8 graph serves (``aot_serving``) at batch 1;
- where the tree registers the int8 conv as an op: the int8 eager serve at
  batch 1 and 8 with its convs reached through that op (registered with
  ``torch.library.Library``'s ``define``/``impl``), through the same
  implementation registered with ``torch.library.custom_op``, and directly
  (no dispatcher), in turns;
- ``yolo_pose_multi``'s per-class serve at batch 1 and 16, 416², and its
  pick alone (``best_boxes_per_class`` on the decoded grid): their times,
  and at batch 16 the pick's peak device memory above what was allocated
  before it (``torch.cuda.max_memory_allocated``), which its fallback
  fold's (B, classes, S, S) comparison blocks set.

``--order`` lists the trees' turns by index (default ``01100110``: old,
new, new, old, twice).  Prints the card's name and power limit, one line per turn and
measurement, and a JSON object of every number as its last line (also
written to ``--out``).  Needs one CUDA card; imports no jax.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

SIZE, BATCHES, MULTI_SIZE, MULTI_BATCHES = 672, (1, 8), 416, (1, 16)
ITERS, WARMUP = 50, 10


def _spread(fn):
    import torch
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return [statistics.median(times), min(times), max(times)]


def _routes(serve, frames, Q, I) -> dict:
    """The int8 eager serve with its 22 convs reached three ways, in turns
    (library, custom_op, direct, direct, custom_op, library): through the
    ``ssp::int8_conv`` op as registered (``torch.library.Library``'s
    ``define``/``impl``), which a traced program calls; through the same
    CUDA implementation registered with ``torch.library.custom_op``; and
    calling it directly, with no dispatcher, as ``int8_conv()`` does
    outside a trace."""
    import torch
    from unittest import mock
    schema = str(torch.ops.ssp.int8_conv.default._schema)
    torch.library.custom_op(
        "ssp_alt::int8_conv", I._int8_conv_cuda, mutates_args=(),
        device_types="cuda", schema=schema[schema.index("("):])

    def via(op):
        def conv(x, wk, ksize, stride=1, pad=0, epilogue=None, tile=None):
            return I._unflatten_outputs(epilogue, op(
                x, wk, ksize, stride, pad, *I._flatten(epilogue), tile))
        return conv

    routes = {"library": via(torch.ops.ssp.int8_conv.default),
              "custom_op": via(torch.ops.ssp_alt.int8_conv.default),
              "direct": via(I._int8_conv_cuda)}
    out = {}
    for b in BATCHES:
        x = frames[:b].contiguous()
        for name in ("library", "custom_op", "direct", "direct", "custom_op",
                     "library"):
            with mock.patch.object(Q, "int8_conv", routes[name]):
                out.setdefault(f"int8 eager b{b} {name}", []).append(
                    _spread(lambda: serve(x)))
    return out


def worker(root: str) -> dict:
    """One tree's numbers, in this process."""
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import singleshotpose_tpu_torch as pkg
    from singleshotpose_tpu_torch.models import quantize as Q
    from singleshotpose_tpu_torch.models.darknet import Darknet, fold_batchnorm
    from singleshotpose_tpu_torch.ops import int8_conv as I
    from singleshotpose_tpu_torch.ops.decode import best_boxes_per_class
    from singleshotpose_tpu_torch.serving import aot_serving, make_serving_fn
    from singleshotpose_tpu_torch.zoo import yolo_pose_multi, yolo_pose_single
    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(root)):
        raise SystemExit(f"imported {pkg.__file__}, not from {root}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    spec = yolo_pose_single()
    folded = fold_batchnorm(Darknet(spec, generator=gen, device=dev))
    frames = torch.randint(0, 256, (max(BATCHES), SIZE, SIZE, 3),
                           generator=gen, dtype=torch.uint8).to(dev)
    q = Q.quantize_folded(spec, folded, Q.calibrate_activations(
        spec, folded, frames.float() / torch.full((), 255.0, device=dev),
        per_channel=True))
    serves = {"bf16": make_serving_fn(spec, folded, pick=("best",)),
              "int8": make_serving_fn(spec, q, pick=("best",))}
    graphs = {name: aot_serving(spec, p, batch=1, width=SIZE, height=SIZE)
              for name, p in (("bf16", folded), ("int8", q))}
    out = {}
    for b in BATCHES:
        x = frames[:b].contiguous()
        for name, fn in serves.items():
            out[f"{name} eager b{b}"] = _spread(lambda: fn(x))
    for name, fn in graphs.items():
        x = frames[:1].contiguous()
        out[f"{name} graph b1"] = _spread(lambda: fn(x))
    if hasattr(I, "_int8_conv_cuda"):
        out.update(_routes(serves["int8"], frames, Q, I))
    del graphs, serves, folded, q
    torch.cuda.empty_cache()

    multi = yolo_pose_multi()
    mfolded = fold_batchnorm(Darknet(multi, generator=gen, device=dev))
    th = multi.net.conf_thresh
    mserve = make_serving_fn(multi, mfolded, pick=("per_class", th))
    mx = torch.randint(0, 256, (max(MULTI_BATCHES), MULTI_SIZE, MULTI_SIZE,
                                3), generator=gen, dtype=torch.uint8).to(dev)
    for b in MULTI_BATCHES:
        xb = mx[:b].contiguous()
        out[f"multi per_class eager b{b}"] = _spread(lambda: mserve(xb))
        decoded = make_serving_fn(multi, mfolded)(xb)
        out[f"per_class pick b{b}"] = _spread(
            lambda: best_boxes_per_class(decoded, th))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    best_boxes_per_class(decoded, th)
    torch.cuda.synchronize()
    out["per_class pick peak MB"] = \
        (torch.cuda.max_memory_allocated() - base) / 1e6
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--trees", nargs="+", required=True)
    ap.add_argument("--order", default="01100110")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker is not None:
        print("WORKER " + json.dumps(worker(args.worker)))
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    turns = []
    for i in args.order:
        tree = args.trees[int(i)]
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--trees", tree,
             "--worker", tree], capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return proc.returncode
        nums = json.loads(next(line for line in proc.stdout.splitlines()
                               if line.startswith("WORKER "))[len("WORKER "):])
        turns.append({"tree": tree, **nums})
        for key, v in nums.items():
            runs = v if isinstance(v, list) and isinstance(v[0], list) else \
                [v] if isinstance(v, list) else None
            what = f"{v:.1f}" if runs is None else ", ".join(
                f"{m:.4f} ms ({lo:.4f}-{hi:.4f})" for m, lo, hi in runs)
            print(f"[dispatch] turn {len(turns)} {tree}: {key}: {what} "
                  f"[{smi}]")
    result = {"card": smi, "turns": turns}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
