#!/usr/bin/env python3
"""Time variants of K2, the max corner confidence kernel, side by side on one
card.

    python3 scripts/k2_variants.py                   # from the repository root
    python3 scripts/k2_variants.py --source parent=DIR/singleshotpose_tpu_torch/csrc/max_corner_confidence.cu

As ``scripts/stem_serve_variants.py`` does for K1, with its helpers: each
variant is ``csrc/max_corner_confidence.cu`` with one textual change, built
with the port's nvcc flags (one nvcc each, started together) into
``singleshotpose_tpu_torch/_build/k2_variants/``; ``--source NAME=FILE``
adds another source whole (an earlier commit's K2, say) as the variant NAME.
The rows: the inputs the first fused train step of ``chip_smoke.py``'s
train phase gives K2 (its seeds, the full-width model), then
``chip_smoke.py``'s K2 rows (the same seeded inputs: one valid slot an
image at (8,50,169), eight at (32,50,845), then 1..50 at (8,50,169),
(8,50,676) and (32,50,845)).  It prints each variant's registers and
spill stores (``-Xptxas -v``), its SASS instruction count, whether its
output has the kernel's bits (all variants but ``no_pairs`` compute the
same function) and a SHA-256 of its output's bytes, and its time in three
rounds of turns (forward, then backward through the list): the device µs
a launch from a torch.profiler trace of 20 launches, and CUDA events
around 50 back-to-back launches, which also count the host's ctypes call.
The variants: 12 or 32 cells a block (the kernel: 24); K lanes a pair
always (``lanes``) or never (``threads``; the kernel: when one pass takes
a round's pairs), each also at 12 cells; and the kernel without its pairs
(``no_pairs``: the flags, staging and stores alone).
Needs one CUDA card and nvcc; imports no jax.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import re
import statistics
import subprocess
import sys
import tempfile

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402
from singleshotpose_tpu_torch.ops import cuda_build  # noqa: E402
from singleshotpose_tpu_torch.ops.confidence import \
    confidence_denominator  # noqa: E402
from singleshotpose_tpu_torch.zoo import yolo_pose_single  # noqa: E402
from stem_serve_variants import (_chain, _sub, build_variants,  # noqa: E402
                                 card, per_launch_us, ptxas_usage)

PROFILED, ROUNDS = 20, 3


def _cells(n: int):
    return _sub("constexpr int kCells = 24;", f"constexpr int kCells = {n};")


def _lanes(always: bool):
    """K lanes a pair for every round (as many passes as it takes), or
    never."""
    if not always:
        return _sub("if (0 < pairs && pairs <= kPass)", "if (false)")
    return _chain(
        _sub("if (0 < pairs && pairs <= kPass)", "if (0 < pairs)"),
        _sub("      const int p = warp * kPerWarp + lane / K;\n",
             "      for (int p0 = 0; p0 < pairs; p0 += kPass) {\n"
             "      const int p = p0 + warp * kPerWarp + lane / K;\n"),
        _sub("__float_as_uint(__fdiv_rn(sum, (float)K)));\n",
             "__float_as_uint(__fdiv_rn(sum, (float)K)));\n      }\n"))


# name: (change, computes the kernel's function)
VARIANTS = {
    "kernel": (None, True),
    "cells12": (_cells(12), True),
    "cells32": (_cells(32), True),
    "lanes": (_lanes(True), True),
    "lanes_cells12": (_chain(_lanes(True), _cells(12)), True),
    "threads": (_lanes(False), True),
    "threads_cells12": (_chain(_lanes(False), _cells(12)), True),
    # G < 0 never holds, so the compiler keeps the rest
    "no_pairs": (_sub("const int pairs = nc * nr;",
                      "const int pairs = G < 0 ? nc * nr : 0;"), False),
}


def sass_counts(lib: str) -> str:
    """Instructions in the kernel's SASS, and of them MUFU, FCHK and CALL
    (the IEEE division's check and slow path), read with the toolkit's
    cuobjdump."""
    tool = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "--dump-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    body = "".join(sec for sec in sass.split("Function : ")[1:]
                   if "max_corner_confidence_kernel" in sec.split("\n", 1)[0])
    lines = re.findall(r"/\*[0-9a-f]{4}\*/\s+(\S+ ?\S*)", body)
    ops = [ln.split()[-1] if ln.startswith("@") else ln.split()[0]
           for ln in lines]
    count = {op: sum(o.startswith(op) for o in ops)
             for op in ("MUFU", "FCHK", "CALL")}
    return f"{len(ops)} SASS instructions, " + ", ".join(
        f"{v} {k}" for k, v in count.items())


def device_us(fn) -> float:
    """Device µs a call of ``fn`` from a torch.profiler trace of PROFILED
    calls (the kernels' durations, as ``chip_smoke.py --profile`` reads
    them)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(PROFILED):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        by_family, _ = chip_smoke._device_time(path)
    return sum(by_family.values()) / PROFILED


def step_row(dev):
    """The inputs the first fused train step of ``chip_smoke.py``'s train
    phase gives K2: (label, gt, valid, pred)."""
    state, cfg, _ = chip_smoke._train_setup(yolo_pose_single(), dev, seed=5,
                                            fused_stem=True)
    frames, labels = chip_smoke._train_batches(dev, 1, seed=8)[0]
    return ("the first train step's own inputs",
            *chip_smoke._k2_step_inputs(state, cfg, frames, labels))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", metavar="NAME=FILE", action="append",
                    default=[],
                    help="another K2 source (e.g. an earlier commit's "
                         "csrc/max_corner_confidence.cu), built as the "
                         "variant NAME; repeatable")
    args = ap.parse_args(argv)
    smi = card()
    dev = torch.device("cuda", 0)
    variants = dict(VARIANTS)
    for spec in args.source:
        name, path = spec.split("=", 1)
        with open(path) as f:
            text = f.read()
        variants[name] = (lambda srcs, text=text: {**srcs, "main": text},
                          True)
    p, i, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    built = build_variants(
        os.path.join(cuda_build.BUILD_DIR, "k2_variants"),
        "max_corner_confidence", variants, "max_corner_confidence_launch",
        [p] * 4 + [i] * 4 + [f32] * 5 + [p])
    for name, (_, log) in built.items():
        path = os.path.join(cuda_build.BUILD_DIR, "k2_variants", name,
                            "lib.so")
        print(f"[variants] {name}: "
              f"{ptxas_usage(log, 'max_corner_confidence_kernel')}; "
              f"{sass_counts(path)}")
    denom = confidence_denominator(2.0)
    stream = torch.cuda.current_stream().cuda_stream
    for label, gt, valid, pred in [step_row(dev), *chip_smoke._k2_rows(dev)]:
        B, G, _ = gt.shape
        S = pred.shape[1]
        tag = f"({B},{G},{S}) {label}, {int(valid.sum())} valid slots: "
        outs = {}

        def launcher(lib, out):
            def launch():
                err = lib.max_corner_confidence_launch(
                    gt.data_ptr(), valid.data_ptr(), pred.data_ptr(),
                    out.data_ptr(), B, G, S, 9, 80.0, 2.0, 640.0, 480.0,
                    denom, stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return launch

        runs = {}
        for name, (lib, _) in built.items():
            outs[name] = torch.full((B, S), float("nan"), device=dev)
            runs[name] = launcher(lib, outs[name])
            runs[name]()
        torch.cuda.synchronize()
        for name, out in outs.items():
            sha = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()
            what = f"the kernel's bits: {torch.equal(out, outs['kernel'])}" \
                if variants[name][1] else "drops work: not compared"
            print(f"[variants] {tag}{name}: {what}; output sha256 {sha}")
        device, events = ({name: [] for name in runs} for _ in range(2))
        order = list(runs) + list(reversed(list(runs)))
        for _ in range(ROUNDS):
            for name in order:
                device[name].append(device_us(runs[name]))
                events[name].append(per_launch_us(runs[name]))
        for name in runs:
            d, e = device[name], events[name]
            print(f"[variants] {tag}{name}: device {statistics.median(d):.2f}"
                  f" µs a launch (median of {len(d)}; {min(d):.2f}-"
                  f"{max(d):.2f}); CUDA events {statistics.median(e):.2f} µs "
                  f"({min(e):.2f}-{max(e):.2f}) [{smi}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
