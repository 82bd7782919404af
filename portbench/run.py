#!/usr/bin/env python3
"""Run one cell of the benchmark of ``singleshotpose_tpu_torch``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its configuration is ``portbench/configs/<config>.json``, its
traffic ``portbench/traffic/<traffic>.json``, whose ``kind`` names the runner
``portbench/runners/<kind>.py``; each per-layer metric is read by
``portbench/metrics/<name>.py``.  The run loads, warms up, measures for
``--seconds`` (``--trace 1``: under a profiler, for at most the traffic's
``trace_seconds``), judges what the window produced against the plain
reference, and prints one JSON line last on standard output.  It needs a
CUDA card; without one, or with fewer than the cell asks for, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every compile cache inside the checkout, at a fixed path, before any
# import that reads it
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                             "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "portbench",
                                                 ".cache", "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = os.path.join(ROOT, "portbench",
                                                    ".cache", "inductor")
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench.lib import harness  # noqa: E402


def main(argv=None) -> int:
    t_process = harness.process_start()
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bad = harness.import_violations()
    if bad:
        print("portbench: forbidden imports:\n  " + "\n  ".join(bad),
              file=sys.stderr)
        return 2
    bench = harness.load_benchmark(ROOT)
    cell = harness.Cell(bench, args.workload, ROOT)
    import torch
    need = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell {args.workload} needs {need} CUDA "
              f"card(s); torch sees {seen}", file=sys.stderr)
        return 3
    ctx = harness.Context(cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=torch.device("cuda"),
                          t_process=t_process)
    out = cell.runner().run(ctx)
    loaded = harness.banned_modules()
    if loaded:
        print("portbench: loaded after the window: " + ", ".join(loaded),
              file=sys.stderr)
        return 4
    line = harness.result_line(cell, ctx, out)
    harness.print_checks(out["checks"])
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
