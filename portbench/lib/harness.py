"""The harness around a runner: finding a cell's files by name, the import
rule, the run's context (clock, memory, the program hook), and the result
line.
"""

from __future__ import annotations

import ast
import importlib
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# whole top-level names no module of the benchmark may import, and none may
# be loaded in a run's process once the window has closed
BANNED = frozenset({"jax", "jaxlib", "flax", "singleshotpose_tpu"})
PROGRAM = "singleshotpose_tpu_torch"


def process_start() -> float:
    """The ``time.time()`` at which this process started (from
    ``/proc/self/stat``'s start tick and the boot time), or now where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.time()


def _imports(path: str):
    """(top-level name, level, module) of each import in a source file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0, a.name
        elif isinstance(node, ast.ImportFrom):
            mod = node.module or ""
            yield mod.split(".")[0], node.level, mod


def import_violations(root: str = PKG) -> List[str]:
    """Every import under ``root`` of a banned top-level name, compared
    whole; and every import by a module of ``reference/`` of the program or
    of a benchmark module outside ``reference/``."""
    bad = []
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = [d for d in dirs if not d.startswith(".")
                   and d != "__pycache__"]
        in_ref = os.path.relpath(dirpath, root).split(os.sep)[0] \
            == "reference"
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            for top, level, mod in _imports(path):
                rel = os.path.relpath(path, root)
                if level == 0 and top in BANNED:
                    bad.append(f"{rel}: imports {mod}")
                elif in_ref and ((level == 0 and top in (PROGRAM,
                                                         "portbench")
                                  and not mod.startswith(
                                      "portbench.reference"))
                                 or level > 1):
                    bad.append(f"{rel}: the reference imports "
                               f"{'.' * level}{mod}")
    return bad


def banned_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in BANNED)


def load_benchmark(root: str) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of ``BENCHMARK.json`` with the files its names lead to."""

    def __init__(self, bench: dict, name: str, root: str):
        by_name = {w["name"]: w for w in bench["workloads"]}
        if name not in by_name:
            raise SystemExit(f"portbench: no workload {name!r} in "
                             f"BENCHMARK.json ({sorted(by_name)})")
        self.bench, self.name, self.root = bench, name, root
        self.entry = by_name[name]
        configs = {c["name"]: c for c in bench["configs"]}
        with open(os.path.join(root, configs[self.entry["config"]]["file"])) \
                as f:
            self.config = json.load(f)
        with open(os.path.join(PKG, "traffic",
                               f"{self.entry['traffic']}.json")) as f:
            self.traffic = json.load(f)

    def runner(self):
        return importlib.import_module(
            f"portbench.runners.{self.traffic['kind']}")

    def end_to_end(self) -> List[dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[dict]:
        """The per-layer metrics the cell reports: those that list it, and
        those that list no cell and move an end-to-end metric it reports."""
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    def reader(self, metric: str):
        return _load_file(os.path.join(PKG, "metrics", f"{metric}.py"),
                          f"portbench_metric_{metric.replace('.', '_')}")


class Context:
    """What a runner is given: the cell's files, the seed, the window, the
    device, the clock since the process started, and ``program(name,
    build, **parts)``, the hook through which every object of the program
    that the window drives is made (``build()`` here; the control and the
    fault tests put something else in its place)."""

    def __init__(self, cell: Cell, *, seed: int, seconds: float, trace: bool,
                 device, t_process: float):
        self.cell, self.seed, self.seconds = cell, seed, seconds
        self.trace, self.device = trace, device
        self.config, self.traffic = cell.config, cell.traffic
        self.t_process = t_process

    def setup_s(self) -> float:
        return time.time() - self.t_process

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def program(self, name: str, build, **parts):
        """The program's object ``name``, ``build()``; ``parts`` are what a
        stand-in needs to make its own."""
        return build()


def correct(out: dict) -> bool:
    return out["attempted"] > 0 and out["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in out["checks"].values())


def result_line(cell: Cell, ctx: Context, out: dict) -> dict:
    """The contract's last line: with ``--trace 0`` the cell's end-to-end
    metrics, with ``--trace 1`` its per-layer metrics (those whose reader
    finds something), the device, and the numbers compared last."""
    import torch
    if ctx.trace:
        metrics = {}
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(out["reading"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]],
                               "unit": m["unit"]} for m in cell.end_to_end()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(),
              "count": int(cell.entry["chips"]),
              "memory_peak_bytes": out["memory_peak_bytes"]}
    line = {"correct": correct(out), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": device}
    summary = out["reading"].get("trace")
    if ctx.trace and summary is not None:
        device["busy_s"] = summary.busy_s
        device["window_s"] = summary.window_s
        line["breakdown"] = summary.breakdown()
    line["checks"] = out["checks"]
    return line


def print_checks(checks: Dict[str, dict], stream=None) -> None:
    stream = stream or sys.stderr
    for name, c in checks.items():
        verdict = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r}) "
              f"{verdict}", file=stream, flush=True)
