"""The harness finds every cell's files by name, and the import rule holds:
no module of the benchmark imports ``jax``, ``jaxlib``, ``flax`` or
``singleshotpose_tpu`` (whole top-level names: the port,
``singleshotpose_tpu_torch``, is allowed), and the reference imports
nothing of the program."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench.lib import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PKG)


def _bench():
    return harness.load_benchmark(ROOT)


def test_every_cell_finds_its_files():
    bench = _bench()
    for w in bench["workloads"]:
        cell = harness.Cell(bench, w["name"], ROOT)
        assert cell.config["cfg"][0]["type"] == "net"
        runner = cell.runner()
        assert callable(runner.run)
        reported = {m["name"] for m in cell.end_to_end()}
        assert "setup_s" in reported and len(reported) >= 2
        layers = cell.per_layer()
        assert layers, w["name"]
        for m in layers:
            assert callable(cell.reader(m["name"]).read)
            assert m["moves"] in reported


def test_every_config_and_metric_has_its_file():
    bench = _bench()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("portbench/")
    for m in bench["per_layer"]:
        assert os.path.isfile(os.path.join(PKG, "metrics", f"{m['name']}.py"))


def test_readers_find_nothing_to_read_in_another_cell():
    bench = _bench()
    for m in bench["per_layer"]:
        read = harness.Cell(bench, bench["workloads"][0]["name"],
                            ROOT).reader(m["name"]).read
        assert read({"kind": "elsewhere"}) is None


def test_the_benchmark_imports_nothing_forbidden():
    assert harness.import_violations() == []


@pytest.mark.parametrize("where, line, bad", [
    ("lib", "import jax", True),
    ("lib", "import jax.numpy as jnp", True),
    ("lib", "from jaxlib import xla_client", True),
    ("lib", "import flax", True),
    ("lib", "import singleshotpose_tpu", True),
    ("lib", "from singleshotpose_tpu.ops import stem", True),
    ("lib", "import singleshotpose_tpu_torch", False),
    ("lib", "from singleshotpose_tpu_torch import serving", False),
    ("reference", "import singleshotpose_tpu_torch", True),
    ("reference", "from singleshotpose_tpu_torch.ops import stem", True),
    ("reference", "from ..lib import seeded", True),
    ("reference", "from portbench.lib import seeded", True),
    ("reference", "from . import darknet", False),
    ("reference", "from portbench.reference import darknet", False),
])
def test_import_rule_compares_whole_names(tmp_path, where, line, bad):
    os.makedirs(tmp_path / where)
    (tmp_path / where / "m.py").write_text(line + "\n")
    assert bool(harness.import_violations(str(tmp_path))) == bad


def test_run_refuses_without_its_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and portbench/ prints no
    result and exits nonzero (no card here; with one, the program's import
    fails)."""
    import shutil
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    name = _bench()["workloads"][0]["name"]
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", "1", "--seconds", "1", "--trace",
                        "0"], cwd=tmp_path, capture_output=True, text=True,
                       env=env, timeout=300)
    assert p.returncode != 0
    assert not p.stdout.strip().startswith("{")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(card):
    name = _bench()["workloads"][0]["name"]
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        name, "--seed", "2147483901", "--seconds", "2",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "checks"
