"""The readers of the program's own spans (``copy_in_host_ms.serve``): each
reads the mean host ms of its span from the program's records, and nothing
where the run was not traced, where the program has no ``tracing`` module (a
program before it), or where no span of its name was recorded.  A traced
run's records are exactly its window's."""

from __future__ import annotations

import os
import sys

import pytest
import torch

import singleshotpose_tpu_torch
from portbench.lib import harness
from portbench.lib.trace import TraceSummary, WINDOW_SPAN
from portbench.tests import tiny
from singleshotpose_tpu_torch import tracing

READERS = {"copy_in_host_ms.serve": "ssp.serve.copy_in"}
SPANS = ("ssp.serve.copy_in", "ssp.train.copy_in", "ssp.loader.batch")
CPU = [torch.profiler.ProfilerActivity.CPU]
ROOT = os.path.dirname(tiny.PKG)


def _reader(metric: str):
    return harness.Cell(harness.load_benchmark(ROOT), "single-serve-b1-672",
                        ROOT).reader(metric).read


def _traced_reading() -> dict:
    window = {"name": WINDOW_SPAN, "ph": "X", "ts": 0.0, "dur": 1e6}
    return {"kind": "serve", "trace": TraceSummary([window]),
            "frames_traced": 8, "batch": 8}


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _record_serve_calls(n: int) -> None:
    with torch.profiler.profile(activities=CPU):
        for _ in range(n):
            for name in SPANS:
                with tracing.span(name):
                    torch.ones(1000).sum()


@pytest.mark.parametrize("metric", sorted(READERS))
def test_reads_the_mean_host_ms_of_its_span(metric):
    _record_serve_calls(4)
    recs = [r for r in tracing.records() if r.name == READERS[metric]]
    assert len(recs) == 4
    want = sum(r.end_ns - r.start_ns for r in recs) / 4 / 1e6
    assert _reader(metric)(_traced_reading()) == pytest.approx(want)


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_in_an_untraced_run(metric):
    _record_serve_calls(2)
    reading = dict(_traced_reading(), trace=None)
    assert _reader(metric)(reading) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_from_a_program_without_spans(metric, monkeypatch):
    """A program with no ``tracing`` module: the import fails, the reader
    gives nothing and does not raise."""
    _record_serve_calls(2)
    monkeypatch.delattr(singleshotpose_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "singleshotpose_tpu_torch.tracing",
                        None)
    assert _reader(metric)(_traced_reading()) is None


@pytest.mark.parametrize("metric", sorted(READERS))
def test_nothing_to_read_without_a_record_of_its_span(metric):
    with torch.profiler.profile(activities=CPU):
        for name in SPANS:
            if name != READERS[metric]:
                with tracing.span(name):
                    pass
    assert _reader(metric)(_traced_reading()) is None
    tracing.reset()
    assert _reader(metric)(_traced_reading()) is None


def test_a_traced_run_records_exactly_its_window():
    """The serve runner at a tiny size on the CPU, traced: one
    ``ssp.serve.copy_in`` a call of the window, none of the warm-up's."""
    torch.set_num_threads(2)
    c = tiny.cell("serve")
    ctx = tiny.Context(c, seconds=0.5)
    ctx.trace = True
    out = c.runner().run(ctx)
    assert out["reading"]["trace"] is not None
    assert harness.correct(out), out["checks"]
    assert tracing.summary()["ssp.serve.copy_in"]["count"] \
        == out["attempted"]
    assert {r.name for r in tracing.records()} == {"ssp.serve.copy_in"}
