"""``singleshotpose_tpu_torch.tracing``: spans recorded only while a torch
profiler records, in memory (name, host start and end) and as
``record_function`` ranges on the profiler's clock; the serve's, the
trainer's and the loader's spans."""

from __future__ import annotations

import json
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import tracing
from singleshotpose_tpu_torch.data.pipeline import Loader, PoseDataset
from singleshotpose_tpu_torch.data.prefetch import prefetch
from singleshotpose_tpu_torch.drivers import (TrainRunConfig, _ProfileWindow,
                                              _to_device)
from singleshotpose_tpu_torch.models.darknet import (Darknet, DarknetSpec,
                                                     fold_batchnorm)

from torch_port_helpers import TINY_BLOCKS

CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.fixture(autouse=True)
def clean():
    tracing.reset()
    yield
    tracing.reset()


def _events(prof, tmp_path, name="trace.json"):
    path = tmp_path / name
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _by_name(recs):
    return {r.name: r for r in recs}


def test_outside_a_profiler_a_span_is_the_shared_no_op():
    assert not autograd_profiler._is_profiler_enabled
    first, second = tracing.span("ssp.a.b"), tracing.span("ssp.c.d")
    assert first is second
    with first:
        with second:
            pass
    assert tracing.records() == [] and tracing.summary() == {}


def test_the_profiler_flag_is_set_while_a_profiler_records():
    """The one check a span makes: the process-wide flag that
    ``torch.profiler.profile`` sets on entry and clears on exit, seen from
    every thread."""
    seen = []
    with torch.profiler.profile(activities=CPU):
        assert autograd_profiler._is_profiler_enabled
        t = threading.Thread(
            target=lambda: seen.append(autograd_profiler._is_profiler_enabled))
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
        assert tracing.span("ssp.a.b") is not tracing.span("ssp.a.b")
    assert seen == [True]
    assert not autograd_profiler._is_profiler_enabled
    assert tracing.span("ssp.a.b") is tracing.span("ssp.c.d")


def test_records_carry_name_and_host_times_in_the_order_they_end():
    with torch.profiler.profile(activities=CPU):
        with tracing.span("ssp.outer.call"):
            with tracing.span("ssp.outer.first"):
                torch.ones(64).sum()
            with tracing.span("ssp.outer.second"):
                torch.ones(64).sum()
        with tracing.span("ssp.alone.call"):
            pass
    recs = tracing.records()
    assert [r.name for r in recs] == ["ssp.outer.first", "ssp.outer.second",
                                      "ssp.outer.call", "ssp.alone.call"]
    by = _by_name(recs)
    outer, first, second, alone = (by["ssp.outer.call"],
                                   by["ssp.outer.first"],
                                   by["ssp.outer.second"],
                                   by["ssp.alone.call"])
    for r in recs:
        assert r.start_ns <= r.end_ns
    assert outer.start_ns <= first.start_ns <= first.end_ns \
        <= second.start_ns <= second.end_ns <= outer.end_ns <= alone.start_ns
    s = tracing.summary()
    assert set(s) == set(by)
    for name, r in by.items():
        assert s[name] == {"count": 1,
                           "seconds": pytest.approx(
                               (r.end_ns - r.start_ns) / 1e9)}
    tracing.reset()
    assert tracing.records() == [] and tracing.summary() == {}


def test_summary_counts_and_sums_repeated_spans():
    with torch.profiler.profile(activities=CPU):
        for _ in range(5):
            with tracing.span("ssp.loop.call"):
                with tracing.span("ssp.loop.inner"):
                    pass
    recs = tracing.records()
    s = tracing.summary()
    assert s["ssp.loop.call"]["count"] == 5 and s["ssp.loop.inner"]["count"] \
        == 5
    assert [r.name for r in recs] == ["ssp.loop.inner", "ssp.loop.call"] * 5
    for name in ("ssp.loop.call", "ssp.loop.inner"):
        total = sum(r.end_ns - r.start_ns for r in recs if r.name == name)
        assert s[name]["seconds"] == pytest.approx(total / 1e9)
    assert s["ssp.loop.inner"]["seconds"] <= s["ssp.loop.call"]["seconds"]


def test_a_span_lies_inside_its_enclosing_range_on_the_profilers_clock(
        tmp_path):
    with torch.profiler.profile(activities=CPU) as prof:
        with torch.profiler.record_function("caller.outer"):
            with tracing.span("ssp.serve.copy_in"):
                with tracing.span("ssp.serve.check"):
                    torch.ones(256).sum()
    events = {e["name"]: e for e in _events(prof, tmp_path)
              if e["name"] in ("caller.outer", "ssp.serve.copy_in",
                               "ssp.serve.check")}
    assert len(events) == 3
    outer, copy_in, check = (events["caller.outer"],
                             events["ssp.serve.copy_in"],
                             events["ssp.serve.check"])
    assert outer["tid"] == copy_in["tid"] == check["tid"]
    end = lambda e: float(e["ts"]) + float(e["dur"])
    assert float(outer["ts"]) <= float(copy_in["ts"]) <= float(check["ts"])
    assert end(check) <= end(copy_in) <= end(outer)


def test_two_threads_record_their_interleaved_spans():
    """Two threads open their spans in lockstep (a barrier between each
    step), so their spans interleave in time; each is recorded once, with
    its own times."""
    barrier = threading.Barrier(2, timeout=30)
    times = {}

    def client(tag):
        barrier.wait()
        with tracing.span(f"ssp.{tag}.call"):
            barrier.wait()
            with tracing.span(f"ssp.{tag}.inner"):
                t0 = time.perf_counter_ns()
                barrier.wait()
                times[tag] = (t0, time.perf_counter_ns())
            barrier.wait()

    with torch.profiler.profile(activities=CPU):
        threads = [threading.Thread(target=client, args=(tag,))
                   for tag in "ab"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    recs = tracing.records()
    by = _by_name(recs)
    assert len(recs) == len(by) == 4
    for tag in "ab":
        call, inner = by[f"ssp.{tag}.call"], by[f"ssp.{tag}.inner"]
        assert call.start_ns <= inner.start_ns <= times[tag][0]
        assert times[tag][1] <= inner.end_ns <= call.end_ns
    a, b = by["ssp.a.inner"], by["ssp.b.inner"]
    assert a.start_ns < b.end_ns and b.start_ns < a.end_ns


def test_many_threads_lose_no_record():
    """More threads than cores, switching as often as the interpreter
    allows: every span of every thread is recorded once."""
    n_threads, n_spans = 16, 50
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def client(k):
            for i in range(n_spans):
                with tracing.span(f"ssp.stress.call{k}"):
                    with tracing.span("ssp.stress.inner"):
                        pass

        with torch.profiler.profile(activities=CPU):
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(tracing.records()) == 2 * n_threads * n_spans
    s = tracing.summary()
    assert s["ssp.stress.inner"]["count"] == n_threads * n_spans
    for k in range(n_threads):
        assert s[f"ssp.stress.call{k}"]["count"] == n_spans


@pytest.fixture(scope="module")
def tiny_serving():
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(4))
    imgs = np.random.RandomState(8).randint(0, 256, (2, 64, 64, 3), np.uint8)
    return spec, fold_batchnorm(model), imgs


def test_aot_serving_on_the_cpu_records_its_call(tiny_serving, tmp_path):
    spec, folded, imgs = tiny_serving
    fn = TS.aot_serving(spec, folded, batch=2, width=64, height=64,
                        compute_dtype=None)
    want = fn(imgs)
    assert tracing.records() == []
    with torch.profiler.profile(activities=CPU) as prof:
        got = fn(imgs)
        fn(imgs)
    assert torch.equal(got, want)
    recs = tracing.records()
    assert [r.name for r in recs] == ["ssp.serve.copy_in"] * 2
    assert tracing.summary()["ssp.serve.copy_in"]["count"] == 2
    names = [e["name"] for e in _events(prof, tmp_path)]
    assert names.count("ssp.serve.copy_in") == 2
    with pytest.raises(ValueError):
        fn(imgs[:1])


def test_to_device_records_its_step(tmp_path):
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    with torch.profiler.profile(activities=CPU):
        got = _to_device(x, torch.device("cpu"))
        _to_device(torch.from_numpy(x), torch.device("cpu"))
    assert torch.equal(got, torch.from_numpy(x))
    assert [r.name for r in tracing.records()] == [
        "ssp.train.to_device"] * 2


@pytest.fixture
def tiny_loader(tmp_path):
    from PIL import Image
    rng = np.random.RandomState(2)
    paths = []
    for i in range(6):
        p = tmp_path / f"{i:06d}.png"
        Image.fromarray(rng.randint(0, 256, (48, 64, 3), np.uint8)).save(p)
        paths.append(str(p))
    lst = tmp_path / "test.txt"
    lst.write_text("\n".join(paths) + "\n")
    return Loader(PoseDataset(str(lst), train=False), 2, shuffle=False,
                  schedule=None, fixed_shape=(40, 32), num_workers=0,
                  drop_last=False, out_uint8=True)


def test_the_loader_records_each_batch(tiny_loader):
    with torch.profiler.profile(activities=CPU):
        batches = list(tiny_loader)
    assert len(batches) == 3
    assert [r.name for r in tracing.records()] == ["ssp.loader.batch"] * 3
    assert tiny_loader.seen == 6


def test_the_loaders_spans_on_the_prefetch_thread_have_their_own_lane(
        tiny_loader, tmp_path):
    """The trainers' profiler window profiles every thread: the batches the
    prefetch thread makes are ``ssp.loader.batch`` ranges in the written
    trace, on that thread, beside the main thread's spans."""
    window = _ProfileWindow(TrainRunConfig(profile_dir=str(tmp_path),
                                           profile_steps=(0, 3)),
                            torch.device("cpu"))
    window.before(0)
    for images, _ in prefetch(tiny_loader):
        _to_device(images, torch.device("cpu"))
    window.after(3)
    assert sorted(r.name for r in tracing.records()) == [
        "ssp.loader.batch"] * 3 + ["ssp.train.to_device"] * 3
    with open(tmp_path / "train_steps_0_3.json") as f:
        events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    lanes = {name: {e["tid"] for e in events if e["name"] == name}
             for name in ("ssp.loader.batch", "ssp.train.to_device")}
    assert sum(e["name"] == "ssp.loader.batch" for e in events) == 3
    assert sum(e["name"] == "ssp.train.to_device" for e in events) == 3
    assert lanes["ssp.loader.batch"].isdisjoint(lanes["ssp.train.to_device"])
