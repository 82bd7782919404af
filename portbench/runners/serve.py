"""A closed-loop serve cell: the program's graph serve
(``serving.aot_serving``) for the cell's one shape, fed batches of u8 frames
from pageable host memory with two batches in flight: launch batch n+1, then
read batch n's boxes to the host.

End to end: ``serve_fps`` (frames whose boxes reached the host, over the
window's seconds) and ``serve_p95_ms`` (the 95th percentile, over every
batch of the window, of the time from the serving call's start to its boxes
on the host).  Every answer of the window is then judged against the plain
reference (``reference/judge.py``).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function as span

from ..lib import roofline, seeded
from ..lib.trace import WINDOW_SPAN, traced
from ..reference import darknet as ref
from ..reference.judge import judge_serve


def _pick(traffic: dict):
    pick = tuple(traffic["pick"])
    return (pick[0], float(pick[1])) if len(pick) > 1 else pick


class _Loop:
    """The client: ``step(i)`` launches request ``i`` and then collects
    the one before it; ``collect()`` collects the last.  The boxes come
    back through two pinned buffers taken in turn (a batch's buffer is
    read before the batch after next writes it) and are kept as copies."""

    def __init__(self, serve, pool: np.ndarray, order: np.ndarray, device):
        self.serve, self.pool, self.order = serve, pool, order
        self.cuda = device.type == "cuda"
        self.pending = None
        self.buffers, self.turn = [], 0
        self.latencies, self.answers, self.calls = [], [], []
        self.copies, self.waits = [], []

    def _buffer(self, out: torch.Tensor) -> torch.Tensor:
        i = self.turn % 2
        self.turn += 1
        if len(self.buffers) <= i:
            self.buffers.append(torch.empty(out.shape, dtype=out.dtype,
                                            pin_memory=self.cuda))
        return self.buffers[i]

    def step(self, i: int) -> None:
        k = int(self.order[i % len(self.order)])
        t = time.perf_counter()
        with span("portbench.serve_call"):
            out = self.serve(self.pool[k])
        self.calls.append(time.perf_counter() - t)
        c = time.perf_counter()
        with span("portbench.copy_out"):
            host = self._buffer(out)
            host.copy_(out, non_blocking=self.cuda)
            event = None
            if self.cuda:
                event = torch.cuda.Event()
                event.record()
        self.copies.append(time.perf_counter() - c)
        self.collect()
        self.pending = (k, t, host, event)

    def collect(self) -> None:
        if self.pending is None:
            return
        k, t, host, event = self.pending
        with span("portbench.read_boxes"):
            w = time.perf_counter()
            if event is not None:
                event.synchronize()
            done = time.perf_counter()
        self.waits.append(done - w)
        self.latencies.append(done - t)
        self.answers.append((k, host.numpy().copy()))
        self.pending = None
        self.last_done = done


def run(ctx) -> Dict:
    from singleshotpose_tpu_torch import serving
    from singleshotpose_tpu_torch.models.darknet import (Darknet,
                                                         DarknetSpec,
                                                         fold_batchnorm)
    from singleshotpose_tpu_torch.ops import cuda_build

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, size, pick = int(tr["batch"]), int(tr["size"]), _pick(tr)
    seeds = seeded.sub_seeds(ctx.seed)
    if dev.type == "cuda":
        t = time.perf_counter()
        cuda_build.build_libraries(tr["kernels"])
        print(f"set-up: the nvcc libraries {time.perf_counter() - t:.4f} s "
              "(built only on a checkout's first run)", file=sys.stderr)
    spec = DarknetSpec(cfg["cfg"])
    raw = seeded.raw_weights(cfg["cfg"], seeds["weights"], dev)
    model = Darknet(spec, device=dev)
    model.load_state_dict(raw)
    folded = fold_batchnorm(model)
    del model
    pool = seeded.frame_pool(seeds["frames"], int(tr["pool_batches"]), B,
                             size, size)
    serve = ctx.program("serve", lambda: serving.aot_serving(
        spec, folded, batch=B, width=size, height=size, pick=pick),
        spec=spec, folded=folded, raw=raw, pick=pick, frames=pool[0])
    order = np.random.default_rng(seeds["order"]).permutation(
        np.resize(np.arange(len(pool)), int(tr["order_length"])))
    loop = _Loop(serve, pool, order, dev)
    for i in range(int(tr["warmup_calls"])):
        loop.step(i)
    loop.collect()
    for kept in (loop.latencies, loop.answers, loop.calls, loop.copies,
                 loop.waits):
        kept.clear()
    # the set-up's objects move out of the collector's reach, so that a
    # full collection in the window scans only what the window made
    gc.collect()
    gc.freeze()

    seconds = ctx.seconds if not ctx.trace else min(
        ctx.seconds, float(tr["trace_seconds"]))
    trace_out: dict = {}
    setup_s = ctx.setup_s()
    with traced(ctx.trace, trace_out):
        with span(WINDOW_SPAN):
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < seconds:
                loop.step(i)
                i += 1
            loop.collect()
    gc.unfreeze()
    window_s = loop.last_done - t0
    attempted = i
    _report_window(loop, window_s)
    answered = len(loop.answers)
    memory_peak = ctx.memory_peak()

    reading = {"kind": "serve", "trace": trace_out.get("summary"),
               "frames_traced": answered * B, "batch": B, "size": size,
               "flops_per_frame": roofline.conv_flops_per_frame(
                   cfg["cfg"], size, size)}
    if ctx.trace:
        reading["pick_ms"] = _pick_ms(serving, spec, folded, pool[0], pick,
                                      dev)
    del serve, folded, loop.serve
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    checks = judge(ctx, cfg, raw, pool, loop.answers, pick, size, dev)
    metrics = {"serve_fps": answered * B / window_s,
               "serve_p95_ms": float(np.percentile(
                   np.asarray(loop.latencies) * 1e3, 95)),
               "setup_s": setup_s}
    return {"attempted": attempted, "failed": attempted - answered,
            "metrics": metrics, "memory_peak_bytes": memory_peak,
            "checks": checks, "reading": reading,
            "window_s": window_s}


def judge(ctx, cfg, raw, pool, answers, pick, size, dev) -> Dict:
    """Every distinct answer of the window against the reference's decoded
    grid of its frames, in the configuration's float32."""
    layers = ref.parse(cfg["cfg"])
    reg = ref.region(layers)
    folded = ref.fold(layers, raw)
    worst = {"pick_gap": 0.0, "box_err_px": 0.0, "conf_err": 0.0}
    sums = {"box_err_mean_px": 0.0, "pick_gap_mean": 0.0}
    picks = 0
    by_batch: Dict[int, list] = {}
    for k, boxes in answers:
        seen = by_batch.setdefault(k, [])
        if not any(np.array_equal(boxes, s) for s in seen):
            seen.append(boxes)
    with torch.no_grad():
        for k, distinct in sorted(by_batch.items()):
            frames = torch.from_numpy(pool[k]).to(dev)
            head = ref.forward_folded(layers, folded, frames)
            grid = ref.decode(head, reg["keypoints"], reg["classes"],
                              reg["num"])
            for boxes in distinct:
                got = judge_serve(boxes, *grid, pick, size)
                for name in worst:
                    worst[name] = max(worst[name], got[name])
                for name in sums:
                    sums[name] += got["sums"][name]
                picks += got["picks"]
    readings = dict(worst, **{name: v / max(picks, 1)
                              for name, v in sums.items()})
    print("readings: " + ", ".join(f"{name} {v!r}"
                                   for name, v in readings.items())
          + f" over {picks} picks", file=sys.stderr)
    limits = ctx.traffic["limits"]
    return {name: {"value": readings[name], "limit": float(limits[name])}
            for name in readings if name in limits}


def _top(parts: np.ndarray, rows: np.ndarray, n: int = 3) -> list:
    return sorted(parts[rows].max(1).round(3).tolist())[-n:]


def _report_window(loop: _Loop, window_s: float) -> None:
    """The window's batches on standard error: latency quantiles, the
    stalls (batches over twice the median latency) and where their time
    went (the serving calls, which hold the copy-in, the copies out, or the
    wait for the boxes)."""
    lat = np.asarray(loop.latencies) * 1e3
    calls = np.asarray(loop.calls) * 1e3
    # a batch's latency spans its own step and the next one's
    two = lambda v: np.stack([v, np.append(v[1:], 0.0)], 1)
    calls, copies = two(calls), two(np.asarray(loop.copies) * 1e3)
    waits = np.asarray(loop.waits) * 1e3
    med = float(np.median(lat))
    stall = lat > 2 * med
    q = np.percentile(lat, [50, 95, 99])
    print(f"window: {len(lat)} batches in {window_s:.4f} s; latency ms "
          f"min {lat.min():.4f} p50 {q[0]:.4f} p95 {q[1]:.4f} p99 "
          f"{q[2]:.4f} max {lat.max():.4f}; serve call ms p50 "
          f"{np.median(calls[:, 0]):.4f} max {calls.max():.4f}; copy-out ms max "
          f"{copies.max():.4f}; wait ms p50 "
          f"{np.median(waits):.4f} max {waits.max():.4f}; stalls "
          f"{int(stall.sum())} ({float((lat[stall] - med).sum()):.4f} ms "
          f"over the median; their longest serve calls ms "
          f"{_top(calls, stall)}, copy-outs ms {_top(copies, stall)}, waits "
          f"ms {_top(waits[:, None], stall)})", file=sys.stderr)


def _pick_ms(serving, spec, folded, frames, pick, dev) -> float:
    """Device ms of the cell's pick on one batch's decoded head: CUDA
    events around 20 calls after 3, the mean."""
    from singleshotpose_tpu_torch.ops import decode
    if dev.type != "cuda":
        return None
    grid_fn = serving.make_serving_fn(spec, folded, pick=("grid",))
    decoded = grid_fn(frames)
    if pick[0] == "best":
        fn = lambda: decode.best_boxes(decoded)
    else:
        fn = lambda: decode.best_boxes_per_class(decoded, pick[1])
    with torch.inference_mode():
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        with span("portbench.pick"):
            start.record()
            for _ in range(20):
                fn()
            end.record()
        end.synchronize()
    return start.elapsed_time(end) / 20
