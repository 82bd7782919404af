"""The closed-loop serve cell of ``runners/serve.py`` for a net with several
heads (YOLOv3's Darknet-53 and FPN as a pose net): the same client loop,
window, metrics and judgement, over this net's own plain reference
(``reference/darknet_heads.py``), weights (``lib/darknet_heads.py``: the
seeded draws, their BN statistics measured on the pool's first batch) and
operation count.  The net runs no hand-written kernel (its first conv is
followed by a strided conv, not the serving stem's pool), so nothing is
built.

A traced run also reads, after the window, the device ms a batch of the
work launched under the program's spans ``ssp.net.trunk`` and
``ssp.net.neck`` (``trunk_ms``, ``neck_ms``): eager calls of
``serving.make_serving_fn`` on one pool batch in a profiler session of
their own, since a graph replay records no span.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch
from torch.profiler import record_function as span

from ..lib import darknet_heads as heads_lib
from ..lib import seeded
from ..lib.trace import WINDOW_SPAN, traced
from ..reference import darknet_heads as ref
from ..reference.judge import judge_serve
from .serve import _Loop, _pick, _pick_ms, _report_window

NET_SPANS = ("ssp.net.trunk", "ssp.net.neck")


def run(ctx) -> Dict:
    from singleshotpose_tpu_torch import serving
    from singleshotpose_tpu_torch.models.darknet import (Darknet,
                                                         DarknetSpec,
                                                         fold_batchnorm)

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    B, size, pick = int(tr["batch"]), int(tr["size"]), _pick(tr)
    seeds = seeded.sub_seeds(ctx.seed)
    spec = DarknetSpec(cfg["cfg"])
    # blocks of the finest head's stride, so that every cell of every head
    # sees content of its own
    pool = seeded.frame_pool(seeds["frames"], int(tr["pool_batches"]), B,
                             size, size, cell=int(tr["frame_cell"]))
    raw = heads_lib.raw_weights(cfg["cfg"], seeds["weights"], dev)
    heads_lib.calibrate_bn(cfg["cfg"], raw,
                           torch.from_numpy(pool[0]).to(dev))
    if dev.type == "cuda":
        # the calibration pass is the benchmark's weight making: the peak
        # counts from here, what the serve holds
        torch.cuda.reset_peak_memory_stats(dev)
    model = Darknet(spec, device=dev)
    model.load_state_dict(raw)
    folded = fold_batchnorm(model)
    del model
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
               "flops_per_frame": heads_lib.conv_flops_per_frame(
                   cfg["cfg"], size, size)}
    if ctx.trace:
        reading["pick_ms"] = _pick_ms(serving, spec, folded, pool[0], pick,
                                      dev)
        reading.update(_net_span_ms(serving, spec, folded, pool[0], pick,
                                    dev))
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
    grid of its frames (all heads, in cfg order), in float32."""
    layers = ref.parse(cfg["cfg"])
    folded = ref.fold(layers, raw)
    K = int(cfg["cfg"][0]["num_keypoints"])
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
            grid = ref.grid(layers, folded, frames, K)
            for boxes in distinct:
                got = judge_serve(boxes, *grid, pick, size)
                for name in worst:
                    worst[name] = max(worst[name], got[name])
                for name in sums:
                    sums[name] += got["sums"][name]
                picks += got["picks"]
            del grid
    readings = dict(worst, **{name: v / max(picks, 1)
                              for name, v in sums.items()})
    print("readings: " + ", ".join(f"{name} {v!r}"
                                   for name, v in readings.items())
          + f" over {picks} picks", file=sys.stderr)
    limits = ctx.traffic["limits"]
    return {name: {"value": readings[name], "limit": float(limits[name])}
            for name in readings if name in limits}


def _net_span_ms(serving, spec, folded, frames, pick, dev,
                 calls: int = 5) -> Dict[str, float]:
    """Device ms a batch of the work launched under each of the program's
    ``NET_SPANS``: ``calls`` eager serving calls on ``frames`` after 3, in
    a profiler session of their own.  A span the program did not record is
    left out."""
    if dev.type != "cuda":
        return {}
    fn = serving.make_serving_fn(spec, folded, pick=pick)
    for _ in range(3):
        fn(frames)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    with prof:
        for _ in range(calls):
            fn(frames)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    by_span = heads_lib.span_device_s(events)
    out = {}
    for name in NET_SPANS:
        seconds, count = by_span.get(name, (0.0, 0))
        if count:
            out[name.rsplit(".", 1)[-1] + "_ms"] = 1e3 * seconds / count
    return out
