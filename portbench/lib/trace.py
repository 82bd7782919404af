"""The traced window: a ``torch.profiler`` trace of the harness's own calls,
reduced to the device's busy time (the union of its kernel, copy and set
intervals), device time by kernel name, and the idle gaps labelled by the
harness span the host was in.

Spans are ``torch.profiler.record_function`` ranges opened by the harness
around its calls into the program, so they share the trace's clock.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
from typing import Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "portbench.window"


def union_busy(intervals: List[Tuple[float, float]]) -> List[Tuple[float,
                                                                    float]]:
    """The union of (start, end) intervals, as disjoint sorted intervals."""
    merged: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            if end > merged[-1][1]:
                merged[-1] = (merged[-1][0], end)
        else:
            merged.append((start, end))
    return merged


class TraceSummary:
    """What a trace's events say, in seconds: ``window_s`` (the harness's
    window span), ``busy_s`` (device intervals merged, clipped to the
    window), device seconds and launch counts by kernel name, and idle
    seconds by the innermost harness span open on the host when each gap
    began."""

    def __init__(self, events: List[dict]):
        windows = [e for e in events if e.get("name") == WINDOW_SPAN
                   and e.get("ph") == "X"]
        if not windows:
            raise ValueError(f"the trace has no {WINDOW_SPAN} span")
        w = windows[0]
        lo, hi = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        self.window_s = (hi - lo) / 1e6
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e.get("ph") == "X"]
        self.device_events = len(dev)
        self.by_name: Dict[str, float] = collections.Counter()
        self.count: Dict[str, int] = collections.Counter()
        spans = []
        for e in dev:
            self.by_name[e["name"]] += float(e["dur"]) / 1e6
            self.count[e["name"]] += 1
            s = max(float(e["ts"]), lo)
            t = min(float(e["ts"]) + float(e["dur"]), hi)
            if t > s:
                spans.append((s, t))
        busy = union_busy(spans)
        self.busy_s = sum(t - s for s, t in busy) / 1e6
        host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                        e["name"]) for e in events
                       if e.get("cat") == "user_annotation"
                       and e.get("ph") == "X"
                       and e["name"].startswith("portbench.")
                       and e["name"] != WINDOW_SPAN))
        self.idle_by_span: Dict[str, float] = collections.Counter()
        starts = [h[0] for h in host]
        edges = [lo] + [x for s, t in busy for x in (s, t)] + [hi]
        for start, end in zip(edges[0::2], edges[1::2]):
            if end > start:
                label = _label(host, starts, start)
                self.idle_by_span[label] += (end - start) / 1e6

    def kernel_seconds(self, *parts: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds any
        of ``parts``."""
        names = [n for n in self.by_name if any(p in n for p in parts)]
        return (sum(self.by_name[n] for n in names),
                sum(self.count[n] for n in names))

    def breakdown(self, n: int = 10) -> dict:
        return {"device_ops": [[k, v] for k, v in
                               self.by_name.most_common(n)],
                "idle_gaps": [[k, v] for k, v in
                              self.idle_by_span.most_common(n)]}


def _label(host, starts, t: float) -> str:
    """The innermost harness span open at ``t``: the latest started of
    those that contain it (spans nest or follow one another, so a few
    steps back from the last start before ``t`` find it), or ``outside any
    span``."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 16, -1), -1):
        if host[j][1] >= t:
            return host[j][2]
    return "outside any span"


@contextlib.contextmanager
def traced(enabled: bool, out: dict):
    """A profiler (host and CUDA activity) around the block when
    ``enabled``; on exit ``out["summary"]`` holds its
    :class:`TraceSummary`.  The chrome trace goes to a temporary file under
    ``TMPDIR`` and is removed once read."""
    if not enabled:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    try:
        yield
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    out["summary"] = TraceSummary(events)
