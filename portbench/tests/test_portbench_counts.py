"""The benchmark's own arithmetic: conv FLOPs from the configurations'
layer lists, the kernels' bytes from shapes, and the window reductions
(a rate over the whole window, a 95th percentile over every batch, the
device's busy time as the union of its intervals)."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from portbench.lib import roofline as R
from portbench.lib.trace import TraceSummary, union_busy

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _blocks(name):
    with open(os.path.join(PKG, "configs", f"{name}.json")) as f:
        return json.load(f)["cfg"]


@pytest.mark.parametrize("name, size, flops", [
    ("yolo_pose_single", 672, 76_520_005_632),
    ("yolo_pose_single", 416, 29_323_993_088),
    ("yolo_pose_multi", 416, 29_372_448_768),
])
def test_conv_flops_per_frame(name, size, flops):
    assert R.conv_flops_per_frame(_blocks(name), size, size) == flops


@pytest.mark.parametrize("name, weights", [("yolo_pose_single", 50_527_072),
                                           ("yolo_pose_multi", 50_670_432)])
def test_conv_weights(name, weights):
    assert R.conv_weights(_blocks(name)) == weights


def test_k1_bytes_from_shapes():
    B, H, W = 8, 672, 672
    nbytes = 4 * B * H * W * 3 + 4 * (864 + 32) + 2 * B * 336 * 336 * 32
    assert R.k1_bound_s(B, H, W) == pytest.approx(nbytes / 3.35e12,
                                                  rel=1e-12)
    # bound by bytes: the conv's 2·27·32 operations a pixel are cheap
    assert nbytes / 3.35e12 > 2 * 27 * 32 * B * H * W / 989e12


def test_union_of_device_intervals():
    assert union_busy([(5, 7), (0, 2), (1, 3), (6, 6.5), (8, 9)]) == \
        [(0, 3), (5, 7), (8, 9)]


def _x(name, ts, dur, cat):
    return {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat}


def test_trace_summary_busy_idle_and_labels():
    events = [
        _x("portbench.window", 100.0, 1000.0, "user_annotation"),
        _x("portbench.serve_call", 100.0, 300.0, "user_annotation"),
        _x("portbench.read_boxes", 400.0, 500.0, "user_annotation"),
        _x("k_a", 50.0, 150.0, "kernel"),        # clipped to start at 100
        _x("k_b", 150.0, 50.0, "kernel"),        # inside k_a
        _x("Memcpy HtoD", 300.0, 100.0, "gpu_memcpy"),
        _x("k_a", 600.0, 100.0, "kernel"),
        _x("cpu_op", 0.0, 5000.0, "cpu_op"),
    ]
    s = TraceSummary(events)
    assert s.window_s == pytest.approx(1000e-6)
    # busy: [100, 200] ∪ [300, 400] ∪ [600, 700]
    assert s.busy_s == pytest.approx(300e-6)
    assert s.kernel_seconds("k_a") == (pytest.approx(250e-6), 2)
    # idle: [200, 300] began in serve_call; [400, 600] and [700, 1100]
    # began in read_boxes (a gap is labelled where it began)
    assert s.idle_by_span["portbench.serve_call"] == pytest.approx(100e-6)
    assert s.idle_by_span["portbench.read_boxes"] == pytest.approx(600e-6)
    assert s.breakdown()["device_ops"][0][0] == "k_a"


def test_window_statistics_cover_every_batch():
    """The serve runner's end-to-end numbers: frames over the window's
    seconds, and the 95th percentile of all the window's latencies — not a
    median of chunks."""
    lat = np.arange(1, 101, dtype=float)
    assert np.percentile(lat, 95) == pytest.approx(95.05)
    assert 100 * 8 / 2.0 == 400.0
