"""The multi-head serve runner (``runners/serve_heads.py``) end to end on
the CPU at a tiny size: the program's serve of a YOLOv3-shaped net agrees
with ``reference/darknet_heads.py`` (``correct``), and a run whose timed
path is broken underneath comes out not correct: the heads decoded in the
wrong order (each normalised by the grid of the head in its place in
reverse order), and the upsample's output shifted by one cell.  The fp8
control comes out not correct too; the weights, FLOP count and span
reduction of ``lib/darknet_heads.py`` are held to ``lib/seeded.py``,
``lib/roofline.py`` and a hand-made trace."""

from __future__ import annotations

import os
from unittest import mock

import pytest
import torch

from portbench.lib import darknet_heads as LH
from portbench.lib import harness, roofline, seeded
from portbench.reference import controls_heads
from portbench.tests import tiny

ANCHORS = "10,13,  16,30,  33,23,  30,61,  62,45,  59,119"


def _conv(f, k, stride=1, bn=True, act="leaky"):
    return {"type": "convolutional", "batch_normalize": str(int(bn)),
            "filters": str(f), "size": str(k), "stride": str(stride),
            "pad": "1", "activation": act}


def _short():
    return {"type": "shortcut", "from": "-3", "activation": "linear"}


def _yolo(mask):
    return {"type": "yolo", "mask": mask, "anchors": ANCHORS,
            "classes": "1", "num": "6"}


def blocks():
    """YOLOv3's kinds of layer at a few channels: strided convs, three
    residual stages, a head at 1/8, a route back, an upsample, a
    concatenation with the trunk and a head at 1/4.  The upsampled branch
    is two thirds of the concatenation (YOLOv3's is one third): only picked
    cells are judged, and at this size a third mixed with the trunk's
    output moves the fine head's picks less than the cell's limits, which
    the full net's own bf16 rounding sets (PERF.md §7)."""
    net = {"type": "net", "width": "96", "height": "96", "channels": "3",
           "num_keypoints": "9"}
    return [net, _conv(8, 3), _conv(16, 3, 2), _conv(8, 1), _conv(16, 3),
            _short(), _conv(32, 3, 2), _conv(16, 1), _conv(32, 3), _short(),
            _conv(16, 1), _conv(32, 3), _short(), _conv(32, 3, 2),
            _conv(16, 1), _conv(32, 3), _short(), _conv(16, 1),
            _conv(32, 3), _conv(60, 1, bn=False, act="linear"),
            _yolo("3,4,5"), {"type": "route", "layers": "-4"},
            _conv(64, 1), {"type": "upsample", "stride": "2"},
            {"type": "route", "layers": "-1, 11"}, _conv(16, 1),
            _conv(32, 3), _conv(60, 1, bn=False, act="linear"),
            _yolo("0,1,2")]


def cell() -> harness.Cell:
    c = harness.Cell.__new__(harness.Cell)
    c.bench = {"end_to_end": [], "per_layer": []}
    c.name, c.root, c.entry = "tiny-serve-heads", os.path.dirname(tiny.PKG), \
        {"chips": 1}
    c.config = {"cfg": blocks()}
    c.traffic = dict(tiny._json("traffic", "serve-b8-608-best-heads.json"),
                     batch=2, size=96, pool_batches=3, warmup_calls=2)
    return c


def run(breaks=None, program=None) -> dict:
    torch.set_num_threads(2)
    c = cell()
    ctx = tiny.Context(c, breaks)
    if program is not None:
        ctx.program = lambda name, build, **parts: program(ctx, name, build,
                                                           parts)
    return c.runner().run(ctx)


def _heads_in_reverse_grids(serve, parts):
    """Each head's keypoints normalised by the grid of the head in its
    place when the heads are taken in reverse order."""
    from singleshotpose_tpu_torch.models.darknet import apply_folded
    from singleshotpose_tpu_torch.ops import decode
    spec, folded = parts["spec"], parts["folded"]

    def f(images):
        x = torch.as_tensor(images).to(folded["conv_1"]["w"].device) \
            .float() * (1.0 / 255.0)
        heads = apply_folded(spec, folded, x, compute_dtype=torch.bfloat16)
        grids = []
        for h, other in zip(heads, heads[::-1]):
            g = decode.decode_grid(h.float(), spec.num_keypoints,
                                   spec.num_classes, spec.num_anchors)
            scale = torch.tensor([h.shape[2] / other.shape[2],
                                  h.shape[1] / other.shape[1]])
            corners = (g.corners.reshape(*g.det_conf.shape, -1, 2)
                       * scale).reshape(g.corners.shape)
            grids.append(decode.DecodedGrid(corners, g.det_conf,
                                            g.cls_probs))
        return decode.best_boxes(decode.DecodedGrid(
            *(torch.cat(p, dim=1) for p in zip(*grids))))
    return f


def _upsample_shifted(serve, parts):
    """The upsample's output rolled one cell to the right."""
    from singleshotpose_tpu_torch.models import layers as L
    plain = L.upsample_nearest

    def shifted(x, stride=2):
        return torch.roll(plain(x, stride), 1, dims=3)

    def f(images):
        with mock.patch.object(L, "upsample_nearest", shifted):
            return serve(images)
    return f


def test_program_agrees_with_reference():
    out = run()
    assert out["attempted"] > 0 and out["failed"] == 0
    assert harness.correct(out), out["checks"]


@pytest.mark.parametrize("fault", [_heads_in_reverse_grids,
                                   _upsample_shifted],
                         ids=lambda f: f.__name__)
def test_broken_timed_path_is_not_correct(fault):
    out = run({"serve": fault})
    assert not harness.correct(out), out["checks"]


def test_fp8_control_is_not_correct():
    out = run(program=lambda ctx, name, build, parts: controls_heads
              .stand_in("fp8", name, ctx, build, parts))
    assert not harness.correct(out), out["checks"]


def test_yolov3_pose_flops_and_weights():
    c = harness.Cell(harness.load_benchmark(os.path.dirname(tiny.PKG)),
                     "yolov3-serve-b8-608", os.path.dirname(tiny.PKG))
    cfg = c.config["cfg"]
    assert LH.conv_flops_per_frame(cfg, 608, 608) == 139_682_717_696
    assert LH.conv_weights(cfg) == c.config["conv_weights"] == 61_546_336


def test_counts_and_draws_are_the_region_nets():
    """On a cfg of the layers both know (conv, maxpool, route), the FLOP
    count is ``roofline``'s and the draws are ``seeded.raw_weights``'s,
    bit for bit."""
    mp = {"type": "maxpool", "size": "2", "stride": "2"}
    cfg = [{"type": "net"}, _conv(8, 3), mp, _conv(16, 3), _conv(8, 1),
           {"type": "route", "layers": "-1,-2"}, mp,
           _conv(20, 1, bn=False, act="linear")]
    assert LH.conv_flops_per_frame(cfg, 64, 96) == \
        roofline.conv_flops_per_frame(cfg, 64, 96)
    assert LH.conv_weights(cfg) == roofline.conv_weights(cfg)
    got = LH.raw_weights(cfg, 2 ** 40 + 3, "cpu")
    want = seeded.raw_weights(cfg, 2 ** 40 + 3, "cpu")
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_calibrated_bn_normalises_each_conv():
    """After ``calibrate_bn`` each BN conv's folded output on the
    calibration frames has its drawn scale and shift, not the stream's
    growth: every head stays within a few units."""
    from portbench.reference import darknet_heads as ref
    cfg = blocks()
    raw = LH.raw_weights(cfg, 5, "cpu")
    frames = seeded.frame_pool(6, 1, 2, 96, 96)[0]
    LH.calibrate_bn(cfg, raw, torch.from_numpy(frames))
    layers = ref.parse(cfg)
    heads = ref.forward_folded(layers, ref.fold(layers, raw),
                               torch.from_numpy(frames))
    assert [tuple(h.shape) for h in heads] == [(2, 12, 12, 60),
                                              (2, 24, 24, 60)]
    assert all(0.05 < float(h.std()) < 5 for h in heads)


def _x(name, ts, dur, cat, tid=1, corr=None):
    e = {"name": name, "ph": "X", "ts": ts, "dur": dur, "cat": cat,
         "pid": 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_span_device_time_follows_the_launches():
    """A kernel counts for the span open on its launching thread when it
    was launched, wherever it ran on the card's clock."""
    events = [
        _x("ssp.net.trunk", 100, 50, "user_annotation"),
        _x("ssp.net.neck", 150, 20, "user_annotation"),
        _x("ssp.net.trunk", 300, 50, "user_annotation"),
        _x("cudaLaunchKernel", 110, 2, "cuda_runtime", corr=1),
        _x("cudaLaunchKernel", 160, 2, "cuda_runtime", corr=2),
        _x("cudaLaunchKernel", 310, 2, "cuda_runtime", corr=3),
        _x("cudaLaunchKernel", 120, 2, "cuda_runtime", tid=2, corr=4),
        _x("k1", 400, 30, "kernel", tid=7, corr=1),
        _x("k2", 430, 10, "kernel", tid=7, corr=2),
        _x("Memcpy DtoD", 440, 5, "gpu_memcpy", tid=7, corr=3),
        _x("k4", 445, 7, "kernel", tid=7, corr=4),
    ]
    got = LH.span_device_s(events)
    assert got["ssp.net.trunk"][1] == 2 and got["ssp.net.neck"][1] == 1
    assert got["ssp.net.trunk"][0] == pytest.approx(35e-6)
    assert got["ssp.net.neck"][0] == pytest.approx(10e-6)
