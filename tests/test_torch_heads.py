"""Nets with several heads in the port (YOLOv3's Darknet-53 and FPN as a
pose net): ``[upsample]`` and ``[yolo]`` parsed, shortcuts, the forwards'
tuple of heads, the decode of all heads into one grid and the serve,
against the plain reference ``portbench/reference/darknet_heads.py`` on a
tiny net; the full ``yolov3-pose`` spec's counts; the paths that know one
head refusing; the trunk and neck spans."""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest
import torch

from singleshotpose_tpu_torch import config as TC
from singleshotpose_tpu_torch import serving, tracing, training
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch import zoo
from singleshotpose_tpu_torch.drivers import loss_config_from_spec
from singleshotpose_tpu_torch.models import darknet as D
from singleshotpose_tpu_torch.models import quantize
from singleshotpose_tpu_torch.models.darknet import (Darknet, DarknetSpec,
                                                     apply_folded,
                                                     fold_batchnorm,
                                                     shard_folded,
                                                     stem_supported)
from singleshotpose_tpu_torch.ops import decode

from portbench.lib import darknet_heads as LH
from portbench.lib import seeded
from portbench.reference import darknet_heads as ref

from torch_port_helpers import TINY_BLOCKS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = 9


def _conv(f, k, stride=1, bn=True, act="leaky"):
    return {"type": "convolutional", "batch_normalize": str(int(bn)),
            "filters": str(f), "size": str(k), "stride": str(stride),
            "pad": "1", "activation": act}


def _yolo(mask):
    return {"type": "yolo", "mask": mask,
            "anchors": "10,13,  16,30,  33,23,  30,61,  62,45,  59,119",
            "classes": "1", "num": "6", "jitter": ".3"}


SHORTCUT = {"type": "shortcut", "from": "-3", "activation": "linear"}

# two residual stages (a leaky shortcut among them), a head at 1/8, a
# route back, an upsample, a two-source route with the trunk, a head at 1/4
HEADS_BLOCKS = [
    {"type": "net", "width": "64", "height": "64", "channels": "3",
     "num_keypoints": str(K)},
    _conv(8, 3), _conv(16, 3, 2), _conv(8, 1), _conv(16, 3), SHORTCUT,
    _conv(32, 3, 2), _conv(16, 1), _conv(32, 3),
    {"type": "shortcut", "from": "-3", "activation": "leaky"},
    _conv(16, 1), _conv(32, 3), SHORTCUT, _conv(32, 3, 2), _conv(16, 1),
    _conv(32, 3), _conv(60, 1, bn=False, act="linear"), _yolo("3,4,5"),
    {"type": "route", "layers": "-4"}, _conv(8, 1),
    {"type": "upsample", "stride": "2"},
    {"type": "route", "layers": "-1, 11"}, _conv(16, 3),
    _conv(60, 1, bn=False, act="linear"), _yolo("0,1,2"),
]
HEAD_SHAPES = [(2, 8, 8, 60), (2, 16, 16, 60)]


@pytest.fixture(scope="module")
def net():
    """The tiny net on seeded weights (the benchmark's draws, BN
    statistics measured on the first frames), its fold, the reference's
    fold and two batches of u8 frames."""
    spec = DarknetSpec(HEADS_BLOCKS)
    raw = LH.raw_weights(HEADS_BLOCKS, 2 ** 33 + 5, "cpu")
    frames = seeded.frame_pool(17, 2, 2, 64, 64)
    LH.calibrate_bn(HEADS_BLOCKS, raw, torch.from_numpy(frames[0]))
    model = Darknet(spec)
    model.load_state_dict(raw)
    layers = ref.parse(HEADS_BLOCKS)
    return types.SimpleNamespace(
        spec=spec, model=model, folded=fold_batchnorm(model), raw=raw,
        layers=layers, ref_folded=ref.fold(layers, raw), frames=frames)


def _unit(frames) -> torch.Tensor:
    return torch.from_numpy(frames).float() / 255.0


def _ref_heads(net, k=1):
    with torch.no_grad():
        return ref.forward_folded(net.layers, net.ref_folded,
                                  torch.from_numpy(net.frames[k]))


def test_spec_of_the_tiny_net(net):
    spec = net.spec
    assert [type(l).__name__ for l in spec.layers].count("UpsampleSpec") == 1
    assert spec.heads == (TC.YoloConfig((3, 4, 5), spec.heads[0].anchors, 1,
                                        6),
                          TC.YoloConfig((0, 1, 2), spec.heads[0].anchors, 1,
                                        6))
    assert spec.heads[0].anchors == (10, 13, 16, 30, 33, 23, 30, 61, 62, 45,
                                     59, 119)
    assert (spec.num_classes, spec.num_anchors, spec.num_keypoints) == \
        (1, 3, K)
    assert (spec.trunk_end, spec.neck_end) == (11, 22)
    # the upsample keeps its input's channels; the route adds the trunk's
    assert spec.out_filters[18:21] == [8, 8, 40]
    assert {11, 13, 19} <= spec._live
    assert not stem_supported(spec, torch.bfloat16)


@pytest.mark.parametrize("forward", ["module", "folded"])
def test_f32_heads_match_reference(net, forward):
    x = _unit(net.frames[1])
    with torch.no_grad():
        got = net.model(x) if forward == "module" else \
            apply_folded(net.spec, net.folded, x)
    want = _ref_heads(net)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w, shape in zip(got, want, HEAD_SHAPES):
        assert tuple(g.shape) == shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_bf16_heads_match_reference(net):
    """bf16 rounds each conv's product to an 8-bit significand before its
    f32 bias add, and that add takes off the BN mean: where a channel's
    mean is k times its spread, the rounding costs k × 2^-9 of the output.
    With the statistics measured on frames (BN takes the mean off, as in a
    trained net) this compounds over the ≤ 17 layers before a head to
    3.3–3.8 % of the head's largest value here; the bound is 8 %."""
    with torch.no_grad():
        got = apply_folded(net.spec, net.folded, _unit(net.frames[1]),
                           compute_dtype=torch.bfloat16)
    for g, w in zip(got, _ref_heads(net)):
        # the heads keep their f32 bias add
        assert g.dtype == torch.float32
        err = (g - w).abs().max() / w.abs().max()
        assert float(err) < 0.08


def test_decode_heads_cell_order_matches_reference():
    """Head by head in cfg order, anchor-major within a head, each head's
    keypoints as fractions of its own grid."""
    gen = torch.Generator().manual_seed(3)
    heads = [torch.randn(2, h, w, 3 * (2 * K + 2), generator=gen)
             for h, w in ((3, 4), (6, 8), (12, 16))]
    got = decode.decode_heads(heads, K, 1, 3)
    want = ref.decode(heads, K, [{"classes": 1, "num": 3}] * 3)
    assert got.det_conf.shape == (2, 3 * (12 + 48 + 192))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-6,
                                   atol=1e-6)
    # a single head decodes as decode_grid does
    one = decode.decode_heads(heads[:1], K, 1, 3)
    for g, w in zip(one, decode.decode_grid(heads[0], K, 1, 3)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("pick", [("best",), ("per_class", 0.05)])
def test_serve_matches_reference_picks(net, pick):
    fn = serving.make_serving_fn(net.spec, net.folded, pick=pick,
                                 compute_dtype=None)
    got = fn(net.frames[1]).numpy()
    with torch.no_grad():
        grid = ref.grid(net.layers, net.ref_folded,
                        torch.from_numpy(net.frames[1]), K)
    want = ref.picks(*grid, pick)
    assert got.shape == want.shape == ((2, 2 * K + 3) if pick[0] == "best"
                                       else (2, 1, 2 * K + 3))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_aot_serving_serves_the_heads(net):
    """The graph serve's CPU form: bf16, ``("best",)``, one box an image
    within a cell's rounding of the f32 reference's pick."""
    fn = serving.aot_serving(net.spec, net.folded, batch=2, width=64,
                             height=64, pick=("best",))
    got = fn(net.frames[1]).numpy()
    with torch.no_grad():
        grid = ref.grid(net.layers, net.ref_folded,
                        torch.from_numpy(net.frames[1]), K)
    want = ref.picks(*grid, ("best",))
    assert got.shape == (2, 2 * K + 3)
    np.testing.assert_allclose(got[:, 2 * K:], want[:, 2 * K:], atol=0.02)


def test_upsample_is_nearest_and_keeps_channels_last():
    x = torch.arange(2 * 3 * 4 * 5, dtype=torch.bfloat16).reshape(
        2, 3, 4, 5).contiguous(memory_format=torch.channels_last)
    y = D.L.upsample_nearest(x, 2)
    assert y.dtype == torch.bfloat16
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, x.repeat_interleave(2, 2).repeat_interleave(2, 3))


def test_weights_round_trip(net, tmp_path):
    path = str(tmp_path / "heads.weights")
    state = net.model.state_dict()
    TW.save_weights(net.spec, state, path, seen=64)
    header, loaded = TW.load_weights(net.spec, path)
    assert header.seen == 64 and loaded.keys() == state.keys()
    assert all(torch.equal(loaded[k], state[k]) for k in state)


def _refusals(net):
    spec, folded, x = net.spec, net.folded, _unit(net.frames[0])
    return {
        "training": lambda: training.init_train_state(
            Darknet(spec), weight_decay=5e-4, momentum=0.9),
        "the region loss": lambda: loss_config_from_spec(
            spec, pretrain_num_epochs=0, im_width=64, im_height=64),
        "int8 calibration": lambda: quantize.calibrate_activations(
            spec, folded, x),
        "int8 quantization": lambda: quantize.quantize_folded(
            spec, folded, {}),
        "the int8 forward": lambda: quantize.Int8Forward(spec, folded),
        "export": lambda: serving.export_serving(spec, folded, width=64,
                                                 height=64),
        "the split of folded weights": lambda: shard_folded(
            spec, folded, types.SimpleNamespace(mp=2)),
        "the split of a model": lambda: Darknet(spec).keep_model_shard(
            types.SimpleNamespace(mp=2)),
    }


@pytest.mark.parametrize("path", ["training", "the region loss",
                                  "int8 calibration", "int8 quantization",
                                  "the int8 forward", "export",
                                  "the split of folded weights",
                                  "the split of a model"])
def test_paths_that_know_one_head_refuse(net, path):
    with pytest.raises(ValueError, match=r"2 \[yolo\] heads"):
        _refusals(net)[path]()


CPU = [torch.profiler.ProfilerActivity.CPU]


@pytest.mark.parametrize("forward", ["module", "folded_f32", "folded_bf16"])
def test_trunk_and_neck_spans_only_while_profiling(net, forward):
    x = _unit(net.frames[0])
    run = {"module": lambda: net.model(x),
           "folded_f32": lambda: apply_folded(net.spec, net.folded, x),
           "folded_bf16": lambda: apply_folded(
               net.spec, net.folded, x, compute_dtype=torch.bfloat16)}[forward]
    tracing.reset()
    try:
        with torch.no_grad():
            run()
            assert tracing.records() == []
            with torch.profiler.profile(activities=CPU) as prof:
                run()
        names = [r.name for r in tracing.records()]
        assert names == ["ssp.net.trunk", "ssp.net.neck"]
        trunk, neck = tracing.records()
        assert trunk.end_ns <= neck.start_ns
        ranges = {e.name for e in prof.events()}
        assert {"ssp.net.trunk", "ssp.net.neck"} <= ranges
    finally:
        tracing.reset()


def test_single_head_nets_open_no_span():
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(1))
    x = torch.rand(1, 64, 64, 3)
    tracing.reset()
    try:
        with torch.no_grad(), torch.profiler.profile(activities=CPU):
            head = model(x)
            apply_folded(spec, fold_batchnorm(model), x,
                         compute_dtype=torch.bfloat16)
        assert isinstance(head, torch.Tensor) and tracing.records() == []
    finally:
        tracing.reset()


# -- the full configuration -------------------------------------------------


def _config():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "yolov3_pose.json")) as f:
        return json.load(f)


def test_yolov3_pose_counts_and_head_shapes():
    """107 layers, 75 convs, 61,546,336 conv weights; at 608² the heads are
    19², 38² and 76² × 60 (shapes on the meta device, nothing computed),
    and the benchmark's FLOP count is 2·k²·C_in·C_out·H·W over the convs
    the program's walk runs."""
    spec = zoo.yolov3_pose()
    kinds = [type(l).__name__ for l in spec.layers]
    assert len(spec.layers) == 107
    assert [kinds.count(k) for k in ("ConvSpec", "ShortcutSpec",
                                     "RouteSpec", "UpsampleSpec",
                                     "YoloSpec")] == [75, 23, 4, 2, 3]
    assert sum(c.filters * c.in_filters * c.size ** 2
               for c in spec.conv_specs()) == 61_546_336
    assert (spec.trunk_end, spec.neck_end) == (74, 105)
    assert not stem_supported(spec, torch.bfloat16)
    flops = []

    def conv_fn(c, x):
        y = torch.nn.functional.conv2d(
            x, torch.empty(c.filters, c.in_filters, c.size, c.size,
                           device="meta"), stride=c.stride, padding=c.pad)
        flops.append(2 * c.size ** 2 * c.in_filters * c.filters
                     * y.shape[2] * y.shape[3])
        return y

    heads = D._walk(spec, torch.empty(1, 3, 608, 608, device="meta"),
                    conv_fn, None)
    assert [tuple(h.shape) for h in heads] == [(1, 60, 19, 19),
                                              (1, 60, 38, 38),
                                              (1, 60, 76, 76)]
    blocks = _config()["cfg"]
    assert LH.conv_flops_per_frame(blocks, 608, 608) == sum(flops) \
        == 139_682_717_696


def test_zoo_blocks_are_the_configuration_file():
    cfg = _config()
    assert zoo.yolov3_pose_blocks() == cfg["cfg"]
    assert zoo._resolve_model("yolov3-pose").blocks == cfg["cfg"]
    assert cfg["conv_weights"] == 61_546_336


def test_cfg_table_and_yolo_block(tmp_path):
    text = "\n".join("[{}]\n{}\n".format(b["type"], "\n".join(
        f"{k}={v}" for k, v in b.items() if k != "type"))
        for b in zoo.yolov3_pose_blocks())
    path = tmp_path / "yolov3-pose.cfg"
    path.write_text(text)
    blocks = TC.parse_cfg(str(path))
    assert blocks == zoo.yolov3_pose_blocks()
    table = TC.format_cfg_table(blocks).splitlines()
    assert len(table) == 108
    assert table[86].split()[:2] == ["85", "upsample"]
    assert table[86].split()[-5:] == ["38", "x", "38", "x", "256"]
    assert table[83].split() == ["82", "yolo"]
    y = TC.yolo_config_from_block(blocks[83])
    assert (y.mask, y.classes, y.num, y.num_anchors) == ((6, 7, 8), 1, 9, 3)
    assert len(y.anchors) == 18


def test_heads_that_differ_are_refused():
    blocks = [dict(b) for b in HEADS_BLOCKS]
    blocks[-1]["classes"] = "2"
    with pytest.raises(ValueError, match="same classes"):
        DarknetSpec(blocks)


@pytest.mark.cuda
def test_graph_serve_of_the_heads_on_the_card(net):
    """``aot_serving`` on a card records the whole net, its three-head
    decode and the pick as one graph: each replay answers as the eager
    serve does, bit for bit, host frames taking the staged way in."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the graph serve records a CUDA "
                    "graph")
    dev = torch.device("cuda")
    folded = {name: {k: t.to(dev) for k, t in p.items()}
              for name, p in net.folded.items()}
    fn = serving.aot_serving(net.spec, folded, batch=2, width=64, height=64,
                             pick=("best",))
    eager = serving.make_serving_fn(net.spec, folded, pick=("best",))
    answers = [fn(net.frames[k]) for k in (0, 1, 0)]
    torch.cuda.synchronize()
    assert fn.replays == 3 and fn.staged == 3 and fn.slot_waits == 0
    for k, got in zip((0, 1, 0), answers):
        assert torch.equal(got, eager(net.frames[k]))
    assert not torch.equal(answers[0], answers[1])
