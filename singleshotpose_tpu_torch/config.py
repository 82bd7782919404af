"""Darknet ``.cfg`` / ``.data`` configuration system.

The port's own copy of ``singleshotpose_tpu/config.py`` (plain Python, no
framework), kept so the port imports nothing of the JAX package;
``tests/test_torch_host.py`` holds it equal to the original.  Left out until
the multi-object slice: ``occlusion_sweep`` and ``print_cfg``.

A rebuild of the reference config layer (reference: ``cfg.py:4-34``
``parse_cfg`` and ``utils.py:343-358`` ``read_data_cfg``).  The parsers keep the
reference's permissive text semantics (ordered ``[section]`` blocks of
``key=value`` strings, ``#`` comments, ``convolutional`` blocks defaulting
``batch_normalize=0``) but everything downstream consumes *typed, frozen*
dataclasses.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = [
    "parse_cfg",
    "read_data_cfg",
    "NetConfig",
    "RegionConfig",
    "DataConfig",
    "net_config_from_block",
    "region_config_from_block",
    "data_config_from_options",
    "format_cfg_table",
]


def parse_cfg(cfgfile: str) -> List[Dict[str, str]]:
    """Parse a darknet-format ``.cfg`` file into an ordered list of blocks.

    Each block is a ``dict`` with a ``type`` key (the ``[section]`` name) plus
    the raw string key/values.  Matches the reference parser semantics
    (``cfg.py:4-34``): blank lines and ``#`` comments skipped, a ``type`` key
    inside a block is renamed ``_type`` (used by ``cost`` layers), and
    ``convolutional`` blocks default ``batch_normalize`` to ``"0"``.
    """
    blocks: List[Dict[str, str]] = []
    block: Optional[Dict[str, str]] = None
    with open(cfgfile, "r") as fp:
        for raw in fp:
            line = raw.rstrip()
            if line == "" or line[0] == "#":
                continue
            if line[0] == "[":
                if block is not None:
                    blocks.append(block)
                block = {"type": line.lstrip("[").rstrip("]")}
                if block["type"] == "convolutional":
                    block["batch_normalize"] = "0"
            else:
                key, value = line.split("=", 1)
                key = key.strip()
                if key == "type":
                    key = "_type"
                block[key] = value.strip()
    if block is not None:
        blocks.append(block)
    return blocks


def read_data_cfg(datacfg: str) -> Dict[str, str]:
    """Parse a ``.data`` key=value file (reference: ``utils.py:343-358``).

    Ships the same defaults as the reference: ``gpus='0'`` (kept for interface
    parity; the port ignores it) and ``num_workers='10'``.
    """
    options: Dict[str, str] = {"gpus": "0", "num_workers": "10"}
    with open(datacfg, "r") as fp:
        for raw in fp:
            line = raw.strip()
            if line == "" or line.startswith("#"):
                continue
            key, value = line.split("=", 1)
            options[key.strip()] = value.strip()
    return options


def _floats(s: str) -> Tuple[float, ...]:
    s = s.strip()
    if not s:
        return ()
    return tuple(float(x) for x in s.split(","))


@dataclasses.dataclass(frozen=True)
class NetConfig:
    """Typed view of the ``[net]`` block (reference: ``cfg/yolo-pose.cfg:1-29``)."""

    batch: int = 8
    subdivisions: int = 1
    width: int = 416
    height: int = 416
    channels: int = 3
    num_keypoints: int = 9
    momentum: float = 0.9
    decay: float = 0.0005
    learning_rate: float = 0.001
    burn_in: int = 1000
    max_batches: int = 80200
    max_epochs: int = 500
    policy: str = "steps"
    steps: Tuple[float, ...] = (-1, 80, 160)
    scales: Tuple[float, ...] = (0.1, 0.1, 0.1)
    conf_thresh: float = 0.1
    test_width: int = 672
    test_height: int = 672
    saturation: float = 1.5
    exposure: float = 1.5
    hue: float = 0.1
    angle: float = 0.0


def net_config_from_block(block: Dict[str, str]) -> NetConfig:
    assert block.get("type") == "net", f"expected [net] block, got {block.get('type')}"
    kw = {}
    ints = {
        "batch", "subdivisions", "width", "height", "channels", "num_keypoints",
        "burn_in", "max_batches", "max_epochs", "test_width", "test_height",
    }
    flts = {
        "momentum", "decay", "learning_rate", "conf_thresh", "saturation",
        "exposure", "hue", "angle",
    }
    for key, value in block.items():
        if key == "type":
            continue
        if key in ints:
            kw[key] = int(value)
        elif key in flts:
            kw[key] = float(value)
        elif key in ("steps", "scales"):
            kw[key] = _floats(value)
        elif key == "policy":
            kw[key] = value
        # unknown keys are carried in the raw block; the typed view drops them
    return NetConfig(**kw)


@dataclasses.dataclass(frozen=True)
class RegionConfig:
    """Typed view of the ``[region]`` block (reference: ``cfg/yolo-pose.cfg:248-265``).

    Like the reference model builder (``darknet.py:230-245``), only the fields
    the loss actually consumes are interpreted; ``jitter``/``rescore``/... are
    hard-coded elsewhere in the pipeline for parity.
    """

    anchors: Tuple[float, ...] = ()
    classes: int = 1
    coords: int = 18
    num: int = 1  # number of anchors
    object_scale: float = 5.0
    noobject_scale: float = 1.0
    class_scale: float = 1.0
    coord_scale: float = 1.0
    thresh: float = 0.6
    softmax: int = 1

    @property
    def num_anchors(self) -> int:
        return self.num

    @property
    def anchor_step(self) -> int:
        return len(self.anchors) // self.num if self.num else 0


def region_config_from_block(block: Dict[str, str]) -> RegionConfig:
    assert block.get("type") == "region"
    kw = {}
    if "anchors" in block:
        kw["anchors"] = _floats(block["anchors"])
    for key in ("classes", "num", "coords", "softmax"):
        if key in block:
            kw[key] = int(block[key])
    for key in ("object_scale", "noobject_scale", "class_scale", "coord_scale", "thresh"):
        if key in block:
            kw[key] = float(block[key])
    return RegionConfig(**kw)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    """Typed view of a ``.data`` file (reference: e.g. ``cfg/ape.data:1-14``)."""

    train: Optional[str] = None
    valid: Optional[str] = None
    backup: Optional[str] = None
    mesh: Optional[str] = None
    tr_range: Optional[str] = None
    name: Optional[str] = None
    diam: Optional[float] = None
    gpus: str = "0"
    num_workers: int = 10
    width: int = 640
    height: int = 480
    fx: float = 572.4114
    fy: float = 573.5704
    u0: float = 325.2611
    v0: float = 242.0489
    # multi-object (OCCLUSION) sweeps: valid1..validN / mesh1..meshN / diam1..diamN
    extra: Dict[str, str] = dataclasses.field(default_factory=dict)


def data_config_from_options(options: Dict[str, str]) -> DataConfig:
    kw: Dict[str, object] = {}
    extra: Dict[str, str] = {}
    for key, value in options.items():
        if key in ("train", "valid", "backup", "mesh", "tr_range", "name", "gpus"):
            kw[key] = value
        elif key == "diam":
            kw[key] = float(value)
        elif key in ("num_workers", "width", "height"):
            kw[key] = int(value)
        elif key in ("im_width", "im_height"):
            # multi-object .data files name these im_width/im_height
            # (e.g. ape_occlusion.data:7-8 vs ape.data's width/height)
            kw[key.replace("im_", "")] = int(value)
        elif key in ("fx", "fy", "u0", "v0"):
            kw[key] = float(value)
        else:
            extra[key] = value
    kw["extra"] = extra
    return DataConfig(**kw)


# ---------------------------------------------------------------------------
# Network pretty-printer ("layer filters size input output" table)
# ---------------------------------------------------------------------------


def format_cfg_table(blocks: Sequence[Dict[str, str]]) -> str:
    """Symbolic shape propagation over blocks, reproducing the reference table
    (reference: ``cfg.py:36-151`` ``print_cfg``; sample output ``README.md:73-82``).
    """
    lines = ["layer     filters    size              input                output"]
    prev_width, prev_height, prev_filters = 416, 416, 3
    out_filters: List[int] = []
    out_widths: List[int] = []
    out_heights: List[int] = []
    filters = prev_filters
    ind = -2
    for block in blocks:
        ind += 1
        btype = block["type"]
        if btype == "net":
            prev_width = int(block.get("width", 416))
            prev_height = int(block.get("height", 416))
            continue
        if btype == "convolutional":
            filters = int(block["filters"])
            kernel_size = int(block["size"])
            stride = int(block["stride"])
            pad = (kernel_size - 1) // 2 if int(block["pad"]) else 0
            width = (prev_width + 2 * pad - kernel_size) // stride + 1
            height = (prev_height + 2 * pad - kernel_size) // stride + 1
            lines.append(
                "%5d %-6s %4d  %d x %d / %d   %3d x %3d x%4d   ->   %3d x %3d x%4d"
                % (ind, "conv", filters, kernel_size, kernel_size, stride,
                   prev_width, prev_height, prev_filters, width, height, filters))
            prev_width, prev_height, prev_filters = width, height, filters
        elif btype == "maxpool":
            pool_size = int(block["size"])
            stride = int(block["stride"])
            width = prev_width // stride
            height = prev_height // stride
            lines.append(
                "%5d %-6s       %d x %d / %d   %3d x %3d x%4d   ->   %3d x %3d x%4d"
                % (ind, "max", pool_size, pool_size, stride,
                   prev_width, prev_height, prev_filters, width, height, filters))
            prev_width, prev_height = width, height
        elif btype == "avgpool":
            lines.append("%5d %-6s                   %3d x %3d x%4d   ->  %3d"
                         % (ind, "avg", prev_width, prev_height, prev_filters, prev_filters))
            prev_width, prev_height = 1, 1
        elif btype == "softmax":
            lines.append("%5d %-6s                                    ->  %3d"
                         % (ind, "softmax", prev_filters))
        elif btype == "cost":
            lines.append("%5d %-6s                                     ->  %3d"
                         % (ind, "cost", prev_filters))
        elif btype == "reorg":
            stride = int(block["stride"])
            filters = stride * stride * prev_filters
            width = prev_width // stride
            height = prev_height // stride
            lines.append(
                "%5d %-6s             / %d   %3d x %3d x%4d   ->   %3d x %3d x%4d"
                % (ind, "reorg", stride, prev_width, prev_height, prev_filters,
                   width, height, filters))
            prev_width, prev_height, prev_filters = width, height, filters
        elif btype == "route":
            layers = [int(i) for i in block["layers"].split(",")]
            layers = [i if i > 0 else i + ind for i in layers]
            if len(layers) == 1:
                lines.append("%5d %-6s %d" % (ind, "route", layers[0]))
                prev_width = out_widths[layers[0]]
                prev_height = out_heights[layers[0]]
                prev_filters = out_filters[layers[0]]
            else:
                lines.append("%5d %-6s %d %d" % (ind, "route", layers[0], layers[1]))
                prev_width = out_widths[layers[0]]
                prev_height = out_heights[layers[0]]
                assert prev_width == out_widths[layers[1]]
                assert prev_height == out_heights[layers[1]]
                prev_filters = out_filters[layers[0]] + out_filters[layers[1]]
        elif btype == "region":
            lines.append("%5d %-6s" % (ind, "detection"))
        elif btype == "shortcut":
            from_id = int(block["from"])
            from_id = from_id if from_id > 0 else from_id + ind
            lines.append("%5d %-6s %d" % (ind, "shortcut", from_id))
            prev_width = out_widths[from_id]
            prev_height = out_heights[from_id]
            prev_filters = out_filters[from_id]
        elif btype == "connected":
            filters = int(block["output"])
            lines.append("%5d %-6s                            %d  ->  %3d"
                         % (ind, "connected", prev_filters, filters))
            prev_filters = filters
            out_widths.append(1)
            out_heights.append(1)
            out_filters.append(prev_filters)
            continue
        else:
            lines.append("unknown type %s" % btype)
        out_widths.append(prev_width)
        out_heights.append(prev_height)
        out_filters.append(prev_filters)
    return "\n".join(lines)
