"""cfg-compiled Darknet in PyTorch: darknet ``.cfg`` blocks → an ``nn.Module``.

Mirrors ``singleshotpose_tpu/models/darknet.py``.  The layer specs and
:class:`DarknetSpec` are the JAX module's, free of jax: the same block dicts
give the same layers, ``out_filters`` and route liveness.  :class:`Darknet`
holds the parameters (conv weights in OIHW, darknet's own layout) and runs
the eval-mode forward and the train-mode one (batch-statistic BN, its stem
optionally the fused train stem of ``ops/stem.py``); :func:`fold_batchnorm`
and :func:`apply_folded` are the BN-folded serving path, whose stem goes to
the serving kernel in ``ops/stem.py``.

Layout: NHWC at the public boundary (images ``(B, H, W, 3)`` in, the head
``(B, H/32, W/32, D)`` out, as in the JAX package), channels_last NCHW inside
so cuDNN runs its NHWC convolutions.

A YOLOv3-style net (``[upsample]`` layers and one ``[yolo]`` block a head,
which the JAX package does not parse) has several heads: each ``[yolo]``
block marks its input as one, and the forwards return a tuple of NHWC heads
in cfg order in place of the one head.  While a profiler records, such a
forward's layers are the spans ``ssp.net.trunk`` (up to the last shortcut)
and ``ssp.net.neck`` (the rest, through the last head conv).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import (NetConfig, RegionConfig, YoloConfig, format_cfg_table,
                      net_config_from_block, parse_cfg,
                      region_config_from_block, upsample_stride_from_block,
                      yolo_config_from_block)
from ..ops import stem
from ..parallel.sharding import (DPGroup, channel_rows, copy_to_model,
                                  gather_channels, gather_model,
                                  shards_channels)
from ..tracing import span
from . import layers as L

__all__ = ["ConvSpec", "MaxPoolSpec", "ReorgSpec", "RouteSpec",
           "ShortcutSpec", "AvgPoolSpec", "SoftmaxSpec", "ConnectedSpec",
           "RegionSpec", "UpsampleSpec", "YoloSpec", "DarknetSpec", "Darknet",
           "fold_batchnorm", "apply_folded", "shard_folded", "gather_folded",
           "stem_supported"]


# ---------------------------------------------------------------------------
# Layer specs (static metadata, resolved at cfg-compile time)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ConvSpec:
    name: str          # parameter prefix, e.g. "conv_3"
    in_filters: int
    filters: int
    size: int
    stride: int
    pad: int
    batch_normalize: bool
    activation: str    # "leaky" | "relu" | "linear"


@dataclasses.dataclass(frozen=True)
class MaxPoolSpec:
    size: int
    stride: int


@dataclasses.dataclass(frozen=True)
class ReorgSpec:
    stride: int


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    layers: Tuple[int, ...]  # absolute layer indices


@dataclasses.dataclass(frozen=True)
class ShortcutSpec:
    from_layer: int          # absolute layer index
    activation: str


@dataclasses.dataclass(frozen=True)
class AvgPoolSpec:
    pass


@dataclasses.dataclass(frozen=True)
class SoftmaxSpec:
    pass


@dataclasses.dataclass(frozen=True)
class ConnectedSpec:
    name: str
    in_features: int
    out_features: int
    activation: str


@dataclasses.dataclass(frozen=True)
class RegionSpec:
    """The region block carries loss hyperparameters; a no-op in the forward."""
    region: RegionConfig


@dataclasses.dataclass(frozen=True)
class UpsampleSpec:
    stride: int


@dataclasses.dataclass(frozen=True)
class YoloSpec:
    """A ``[yolo]`` block: marks its input as a head; a no-op in the
    forward (the pose decode applies its own activations)."""
    yolo: YoloConfig


LayerSpec = Union[ConvSpec, MaxPoolSpec, ReorgSpec, RouteSpec, ShortcutSpec,
                  AvgPoolSpec, SoftmaxSpec, ConnectedSpec, RegionSpec,
                  UpsampleSpec, YoloSpec]


class DarknetSpec:
    """Static network description compiled from a darknet ``.cfg``
    (``singleshotpose_tpu/models/darknet.py:106-216``)."""

    def __init__(self, blocks: Sequence[Dict[str, str]]):
        self.blocks: List[Dict[str, str]] = list(blocks)
        if not self.blocks or self.blocks[0]["type"] != "net":
            raise ValueError("a darknet cfg starts with a [net] block")
        self.net: NetConfig = net_config_from_block(self.blocks[0])
        self.region: Optional[RegionConfig] = None
        self.layers: List[LayerSpec] = []

        prev_filters = self.net.channels
        out_filters: List[int] = []
        conv_id = 0
        for block in self.blocks[1:]:
            btype = block["type"]
            ind = len(self.layers)
            if btype == "convolutional":
                conv_id += 1
                filters = int(block["filters"])
                size = int(block["size"])
                pad = (size - 1) // 2 if int(block["pad"]) else 0
                self.layers.append(ConvSpec(
                    name=f"conv_{conv_id}", in_filters=prev_filters,
                    filters=filters, size=size, stride=int(block["stride"]),
                    pad=pad,
                    batch_normalize=bool(int(block["batch_normalize"])),
                    activation=block.get("activation", "linear")))
                prev_filters = filters
            elif btype == "maxpool":
                self.layers.append(MaxPoolSpec(int(block["size"]),
                                               int(block["stride"])))
            elif btype == "avgpool":
                self.layers.append(AvgPoolSpec())
            elif btype == "softmax":
                self.layers.append(SoftmaxSpec())
            elif btype == "cost":
                self.layers.append(RegionSpec(RegionConfig()))
            elif btype == "reorg":
                stride = int(block["stride"])
                self.layers.append(ReorgSpec(stride))
                prev_filters = stride * stride * prev_filters
            elif btype == "route":
                refs = [int(i) for i in block["layers"].split(",")]
                refs = tuple(i if i > 0 else i + ind for i in refs)
                self.layers.append(RouteSpec(refs))
                prev_filters = sum(out_filters[i] for i in refs)
            elif btype == "shortcut":
                frm = int(block["from"])
                frm = frm if frm > 0 else frm + ind
                self.layers.append(ShortcutSpec(
                    frm, block.get("activation", "linear")))
                prev_filters = out_filters[ind - 1]
            elif btype == "connected":
                conv_id += 1
                out_features = int(block["output"])
                self.layers.append(ConnectedSpec(
                    name=f"fc_{conv_id}", in_features=prev_filters,
                    out_features=out_features,
                    activation=block.get("activation", "linear")))
                prev_filters = out_features
            elif btype == "region":
                self.region = region_config_from_block(block)
                self.layers.append(RegionSpec(self.region))
            elif btype == "upsample":
                self.layers.append(UpsampleSpec(
                    upsample_stride_from_block(block)))
            elif btype == "yolo":
                self.layers.append(YoloSpec(yolo_config_from_block(block)))
            else:
                raise ValueError(f"unknown block type {btype!r}")
            out_filters.append(prev_filters)

        self.out_filters = out_filters
        # Liveness: which layer outputs are re-read by a later route/shortcut.
        needed = set()
        for i, spec in enumerate(self.layers):
            if isinstance(spec, RouteSpec):
                needed.update(spec.layers)
            elif isinstance(spec, ShortcutSpec):
                needed.add(spec.from_layer)
                needed.add(i - 1)
        self._live = frozenset(needed)

        # the [yolo] heads, in cfg order, and where the trunk and the neck end
        self.heads: Tuple[YoloConfig, ...] = tuple(
            l.yolo for l in self.layers if isinstance(l, YoloSpec))
        if self.heads:
            if self.region is not None:
                raise ValueError("a cfg has [yolo] heads or a [region] "
                                 "head, not both")
            for y in self.heads:
                if (y.classes, y.num_anchors) != (self.heads[0].classes,
                                                  self.heads[0].num_anchors):
                    raise ValueError(
                        "every [yolo] head must have the same classes and "
                        "anchor count, to decode into one grid")
                if not y.num_anchors:
                    raise ValueError("a [yolo] block needs a mask")
            yolo = [i for i, l in enumerate(self.layers)
                    if isinstance(l, YoloSpec)]
            shortcuts = [i for i, l in enumerate(self.layers)
                         if isinstance(l, ShortcutSpec)]
            # the trunk: up to the last shortcut; the neck: through the
            # conv that feeds the last head
            self.trunk_end = shortcuts[-1] if shortcuts else -1
            self.neck_end = yolo[-1] - 1

    @classmethod
    def from_cfg(cls, cfgfile: str) -> "DarknetSpec":
        return cls(parse_cfg(cfgfile))

    @property
    def num_keypoints(self) -> int:
        return self.net.num_keypoints

    @property
    def num_classes(self) -> int:
        if self.heads:
            return self.heads[0].classes
        return self.region.classes if self.region else 0

    @property
    def num_anchors(self) -> int:
        """The anchors of the head (of each head, in a net with [yolo]
        heads)."""
        if self.heads:
            return self.heads[0].num_anchors
        return self.region.num if self.region else 1

    def require_one_head(self, what: str) -> None:
        """Raise ``ValueError`` when the net has [yolo] heads: ``what`` is a
        path that knows one head."""
        if self.heads:
            raise ValueError(
                f"{what} knows one head of one grid; this net has "
                f"{len(self.heads)} [yolo] heads (a net with several heads "
                "is served by serving.make_serving_fn and aot_serving)")

    @property
    def anchors(self) -> Tuple[float, ...]:
        return self.region.anchors if self.region else ()

    def conv_specs(self) -> List[ConvSpec]:
        return [l for l in self.layers if isinstance(l, ConvSpec)]

    def format_network(self) -> str:
        return format_cfg_table(self.blocks)


def stem_supported(spec: DarknetSpec, compute_dtype, shape=None,
                   data_shards: int = 1) -> bool:
    """True when ``spec``'s first two layers are the fused stems' pattern
    (conv 3×3 s1 p1 3→32 with BN and leaky, then a 2×2/2 max pool, neither
    output re-read by a route) and the compute type is bf16 —
    ``singleshotpose_tpu/ops/stem.py:stem_supported`` without its device
    check (here the tensors' device picks kernel or plain version).

    ``shape``: the input (B, H, W, C), when given, also applies the JAX
    package's batch gate as it stands there: B < 64, and H, W multiples of
    32 (its threshold, measured on its accelerator; ``chip_smoke.py
    --profile`` measures the fused and the unfused step on the card at
    batch 64).  ``data_shards``: the data-parallel world size when ``shape``
    is the global batch's — the gate then applies to the per-rank batch
    (each rank runs the kernels on its own rows), which must be a whole,
    nonzero share of B."""
    if compute_dtype != torch.bfloat16 or len(spec.layers) < 2:
        return False
    if shape is not None:
        B, H, W = shape[0], shape[1], shape[2]
        if B % data_shards or B < data_shards:
            return False
        if B // data_shards >= 64 or H % 32 or W % 32:
            return False
    c, m = spec.layers[0], spec.layers[1]
    return (isinstance(c, ConvSpec) and isinstance(m, MaxPoolSpec)
            and c.in_filters == 3 and c.filters == 32 and c.size == 3
            and c.stride == 1 and c.pad == 1 and c.batch_normalize
            and c.activation == "leaky" and m.size == 2 and m.stride == 2
            and 0 not in spec._live and 1 not in spec._live)


def _world(group: Optional[DPGroup]) -> int:
    return 1 if group is None else group.world


# ---------------------------------------------------------------------------
# The shared block interpreter (NCHW, channels_last memory)
# ---------------------------------------------------------------------------


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return L.leaky_relu(x)
    if activation == "relu":
        return torch.clamp_min(x, 0)
    return x


def _walk_other(spec: DarknetSpec, lspec, i: int, x: torch.Tensor,
                cache: Dict[int, torch.Tensor], fc_params) -> torch.Tensor:
    """Layer ``i`` of a type other than conv and max pool on NCHW ``x``
    (``cache`` holds the outputs a later layer re-reads) — shared by
    :func:`_walk` and the int8 interpreter of ``models/quantize.py``, as
    ``DarknetSpec._walk_other`` is in the JAX package."""
    if isinstance(lspec, ReorgSpec):
        return L.reorg(x, lspec.stride)
    if isinstance(lspec, RouteSpec):
        srcs = [cache[j] for j in lspec.layers]
        return srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
    if isinstance(lspec, ShortcutSpec):
        return _activate(cache[lspec.from_layer] + cache[i - 1],
                         lspec.activation)
    if isinstance(lspec, AvgPoolSpec):
        return L.global_avg_pool(x)
    if isinstance(lspec, SoftmaxSpec):
        return F.softmax(x, dim=1)
    if isinstance(lspec, ConnectedSpec):
        w, b = fc_params(lspec)
        # flatten in NHWC order, as the JAX forward does
        flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) \
            if x.dim() == 4 else x
        return _activate(flat.float() @ w.t().float() + b, lspec.activation)
    if isinstance(lspec, UpsampleSpec):
        return L.upsample_nearest(x, lspec.stride)
    if isinstance(lspec, (RegionSpec, YoloSpec)):
        return x
    raise ValueError(f"unhandled layer spec {lspec!r}")


def _segments(spec: DarknetSpec, start: int):
    """``spec.layers[start:]`` as (first, end, span name or None) runs: one
    unnamed run, or for a net with [yolo] heads the trunk's, the neck's and
    what follows the last head conv."""
    n = len(spec.layers)
    if not spec.heads:
        return [(start, n, None)]
    trunk, neck = spec.trunk_end + 1, spec.neck_end + 1
    return [(max(start, lo), hi, name) for lo, hi, name in
            ((start, trunk, "ssp.net.trunk"), (trunk, neck, "ssp.net.neck"),
             (neck, n, None)) if hi > max(start, lo)]


def _walk(spec: DarknetSpec, x: torch.Tensor, conv_fn, fc_params,
          start: int = 0, gather=None):
    """Run ``spec.layers[start:]`` on NCHW ``x``.  ``conv_fn(spec, x)``
    supplies the conv + norm + bias body; every other layer type has one
    implementation here, and only outputs a later layer re-reads are kept.
    ``gather(spec, x)``, when given, takes each conv's activated output (on
    a data × model grid: a split conv's channels gathered).  Returns the
    last layer's output, or for a net with [yolo] heads the tuple of each
    head's input, in cfg order."""
    cache: Dict[int, torch.Tensor] = {}
    heads: List[torch.Tensor] = []
    for lo, hi, name in _segments(spec, start):
        with span(name) if name else contextlib.nullcontext():
            for i in range(lo, hi):
                lspec = spec.layers[i]
                if isinstance(lspec, ConvSpec):
                    x = _activate(conv_fn(lspec, x), lspec.activation)
                    if gather is not None:
                        x = gather(lspec, x)
                elif isinstance(lspec, MaxPoolSpec):
                    x = L.max_pool(x, lspec.size, lspec.stride) \
                        if lspec.stride > 1 else L.max_pool_stride1(x)
                else:
                    if isinstance(lspec, YoloSpec):
                        heads.append(x)
                    x = _walk_other(spec, lspec, i, x, cache, fc_params)
                if i in spec._live:
                    cache[i] = x
    return tuple(heads) if spec.heads else x


def _to_nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view; for a contiguous NHWC tensor this is channels_last
    memory already, so no copy."""
    if images.dim() != 4:
        raise ValueError(f"expected NHWC images, got shape {tuple(images.shape)}")
    return images.permute(0, 3, 1, 2)


def _to_nhwc(x):
    """NCHW → NHWC view of a 4-d tensor (others as they are), or of each
    head of a tuple."""
    if isinstance(x, tuple):
        return tuple(_to_nhwc(h) for h in x)
    return x.permute(0, 2, 3, 1) if x.dim() == 4 else x


def _conv(spec: ConvSpec, x: torch.Tensor, w: torch.Tensor,
          compute_dtype) -> torch.Tensor:
    """Convolution with the compute-dtype policy: bf16 in and out when
    ``compute_dtype`` is set (f32 accumulation inside), f32 otherwise."""
    if compute_dtype is not None:
        x, w = x.to(compute_dtype), w.to(compute_dtype)
    else:
        x = x.float()
    return F.conv2d(x, w, stride=spec.stride, padding=spec.pad)


# ---------------------------------------------------------------------------
# Module: parameters and the eval-mode forward
# ---------------------------------------------------------------------------


def _uniform(size, bound: float, generator: Optional[torch.Generator],
             device) -> torch.Tensor:
    """U(±bound) drawn from ``generator`` on the CPU, then moved; zeros when
    there is no generator (the weights are about to be loaded)."""
    if generator is None:
        return torch.zeros(size, device=device)
    return ((torch.rand(size, generator=generator) * 2 - 1) * bound).to(device)


class ConvBlock(nn.Module):
    """One darknet conv: OIHW ``weight`` plus either BN (``scale``, ``bias``,
    running statistics) or a conv ``bias``.  With a generator, initialised
    as the JAX package's ``init_params``: U(±1/√fan_in), BN scale 1, bias 0,
    mean 0, var 1.  ``model_shards``: the model axis its output channels
    are split over (:meth:`keep_shard`); 1 holds them all."""

    def __init__(self, spec: ConvSpec, generator: Optional[torch.Generator],
                 device=None):
        super().__init__()
        self.spec = spec
        shape = (spec.filters, spec.in_filters, spec.size, spec.size)
        bound = 1.0 / float(np.sqrt(spec.in_filters * spec.size * spec.size))
        self.weight = nn.Parameter(_uniform(shape, bound, generator, device))
        n = spec.filters
        if spec.batch_normalize:
            self.scale = nn.Parameter(torch.ones(n, device=device))
            self.bias = nn.Parameter(torch.zeros(n, device=device))
            self.register_buffer("running_mean", torch.zeros(n, device=device))
            self.register_buffer("running_var", torch.ones(n, device=device))
        else:
            self.bias = nn.Parameter(_uniform((n,), bound, generator, device))
        self.model_shards = 1

    @torch.no_grad()
    def keep_shard(self, group: DPGroup) -> slice:
        """Keep this rank's output channels of every tensor — the weight's
        rows, the BN terms and running statistics, or the bias — in place
        (the parameters stay the same objects, so an optimizer built on
        them still holds them).  Returns the rows kept."""
        rows = channel_rows(self.spec.filters, group)
        for p in self.parameters(recurse=False):
            p.data = p.data[rows].clone()
        for name, b in list(self.named_buffers(recurse=False)):
            setattr(self, name, b[rows].clone())
        self.model_shards = group.mp
        return rows

    def folded(self, eps: float = L.BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) with the running BN folded in, f32, OIHW.  The
        divisor is ``sqrt(var + eps)`` exactly as the JAX fold computes it
        (``darknet.py:454``), not an rsqrt."""
        if not self.spec.batch_normalize:
            return self.weight.detach(), self.bias.detach()
        inv = self.scale.detach() / torch.sqrt(self.running_var + eps)
        return (self.weight.detach() * inv[:, None, None, None],
                self.bias.detach() - self.running_mean * inv)

    def forward(self, x: torch.Tensor, compute_dtype=None,
                group: Optional[DPGroup] = None) -> torch.Tensor:
        """Conv, then BN or the f32 bias add.  In training mode BN normalizes
        with the batch statistics and updates the running buffers in place
        (``DarknetSpec.apply(train=True)``, ``darknet.py:373-391``); in eval
        mode it uses the running statistics.  With a compute dtype the conv
        output is in that dtype and BN returns it in that dtype; the head's
        f32 bias add promotes the head to f32.  ``group``: the statistics
        and the running update's count cover the data group's global batch
        (sync-BN).  A split conv (``model_shards > 1``) takes ``x`` through
        :func:`~..parallel.sharding.copy_to_model` and returns its own
        channels; the caller gathers them."""
        if self.model_shards > 1:
            x = copy_to_model(x, group)
        y = _conv(self.spec, x, self.weight, compute_dtype)
        if not self.spec.batch_normalize:
            return y + L.per_channel(self.bias, y)
        if not self.training:
            return L.batch_norm(y, self.scale, self.bias, self.running_mean,
                                self.running_var)
        y, mean, var = L.batch_norm_train(y, self.scale, self.bias,
                                          group=group)
        self.update_running(mean, var, y.shape[0] * y.shape[2] * y.shape[3]
                            * _world(group))
        return y

    @torch.no_grad()
    def update_running(self, mean: torch.Tensor, var: torch.Tensor,
                       n: int) -> None:
        """Fold one batch's statistics over ``n`` values into the running
        buffers, in place (``layers.running_stat_update``)."""
        new_mean, new_var = L.running_stat_update(
            self.running_mean, self.running_var, mean, var, n)
        self.running_mean.copy_(new_mean)
        self.running_var.copy_(new_var)


class Connected(nn.Module):
    """A darknet ``[connected]`` layer; ``weight`` is (out, in) as darknet
    stores it, ``in`` indexing the NHWC-flattened input."""

    def __init__(self, spec: ConnectedSpec,
                 generator: Optional[torch.Generator], device=None):
        super().__init__()
        bound = 1.0 / float(np.sqrt(spec.in_features))
        self.weight = nn.Parameter(_uniform(
            (spec.out_features, spec.in_features), bound, generator, device))
        self.bias = nn.Parameter(_uniform((spec.out_features,), bound,
                                          generator, device))


class Darknet(nn.Module):
    """The network of a :class:`DarknetSpec`.

    ``forward`` in eval mode (the default) is the counterpart of
    ``DarknetSpec.apply(train=False)``: running BN statistics, NHWC in and
    out.  In training mode (``model.train()``) it is the counterpart of
    ``apply(train=True)``: batch-statistic BN whose running buffers are
    updated in place; :meth:`forward_train` also returns the new statistics.
    ``fused_stem=True`` in training mode runs layers 0–1 through the fused
    train stem (``ops/stem.stem_conv_bn_pool_train``: K3–K6 on a card) when
    :func:`stem_supported` admits the spec, dtype and input shape, as
    ``apply(train=True, fused_stem=True)`` does; in eval mode it does
    nothing.
    Random initialisation comes
    only from an explicit ``generator``; without one the weights are zeros,
    to be replaced by ``load_state_dict``.  State-dict keys are
    ``<layer>.weight`` plus ``<layer>.{scale,bias,running_mean,running_var}``
    for BN convs and ``<layer>.bias`` otherwise, e.g. ``conv_1.weight``.

    ``model_shards``: the model axis of the data × model grid the model is
    split over (:meth:`keep_model_shard`; 1: whole).  A split model runs
    only on its grid: each split conv holds this rank's output channels and
    its output is gathered over the model group.
    """

    def __init__(self, spec: DarknetSpec, *,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.spec = spec
        for lspec in spec.layers:
            if isinstance(lspec, ConvSpec):
                self.add_module(lspec.name, ConvBlock(lspec, generator, device))
            elif isinstance(lspec, ConnectedSpec):
                self.add_module(lspec.name, Connected(lspec, generator, device))
        self.model_shards = 1
        self.eval()

    def keep_model_shard(self, group: DPGroup) -> List[Tuple[torch.Tensor,
                                                              slice]]:
        """Split the model over ``group``'s model axis in place: each conv
        whose filters divide by ``group.mp`` keeps this rank's output
        channels (``ConvBlock.keep_shard``), every other conv and connected
        layer stays whole.  Returns the split parameters with their rows
        (their momentum buffers take the same rows)."""
        if self.model_shards != 1:
            raise ValueError(f"the model is already split over "
                             f"{self.model_shards} model ranks")
        self.spec.require_one_head("the dp × mp split")
        kept = []
        for lspec in self.spec.conv_specs():
            if shards_channels(lspec.filters, group.mp):
                block = getattr(self, lspec.name)
                rows = block.keep_shard(group)
                kept += [(p, rows) for p in block.parameters()]
        self.model_shards = group.mp
        return kept

    def _fc(self, lspec: ConnectedSpec):
        m = getattr(self, lspec.name)
        return m.weight, m.bias

    def forward(self, images: torch.Tensor, compute_dtype=None,
                fused_stem: bool = False,
                group: Optional[DPGroup] = None) -> torch.Tensor:
        """``images`` NHWC float in [0, 1] → the raw head, NHWC (a tuple of
        heads in cfg order for a net with [yolo] heads).  ``group``:
        ``images`` are this rank's rows of a data-parallel batch, and
        training-mode BN is synchronised over the data group (the fused
        stem's too, gated on the per-data-rank batch).  A model split over
        a grid's model axis runs only on that grid: each split conv's
        output is gathered over the model group, and the fused stem, whose
        kernels compute all 32 channels, runs on conv_1's gathered weight,
        scale and bias and updates this rank's running channels."""
        mp = 1 if group is None else group.mp
        if self.model_shards != mp:
            raise ValueError(
                f"the model is split over {self.model_shards} model ranks "
                f"but runs on a group of mp={mp} (split it with "
                "training.shard_train_state on its grid)")
        start, x = 0, _to_nchw(images)
        world = _world(group)
        if fused_stem and self.training and stem_supported(
                self.spec, compute_dtype,
                (images.shape[0] * world,) + tuple(images.shape[1:]),
                data_shards=world):
            B, H, W, _ = images.shape
            c0 = getattr(self, self.spec.layers[0].name)
            w, scale, bias = c0.weight, c0.scale, c0.bias
            if c0.model_shards > 1:
                w, scale, bias = (gather_model(t, group)
                                  for t in (w, scale, bias))
            pooled, mean, var = stem.stem_conv_bn_pool_train(
                images.float().contiguous(), w, scale, bias, group)
            if c0.model_shards > 1:
                rows = channel_rows(c0.spec.filters, group)
                mean, var = mean[rows], var[rows]
            c0.update_running(mean, var, B * H * W * world)
            start, x = 2, _to_nchw(pooled)

        def gather(s: ConvSpec, x: torch.Tensor) -> torch.Tensor:
            if getattr(self, s.name).model_shards > 1:
                return gather_channels(x, group)
            return x

        out = _walk(self.spec, x,
                    lambda s, x: getattr(self, s.name)(x, compute_dtype,
                                                       group),
                    self._fc, start=start, gather=gather if mp > 1 else None)
        return _to_nhwc(out)

    def forward_train(self, images: torch.Tensor, compute_dtype=None,
                      fused_stem: bool = False):
        """Switch to training mode and run the forward: returns (head,
        new_stats), ``new_stats`` the updated running statistics as
        ``{layer: {"mean", "var"}}`` — the JAX ``apply(train=True)``'s
        second result.  The running buffers are updated in place."""
        self.train()
        head = self(images, compute_dtype, fused_stem)
        return head, self.batch_stats()

    def batch_stats(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The running BN statistics, ``{layer: {"mean", "var"}}``."""
        return {l.name: {"mean": getattr(self, l.name).running_mean,
                         "var": getattr(self, l.name).running_var}
                for l in self.spec.conv_specs() if l.batch_normalize}


def fold_batchnorm(model: Darknet) -> Dict[str, Dict[str, torch.Tensor]]:
    """Fold the running BN statistics into each conv's weight and bias:
    ``{layer: {"w": OIHW f32, "b": (O,) f32}}``, plus the connected layers'
    own ``w``/``b`` — the serving parameters of :func:`apply_folded`.  The
    fold is per channel, so a split model's fold is the split of the
    fold: each split conv's ``w``/``b`` hold this rank's channels."""
    folded: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for lspec in model.spec.layers:
            if isinstance(lspec, (ConvSpec, ConnectedSpec)):
                m = getattr(model, lspec.name)
                w, b = m.folded() if isinstance(lspec, ConvSpec) \
                    else (m.weight.detach(), m.bias.detach())
                folded[lspec.name] = {"w": w.contiguous(), "b": b.contiguous()}
    return folded


def _split_convs(spec: DarknetSpec, group: Optional[DPGroup]) -> List[ConvSpec]:
    mp = 1 if group is None else group.mp
    if mp > 1:
        spec.require_one_head("the dp × mp split")
    return [l for l in spec.conv_specs() if shards_channels(l.filters, mp)]


def shard_folded(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                 group: DPGroup) -> Dict[str, Dict[str, torch.Tensor]]:
    """The whole folded params' split over ``group``'s model axis: each
    split conv's ``w``/``b`` rows of this rank (views), every other layer
    as it is (JAX's ``folded_param_shardings``)."""
    out = dict(folded)
    for lspec in _split_convs(spec, group):
        rows = channel_rows(lspec.filters, group)
        out[lspec.name] = {k: v[rows] for k, v in folded[lspec.name].items()}
    return out


def gather_folded(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                  group: DPGroup) -> Dict[str, Dict[str, torch.Tensor]]:
    """Split folded params whole on every rank: each split conv's ``w``/``b``
    gathered over the model group in model-rank order."""
    out = dict(folded)
    with torch.no_grad():
        for lspec in _split_convs(spec, group):
            out[lspec.name] = {k: gather_model(v, group)
                               for k, v in folded[lspec.name].items()}
    return out


def apply_folded(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                 images: torch.Tensor, *, compute_dtype=None,
                 group: Optional[DPGroup] = None) -> torch.Tensor:
    """Inference with BN folded into the convs — the serving forward
    (``DarknetSpec.apply_folded``).  ``images`` NHWC float in [0, 1]; the
    raw head NHWC, or for a net with [yolo] heads the tuple of its heads in
    cfg order.

    bf16 policy: the backbone convs (the ones that had BN) add their f32 bias
    in f32 and store bf16; the head conv keeps its f32 bias-add, since its
    regression output feeds the decoder and no later conv re-rounds it.  A
    shortcut adds its two bf16 inputs and stores bf16; an upsample copies.

    With ``compute_dtype=torch.bfloat16`` and the stem pattern present the
    first conv + leaky + pool run as one kernel
    (:func:`~singleshotpose_tpu_torch.ops.stem.stem_conv_pool_infer`): on a
    CUDA tensor the hand-written kernel, on a CPU tensor its plain twin.

    ``group`` with ``mp > 1``: ``folded`` holds this rank's split convs
    (:func:`fold_batchnorm` of a split model, or :func:`shard_folded`);
    each split conv's output is gathered over the model group, and the
    serving stem, which takes all 32 channels, runs on conv_1's gathered
    ``w``/``b``.
    """
    split = {l.name for l in _split_convs(spec, group)}
    for lspec in spec.conv_specs():
        want = lspec.filters // group.mp if lspec.name in split \
            else lspec.filters
        if folded[lspec.name]["w"].shape[0] != want:
            raise ValueError(
                f"{lspec.name}: {folded[lspec.name]['w'].shape[0]} filters "
                f"where this rank holds {want} of {lspec.filters} (split "
                "params run on their grid; shard_folded splits whole ones)")
    start = 0
    if stem_supported(spec, compute_dtype):
        p0 = folded[spec.layers[0].name]
        w, b = p0["w"], p0["b"]
        if spec.layers[0].name in split:
            w, b = gather_model(w, group), gather_model(b, group)
        x = _to_nchw(stem.stem_conv_pool_infer(images.float().contiguous(),
                                               w, b))
        start = 2
    else:
        x = _to_nchw(images)

    def conv_fn(lspec: ConvSpec, x):
        p = folded[lspec.name]
        y = _conv(lspec, x, p["w"], compute_dtype).float() \
            + L.per_channel(p["b"], x)
        if compute_dtype is not None and lspec.batch_normalize:
            y = y.to(compute_dtype)
        return y

    def fc(lspec: ConnectedSpec):
        return folded[lspec.name]["w"], folded[lspec.name]["b"]

    def gather(lspec: ConvSpec, x: torch.Tensor) -> torch.Tensor:
        return gather_channels(x, group) if lspec.name in split else x

    return _to_nhwc(_walk(spec, x, conv_fn, fc, start=start,
                          gather=gather if split else None))
