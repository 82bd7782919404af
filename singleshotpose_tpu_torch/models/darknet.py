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
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..config import (NetConfig, RegionConfig, format_cfg_table,
                      net_config_from_block, parse_cfg,
                      region_config_from_block)
from ..ops import stem
from . import layers as L

__all__ = ["ConvSpec", "MaxPoolSpec", "ReorgSpec", "RouteSpec",
           "ShortcutSpec", "AvgPoolSpec", "SoftmaxSpec", "ConnectedSpec",
           "RegionSpec", "DarknetSpec", "Darknet", "fold_batchnorm",
           "apply_folded", "stem_supported"]


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


LayerSpec = Union[ConvSpec, MaxPoolSpec, ReorgSpec, RouteSpec, ShortcutSpec,
                  AvgPoolSpec, SoftmaxSpec, ConnectedSpec, RegionSpec]


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

    @classmethod
    def from_cfg(cls, cfgfile: str) -> "DarknetSpec":
        return cls(parse_cfg(cfgfile))

    @property
    def num_keypoints(self) -> int:
        return self.net.num_keypoints

    @property
    def num_classes(self) -> int:
        return self.region.classes if self.region else 0

    @property
    def num_anchors(self) -> int:
        return self.region.num if self.region else 1

    @property
    def anchors(self) -> Tuple[float, ...]:
        return self.region.anchors if self.region else ()

    def conv_specs(self) -> List[ConvSpec]:
        return [l for l in self.layers if isinstance(l, ConvSpec)]

    def format_network(self) -> str:
        return format_cfg_table(self.blocks)


def stem_supported(spec: DarknetSpec, compute_dtype, shape=None) -> bool:
    """True when ``spec``'s first two layers are the fused stems' pattern
    (conv 3×3 s1 p1 3→32 with BN and leaky, then a 2×2/2 max pool, neither
    output re-read by a route) and the compute type is bf16 —
    ``singleshotpose_tpu/ops/stem.py:stem_supported`` without its device
    check (here the tensors' device picks kernel or plain version).

    ``shape``: the input (B, H, W, C), when given, also applies the JAX
    package's batch gate as it stands there: B < 64, and H, W multiples of
    32 (its threshold, measured on its accelerator; ``chip_smoke.py
    --profile`` measures the fused and the unfused step on the card at
    batch 64)."""
    if compute_dtype != torch.bfloat16 or len(spec.layers) < 2:
        return False
    if shape is not None:
        B, H, W = shape[0], shape[1], shape[2]
        if B >= 64 or H % 32 or W % 32:
            return False
    c, m = spec.layers[0], spec.layers[1]
    return (isinstance(c, ConvSpec) and isinstance(m, MaxPoolSpec)
            and c.in_filters == 3 and c.filters == 32 and c.size == 3
            and c.stride == 1 and c.pad == 1 and c.batch_normalize
            and c.activation == "leaky" and m.size == 2 and m.stride == 2
            and 0 not in spec._live and 1 not in spec._live)


# ---------------------------------------------------------------------------
# The shared block interpreter (NCHW, channels_last memory)
# ---------------------------------------------------------------------------


def _activate(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "leaky":
        return L.leaky_relu(x)
    if activation == "relu":
        return torch.clamp_min(x, 0)
    return x


def _walk(spec: DarknetSpec, x: torch.Tensor, conv_fn, fc_params,
          start: int = 0) -> torch.Tensor:
    """Run ``spec.layers[start:]`` on NCHW ``x``.  ``conv_fn(spec, x)``
    supplies the conv + norm + bias body; every other layer type has one
    implementation here, and only outputs a later layer re-reads are kept."""
    cache: Dict[int, torch.Tensor] = {}
    for i, lspec in enumerate(spec.layers[start:], start):
        if isinstance(lspec, ConvSpec):
            x = _activate(conv_fn(lspec, x), lspec.activation)
        elif isinstance(lspec, MaxPoolSpec):
            x = L.max_pool(x, lspec.size, lspec.stride) if lspec.stride > 1 \
                else L.max_pool_stride1(x)
        elif isinstance(lspec, ReorgSpec):
            x = L.reorg(x, lspec.stride)
        elif isinstance(lspec, RouteSpec):
            srcs = [cache[j] for j in lspec.layers]
            x = srcs[0] if len(srcs) == 1 else torch.cat(srcs, dim=1)
        elif isinstance(lspec, ShortcutSpec):
            x = _activate(cache[lspec.from_layer] + cache[i - 1],
                          lspec.activation)
        elif isinstance(lspec, AvgPoolSpec):
            x = L.global_avg_pool(x)
        elif isinstance(lspec, SoftmaxSpec):
            x = F.softmax(x, dim=1)
        elif isinstance(lspec, ConnectedSpec):
            w, b = fc_params(lspec)
            # flatten in NHWC order, as the JAX forward does
            flat = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1) \
                if x.dim() == 4 else x
            x = _activate(flat.float() @ w.t().float() + b, lspec.activation)
        elif not isinstance(lspec, RegionSpec):
            raise ValueError(f"unhandled layer spec {lspec!r}")
        if i in spec._live:
            cache[i] = x
    return x


def _to_nchw(images: torch.Tensor) -> torch.Tensor:
    """NHWC → NCHW view; for a contiguous NHWC tensor this is channels_last
    memory already, so no copy."""
    if images.dim() != 4:
        raise ValueError(f"expected NHWC images, got shape {tuple(images.shape)}")
    return images.permute(0, 3, 1, 2)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
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
    mean 0, var 1."""

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

    def folded(self, eps: float = L.BN_EPS) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weight, bias) with the running BN folded in, f32, OIHW.  The
        divisor is ``sqrt(var + eps)`` exactly as the JAX fold computes it
        (``darknet.py:454``), not an rsqrt."""
        if not self.spec.batch_normalize:
            return self.weight.detach(), self.bias.detach()
        inv = self.scale.detach() / torch.sqrt(self.running_var + eps)
        return (self.weight.detach() * inv[:, None, None, None],
                self.bias.detach() - self.running_mean * inv)

    def forward(self, x: torch.Tensor, compute_dtype=None) -> torch.Tensor:
        """Conv, then BN or the f32 bias add.  In training mode BN normalizes
        with the batch statistics and updates the running buffers in place
        (``DarknetSpec.apply(train=True)``, ``darknet.py:373-391``); in eval
        mode it uses the running statistics.  With a compute dtype the conv
        output is in that dtype and BN returns it in that dtype; the head's
        f32 bias add promotes the head to f32."""
        y = _conv(self.spec, x, self.weight, compute_dtype)
        if not self.spec.batch_normalize:
            return y + L.per_channel(self.bias, y)
        if not self.training:
            return L.batch_norm(y, self.scale, self.bias, self.running_mean,
                                self.running_var)
        y, mean, var = L.batch_norm_train(y, self.scale, self.bias)
        self.update_running(mean, var, y.shape[0] * y.shape[2] * y.shape[3])
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
        self.eval()

    def _fc(self, lspec: ConnectedSpec):
        m = getattr(self, lspec.name)
        return m.weight, m.bias

    def forward(self, images: torch.Tensor, compute_dtype=None,
                fused_stem: bool = False) -> torch.Tensor:
        """``images`` NHWC float in [0, 1] → the raw head, NHWC."""
        start, x = 0, _to_nchw(images)
        if fused_stem and self.training and stem_supported(
                self.spec, compute_dtype, tuple(images.shape)):
            B, H, W, _ = images.shape
            c0 = getattr(self, self.spec.layers[0].name)
            pooled, mean, var = stem.stem_conv_bn_pool_train(
                images.float().contiguous(), c0.weight, c0.scale, c0.bias)
            c0.update_running(mean, var, B * H * W)
            start, x = 2, _to_nchw(pooled)
        out = _walk(self.spec, x,
                    lambda s, x: getattr(self, s.name)(x, compute_dtype),
                    self._fc, start=start)
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
    own ``w``/``b`` — the serving parameters of :func:`apply_folded`."""
    folded: Dict[str, Dict[str, torch.Tensor]] = {}
    with torch.no_grad():
        for lspec in model.spec.layers:
            if isinstance(lspec, (ConvSpec, ConnectedSpec)):
                m = getattr(model, lspec.name)
                w, b = m.folded() if isinstance(lspec, ConvSpec) \
                    else (m.weight.detach(), m.bias.detach())
                folded[lspec.name] = {"w": w.contiguous(), "b": b.contiguous()}
    return folded


def apply_folded(spec: DarknetSpec, folded: Dict[str, Dict[str, torch.Tensor]],
                 images: torch.Tensor, *, compute_dtype=None) -> torch.Tensor:
    """Inference with BN folded into the convs — the serving forward
    (``DarknetSpec.apply_folded``).  ``images`` NHWC float in [0, 1].

    bf16 policy: the backbone convs (the ones that had BN) add their f32 bias
    in f32 and store bf16; the head conv keeps its f32 bias-add, since its
    regression output feeds the decoder and no later conv re-rounds it.

    With ``compute_dtype=torch.bfloat16`` and the stem pattern present the
    first conv + leaky + pool run as one kernel
    (:func:`~singleshotpose_tpu_torch.ops.stem.stem_conv_pool_infer`): on a
    CUDA tensor the hand-written kernel, on a CPU tensor its plain twin.
    """
    start = 0
    if stem_supported(spec, compute_dtype):
        p0 = folded[spec.layers[0].name]
        x = _to_nchw(stem.stem_conv_pool_infer(images.float().contiguous(),
                                               p0["w"], p0["b"]))
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

    return _to_nhwc(_walk(spec, x, conv_fn, fc, start=start))
