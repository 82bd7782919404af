"""Plain PyTorch reference of a pose net with several heads: YOLOv3's
Darknet-53 and three-scale FPN (darknet's ``cfg/yolov3.cfg``) with pose
heads in place of its detection heads.

Written from the cfg's semantics, in float32 with TF32 off, without
kernels, caches or batching, and importing nothing of the program.  The
layers: darknet's conv (BN folded by ``darknet.fold``), maxpool, route
(the sources' channels concatenated), shortcut (``from``: the previous
layer's output plus the ``from`` layer's, then the block's activation),
upsample (nearest: ``out[i, j] = in[i // s, j // s]``) and the ``[yolo]``
block, which marks its input as a head.  The decode is SingleShotPose's
region decode (``darknet.decode``) of each head over its own grid, the
heads' cells laid end to end in cfg order (anchor-major within a head) as
one grid of S cells; the picks are ``darknet.picks`` over that grid.

Departures from darknet:

  * the ``[yolo]`` layer applies nothing: darknet's logistic on x, y,
    objectness and classes, and its anchor-scaled w, h, are replaced by
    SingleShotPose's pose decode, which activates the centroid offset and
    the objectness and softmaxes the classes;
  * the anchors (``mask`` into ``anchors``) are carried but unused, as the
    pose decode uses none;
  * the heads decode into one grid and one pick an image, in place of
    darknet's per-scale boxes and NMS.

``quant``, where given, rounds each conv's input and weight before the
product: the lower-precision control.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from . import darknet as ref


def parse(blocks: Sequence[Dict[str, str]]) -> List[dict]:
    """The layers after ``[net]``: convs named ``conv_<n>`` in order, as
    ``darknet.parse`` names them, and the multi-head net's other layers."""
    layers, n = [], 0
    for i, b in enumerate(blocks[1:]):
        kind = b["type"]
        rel = lambda j: j if j >= 0 else i + j      # noqa: E731
        if kind == "convolutional":
            n += 1
            k = int(b["size"])
            layers.append(dict(kind="conv", name=f"conv_{n}", size=k,
                               filters=int(b["filters"]),
                               stride=int(b.get("stride", 1)),
                               pad=k // 2 if int(b.get("pad", 0)) else 0,
                               bn=int(b.get("batch_normalize", 0)) == 1,
                               leaky=b.get("activation") == "leaky"))
        elif kind == "maxpool":
            layers.append(dict(kind="maxpool", size=int(b["size"]),
                               stride=int(b["stride"])))
        elif kind == "route":
            layers.append(dict(kind="route", src=[
                rel(int(j)) for j in str(b["layers"]).split(",")]))
        elif kind == "shortcut":
            layers.append(dict(kind="shortcut", src=rel(int(b["from"])),
                               leaky=b.get("activation") == "leaky"))
        elif kind == "upsample":
            layers.append(dict(kind="upsample",
                               stride=int(b.get("stride", 2))))
        elif kind == "yolo":
            mask = [int(m) for m in str(b["mask"]).split(",")]
            anchors = [float(a) for a in str(b.get("anchors", "")).split(",")
                       if a.strip()]
            layers.append(dict(kind="yolo", classes=int(b["classes"]),
                               num=len(mask),
                               anchors=tuple(anchors[2 * m + e] for m in mask
                                             for e in (0, 1)) if anchors
                               else ()))
        else:
            raise ValueError(f"layer type {kind!r} has no reference")
    return layers


def heads(layers: List[dict]) -> List[dict]:
    """The ``[yolo]`` layers, in cfg order."""
    return [l for l in layers if l["kind"] == "yolo"]


def _upsample(x: torch.Tensor, s: int) -> torch.Tensor:
    return x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)


def walk(layers: List[dict], x: torch.Tensor, conv) -> List[torch.Tensor]:
    """NCHW ``x`` through the layers, ``conv(l, x)`` giving a conv's output
    before its activation: each head's input, NHWC, in cfg order."""
    outs, out_heads = [], []
    for l in layers:
        kind = l["kind"]
        if kind == "conv":
            x = conv(l, x)
            if l["leaky"]:
                x = ref._leaky(x)
        elif kind == "maxpool":
            x = F.max_pool2d(x, l["size"], l["stride"])
        elif kind == "route":
            x = torch.cat([outs[j] for j in l["src"]], dim=1)
        elif kind == "shortcut":
            x = outs[-1] + outs[l["src"]]
            if l["leaky"]:
                x = ref._leaky(x)
        elif kind == "upsample":
            x = _upsample(x, l["stride"])
        elif kind == "yolo":
            out_heads.append(x.permute(0, 2, 3, 1))
        outs.append(x)
    return out_heads


def forward_folded(layers: List[dict], folded, images: torch.Tensor,
                   quant: Optional[Callable] = None) -> List[torch.Tensor]:
    """The eval-mode forward of u8 NHWC ``images`` over folded weights
    (``darknet.fold``): each head's raw output, NHWC float32, in cfg
    order."""
    ref._float32()
    q = quant or (lambda t: t)

    def conv(l, x):
        p = folded[l["name"]]
        return F.conv2d(q(x), q(p["w"]), stride=l["stride"],
                        padding=l["pad"]) + p["b"][None, :, None, None]

    return walk(layers, ref.to_unit(images), conv)


def decode(head_list: Sequence[torch.Tensor], K: int, yolo: List[dict]):
    """Each head's region decode (``darknet.decode``, its keypoints as
    fractions of its own grid), the cells laid end to end in cfg order.
    Returns (corners (B, S, 2K), det (B, S), probs (B, S, C))."""
    grids = [ref.decode(h, K, y["classes"], y["num"])
             for h, y in zip(head_list, yolo)]
    return tuple(torch.cat(parts, dim=1) for parts in zip(*grids))


def grid(layers: List[dict], folded, images: torch.Tensor, K: int,
         quant: Optional[Callable] = None):
    """u8 NHWC ``images`` → their decoded grid."""
    return decode(forward_folded(layers, folded, images, quant), K,
                  heads(layers))


fold = ref.fold
picks = ref.picks
