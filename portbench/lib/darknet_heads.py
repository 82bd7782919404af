"""The seeded weights, the operation count and the span reduction of a
pose net with several heads (``reference/darknet_heads.py``'s layers:
conv, maxpool, route, shortcut, upsample and ``[yolo]``).

``raw_weights`` makes the draws of ``seeded.raw_weights`` with the same
bounds, over this layer list, and ``calibrate_bn`` measures the BN
statistics on seeded frames; ``conv_flops_per_frame`` is
``roofline.conv_flops_per_frame``'s formula over it.  ``span_device_s``
reads a ``torch.profiler`` trace: the device time of the work launched
while a host span was open.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..reference import darknet as ref
from ..reference.darknet_heads import parse, walk
from .trace import DEVICE_CATS


def layer_shapes(blocks: Sequence[Dict[str, str]], height: int,
                 width: int) -> List[Tuple[dict, Dict[str, int]]]:
    """Walk the cfg's layers on a (height, width, 3) input: each parsed
    layer with its input and output (channels, height, width)."""
    c, h, w = 3, height, width
    outs: List[Tuple[int, int, int]] = []
    shapes = []
    for l in parse(blocks):
        info = {"c_in": c, "h_in": h, "w_in": w}
        kind = l["kind"]
        if kind == "conv":
            k, s, p = l["size"], l["stride"], l["pad"]
            h, w = (h + 2 * p - k) // s + 1, (w + 2 * p - k) // s + 1
            c = l["filters"]
        elif kind == "maxpool" and l["stride"] > 1:
            h, w = h // l["stride"], w // l["stride"]
        elif kind == "route":
            c = sum(outs[j][0] for j in l["src"])
            h, w = outs[l["src"][0]][1:]
        elif kind == "upsample":
            h, w = h * l["stride"], w * l["stride"]
        info.update(c_out=c, h_out=h, w_out=w)
        outs.append((c, h, w))
        shapes.append((l, info))
    return shapes


def conv_flops_per_frame(blocks: Sequence[Dict[str, str]], height: int,
                         width: int) -> int:
    """2·k²·C_in·C_out·H_out·W_out summed over every conv, the heads' too."""
    return sum(2 * l["size"] ** 2 * i["c_in"] * i["c_out"] * i["h_out"]
               * i["w_out"] for l, i in layer_shapes(blocks, height, width)
               if l["kind"] == "conv")


def conv_weights(blocks: Sequence[Dict[str, str]]) -> int:
    """The convs' weight count (k²·C_in·C_out)."""
    return sum(l["size"] ** 2 * i["c_in"] * i["c_out"]
               for l, i in layer_shapes(blocks, 64, 64)
               if l["kind"] == "conv")


def raw_weights(blocks: Sequence[dict], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The network's raw parameters and BN statistics, keyed
    ``conv_<n>.<tensor>``, float32 on ``device``: ``seeded.raw_weights``'s
    two draws from a generator on that device, in the same order and
    bounds — every conv weight (and each linear conv's bias after its
    weight) from one draw, U(±√(6/fan_in)) under BN and U(±1/√fan_in)
    without; every BN vector from a second, scale and running variance in
    [0.8, 1.2], bias and running mean in [−0.1, 0.1]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs = [(l, i["c_in"], i["c_out"])
             for l, i in layer_shapes(blocks, 64, 64) if l["kind"] == "conv"]
    sizes = [co * ci * l["size"] ** 2 for l, ci, co in convs]
    u = torch.rand(sum(sizes) + sum(co for l, _, co in convs if not l["bn"]),
                   generator=gen, device=device) * 2 - 1
    n_bn = sum(co for l, _, co in convs if l["bn"])
    v = torch.rand(4 * n_bn, generator=gen, device=device)
    raw, at, at_bn = {}, 0, 0
    for (l, ci, co), n in zip(convs, sizes):
        fan_in = ci * l["size"] ** 2
        bound = (6.0 / fan_in) ** 0.5 if l["bn"] else fan_in ** -0.5
        name = l["name"]
        raw[f"{name}.weight"] = (u[at:at + n] * bound).view(
            co, ci, l["size"], l["size"]).clone()
        at += n
        if l["bn"]:
            s = v[at_bn:at_bn + 4 * co].view(4, co)
            raw[f"{name}.scale"] = 0.8 + 0.4 * s[0]
            raw[f"{name}.bias"] = 0.2 * s[1] - 0.1
            raw[f"{name}.running_mean"] = 0.2 * s[2] - 0.1
            raw[f"{name}.running_var"] = 0.8 + 0.4 * s[3]
            at_bn += 4 * co
        else:
            raw[f"{name}.bias"] = (u[at:at + co] * bound).clone()
            at += co
    return raw


@torch.no_grad()
def calibrate_bn(blocks: Sequence[dict], raw: Dict[str, torch.Tensor],
                 frames) -> None:
    """Set each BN conv's running statistics, in place, from what its
    output measures on ``frames`` (u8 NHWC, on ``raw``'s device), as
    training leaves them: ``running_mean = m + drawn_mean·√v`` and
    ``running_var = v·drawn_var``, ``m`` and ``v`` the conv output's
    per-channel mean and (biased) variance over the frames, each layer
    normalized with its new statistics before the next is measured
    (float32, TF32 off for the pass).  The drawn statistics become perturbations of the
    measured ones.  Drawn alone, the statistics of a random net leave the
    residual stream to grow at each of Darknet-53's shortcuts (about ×1.5
    in scale, ~×10⁴ over the 23), and every head's sigmoid saturates."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    ref._float32()

    def conv(l, x):
        n = l["name"]
        z = F.conv2d(x, raw[f"{n}.weight"], stride=l["stride"],
                     padding=l["pad"])
        if not l["bn"]:
            return z + raw[f"{n}.bias"][None, :, None, None]
        var, mean = torch.var_mean(z, dim=(0, 2, 3), unbiased=False)
        raw[f"{n}.running_mean"] = mean + raw[f"{n}.running_mean"] \
            * var.sqrt()
        raw[f"{n}.running_var"] = var * raw[f"{n}.running_var"]
        inv = raw[f"{n}.scale"] / torch.sqrt(raw[f"{n}.running_var"]
                                             + ref.BN_EPS)
        shift = raw[f"{n}.bias"] - raw[f"{n}.running_mean"] * inv
        return z * inv[None, :, None, None] + shift[None, :, None, None]

    try:
        walk(parse(blocks), ref.to_unit(torch.as_tensor(frames)), conv)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def span_device_s(events: List[dict]) -> Dict[str, Tuple[float, int]]:
    """For each host span (``user_annotation``) name in a chrome trace:
    the device seconds of the kernels, copies and sets launched while one
    was open on the launching thread, and how many were recorded.  A
    launch and its device work share the trace's ``correlation`` id."""
    device = collections.defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and e.get("ph") == "X":
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                device[corr] += float(e["dur"]) / 1e6
    launches = collections.defaultdict(list)
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if corr in device and e.get("cat") not in DEVICE_CATS \
                and e.get("ph") == "X":
            launches[(e.get("pid"), e.get("tid"))].append(
                (float(e["ts"]), corr))
    out: Dict[str, Tuple[float, int]] = {}
    for e in events:
        if e.get("cat") != "user_annotation" or e.get("ph") != "X":
            continue
        lo = float(e["ts"])
        hi = lo + float(e["dur"])
        seconds = sum(device[c] for t, c in
                      launches.get((e.get("pid"), e.get("tid")), ())
                      if lo <= t <= hi)
        total, count = out.get(e["name"], (0.0, 0))
        out[e["name"]] = (total + seconds, count + 1)
    return out
