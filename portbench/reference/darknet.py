"""Plain PyTorch reference of the pose net: a darknet cfg's layers, the BN
fold, the eval forward, the region decode and the box picks.

Written from the cfg's semantics (darknet's conv, maxpool, route, reorg and
region layers; SingleShotPose's decode and its class picks), in float32 with
TF32 off, without kernels, caches or batching.  It imports nothing of the
program: it takes the raw weights the benchmark made (conv weights, BN
scale, bias and running statistics, keyed ``conv_<n>.<tensor>``) and works
out the fold itself.  ``quant``, where given, rounds each conv's input and
weight before the product: the lower-precision control.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-4
LEAKY = 0.1


def _ints(s) -> List[int]:
    return [int(v) for v in str(s).replace(" ", "").split(",") if v]


def parse(blocks: Sequence[Dict[str, str]]) -> List[dict]:
    """The layers after ``[net]``: convs named ``conv_<n>`` in order."""
    layers, n = [], 0
    for i, b in enumerate(blocks[1:]):
        kind = b["type"]
        if kind == "convolutional":
            n += 1
            k = int(b["size"])
            layers.append(dict(kind="conv", name=f"conv_{n}", size=k,
                               stride=int(b.get("stride", 1)),
                               pad=k // 2 if int(b.get("pad", 0)) else 0,
                               bn=int(b.get("batch_normalize", 0)) == 1,
                               leaky=b.get("activation") == "leaky"))
        elif kind == "maxpool":
            layers.append(dict(kind="maxpool", size=int(b["size"]),
                               stride=int(b["stride"])))
        elif kind == "route":
            layers.append(dict(kind="route", src=[
                j if j >= 0 else i + j for j in _ints(b["layers"])]))
        elif kind == "reorg":
            layers.append(dict(kind="reorg", stride=int(b["stride"])))
        elif kind == "region":
            anchors = str(b.get("anchors", "")).split(",")
            layers.append(dict(kind="region", classes=int(b["classes"]),
                               num=int(b["num"]),
                               anchors=tuple(float(a) for a in anchors
                                             if a.strip()),
                               keypoints=int(b["coords"]) // 2))
        else:
            raise ValueError(f"layer type {kind!r} has no reference")
    return layers


def region(layers: List[dict]) -> dict:
    return next(l for l in layers if l["kind"] == "region")


def fold(layers: List[dict], raw: Dict[str, torch.Tensor]
         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each conv's (w, b) with its running BN statistics folded in:
    ``w·s/√(var+eps)`` and ``bias − mean·s/√(var+eps)``, in float64 and
    then rounded once to float32."""
    out = {}
    for l in layers:
        if l["kind"] != "conv":
            continue
        name = l["name"]
        w = raw[f"{name}.weight"].double()
        if l["bn"]:
            inv = raw[f"{name}.scale"].double() / torch.sqrt(
                raw[f"{name}.running_var"].double() + BN_EPS)
            b = raw[f"{name}.bias"].double() \
                - raw[f"{name}.running_mean"].double() * inv
            w = w * inv[:, None, None, None]
        else:
            b = raw[f"{name}.bias"].double()
        out[name] = {"w": w.float(), "b": b.float()}
    return out


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, x * LEAKY)


def _reorg(x: torch.Tensor, s: int) -> torch.Tensor:
    """Darknet's space-to-depth in NHWC terms: ``out[b, i, k, (j·s+l)·C +
    c] = x[b, i·s+j, k·s+l, c]``; here on NCHW ``x``."""
    B, C, H, W = x.shape
    nhwc = x.permute(0, 2, 3, 1).reshape(B, H // s, s, W // s, s, C)
    out = nhwc.permute(0, 1, 3, 2, 4, 5).reshape(B, H // s, W // s, s * s * C)
    return out.permute(0, 3, 1, 2)


def _walk(layers: List[dict], x: torch.Tensor, conv) -> torch.Tensor:
    outs = []
    for l in layers:
        kind = l["kind"]
        if kind == "conv":
            x = conv(l, x)
            if l["leaky"]:
                x = _leaky(x)
        elif kind == "maxpool":
            x = F.max_pool2d(x, l["size"], l["stride"])
        elif kind == "route":
            x = torch.cat([outs[j] for j in l["src"]], dim=1)
        elif kind == "reorg":
            x = _reorg(x, l["stride"])
        outs.append(x)
    return x


def _float32() -> None:
    """Float32 products as float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def to_unit(images: torch.Tensor) -> torch.Tensor:
    """u8 NHWC frames → float32 NCHW in [0, 1]."""
    return images.float().div(255.0).permute(0, 3, 1, 2)


def forward_folded(layers: List[dict], folded, images: torch.Tensor,
                   quant: Optional[Callable] = None) -> torch.Tensor:
    """The eval-mode forward of u8 NHWC ``images`` over folded weights: the
    raw head, NHWC float32."""
    _float32()
    q = quant or (lambda t: t)

    def conv(l, x):
        p = folded[l["name"]]
        y = F.conv2d(q(x), q(p["w"]), stride=l["stride"], padding=l["pad"])
        return y + p["b"][None, :, None, None]

    return _walk(layers, to_unit(images), conv).permute(0, 2, 3, 1)


def decode(head: torch.Tensor, K: int, C: int, nA: int):
    """The region decode of an NHWC head: per cell s = a·H·W + y·W + x the
    keypoints as grid fractions (the centroid's offset through a sigmoid,
    the others raw), the sigmoid objectness and the class softmax.
    Returns (corners (B, S, 2K), det (B, S), probs (B, S, C))."""
    B, H, W, _ = head.shape
    E = 2 * K + 1 + C
    cells = head.float().reshape(B, H, W, nA, E).permute(0, 3, 1, 2, 4) \
        .reshape(B, nA * H * W, E)
    kp = cells[..., :2 * K].reshape(B, -1, K, 2).clone()
    kp[:, :, 0] = torch.sigmoid(kp[:, :, 0])
    gy, gx = torch.meshgrid(torch.arange(H, device=head.device),
                            torch.arange(W, device=head.device), indexing="ij")
    gx = gx.reshape(-1).repeat(nA).float()
    gy = gy.reshape(-1).repeat(nA).float()
    px = (kp[..., 0] + gx[None, :, None]) / W
    py = (kp[..., 1] + gy[None, :, None]) / H
    corners = torch.stack([px, py], -1).reshape(B, -1, 2 * K)
    det = torch.sigmoid(cells[..., 2 * K])
    probs = torch.softmax(cells[..., 2 * K + 1:], -1) if C > 0 else \
        torch.ones(B, nA * H * W, 0, device=head.device)
    return corners, det, probs


def _fold_ends(det: np.ndarray, prob: np.ndarray) -> np.ndarray:
    """SingleShotPose's fallback pick over cells 0..S−1 in order: adopt a
    cell when its objectness and its class prob both beat the last adopted
    cell's, strictly.  ``det`` (B, S), ``prob`` (B, N, S) → the last adopted
    cell (B, N)."""
    B, N, S = prob.shape
    best_d = np.full((B, N), -np.inf)
    best_p = np.full((B, N), -np.inf)
    end = np.zeros((B, N), np.int64)
    for s in range(S):
        d, p = det[:, s][:, None], prob[:, :, s]
        take = (d > best_d) & (p > best_p)
        best_d = np.where(take, d, best_d)
        best_p = np.where(take, p, best_p)
        end = np.where(take, s, end)
    return end


def picks(corners, det, probs, pick: Sequence) -> np.ndarray:
    """The boxes a serve returns, from a decoded grid: ``("best",)`` the
    highest-objectness cell an image, (B, 2K+3); ``("per_class", th)`` for
    each class the highest-objectness cell among those whose objectness
    times top class prob exceeds ``th`` and whose top class it is, else the
    fallback fold over objectness and that class's prob, (B, C, 2K+3).
    Rows: 2K corners, objectness, class confidence, class id."""
    corners, det, probs = (t.double().cpu().numpy()
                           for t in (corners, det, probs))
    B, S, C = probs.shape
    if pick[0] == "best":
        idx = det.argmax(1)
        b = np.arange(B)
        cmax = probs.max(-1)[b, idx] if C else np.ones(B)
        cid = probs.argmax(-1)[b, idx] if C else np.zeros(B)
        return np.concatenate([corners[b, idx], det[b, idx, None],
                               cmax[:, None], cid[:, None]], 1)
    th = float(pick[1])
    cmax, cid = probs.max(-1), probs.argmax(-1)
    keep = ((det * cmax) > th)[:, None, :] & \
        (cid[:, None, :] == np.arange(C)[None, :, None])          # (B, C, S)
    kept = np.where(keep, det[:, None, :], -np.inf).argmax(-1)
    ends = _fold_ends(det, probs.transpose(0, 2, 1))
    any_keep = keep.any(-1)
    idx = np.where(any_keep, kept, ends)
    b = np.arange(B)[:, None]
    conf = np.where(any_keep, cmax[b, idx],
                    probs.transpose(0, 2, 1)[b, np.arange(C)[None, :], idx])
    cls = np.broadcast_to(np.arange(C, dtype=np.float64), (B, C))
    return np.concatenate([corners[b, idx], det[b, idx][..., None],
                           conf[..., None], cls[..., None]], -1)
