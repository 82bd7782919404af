"""The benchmark's own operation and byte counts, from a configuration's
darknet blocks and a cell's shapes, and the H100's published peaks.

Nothing here reads the program: the layer list is the configuration file's
own copy of the cfg, and the kernels' bytes are counted from the shapes the
kernels take (each input byte read once, each output byte written once).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def _ints(s: str) -> List[int]:
    return [int(v) for v in str(s).replace(" ", "").split(",") if v]


def layer_shapes(blocks: Sequence[Dict[str, str]], height: int,
                 width: int) -> List[Tuple[str, Dict[str, int]]]:
    """Walk the cfg's layers (every block after ``[net]``) on a (height,
    width, 3) input: for each layer its type and its input and output
    (channels, height, width); a conv also its kernel size and stride."""
    c, h, w = 3, height, width
    outs: List[Tuple[int, int, int]] = []
    layers = []
    for i, b in enumerate(blocks[1:]):
        kind = b["type"]
        info = {"c_in": c, "h_in": h, "w_in": w}
        if kind == "convolutional":
            k, s = int(b["size"]), int(b.get("stride", 1))
            pad = k // 2 if int(b.get("pad", 0)) else 0
            h = (h + 2 * pad - k) // s + 1
            w = (w + 2 * pad - k) // s + 1
            c = int(b["filters"])
            info.update(size=k, stride=s)
        elif kind == "maxpool":
            s = int(b["stride"])
            if s > 1:
                h, w = h // s, w // s
        elif kind == "reorg":
            s = int(b["stride"])
            c, h, w = c * s * s, h // s, w // s
        elif kind == "route":
            srcs = [j if j >= 0 else i + j for j in _ints(b["layers"])]
            c = sum(outs[j][0] for j in srcs)
            h, w = outs[srcs[0]][1], outs[srcs[0]][2]
        elif kind != "region":
            raise ValueError(f"layer type {kind!r} is not counted")
        info.update(c_out=c, h_out=h, w_out=w)
        outs.append((c, h, w))
        layers.append((kind, info))
    return layers


def conv_flops_per_frame(blocks: Sequence[Dict[str, str]], height: int,
                         width: int) -> int:
    """2·k²·C_in·C_out·H_out·W_out summed over every conv, the head's too:
    the forward's multiply-adds of one frame."""
    return sum(2 * i["size"] ** 2 * i["c_in"] * i["c_out"] * i["h_out"]
               * i["w_out"] for kind, i in layer_shapes(blocks, height, width)
               if kind == "convolutional")


def conv_weights(blocks: Sequence[Dict[str, str]]) -> int:
    """The convs' weight count (k²·C_in·C_out), independent of the size."""
    return sum(i["size"] ** 2 * i["c_in"] * i["c_out"]
               for kind, i in layer_shapes(blocks, 32, 32)
               if kind == "convolutional")


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over ``peak``."""
    return max(nbytes / HBM_BYTES_PER_S, flops / peak)


_STEM_W = 32 * 3 * 3 * 3          # the stem conv's weights, OIHW
_STEM_C = 32


def k1_bound_s(B: int, H: int, W: int) -> float:
    """K1, the serving stem (conv 3→32 3×3, bias, leaky, 2×2/2 pool): its
    f32 (B, H, W, 3) input, f32 weights and bias read once, its bf16
    (B, H/2, W/2, 32) output written once; the conv's operations at the
    bf16 tensor-core rate."""
    nbytes = 4 * B * H * W * 3 + 4 * (_STEM_W + _STEM_C) \
        + 2 * B * (H // 2) * (W // 2) * _STEM_C
    return bound_s(nbytes, 2 * 27 * _STEM_C * B * H * W, BF16_FLOPS)
