"""The fp8 control of a net with several heads: the plain reference
(``darknet_heads``) in the program's place, every conv's input and weight
rounded to float8 e4m3 at a per-tensor scale (``controls.fp8``), the
products accumulated in float32 — the precision below the configuration's
bfloat16, which the comparison has to find not correct."""

from __future__ import annotations

import torch

from . import darknet_heads as ref
from .controls import fp8


def fp8_serve(parts: dict):
    """The reference's serve in fp8: u8 frames → the cell's boxes, on the
    frames' device."""
    layers = ref.parse(parts["blocks"])
    folded = ref.fold(layers, parts["raw"])
    K = int(parts["blocks"][0]["num_keypoints"])
    device = parts["raw"][next(iter(parts["raw"]))].device

    @torch.no_grad()
    def serve(images):
        frames = torch.as_tensor(images).to(device)
        grid = ref.grid(layers, folded, frames, K, quant=fp8)
        boxes = ref.picks(*grid, parts["pick"])
        return torch.from_numpy(boxes).float().to(device)

    return serve


def stand_in(kind: str, name: str, ctx, build, parts: dict):
    """The control's object in place of the program's ``name``."""
    if kind == "fp8" and name == "serve":
        return fp8_serve(dict(parts, blocks=ctx.config["cfg"]))
    raise ValueError(f"no {kind} stand-in for the program's {name}")
