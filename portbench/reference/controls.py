"""The controls: stand-ins for the program's objects, computed in the
precision below the one the configuration states (bfloat16), which the
comparison has to find not correct.

``fp8``: the plain reference in the program's place, every conv's input and
weight rounded to float8 e4m3 after a per-tensor scale to its largest
magnitude, the products accumulated in float32.
The program's own int8 serve, the other control of a serve cell, is made
in ``portbench/control.py``: nothing of the program is imported here.
"""

from __future__ import annotations

import torch

from . import darknet as ref


def fp8(t: torch.Tensor) -> torch.Tensor:
    """A conv operand rounded to float8 e4m3 at a per-tensor scale that
    maps its largest magnitude to the format's largest, back in f32."""
    dtype = torch.float8_e4m3fn
    top = torch.finfo(dtype).max / t.abs().amax().clamp_min(1e-30)
    return (t * top).to(dtype).float() / top


def fp8_serve(parts: dict):
    """The reference's serve in fp8: u8 frames → the cell's boxes, on the
    frames' device."""
    cfg_layers = ref.parse(parts["blocks"])
    reg = ref.region(cfg_layers)
    folded = ref.fold(cfg_layers, parts["raw"])
    device = parts["raw"][next(iter(parts["raw"]))].device

    @torch.no_grad()
    def serve(images):
        frames = torch.as_tensor(images).to(device)
        head = ref.forward_folded(cfg_layers, folded, frames, quant=fp8)
        grid = ref.decode(head, reg["keypoints"], reg["classes"], reg["num"])
        boxes = ref.picks(*grid, parts["pick"])
        return torch.from_numpy(boxes).float().to(device)

    return serve


def stand_in(kind: str, name: str, ctx, build, parts: dict):
    """The control's object in place of the program's ``name``."""
    parts = dict(parts, blocks=ctx.config["cfg"])
    if kind == "fp8" and name == "serve":
        return fp8_serve(parts)
    raise ValueError(f"no {kind} stand-in for the program's {name}")
