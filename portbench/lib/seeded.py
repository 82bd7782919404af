"""Everything a run makes from its ``--seed``: the sub-seeds, the network's
raw weights (on the device, in a few large draws) and the serve cells'
frames (in pageable host memory, as a decoder hands them over).

The same seed gives the same inputs; both the program and the reference
are handed them.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from ..reference.darknet import parse

# one child seed a purpose, in this order
PURPOSES = ("weights", "frames", "order", "loader", "sample")


def sub_seeds(seed: int) -> Dict[str, int]:
    """Independent 63-bit seeds for each purpose, from any whole ``seed``."""
    ss = np.random.SeedSequence(abs(int(seed)))
    return {p: int(c.generate_state(1, np.uint64)[0] >> np.uint64(1))
            for p, c in zip(PURPOSES, ss.spawn(len(PURPOSES)))}


def raw_weights(blocks: Sequence[dict], seed: int,
                device) -> Dict[str, torch.Tensor]:
    """The network's raw parameters and BN statistics, keyed
    ``conv_<n>.<tensor>``, float32 on ``device``, from a generator on that
    device: every conv weight from one draw, U(±√(6/fan_in)) under BN (the
    leaky ReLU's variance-keeping bound) and U(±1/√fan_in) on the linear
    head with its bias; every BN vector from a second draw, scale in
    [0.8, 1.2], bias and running mean in [−0.1, 0.1], running variance in
    [0.8, 1.2]."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    convs, c_in = [], 3
    outs = []
    for l, b in zip(parse(blocks), blocks[1:]):
        if l["kind"] == "conv":
            c_out = int(b["filters"])
            convs.append((l, c_in, c_out))
            c_in = c_out
        elif l["kind"] == "route":
            c_in = sum(outs[j] for j in l["src"])
        elif l["kind"] == "reorg":
            c_in *= l["stride"] ** 2
        outs.append(c_in)
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


def frame_pool(seed: int, n: int, batch: int, height: int,
               width: int, cell: int = 32) -> np.ndarray:
    """``n`` distinct batches of u8 frames (n, batch, height, width, 3), in
    pageable host memory: each frame three parts a blocky pattern of
    ``cell``-pixel squares (the network's output stride, so every frame
    and every output cell sees its own content) and one part pixel noise."""
    rng = np.random.default_rng(seed)
    shape = (n, batch, height, width, 3)
    fine = np.frombuffer(rng.bytes(int(np.prod(shape))), np.uint8)
    coarse = np.frombuffer(rng.bytes(n * batch * (height // cell)
                                     * (width // cell) * 3), np.uint8)
    coarse = coarse.reshape(n, batch, height // cell, 1, width // cell, 1, 3)
    out = np.empty(shape, np.uint16)
    out.reshape(n, batch, height // cell, cell, width // cell, cell, 3)[:] = \
        coarse * np.uint16(3)
    out += fine.reshape(shape)
    return (out >> 2).astype(np.uint8)
