"""A tiny network and cells for the CPU tests: the serve runner driven end
to end on the CPU (the program's plain versions of its kernels), with the
program's objects optionally replaced by broken ones."""

from __future__ import annotations

import json
import os

import torch

from portbench.lib import harness

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ANCHORS = "1.4820, 2.2412, 2.0501, 3.1265, 2.3946, 4.6891, 3.1018, 3.9910, " \
    "3.4879, 5.8851"


def _json(*parts):
    with open(os.path.join(PKG, *parts)) as f:
        return json.load(f)


def _conv(f, k, bn=True, act="leaky"):
    return {"type": "convolutional", "batch_normalize": str(int(bn)),
            "filters": str(f), "size": str(k), "stride": "1", "pad": "1",
            "activation": act}


def blocks(multi: bool):
    """The real net's [net] block and kinds of layer — the fused stem's
    conv and pool, 3×3 and 1×1 convs, a route, a reorg and a concatenating
    route, a linear head, the region — at a few channels, 18 convs deep
    (the real one is 23), so that rounding builds up as it does there."""
    cfg = _json("configs", "yolo_pose_multi.json" if multi
                else "yolo_pose_single.json")["cfg"]
    C, nA = (13, 5) if multi else (1, 1)
    mp = {"type": "maxpool", "size": "2", "stride": "2"}
    deep = [_conv(32, 3) if i % 2 else _conv(16, 1) for i in range(10)]
    return [cfg[0], _conv(32, 3), mp, _conv(16, 3), mp, _conv(32, 3), mp,
            *deep, _conv(32, 3), {"type": "route", "layers": "-13"},
            _conv(8, 1),
            {"type": "reorg", "stride": "2"},
            {"type": "route", "layers": "-1,-4"}, _conv(32, 3),
            _conv(nA * (2 * 9 + 1 + C), 1, False, "linear"),
            {"type": "region", "anchors": ANCHORS if multi else "",
             "classes": str(C), "coords": "18", "num": str(nA)}]


CELLS = {
    "serve": ("serve-b8-672-best", False, dict(batch=2, size=160,
                                                 pool_batches=3,
                                                 warmup_calls=2)),
    "serve_multi": ("serve-b16-416-per_class", True,
                    dict(batch=4, size=160, pool_batches=3, warmup_calls=2)),
}


def cell(kind: str) -> harness.Cell:
    """The cell's traffic at a tiny batch and size, over the tiny net."""
    traffic, multi, small = CELLS[kind]
    c = harness.Cell.__new__(harness.Cell)
    c.bench = {"end_to_end": [], "per_layer": []}
    c.name, c.root, c.entry = f"tiny-{kind}", os.path.dirname(PKG), \
        {"chips": 1}
    c.config = {"cfg": blocks(multi)}
    c.traffic = dict(_json("traffic", f"{traffic}.json"), **small)
    return c


class Context(harness.Context):
    """A CPU run whose program objects pass through ``breaks[name]``."""

    def __init__(self, c, breaks=None, seed: int = 2 ** 31 + 11,
                 seconds: float = 1.0):
        super().__init__(c, seed=seed, seconds=seconds, trace=False,
                         device=torch.device("cpu"),
                         t_process=harness.process_start())
        self.breaks = breaks or {}

    def program(self, name, build, **parts):
        obj = build()
        fault = self.breaks.get(name)
        return obj if fault is None else fault(obj, parts)


def run(kind: str, breaks=None, **kw) -> dict:
    torch.set_num_threads(2)
    c = cell(kind)
    return c.runner().run(Context(c, breaks, **kw))
