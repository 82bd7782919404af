"""The cell's box pick (``ops/decode.best_boxes`` or
``best_boxes_per_class``) on one batch's decoded head: device ms a call,
CUDA events around 20 calls."""


def read(r):
    if r.get("kind") != "serve":
        return None
    return r.get("pick_ms")
