"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the JAX
package takes the numpy HWIO parameter dicts as they are, the port takes
them through ``weights.params_from_jax``.
"""

import numpy as np
import torch

# 6 xdist workers share 8 cores; torch would start 8 threads in each
torch.set_num_threads(2)

TINY_BLOCKS = [
    {"type": "net", "batch": "2", "channels": "3", "height": "64",
     "width": "64", "test_width": "64", "test_height": "64"},
    # the serving-stem pattern: conv 3x3 3->32 + BN + leaky, then 2x2/2 pool
    {"type": "convolutional", "batch_normalize": "1", "filters": "32",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "16",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "32",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "32",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "64",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "1"},
    {"type": "route", "layers": "-4"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "8",
     "size": "1", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "reorg", "stride": "2"},
    {"type": "route", "layers": "-1,-4"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "32",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "convolutional", "batch_normalize": "0", "filters": "20",
     "size": "1", "stride": "1", "pad": "1", "activation": "linear"},
    {"type": "region", "anchors": "", "classes": "1", "coords": "18",
     "num": "1"},
]


def _cfg_text(blocks):
    return "\n".join(
        "[{}]\n{}\n".format(b["type"], "\n".join(
            f"{k}={v}" for k, v in b.items() if k != "type"))
        for b in blocks)


TINY_CFG = _cfg_text(TINY_BLOCKS)

# yolo-pose-multi.cfg's 5 anchors (zoo.MULTI_ANCHORS)
MULTI_ANCHORS = (1.4820, 2.2412, 2.0501, 3.1265, 2.3946, 4.6891, 3.1018,
                 3.9910, 3.4879, 5.8851)

# the tiny net with the multi-object head: 13 classes, 5 anchors,
# 5·(2·9 + 1 + 13) = 160 filters
TINY_MULTI_BLOCKS = [dict(b) for b in TINY_BLOCKS]
TINY_MULTI_BLOCKS[-2]["filters"] = "160"
TINY_MULTI_BLOCKS[-1].update(
    classes="13", num="5",
    anchors=", ".join(f"{a:.4f}" for a in MULTI_ANCHORS))
TINY_MULTI_CFG = _cfg_text(TINY_MULTI_BLOCKS)


def jax_params(spec, seed=0):
    """Random (params, batch_stats) in the JAX package's numpy HWIO form,
    with non-trivial BN affine terms and running statistics.  Weights are
    He-scaled so activations stay O(1) through the net."""
    rng = np.random.RandomState(seed)
    params, stats = {}, {}
    for l in spec.conv_specs():
        fan_in = l.in_filters * l.size * l.size
        p = {"w": (rng.randn(l.size, l.size, l.in_filters, l.filters)
                   * np.sqrt(2.0 / fan_in)).astype(np.float32)}
        n = l.filters
        if l.batch_normalize:
            p["scale"] = rng.uniform(0.5, 1.5, n).astype(np.float32)
            p["bias"] = (rng.randn(n) * 0.1).astype(np.float32)
            stats[l.name] = {
                "mean": (rng.randn(n) * 0.1).astype(np.float32),
                "var": rng.uniform(0.5, 1.5, n).astype(np.float32)}
        else:
            p["b"] = (rng.randn(n) * 0.1).astype(np.float32)
        params[l.name] = p
    return params, stats


def port_folded(jf):
    """JAX's folded HWIO dict → the port's OIHW one, the same bits."""
    return {k: {"w": torch.from_numpy(np.asarray(v["w"]).transpose(3, 2, 0, 1)
                                      .copy()),
                "b": torch.from_numpy(np.asarray(v["b"]).copy())}
            for k, v in jf.items()}


def port_q(jq):
    """A JAX int8 pytree → the port's: the same fields, ``w`` as OIHW."""
    out = {}
    for k, d in jq.items():
        out[k] = {f: torch.from_numpy(np.array(v)) for f, v in d.items()}
        if "w" in out[k]:
            out[k]["w"] = out[k]["w"].permute(3, 2, 0, 1).contiguous()
    return out


# K2's valid-slot patterns: one slot (single-object LINEMOD), eight, all of
# them, a scattered mask that is no prefix, and one image with none beside
# full ones ("prefix<n>" takes any n: a synthesized OCCLUSION frame has up
# to 9, an eggbox scene)
K2_PATTERNS = ["prefix1", "prefix8", "all", "scattered", "one_empty"]


def k2_valid(pattern, B, G, rng):
    """(B, G) bool slot validity of one of K2_PATTERNS."""
    valid = np.zeros((B, G), bool)
    if pattern.startswith("prefix"):
        valid[:, :int(pattern[len("prefix"):])] = True
    elif pattern == "all":
        valid[:] = True
    elif pattern == "scattered":
        valid = rng.rand(B, G) < 0.3
        valid[:, 0] = False                 # no prefix: slot 0 always empty
        valid[:, 37 % G] = True
    else:                                   # one_empty
        valid[1:] = True
    return valid


def k2_inputs(valid, S, rng, K=9):
    """f32 GT slots (B, G, 2K) and predictions (B, S, 2K) near one valid
    slot of each cell's image (any slot where the image has none), so the
    max spreads over (0, 1)."""
    B, G = valid.shape
    gt = rng.uniform(0.1, 0.9, (B, G, 2 * K)).astype(np.float32)
    pick = np.empty((B, S), np.int64)
    for b in range(B):
        slots = np.flatnonzero(valid[b]) if valid[b].any() else np.arange(G)
        pick[b] = rng.choice(slots, S)
    near = gt[np.arange(B)[:, None], pick]
    pred = (near + rng.randn(B, S, 2 * K) * 0.03).astype(np.float32)
    return gt, pred


def rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))
