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

TINY_CFG = "\n".join(
    "[{}]\n{}\n".format(b["type"], "\n".join(
        f"{k}={v}" for k, v in b.items() if k != "type"))
    for b in TINY_BLOCKS)


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


def rel_err(got, ref):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    return float(np.abs(got - ref).max() / (np.abs(ref).max() + 1e-12))
