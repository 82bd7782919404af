"""Darknet binary ``.weights`` ⇄ :class:`Darknet` state dict (bit-exact).

Mirrors ``singleshotpose_tpu/weights.py``.  Format: a header of 4 × int32
(``header[3]`` = the ``seen`` sample counter), then a flat float32 buffer
consumed per layer in block order:

* conv + BN: ``[bn.bias, bn.scale, running_mean, running_var, weight(OIHW)]``
* conv:      ``[bias, weight(OIHW)]``
* connected: ``[bias, weight(out × in)]``

Darknet stores conv weights OIHW, which is this package's layout, so the
codec is a pure reshape: no transpose, no arithmetic.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .models.darknet import ConnectedSpec, ConvSpec, DarknetSpec

__all__ = ["WeightsHeader", "load_weights", "save_weights", "params_from_jax"]

State = Dict[str, torch.Tensor]


class WeightsHeader:
    """The 4-int32 darknet header; ``seen`` is header[3]."""

    def __init__(self, values: Optional[np.ndarray] = None):
        self.values = np.zeros(4, dtype=np.int32) if values is None else \
            np.asarray(values, dtype=np.int32).copy()
        if self.values.shape != (4,):
            raise ValueError(f"darknet header has 4 int32, got {self.values.shape}")

    @property
    def seen(self) -> int:
        return int(self.values[3])

    @seen.setter
    def seen(self, v: int) -> None:
        self.values[3] = v


def _conv_keys(spec: ConvSpec) -> Tuple[str, ...]:
    """State-dict keys of one conv, in darknet file order (weight last)."""
    n = spec.name
    if spec.batch_normalize:
        return (f"{n}.bias", f"{n}.scale", f"{n}.running_mean",
                f"{n}.running_var", f"{n}.weight")
    return (f"{n}.bias", f"{n}.weight")


def _layer_entries(spec: DarknetSpec):
    """(state-dict key, shape) in darknet file order."""
    for lspec in spec.layers:
        if isinstance(lspec, ConvSpec):
            keys = _conv_keys(lspec)
            for k in keys[:-1]:
                yield k, (lspec.filters,)
            yield keys[-1], (lspec.filters, lspec.in_filters, lspec.size,
                             lspec.size)
        elif isinstance(lspec, ConnectedSpec):
            yield f"{lspec.name}.bias", (lspec.out_features,)
            yield f"{lspec.name}.weight", (lspec.out_features,
                                           lspec.in_features)


def load_weights(spec: DarknetSpec, path: str) -> Tuple[WeightsHeader, State]:
    """Load a reference ``.weights`` file → (header, state dict for
    :class:`Darknet`).  Tensors are f32 CPU copies of the file's bytes.  A
    file shorter than the net yields the entries it holds in full."""
    with open(path, "rb") as fp:
        header = WeightsHeader(np.fromfile(fp, count=4, dtype=np.int32))
        buf = np.fromfile(fp, dtype=np.float32)
    state: State = {}
    start = 0
    for key, shape in _layer_entries(spec):
        n = int(np.prod(shape))
        if start + n > buf.size:
            break
        state[key] = torch.from_numpy(buf[start:start + n].reshape(shape).copy())
        start += n
    return header, state


def save_weights(spec: DarknetSpec, state: State, path: str,
                 seen: int = 0) -> None:
    """Write darknet binary format from a :class:`Darknet` state dict, with
    ``seen`` in the header."""
    hdr = WeightsHeader()
    hdr.seen = seen
    with open(path, "wb") as fp:
        hdr.values.tofile(fp)
        for key, shape in _layer_entries(spec):
            t = state[key].detach().to("cpu", torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}: shape {tuple(t.shape)} != {shape}")
            np.ascontiguousarray(t.numpy()).tofile(fp)


def params_from_jax(spec: DarknetSpec, params, batch_stats) -> State:
    """The JAX package's ``(params, batch_stats)`` — numpy HWIO dicts as
    ``DarknetSpec.init_params`` or ``singleshotpose_tpu.weights.load_weights``
    give them — → this package's state dict, so both compute one function."""
    state: State = {}

    def put(key, a):
        state[key] = torch.from_numpy(np.array(a, dtype=np.float32, copy=True))

    for lspec in spec.layers:
        if isinstance(lspec, ConvSpec):
            p, n = params[lspec.name], lspec.name
            put(f"{n}.weight", np.asarray(p["w"]).transpose(3, 2, 0, 1))
            if lspec.batch_normalize:
                put(f"{n}.scale", p["scale"])
                put(f"{n}.bias", p["bias"])
                put(f"{n}.running_mean", batch_stats[n]["mean"])
                put(f"{n}.running_var", batch_stats[n]["var"])
            else:
                put(f"{n}.bias", p["b"])
        elif isinstance(lspec, ConnectedSpec):
            p, n = params[lspec.name], lspec.name
            put(f"{n}.weight", np.asarray(p["w"]).T)
            put(f"{n}.bias", p["b"])
    return state
