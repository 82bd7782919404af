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

from .models.darknet import ConnectedSpec, ConvSpec, Darknet, DarknetSpec

__all__ = ["WeightsHeader", "load_weights", "load_weights_until_last",
           "save_weights", "resume_counters", "params_from_jax",
           "train_state_from_jax"]

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


def _layer_entries(spec: DarknetSpec, skip_last_blocks: int = 0,
                   cutoff: int = 0):
    """(state-dict key, shape) in darknet file order, over the spec's layers
    but its last ``skip_last_blocks``, or over its first ``cutoff`` layers
    when ``cutoff`` > 0."""
    layers = spec.layers[:cutoff] if cutoff > 0 else \
        spec.layers[:len(spec.layers) - skip_last_blocks]
    for lspec in layers:
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


def _load(spec: DarknetSpec, path: str,
          skip_last_blocks: int) -> Tuple[WeightsHeader, State]:
    with open(path, "rb") as fp:
        header = WeightsHeader(np.fromfile(fp, count=4, dtype=np.int32))
        buf = np.fromfile(fp, dtype=np.float32)
    state: State = {}
    start = 0
    for key, shape in _layer_entries(spec, skip_last_blocks):
        n = int(np.prod(shape))
        if start + n > buf.size:
            break
        state[key] = torch.from_numpy(buf[start:start + n].reshape(shape).copy())
        start += n
    return header, state


def load_weights(spec: DarknetSpec, path: str) -> Tuple[WeightsHeader, State]:
    """Load a reference ``.weights`` file → (header, state dict for
    :class:`Darknet`).  Tensors are f32 CPU copies of the file's bytes.  A
    file shorter than the net yields the entries it holds in full."""
    return _load(spec, path, 0)


def load_weights_until_last(spec: DarknetSpec, path: str,
                            generator: Optional[torch.Generator] = None
                            ) -> Tuple[WeightsHeader, State]:
    """Backbone-only load (``singleshotpose_tpu/weights.py:118-135``): read
    the file over every layer but the last two blocks (the head conv and the
    region block), so an ImageNet backbone such as
    ``darknet19_448.conv.23`` initializes a pose net; every entry the file
    does not cover comes from a fresh :class:`Darknet` drawn from
    ``generator`` (seed 0 when None).  Returns (header, a full state dict)."""
    header, loaded = _load(spec, path, 2)
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    state = Darknet(spec, generator=gen).state_dict()
    state.update(loaded)
    return header, state


def save_weights(spec: DarknetSpec, state: State, path: str,
                 seen: int = 0, header: Optional[WeightsHeader] = None,
                 cutoff: int = 0) -> None:
    """Write darknet binary format from a :class:`Darknet` state dict
    (``singleshotpose_tpu/weights.py:138``): ``header``'s four values (zeros
    when None) with ``seen`` in place of its last, then the layers.
    ``cutoff`` counts *blocks after [net]* like the reference's
    ``save_weights(cutoff)``; 0 ⇒ all layers."""
    hdr = WeightsHeader(None if header is None else header.values)
    hdr.seen = seen
    with open(path, "wb") as fp:
        hdr.values.tofile(fp)
        for key, shape in _layer_entries(spec, cutoff=cutoff):
            t = state[key].detach().to("cpu", torch.float32)
            if tuple(t.shape) != shape:
                raise ValueError(f"{key}: shape {tuple(t.shape)} != {shape}")
            np.ascontiguousarray(t.numpy()).tofile(fp)


def params_from_jax(spec: DarknetSpec, params, batch_stats=None) -> State:
    """The JAX package's ``(params, batch_stats)`` — numpy HWIO dicts as
    ``DarknetSpec.init_params`` or ``singleshotpose_tpu.weights.load_weights``
    give them — → this package's state dict, so both compute one function.
    Without ``batch_stats`` the running statistics are left out."""
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
                if batch_stats is not None:
                    put(f"{n}.running_mean", batch_stats[n]["mean"])
                    put(f"{n}.running_var", batch_stats[n]["var"])
            else:
                put(f"{n}.bias", p["b"])
        elif isinstance(lspec, ConnectedSpec):
            p, n = params[lspec.name], lspec.name
            put(f"{n}.weight", np.asarray(p["w"]).T)
            put(f"{n}.bias", p["b"])
    return state


def resume_counters(header: WeightsHeader, batch_size: int,
                    nsamples: int) -> Tuple[int, int]:
    """(processed_batches, init_epoch) from the header's ``seen``, as the
    reference derives them on resume (``train.py:343-346``)."""
    if nsamples <= 0:
        return 0, 0
    return header.seen // batch_size, header.seen // nsamples


def train_state_from_jax(spec: DarknetSpec, params, batch_stats, momentum,
                         seen: int, *, weight_decay: float,
                         momentum_coef: float, device=None):
    """The JAX package's train state — ``params``, ``batch_stats``, the SGD
    ``momentum`` pytree (same structure as ``params``) and ``seen``, as
    numpy — → this package's :class:`~.training.TrainState` on ``device``:
    the model, an SGD optimizer whose momentum buffers hold ``momentum``
    (OIHW like the weights), and ``seen``.  Both packages then continue one
    trajectory from the same state."""
    from .training import init_train_state

    model = Darknet(spec, device=device)
    model.load_state_dict(params_from_jax(spec, params, batch_stats))
    state = init_train_state(model, weight_decay=weight_decay,
                             momentum=momentum_coef, seen=int(seen))
    # the momentum pytree has the params' structure, so the same mapping
    bufs = params_from_jax(spec, momentum)
    for name, p in model.named_parameters():
        state.optimizer.state[p]["momentum_buffer"] = bufs[name].to(p.device)
    return state
