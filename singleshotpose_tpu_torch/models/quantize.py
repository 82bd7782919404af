"""int8 post-training quantization of the folded serving network.

Mirrors ``singleshotpose_tpu/models/quantize.py``, with the same names and
the same scheme:

- **weights**: per-output-channel symmetric int8, ``sw[c] =
  absmax(w[..., c]) / 127``, ``wq = round(w / sw)``;
- **activations**: static symmetric scales from one calibration forward
  (:func:`calibrate_activations`: the absmax of each conv's input, or a
  percentile of it, or — ``per_channel`` — a vector of per-input-channel
  absmaxes that :func:`quantize_folded` folds into the weights);
- **a block**: ``x → round(x / sa) → int8 conv (int32 sums) → ·scale + b →
  compute dtype → leaky``; the head conv, and any conv whose input
  calibrated to 0, stay in the compute dtype.

The int8 pytree, ``{layer: {"wq", "sw", "sa", "b"}}`` for a quantized conv
and ``{"w", "b"}`` for the others, is the JAX package's: ``wq`` is HWIO int8
as there; a kept conv's ``w`` is the port's folded OIHW in memory and HWIO
in the ``.npz`` artifact (:func:`save_quantized` / :func:`load_quantized`),
so an artifact written by either package serves in the other.

:func:`apply_quantized` is the int8 serving forward, its conv
``ops/int8_conv.int8_conv`` (the hand-written kernel on a card, its plain
twin on the CPU) with the block's epilogue in it: the dequant, the compute
dtype, leaky and, where the next reader is a quantized conv (directly or
through non-live max pools), that conv's quantizer, so the conv writes
int8, the compute dtype, or both (:func:`epilogue_plan`).
:class:`Int8Forward` builds it once for a serving loop, each ``wq``
re-packed for the kernel (C_in padded to a multiple of 4).

Rounding points, read from the optimized HLO of JAX's forms: ``round`` is
half to even in both packages; XLA contracts the dequant ``y·scale + b``
into one FMA (``data.device_augment.fma`` rounds as it does); and where the
scales are compile-time constants — JAX's ``make_serving_fn`` jitted with
the weights closed over — it turns ``x / sa`` into ``x · f32(1/sa)`` and, on
u8 frames with a scalar first scale, folds ``· f32(1/255) · f32(1/sa)`` into
one multiply.  With the scales as jit arguments (JAX's eval driver) it
divides.  ``apply_quantized(scales_as_constants=)`` picks the form.
"""

from __future__ import annotations

from typing import Dict, FrozenSet, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..data.device_augment import fma, recip
from ..ops.int8_conv import (INT8_MAX, Epilogue, int8_conv, pack_weights,
                              round_clip)
from . import layers as L
from .darknet import (ConnectedSpec, ConvSpec, DarknetSpec, MaxPoolSpec,
                      _activate, _conv, _to_nchw, _to_nhwc, _walk,
                      _walk_other)

__all__ = ["calibrate_activations", "quantize_folded", "apply_quantized",
           "default_skip_layers", "save_quantized", "load_quantized",
           "Int8Forward", "EpiloguePlan", "epilogue_plan"]



def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true division on every device, as JAX's eager ops
    divide: on a card PyTorch multiplies by the reciprocal of a Python-scalar
    divisor, so ``d`` goes in as a tensor on ``x``'s device."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def default_skip_layers(spec: DarknetSpec) -> FrozenSet[str]:
    """The layers kept in the compute dtype by default: the head conv,
    whose raw keypoint offsets need more than 8 bits."""
    convs = spec.conv_specs()
    return frozenset({convs[-1].name}) if convs else frozenset()


def _percentile(v: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(v, q)`` of a flat f32 ``v``, linear method, with
    its f32 arithmetic: ``pos = f32(q/100)·(f32(n) − 1)``, the two
    neighbours of the sorted ``v`` weighted by ``pos − floor(pos)``, summed
    as XLA's CPU program sums them (``fma(lo, w_lo, hi·w_hi)``).  Sorted
    with ``torch.sort``: ``torch.quantile`` refuses more than 2^24
    elements."""
    v = torch.sort(v).values
    n = np.float32(v.numel())
    pos = np.float32(np.float32(q) / np.float32(100)) * np.float32(n - 1)
    lo, hi = np.floor(pos), np.ceil(pos)
    hw = np.float32(pos - lo)
    lw = np.float32(1) - hw
    lo, hi = (int(min(max(i, 0), n - 1)) for i in (lo, hi))
    return fma(v[lo], torch.tensor(float(lw)), v[hi] * float(hw))


@torch.no_grad()
def calibrate_activations(spec: DarknetSpec, folded, images: torch.Tensor,
                          *, compute_dtype=torch.bfloat16,
                          percentile: Optional[float] = None,
                          per_channel: bool = False) -> Dict[str, object]:
    """One folded forward over ``images`` (NHWC float in [0, 1]) recording
    each conv input's range: ``{conv_name: float}`` (the absmax, or the
    ``percentile`` of |x|), or with ``per_channel`` ``{conv_name: f32
    (C_in,) numpy}`` (per-input-channel absmax).

    The forward is the JAX calibration's (``quantize.py:97-110``): the
    shared walk with the plain conv — never the serving stem's kernel, which
    rounds a few outputs differently — and the f32 bias added to the conv's
    compute-dtype output with no cast back.  The absmax is the default and
    the percentile measured harmful on this task (the JAX docstring has the
    protocol); per-channel ranges are what ``valid --quantize`` uses."""
    spec.require_one_head("int8 quantization")
    records: Dict[str, torch.Tensor] = {}

    def conv_fn(cspec: ConvSpec, x):
        ax = x.abs().float()
        if per_channel:
            records[cspec.name] = ax.amax(dim=(0, 2, 3))
        elif percentile is None:
            records[cspec.name] = ax.max()
        else:
            records[cspec.name] = _percentile(ax.reshape(-1), percentile)
        p = folded[cspec.name]
        return _conv(cspec, x, p["w"], compute_dtype).float() \
            + L.per_channel(p["b"], x)

    def fc(lspec: ConnectedSpec):
        return folded[lspec.name]["w"], folded[lspec.name]["b"]

    _walk(spec, _to_nchw(images), conv_fn, fc)
    if per_channel:
        return {k: v.cpu().numpy().astype(np.float32)
                for k, v in records.items()}
    return {k: float(v) for k, v in records.items()}


def quantize_folded(spec: DarknetSpec, folded, act_absmax: Dict[str, object],
                    *, skip_layers: Optional[Sequence[str]] = None):
    """Folded f32 params (:func:`~.darknet.fold_batchnorm`) + calibration
    ranges → the int8 pytree, on the folded weights' device.

    A quantized conv carries ``{"wq": HWIO int8, "sw": f32 (C_out,), "sa":
    f32 scalar or, per channel, f32 (C_in,) (already folded into ``wq``,
    kept for the input quantizer), "b": f32 (C_out,)}``; a skipped conv, or
    one whose range is 0, and the connected layers keep ``{"w", "b"}``.
    Per-channel ranges are floored at 1e-3 of their largest, so a dead
    channel cannot blow up the int8 grid.  Every operation is the JAX
    function's eager one, so ``wq``, ``sw`` and ``sa`` are its bits."""
    spec.require_one_head("int8 quantization")
    skip = frozenset(skip_layers) if skip_layers is not None \
        else default_skip_layers(spec)
    out = {}
    for lspec in spec.layers:
        if isinstance(lspec, ConvSpec):
            p = folded[lspec.name]
            amax = act_absmax.get(lspec.name, 0.0)
            per_ch = getattr(amax, "ndim", 0) == 1
            top = float(np.max(amax)) if per_ch else float(amax)
            if lspec.name in skip or top <= 0.0:
                out[lspec.name] = {"w": p["w"], "b": p["b"]}
                continue
            w = p["w"].float().permute(2, 3, 1, 0)          # OIHW → HWIO
            if per_ch:
                a = torch.tensor(np.asarray(amax, np.float32),
                                 device=w.device)
                a = torch.maximum(a, 1e-3 * a.max())
                sa = _div(a, INT8_MAX)
                w = w * sa[None, None, :, None]
            else:
                # JAX: jnp.float32(amax / 127.0), a Python (f64) division
                sa = torch.tensor(np.float32(top / INT8_MAX), device=w.device)
            sw = _div(torch.clamp_min(w.abs().amax(dim=(0, 1, 2)), 1e-12),
                      INT8_MAX)
            wq = round_clip(w / sw)
            out[lspec.name] = {"wq": wq.to(torch.int8).contiguous(),
                               "sw": sw, "sa": sa, "b": p["b"].float()}
        elif isinstance(lspec, ConnectedSpec):
            out[lspec.name] = dict(folded[lspec.name])
    return out


def save_quantized(path: str, qparams) -> None:
    """Write an int8 pytree to ``.npz``, keys ``layer/field``, in the JAX
    package's layouts (HWIO ``wq`` and ``w``, a connected ``w`` as (in,
    out)) — the deployable artifact, loadable by either package."""
    flat = {}
    for layer, d in qparams.items():
        for field, v in d.items():
            a = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
            if field == "w":
                a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
            flat[f"{layer}/{field}"] = a
    np.savez(path, **flat)


def load_quantized(path: str, device=None):
    """Read an ``.npz`` of :func:`save_quantized` (or of the JAX package's
    ``ssp quantize``) into an int8 pytree of tensors on ``device`` (the
    CPU by default), ``w`` back in the port's layouts."""
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    with np.load(path) as z:
        for key in z.files:
            layer, field = key.rsplit("/", 1)
            a = z[key]
            if field == "w":
                a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
            # .copy(): C order (after the transpose), and 0-d stays 0-d
            out.setdefault(layer, {})[field] = torch.from_numpy(
                a.copy()).to(device)
    return out


class _QuantConv:
    """What the int8 forward needs of one quantized conv: its quantizer's
    scale (per channel a (1, C, 1, 1) tensor; scalar, a Python float
    multiplier in the constants form, which a CUDA graph bakes in, else the
    0-d tensor divisor) and the same as the flat f32 tensor a producer's
    epilogue reads (``q_flat``), the dequant scale, the bias and the packed
    weights (C_in padded to a multiple of 4, ``c_pad``), all held here for
    a graph that reads them."""

    def __init__(self, p, constants: bool):
        sa = p["sa"]
        self.per_channel = sa.dim() == 1
        if self.per_channel:
            # per-channel sa is folded into wq: the dequant is sw alone
            self.scale = p["sw"].float().contiguous()
            q = sa.float().reshape(1, -1, 1, 1)
            self.q = 1.0 / q if constants else q
            self.q_flat = self.q.reshape(-1).contiguous()
        else:
            s = np.float32(sa.item())
            self.scale = p["sw"].float() * float(s)
            # a device tensor divisor: a card multiplies by the reciprocal
            # of a Python scalar one
            self.q = recip(s) if constants else sa.float().reshape(())
            self.q_flat = torch.full((1,), self.q, dtype=torch.float32,
                                     device=sa.device) if constants \
                else self.q.reshape(1)
        self.constants = constants
        self.b = p["b"].float().contiguous()
        c_in = int(p["wq"].shape[2])
        self.c_pad = -(-c_in // 4) * 4
        self.wk = pack_weights(p["wq"], c_in=self.c_pad)
        self.ksize = int(p["wq"].shape[0])

    def quantize(self, x: torch.Tensor, pre: Optional[float] = None
                 ) -> torch.Tensor:
        """``clip(round(x / sa), ±127)`` as int8 (``x · (1/sa)`` in the
        constants form); ``pre``: a constant factor of ``x`` that XLA folds
        with a scalar ``1/sa`` into one f32 multiply.  NCHW in, NCHW int8
        out, C_in padded with zero channels to ``c_pad`` (then channels
        last in memory), as the kernel reads it."""
        v = x.float()
        if pre is not None:
            if self.constants and not self.per_channel:
                v = v * float(np.float32(pre) * np.float32(self.q))
                return self._to_int8(v)
            v = v * pre
        v = v * self.q if self.constants else v / self.q
        return self._to_int8(v)

    def _to_int8(self, v: torch.Tensor) -> torch.Tensor:
        r = round_clip(v)
        B, C, H, W = r.shape
        if C == self.c_pad:
            return r.to(torch.int8)
        # the kernel's 4-byte copies: the cast writes into a zeroed NHWC
        # buffer whose extra channels stay 0
        out = torch.zeros((B, H, W, self.c_pad), dtype=torch.int8,
                          device=r.device)
        out[..., :C].copy_(r.permute(0, 2, 3, 1))
        return out.permute(0, 3, 1, 2)

    def conv(self, xq: torch.Tensor, cspec: ConvSpec, compute_dtype
             ) -> torch.Tensor:
        """int8 conv, then ``fma(y, scale, b)`` in f32, then the compute
        dtype: NCHW int8 → NCHW (channels_last memory)."""
        return self.conv_fused(xq, cspec, compute_dtype, "linear", None,
                               True)[0]

    def conv_fused(self, xq: torch.Tensor, cspec: ConvSpec, compute_dtype,
                   activation: str, consumer: Optional["_QuantConv"],
                   value: bool):
        """The int8 conv with its epilogue: the dequant, the compute dtype,
        ``activation`` (in the kernel when leaky or linear), and with a
        ``consumer`` that conv's quantizer.  Returns (the compute-dtype
        output or None unless ``value``, the consumer's int8 input or
        None), NCHW views of NHWC memory.  ``xq`` carries ``c_pad``
        channels, as :meth:`quantize` writes them."""
        fused = activation in _FUSED_ACTIVATIONS
        ep = Epilogue(self.scale, self.b, dtype=compute_dtype,
                      leaky=fused and activation == "leaky",
                      quant=None if consumer is None else consumer.q_flat,
                      divide=consumer is not None and not consumer.constants,
                      value=value or consumer is None)
        y, yq = int8_conv(xq.permute(0, 2, 3, 1).contiguous(), self.wk,
                          self.ksize, cspec.stride, cspec.pad, epilogue=ep)
        if y is not None:
            y = y.permute(0, 3, 1, 2)
            if not fused:
                y = _activate(y, activation)
        return y, None if yq is None else yq.permute(0, 3, 1, 2)


# the activations the int8 conv's epilogue computes
_FUSED_ACTIVATIONS = ("leaky", "linear")


class EpiloguePlan(NamedTuple):
    """What a quantized conv's epilogue writes: ``consumer``, the quantized
    conv whose int8 input it also writes (directly, or through non-live max
    pools), or None; ``value``, whether it writes the compute-dtype output
    (anything else reads it: a route, a reorg, a float conv, the head)."""

    consumer: Optional[str]
    value: bool

    @property
    def writes(self) -> str:
        """"int8", "compute" or "both"."""
        if self.consumer is None:
            return "compute"
        return "both" if self.value else "int8"


def _pool_consumer(spec: DarknetSpec, quantized, i: int) -> Optional[str]:
    """The quantized conv at the end of the run of non-live max pools
    starting at layer ``i``, if there is one."""
    layers, j = spec.layers, i
    while j < len(layers) and isinstance(layers[j], MaxPoolSpec):
        if j in spec._live:
            return None
        j += 1
    if j < len(layers) and isinstance(layers[j], ConvSpec) \
            and layers[j].name in quantized:
        return layers[j].name
    return None


def epilogue_plan(spec: DarknetSpec, quantized) -> Dict[str, EpiloguePlan]:
    """For each conv in ``quantized`` (names), what its epilogue writes:
    the int8 input of the quantized conv that alone reads it next (the next
    layer, or the end of a run of non-live max pools — quantizing before
    the pools is bit-exact, the quantizer being monotone), the compute
    dtype where anything else reads it (a later route re-reads a live
    layer), or both.  A conv whose activation the epilogue does not compute
    writes the compute dtype only."""
    layers, plan = spec.layers, {}
    for i, lspec in enumerate(layers):
        if not isinstance(lspec, ConvSpec) or lspec.name not in quantized:
            continue
        consumer = None
        nxt = layers[i + 1] if i + 1 < len(layers) else None
        if lspec.activation in _FUSED_ACTIVATIONS \
                and lspec.filters % 4 == 0:
            if isinstance(nxt, ConvSpec) and nxt.name in quantized:
                consumer = nxt.name
            elif isinstance(nxt, MaxPoolSpec):
                consumer = _pool_consumer(spec, quantized, i + 1)
        plan[lspec.name] = EpiloguePlan(
            consumer, consumer is None or i in spec._live)
    return plan


class Int8Forward:
    """The int8 serving forward of one int8 pytree (its tensors on the
    device it serves on), built once: each quantized conv's scales (a
    scalar ``sa`` read to the host here, so a CUDA graph of the call bakes
    it in) and re-packed weights, and the epilogue plan
    (:func:`epilogue_plan`), are held by this object, which a serving
    closure keeps alive.  Calling it is :func:`apply_quantized`."""

    def __init__(self, spec: DarknetSpec, qparams, *,
                 scales_as_constants: bool = False):
        spec.require_one_head("the int8 forward")
        self.spec, self.qparams = spec, qparams
        self.convs = {l.name: _QuantConv(qparams[l.name], scales_as_constants)
                      for l in spec.layers if isinstance(l, ConvSpec)
                      and "wq" in qparams[l.name]}
        self.plan = epilogue_plan(spec, self.convs)

    def __call__(self, images: torch.Tensor, *, compute_dtype=torch.bfloat16,
                 input_scale: Optional[float] = None) -> torch.Tensor:
        spec, qparams, convs = self.spec, self.qparams, self.convs
        layers = spec.layers

        def fc(lspec: ConnectedSpec):
            return qparams[lspec.name]["w"], qparams[lspec.name]["b"]

        x = _to_nchw(images)
        xq, xq_for = None, None     # int8 x, quantized for the conv xq_for
        if input_scale is not None:
            first = layers[0] if layers else None
            if isinstance(first, ConvSpec) and first.name in convs:
                xq = convs[first.name].quantize(x, input_scale)
                xq_for = first.name
            else:
                x = x * input_scale
        cache: Dict[int, torch.Tensor] = {}
        for i, lspec in enumerate(layers):
            if isinstance(lspec, ConvSpec):
                if lspec.name in convs:
                    q = convs[lspec.name]
                    if xq is None or xq_for != lspec.name:
                        xq = q.quantize(x)
                    consumer, value = self.plan[lspec.name]
                    x, xq = q.conv_fused(xq, lspec, compute_dtype,
                                         lspec.activation,
                                         convs.get(consumer), value)
                    xq_for = consumer
                else:
                    p = qparams[lspec.name]
                    x = _conv(lspec, x, p["w"], compute_dtype).float() \
                        + L.per_channel(p["b"], x)
                    x = _activate(x, lspec.activation)
                    xq = None
            elif isinstance(lspec, MaxPoolSpec):
                if xq is None:
                    hit = _pool_consumer(spec, convs, i)
                    if hit is not None:
                        xq, xq_for = convs[hit].quantize(x), hit
                pool = (lambda a: L.max_pool(a, lspec.size, lspec.stride)) \
                    if lspec.stride > 1 else L.max_pool_stride1
                if xq is not None:
                    xq, x = pool(xq), None
                else:
                    x = pool(x)
            else:
                x = _walk_other(spec, lspec, i, x, cache, fc)
                xq = None
            if i in spec._live:
                cache[i] = x
        return _to_nhwc(x)


def apply_quantized(spec: DarknetSpec, qparams, images: torch.Tensor, *,
                    compute_dtype=torch.bfloat16,
                    scales_as_constants: bool = False,
                    input_scale: Optional[float] = None) -> torch.Tensor:
    """The int8 serving forward: NHWC float images → the raw head, NHWC,
    as :func:`~.darknet.apply_folded` returns it.  Layers without ``wq``
    run in ``compute_dtype`` (the conv output plus the f32 bias, not cast
    back, as ``quantize.py:240`` adds it).

    Max pool commutes with the monotone quantizer, so a run of pools in
    front of a quantized conv quantizes *before* the pools and pools int8
    (``models.layers.max_pool`` on integers), unless a later route re-reads
    a pooled output (the liveness bail).  Route and reorg run through the
    port's ``_walk_other``.

    ``scales_as_constants``: the rounding of JAX's serve compiled with the
    weights closed over (``x · f32(1/sa)``), else of its eval driver
    (``x / sa``).  ``input_scale``: ``images`` are raw values (u8 frames as
    floats) to be scaled by this f32 constant first — folded with a scalar
    first-layer ``1/sa`` in the constants form, as XLA folds it.  A serving
    loop builds :class:`Int8Forward` once instead."""
    return Int8Forward(spec, qparams, scales_as_constants=scales_as_constants)(
        images, compute_dtype=compute_dtype, input_scale=input_scale)
