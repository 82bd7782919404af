"""PyTorch port vs the JAX package: the int8 conv's fused epilogue
(singleshotpose_tpu_torch/ops/int8_conv.py ``Epilogue``,
models/quantize.py ``epilogue_plan`` and the forward that follows it).

On the CPU the port's int8 conv with an epilogue is its plain twin: the
int8 product, then the unfused chain's ops (the exact FMA, the cast, leaky,
the next conv's quantizer).  Held bit for bit — integer sums are exact and
every rounding is the JAX program's — against JAX's ``quant_conv`` +
``_activate`` + ``_quant_act`` (``singleshotpose_tpu/models/quantize.py``)
jitted as its serve (scales closed over: ``x · f32(1/sa)``) and as its eval
loop (scales as arguments: ``x / sa``), in bf16 and f32, with per-channel
and scalar quantizers, at a 1x1, a 3x3 and the first conv's padded C_in.
The epilogue plans of both zoo models are pinned, and the forward that
follows its plan equals JAX's ``apply_quantized`` on ``yolo_pose_single``
at 64² bit for bit with every conv int8.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu.models import layers as JL
from singleshotpose_tpu.models import quantize as JQ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.zoo import yolo_pose_single as jyolo

from singleshotpose_tpu_torch.models import quantize as TQ
from singleshotpose_tpu_torch.models.darknet import ConvSpec
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops import int8_conv as I
from singleshotpose_tpu_torch.zoo import yolo_pose_multi as tmulti
from singleshotpose_tpu_torch.zoo import yolo_pose_single as tyolo

from test_torch_quantize import _jax_head
from torch_port_helpers import TINY_BLOCKS, jax_params, port_folded, port_q

# (B, H, W, C_in, C_out, ksize, stride, pad): a 1x1, a 3x3, the first conv
CONVS = [(2, 6, 5, 64, 48, 1, 1, 0), (2, 8, 7, 32, 64, 3, 1, 1),
         (2, 9, 7, 3, 32, 3, 1, 1)]


def _case(B, H, W, C, N, k, per_channel, seed):
    """Random int8 input and weights, a producer's ``sw`` and ``b`` that
    map its sums to about N(0, 1), and its consumer's ``sa`` (per channel
    over the producer's outputs, or a scalar) that puts the quantized
    values at about ±40, some clamping at ±127."""
    rng = np.random.RandomState(seed)
    x = rng.randint(-127, 128, (B, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, C, N)).astype(np.int8)
    sd = 127.0 ** 2 / 3.0 * np.sqrt(k * k * C)      # the sums' spread
    sw = (rng.rand(N) * 2 / sd).astype(np.float32)
    b = (rng.randn(N) * 0.5).astype(np.float32)
    if per_channel:
        sa = (1.0 / (rng.rand(N) * 40 + 10)).astype(np.float32)
    else:
        sa = np.float32(1.0 / (rng.rand() * 10 + 40))
    return x, wq, sw, b, sa


def _jax_chain(x, wq, sw, b, sa, stride, pad, cd, constants):
    """JAX's int8 block for a producer conv with ``sw``, ``b`` (its own
    ``sa`` folded: the dequant scale is ``sw``) feeding a consumer with
    ``sa``: (the activated value, the consumer's int8)."""
    def f(x, sw, b, sa):
        y = JL.conv2d(x, wq, stride, pad, preferred_dtype=jnp.int32)
        y = y.astype(jnp.float32) * jnp.asarray(sw, jnp.float32) + b
        y = y.astype(cd) if cd is not None else y
        y = JSpec._activate(y, "leaky")
        return y, JQ._quant_act(y, sa)
    if constants:
        out = jax.jit(lambda v: f(v, sw, b, sa))(jnp.asarray(x))
    else:
        out = jax.jit(f)(jnp.asarray(x), sw, b, sa)
    return [np.asarray(o) for o in out]


def _port_conv(wq, sw, b, sa, constants):
    """The port's producer and consumer ``_QuantConv`` of the same block:
    the producer's per-channel ``sa`` of ones (folded: its dequant is
    ``sw``), the consumer's quantizer ``sa``."""
    n = wq.shape[-1]
    producer = TQ._QuantConv(
        {"wq": torch.from_numpy(wq), "sw": torch.from_numpy(sw),
         "sa": torch.ones(wq.shape[2]), "b": torch.from_numpy(b)}, constants)
    consumer = TQ._QuantConv(
        {"wq": torch.zeros((1, 1, n, 4), dtype=torch.int8),
         "sw": torch.ones(4), "sa": torch.tensor(sa), "b": torch.zeros(4)},
        constants)
    return producer, consumer


@pytest.mark.parametrize("conv", CONVS, ids=["1x1", "3x3", "first_conv"])
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("per_channel", [True, False],
                         ids=["per_channel", "scalar"])
@pytest.mark.parametrize("form", ["argument", "constant"])
def test_fused_twin_matches_jax_chain(conv, dtype, per_channel, form):
    B, H, W, C, N, k, stride, pad = conv
    x, wq, sw, b, sa = _case(B, H, W, C, N, k, per_channel, seed=B * H + C)
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" \
        else (None, None)
    constants = form == "constant"
    want_v, want_q = _jax_chain(x, wq, sw, b, sa, stride, pad, jcd,
                                constants)
    producer, consumer = _port_conv(wq, sw, b, sa, constants)
    cspec = ConvSpec(name="conv", filters=N, size=k, stride=stride, pad=pad,
                     activation="leaky", batch_normalize=False,
                     in_filters=C)
    # the first conv's C_in 3 padded with a zero channel, as the
    # forward's quantizer writes it
    xq = torch.nn.functional.pad(torch.from_numpy(x).permute(0, 3, 1, 2),
                                 (0, 0, 0, 0, 0, producer.c_pad - C))
    for writes, (value, with_q) in {"int8": (False, True),
                                    "compute": (True, False),
                                    "both": (True, True)}.items():
        v, q = producer.conv_fused(xq, cspec, tcd, "leaky",
                                   consumer if with_q else None, value)
        assert (v is not None) == value and (q is not None) == with_q
        if v is not None:
            assert v.dtype == (tcd or torch.float32)
            np.testing.assert_array_equal(
                v.permute(0, 2, 3, 1).float().numpy(),
                want_v.astype(np.float32), err_msg=writes)
        if q is not None:
            assert q.dtype == torch.int8
            np.testing.assert_array_equal(q.permute(0, 2, 3, 1).numpy(),
                                          want_q, err_msg=writes)
    # the quantizer saturates somewhere, and the plain chain agrees
    assert np.abs(want_q.astype(int)).max() == 127


@pytest.mark.parametrize("per_channel", [True, False])
def test_padded_first_conv_equals_unpadded(per_channel):
    """C_in 3 padded to 4 with a zero channel, in the input and the packed
    weights: the int32 sums and every epilogue output are the same bits."""
    x, wq, sw, b, sa = _case(2, 11, 9, 3, 32, 3, per_channel, seed=5)
    x4 = np.concatenate([x, np.zeros(x.shape[:3] + (1,), np.int8)], -1)
    args = [(torch.from_numpy(x), I.pack_weights(torch.from_numpy(wq))),
            (torch.from_numpy(x4),
             I.pack_weights(torch.from_numpy(wq), c_in=4))]
    assert tuple(args[1][1].shape) == (32, 64)
    assert bool((args[1][1][:, 36:] == 0).all())
    y3, y4 = (I.int8_conv(xx, wk, 3, 1, 1) for xx, wk in args)
    assert torch.equal(y3, y4)
    ep = I.Epilogue(torch.from_numpy(sw), torch.from_numpy(b),
                    quant=torch.from_numpy(np.atleast_1d(sa)),
                    value=True)
    (v3, q3), (v4, q4) = (I.int8_conv(xx, wk, 3, 1, 1, epilogue=ep)
                          for xx, wk in args)
    assert torch.equal(v3.view(torch.int16), v4.view(torch.int16))
    assert torch.equal(q3, q4)


def test_first_layer_quantizer_writes_the_padded_buffer():
    """The forward's first quantizer writes NHWC int8 with C_in padded to
    4, its fourth channel 0, which the conv takes as it is; its first 3
    channels are the quantizer's ``clip(round(x · f32(1/sa)), ±127)``."""
    q = TQ._QuantConv({"wq": torch.zeros((3, 3, 3, 32), dtype=torch.int8),
                       "sw": torch.ones(32), "sa": torch.tensor(0.01),
                       "b": torch.zeros(32)}, constants=True)
    x = torch.rand((2, 3, 16, 12)).to(memory_format=torch.channels_last)
    padded = q.quantize(x)
    assert padded.shape == (2, 4, 16, 12)
    nhwc = padded.permute(0, 2, 3, 1)
    assert nhwc.is_contiguous() and bool((nhwc[..., 3] == 0).all())
    inv_sa = float(np.float32(1) / np.float32(0.01))
    want = torch.clamp(torch.round(x * inv_sa), -127, 127).to(torch.int8)
    assert torch.equal(padded[:, :3], want)
    assert q.wk.shape == (32, 64)


@pytest.mark.parametrize("model", ["single", "multi"])
def test_epilogue_plans_of_the_zoo_models(model):
    """Each quantized conv writes the next conv's int8 input where that
    conv alone reads it (through the max pools, quantized first), the
    compute dtype where anything else does; conv_13, re-read by the
    passthrough route and read by conv_14 through a pool, writes both."""
    spec = tyolo() if model == "single" else tmulti()
    skip = TQ.default_skip_layers(spec)
    quantized = {l.name for l in spec.layers
                 if isinstance(l, ConvSpec) and l.name not in skip}
    plan = TQ.epilogue_plan(spec, quantized)
    writes = {name: p.writes for name, p in plan.items()}
    want = {f"conv_{i}": "int8" for i in range(1, 20)}
    want.update(conv_13="both", conv_20="compute", conv_21="compute",
                conv_22="compute")
    assert writes == want
    assert plan["conv_13"] == TQ.EpiloguePlan("conv_14", True)
    assert plan["conv_1"] == TQ.EpiloguePlan("conv_2", False)
    assert plan["conv_14"].consumer == "conv_15"
    assert "conv_23" not in plan              # the head stays bf16


def test_forward_runs_every_quantized_conv_fused(monkeypatch):
    """On the tiny spec: every quantized conv's call carries an epilogue
    whose outputs are its plan's, the first conv takes the padded input."""
    jspec = JSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=3)
    tf = port_folded(jfold(jspec, params, stats))
    tspec = TSpec(TINY_BLOCKS)
    x = torch.from_numpy(np.random.RandomState(0).rand(2, 64, 64, 3)
                         .astype(np.float32))
    qp = TQ.quantize_folded(tspec, tf, TQ.calibrate_activations(
        tspec, tf, x, per_channel=True))
    fwd = TQ.Int8Forward(tspec, qp, scales_as_constants=True)
    calls = []
    real = TQ.int8_conv

    def spy(xq, wk, *args, epilogue=None):
        calls.append((xq.shape[-1], epilogue))
        return real(xq, wk, *args, epilogue=epilogue)

    monkeypatch.setattr(TQ, "int8_conv", spy)
    fwd(x * 255.0, input_scale=1 / 255.0)
    assert len(calls) == len(fwd.convs) == len(fwd.plan)
    assert calls[0][0] == 4                      # the padded first conv
    for (_, ep), (name, plan) in zip(calls, fwd.plan.items()):
        assert ep is not None and ep.value == plan.value, name
        assert (ep.quant is not None) == (plan.consumer is not None), name
        if plan.consumer is not None:
            assert ep.quant is fwd.convs[plan.consumer].q_flat
            assert not ep.divide                  # the constants form


def test_forward_on_yolo_pose_single_matches_jax_bit_for_bit():
    """The forward that follows its plan, every conv int8 (the head too),
    bf16, scales as arguments: JAX's ``apply_quantized`` head bit for bit
    at 64²."""
    jspec, tspec = jyolo(test_size=64), tyolo(test_size=64)
    params, stats = jax_params(jspec, seed=21)
    jf = jfold(jspec, params, stats)
    x = np.random.RandomState(22).rand(1, 64, 64, 3).astype(np.float32)
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    per_channel=True)
    jq = JQ.quantize_folded(jspec, jf, amax, skip_layers=())
    assert sum("wq" in v for v in jq.values()) == 23
    want = _jax_head(jspec, jq, x, jnp.bfloat16, False)
    fwd = TQ.Int8Forward(tspec, port_q(jq))
    assert [p.writes for p in fwd.plan.values()].count("both") == 1
    got = fwd(torch.from_numpy(x), compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(), want)
