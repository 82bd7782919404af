"""PyTorch port vs the JAX package: int8 post-training quantization
(singleshotpose_tpu_torch/models/quantize.py, ops/int8_conv.py, the int8
serve in serving.py, the eval drivers' ``quantize=``/``add_s=``/``save=``,
``cli quantize`` and ``valid(-multi) --quantize``).

The same numpy inputs and folded weights go through both packages.
Tolerances, with their reasons:

- the int8 conv's twin equals JAX's ``conv2d(preferred_dtype=int32)`` bit
  for bit (integer sums are exact);
- ``quantize_folded`` from the same ranges gives the same ``wq``, ``sw``,
  ``sa`` bits (every step is the same eager IEEE operation);
- calibration ranges in f32 to rel 1e-5 (the f32 convs sum in another
  order), in bf16 to rel 2e-2 (a bf16 conv output a rounding step apart
  moves a range by up to one bf16 ulp, 2^-8);
- ``apply_quantized``: the int8 chain bit for bit in f32 and bf16 (the
  quantized activations, and so the head, when every conv is quantized),
  in both rounding forms (scales as jit arguments: ``x / sa``; closed over:
  ``x·f32(1/sa)``, on u8 frames with a scalar first scale one folded
  multiply); with the head conv kept in float, the head to 1e-5 of its
  scale in f32 (that conv's sum order) and 2e-2 in bf16, as
  ``test_torch_serving`` holds the bf16 serve;
- the drivers: equal sample counts and accuracies, predicted corners to
  1e-4 of the normalized coordinate in f32, as the bf16-free driver tests
  hold them;
- ``adi`` to rel 1e-12 of scipy's KD-tree (f64 distances both).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import evaluate as JE
from singleshotpose_tpu import serving as JS
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models import layers as JL
from singleshotpose_tpu.models import quantize as JQ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.utils.geometry import adi as jadi
from singleshotpose_tpu.zoo import linemod_datacfg
from singleshotpose_tpu.zoo import yolo_pose_single as jyolo

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import evaluate as TE
from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.data.device_augment import INV255
from singleshotpose_tpu_torch.models import quantize as TQ
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.models.darknet import _walk, _to_nchw, _to_nhwc
from singleshotpose_tpu_torch.ops import int8_conv as I
from singleshotpose_tpu_torch.utils.geometry import adi as tadi
from singleshotpose_tpu_torch.zoo import yolo_pose_single as tyolo

from test_torch_multi_eval import occlusion  # noqa: F401  (fixture)
from test_torch_pose import K, _poses
from test_torch_serving import linemod  # noqa: F401  (fixture)
from torch_port_helpers import TINY_BLOCKS, jax_params, port_folded, port_q

KW = dict(batch_size=3, num_workers=0, verbose=False)


@pytest.fixture(scope="module")
def tiny():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=3)
    jf = jfold(jspec, params, stats)
    x = np.random.RandomState(0).rand(2, 64, 64, 3).astype(np.float32)
    return jspec, tspec, jf, port_folded(jf), x


# ---------------------------------------------------------------------------
# the int8 conv
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("B,H,W,C,N,k,stride,pad", [
    (2, 9, 7, 3, 32, 3, 1, 1),       # the first conv's C_in = 3, odd width
    (1, 6, 5, 64, 40, 1, 1, 0),      # 1x1
    (2, 8, 8, 32, 64, 3, 1, 1),      # 3x3
    (2, 8, 9, 36, 16, 3, 2, 1)])     # the 4-byte copy path, stride 2
def test_int8_conv_twin_matches_jax_conv(B, H, W, C, N, k, stride, pad):
    rng = np.random.RandomState(B * 100 + C)
    x = rng.randint(-127, 128, (B, H, W, C)).astype(np.int8)
    wq = rng.randint(-127, 128, (k, k, C, N)).astype(np.int8)
    want = np.asarray(JL.conv2d(jnp.asarray(x), jnp.asarray(wq), stride, pad,
                                preferred_dtype=jnp.int32))
    got = I.int8_conv(torch.from_numpy(x), I.pack_weights(torch.from_numpy(wq)),
                      k, stride, pad)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_conv_packs_and_checks():
    wq = torch.randint(-127, 128, (3, 3, 3, 32), dtype=torch.int8)
    wk = I.pack_weights(wq)
    assert tuple(wk.shape) == (32, 32) and wk.is_contiguous()
    assert bool((wk[:, 27:] == 0).all())
    assert torch.equal(wk[:, :27].reshape(32, 3, 3, 3), wq.permute(3, 0, 1, 2))
    x = torch.zeros((1, 4, 4, 3), dtype=torch.int8)
    with pytest.raises(ValueError, match="packs to"):
        I.int8_conv(x, wk[:, :16], 3, 1, 1)
    with pytest.raises(ValueError, match="int8"):
        I.int8_conv(x.float(), wk, 3, 1, 1)


# ---------------------------------------------------------------------------
# calibration and quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["absmax", "per_channel", "percentile",
                                  "absmax_bf16"])
def test_calibrate_activations_matches_jax(tiny, mode):
    jspec, tspec, jf, tf, x = tiny
    bf16 = mode.endswith("bf16")
    kw = dict(per_channel=mode == "per_channel",
              percentile=99.9 if mode == "percentile" else None)
    want = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    compute_dtype=jnp.bfloat16 if bf16
                                    else None, **kw)
    got = TQ.calibrate_activations(tspec, tf, torch.from_numpy(x),
                                   compute_dtype=torch.bfloat16 if bf16
                                   else None, **kw)
    assert set(got) == set(want) == {c.name for c in tspec.conv_specs()}
    for k in want:
        if mode == "per_channel":
            assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=2e-2 if bf16 else 1e-5,
                                   err_msg=k)
    # the first conv reads the images themselves: exact
    np.testing.assert_array_equal(got["conv_1"], want["conv_1"])


@pytest.mark.parametrize("per_channel", [False, True])
def test_quantize_folded_matches_jax_bits(tiny, per_channel):
    jspec, tspec, jf, tf, x = tiny
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    compute_dtype=None,
                                    per_channel=per_channel)
    want = JQ.quantize_folded(jspec, jf, amax)
    got = TQ.quantize_folded(tspec, tf, amax)
    assert set(got) == set(want)
    for k, d in want.items():
        assert set(got[k]) == set(d), k
        for f, v in d.items():
            g = got[k][f]
            if f == "w":            # kept head: the port's OIHW
                g = g.permute(2, 3, 1, 0)
            assert g.dtype == {"wq": torch.int8}.get(f, torch.float32)
            np.testing.assert_array_equal(g.numpy(), np.asarray(v),
                                          err_msg=f"{k}/{f}")


def test_zero_range_falls_back_and_head_is_skipped(tiny):
    jspec, tspec, jf, tf, x = tiny
    amax = TQ.calibrate_activations(tspec, tf, torch.from_numpy(x),
                                    compute_dtype=None)
    qp = TQ.quantize_folded(tspec, tf, amax)
    head = tspec.conv_specs()[-1].name
    assert TQ.default_skip_layers(tspec) == {head}
    assert "wq" not in qp[head] and qp[head]["w"].shape == tf[head]["w"].shape
    assert all("wq" in qp[c.name] for c in tspec.conv_specs()[:-1])
    assert TS._is_quantized(qp) and not TS._is_quantized(tf)
    qp0 = TQ.quantize_folded(tspec, tf, {**amax, "conv_1": 0.0})
    assert "wq" not in qp0["conv_1"]
    pc = TQ.calibrate_activations(tspec, tf, torch.from_numpy(x),
                                  compute_dtype=None, per_channel=True)
    qp1 = TQ.quantize_folded(tspec, tf, {**pc, "conv_3": np.zeros(16,
                                                                   np.float32)})
    assert "wq" not in qp1["conv_3"] and "wq" in qp1["conv_2"]
    # the head through the int8 forward with conv_1 in float: finite
    out = TQ.apply_quantized(tspec, qp0, torch.from_numpy(x), compute_dtype=None)
    assert bool(torch.isfinite(out).all())


def _jax_head(jspec, jq, x, cd, constants):
    f = (jax.jit(lambda v: JQ.apply_quantized(jspec, jq, v, compute_dtype=cd))
         if constants else
         jax.jit(lambda p, v: JQ.apply_quantized(jspec, p, v,
                                                  compute_dtype=cd)))
    out = f(jnp.asarray(x)) if constants else f(jq, jnp.asarray(x))
    return np.asarray(out, np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("form", ["argument", "constant"])
def test_apply_quantized_matches_jax(tiny, dtype, per_channel, form):
    jspec, tspec, jf, tf, x = tiny
    jcd, tcd = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" \
        else (None, None)
    constants = form == "constant"
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    compute_dtype=jcd, per_channel=per_channel)
    # every conv quantized: the int8 chain and the head bit for bit
    jq = JQ.quantize_folded(jspec, jf, amax, skip_layers=())
    want = _jax_head(jspec, jq, x, jcd, constants)
    got = TQ.apply_quantized(tspec, port_q(jq), torch.from_numpy(x),
                             compute_dtype=tcd, scales_as_constants=constants)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # the default: the head conv in float, the head at a stated tolerance
    jq = JQ.quantize_folded(jspec, jf, amax)
    want = _jax_head(jspec, jq, x, jcd, constants)
    got = TQ.apply_quantized(tspec, port_q(jq), torch.from_numpy(x),
                             compute_dtype=tcd, scales_as_constants=constants)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def test_the_two_rounding_forms_differ_where_jax_does(tiny):
    """Per-channel scales on u8 frames: JAX's closed-over serve and its
    argument form round some activation apart; the port follows each."""
    jspec, tspec, jf, tf, x = tiny
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    per_channel=True)
    jq = JQ.quantize_folded(jspec, jf, amax, skip_layers=())
    u8 = np.random.RandomState(5).randint(0, 256, (3, 64, 64, 3)).astype(
        np.uint8)

    def jax_u8(p, v):
        return JQ.apply_quantized(jspec, p, v.astype(jnp.float32) / 255.0)

    closed = np.asarray(jax.jit(lambda v: jax_u8(jq, v))(jnp.asarray(u8)),
                        np.float32)
    arg = np.asarray(jax.jit(jax_u8)(jq, jnp.asarray(u8)), np.float32)
    tq, raw = port_q(jq), torch.from_numpy(u8).float()
    for constants, want in ((True, closed), (False, arg)):
        got = TQ.apply_quantized(tspec, tq, raw, scales_as_constants=constants,
                                 input_scale=INV255)
        np.testing.assert_array_equal(got.float().numpy(), want)
    assert not np.array_equal(closed, arg)


def test_u8_scalar_quantizer_folds_as_xla_does():
    """A closed-over scalar ``sa`` on u8 frames: XLA multiplies by one
    constant, f32(1/255)·f32(1/sa), where the port's folded quantizer
    does; every u8 level, 64 scales."""
    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    rng = np.random.RandomState(7)
    for sa in rng.uniform(1e-3, 2e-2, 64).astype(np.float32):
        want = np.asarray(jax.jit(lambda v: JQ._quant_act(
            v.astype(jnp.float32) / 255.0, jnp.float32(sa)))(levels))
        q = TQ._QuantConv({"sa": torch.tensor(sa), "sw": torch.ones(4),
                           "b": torch.zeros(4),
                           "wq": torch.zeros((1, 1, 1, 4), dtype=torch.int8)},
                          constants=True)
        got = q.quantize(_to_nchw(torch.from_numpy(levels).float()), INV255)
        # the one channel, padded with zeros to the kernel's 4
        np.testing.assert_array_equal(_to_nhwc(got[:, :1]).numpy(), want)


def test_apply_quantized_on_yolo_pose_single_matches_jax():
    jspec, tspec = jyolo(test_size=64), tyolo(test_size=64)
    params, stats = jax_params(jspec, seed=21)
    jf = jfold(jspec, params, stats)
    x = np.random.RandomState(22).rand(1, 64, 64, 3).astype(np.float32)
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    compute_dtype=None, per_channel=True)
    got_amax = TQ.calibrate_activations(tspec, port_folded(jf),
                                        torch.from_numpy(x),
                                        compute_dtype=None, per_channel=True)
    # f32 sums in another order through up to 22 convs: rel 1e-4
    for k in amax:
        np.testing.assert_allclose(got_amax[k], amax[k], rtol=1e-4, err_msg=k)
    jq = JQ.quantize_folded(jspec, jf, amax)
    assert sum("wq" in v for v in jq.values()) == 22
    want = _jax_head(jspec, jq, x, None, False)
    got = TQ.apply_quantized(tspec, port_q(jq), torch.from_numpy(x),
                             compute_dtype=None).numpy()
    assert got.shape == want.shape == (1, 2, 2, 20)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())


def test_pool_commutation_is_bit_exact(tiny):
    """Quantizing before the pools equals quantizing at the conv input."""
    _, tspec, _, tf, x = tiny
    for per_channel in (False, True):
        amax = TQ.calibrate_activations(tspec, tf, torch.from_numpy(x),
                                        per_channel=per_channel)
        qp = TQ.quantize_folded(tspec, tf, amax)
        fwd = TQ.Int8Forward(tspec, qp)

        def naive(cspec, xin):
            if cspec.name not in fwd.convs:
                p = qp[cspec.name]
                return torch.nn.functional.conv2d(
                    xin.to(torch.bfloat16), p["w"].to(torch.bfloat16),
                    padding=cspec.pad).float() + p["b"].reshape(1, -1, 1, 1)
            q = fwd.convs[cspec.name]
            return q.conv(q.quantize(xin), cspec, torch.bfloat16)

        want = _to_nhwc(_walk(tspec, _to_nchw(torch.from_numpy(x)), naive,
                              None))
        got = fwd(torch.from_numpy(x))
        assert torch.equal(got.float(), want.float())


# ---------------------------------------------------------------------------
# the artifact and the serve
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("per_channel", [False, True])
def test_artifacts_cross_between_the_packages(tiny, tmp_path, per_channel):
    jspec, tspec, jf, tf, x = tiny
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    compute_dtype=None,
                                    per_channel=per_channel)
    jq = JQ.quantize_folded(jspec, jf, amax)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    JQ.save_quantized(jpath, jax.device_get(jq))
    loaded = TQ.load_quantized(jpath)
    want = _jax_head(jspec, JQ.load_quantized(jpath), x, None, False)
    got = TQ.apply_quantized(tspec, loaded, torch.from_numpy(x),
                             compute_dtype=None).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    # the port's artifact holds JAX's keys, layouts and bits
    TQ.save_quantized(tpath, TQ.quantize_folded(tspec, tf, amax))
    with np.load(jpath) as a, np.load(tpath) as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_array_equal(b[key], a[key], err_msg=key)


def test_int8_serve_matches_jax_and_aot_serving(tiny):
    jspec, tspec, jf, tf, x = tiny
    amax = JQ.calibrate_activations(jspec, jf, jnp.asarray(x),
                                    per_channel=True)
    jq = JQ.quantize_folded(jspec, jf, amax, skip_layers=())
    tq = port_q(jq)
    u8 = np.random.RandomState(9).randint(0, 256, (2, 64, 64, 3)).astype(
        np.uint8)
    want = np.asarray(jax.jit(JS.make_serving_fn(jspec, jq, pick=("best",)))(
        jnp.asarray(u8)))
    serve = TS.make_serving_fn(tspec, tq, pick=("best",))
    got = serve(u8)
    assert serve.int8 is not None
    np.testing.assert_array_equal(got.numpy(), want)
    aot = TS.aot_serving(tspec, tq, batch=2, width=64, height=64)
    assert torch.equal(aot(u8), got)
    with pytest.raises(ValueError, match="takes"):
        aot(u8[:1])
    with TS.MicroBatcher(serve, height=64, width=64, buckets=(2,)) as mb:
        rows = [mb.submit(f) for f in u8]
        assert torch.equal(torch.stack([r.result(60) for r in rows]), got)


# ---------------------------------------------------------------------------
# the drivers and the CLI
# ---------------------------------------------------------------------------


def _same_accuracies(got, want):
    assert got["n_samples"] == want["n_samples"]
    for k in got:
        if k.startswith("acc_"):
            assert got[k] == want[k], (k, got[k], want[k])


def test_run_validation_quantize_matches_jax(linemod, tmp_path):  # noqa: F811
    datacfg, cfg, wfile = linemod
    got = TDr.run_validation(datacfg, cfg, wfile, compute_dtype=None,
                             device="cpu", quantize=True, **KW)
    want = JDr.run_validation(datacfg, cfg, wfile, compute_dtype=None,
                              quantize=True, **KW)
    _same_accuracies(got, want)
    # an artifact of the JAX package's quantize, served without weights
    from singleshotpose_tpu.config import (data_config_from_options,
                                           read_data_cfg)
    from singleshotpose_tpu.data.pipeline import Loader, PoseDataset
    jspec = JSpec.from_cfg(cfg)
    _, params, stats = JW.load_weights(jspec, wfile)
    jfolded = jfold(jspec, params, stats)
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    ds = PoseDataset(dcfg.valid, train=False)
    imgs, _ = next(iter(Loader(ds, 4, shuffle=False, schedule=None,
                               fixed_shape=(64, 64), num_workers=0,
                               drop_last=False, out_uint8=True)))
    calib = jnp.asarray(imgs).astype(jnp.float32) / 255.0
    path = str(tmp_path / "q.npz")
    JQ.save_quantized(path, jax.device_get(JQ.quantize_folded(
        jspec, jfolded, JQ.calibrate_activations(jspec, jfolded, calib,
                                                 compute_dtype=None))))
    got = TDr.run_validation(datacfg, cfg, None, compute_dtype=None,
                             device="cpu", quantize=path, **KW)
    want = JDr.run_validation(datacfg, cfg, None, compute_dtype=None,
                              quantize=path, **KW)
    _same_accuracies(got, want)


def test_quantized_eval_pass_corners_match_jax(linemod):  # noqa: F811
    from singleshotpose_tpu import weights as JWt
    from singleshotpose_tpu.config import (data_config_from_options,
                                           read_data_cfg)
    from singleshotpose_tpu.data.pipeline import Loader, PoseDataset
    from singleshotpose_tpu_torch import weights as TW
    from singleshotpose_tpu_torch.models.darknet import Darknet
    datacfg, cfg, wfile = linemod
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    jspec, tspec = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)

    def loader():
        return Loader(PoseDataset(dcfg.valid, train=False), 3, shuffle=False,
                      schedule=None, fixed_shape=(64, 64), num_workers=0,
                      drop_last=False, out_uint8=True)

    _, params, stats = JWt.load_weights(jspec, wfile)
    _, jart = JDr._eval_pass(jspec, params, stats, loader(),
                             JDr.EvalContext.from_data_config(dcfg),
                             pick=("best",), num_keypoints=9,
                             compute_dtype=None, quantize=True)
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, wfile)[1])
    _, tart = TDr._eval_pass(tspec, model, loader(),
                             TDr.EvalContext.from_data_config(dcfg),
                             compute_dtype=None, device="cpu", quantize=True)
    np.testing.assert_array_equal(tart["image_idx"], jart["image_idx"])
    np.testing.assert_array_equal(tart["corners_gt"], jart["corners_gt"])
    np.testing.assert_allclose(tart["corners_pr"] / [640, 480],
                               jart["corners_pr"] / [640, 480], rtol=0,
                               atol=1e-4)


def test_cli_quantize_then_valid(linemod, tmp_path, capsys):  # noqa: F811
    datacfg, cfg, wfile = linemod
    path = str(tmp_path / "cli_q.npz")
    assert tcli(["quantize", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--weightfile", wfile, "--out", path, "--calib_images", "3",
                 "--device", "cpu"]) == 0
    assert "quantized 7/8 conv layers on 3 calibration images" in \
        capsys.readouterr().out
    assert tcli(["valid", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--quantize", path, "--batch_size", "3",
                 "--device", "cpu"]) == 0
    assert "Acc using 5 px 2D Projection" in capsys.readouterr().out
    # the port's artifact in the JAX driver: the same accuracies (bf16)
    got = TDr.run_validation(datacfg, cfg, None, device="cpu", quantize=path,
                             **KW)
    want = JDr.run_validation(datacfg, cfg, None, quantize=path, **KW)
    _same_accuracies(got, want)
    scalar = str(tmp_path / "cli_scalar.npz")
    assert tcli(["quantize", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--weightfile", wfile, "--out", scalar, "--act_scales",
                 "scalar", "--device", "cpu"]) == 0
    with np.load(scalar) as z:
        assert z["conv_2/sa"].ndim == 0 and "conv_8/w" in z.files


def test_run_validation_multi_quantize_matches_jax(occlusion):  # noqa: F811
    datacfgs, occ, cfg, wfile = occlusion
    kw = dict(batch_size=2, num_workers=0, compute_dtype=None, verbose=False)
    got = TDr.run_validation_multi(datacfgs["cat"], cfg, wfile, device="cpu",
                                   quantize=True, **kw)
    want = JDr.run_validation_multi(datacfgs["cat"], cfg, wfile,
                                    quantize=True, **kw)
    assert got["n_samples"] == want["n_samples"] == 3
    assert got["acc_table"] == want["acc_table"]
    np.testing.assert_allclose(got["mean_err_2d"], want["mean_err_2d"],
                               rtol=1e-3)


def test_cli_valid_multi_quantize(occlusion, capsys):  # noqa: F811
    datacfgs, occ, cfg, wfile = occlusion
    assert tcli(["valid-multi", "--modelcfg", cfg, "--weightfile", wfile,
                 "--datacfgs", datacfgs["ape"], "--quantize",
                 "--device", "cpu"]) == 0
    assert "Acc using 50 px 2D Projection" in capsys.readouterr().out
    assert tcli(["valid-multi", "--modelcfg", cfg, "--weightfile", wfile,
                 "--datacfg", occ, "--quantize", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.count("Acc using 5 px 2D Projection") == 7


# ---------------------------------------------------------------------------
# ADD-S and the saved predictions
# ---------------------------------------------------------------------------


def test_adi_matches_jax():
    rng = np.random.RandomState(3)
    for n, m in ((50, 50), (700, 1300), (2100, 300)):
        est = rng.randn(n, 3).astype(np.float32)
        gt = rng.randn(m, 3).astype(np.float32)
        np.testing.assert_allclose(tadi(est, gt, chunk=256), jadi(est, gt),
                                   rtol=1e-12)


def test_pose_metrics_symmetric_matches_jax():
    X, _, _, px = _poses(16, seed=12)
    rng = np.random.RandomState(13)
    pr = px + rng.uniform(-2, 2, px.shape)
    verts = rng.uniform(-1, 1, (300, 3)) * np.abs(X).max(axis=0)
    verts = np.concatenate([verts, np.ones((300, 1))], axis=1).T
    fields = (X.astype(np.float32), verts.astype(np.float32),
              K.astype(np.float32), 0.2, 640, 480)
    tctx, jctx = TE.EvalContext(*fields), JE.EvalContext(*fields)
    got = TE.pose_metrics(px, pr, tctx, symmetric=True, device="cpu")
    want = JE.pose_metrics(px, pr, jctx, symmetric=True)
    plain = TE.pose_metrics(px, pr, tctx, device="cpu")
    # the poses come from two PnP solvers (rel 1e-3, as the ADD test)
    np.testing.assert_allclose(got["err_3d"], want["err_3d"], rtol=1e-3)
    assert got["err_3d"].dtype == np.float32
    assert (got["err_3d"] <= plain["err_3d"] + 1e-6).all()
    assert (got["err_3d"] < plain["err_3d"]).any()


def test_add_s_and_save_match_jax(linemod, tmp_path):  # noqa: F811
    datacfg, cfg, wfile = linemod
    text = open(datacfg).read()
    dirs = {}
    for who in ("jax", "port"):
        dirs[who] = str(tmp_path / who)
        path = str(tmp_path / f"{who}.data")
        with open(path, "w") as f:
            f.write("\n".join(
                f"backup = {dirs[who]}" if line.split("=")[0].strip()
                == "backup" else line for line in text.splitlines()) + "\n")
        dirs[who + "_cfg"] = path
    got = TDr.run_validation(dirs["port_cfg"], cfg, wfile, compute_dtype=None,
                             device="cpu", add_s=True, save=True, **KW)
    want = JDr.run_validation(dirs["jax_cfg"], cfg, wfile, compute_dtype=None,
                              add_s=True, save=True, **KW)
    _same_accuracies(got, want)
    plain = TDr.run_validation(datacfg, cfg, wfile, compute_dtype=None,
                               device="cpu", **KW)
    assert got["mean_err_3d"] <= plain["mean_err_3d"]
    for sub in ("test/gt", "test/pr"):
        names = sorted(os.listdir(os.path.join(dirs["jax"], sub)))
        assert names == sorted(os.listdir(os.path.join(dirs["port"], sub)))
        assert len(names) == 3 * 4
        for name in names:
            a = np.loadtxt(os.path.join(dirs["jax"], sub, name))
            b = np.loadtxt(os.path.join(dirs["port"], sub, name))
            if sub == "test/gt" or name.startswith("corners"):
                np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-3,
                                           err_msg=name)
            else:       # PnP on a random net's corners: shapes and finite
                assert b.shape == a.shape and np.isfinite(b).all()
    mats = [f for f in os.listdir(dirs["port"]) if f.endswith(".mat")]
    assert mats == [f for f in os.listdir(dirs["jax"]) if f.endswith(".mat")]
