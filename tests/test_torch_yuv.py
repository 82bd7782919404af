"""The port's yuv420 eval transfer (``singleshotpose_tpu_torch/ops/yuv.py``,
the serving function's ``transfer="yuv420"`` form and the drivers'
``transfer="yuv420"``) against the JAX package.

Tolerances:

* ``yuv420_to_rgb_resized`` equals JAX's jitted function bit for bit
  where XLA's CPU program rounds each op on its own, as the port does (the
  identity shape and some resizes).  At other shapes XLA's code generator
  contracts some of the BT.601 matrix's multiply-adds into FMAs, and which
  ones depends on the shape (at 48×64→72×80 the G chain, at 480×640→
  672×672 R and G), so no fixed formula copies it: there the two differ by
  at most 2 f32 ulp at the top of the [0, 1] range (2·2⁻²³; one rounding of
  the pre-scale value, scaled by 1/255).
* The serving function's yuv420 form equals the rgb form on the port's own
  conversion bit for bit, and JAX's eval forward to 1e-5 (f32).
* ``_eval_pass`` corners equal JAX's to 1e-4 of the image size, as
  ``tests/test_torch_quantize.py`` holds the rgb ones; ``run_validation``
  and ``run_validation_multi`` give JAX's accuracies.
* The transfer's own gate (``tests/test_yuv.py``'s): against the rgb eval
  input of the same frames, luma drift mean < 1 and max < 16 u8 levels,
  PSNR > 27 dB.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import native as JN
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.config import data_config_from_options as jdco
from singleshotpose_tpu.config import read_data_cfg as jread
from singleshotpose_tpu.data import pipeline as JP
from singleshotpose_tpu.models import quantize as JQ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.ops.yuv import yuv420_to_rgb_resized as jyuv

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.config import (data_config_from_options,
                                             read_data_cfg)
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.models.darknet import Darknet
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.data.augment import resize_indices
from singleshotpose_tpu_torch.ops.yuv import yuv420_to_rgb_resized

from test_torch_multi_eval import occlusion  # noqa: F401  (fixture)
from test_torch_serving import linemod  # noqa: F401  (fixture)
from torch_port_helpers import port_folded

KW = dict(batch_size=3, num_workers=0, compute_dtype=None, verbose=False)
ULP1 = float(np.finfo(np.float32).eps)          # 2⁻²³, an ulp of 1.0


def _planes(rng, B, H, W):
    return (rng.randint(0, 256, (B, H, W), np.uint8),
            rng.randint(0, 256, (B, (H + 1) // 2, (W + 1) // 2, 2), np.uint8))


@pytest.mark.parametrize("B,H,W,out_h,out_w,exact", [
    (2, 48, 64, 48, 64, True),         # the identity shape
    (3, 50, 66, 40, 40, True),         # odd planes, downscale
    (2, 64, 96, 128, 128, True),       # upscale
    (2, 48, 64, 72, 80, False),        # XLA contracts the G chain
    (1, 480, 640, 672, 672, False),    # the test size: R and G contracted
])
def test_conversion_matches_jax(B, H, W, out_h, out_w, exact):
    y, cbcr = _planes(np.random.RandomState(H + out_w), B, H, W)
    want = np.asarray(jyuv(jnp.asarray(y), jnp.asarray(cbcr), out_w=out_w,
                           out_h=out_h))
    got = yuv420_to_rgb_resized(torch.from_numpy(y), torch.from_numpy(cbcr),
                                out_w=out_w, out_h=out_h)
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (B, out_h, out_w, 3)
    got = got.numpy()
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() <= 2 * ULP1
        assert (got != want).mean() < 0.2
    assert got.min() >= 0 and got.max() <= 1


def test_resize_indices_are_resize_nearest():
    """The gather's rows and columns pick what JAX's host resize picks."""
    from singleshotpose_tpu.data.augment import resize_nearest
    img = np.arange(37 * 53).reshape(37, 53)
    for oh, ow in ((37, 53), (20, 71), (64, 64), (1, 1)):
        np.testing.assert_array_equal(
            img[resize_indices(37, oh)][:, resize_indices(53, ow)],
            resize_nearest(img, ow, oh))


def test_conversion_refuses_bad_planes():
    y, cbcr = _planes(np.random.RandomState(0), 2, 8, 8)
    with pytest.raises(ValueError, match="yuv420 planes"):
        yuv420_to_rgb_resized(torch.from_numpy(y).float(),
                              torch.from_numpy(cbcr), out_w=8, out_h=8)
    with pytest.raises(ValueError, match="yuv420 planes"):
        yuv420_to_rgb_resized(torch.from_numpy(y), torch.from_numpy(cbcr[:1]),
                              out_w=8, out_h=8)


def _native_or_skip():
    if not JN.native_available():
        pytest.skip("native toolchain unavailable")
    from singleshotpose_tpu_torch.native import NativeLoader
    return NativeLoader(nthreads=1)


def test_eval_input_luma_and_psnr_gate(tmp_path):
    """The yuv420 eval input against the rgb eval input of the same JPEG
    frames at eval size: they differ only by the JPEG chroma round trip,
    so luma is nearly exact and the PSNR stays above the chroma floor."""
    from test_drivers import _make_synthetic_linemod
    nl = _native_or_skip()
    datacfg, _ = _make_synthetic_linemod(tmp_path)
    paths = [ln.strip() for ln in open(read_data_cfg(datacfg)["valid"])
             if ln.strip()]
    W = H = 128
    rgb = nl.test_batch_u8(paths, W, H).astype(np.float32) / 255.0
    y, cbcr = nl.test_batch_yuv420(paths)
    out = yuv420_to_rgb_resized(torch.from_numpy(y), torch.from_numpy(cbcr),
                                out_w=W, out_h=H).numpy()
    assert out.shape == rgb.shape == (6, H, W, 3)
    delta = (out - rgb) * 255.0
    luma = np.abs(delta @ np.array([0.299, 0.587, 0.114], np.float32))
    assert luma.mean() < 1.0, f"luma drift mean {luma.mean():.3f} u8"
    assert luma.max() < 16.0, f"luma drift max {luma.max():.3f} u8"
    psnr = 10 * np.log10(255.0 ** 2 / max((delta ** 2).mean(), 1e-12))
    assert psnr > 27.0, f"yuv420 path PSNR {psnr:.2f} dB vs host rgb"


# ---------------------------------------------------------------------------
# the serving function's yuv420 form
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny_folded(linemod):  # noqa: F811
    _, cfg, wfile = linemod
    jspec, tspec = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)
    _, params, stats = JW.load_weights(jspec, wfile)
    jf = jax.device_get(jfold(jspec, params, stats))
    return jspec, tspec, jf, port_folded(jf)


@pytest.mark.parametrize("pick", [("best",), ("per_class", 0.05), None],
                         ids=["best", "per_class", "grid"])
def test_yuv420_serve_is_the_rgb_serve_on_the_converted_frames(tiny_folded,
                                                                pick):
    jspec, tspec, jf, tf = tiny_folded
    y, cbcr = _planes(np.random.RandomState(1), 3, 48, 80)
    kw = dict(pick=pick, compute_dtype=None)
    serve = TS.make_serving_fn(tspec, tf, transfer="yuv420",
                               out_shape=(64, 64), **kw)
    got = serve(y, cbcr)
    frames = yuv420_to_rgb_resized(torch.from_numpy(y),
                                   torch.from_numpy(cbcr), out_w=64,
                                   out_h=64)
    want = TS.make_serving_fn(tspec, tf, **kw)(frames)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert torch.equal(g, w)
    jfwd = JDr._eval_forward(jspec, None, "yuv420", (64, 64),
                             pick if pick is not None else None)
    jout = jfwd(jax.tree.map(jnp.asarray, jf), jnp.asarray(y),
                jnp.asarray(cbcr))
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(jout)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_make_serving_fn_refuses_bad_transfer(tiny_folded):
    _, tspec, _, tf = tiny_folded
    with pytest.raises(ValueError, match="needs out_shape"):
        TS.make_serving_fn(tspec, tf, transfer="yuv420")
    with pytest.raises(ValueError, match="unknown transfer"):
        TS.make_serving_fn(tspec, tf, transfer="jpeg")


class _Group:
    def __init__(self, rank, world):
        self.rank, self.world = rank, world


def test_serve_rows_splits_both_planes_by_rows(tiny_folded, monkeypatch):
    """Under a data-parallel group each rank serves its rows of both
    planes (a ragged batch zero-padded); the gathered boxes are the whole
    batch's, served at once."""
    _, tspec, _, tf = tiny_folded
    serve = TS.make_serving_fn(tspec, tf, pick=("best",), compute_dtype=None,
                               transfer="yuv420", out_shape=(64, 64))
    rng = np.random.RandomState(2)
    batches = [(_planes(rng, n, 32, 48), np.full((n, 1050), float(n)))
               for n in (4, 3)]
    local = {}

    def gather(rank):
        def fn(t, group):
            local[rank] = t
            return torch.stack([local.get(0, t), local.get(1, t)])
        return fn

    for rank in (1, 0):
        monkeypatch.setattr(TDr, "all_gather_rows", gather(rank))
        out = TDr._serve_rows(serve, batches, _Group(rank, 2))
    assert [len(b) for b, _ in out] == [4, 3]
    for (boxes, labels), ((y, cbcr), lab) in zip(out, batches):
        assert torch.equal(boxes, serve(y, cbcr))
        assert labels is lab


# ---------------------------------------------------------------------------
# the drivers
# ---------------------------------------------------------------------------


def test_eval_pass_corners_match_jax(linemod):  # noqa: F811
    _native_or_skip()
    datacfg, cfg, wfile = linemod
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    jspec, tspec = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)

    def loader(P):
        return P.Loader(P.PoseDataset(dcfg.valid, train=False), 3,
                        shuffle=False, schedule=None, fixed_shape=(64, 64),
                        num_workers=0, drop_last=False, out_uint8=True,
                        out_yuv420=True)

    _, params, stats = JW.load_weights(jspec, wfile)
    _, jart = JDr._eval_pass(jspec, params, stats, loader(JP),
                             JDr.EvalContext.from_data_config(jdco(
                                 jread(datacfg))),
                             pick=("best",), num_keypoints=9,
                             compute_dtype=None, transfer="yuv420",
                             out_shape=(64, 64))
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, wfile)[1])
    _, tart = TDr._eval_pass(tspec, model, loader(TP),
                             TDr.EvalContext.from_data_config(dcfg),
                             compute_dtype=None, device="cpu",
                             transfer="yuv420", out_shape=(64, 64))
    np.testing.assert_array_equal(tart["image_idx"], jart["image_idx"])
    np.testing.assert_array_equal(tart["corners_gt"], jart["corners_gt"])
    np.testing.assert_allclose(tart["corners_pr"] / [640, 480],
                               jart["corners_pr"] / [640, 480], rtol=0,
                               atol=1e-4)


def _same_accuracies(got, want):
    assert got["n_samples"] == want["n_samples"] == 4
    for k in got:
        if k.startswith("acc_"):
            assert got[k] == want[k], (k, got[k], want[k])


def test_run_validation_yuv420_matches_jax(linemod):  # noqa: F811
    _native_or_skip()
    datacfg, cfg, wfile = linemod
    got = TDr.run_validation(datacfg, cfg, wfile, device="cpu",
                             transfer="yuv420", **KW)
    want = JDr.run_validation(datacfg, cfg, wfile, transfer="yuv420", **KW)
    _same_accuracies(got, want)
    for k in ("mean_err_2d", "mean_corner_err_2d"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def test_run_validation_yuv420_int8_artifact_matches_jax(linemod, tmp_path):  # noqa: F811
    """An int8 artifact (``quantize="<path>.npz"``) composes with the
    yuv420 transfer; ``quantize=True`` refuses it, as JAX's does."""
    _native_or_skip()
    datacfg, cfg, wfile = linemod
    jspec = JSpec.from_cfg(cfg)
    _, params, stats = JW.load_weights(jspec, wfile)
    jf = jfold(jspec, params, stats)
    calib = jnp.asarray(np.random.RandomState(3).uniform(
        0, 1, (4, 64, 64, 3)).astype(np.float32))
    path = str(tmp_path / "q.npz")
    JQ.save_quantized(path, jax.device_get(JQ.quantize_folded(
        jspec, jf, JQ.calibrate_activations(jspec, jf, calib,
                                            compute_dtype=None))))
    got = TDr.run_validation(datacfg, cfg, None, device="cpu",
                             transfer="yuv420", quantize=path, **KW)
    want = JDr.run_validation(datacfg, cfg, None, transfer="yuv420",
                              quantize=path, **KW)
    _same_accuracies(got, want)
    with pytest.raises(ValueError, match="quantize=True requires "
                                         "transfer='rgb'"):
        TDr.run_validation(datacfg, cfg, wfile, device="cpu",
                           transfer="yuv420", quantize=True, **KW)


@pytest.mark.parametrize("pick", ["class_id", "per_class"])
def test_run_validation_multi_yuv420_matches_jax(occlusion, pick):  # noqa: F811
    _native_or_skip()
    datacfgs, _, cfg, wfile = occlusion
    kw = dict(batch_size=2, num_workers=0, compute_dtype=None, verbose=False,
              transfer="yuv420")
    tdc = jdc = datacfgs["ape"]
    if pick == "per_class":         # a DataConfig has no class_id key
        tdc = data_config_from_options(read_data_cfg(tdc))
        jdc = jdco(jread(jdc))
    got = TDr.run_validation_multi(tdc, cfg, wfile, device="cpu", **kw)
    want = JDr.run_validation_multi(jdc, cfg, wfile, **kw)
    assert got["n_samples"] == want["n_samples"] == 3
    assert got["acc_table"] == want["acc_table"]
    np.testing.assert_allclose(got["mean_err_2d"], want["mean_err_2d"],
                               rtol=1e-3)


def test_cli_valid_transfer_yuv420(linemod, capsys):  # noqa: F811
    _native_or_skip()
    datacfg, cfg, wfile = linemod
    assert tcli(["valid", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--weightfile", wfile, "--transfer", "yuv420",
                 "--batch_size", "3", "--device", "cpu"]) == 0
    assert "Acc using 5 px 2D Projection" in capsys.readouterr().out


def test_trainer_eval_transfer_yuv420(monkeypatch):
    """``eval_transfer="yuv420"`` reaches the in-training eval as is;
    ``auto`` still picks only ``bank`` or ``rgb``."""
    rc = TDr.TrainRunConfig(eval_transfer="yuv420", device="cpu")
    assert TDr._resolve_eval_transfer(rc, 1 << 20, torch.device("cpu")) \
        == "yuv420"
    monkeypatch.setattr(TDr, "hbm_free_bytes", lambda device=None: 0)
    rc = TDr.TrainRunConfig(eval_transfer="auto", device="cpu")
    assert TDr._resolve_eval_transfer(rc, 1 << 20, torch.device("cpu")) \
        == "rgb"
    import argparse
    from singleshotpose_tpu_torch.cli import _add_train_flags
    p = argparse.ArgumentParser()
    _add_train_flags(p)
    args = p.parse_args(["--eval_transfer", "yuv420",
                         "--loader_backend", "native"])
    assert (args.eval_transfer, args.loader_backend) == ("yuv420", "native")
