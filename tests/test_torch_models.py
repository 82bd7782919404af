"""PyTorch port vs the JAX package: spec, layers, weights codec, BN fold and
the Darknet forward (singleshotpose_tpu_torch/models, zoo, weights).

The same numpy inputs go through both packages on the CPU.  Tolerances:
exact where the JAX side is exact (spec, codec, reorg, pools, leaky);
rtol 1e-6 where an rsqrt or a sqrt may differ by one ulp (BN, fold); 1e-4
of max|ref| for an f32 forward and 2e-2 for a bf16 forward, whose convs sum
in another order and so round some bf16 values the other way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import weights as JW
from singleshotpose_tpu import zoo as jzoo
from singleshotpose_tpu.models import layers as JL
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold

from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch import zoo as tzoo
from singleshotpose_tpu_torch.models import layers as TL
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm,
                                                     stem_supported)
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec

from torch_port_helpers import TINY_BLOCKS, jax_params, rel_err


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("builder", ["yolo_pose_single", "yolo_pose_multi",
                                     "yolo_pose_pretrain", "tiny"])
def test_spec_and_zoo_match_jax(builder):
    if builder == "tiny":
        jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    else:
        jspec, tspec = getattr(jzoo, builder)(), getattr(tzoo, builder)()
    assert tspec.blocks == jspec.blocks
    assert [type(l).__name__ for l in tspec.layers] == \
        [type(l).__name__ for l in jspec.layers]
    assert [dataclasses.asdict(l) for l in tspec.layers] == \
        [dataclasses.asdict(l) for l in jspec.layers]
    assert tspec.out_filters == jspec.out_filters
    assert tspec._live == jspec._live
    # the port's typed configs are its own copies of the JAX dataclasses:
    # equal field by field
    fields = lambda c: None if c is None else dataclasses.asdict(c)
    assert fields(tspec.net) == fields(jspec.net)
    assert fields(tspec.region) == fields(jspec.region)
    assert (tspec.num_keypoints, tspec.num_classes, tspec.num_anchors) == \
        (jspec.num_keypoints, jspec.num_classes, jspec.num_anchors)


def test_resolve_model_accepts_zoo_names(tmp_path):
    from torch_port_helpers import TINY_CFG
    spec = tzoo._resolve_model("yolo-pose")
    assert spec.blocks == jzoo.yolo_pose_single().blocks
    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    assert tzoo._resolve_model(str(cfg)).blocks == JSpec.from_cfg(str(cfg)).blocks
    assert tzoo._resolve_model(spec) is spec


def test_layers_bitexact_against_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 12, 6).astype(np.float32)        # NHWC
    xt = _nchw(x)
    np.testing.assert_array_equal(_nhwc(TL.reorg(xt, 2)),
                                  np.asarray(JL.reorg(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(_nhwc(TL.max_pool(xt, 2, 2)),
                                  np.asarray(JL.max_pool(jnp.asarray(x), 2, 2)))
    np.testing.assert_array_equal(
        _nhwc(TL.max_pool_stride1(xt)),
        np.asarray(JL.max_pool_stride1(jnp.asarray(x))))
    np.testing.assert_array_equal(_nhwc(TL.leaky_relu(xt)),
                                  np.asarray(JL.leaky_relu(jnp.asarray(x))))
    # bf16: the slope rounds to bf16 before the multiply on both sides
    xb = jnp.asarray(x, jnp.bfloat16)
    np.testing.assert_array_equal(
        _nhwc(TL.leaky_relu(xt.to(torch.bfloat16))),
        np.asarray(JL.leaky_relu(xb), np.float32))
    # a mean: the two libraries sum in another order
    np.testing.assert_allclose(
        TL.global_avg_pool(xt).numpy(),
        np.asarray(JL.global_avg_pool(jnp.asarray(x))), rtol=1e-6, atol=1e-7)


def test_batch_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 5, 7, 16).astype(np.float32)
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.randn(16) * 0.1
    mean, var = rng.randn(16) * 0.1, rng.uniform(0.5, 1.5, 16)
    args = [a.astype(np.float32) for a in (scale, bias, mean, var)]
    got = _nhwc(TL.batch_norm(_nchw(x), *map(torch.from_numpy, args)))
    ref = np.asarray(JL.batch_norm(jnp.asarray(x), *map(jnp.asarray, args)))
    # rsqrt may differ by one ulp between the two libraries
    np.testing.assert_allclose(got, ref, rtol=1e-6,
                               atol=1e-6 * np.abs(ref).max())


def test_weights_file_from_jax_loads_bitexact(tmp_path):
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=2)
    path = str(tmp_path / "net.weights")
    JW.save_weights(jspec, params, stats, path, seen=1234)
    header, state = TW.load_weights(tspec, path)
    assert header.seen == 1234
    want = TW.params_from_jax(tspec, params, stats)
    assert state.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(state[k].numpy(), want[k].numpy())
    # the port's state loads into its module, and writes the same bytes back
    Darknet(tspec).load_state_dict(state)
    out = str(tmp_path / "back.weights")
    TW.save_weights(tspec, state, out, seen=1234)
    with open(path, "rb") as a, open(out, "rb") as b:
        assert a.read() == b.read()


def test_fold_batchnorm_matches_jax():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=3)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    got = fold_batchnorm(model)
    ref = jfold(jspec, params, stats)
    assert got.keys() == ref.keys()
    for name in ref:
        w = np.asarray(ref[name]["w"]).transpose(3, 2, 0, 1)
        np.testing.assert_allclose(got[name]["w"].numpy(), w, rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(got[name]["b"].numpy(),
                                   np.asarray(ref[name]["b"]), rtol=1e-6,
                                   atol=1e-7)


@pytest.fixture(scope="module")
def tiny_pair():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=4)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    img = np.random.RandomState(5).rand(2, 64, 64, 3).astype(np.float32)
    return jspec, tspec, params, stats, model, img


@pytest.mark.parametrize("folded", [False, True], ids=["apply", "folded"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_tiny_forward_matches_jax(tiny_pair, folded, dtype):
    jspec, tspec, params, stats, model, img = tiny_pair
    jcd = jnp.bfloat16 if dtype == "bf16" else None
    tcd = torch.bfloat16 if dtype == "bf16" else None
    with torch.inference_mode():
        if folded:
            got = apply_folded(tspec, fold_batchnorm(model),
                               torch.from_numpy(img), compute_dtype=tcd)
            ref = jspec.apply_folded(jfold(jspec, params, stats),
                                     jnp.asarray(img), compute_dtype=jcd)
        else:
            got = model(torch.from_numpy(img), compute_dtype=tcd)
            ref = jspec.apply(params, jnp.asarray(img), batch_stats=stats,
                              compute_dtype=jcd)
    assert tuple(got.shape) == ref.shape == (2, 4, 4, 20)
    assert rel_err(got.float().numpy(), ref) <= (2e-2 if dtype == "bf16"
                                                 else 1e-4)


CLASSIFIER_BLOCKS = [
    {"type": "net", "channels": "3", "height": "16", "width": "16"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "8",
     "size": "3", "stride": "1", "pad": "1", "activation": "leaky"},
    {"type": "convolutional", "batch_normalize": "1", "filters": "8",
     "size": "3", "stride": "1", "pad": "1", "activation": "relu"},
    {"type": "shortcut", "from": "-2", "activation": "leaky"},
    {"type": "maxpool", "size": "2", "stride": "2"},
    {"type": "convolutional", "batch_normalize": "0", "filters": "6",
     "size": "1", "stride": "1", "pad": "1", "activation": "linear"},
    {"type": "avgpool"},
    {"type": "connected", "output": "5", "activation": "linear"},
    {"type": "softmax"},
    {"type": "cost"},
]


def test_classifier_layers_and_fc_codec_match_jax(tmp_path):
    """The layer types the pose nets do not use: shortcut, relu, avgpool,
    connected, softmax, cost — forward and weights codec."""
    jspec, tspec = JSpec(CLASSIFIER_BLOCKS), TSpec(CLASSIFIER_BLOCKS)
    assert [dataclasses.asdict(l) for l in tspec.layers] == \
        [dataclasses.asdict(l) for l in jspec.layers]
    params, stats = jax_params(jspec, seed=8)
    rng = np.random.RandomState(9)
    params["fc_4"] = {"w": rng.randn(6, 5).astype(np.float32),
                      "b": rng.randn(5).astype(np.float32)}
    path = str(tmp_path / "cls.weights")
    JW.save_weights(jspec, params, stats, path)
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, path)[1])
    img = rng.rand(2, 16, 16, 3).astype(np.float32)
    with torch.inference_mode():
        got = model(torch.from_numpy(img))
        got_folded = apply_folded(tspec, fold_batchnorm(model),
                                  torch.from_numpy(img))
    ref = jspec.apply(params, jnp.asarray(img), batch_stats=stats)
    assert tuple(got.shape) == ref.shape == (2, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got_folded.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_stem_pattern_detected():
    assert stem_supported(tzoo.yolo_pose_single(), torch.bfloat16)
    assert stem_supported(TSpec(TINY_BLOCKS), torch.bfloat16)
    assert not stem_supported(tzoo.yolo_pose_single(), None)
    assert not stem_supported(tzoo.yolo_pose_single(), torch.float32)


def test_full_width_yolo_pose_single_matches_jax():
    """The full ~50.6 M-parameter net, once, at 64², batch 1, f32."""
    jspec, tspec = jzoo.yolo_pose_single(), tzoo.yolo_pose_single()
    params, stats = jax_params(jspec, seed=6)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    n_params = sum(t.numel() for t in model.state_dict().values())
    assert 50_000_000 < n_params < 51_000_000
    img = np.random.RandomState(7).rand(1, 64, 64, 3).astype(np.float32)
    with torch.inference_mode():
        got = apply_folded(tspec, fold_batchnorm(model), torch.from_numpy(img))
    ref = jax.jit(lambda p, x: jspec.apply_folded(p, x))(
        jfold(jspec, params, stats), jnp.asarray(img))
    assert tuple(got.shape) == ref.shape == (1, 2, 2, 20)
    assert rel_err(got.numpy(), ref) <= 1e-3
