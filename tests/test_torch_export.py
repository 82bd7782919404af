"""PyTorch port: the serving artifact (singleshotpose_tpu_torch/serving.py
``export_serving`` / ``save_exported`` / ``load_serving``, ``cli export``),
against the port's in-process serve and JAX's own exported serve, and the
kernels' custom ops (``ssp::stem_conv_pool_infer``, ``ssp::int8_conv``).

Tolerances, with their reasons:

- the loaded artifact equals the port's ``make_serving_fn`` bit for bit:
  the same ATen ops and custom ops run on the same shapes, for a fixed
  batch and a symbolic one, every pick, u8 and float input;
- against JAX's exported serve on the same weights, loaded by JAX's
  ``load_serving`` and compiled without excess precision (XLA's CPU
  compiler otherwise keeps some bf16 values in f32): f32 boxes to 1e-5 (the
  same f32 net, summed in another order), bf16 to 2e-2 of a corner's scale
  (a bf16 conv output rounds a few values the other way), as
  ``tests/test_torch_serving.py`` holds the in-process serves; int8 bit for
  bit, as ``tests/test_torch_quantize.py`` holds the in-process int8 serve
  (every conv int8: integer sums, roundings where XLA's are).
"""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import serving as JS
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models import quantize as JQ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold

from singleshotpose_tpu_torch import checkpoint as TC
from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import training as TT
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch import zoo
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models import quantize as TQ
from singleshotpose_tpu_torch.models.darknet import Darknet, fold_batchnorm
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops import int8_conv as I
from singleshotpose_tpu_torch.ops import stem

from torch_port_helpers import (TINY_BLOCKS, TINY_CFG, TINY_MULTI_BLOCKS,
                                jax_params, port_folded, port_q)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 64


@pytest.fixture(scope="module")
def nets():
    """{"single" | "multi" | "int8": (jax spec, port spec, JAX params, the
    port's)}, one set of JAX weights each, carried across."""
    out = {}
    for name, blocks, seed in (("single", TINY_BLOCKS, 21),
                               ("multi", TINY_MULTI_BLOCKS, 22)):
        jspec, tspec = JSpec(blocks), TSpec(blocks)
        params, stats = jax_params(jspec, seed=seed)
        jf = jfold(jspec, params, stats)
        out[name] = (jspec, tspec, jf, port_folded(jf))
    jspec, tspec, jf, _ = out["single"]
    calib = np.random.RandomState(23).rand(2, SIZE, SIZE, 3).astype(np.float32)
    jq = JQ.quantize_folded(
        jspec, jf, JQ.calibrate_activations(jspec, jf, jnp.asarray(calib),
                                            per_channel=True),
        skip_layers=())
    out["int8"] = (jspec, tspec, jax.device_get(jq), port_q(jq))
    return out


@pytest.fixture(scope="module")
def frames():
    return np.random.RandomState(24).randint(0, 256, (4, SIZE, SIZE, 3),
                                             np.uint8)


def _save_load(exported, path):
    TS.save_exported(str(path), exported)
    return TS.load_serving(str(path), device="cpu")


def _equal(got, want):
    if isinstance(want, torch.Tensor):
        assert isinstance(got, torch.Tensor)
        assert torch.equal(got, want)
        return
    assert type(got) is type(want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# (net, pick): the single-object picks on the single-object net, the class
# picks on the multi-object one (13 classes, 5 anchors)
_PICKS = [("single", None), ("single", ("best",)),
          ("multi", ("per_class", 0.05)), ("multi", ("for_class", 3, 0.05))]


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("net,pick", _PICKS,
                         ids=["grid", "best", "per_class", "for_class"])
def test_round_trip_symbolic_batch_equals_serve(nets, frames, tmp_path, net,
                                                pick, dtype):
    _, tspec, _, tf = nets[net]
    cd = torch.bfloat16 if dtype == "bf16" else None
    loaded = _save_load(TS.export_serving(tspec, tf, width=SIZE, height=SIZE,
                                          pick=pick, compute_dtype=cd),
                        tmp_path / "a.pt2")
    serve = TS.make_serving_fn(tspec, tf, pick=pick, compute_dtype=cd)
    for b in (1, 3, 4):
        _equal(loaded(frames[:b]), serve(frames[:b]))


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("input_dtype", ["uint8", "float32"])
def test_round_trip_fixed_batch_equals_serve(nets, frames, tmp_path, dtype,
                                             input_dtype):
    _, tspec, _, tf = nets["single"]
    cd = torch.bfloat16 if dtype == "bf16" else None
    x = frames if input_dtype == "uint8" else \
        torch.from_numpy(frames).float() / 255.0
    loaded = _save_load(TS.export_serving(
        tspec, tf, width=SIZE, height=SIZE, batch=4, compute_dtype=cd,
        input_dtype=getattr(torch, input_dtype)), tmp_path / "a.pt2")
    want = TS.make_serving_fn(tspec, tf, pick=("best",), compute_dtype=cd)(x)
    _equal(loaded(x), want)
    with pytest.raises(Exception):
        loaded(x[:3])                  # the batch is fixed


def test_float_input_symbolic_batch(nets, frames, tmp_path):
    _, tspec, _, tf = nets["single"]
    x = torch.from_numpy(frames).float() / 255.0
    loaded = _save_load(TS.export_serving(
        tspec, tf, width=SIZE, height=SIZE, input_dtype=torch.float32),
        tmp_path / "a.pt2")
    serve = TS.make_serving_fn(tspec, tf, pick=("best",))
    for b in (1, 4):
        _equal(loaded(x[:b]), serve(x[:b]))


def test_float64_array_runs_as_f32(nets, tmp_path):
    """A float64 numpy array (``np.random.rand``) through a float-input
    artifact is cast to the program's f32, as JAX's loaded artifact takes
    it with x64 off: the boxes equal ``make_serving_fn``'s on the same
    array and on the array as f32, bit for bit."""
    _, tspec, _, tf = nets["single"]
    loaded = _save_load(TS.export_serving(
        tspec, tf, width=SIZE, height=SIZE, input_dtype=torch.float32),
        tmp_path / "a.pt2")
    x = np.random.RandomState(25).rand(2, SIZE, SIZE, 3)
    assert x.dtype == np.float64
    serve = TS.make_serving_fn(tspec, tf, pick=("best",))
    got = loaded(x)
    assert got.dtype == torch.float32
    _equal(got, serve(x))
    _equal(got, serve(x.astype(np.float32)))


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_artifact_matches_jax_artifact(nets, frames, tmp_path, kind):
    jspec, tspec, jp, tp = nets["int8" if kind == "int8" else "single"]
    jcd, tcd = (jnp.float32, None) if kind == "f32" else \
        (jnp.bfloat16, torch.bfloat16)
    jpath = str(tmp_path / "jax.sspx")
    JS.save_exported(jpath, JS.export_serving(
        jspec, jp, width=SIZE, height=SIZE, compute_dtype=jcd))
    # JAX's loaded artifact compiled without excess precision, so that its
    # CPU program rounds to bf16 where the port does (the repo's bf16
    # references are compiled so: tests/test_torch_training.py:_strict_jit)
    x = jnp.asarray(frames)
    want = np.asarray(JS.load_serving(jpath).lower(x).compile(
        compiler_options={"xla_allow_excess_precision": False})(x))
    got = _save_load(TS.export_serving(tspec, tp, width=SIZE, height=SIZE,
                                       compute_dtype=tcd),
                     tmp_path / "port.pt2")(frames).numpy()
    assert got.shape == want.shape == (4, 21)
    if kind == "int8":
        np.testing.assert_array_equal(got, want)
    else:
        tol = 1e-5 if kind == "f32" else 2e-2
        np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def _op_nodes(exported, name):
    return [n for n in exported.graph.nodes if n.op == "call_function"
            and str(n.target).startswith(f"ssp.{name}")]


def test_graph_holds_one_stem_op_in_bf16(nets):
    _, tspec, _, tf = nets["single"]
    bf16 = TS.export_serving(tspec, tf, width=SIZE, height=SIZE)
    assert len(_op_nodes(bf16, "stem_conv_pool_infer")) == 1
    assert not _op_nodes(bf16, "int8_conv")
    f32 = TS.export_serving(tspec, tf, width=SIZE, height=SIZE,
                            compute_dtype=None)
    assert not _op_nodes(f32, "stem_conv_pool_infer")


def test_graph_holds_one_int8_op_per_quantized_conv(nets):
    _, tspec, _, tq = nets["int8"]
    exported = TS.export_serving(tspec, tq, width=SIZE, height=SIZE)
    n_q = sum("wq" in v for v in tq.values())
    assert n_q == len(tspec.conv_specs())        # skip_layers=(): every conv
    assert len(_op_nodes(exported, "int8_conv")) == n_q
    assert not _op_nodes(exported, "stem_conv_pool_infer")


# ---------------------------------------------------------------------------
# the custom ops
# ---------------------------------------------------------------------------


def test_stem_op_opcheck_and_plain_version():
    rng = np.random.RandomState(25)
    img = torch.from_numpy(rng.rand(2, 10, 12, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 3, 3, 3).astype(np.float32) * 0.3)
    b = torch.from_numpy(rng.randn(32).astype(np.float32) * 0.1)
    torch.library.opcheck(torch.ops.ssp.stem_conv_pool_infer.default,
                          (img, w, b))
    assert torch.equal(stem.stem_conv_pool_infer(img, w, b),
                       stem.stem_conv_pool_infer_reference(img, w, b))


def test_wrappers_skip_the_dispatcher_outside_a_trace(monkeypatch):
    """Outside a trace each wrapper calls its device's implementation
    itself; the op (and through it the same implementation) is what a
    traced program calls."""
    calls = []

    def counted(fn):
        def wrapped(*args):
            calls.append(fn.__name__)
            return fn(*args)
        return wrapped

    monkeypatch.setattr(I, "_int8_conv_cpu", counted(I._int8_conv_cpu))
    monkeypatch.setattr(stem, "stem_conv_pool_infer_reference",
                        counted(stem.stem_conv_pool_infer_reference))
    rng = np.random.RandomState(31)
    x = torch.from_numpy(rng.randint(-127, 128, (1, 5, 5, 4)).astype(np.int8))
    wk = I.pack_weights(torch.from_numpy(
        rng.randint(-127, 128, (3, 3, 4, 8)).astype(np.int8)))
    img = torch.from_numpy(rng.rand(1, 4, 4, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(32, 3, 3, 3).astype(np.float32))
    b = torch.zeros(32)
    y = I.int8_conv(x, wk, 3, 1, 1)
    s = stem.stem_conv_pool_infer(img, w, b)
    assert calls == ["_int8_conv_cpu", "stem_conv_pool_infer_reference"]
    assert torch.equal(torch.ops.ssp.int8_conv.default(
        x, wk, 3, 1, 1, *I._flatten(None), None)[0], y)
    assert torch.equal(torch.ops.ssp.stem_conv_pool_infer.default(img, w, b),
                       s)
    assert len(calls) == 2               # the ops hold the unpatched kernels


def _epilogue_modes():
    """Every epilogue ``epilogue_plan`` gives a conv of the zoo models and
    the tiny net, with every conv quantized or the default ones: (writes,
    leaky) from the plan, times the value's dtype (bf16 or f32) and, where
    it writes int8, the consumer's quantizer (per channel or scalar, a
    multiply in the serve's constants form or a division in the eval's);
    then the bare int32 product, None."""
    modes = set()
    for spec in (zoo.yolo_pose_single(), zoo.yolo_pose_multi(),
                 TSpec(TINY_BLOCKS)):
        convs = {l.name: l for l in spec.conv_specs()}
        for quantized in (set(convs),
                          set(convs) - TQ.default_skip_layers(spec)):
            for lname, plan in TQ.epilogue_plan(spec, quantized).items():
                leaky = convs[lname].activation == "leaky"
                quants = [None] if plan.consumer is None else \
                    [(q, d) for q in ("per_channel", "scalar")
                     for d in (False, True)]
                for dtype in ("bf16", "f32"):
                    for q in quants:
                        modes.add((plan.writes, dtype, leaky, q))
    return [None] + sorted(modes, key=repr)


_MODES = _epilogue_modes()


def _mode_id(mode):
    if mode is None:
        return "int32"
    writes, dtype, leaky, q = mode
    quant = "" if q is None else f"-{q[0]}-{'divide' if q[1] else 'mul'}"
    return f"{writes}-{dtype}-{'leaky' if leaky else 'linear'}{quant}"


def test_epilogue_modes_cover_the_plans():
    writes = {m[0] for m in _MODES if m is not None}
    assert writes == {"compute", "int8", "both"}
    assert {m[2] for m in _MODES if m is not None} == {True, False}


@pytest.mark.parametrize("mode", _MODES, ids=_mode_id)
def test_int8_op_opcheck_in_every_epilogue_mode(mode):
    rng = np.random.RandomState(26)
    c_in, c_out = 8, 16
    x = torch.from_numpy(rng.randint(-127, 128, (2, 9, 7, c_in))
                         .astype(np.int8))
    wk = I.pack_weights(torch.from_numpy(
        rng.randint(-127, 128, (3, 3, c_in, c_out)).astype(np.int8)))
    ep = None
    if mode is not None:
        writes, dtype, leaky, q = mode
        quant = None
        if q is not None:
            n = c_out if q[0] == "per_channel" else 1
            quant = torch.from_numpy(rng.uniform(0.5, 2, n).astype(np.float32))
        scale = rng.uniform(1e-3, 1e-2, c_out).astype(np.float32)
        ep = I.Epilogue(
            torch.from_numpy(scale),
            torch.from_numpy(rng.randn(c_out).astype(np.float32)),
            dtype=torch.bfloat16 if dtype == "bf16" else None, leaky=leaky,
            quant=quant, divide=q is not None and q[1],
            value=writes != "int8")
    torch.library.opcheck(torch.ops.ssp.int8_conv.default,
                          (x, wk, 3, 2, 1, *I._flatten(ep), None))
    got = I.int8_conv(x, wk, 3, 2, 1, ep)
    want = I.int8_conv_reference(x, wk, 3, 2, 1, ep)
    if ep is None:
        assert torch.equal(got, want)
    else:
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            assert g is None or torch.equal(g, w)


# ---------------------------------------------------------------------------
# loading without jax, behind a MicroBatcher, from the CLI
# ---------------------------------------------------------------------------


_NO_JAX_LOAD = r"""
import sys
sys.modules["jax"] = None
sys.modules["singleshotpose_tpu"] = None
import numpy as np, torch
torch.set_num_threads(2)
from singleshotpose_tpu_torch.serving import load_serving
serve = load_serving(sys.argv[1], device="cpu")
got = serve(np.load(sys.argv[2])).numpy()
assert np.array_equal(got, np.load(sys.argv[3])), "boxes differ"
used = sorted(m for m in sys.modules if m.split(".")[0] in
              ("jax", "singleshotpose_tpu") and sys.modules[m] is not None)
assert not used, used
print("LOADED_WITHOUT_JAX")
"""


def test_artifact_loads_and_serves_without_jax(nets, frames, tmp_path):
    _, tspec, _, tf = nets["single"]
    path = str(tmp_path / "a.pt2")
    TS.save_exported(path, TS.export_serving(tspec, tf, width=SIZE,
                                             height=SIZE))
    np.save(tmp_path / "x.npy", frames[:3])
    np.save(tmp_path / "want.npy",
            TS.make_serving_fn(tspec, tf, pick=("best",))(frames[:3]).numpy())
    proc = subprocess.run(
        [sys.executable, "-c", _NO_JAX_LOAD, path, str(tmp_path / "x.npy"),
         str(tmp_path / "want.npy")], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED_WITHOUT_JAX" in proc.stdout


def test_load_serving_runs_on_the_card_unless_asked(nets, tmp_path,
                                                    monkeypatch):
    """Without a device, a loaded artifact runs on the card, wherever it
    was exported: with no CUDA, loading it refuses rather than serve on the
    CPU."""
    _, tspec, _, tf = nets["single"]
    path = str(tmp_path / "a.pt2")
    TS.save_exported(path, TS.export_serving(tspec, tf, width=SIZE,
                                             height=SIZE))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.load_serving(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TS.load_serving(path, device="cuda:0")
    assert TS.load_serving(path, device="cpu") is not None


def test_microbatcher_serves_a_loaded_artifact(nets, tmp_path):
    _, tspec, _, tf = nets["single"]
    loaded = _save_load(TS.export_serving(tspec, tf, width=SIZE, height=SIZE),
                        tmp_path / "a.pt2")
    imgs = np.random.RandomState(27).randint(0, 256, (16, SIZE, SIZE, 3),
                                             np.uint8)
    direct = loaded(imgs).numpy()
    got = [None] * len(imgs)
    with TS.MicroBatcher(loaded, height=SIZE, width=SIZE, buckets=(1, 2, 4),
                         max_delay_ms=5.0) as mb:
        def client(k):
            for i in range(k, len(imgs), 4):
                got[i] = mb.infer(imgs[i], timeout=60).numpy()

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    np.testing.assert_array_equal(np.stack(got), direct)


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    path = tmp_path_factory.mktemp("cfg") / "tiny.cfg"
    path.write_text(TINY_CFG)
    return str(path)


def _cli_export(tmp_path, cfg, *source, compute="float32"):
    out = str(tmp_path / "m.pt2")
    assert tcli(["export", "--modelcfg", cfg, *source, "--out", out,
                 "--width", str(SIZE), "--height", str(SIZE), "--batch", "2",
                 "--compute", compute, "--device", "cpu"]) == 0
    return TS.load_serving(out, device="cpu")


def test_cli_export_from_weights(tmp_path, tiny_cfg, frames, capsys):
    jspec = JSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=28)
    wfile = str(tmp_path / "t.weights")
    JW.save_weights(jspec, params, stats, wfile)
    loaded = _cli_export(tmp_path, tiny_cfg, "--weightfile", wfile)
    assert "exported bf16-folded serving fn (64x64, batch=2, pick=best" \
        in capsys.readouterr().out
    tspec = TSpec(TINY_BLOCKS)
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, wfile)[1])
    want = TS.make_serving_fn(tspec, fold_batchnorm(model), pick=("best",),
                              compute_dtype=None)(frames[:2])
    _equal(loaded(frames[:2]), want)


def test_cli_export_quantized_from_jax_npz(nets, tmp_path, tiny_cfg, frames,
                                           capsys):
    jspec, tspec, jq, _ = nets["int8"]
    path = str(tmp_path / "q.npz")
    JQ.save_quantized(path, jq)
    loaded = _cli_export(tmp_path, tiny_cfg, "--quantized", path,
                         compute="bfloat16")
    assert "exported int8 serving fn" in capsys.readouterr().out
    got = loaded(frames[:2])
    want = np.asarray(jax.jit(JS.make_serving_fn(
        jspec, JQ.load_quantized(path), pick=("best",)))(
            jnp.asarray(frames[:2])))
    np.testing.assert_array_equal(got.numpy(), want)
    _equal(got, TS.make_serving_fn(tspec, TQ.load_quantized(path),
                                   pick=("best",))(frames[:2]))


@pytest.mark.parametrize("step", [None, 3])
def test_cli_export_from_checkpoint(tmp_path, tiny_cfg, frames, step, capsys):
    tspec = TSpec(TINY_BLOCKS)
    ckpt = TC.Checkpointer(str(tmp_path / "ckpt"))
    models = {}
    for s, seed in ((3, 29), (5, 30)):
        model = Darknet(tspec, generator=torch.Generator().manual_seed(seed))
        ckpt.save(s, TT.init_train_state(model, weight_decay=5e-4,
                                         momentum=0.9))
        models[s] = model
    assert TC.latest_step(str(tmp_path / "ckpt")) == 5
    assert TC.latest_step(str(tmp_path / "none")) is None
    args = ["--checkpoint_dir", str(tmp_path / "ckpt")]
    if step is not None:
        args += ["--step", str(step)]
    loaded = _cli_export(tmp_path, tiny_cfg, *args)
    used = 5 if step is None else step
    assert f"exporting checkpoint step {used}" in capsys.readouterr().out
    want = TS.make_serving_fn(tspec, fold_batchnorm(models[used]),
                              pick=("best",), compute_dtype=None)(frames[:2])
    _equal(loaded(frames[:2]), want)


def test_cli_export_refuses_an_empty_checkpoint_dir(tmp_path, tiny_cfg):
    with pytest.raises(SystemExit, match="no checkpoints"):
        tcli(["export", "--modelcfg", tiny_cfg, "--checkpoint_dir",
              str(tmp_path / "none"), "--out", str(tmp_path / "m.pt2"),
              "--device", "cpu"])
