"""The port's compiled-program paths on the CPU, against the JAX package
where it has the same function (singleshotpose_tpu_torch/ops/losses.py,
training.py, drivers.py, cli.py, serving.py).

``region_loss`` with a 0-dim tensor epoch equals JAX's with a traced epoch
on both sides of the pretrain gate (loss and stats rtol 1e-6, gradient
w.r.t. the head 1e-6 of its max), and the int-epoch loss bit for bit.
:func:`training.sgd_update` with a tensor lr equals ``sgd_apply`` (rtol
1e-6, atol 1e-7: an ulp where torch fuses the decay's multiply-add), from
zero and from carried momentum.  On the CPU, which records no CUDA graph
and compiles nothing, ``precompile_buckets`` hands back the eager step and
leaves the state bit for bit, and a run with it trains to the same weights
as one without, for both trainers; ``--profile_dir`` writes a trace.
``aot_serving`` runs ``make_serving_fn`` under a fixed-shape contract, and
the ``MicroBatcher`` takes a ``{bucket: fn}`` dict and ``start=False``, as
``tests/test_serving.py`` holds the JAX versions.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import training as JTr
from singleshotpose_tpu.ops import losses as JLo

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import training as TTr
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models.darknet import (Darknet, DarknetSpec,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.ops import losses as TLo

from test_drivers import TINY_CFG, _make_synthetic_linemod
from test_torch_loss import _loss_inputs
from test_torch_multi_train import occ_tree  # noqa: F401  (a fixture)
from test_torch_training import B, DECAY, LR, MOM, _batches
from torch_port_helpers import TINY_BLOCKS


@pytest.mark.parametrize("epoch", [15, 16], ids=["at-gate", "past-gate"])
@pytest.mark.parametrize("variant", ["single", "multi"])
def test_region_loss_with_a_device_epoch_matches_jax(variant, epoch):
    if variant == "single":
        nA, C, H, W, extra = 1, 1, 13, 13, {}
    else:
        nA, C, H, W = 5, 3, 6, 5
        extra = dict(num_classes=C, num_anchors=nA, with_class_loss=True,
                     anchors=(1.08, 1.19, 3.42, 4.41, 6.63, 11.38, 9.42,
                              5.11, 16.62, 10.52))
    head, target = _loss_inputs(4, H, W, nA, C, seed=11 + nA)
    jcfg = JLo.RegionLossConfig(use_pallas=False, **extra)
    tcfg = TLo.RegionLossConfig(**extra)

    @jax.jit
    def jloss(h, e):
        return JLo.region_loss(h, jnp.asarray(target), e, jcfg)

    (jl, jstats), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        jnp.asarray(head), jnp.int32(epoch))

    def port(e):
        h = torch.from_numpy(head).requires_grad_(True)
        loss, stats = TLo.region_loss(h, torch.from_numpy(target), e, tcfg)
        loss.backward()
        return stats, h.grad

    stats, grad = port(torch.tensor(epoch))
    for k in jstats:
        want = float(np.asarray(jstats[k]))
        assert float(stats[k]) == pytest.approx(want, rel=1e-6, abs=1e-6), k
    jg = np.asarray(jgrad)
    assert np.abs(grad.numpy() - jg).max() <= 1e-6 * np.abs(jg).max()
    gated = float(stats["loss_x"] + stats["loss_y"] + stats["loss_cls"])
    assert (float(stats["loss"]) == pytest.approx(gated, rel=1e-6)) == \
        (epoch <= 15)

    int_stats, int_grad = port(epoch)
    for k in stats:
        assert torch.equal(int_stats[k], stats[k]), k
    assert torch.equal(int_grad, grad)


@pytest.mark.parametrize("carried", [False, True],
                         ids=["zero-momentum", "carried-momentum"])
def test_sgd_update_with_a_tensor_lr_matches_jax(carried):
    model = Darknet(DarknetSpec(TINY_BLOCKS))
    rng = np.random.RandomState(5)
    p, g, m = ({n: rng.randn(*t.shape).astype(np.float32)
                for n, t in model.named_parameters()} for _ in range(3))
    if not carried:
        m = {n: np.zeros_like(v) for n, v in m.items()}
    jp, jm = JTr.sgd_apply(*({k: jnp.asarray(v) for k, v in d.items()}
                             for d in (p, g, m)),
                           np.float32(LR), DECAY * B, MOM)
    state = TTr.init_train_state(model, weight_decay=DECAY * B, momentum=MOM)
    for name, t in model.named_parameters():
        t.data.copy_(torch.from_numpy(p[name]))
        t.grad = torch.from_numpy(g[name].copy())
        if carried:
            state.optimizer.state[t]["momentum_buffer"] = \
                torch.from_numpy(m[name].copy())
    TTr.sgd_update(state.optimizer, torch.tensor(LR, dtype=torch.float32))
    for name, t in model.named_parameters():
        buf = state.optimizer.state[t]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), np.asarray(jm[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        # the gradient is read, not overwritten
        np.testing.assert_array_equal(t.grad.numpy(), g[name])


def _tiny_state(seed=0):
    model = Darknet(DarknetSpec(TINY_BLOCKS),
                    generator=torch.Generator().manual_seed(seed))
    return TTr.init_train_state(model, weight_decay=DECAY * B, momentum=MOM)


def _snapshot(state):
    return ({k: v.clone() for k, v in state.model.state_dict().items()},
            {id(p): state.optimizer.state[p].get("momentum_buffer")
             for p in state.model.parameters()}, state.seen)


def test_cpu_precompile_buckets_leaves_the_state_as_it_was():
    state = _tiny_state()
    step = TTr.make_train_step(TLo.RegionLossConfig(), compute_dtype=None)
    imgs, tgt = _batches(1, seed=2)[0]
    step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR, 16)
    sd, bufs, seen = _snapshot(state)
    bufs = {k: v.clone() for k, v in bufs.items()}
    got = TDr._precompile_buckets(step, state, (64, 96, 128), B, 9)
    assert got is step                        # no graphs on the CPU
    sd2, bufs2, seen2 = _snapshot(state)
    assert seen2 == seen == B
    for k in sd:
        assert torch.equal(sd2[k], sd[k]), k
    for k in bufs:
        assert torch.equal(bufs2[k], bufs[k])
    with pytest.raises(ValueError, match="needs a CUDA device"):
        TTr.capture_train_step(step, state, (64,), B, 1050)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_captured_synth")
    datacfg, _ = _make_synthetic_linemod(tmp)
    cfgfile = tmp / "tiny.cfg"
    cfgfile.write_text(TINY_CFG)
    return datacfg, str(cfgfile), tmp


def _same_states(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])
    assert a.seen == b.seen


def test_run_training_with_precompile_buckets_trains_the_same(synth):
    datacfg, cfgfile, tmp = synth
    runs = []
    for precompile in (False, True):
        rc = TDr.TrainRunConfig(eval_after=100, num_workers=1,
                                bg_dir="/nonexistent", log_every=1,
                                max_epochs_override=1, compute_dtype=None,
                                device="cpu", precompile_buckets=precompile)
        runs.append(TDr.run_training(datacfg, cfgfile, None, 0, rc))
    a, b = runs
    assert a["history"]["training_losses"] == b["history"]["training_losses"]
    assert len(a["history"]["training_losses"]) == 3
    _same_states(a["state"], b["state"])


def test_run_training_multi_with_precompile_buckets_trains_the_same(
        occ_tree):  # noqa: F811
    root, lm, occ, _, cfg = occ_tree
    runs = []
    for precompile in (False, True):
        rc = TDr.TrainRunConfig(eval_after=100, num_workers=1,
                                bg_dir="/nonexistent", log_every=1,
                                max_epochs_override=1, compute_dtype=None,
                                device="cpu", precompile_buckets=precompile)
        runs.append(TDr.run_training_multi(occ, cfg, None, 0, None, lm, rc))
    a, b = runs
    assert a["history"]["training_losses"] == b["history"]["training_losses"]
    assert len(a["history"]["training_losses"]) == 2
    _same_states(a["state"], b["state"])


def test_cli_train_precompile_buckets_and_profile_dir(synth, capsys):
    """Four epochs of three batches take the processed batches past the
    profiler window's default steps 5-10; the trace holds the step's
    ``ssp.train.to_device`` spans and, in the prefetch thread's own lane,
    the loader's ``ssp.loader.batch``."""
    datacfg, cfgfile, tmp = synth
    prof = str(tmp / "profile")
    assert tcli(["train", "--datacfg", datacfg, "--modelcfg", cfgfile,
                 "--initweightfile", "", "--bg_dir", "/nonexistent",
                 "--max_epochs", "4", "--precompile_buckets",
                 "--profile_dir", prof, "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "nothing to precompile on cpu" in out
    (trace,) = glob.glob(os.path.join(prof, "*.json"))
    assert os.path.basename(trace) == "train_steps_5_10.json"
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    assert any("conv" in e.get("name", "") for e in events)
    lanes = {name: {e["tid"] for e in events if e.get("name") == name}
             for name in ("ssp.train.to_device", "ssp.loader.batch")}
    assert all(lanes.values()), lanes
    assert lanes["ssp.train.to_device"].isdisjoint(lanes["ssp.loader.batch"])


@pytest.fixture(scope="module")
def tiny_serving():
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(4))
    imgs = np.random.RandomState(8).randint(0, 256, (4, 64, 64, 3), np.uint8)
    return spec, fold_batchnorm(model), imgs


@pytest.mark.parametrize("pick", [("best",), ("grid",)], ids=["best", "grid"])
def test_aot_serving_equals_make_serving_fn_and_fixes_its_shape(tiny_serving,
                                                                pick):
    spec, folded, imgs = tiny_serving
    fn = TS.aot_serving(spec, folded, batch=4, width=64, height=64,
                        pick=pick, compute_dtype=None)
    want = TS.make_serving_fn(spec, folded, pick=pick, compute_dtype=None)(
        imgs)
    got = fn(imgs)
    for g, w in zip(*(([x] if isinstance(x, torch.Tensor) else x)
                      for x in (got, want))):
        assert torch.equal(g, w)
    # a wrong shape or dtype fails loudly
    with pytest.raises(ValueError, match="takes"):
        fn(imgs[:2])
    with pytest.raises(ValueError, match="takes"):
        fn(imgs.astype(np.float32) / 255.0)


def test_microbatcher_per_bucket_fns(tiny_serving):
    """A ``{bucket: fn}`` dict of ``aot_serving`` functions routes each
    batch to its bucket's function; the answers equal one direct call."""
    spec, folded, imgs = tiny_serving
    used = []

    def make(b):
        inner = TS.aot_serving(spec, folded, batch=b, width=64, height=64,
                               compute_dtype=None)

        def fn(frames):
            assert frames.shape[0] == b
            used.append(b)
            return inner(frames)
        return fn

    serve = TS.make_serving_fn(spec, folded, pick=("best",),
                               compute_dtype=None)
    direct = serve(imgs)
    mb = TS.MicroBatcher({b: make(b) for b in (1, 4)}, height=64, width=64,
                         buckets=(1, 4), max_delay_ms=1.0, start=False)
    futs = [mb.submit(im) for im in imgs[:3]]
    mb.start()
    got = torch.stack([f.result(timeout=60) for f in futs])
    mb.close()
    assert used == [4]                 # queued before start: one padded batch
    assert torch.equal(got, direct[:3])
    with TS.MicroBatcher({b: make(b) for b in (1, 4)}, height=64, width=64,
                         buckets=(1, 4), max_delay_ms=1.0,
                         start=False) as mb2:      # the context starts it
        # a lone request: a batch-1 call (the CPU's convs round by batch)
        assert torch.equal(mb2.infer(imgs[3], timeout=60),
                           serve(imgs[3:])[0])
    assert used == [4, 1]


def test_microbatcher_start_false_and_missing_buckets(tiny_serving):
    spec, folded, imgs = tiny_serving
    serve = TS.make_serving_fn(spec, folded, pick=("best",),
                               compute_dtype=None)
    with pytest.raises(ValueError, match=r"no serve_fn for buckets \[2, 8\]"):
        TS.MicroBatcher({1: serve, 4: serve}, height=64, width=64,
                        buckets=(1, 2, 4, 8))
    # never started: close fails what was queued and joins no thread
    mb = TS.MicroBatcher(serve, height=64, width=64, buckets=(1, 2),
                         start=False)
    fut = mb.submit(imgs[0])
    mb.close()
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=60)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(imgs[0])
    assert mb not in TS._RUNNING
