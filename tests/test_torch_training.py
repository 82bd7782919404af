"""PyTorch port vs the JAX package: training-mode BN, the train-mode forward,
the LR schedule, SGD, the train step, the weights codec after training and
the full-state checkpoint (singleshotpose_tpu_torch/models, training.py,
weights.py, checkpoint.py).

The same numpy inputs and the same starting state (carried by
``weights.train_state_from_jax``) go through both packages on the CPU.
Tolerances: f32 BN and the f32 train-mode forward rel 1e-5 of max|ref|
(the two libraries sum in another order); bf16 forwards rel 2e-2, since
their convs then round some bf16 values the other way; the schedule
exactly; SGD rel 1e-6 (an ulp where torch fuses a multiply-add); f32
gradients rel 1e-4 and a 5-step f32 trajectory rel 1e-4 (those ulps,
through BN, the loss and momentum).  One bf16 step: loss rel 2e-2, and
gradient cosine > 0.99 against JAX run op by op, where every primitive is
compiled alone and so rounds to bf16 wherever the program says, as the
eager port does; the test also measures how far JAX's own compiled
gradient lies from that, and holds the port to no worse.  The compiled JAX
side is built with ``xla_allow_excess_precision`` off, for the same reason
(the CPU compiler otherwise keeps f32 through fused bf16 chains).  Max-pool
gradients at tied windows are equal exactly.  The codec is bit for bit; a
checkpoint resume is exact on the CPU.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import training as JTr
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu.models import layers as JL
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.ops import losses as JLo

from singleshotpose_tpu_torch import training as TTr
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.checkpoint import Checkpointer
from singleshotpose_tpu_torch.models import layers as TL
from singleshotpose_tpu_torch.models.darknet import (Darknet, apply_folded,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops import losses as TLo

from torch_port_helpers import TINY_BLOCKS, jax_params, rel_err

B, IMG = 2, 64
LR, MOM, DECAY = 1e-3, 0.9, 0.0005
EPOCH = 16          # past the default 15-epoch gate: the confidence term counts


def _strict_jit(fn, *args):
    """``fn(*args)`` jitted with every bf16 rounding kept."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_allow_excess_precision": False})(*args)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2)


def _batches(n, seed=0, size=IMG):
    """``n`` (u8 images NHWC, padded targets) with one GT per image."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        imgs = rng.randint(0, 256, (B, size, size, 3)).astype(np.uint8)
        t = np.zeros((B, 50, 21), np.float32)
        t[:, 0, 1:19] = rng.uniform(0.15, 0.85, (B, 18))
        t[:, 0, 19:21] = [0.3, 0.4]
        out.append((imgs, t.reshape(B, -1)))
    return out


@pytest.fixture(scope="module")
def tiny():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=21)
    return jspec, tspec, params, stats


def _port_state(tspec, params, stats, momentum=None, seen=0, **kw):
    momentum = momentum if momentum is not None else \
        jax.tree.map(np.zeros_like, params)
    return TW.train_state_from_jax(tspec, params, stats, momentum, seen,
                                   weight_decay=DECAY * B, momentum_coef=MOM,
                                   **kw)


def _assert_state_close(tspec, state, jstate, tol):
    """Params, BN statistics, momentum and seen of the port's state against
    a JAX TrainState, each tensor to ``tol`` of its max|ref|."""
    jp = jax.tree.map(np.asarray, jstate.params)
    js = jax.tree.map(np.asarray, jstate.batch_stats)
    want = TW.params_from_jax(tspec, jp, js)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert rel_err(got[k], want[k]) <= tol, (k, rel_err(got[k], want[k]))
    jm = TW.params_from_jax(tspec, jax.tree.map(np.asarray, jstate.momentum))
    for name, p in state.model.named_parameters():
        buf = state.optimizer.state[p]["momentum_buffer"]
        assert rel_err(buf, jm[name]) <= tol, (name, rel_err(buf, jm[name]))
    assert state.seen == int(jstate.seen)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batch_norm_train_and_running_stats_match_jax(dtype):
    rng = np.random.RandomState(1)
    x = (rng.randn(3, 6, 5, 16) * 2 + 0.5).astype(np.float32)   # NHWC
    scale, bias = rng.uniform(0.5, 1.5, 16), rng.randn(16) * 0.1
    rmean, rvar = rng.randn(16) * 0.1, rng.uniform(0.5, 1.5, 16)
    scale, bias, rmean, rvar = (a.astype(np.float32)
                                for a in (scale, bias, rmean, rvar))
    jx = jnp.asarray(x, jnp.bfloat16 if dtype == "bf16" else jnp.float32)
    tx = _nchw(x).to(torch.bfloat16 if dtype == "bf16" else torch.float32)
    jy, jm, jv = JL.batch_norm_train(jx, *map(jnp.asarray,
                                              (scale, bias, rmean, rvar)))
    ty, bm, bv = TL.batch_norm_train(tx, torch.from_numpy(scale),
                                     torch.from_numpy(bias))
    tm, tv = TL.running_stat_update(torch.from_numpy(rmean),
                                    torch.from_numpy(rvar), bm, bv, 3 * 6 * 5)
    assert ty.dtype == tx.dtype and bm.dtype == torch.float32
    tol = 2e-2 if dtype == "bf16" else 1e-5
    assert rel_err(ty.permute(0, 2, 3, 1).float(), np.asarray(jy, np.float32)) \
        <= tol
    # the statistics are f32 on both sides, whatever the activations' dtype
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_train_forward_matches_jax(tiny, dtype):
    jspec, tspec, params, stats = tiny
    img = np.random.RandomState(5).rand(B, IMG, IMG, 3).astype(np.float32)
    jcd = jnp.bfloat16 if dtype == "bf16" else None
    tcd = torch.bfloat16 if dtype == "bf16" else None
    want, jstats = _strict_jit(lambda p, s, x: jspec.apply(
        p, x, batch_stats=s, train=True, compute_dtype=jcd),
        params, stats, jnp.asarray(img))
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    with torch.no_grad():
        got, new_stats = model.forward_train(torch.from_numpy(img), tcd)
    assert model.training
    assert got.dtype == torch.float32        # the head's f32 bias add
    assert tuple(got.shape) == want.shape == (B, 4, 4, 20)
    tol = 2e-2 if dtype == "bf16" else 1e-5
    assert rel_err(got.numpy(), want) <= tol
    assert new_stats.keys() == jstats.keys()
    for name in jstats:
        for k in ("mean", "var"):
            assert rel_err(new_stats[name][k], jstats[name][k]) <= tol, \
                (name, k)
    # the running buffers moved: they are what forward_train returned
    assert not np.allclose(model.conv_1.running_mean.numpy(),
                           stats["conv_1"]["mean"])


@pytest.mark.parametrize("folded", [False, True], ids=["running", "folded"])
def test_eval_forward_matches_jax(tiny, folded):
    """The port's inference forwards (the module in eval mode, and
    ``apply_folded`` over ``fold_batchnorm``) against JAX
    ``make_eval_forward``."""
    jspec, tspec, params, stats = tiny
    img = np.random.RandomState(15).rand(B, IMG, IMG, 3).astype(np.float32)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    model.train()
    jfwd = JTr.make_eval_forward(jspec, compute_dtype=None, folded=folded)
    with torch.no_grad():
        if folded:
            from singleshotpose_tpu.models.darknet import \
                fold_batchnorm as jfold
            want = jfwd(jfold(jspec, params, stats), jnp.asarray(img))
            got = apply_folded(tspec, fold_batchnorm(model),
                               torch.from_numpy(img), compute_dtype=None)
        else:
            want = jfwd(params, stats, jnp.asarray(img))
            got = model.eval()(torch.from_numpy(img), None)
    assert rel_err(got.numpy(), want) <= 1e-4


@pytest.mark.parametrize("steps,scales", [
    ((10, 20, 30), (0.1, 0.5, 2.0)),
    ((-1, 5.5, 40), (0.1, 0.1)),         # fewer scales than steps
    ((), ()),
])
def test_schedule_lr_matches_jax(steps, scales):
    for pb in (0, 4, 5, 5.5, 6, 9, 10, 11, 20, 25, 30, 31, 40, 100):
        assert TTr.schedule_lr(0.001, pb, steps, scales) == \
            JTr.schedule_lr(0.001, pb, steps, scales), pb


@pytest.mark.parametrize("carried", [False, True],
                         ids=["first-step", "carried-momentum"])
def test_sgd_matches_jax_sgd_apply(tiny, carried):
    """``torch.optim.SGD`` as ``init_train_state`` builds it takes JAX
    ``sgd_apply``'s step: from the momentum buffers it makes at the first
    step (JAX starts from zeros), and from buffers carried in."""
    _, tspec, _, _ = tiny
    model = Darknet(tspec)
    rng = np.random.RandomState(3)
    p, g, m = ({n: rng.randn(*t.shape).astype(np.float32)
                for n, t in model.named_parameters()} for _ in range(3))
    if not carried:
        m = jax.tree.map(np.zeros_like, m)
    jp, jm = JTr.sgd_apply(*(jax.tree.map(jnp.asarray, d) for d in (p, g, m)),
                           LR, DECAY * B, MOM)
    for name, t in model.named_parameters():
        t.data.copy_(torch.from_numpy(p[name]))
        t.grad = torch.from_numpy(g[name].copy())
    state = TTr.init_train_state(model, weight_decay=DECAY * B, momentum=MOM)
    if carried:
        for name, t in model.named_parameters():
            state.optimizer.state[t]["momentum_buffer"] = \
                torch.from_numpy(m[name].copy())
    for group in state.optimizer.param_groups:
        group["lr"] = LR
    state.optimizer.step()
    for name, t in model.named_parameters():
        # torch's add-with-alpha may fuse the decay's multiply-add: an ulp
        buf = state.optimizer.state[t]["momentum_buffer"]
        np.testing.assert_allclose(buf.numpy(), np.asarray(jm[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[name]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("stride", [2, 1])
def test_max_pool_gradient_at_ties_matches_jax(stride):
    """bf16 max-pool gradients route a tied window's gradient to the same
    element on both sides (XLA's SelectAndScatter, torch's max_pool2d
    backward).  Small integers make most windows tie and every sum exact."""
    rng = np.random.RandomState(11)
    x = rng.randint(0, 3, (2, 8, 8, 4)).astype(np.float32)         # NHWC
    jpool = (lambda v: JL.max_pool(v, 2, 2)) if stride == 2 else \
        JL.max_pool_stride1
    tpool = (lambda v: TL.max_pool(v, 2, 2)) if stride == 2 else \
        TL.max_pool_stride1
    jx = jnp.asarray(x, jnp.bfloat16)
    jy, vjp = jax.vjp(jpool, jx)
    g = rng.randint(-4, 5, jy.shape).astype(np.float32)
    (jg,) = vjp(jnp.asarray(g, jnp.bfloat16))
    tx = _nchw(x).to(torch.bfloat16).requires_grad_()
    ty = tpool(tx)
    ty.backward(_nchw(g).to(torch.bfloat16))
    np.testing.assert_array_equal(ty.detach().permute(0, 2, 3, 1).float(),
                                  np.asarray(jy, np.float32))
    np.testing.assert_array_equal(tx.grad.permute(0, 2, 3, 1).float(),
                                  np.asarray(jg, np.float32))
    if stride == 2:       # most windows hold a tie for their maximum
        w = x.reshape(2, 4, 2, 4, 2, 4).transpose(0, 1, 3, 5, 2, 4) \
            .reshape(-1, 4)
        assert ((w == w.max(-1, keepdims=True)).sum(-1) > 1).mean() > 0.5


def test_five_step_trajectory_matches_jax(tiny):
    jspec, tspec, params, stats = tiny
    batches = _batches(5, seed=4)
    jcfg = JLo.RegionLossConfig.single(use_pallas=False)
    jstep = JTr.make_train_step(jspec, jcfg, weight_decay=DECAY * B,
                                momentum=MOM, compute_dtype=None, donate=False)
    jstate = JTr.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jax.tree.map(jnp.asarray, stats))
    state = _port_state(tspec, params, stats)
    step = TTr.make_train_step(TLo.RegionLossConfig(),
                               compute_dtype=None)
    for i, (imgs, tgt) in enumerate(batches):
        jstate, jst = jstep(jstate, jnp.asarray(imgs), jnp.asarray(tgt),
                            np.float32(LR), np.int32(EPOCH))
        st = step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR,
                  EPOCH)
        want = float(jst["loss"])
        assert abs(float(st["loss"].detach()) - want) <= 1e-4 * abs(want), i
        assert float(st["loss_conf"]) > 0
    _assert_state_close(tspec, state, jstate, 1e-4)
    assert state.seen == 5 * B


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_gradients_match_jax(tiny, dtype):
    jspec, tspec, params, stats = tiny
    imgs, tgt = _batches(1, seed=6)[0]
    x = imgs.astype(np.float32) / 255.0
    jcfg = JLo.RegionLossConfig.single(use_pallas=False)
    jcd = jnp.bfloat16 if dtype == "bf16" else None
    tcd = torch.bfloat16 if dtype == "bf16" else None

    def jloss(p):
        out, _ = jspec.apply(p, jnp.asarray(x), batch_stats=stats, train=True,
                             compute_dtype=jcd)
        return JLo.region_loss(out, jnp.asarray(tgt), EPOCH, jcfg)[0]

    jl, jgrads = _strict_jit(jax.value_and_grad(jloss),
                             jax.tree.map(jnp.asarray, params))
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    model.train()
    head = model(torch.from_numpy(x), tcd)
    loss, _ = TLo.region_loss(head, torch.from_numpy(tgt), EPOCH,
                              TLo.RegionLossConfig())
    loss.backward()
    want = TW.params_from_jax(tspec, jax.tree.map(np.asarray, jgrads))
    got = {n: p.grad for n, p in model.named_parameters()}
    if dtype == "f32":
        assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
        for n in want:
            assert rel_err(got[n], want[n]) <= 1e-4, (n, rel_err(got[n],
                                                                  want[n]))
        return
    assert abs(float(loss) - float(jl)) <= 2e-2 * abs(float(jl))
    # JAX op by op: each primitive compiled alone rounds to bf16 wherever
    # the program says, as the eager port does
    with jax.disable_jit():
        _, ograds = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray,
                                                           params))
    flat = lambda gs: torch.cat([torch.as_tensor(gs[n]).flatten()
                                 for n in want])
    cos = lambda a, b: float(a @ b / (a.norm() * b.norm()))
    g, o = flat(got), flat(TW.params_from_jax(
        tspec, jax.tree.map(np.asarray, ograds)))
    port, floor = cos(g, o), cos(flat(want), o)
    # floor: JAX's compiled gradient against JAX op by op
    assert port > 0.99 and port >= floor - 0.005, (port, floor)


def test_one_bf16_step_matches_jax(tiny):
    jspec, tspec, params, stats = tiny
    imgs, tgt = _batches(1, seed=6)[0]
    jcfg = JLo.RegionLossConfig.single(use_pallas=False)

    # the step itself, from one carried state on both sides
    jstep = JTr.make_train_step(jspec, jcfg, weight_decay=DECAY * B,
                                momentum=MOM, compute_dtype=jnp.bfloat16,
                                donate=False)
    _, jst = jstep(JTr.init_train_state(jax.tree.map(jnp.asarray, params),
                                        jax.tree.map(jnp.asarray, stats)),
                   jnp.asarray(imgs), jnp.asarray(tgt), np.float32(LR),
                   np.int32(EPOCH))
    st = TTr.make_train_step(TLo.RegionLossConfig())(
        _port_state(tspec, params, stats), torch.from_numpy(imgs),
        torch.from_numpy(tgt), LR, EPOCH)
    want = float(jst["loss"])
    assert abs(float(st["loss"]) - want) <= 2e-2 * abs(want)


def test_weights_after_training_load_in_jax_bitexact(tiny, tmp_path):
    jspec, tspec, params, stats = tiny
    state = _port_state(tspec, params, stats)
    step = TTr.make_train_step(TLo.RegionLossConfig(),
                               compute_dtype=None)
    for imgs, tgt in _batches(2, seed=8):
        step(state, torch.from_numpy(imgs), torch.from_numpy(tgt), LR, EPOCH)
    path = str(tmp_path / "trained.weights")
    TW.save_weights(tspec, state.model.state_dict(), path, seen=state.seen)
    header, jp, js = JW.load_weights(jspec, path)
    assert header.seen == state.seen == 2 * B
    want = TW.params_from_jax(tspec, jp, js)
    got = state.model.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), k)

    # the backbone load: every layer but the last two blocks from the file,
    # bit for bit as the JAX loader reads it; the head freshly drawn
    jheader, jp2, js2 = JW.load_weights_until_last(jspec, path)
    theader, tstate = TW.load_weights_until_last(
        tspec, path, torch.Generator().manual_seed(1))
    assert theader.seen == jheader.seen
    head = tspec.conv_specs()[-1].name
    want = TW.params_from_jax(tspec, jp2, js2)
    for k in want:
        if k.startswith(head + "."):
            assert tstate[k].shape == want[k].shape
            assert not torch.equal(tstate[k], got[k])
        else:
            np.testing.assert_array_equal(tstate[k].numpy(), want[k].numpy(),
                                          k)
    Darknet(tspec).load_state_dict(tstate)
    assert TW.resume_counters(theader, B, 3) == \
        JW.resume_counters(jheader, B, 3) == (2, 1)


def test_checkpoint_resume_repeats_the_next_steps(tiny, tmp_path):
    _, tspec, params, stats = tiny
    batches = _batches(4, seed=9)
    step = TTr.make_train_step(TLo.RegionLossConfig(),
                               compute_dtype=None)
    run = lambda state, bs: [float(step(state, torch.from_numpy(i),
                                        torch.from_numpy(t), LR, EPOCH)["loss"])
                             for i, t in bs]
    a = _port_state(tspec, params, stats)
    run(a, batches[:2])
    ckpt = Checkpointer(str(tmp_path / "ckpt"))
    ckpt.save(2, a)
    losses_a = run(a, batches[2:])

    # a state from other weights, restored from the checkpoint
    b = _port_state(tspec, *jax_params(JSpec(TINY_BLOCKS), seed=99))
    assert ckpt.restore(b) == 2 and b.seen == 2 * B
    losses_b = run(b, batches[2:])
    assert losses_b == losses_a
    for (k, va), vb in zip(a.model.state_dict().items(),
                           b.model.state_dict().values()):
        assert torch.equal(va, vb), k
    assert b.seen == a.seen == 4 * B

    # retention: the newest three steps stay
    for s in (3, 4, 5, 6):
        ckpt.save(s, a)
    assert ckpt.steps() == [4, 5, 6] and ckpt.latest_step() == 6
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["4.pt", "5.pt", "6.pt"]
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(b)
