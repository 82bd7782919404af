"""PyTorch port vs the JAX package: the serving function, the micro-batcher,
the validation driver and its CLI (singleshotpose_tpu_torch/serving.py,
drivers.py, cli.py) — and that the port (serving and a train step) runs
with jax absent.

Tolerances: f32 serving boxes to 1e-5 (the same f32 net, summed in another
order); bf16 boxes to 2e-2 of a corner's scale — the tiny net's bf16 convs
round a few values the other way, which moves a corner by an ulp of the
head; validation corners to 1e-4 in f32, with equal sample counts and
accuracies.  Mean errors are not compared: PnP on a random net's corners is
ill-posed, so two f32 solvers may settle in different places.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu import drivers as JDr
from singleshotpose_tpu import serving as JS
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.models.darknet import fold_batchnorm as jfold
from singleshotpose_tpu.zoo import linemod_datacfg

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import serving as TS
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models.darknet import Darknet, fold_batchnorm
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec

from linemod_fixture import make_linemod_fixture, write_random_weights
from torch_port_helpers import TINY_BLOCKS, TINY_CFG, jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def tiny():
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=12)
    model = Darknet(tspec)
    model.load_state_dict(TW.params_from_jax(tspec, params, stats))
    imgs = np.random.RandomState(13).randint(0, 256, (4, 64, 64, 3), np.uint8)
    return jspec, tspec, jfold(jspec, params, stats), fold_batchnorm(model), imgs


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_serving_fn_matches_jax(tiny, dtype):
    jspec, tspec, jfolded, tfolded, imgs = tiny
    jcd = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tcd = torch.bfloat16 if dtype == "bf16" else None
    tol = 2e-2 if dtype == "bf16" else 1e-5
    want = jax.jit(JS.make_serving_fn(jspec, jfolded, pick=("best",),
                                      compute_dtype=jcd))(jnp.asarray(imgs))
    got = TS.make_serving_fn(tspec, tfolded, pick=("best",),
                             compute_dtype=tcd)(imgs)
    assert tuple(got.shape) == want.shape == (4, 21)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=tol)
    grid = TS.make_serving_fn(tspec, tfolded, compute_dtype=tcd)(
        torch.from_numpy(imgs).float() / 255.0)
    jgrid = JS.make_serving_fn(jspec, jfolded, compute_dtype=jcd)(
        jnp.asarray(imgs, jnp.float32) / 255.0)
    for g, r in zip(grid, jgrid):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=0, atol=tol)


def test_serving_fn_rejects_multi_object_picks(tiny):
    _, tspec, _, tfolded, _ = tiny
    with pytest.raises(ValueError):
        TS.make_serving_fn(tspec, tfolded, pick=("per_class", 0.1))


def test_microbatcher_answers_equal_direct_call(tiny):
    _, tspec, _, tfolded, imgs = tiny
    serve = TS.make_serving_fn(tspec, tfolded, pick=("best",))
    direct = serve(imgs).numpy()
    with TS.MicroBatcher(serve, height=64, width=64, buckets=(1, 2, 4),
                         max_delay_ms=5.0) as mb:
        futs = [mb.submit(im) for im in imgs]
        got = np.stack([f.result(timeout=60).numpy() for f in futs])
        with pytest.raises(ValueError):
            mb.submit(imgs[0][:32])
    np.testing.assert_array_equal(got, direct)
    with pytest.raises(RuntimeError):
        mb.submit(imgs[0])


def test_microbatcher_many_clients_stress(tiny):
    """More client threads than cores, a short switch interval: every
    request gets its own frame's answer, and the batcher's threads end."""
    import threading
    _, tspec, _, tfolded, imgs = tiny
    serve = TS.make_serving_fn(tspec, tfolded, pick=("best",),
                               compute_dtype=None)
    direct = serve(imgs).numpy()
    n_clients, per_client = 12, 3
    answers = {}
    lock = threading.Lock()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with TS.MicroBatcher(serve, height=64, width=64, buckets=(1, 2, 4, 8),
                             max_delay_ms=1.0) as mb:
            def client(k):
                for j in range(per_client):
                    i = (k + j) % len(imgs)
                    out = mb.infer(imgs[i], timeout=120).numpy()
                    with lock:
                        answers[(k, j)] = (i, out)
            threads = [threading.Thread(target=client, args=(k,))
                       for k in range(n_clients)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=180)
            assert not any(t.is_alive() for t in threads)
        assert not mb._thread.is_alive() and not mb._resolver.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert len(answers) == n_clients * per_client
    for i, out in answers.values():
        np.testing.assert_allclose(out, direct[i], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def linemod(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("lm"))
    lm = make_linemod_fixture(root, ["ape"], n_frames=4, seed=14)
    datacfg = os.path.join(root, "ape.data")
    with open(datacfg, "w") as f:
        f.write(linemod_datacfg("ape", linemod_root=lm,
                                backup_root=os.path.join(root, "backup")))
    cfg = os.path.join(root, "tiny.cfg")
    with open(cfg, "w") as f:
        f.write(TINY_CFG)
    wfile = os.path.join(root, "w", "tiny.weights")
    write_random_weights(JSpec(TINY_BLOCKS), wfile, seed=15)
    return datacfg, cfg, wfile


def test_run_validation_matches_jax(linemod):
    datacfg, cfg, wfile = linemod
    kw = dict(batch_size=3, num_workers=0, verbose=False)
    got = TDr.run_validation(datacfg, cfg, wfile, compute_dtype=None,
                             device="cpu", **kw)
    want = JDr.run_validation(datacfg, cfg, wfile, compute_dtype=None, **kw)
    assert got["n_samples"] == want["n_samples"] == 4
    for k in got:
        if k.startswith("acc_"):
            assert got[k] == want[k], (k, got[k], want[k])

    # the predicted corners behind those numbers
    from singleshotpose_tpu import weights as JW
    from singleshotpose_tpu.config import (data_config_from_options,
                                           read_data_cfg)
    from singleshotpose_tpu.data.pipeline import Loader, PoseDataset
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    jspec, tspec = JSpec.from_cfg(cfg), TSpec.from_cfg(cfg)

    def loader():
        ds = PoseDataset(dcfg.valid, train=False)
        return Loader(ds, 3, shuffle=False, schedule=None, fixed_shape=(64, 64),
                      num_workers=0, drop_last=False, out_uint8=True)

    _, params, stats = JW.load_weights(jspec, wfile)
    _, jart = JDr._eval_pass(jspec, params, stats, loader(),
                             JDr.EvalContext.from_data_config(dcfg),
                             pick=("best",), num_keypoints=9,
                             compute_dtype=None)
    model = Darknet(tspec)
    model.load_state_dict(TW.load_weights(tspec, wfile)[1])
    _, tart = TDr._eval_pass(tspec, model, loader(),
                             TDr.EvalContext.from_data_config(dcfg),
                             compute_dtype=None, device="cpu")
    np.testing.assert_array_equal(tart["image_idx"], jart["image_idx"])
    np.testing.assert_array_equal(tart["corners_gt"], jart["corners_gt"])
    # corners in pixels; 1e-4 of the normalized coordinate
    np.testing.assert_allclose(tart["corners_pr"] / [640, 480],
                               jart["corners_pr"] / [640, 480], rtol=0,
                               atol=1e-4)


def test_cli_valid_on_cpu(linemod, capsys):
    datacfg, cfg, wfile = linemod
    assert tcli(["valid", "--datacfg", datacfg, "--modelcfg", cfg,
                 "--weightfile", wfile, "--batch_size", "2",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "Acc using 5 px 2D Projection" in out
    assert tcli(["frobnicate"]) == 2


def test_cli_valid_refuses_missing_cuda(linemod):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    datacfg, cfg, wfile = linemod
    with pytest.raises(SystemExit, match="CUDA is not available"):
        tcli(["valid", "--datacfg", datacfg, "--modelcfg", cfg,
              "--weightfile", wfile])


_NO_JAX = r"""
import sys
sys.modules["jax"] = None            # any `import jax` now raises ImportError
sys.modules["singleshotpose_tpu"] = None     # and so does the JAX package
import numpy as np, torch
torch.set_num_threads(2)
import singleshotpose_tpu_torch
from singleshotpose_tpu_torch import (checkpoint, cli, config, drivers,
                                      evaluate, serving, training, weights,
                                      zoo)
from singleshotpose_tpu_torch.data import augment, pipeline, prefetch
from singleshotpose_tpu_torch.models import darknet, layers
from singleshotpose_tpu_torch.ops import (confidence, cuda_build, decode,
                                          losses, max_corner_confidence, pnp,
                                          stem, targets)
from singleshotpose_tpu_torch.utils import geometry, labels, meshply
import chip_smoke                    # the card's smoke script imports the same
spec = zoo.yolo_pose_single(test_size=64)
model = darknet.Darknet(spec, generator=torch.Generator().manual_seed(0))
boxes = serving.make_serving_fn(spec, darknet.fold_batchnorm(model),
                                pick=("best",))(np.zeros((1, 64, 64, 3), np.uint8))
assert boxes.shape == (1, 21) and bool(torch.isfinite(boxes).all())
X = np.array([[0, 0, 0]] + [[a * .05, b * .04, c * .03] for a in (-1, 1)
              for b in (-1, 1) for c in (-1, 1)], np.float32)
K = np.array([[572.4, 0, 325.3], [0, 573.6, 242.0], [0, 0, 1]], np.float32)
uvw = (X + [0.01, -0.02, 0.7]) @ K.T
R, t = pnp.pnp_batched(X, (uvw[:, :2] / uvw[:, 2:])[None], K)
assert np.abs(t.numpy()[0] - [0.01, -0.02, 0.7]).max() < 1e-3
sys.path.insert(0, "tests")
from torch_port_helpers import TINY_BLOCKS
tiny = darknet.DarknetSpec(TINY_BLOCKS)
target = torch.zeros((2, 50 * 21))
target.view(2, 50, 21)[:, 0, 1:19] = 0.5
calls, real = [], stem.stem_conv_bn_pool_train
stem.stem_conv_bn_pool_train = lambda *a: calls.append(1) or real(*a)
for fused in (False, True):
    state = training.init_train_state(
        darknet.Darknet(tiny, generator=torch.Generator().manual_seed(1)),
        weight_decay=1e-3, momentum=0.9)
    stats = training.make_train_step(losses.RegionLossConfig(),
                                     fused_stem=fused)(
        state, torch.zeros((2, 64, 64, 3), dtype=torch.uint8), target, 1e-3,
        16)
    assert bool(torch.isfinite(stats["loss"])) and state.seen == 2
assert calls == [1]                  # the fused step ran the train stem
used = sorted(m for m in sys.modules if m.split(".")[0] == "singleshotpose_tpu"
              and sys.modules[m] is not None)
assert not used, used
print("NO_JAX_OK")
"""


def test_port_imports_and_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
