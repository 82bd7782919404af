"""The port's device-resident single-object data path against the JAX
package's: ``data/device_augment.py``, ``data/device_bank.py``, the
``device``/``device_bank`` backends of ``data/pipeline.Loader``,
``utils/memory.py``, and the trainer and ``cli train`` on them.

Tolerances, all on the CPU with the same numpy inputs and seeds:
``draw_params`` equal; images bit for bit — the port yields u8 levels, and
those times f32(1/255) (what the train step computes from them, checked
here too) equal JAX's f32 batches, on the u8 path and on the float
alpha-blend path alike; labels bit for bit as well (the port rounds the
label transform where XLA's CPU program rounds it), which is tighter than
the rtol 1e-6 asked of them.  Frames are PNGs so that both packages decode
the same pixels, whichever decoder the JAX package picks.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu.data import device_augment as JDA
from singleshotpose_tpu.data import device_bank as JDB
from singleshotpose_tpu.data import pipeline as JP

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.data import device_augment as TDA
from singleshotpose_tpu_torch.data import device_bank as TDB
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.models.darknet import Darknet, DarknetSpec
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.training import init_train_state, make_train_step
from singleshotpose_tpu_torch.utils import memory as TM

from torch_port_helpers import TINY_BLOCKS
from test_drivers import TINY_CFG, _make_synthetic_linemod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
INV255 = np.float32(1) / np.float32(255)
AUG = dict(jitter=0.2, hue=0.1, saturation=1.5, exposure=1.5)


def _unit(levels: torch.Tensor) -> np.ndarray:
    """u8 levels as the train step scales them: times f32(1/255)."""
    return levels.numpy().astype(np.float32) * INV255


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """4 PNG frames (48×64) with binary masks; frame 1 has two GT rows and
    frame 2 an empty label file; two backgrounds of other sizes."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("tiny_bank")
    root = tmp / "obj"
    for d in ("JPEGImages", "mask", "labels"):
        (root / d).mkdir(parents=True)
    rng = np.random.RandomState(0)
    paths = []
    for i in range(4):
        img = rng.randint(0, 256, (48, 64, 3), np.uint8)
        img[::4] = img[::4, :, :1]              # grey rows: saturation 0
        name = f"{i:06d}"
        p = root / "JPEGImages" / f"{name}.png"
        Image.fromarray(img).save(p)
        m = np.zeros((48, 64), np.uint8)
        m[8 + i:34, 12:44 + i] = 255
        Image.fromarray(m).save(root / "mask" / f"{name[2:]}.png")
        rows = rng.uniform(0.05, 0.95, (2 if i == 1 else 1, 21))
        rows[:, 0] = 0
        if i == 2:
            (root / "labels" / f"{name}.txt").write_text("")
        else:
            np.savetxt(root / "labels" / f"{name}.txt", rows)
        paths.append(str(p))
    lst = tmp / "train.txt"
    lst.write_text("\n".join(paths) + "\n")
    bgs = []
    for k, shape in enumerate(((32, 40, 3), (60, 50, 3))):
        bg = tmp / f"bg{k}.png"
        Image.fromarray(rng.randint(0, 256, shape, np.uint8)).save(bg)
        bgs.append(str(bg))
    return str(lst), bgs


@pytest.mark.parametrize("ow,oh,aug", [
    (64, 48, AUG), (61, 47, dict(AUG, jitter=0.4, hue=0.5)),
    (416, 416, dict(AUG, saturation=3.0, exposure=0.5))])
def test_draw_params_match_jax(ow, oh, aug):
    jp, jlab = JDA.draw_params(np.random.RandomState(5), 6, ow, oh, **aug)
    tp, tlab = TDA.draw_params(np.random.RandomState(5), 6, ow, oh, **aug)
    for field in TDA.AugmentParams._fields:
        np.testing.assert_array_equal(getattr(tp, field),
                                      np.asarray(getattr(jp, field)), field)
    np.testing.assert_array_equal(tlab, jlab)


# (out_w, out_h, jitter, hue): a width not divisible by 4; crops far out of
# the frame; hue shifts of both signs that wrap the wheel
_AUG_CASES = [(96, 96, 0.2, 0.1), (61, 47, 0.45, 0.5), (32, 40, 0.3, 1.0)]


@pytest.mark.parametrize("ow,oh,jitter,hue", _AUG_CASES)
def test_augment_batch_u8_matches_jax(ow, oh, jitter, hue):
    rng = np.random.RandomState(ow)
    B, H, W = 4, 48, 64
    imgs = rng.randint(0, 256, (B, H, W, 3), np.uint8)
    imgs[:, ::3] = imgs[:, ::3, :, :1]                  # grey: d == 0
    imgs[:, 1::7] = 0                                   # black: max == 0
    masks = ((rng.rand(B, H, W, 1) > 0.4) * 255).astype(np.uint8)
    bgs = rng.randint(0, 256, (B, H, W, 3), np.uint8)
    aug = dict(AUG, jitter=jitter, hue=hue)
    jp, _ = JDA.draw_params(np.random.RandomState(1), B, W, H, **aug)
    tp, _ = TDA.draw_params(np.random.RandomState(1), B, W, H, **aug)
    assert (tp.dhue < 0).any() and (tp.pleft < 0).any()
    want = np.asarray(JDA.augment_batch(jnp.asarray(imgs), jnp.asarray(masks),
                                        jnp.asarray(bgs), jp, ow, oh))
    got = TDA.augment_batch(*map(torch.from_numpy, (imgs, masks, bgs)), tp,
                            ow, oh)
    assert got.dtype == torch.uint8 and tuple(got.shape) == (B, oh, ow, 3)
    np.testing.assert_array_equal(_unit(got), want)


def test_augment_batch_float_path_matches_jax():
    """Soft masks blend (the alpha path): bit for bit too — the port rounds
    the blend once, as XLA's CPU program contracts it."""
    rng = np.random.RandomState(3)
    B, H, W = 3, 40, 56
    imgs = rng.randint(0, 256, (B, H, W, 3)).astype(np.float32) * INV255
    masks = rng.rand(B, H, W, 1).astype(np.float32)
    bgs = rng.rand(B, H, W, 3).astype(np.float32)
    jp, _ = JDA.draw_params(np.random.RandomState(2), B, W, H, **AUG)
    tp, _ = TDA.draw_params(np.random.RandomState(2), B, W, H, **AUG)
    want = np.asarray(JDA.augment_batch(jnp.asarray(imgs), jnp.asarray(masks),
                                        jnp.asarray(bgs), jp, 45, 37))
    got = TDA.augment_batch(*map(torch.from_numpy, (imgs, masks, bgs)), tp,
                            45, 37)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_bank_batch_matches_jax(tiny):
    lst, bgs = tiny
    jbank = JDB.build_frame_bank(JP.PoseDataset(
        lst, train=True, bg_file_names=bgs)).device_put()
    tbank = TDB.build_frame_bank(TP.PoseDataset(
        lst, train=True, bg_file_names=bgs)).device_put(CPU)
    for a, b in zip(tbank, jbank):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    B = 6
    idxs = np.array([0, 1, 2, 3, 1, 2], np.int32)
    bg_idxs = np.array([0, 1, 1, 0, 0, 1], np.int32)
    jp, _ = JDA.draw_params(np.random.RandomState(4), B, 64, 48,
                            **dict(AUG, jitter=0.4, hue=0.5))
    tp, _ = TDA.draw_params(np.random.RandomState(4), B, 64, 48,
                            **dict(AUG, jitter=0.4, hue=0.5))
    ji, jl = JDB.augment_bank_batch(jbank, jnp.asarray(idxs),
                                    jnp.asarray(bg_idxs), jp, out_w=61,
                                    out_h=47, K=9)
    ti, tl = TDB.augment_bank_batch(tbank, idxs, bg_idxs, tp, out_w=61,
                                    out_h=47, K=9)
    np.testing.assert_array_equal(_unit(ti), np.asarray(ji))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    rows = tl.numpy().reshape(B, 50, 21)
    # the extent fields (19, 20) pass through untouched: nonzero in real rows
    assert (rows[[0, 3], 1:] == 0).all() and (rows[[0, 3], 0, 19] != 0).all()
    assert (rows[1, 2:] == 0).all() and (rows[1, :2, 19] != 0).all()
    assert (rows[2] == 0).all()                        # the empty label file


def _loaders(lst, bgs, backend, **kw):
    jl = JP.Loader(JP.PoseDataset(lst, train=True, bg_file_names=bgs),
                   num_workers=0, backend=backend, **kw)
    tl = TP.Loader(TP.PoseDataset(lst, train=True, bg_file_names=bgs),
                   num_workers=0, backend=backend, device=CPU, **kw)
    return jl, tl


@pytest.mark.parametrize("backend", ["device", "device_bank"])
@pytest.mark.parametrize("with_bgs", [True, False])
def test_loader_device_backends_match_jax(tiny, backend, with_bgs):
    """An epoch over SINGLE_SCHEDULE's last stage (widths 224-832 drawn
    per batch) and one at a fixed 61×47: JAX's batches bit for bit."""
    lst, bgs = tiny
    bgs = bgs if with_bgs else []
    nb = 2                                   # batches an epoch at batch 2
    jl, tl = _loaders(lst, bgs, backend, batch_size=2, seed=3,
                      seen=70 * nb * 2)
    pairs = list(zip(jl, tl))
    jf, tf = _loaders(lst, bgs, backend, batch_size=2, seed=9,
                      fixed_shape=(61, 47))
    pairs += list(zip(jf, tf))
    assert len(pairs) == 4
    widths = set()
    for (ji, jlab), (ti, tlab) in pairs:
        assert ti.dtype == torch.uint8 and ti.device == CPU
        np.testing.assert_array_equal(_unit(ti), np.asarray(ji))
        tlab = tlab.numpy() if isinstance(tlab, torch.Tensor) else tlab
        np.testing.assert_array_equal(tlab, np.asarray(jlab))
        widths.add(ti.shape[2])
    assert len(widths) == 3, widths
    assert tl.seen == jl.seen


def test_device_and_bank_backends_agree(tiny):
    lst, bgs = tiny
    kw = dict(batch_size=2, seed=6, num_workers=0, device=CPU)
    dev = TP.Loader(TP.PoseDataset(lst, train=True, bg_file_names=bgs),
                    backend="device", **kw)
    bank = TP.Loader(TP.PoseDataset(lst, train=True, bg_file_names=bgs),
                     backend="device_bank", **kw)
    for (di, dl), (bi, bl) in zip(dev, bank):
        assert torch.equal(di, bi)
        # the bank's label transform runs in f32, the host one in f64
        np.testing.assert_allclose(bl.numpy(), dl, rtol=0, atol=2e-6)


def test_step_scales_u8_as_jax(tiny):
    """The train step turns u8 levels into JAX's f32 bits: every level, and
    a bank batch against the JAX bank's f32 batch."""
    spec = DarknetSpec(TINY_BLOCKS)
    model = Darknet(spec, generator=torch.Generator().manual_seed(0))
    state = init_train_state(model, weight_decay=0.0, momentum=0.9)
    step = make_train_step(RegionLossConfig(), compute_dtype=None)
    inputs = []
    model.register_forward_pre_hook(
        lambda m, args: inputs.append(args[0].detach().clone()))
    target = torch.zeros((4, 50 * 21))
    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    levels = np.broadcast_to(levels, (4, 16, 16, 3)).copy()
    levels = np.pad(levels, ((0, 0), (24, 24), (24, 24), (0, 0)))
    step(state, torch.from_numpy(levels), target, 0.0, 0)
    want = jax.jit(lambda u: u.astype(jnp.float32) / 255.0)(levels)
    np.testing.assert_array_equal(inputs[-1].numpy(), np.asarray(want))

    lst, bgs = tiny
    jl, tl = _loaders(lst, bgs, "device_bank", batch_size=4, seed=2,
                      fixed_shape=(64, 64))
    (ji, _), (ti, tlab) = next(iter(jl)), next(iter(tl))
    step(state, ti, tlab, 0.0, 0)
    np.testing.assert_array_equal(inputs[-1].numpy(), np.asarray(ji))


@pytest.mark.parametrize("backend,match", [
    # device_synth is ported now (tests/test_torch_device_synth.py): the
    # case keeps its id and holds that a dataset without a scene
    # synthesizer is refused
    pytest.param("device_synth", "device_synth backend needs a PoseDataset",
                 id="device_synth-not ported.*item 1"),
    ("frobnicate", "unknown loader backend")])
def test_unported_backends_raise(tiny, backend, match):
    lst, bgs = tiny
    with pytest.raises(ValueError, match=match):
        TP.Loader(TP.PoseDataset(lst, train=True), 2, backend=backend)


def test_device_backends_refuse_misuse(tiny):
    lst, _ = tiny
    test_ds = TP.PoseDataset(lst, train=False)
    with pytest.raises(ValueError, match="train-mode"):
        TP.Loader(test_ds, 2, backend="device_bank", device=CPU)
    synth_ds = TP.PoseDataset(lst, train=True, synthesizer=lambda *a: None)
    with pytest.raises(ValueError, match="scene-synthesis"):
        TP.Loader(synth_ds, 2, backend="device", device=CPU)
    if not torch.cuda.is_available():        # the card is the default
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TP.Loader(TP.PoseDataset(lst, train=True), 2,
                      backend="device_bank")


def test_frame_bank_preflight(monkeypatch):
    """An over-budget bank placement fails with the actionable message;
    off CUDA there is no accounting and the check passes."""
    bank = TDB.DeviceFrameBank(
        images=torch.zeros((2, 4, 4, 3), dtype=torch.uint8),
        masks=torch.zeros((2, 4, 4), dtype=torch.uint8),
        truths=torch.zeros((2, 50, 21)),
        n_rows=torch.ones(2, dtype=torch.int32),
        bgs=torch.zeros((1, 4, 4, 3), dtype=torch.uint8))
    assert bank.nbytes() == 96 + 32 + 8400 + 48
    monkeypatch.setattr(TM, "hbm_free_bytes", lambda device=None: 1 << 20)
    with pytest.raises(RuntimeError, match="device memory.*--loader_backend "
                                           "python"):
        bank.device_put(CPU)
    monkeypatch.setattr(TM, "hbm_free_bytes", lambda device=None: 64 << 30)
    assert bank.device_put(CPU).images.device == CPU
    monkeypatch.undo()
    assert TM.hbm_free_bytes(CPU) is None
    TM.check_hbm_budget(1 << 60, "anything", device=CPU)


def test_cache_decoded_hits_once(tiny, monkeypatch):
    """With cache_decoded, each image and mask file is decoded once across
    epochs, on the python and the device backend (the latter through the
    decoder it binds: the native one when it builds, else PIL)."""
    lst, bgs = tiny
    calls = []

    def counting(decode):
        return lambda path: calls.append(path) or decode(path)

    monkeypatch.setattr(TP, "load_image", counting(TP.load_image))
    for backend in ("python", "device"):
        calls.clear()
        ds = TP.PoseDataset(lst, train=True, bg_file_names=bgs,
                            cache_decoded=True)
        ld = TP.Loader(ds, 4, fixed_shape=(32, 32), num_workers=0, seed=0,
                       backend=backend, device=CPU)
        if backend == "device" and ld._decode is not TP.load_image:
            ld._decode = counting(ld._decode)
        for _ in range(3):
            for _ in ld:
                pass
        frames = [c for c in calls if "bg" not in os.path.basename(c)]
        assert len(frames) == len(set(frames)) == 8, backend


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    from PIL import Image
    tmp = tmp_path_factory.mktemp("torch_bank_train")
    datacfg, backup = _make_synthetic_linemod(tmp)
    cfgfile = tmp / "tiny.cfg"
    cfgfile.write_text(TINY_CFG)
    bg_dir = tmp / "bg"
    bg_dir.mkdir()
    Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (200, 300, 3), np.uint8)).save(bg_dir / "bg0.png")
    return datacfg, str(cfgfile), str(bg_dir), tmp


@pytest.mark.parametrize("backend", ["device", "device_bank"])
def test_run_training_device_backends(synth, backend):
    """One epoch of the single trainer on a device backend, on the CPU."""
    datacfg, cfgfile, bg_dir, _ = synth
    rc = TDr.TrainRunConfig(loader_backend=backend, num_workers=0,
                            eval_every=100, eval_after=100, log_every=2,
                            max_epochs_override=1, bg_dir=bg_dir,
                            compute_dtype=None, device="cpu")
    result = TDr.run_training(datacfg, cfgfile, None, 100, rc)
    losses = result["history"]["training_losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert result["state"].seen == 6


def test_cli_train_device_bank(synth, capsys):
    datacfg, cfgfile, bg_dir, _ = synth
    assert tcli(["train", "--datacfg", datacfg, "--modelcfg", cfgfile,
                 "--initweightfile", "", "--max_epochs", "1",
                 "--bg_dir", bg_dir, "--loader_backend", "device_bank",
                 "--eval_transfer", "bank", "--cache_decoded",
                 "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "device_bank: 6 frames" in out and "best accuracy" in out


def test_multi_trainer_refuses_device_backends(synth):
    datacfg, cfgfile, _, _ = synth
    rc = TDr.TrainRunConfig(loader_backend="device_bank", device="cpu",
                            num_workers=0)
    with pytest.raises(ValueError, match="scene-synthesis"):
        TDr.run_training_multi(datacfg, cfgfile, None, 0, [],
                               os.path.dirname(datacfg), rc)


_NO_JAX = r"""
import sys
sys.modules["jax"] = None
sys.modules["singleshotpose_tpu"] = None
import numpy as np, torch
torch.set_num_threads(2)
from singleshotpose_tpu_torch.data import (device_augment, device_bank,
                                           eval_bank, shaded)
from singleshotpose_tpu_torch.utils import memory
rng = np.random.RandomState(0)
img, mask, lab, R, t = shaded.render_frame(rng, rng.randint(60, 255, (6, 3)))
bank = device_bank.DeviceFrameBank(
    torch.from_numpy(img[None]), torch.from_numpy(mask[None]),
    torch.from_numpy(np.pad(lab[None, None], ((0, 0), (0, 49), (0, 0)))),
    torch.ones(1, dtype=torch.int32),
    torch.zeros((1, 480, 640, 3), dtype=torch.uint8)).device_put("cpu")
params, _ = device_augment.draw_params(rng, 2, 640, 480, jitter=0.2,
                                       hue=0.1, saturation=1.5, exposure=1.5)
images, labels = device_bank.augment_bank_batch(
    bank, np.zeros(2, np.int64), np.zeros(2, np.int64), params, out_w=96,
    out_h=64)
assert images.shape == (2, 64, 96, 3) and images.dtype == torch.uint8
assert labels.shape == (2, 50 * 21) and float(labels[0, 1]) != 0
assert memory.hbm_free_bytes("cpu") is None
used = sorted(m for m in sys.modules if m.split(".")[0] == "singleshotpose_tpu"
              and sys.modules[m] is not None)
assert not used, used
print("NO_JAX_OK")
"""


def test_device_data_modules_run_without_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_JAX_OK" in proc.stdout
