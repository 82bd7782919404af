"""The port's on-device multi-object scene synthesis
(``singleshotpose_tpu_torch/data/device_synth.py``; ``Loader(backend=
"device_synth")``, the multi trainer and ``cli train-multi`` on it) against
the JAX package's ``data/device_synth.py``; the serve's u8 scale; and
``scripts/shaded_accuracy_multi.py`` at a CPU size.

The port draws a batch's random integers apart from the synthesis
(``draw_synth``, a ``torch.Generator``); JAX draws threefry keys inside its
program.  ``_jax_draws`` recovers JAX's own draws from a key by JAX's split
sequence, and from them the port's ``synthesize_batch`` equals JAX's bit for
bit, images and labels (tolerance 0), on the hand-made bank and on a bank
built from a LINEMOD tree by both packages' ``build_scene_bank`` (whose
arrays are equal too), at ``propose_scale`` 1 and 4, ``attempts`` 30 and 3,
widths 64 and 96.  Those masks are binary, as LINEMOD's are.  On soft masks
the port equals JAX's program compiled for one scene at a time, bit for
bit; JAX's batched program disagrees with that one on some pixels (its
fusions contract other products into FMAs there), which the test counts:
182 of 110,592 and 122 of 73,728 pixel values in its two cases.
The port's own draws are held to JAX's integer ranges and, on a crowded
corpus, to the host synthesizer's objects per scene (JAX's tolerance).
"""

import dataclasses
import json
import os
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from singleshotpose_tpu.data import device_synth as JDS
from singleshotpose_tpu.data.synth_multi import SynthConfig as JSynthConfig

from singleshotpose_tpu_torch import drivers as TDr
from singleshotpose_tpu_torch import serving as TSv
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.data import device_synth as TDS
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.data import synth_multi as TSM
from singleshotpose_tpu_torch.models.darknet import (Darknet, DarknetSpec,
                                                     fold_batchnorm)
from singleshotpose_tpu_torch.training import init_train_state, make_train_step

from test_torch_multi_train import occ_tree  # noqa: F401  (a fixture)
from torch_port_helpers import TINY_BLOCKS, TINY_MULTI_BLOCKS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NL, K = 21, 9


def _jax_draws(jbank, base_idx, key, st) -> TDS.SynthDraws:
    """The integers JAX's ``synthesize_batch(jbank, base_idx, key)`` draws,
    by its own split sequence: ``split(key, B)``; per scene ``split(k, 5)``
    → the base crop (``_draw_crop``), the shift, the permutation, the
    background and the slots' keys; per slot ``split(kslot, attempts)``, and
    per proposal ``split`` into its frame's ``randint`` and its crop."""
    H, W = jbank.images.shape[1:3]
    comps = jnp.asarray(jbank.companions)
    counts = jnp.asarray(jbank.obj_count)
    cls = jnp.take(jnp.asarray(jbank.base_class), jnp.asarray(base_idx))

    def one(k, c):
        kb, kshift, kperm, kbg, kscan = jax.random.split(k, 5)
        crop = jnp.stack(JDS._draw_crop(kb, W, H, st.jitter))
        shift = jax.random.randint(kshift, (2,), -st.shift, st.shift + 1)
        perm = jax.random.permutation(kperm, 8)
        bg = jax.random.randint(kbg, (), 0, jbank.bgs.shape[0])

        def slot(cl, kslot):
            nactive = jnp.maximum(counts[cl], 1)

            def proposal(kk):
                kf, kc = jax.random.split(kk)
                return (jax.random.randint(kf, (), 0, nactive),
                        jnp.stack(JDS._draw_crop(kc, W, H, st.jitter)))
            return jax.vmap(proposal)(jax.random.split(kslot, st.attempts))

        offset, crops = jax.vmap(slot)(jnp.take(comps[c], perm),
                                       jax.random.split(kscan, 8))
        return crop, shift, perm, bg, offset, crops

    keys = jax.random.split(key, len(base_idx))
    return TDS.SynthDraws(*(torch.from_numpy(np.asarray(a).astype(np.int64))
                            for a in jax.jit(jax.vmap(one))(keys, cls)))


def _port_bank(jbank) -> TDS.DeviceSceneBank:
    return TDS.DeviceSceneBank(*(torch.from_numpy(np.array(a))
                                 for a in jbank))


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _parity(jbank, base_idx, key, out_w, out_h, binary=False, **st_kw):
    """JAX's batch and the port's from JAX's draws (``binary``: composited
    on u8 levels): (JAX images, JAX labels, port images, port labels),
    numpy."""
    jst, tst = JDS.DeviceSynthStatic(**st_kw), TDS.DeviceSynthStatic(**st_kw)
    jimg, jlab = JDS.synthesize_batch(jbank, base_idx, key, out_w=out_w,
                                      out_h=out_h, st=jst)
    tbank = _port_bank(jbank)
    assert TDS.binary_masks(tbank) or not binary
    timg, tlab = TDS.synthesize_batch(
        tbank, base_idx, _jax_draws(jbank, base_idx, key, jst), out_w=out_w,
        out_h=out_h, st=tst, binary=binary)
    return np.asarray(jimg), np.asarray(jlab), timg.numpy(), tlab.numpy()


def _objs_per_scene(labels) -> np.ndarray:
    rows = np.asarray(labels).reshape(len(labels), -1, NL)
    return (np.abs(rows[:, :, 1:]).sum(-1) > 0).sum(-1)


def _label_row(cls, cx, cy, half):
    """One 21-float row with keypoints on the mask's bounding box."""
    row = np.zeros(NL, np.float32)
    row[0] = cls
    xs = np.clip(cx + half * np.array([0, -1, 1, -1, 1, -1, 1, 0, 0]), 0, 1)
    ys = np.clip(cy + half * np.array([0, -1, -1, 1, 1, 0, 0, -1, 1]), 0, 1)
    row[1:2 * K + 1:2] = xs
    row[2:2 * K + 1:2] = ys
    row[19] = xs.max() - xs.min()
    row[20] = ys.max() - ys.min()
    return row


@pytest.fixture
def hand_bank():
    """``tests/test_device_synth.py``'s hand-made bank: 3 frames, 32×32:
    base (cls 0, cols 0..11), an overlapping companion (cls 1, cols 0..11)
    and a disjoint one (cls 2, cols 20..31); numpy arrays."""
    H = W = 32
    imgs = np.zeros((3, H, W, 3), np.uint8)
    masks = np.zeros((3, H, W), np.uint8)
    for i, (val, c0, c1) in enumerate(((200, 0, 12), (50, 0, 12),
                                       (100, 20, 32))):
        imgs[i, :, c0:c1] = val
        masks[i, :, c0:c1] = 255
    labels = np.stack([_label_row(0, 6 / 32, 0.5, 4 / 32),
                       _label_row(1, 6 / 32, 0.5, 4 / 32),
                       _label_row(2, 26 / 32, 0.5, 4 / 32)])
    obj_start = np.zeros(13, np.int32)
    obj_count = np.zeros(13, np.int32)
    obj_start[1], obj_count[1] = 1, 1
    obj_start[2], obj_count[2] = 2, 1
    comp = np.full((13, 8), -1, np.int32)
    comp[0, 0], comp[0, 1] = 1, 2
    bgs = np.full((1, H, W, 3), 30, np.uint8)
    return JDS.DeviceSceneBank(imgs, masks, labels, obj_start, obj_count,
                               comp, bgs, np.array([0], np.int32),
                               np.array([0], np.int32))


# (propose_scale, attempts, width, height)
_CASES = [(1, 30, 64, 64), (4, 30, 96, 96), (1, 3, 96, 64), (4, 3, 64, 96)]


@pytest.mark.parametrize("binary", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("ps,attempts,w,h", _CASES)
def test_hand_bank_scenes_match_jax(hand_bank, ps, attempts, w, h, binary):
    """Every dataset line a base (its class's companions); the class-0
    base has both companions, crops and shifts drawn (jitter 0.1, shift
    8 px); composited in f32, and on u8 levels (the masks are binary)."""
    bank = hand_bank._replace(base_index=np.arange(3, dtype=np.int32),
                              base_class=np.arange(3, dtype=np.int32))
    idx = np.array([0, 1, 2, 0, 0, 2], np.int32)
    ji, jl, ti, tl = _parity(bank, idx, jax.random.PRNGKey(w + attempts),
                             w, h, binary, jitter=0.1, shift=8,
                             attempts=attempts, propose_scale=ps)
    np.testing.assert_array_equal(_bits(ti), _bits(ji))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))
    assert _objs_per_scene(jl).max() > 1      # a companion was pasted


@pytest.fixture(scope="module")
def fake_linemod(tmp_path_factory):
    """LINEMOD/<obj>/{JPEGImages,mask,labels,train.txt} for 3 objects with
    binary PNG masks (``tests/test_device_synth.py``'s tree), and a
    background."""
    from PIL import Image
    tmp = tmp_path_factory.mktemp("synth_tree")
    rng = np.random.RandomState(1)
    root = tmp / "LINEMOD"
    centers = {"ape": (160, 120), "can": (480, 120), "cat": (320, 360)}
    for oi, obj in enumerate(["ape", "can", "cat"]):
        base = root / obj
        for d in ("JPEGImages", "mask", "labels"):
            (base / d).mkdir(parents=True)
        paths = []
        for i in range(3):
            img = rng.randint(0, 255, (480, 640, 3), np.uint8)
            cx, cy = centers[obj]
            m = np.zeros((480, 640), np.uint8)
            m[cy - 60:cy + 60, cx - 60:cx + 60] = 255
            name = f"00{i:04d}"
            Image.fromarray(img).save(base / "JPEGImages" / f"{name}.jpg")
            Image.fromarray(m).save(base / "mask" / f"{name[2:]}.png")
            lab = np.zeros(21, np.float32)
            lab[0] = oi
            lab[1:19:2] = cx / 640.0 + rng.uniform(-0.05, 0.05, 9)
            lab[2:19:2] = cy / 480.0 + rng.uniform(-0.05, 0.05, 9)
            lab[19:21] = [0.19, 0.25]
            np.savetxt(base / "labels" / f"{name}.txt", lab[None])
            paths.append(f"LINEMOD/{obj}/JPEGImages/{name}.jpg")
        (base / "train.txt").write_text("\n".join(paths) + "\n")
    bg = tmp / "bg.jpg"
    Image.fromarray(rng.randint(0, 256, (64, 80, 3), np.uint8)).save(bg)
    bases = [str(root / "ape/JPEGImages/000000.jpg"),
             str(root / "ape/JPEGImages/000001.jpg"),
             str(root / "cat/JPEGImages/000002.jpg")]
    return str(root), bases, str(bg)


@pytest.fixture(scope="module")
def tree_banks(fake_linemod):
    root, bases, bg = fake_linemod
    jbank = JDS.build_scene_bank(JSynthConfig(linemod_root=root), bases, [bg])
    tbank = TDS.build_scene_bank(TSM.SynthConfig(linemod_root=root), bases,
                                 [bg])
    return jbank, tbank


def test_build_scene_bank_matches_jax(tree_banks):
    jbank, tbank = tree_banks
    assert TDS.DeviceSceneBank._fields == JDS.DeviceSceneBank._fields
    for name, j, t in zip(jbank._fields, jbank, tbank):
        assert t.numpy().dtype == np.asarray(j).dtype, name
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    assert tbank.images.shape == (9, 480, 640, 3)
    assert tbank.companions.shape == (14, 8)
    assert tbank.base_class.tolist() == [0, 0, 4]
    assert tbank.nbytes() == jbank.nbytes()
    assert TDS.binary_masks(tbank)          # PNG masks of 0 and 255
    assert not TDS.binary_masks(_port_bank(_soft_bank()))


@pytest.mark.parametrize("binary", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("ps,attempts,w,h", _CASES)
def test_tree_bank_scenes_match_jax(tree_banks, ps, attempts, w, h, binary):
    jbank, _ = tree_banks
    idx = np.array([0, 1, 2, 1], np.int32)
    ji, jl, ti, tl = _parity(jbank, idx, jax.random.PRNGKey(ps * 7 + w),
                             w, h, binary, jitter=0.1, shift=10,
                             attempts=attempts, propose_scale=ps)
    np.testing.assert_array_equal(_bits(ti), _bits(ji))
    np.testing.assert_array_equal(_bits(tl), _bits(jl))
    assert (_objs_per_scene(jl) == 3).all()   # centres far apart: all placed


def _soft_bank(seed: int = 2, N: int = 12, H: int = 48, W: int = 64):
    """Frames with soft masks (u8 levels 0..255 inside a box): every
    composite product matters to the bits.  Classes 0..5 with 2 frames
    each, each base class with 7 companions (some classes empty)."""
    rng = np.random.RandomState(seed)
    imgs = rng.randint(0, 256, (N, H, W, 3)).astype(np.uint8)
    masks = np.zeros((N, H, W), np.uint8)
    labels = np.zeros((N, NL), np.float32)
    for i in range(N):
        y0, x0 = rng.randint(0, H // 2), rng.randint(0, W // 2)
        hh, ww = rng.randint(8, H // 2), rng.randint(8, W // 2)
        masks[i, y0:y0 + hh, x0:x0 + ww] = rng.randint(0, 256, (hh, ww))
        labels[i, 0] = i // 2
        labels[i, 1:19] = rng.uniform(0.0, 1.0, 18)
    obj_start = np.zeros(13, np.int32)
    obj_count = np.zeros(13, np.int32)
    obj_start[:6], obj_count[:6] = np.arange(6) * 2, 2
    comp = np.full((14, 8), -1, np.int32)
    for c in range(13):
        comp[c, :7] = [o for o in range(13) if o != c][:7]
    return JDS.DeviceSceneBank(
        imgs, masks, labels, obj_start, obj_count, comp,
        rng.randint(0, 256, (3, H, W, 3)).astype(np.uint8),
        np.arange(N, dtype=np.int32), (np.arange(N) // 2).astype(np.int32))


@pytest.mark.parametrize("ps,attempts,w,h", [(4, 3, 96, 96), (1, 30, 96, 64)])
def test_soft_masks_match_jax_per_scene(ps, attempts, w, h):
    """Soft masks: the port = JAX's program compiled for one scene, bit
    for bit; JAX's batched program differs from it on some pixels."""
    jbank = _soft_bank()
    st_kw = dict(jitter=0.1, shift=20, attempts=attempts, propose_scale=ps)
    idx = np.array([0, 3, 7, 10], np.int32)
    key = jax.random.PRNGKey(w + ps)
    ji, jl, ti, tl = _parity(jbank, idx, key, w, h, **st_kw)
    one = jax.jit(partial(JDS._synthesize_one, out_w=w, out_h=h,
                          st=JDS.DeviceSynthStatic(**st_kw)))
    dbank = jax.tree.map(jnp.asarray, jbank)
    batch_vs_one = 0
    for b, k in enumerate(jax.random.split(key, len(idx))):
        oi, ol = one(dbank, jbank.base_index[idx[b]],
                     jbank.base_class[idx[b]], k)
        np.testing.assert_array_equal(_bits(ti[b]), _bits(oi))
        np.testing.assert_array_equal(_bits(tl[b]), _bits(ol))
        batch_vs_one += int((_bits(ji[b]) != _bits(oi)).sum())
    np.testing.assert_array_equal(_bits(tl), _bits(jl))
    print(f"JAX batched != JAX per scene on {batch_vs_one} of {ji.size} "
          "pixel values")
    assert int((_bits(ti) != _bits(ji)).sum()) == batch_vs_one


# ---- closed forms, as tests/test_device_synth.py holds JAX's -----------


def _synth(bank, idx, seed, **st_kw):
    """The port's scenes from its own draws (a CPU generator)."""
    st = TDS.DeviceSynthStatic(**st_kw)
    tbank = _port_bank(bank)
    idx = torch.as_tensor(np.asarray(idx, np.int64))
    H, W = tbank.frame_shape
    draws = TDS.draw_synth(torch.Generator().manual_seed(seed), len(idx),
                           tbank, tbank.base_class[idx].long(), st, W, H)
    img, lab = TDS.synthesize_batch(tbank, idx, draws, out_w=32, out_h=32,
                                    st=st)
    return img.numpy(), lab.numpy().reshape(len(idx), 50, NL)


def test_rejection_composite_and_labels_exact(hand_bank):
    img, lab = _synth(hand_bank, [0], 3, jitter=0.0, shift=0, attempts=3)
    img, lab = img[0], lab[0]
    # cls 1 covers the base (ratio 1.0 ≥ 0.2: rejected); cls 2 is disjoint
    n = int((lab[:, 1] != 0).argmin())
    assert n == 2
    assert set(lab[:2, 0].astype(int)) == {0, 2}
    np.testing.assert_allclose(lab[0], hand_bank.labels[0], atol=1e-6)
    np.testing.assert_allclose(lab[1], hand_bank.labels[2], atol=1e-6)
    np.testing.assert_allclose(img[:, 0:12], 200 / 255.0, atol=1e-6)
    np.testing.assert_allclose(img[:, 20:32], 100 / 255.0, atol=1e-6)
    np.testing.assert_allclose(img[:, 12:20], 30 / 255.0, atol=1e-6)


def test_base_always_on_top(hand_bank):
    masks, imgs = np.array(hand_bank.masks), np.array(hand_bank.images)
    masks[2] = 0
    masks[2, :, 6:18] = 255          # overlaps base cols 6..11 (ratio 0.5)
    imgs[2] = 0
    imgs[2, :, 6:18] = 100
    bank = hand_bank._replace(masks=masks, images=imgs)
    img, lab = _synth(bank, [0], 0, jitter=0.0, shift=0, attempts=3,
                      max_intersection=0.75)     # accepted at 0.5 < 0.75
    assert int((lab[0, :, 1] != 0).argmin()) == 2
    np.testing.assert_allclose(img[0, :, 0:12], 200 / 255.0, atol=1e-6)
    np.testing.assert_allclose(img[0, :, 12:18], 100 / 255.0, atol=1e-6)


def test_base_class_indexed_by_dataset_line(hand_bank):
    """Dataset line 0 → bank row 2 (class 2, no companions): a bank-row
    lookup of the class would paste class 0's companions."""
    bank = hand_bank._replace(base_index=np.array([2], np.int32),
                              base_class=np.array([2], np.int32))
    img, lab = _synth(bank, [0], 2, jitter=0.0, shift=0, attempts=3)
    assert int((lab[0, :, 1] != 0).argmin()) == 1
    assert int(lab[0, 0, 0]) == 2
    np.testing.assert_allclose(img[0, :, 20:32], 100 / 255.0, atol=1e-6)
    np.testing.assert_allclose(img[0, :, 0:20], 30 / 255.0, atol=1e-6)


def test_unplaceable_when_all_proposals_collide(hand_bank):
    comp = np.array(hand_bank.companions)
    comp[0] = -1
    comp[0, 0] = 1
    _, lab = _synth(hand_bank._replace(companions=comp), [0], 1, jitter=0.0,
                    shift=0, attempts=4)
    assert int((lab[0, :, 1] != 0).argmin()) == 1


# ---- the port's own draws -------------------------------------------------


@pytest.mark.parametrize("attempts", [None, 4])
def test_static_from_config_matches_jax(attempts):
    tcfg = TSM.SynthConfig(linemod_root="/nonexistent", max_attempts=17)
    jcfg = JSynthConfig(linemod_root="/nonexistent", max_attempts=17)
    got = TDS.DeviceSynthStatic.from_config(tcfg, attempts=attempts)
    want = JDS.DeviceSynthStatic.from_config(jcfg, attempts=attempts)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.attempts == (17 if attempts is None else 4)
    assert got.propose_scale == 4
    with pytest.raises(ValueError, match="flip='off'"):
        TDS.DeviceSynthStatic.from_config(
            TSM.SynthConfig(linemod_root="/x", flip="reference"))


def test_draws_fall_in_jax_ranges(tree_banks):
    _, bank = tree_banks
    st = TDS.DeviceSynthStatic(jitter=0.1, shift=10, attempts=30)
    H, W = bank.frame_shape
    idx = torch.tensor([0, 1, 2, 0, 2, 1])
    cls = bank.base_class[idx].long()
    d = TDS.draw_synth(torch.Generator().manual_seed(9), 6, bank, cls, st,
                       W, H)
    assert tuple(d.offset.shape) == (6, 8, 30)
    assert tuple(d.crop.shape) == (6, 8, 30, 4)
    dw, dh = int(W * 0.1), int(H * 0.1)
    for crop in (d.base_crop, d.crop.reshape(-1, 4)):
        pl, pt, sw, sh = crop.unbind(-1)
        assert pl.abs().max() <= dw and pt.abs().max() <= dh
        pr, pb = W - pl - sw, H - pt - sh          # the other two offsets
        assert pr.abs().max() <= dw and pb.abs().max() <= dh
    # the 1,440 proposals reach both ends
    assert (pl.min(), pl.max(), pb.min(), pb.max()) == (-dw, dw, -dh, dh)
    assert d.shift.abs().max() <= 10 and d.shift.min() < 0 < d.shift.max()
    assert (d.perm.sort(1).values == torch.arange(8)).all()
    assert 0 <= d.bg.min() and d.bg.max() < bank.bgs.shape[0]
    slot_cls = bank.companions[cls].long().gather(1, d.perm).clamp(min=0)
    n = bank.obj_count[slot_cls].long().clamp(min=1)
    assert (d.offset >= 0).all() and (d.offset < n[..., None]).all()
    assert (d.offset == 2).any()                  # a class's last frame


def test_same_seed_same_batch(tree_banks):
    _, bank = tree_banks
    st = TDS.DeviceSynthStatic(jitter=0.1, shift=10, attempts=6,
                               propose_scale=4)
    H, W = bank.frame_shape
    idx = torch.tensor([0, 2, 1])

    def batch(seed):
        d = TDS.draw_synth(torch.Generator().manual_seed(seed), 3, bank,
                           bank.base_class[idx].long(), st, W, H)
        return TDS.synthesize_batch(bank, idx, d, out_w=64, out_h=64, st=st)

    (a, la), (b, lb), (c, _) = batch(5), batch(5), batch(6)
    assert torch.equal(a, b) and torch.equal(la, lb)
    assert not torch.equal(a, c)
    assert a.shape == (3, 64, 64, 3) and la.shape == (3, 50 * NL)
    assert 0.0 <= float(a.min()) and float(a.max()) <= 1.0


@pytest.fixture
def crowded_linemod(tmp_path, monkeypatch):
    """``tests/test_device_synth.py``'s crowded corpus (160×120 frames, 5
    objects × 4 frames, big masks); the first object gets the other four as
    companions."""
    from PIL import Image
    rng = np.random.RandomState(3)
    root = tmp_path / "LINEMOD"
    objs = TSM.OCCLUSION_CLASSES[:5]
    for oi, obj in enumerate(objs):
        base = root / obj
        for d in ("JPEGImages", "mask", "labels"):
            (base / d).mkdir(parents=True)
        paths = []
        for i in range(4):
            img = rng.randint(0, 255, (120, 160, 3), np.uint8)
            m = np.zeros((120, 160), np.uint8)
            hw, hh = rng.randint(25, 45), rng.randint(20, 38)
            cx = rng.randint(hw, 160 - hw)
            cy = rng.randint(hh, 120 - hh)
            m[cy - hh:cy + hh, cx - hw:cx + hw] = 255
            name = f"00{i:04d}"
            Image.fromarray(img).save(base / "JPEGImages" / f"{name}.jpg")
            Image.fromarray(m).save(base / "mask" / f"{name[2:]}.png")
            lab = np.zeros(21, np.float32)
            lab[0] = oi
            lab[1:19:2] = np.clip(cx / 160.0 + rng.uniform(-0.1, 0.1, 9),
                                  0, 1)
            lab[2:19:2] = np.clip(cy / 120.0 + rng.uniform(-0.1, 0.1, 9),
                                  0, 1)
            lab[19:21] = [2 * hw / 160.0, 2 * hh / 120.0]
            np.savetxt(base / "labels" / f"{name}.txt", lab[None])
            paths.append(f"LINEMOD/{obj}/JPEGImages/{name}.jpg")
        (base / "train.txt").write_text("\n".join(paths) + "\n")
    add = dict(TSM.ADD_OBJS)
    add[objs[0]] = tuple(objs[1:])
    monkeypatch.setattr(TSM, "ADD_OBJS", add)
    monkeypatch.setattr(TDS, "ADD_OBJS", add)
    return str(root), objs


def test_placement_distribution_matches_host(crowded_linemod, tmp_path):
    """Objects per scene: the port's draws at the default attempts (the
    host's max_attempts) match the host synthesizer's mean within 0.5
    (JAX's tolerance), and one attempt under-places by more than 0.5."""
    root, objs = crowded_linemod
    lines = [os.path.join(root, objs[0], "JPEGImages", f"00{i:04d}.jpg")
             for i in range(4)]
    listfile = tmp_path / "base.txt"
    listfile.write_text("\n".join(lines) + "\n")
    cfg = TSM.SynthConfig(linemod_root=root)
    synth = TSM.MultiObjectSynthesizer(cfg)
    ds = TP.PoseDataset(str(listfile), train=True, synthesizer=synth,
                        cache_decoded=True)
    rng = np.random.RandomState(11)
    host = [_objs_per_scene(synth(ds, lines[i % 4], (96, 96), rng)[1][None])
            for i in range(64)]
    host_mean = float(np.mean(host))
    assert host_mean > 2.5              # the corpus is crowded

    bank = TDS.build_scene_bank(cfg, lines)
    H, W = bank.frame_shape

    def device_mean(attempts):
        st = TDS.DeviceSynthStatic.from_config(cfg, attempts=attempts)
        gen = torch.Generator().manual_seed(5)
        counts = []
        for i in range(4):
            idx = torch.arange(16) % 4
            d = TDS.draw_synth(gen, 16, bank, bank.base_class[idx].long(),
                               st, W, H)
            counts.append(_objs_per_scene(TDS.synthesize_batch(
                bank, idx, d, out_w=96, out_h=96, st=st)[1].numpy()))
        return float(np.concatenate(counts).mean())

    parity, starved = device_mean(None), device_mean(1)
    assert abs(parity - host_mean) < 0.5, (parity, host_mean)
    assert parity - starved > 0.5, (parity, starved)


# ---- the loader, the multi trainer and the CLI ------------------------------


def _synth_dataset(fake_linemod, tmp_path, n=2):
    root, bases, _ = fake_linemod
    listfile = tmp_path / "tr.txt"
    listfile.write_text("\n".join(bases[:n]) + "\n")
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(linemod_root=root,
                                                       shift=10))
    return TP.PoseDataset(str(listfile), train=True,
                          aug=TP.AugmentConfig.multi(), synthesizer=synth)


def test_loader_device_synth_feeds_train_step(fake_linemod, tmp_path):
    ds = _synth_dataset(fake_linemod, tmp_path)
    ld = TP.Loader(ds, batch_size=2, fixed_shape=(64, 64), num_workers=0,
                   seed=0, backend="device_synth", device="cpu")
    imgs, labels = next(iter(ld))
    assert imgs.dtype == torch.float32 and labels.dtype == torch.float32
    assert imgs.shape == (2, 64, 64, 3) and labels.shape == (2, 50 * NL)
    assert imgs.device.type == labels.device.type == "cpu"
    assert ld.seen == 2 and ld.pool is None
    assert (_objs_per_scene(labels.numpy()) == 3).all()

    spec = DarknetSpec(TINY_MULTI_BLOCKS)
    state = init_train_state(
        Darknet(spec, generator=torch.Generator().manual_seed(0)),
        weight_decay=1e-3, momentum=0.9)
    cfg = TDr.loss_config_from_spec(spec, pretrain_num_epochs=0,
                                    im_width=640, im_height=480, multi=True)
    stats = make_train_step(cfg, compute_dtype=None)(state, imgs, labels,
                                                     1e-4, 100)
    assert np.isfinite(float(stats["loss"]))
    assert int(stats["nGT"]) == 6


def test_loader_threads_synth_knobs(fake_linemod, tmp_path):
    ds = _synth_dataset(fake_linemod, tmp_path, n=1)

    def first_batch():
        ld = TP.Loader(ds, batch_size=1, fixed_shape=(64, 64), num_workers=0,
                       seed=0, backend="device_synth", device="cpu",
                       synth_attempts=2, synth_propose_scale=2)
        return ld, next(iter(ld))

    ld, (a, la) = first_batch()
    assert ld._synth_static.attempts == 2
    assert ld._synth_static.propose_scale == 2
    # the loader's host stream seeds each batch's generator: the same seed
    # gives the same scenes
    _, (b, lb) = first_batch()
    assert torch.equal(a, b) and torch.equal(la, lb)


def test_loader_device_synth_requires_synthesizer(tmp_path):
    listfile = tmp_path / "t.txt"
    listfile.write_text("x.jpg\n")
    ds = TP.PoseDataset(str(listfile), train=True)
    with pytest.raises(ValueError, match="device_synth"):
        TP.Loader(ds, batch_size=1, num_workers=0, backend="device_synth",
                  device="cpu")


@pytest.mark.parametrize("backend", ["native", "device", "device_bank"])
def test_multi_trainer_refuses_single_object_backends(occ_tree, backend):
    root, lm, occ, ape, cfg = occ_tree
    with pytest.raises(ValueError, match="scene-synthesis"):
        TDr.run_training_multi(occ, cfg, None, 0, None, None,
                               TDr.TrainRunConfig(device="cpu",
                                                  loader_backend=backend))


def test_run_training_multi_device_synth_on_cpu(occ_tree, monkeypatch):
    """One epoch fed by device_synth on the CPU, with precompile_buckets
    (the eager step there); the loader gets the device and the knobs, and
    the scenes are f32."""
    root, lm, occ, ape, cfg = occ_tree
    seen = {}
    real = TDr.Loader

    def loader(*a, **kw):
        ld = real(*a, **kw)
        seen.update(kw, obj=ld)
        return ld

    monkeypatch.setattr(TDr, "Loader", loader)
    rc = TDr.TrainRunConfig(eval_every=20, eval_after=-1, num_workers=2,
                            eval_batch_size=2,
                            bg_dir=os.path.join(root, "VOC", "JPEGImages"),
                            log_every=1, max_epochs_override=1,
                            compute_dtype=None, device="cpu",
                            loader_backend="device_synth",
                            synth_attempts=5, synth_propose_scale=8,
                            precompile_buckets=True)
    result = TDr.run_training_multi(occ, cfg, None, 0, None, None, rc)
    losses = result["history"]["training_losses"]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert result["state"].seen == 4
    assert seen["backend"] == "device_synth" and seen["out_uint8"] is False
    assert seen["device"] == torch.device("cpu")
    st = seen["obj"]._synth_static
    assert (st.attempts, st.propose_scale) == (5, 8)
    # the fixture's bank: its 4 objects × 2 frames
    assert seen["obj"]._synth_bank.images.shape[0] == 8


def test_cli_train_multi_device_synth_flags(occ_tree, monkeypatch, capsys):
    root, lm, occ, _, cfg = occ_tree
    got = {}

    def run(*a):
        got["rc"] = a[-1]
        return {"best_acc": 0.0}

    monkeypatch.setattr(TDr, "run_training_multi", run)
    assert tcli(["train-multi", "--datacfg", occ, "--modelcfg", cfg,
                 "--initweightfile", "", "--device", "cpu",
                 "--loader_backend", "device_synth", "--synth_attempts", "6",
                 "--synth_propose_scale", "2"]) == 0
    rc = got["rc"]
    assert (rc.loader_backend, rc.synth_attempts, rc.synth_propose_scale) \
        == ("device_synth", 6, 2)
    assert TDr.TrainRunConfig().synth_attempts is None
    assert TDr.TrainRunConfig().synth_propose_scale == 4


# ---- the serve's u8 scale ----------------------------------------------------


def test_serve_scales_u8_as_jax(monkeypatch):
    """All 256 levels through the serving function's u8 path equal JAX's
    jitted ``x.astype(f32) / 255.0`` bit for bit."""
    spec = DarknetSpec(TINY_BLOCKS)
    folded = fold_batchnorm(Darknet(spec,
                                    generator=torch.Generator().manual_seed(0)))
    seen = []
    real = TSv.apply_folded

    def spy(spec, folded, images, **kw):
        seen.append(images.clone())
        return real(spec, folded, images, **kw)

    monkeypatch.setattr(TSv, "apply_folded", spy)
    levels = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1).repeat(3, -1)
    frames = np.pad(levels, ((0, 0), (0, 48), (0, 48), (0, 0)))
    TSv.make_serving_fn(spec, folded, pick=("best",))(frames)
    want = np.asarray(jax.jit(lambda x: x.astype(jnp.float32) / 255.0)(
        frames))
    np.testing.assert_array_equal(_bits(seen[0].numpy()), _bits(want))
    # the division it replaced differs on 126 levels
    div = (torch.arange(256).float() / torch.tensor(255.0)).numpy()
    assert int((_bits(div) != _bits(want[0, :16, :16, 0].reshape(-1))).sum()) \
        == 126


# ---- scripts/shaded_accuracy_multi.py ---------------------------------------


def _script():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "shaded_accuracy_multi",
        os.path.join(REPO, "scripts", "shaded_accuracy_multi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_shaded_accuracy_multi_script_on_cpu(tmp_path, capsys):
    out = tmp_path / "result.json"
    assert _script().main([
        "--frames_per_class", "2", "--steps", "3", "--batch", "2", "--size",
        "64", "--n_eval", "2", "--n_splats", "300", "--device", "cpu",
        "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert json.loads(out.read_text()) == result
    assert result["eval_n"] == 6                     # 2 scenes × 3 objects
    assert result["steps"] == 3 and len(result["chunk_losses"]) >= 1
    for k in ("acc_2d_5px", "acc_2d_10px", "mean_px_err"):
        assert np.isfinite(result[k]), k
    assert np.isfinite(result["chunk_losses"]).all()
