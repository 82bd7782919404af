"""The port's multi-object host code against the JAX package: the OCCLUSION
``.data`` renderers and sweep, the GT corner permutation, the multi-scale
schedule and augmentation settings, the scene synthesizer
(singleshotpose_tpu_torch/data/synth_multi.py) and the loader over its
scenes.

Exact, as ``tests/test_torch_host.py`` holds the single-object copies: the
configs compare equal, and one scene with its 50-slot label, and every
loader batch under ``MULTI_SCHEDULE``, is bit for bit the JAX package's
(``SynthConfig(native="off")``, ``Loader(backend="python")``) for the same
seed.  The tree is ``tests/linemod_fixture.py``'s, with eggbox and its 8
companions, each object moved to its own cell of a 3×3 layout of the frame
(the fixture centres them all) so that companions rarely overlap and an
eggbox scene carries 9 objects; each label file's class id is set to its
object's OCCLUSION class.
"""

import dataclasses
import os

import numpy as np
import pytest

from singleshotpose_tpu import config as JC
from singleshotpose_tpu import zoo as JZ
from singleshotpose_tpu.data import pipeline as JP
from singleshotpose_tpu.data import synth_multi as JSM
from singleshotpose_tpu.utils import geometry as JG

from singleshotpose_tpu_torch import config as TC
from singleshotpose_tpu_torch import zoo as TZ
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.data import synth_multi as TSM
from singleshotpose_tpu_torch.utils import geometry as TG
from singleshotpose_tpu_torch.utils.labels import get_all_files

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from linemod_fixture import make_linemod_fixture

# eggbox and its companions (synth_multi.ADD_OBJS["eggbox"])
OBJECTS = ("ape", "benchvise", "cam", "can", "cat", "duck", "eggbox",
           "glue", "holepuncher")


def test_zoo_occlusion_tables_match_jax():
    assert TZ.LINEMOD_DIAMETERS == JZ.LINEMOD_DIAMETERS
    assert TZ.LINEMOD_OBJECTS == JZ.LINEMOD_OBJECTS
    assert TZ.OCCLUSION_OBJECTS == JZ.OCCLUSION_OBJECTS
    assert TZ.LINEMOD_OBJECTS == TSM.OCCLUSION_CLASSES == JSM.OCCLUSION_CLASSES
    assert TSM.ADD_OBJS == JSM.ADD_OBJS
    assert max(len(v) for v in TSM.ADD_OBJS.values()) == \
        len(TSM.ADD_OBJS["eggbox"]) == 8
    for zoo in (TZ, JZ):
        with pytest.raises(ValueError):
            zoo.occlusion_datacfg("lamp")


@pytest.mark.parametrize("obj", (None,) + JZ.OCCLUSION_OBJECTS)
def test_occlusion_datacfg_and_sweep_match_jax(tmp_path, obj):
    kw = dict(linemod_root="data/LINEMOD", backup_root="bk",
              train_list="cfg/tr.txt") if obj is None else \
        dict(linemod_root="data/LINEMOD", backup_root="bk")
    text = TZ.occlusion_datacfg(obj, **kw)
    assert text == JZ.occlusion_datacfg(obj, **kw)
    path = tmp_path / "occ.data"
    path.write_text(text)
    tdc = TC.data_config_from_options(TC.read_data_cfg(str(path)))
    jdc = JC.data_config_from_options(JC.read_data_cfg(str(path)))
    got = [dataclasses.asdict(e) for e in TC.occlusion_sweep(tdc)]
    want = [dataclasses.asdict(e) for e in JC.occlusion_sweep(jdc)]
    assert got == want
    assert len(got) == (7 if obj is None else 0)


def test_fix_corner_order_matches_jax():
    c = np.random.RandomState(0).rand(9, 2)
    np.testing.assert_array_equal(TG.fix_corner_order(c),
                                  JG.fix_corner_order(c))
    assert TG.fix_corner_order(c).dtype == np.float32


def test_multi_schedule_and_augment_config_match_jax():
    assert TP.MULTI_SCHEDULE.stages == JP.MULTI_SCHEDULE.stages
    assert TP.MULTI_SCHEDULE.all_widths == JP.MULTI_SCHEDULE.all_widths
    assert (TP.MULTI_SCHEDULE.all_widths[0],
            TP.MULTI_SCHEDULE.all_widths[-1]) == (320, 608)
    a, b = np.random.RandomState(1), np.random.RandomState(1)
    for seen in range(0, 3000, 41):
        assert TP.MULTI_SCHEDULE.draw(a, seen, 5, 8) == \
            JP.MULTI_SCHEDULE.draw(b, seen, 5, 8)
    assert dataclasses.asdict(TP.AugmentConfig.multi()) == \
        dataclasses.asdict(JP.AugmentConfig.multi())


def test_compositing_helpers_match_jax():
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (48, 64, 3), np.uint8)
    mask = (rng.rand(48, 64) > 0.4).astype(np.uint8) * 255
    total = rng.randint(0, 256, (48, 64), np.uint8)
    np.testing.assert_array_equal(TSM.mask_foreground(img, mask),
                                  JSM.mask_foreground(img, mask))
    np.testing.assert_array_equal(TSM.superimpose(img, mask, img[::-1]),
                                  JSM.superimpose(img, mask, img[::-1]))
    np.testing.assert_array_equal(TSM.superimpose_masks(mask, total),
                                  JSM.superimpose_masks(mask, total))
    for fn in ("shifted_augment_with_mask", "augment_with_mask"):
        a, b = np.random.RandomState(3), np.random.RandomState(3)
        for flip in (False, True):
            got = getattr(TSM, fn)(a, img, mask, 40, 32, 0.1,
                                   apply_flip=flip)
            want = getattr(JSM, fn)(b, img, mask, 40, 32, 0.1,
                                    apply_flip=flip)
            np.testing.assert_array_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1], want[1])
            assert got[2:] == want[2:]


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The fixture tree, each object rolled (frame, mask and label) to its
    cell of a 3×3 layout and its class id set, and a VOC background;
    returns (LINEMOD root, background files)."""
    from PIL import Image
    root = str(tmp_path_factory.mktemp("multi_host"))
    lm = make_linemod_fixture(root, OBJECTS, n_frames=2, seed=30)
    for k, obj in enumerate(OBJECTS):
        dx, dy = (k % 3 - 1) * 200, (k // 3 - 1) * 150
        for i in range(2):
            name = f"00{i:04d}"
            for path in (os.path.join(lm, obj, "JPEGImages", f"{name}.jpg"),
                         os.path.join(lm, obj, "mask", f"{name[2:]}.png")):
                a = np.roll(np.asarray(Image.open(path)), (dy, dx), (0, 1))
                Image.fromarray(a).save(path)
            path = os.path.join(lm, obj, "labels", f"{name}.txt")
            lab = np.loadtxt(path, ndmin=2)
            lab[:, 0] = TSM.OCCLUSION_CLASSES.index(obj)
            lab[:, 1:19:2] += dx / 640
            lab[:, 2:19:2] += dy / 480
            np.savetxt(path, lab)
    return lm, get_all_files(os.path.join(root, "VOC", "JPEGImages"))


def _frame(lm, obj, i=0):
    return os.path.join(lm, obj, "JPEGImages", f"00{i:04d}.jpg")


@pytest.mark.parametrize("base,shape,seed", [("eggbox", (416, 416), 4),
                                             ("ape", (352, 352), 5),
                                             ("cat", (608, 608), 6)])
def test_scene_matches_jax(tree, tmp_path, base, shape, seed):
    lm, bgs = tree
    listfile = tmp_path / "train.txt"
    listfile.write_text(_frame(lm, base) + "\n")
    scenes = []
    for P, SM, extra in ((TP, TSM, {"native": "off"}),
                         (JP, JSM, {"native": "off"})):
        synth = SM.MultiObjectSynthesizer(SM.SynthConfig(
            linemod_root=lm, max_attempts=6, **extra))
        ds = P.PoseDataset(str(listfile), train=True, bg_file_names=bgs,
                           synthesizer=synth)
        scenes.append(synth(ds, _frame(lm, base), shape,
                            np.random.RandomState(seed)))
    (gi, gl), (wi, wl) = scenes
    assert gi.dtype == wi.dtype == np.uint8 and gi.shape == shape + (3,)
    np.testing.assert_array_equal(gi, wi)
    np.testing.assert_array_equal(gl, wl)
    lab = gl.reshape(50, 21)
    n = int(np.cumprod(lab[:, 1] != 0).sum())
    assert 2 <= n <= 1 + len(TSM.ADD_OBJS[base])
    assert lab[0, 0] == TSM.OCCLUSION_CLASSES.index(base)
    if base == "eggbox":
        assert n == 9, n                  # the base and all 8 companions


def _multi_batches(P, SM, lm, listfile, bgs, extra_synth, extra_loader, **kw):
    synth = SM.MultiObjectSynthesizer(SM.SynthConfig(
        linemod_root=lm, max_attempts=6, **extra_synth))
    ds = P.PoseDataset(listfile, train=True, bg_file_names=bgs,
                       aug=P.AugmentConfig.multi(), synthesizer=synth)
    return list(P.Loader(ds, 2, schedule=P.MULTI_SCHEDULE, **kw,
                         **extra_loader))


@pytest.mark.parametrize("out_uint8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("seen", [0, 130], ids=["416", "multi-scale"])
def test_multi_loader_batches_equal_jax(tree, tmp_path, seen, out_uint8):
    """Seeded batches of synthesized scenes: MULTI_SCHEDULE's widths (at
    ``seen`` = 130 the second stage draws from 416–512), the scenes and
    their labels, bit for bit."""
    lm, bgs = tree
    listfile = tmp_path / "train.txt"
    listfile.write_text("\n".join(_frame(lm, o, i) for o in
                                  ("eggbox", "ape", "cat") for i in (0, 1))
                        + "\n")
    kw = dict(seen=seen, seed=12, num_workers=2, out_uint8=out_uint8)
    got = _multi_batches(TP, TSM, lm, str(listfile), bgs, {"native": "off"},
                         {"backend": "python"}, **kw)
    want = _multi_batches(JP, JSM, lm, str(listfile), bgs, {"native": "off"},
                          {"backend": "python"}, **kw)
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    widths = [b[0].shape[1] for b in got]
    if seen:
        assert all(416 <= w <= 512 for w in widths)
    else:
        assert set(widths) == {416}
    ngt = [int(np.cumprod(lab.reshape(50, 21)[:, 1] != 0).sum())
           for _, labels in got for lab in labels]
    assert max(ngt) > 1
