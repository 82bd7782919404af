"""The port's own copies of the JAX package's plain-Python host modules
(singleshotpose_tpu_torch/{config,utils,data}) against the originals.

The port imports nothing of ``singleshotpose_tpu``, so it keeps copies of
the framework-free modules it runs: the cfg and ``.data`` parsers, the
geometry, mesh and label helpers, the augmentation, the prefetch thread and
the Python-backend loader.  Each is held here to the original on the same
inputs, exactly: the parsed blocks and typed configs compare equal, the
arrays bit for bit, and every loader batch — train mode with its seeded
multi-scale widths, background swaps and augmentation, and test mode — is
bit for bit the JAX package's ``Loader(backend="python")`` batch.
"""

import dataclasses
import os

import numpy as np
import pytest

from singleshotpose_tpu import config as JC
from singleshotpose_tpu.data import augment as JA
from singleshotpose_tpu.data import pipeline as JP
from singleshotpose_tpu.data import prefetch as JPf
from singleshotpose_tpu.utils import geometry as JG
from singleshotpose_tpu.utils import labels as JLb
from singleshotpose_tpu.utils import meshply as JM
from singleshotpose_tpu.zoo import yolo_pose_single as jzoo_single

from singleshotpose_tpu_torch import config as TC
from singleshotpose_tpu_torch.data import augment as TA
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.data import prefetch as TPf
from singleshotpose_tpu_torch.utils import geometry as TG
from singleshotpose_tpu_torch.utils import labels as TLb
from singleshotpose_tpu_torch.utils import meshply as TM

import torch_port_helpers
from linemod_fixture import make_linemod_fixture
from test_drivers import TINY_CFG as DRIVER_CFG


def _asdict(cfg):
    return dataclasses.asdict(cfg)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


_CFGS = {"tiny": torch_port_helpers.TINY_CFG, "driver": DRIVER_CFG,
         "commented": "# a comment\n\n[net]\nwidth=320\nheight = 288\n"
                      "steps=-1,80\n[convolutional]\nfilters=32\nsize=3\n"
                      "stride=1\npad=1\nactivation=leaky\n[cost]\ntype=sse\n"
                      "[maxpool]\nsize=2\nstride=2\n"}


@pytest.mark.parametrize("name", sorted(_CFGS))
def test_parse_cfg_and_format_table_match_jax(tmp_path, name):
    path = tmp_path / f"{name}.cfg"
    path.write_text(_CFGS[name])
    blocks = TC.parse_cfg(str(path))
    assert blocks == JC.parse_cfg(str(path))
    assert TC.format_cfg_table(blocks) == JC.format_cfg_table(blocks)
    assert _asdict(TC.net_config_from_block(blocks[0])) == \
        _asdict(JC.net_config_from_block(blocks[0]))
    for b in blocks:
        if b["type"] == "region":
            assert _asdict(TC.region_config_from_block(b)) == \
                _asdict(JC.region_config_from_block(b))


def test_format_table_of_yolo_pose_matches_jax():
    blocks = jzoo_single().blocks
    assert TC.format_cfg_table(blocks) == JC.format_cfg_table(blocks)
    region = [b for b in blocks if b["type"] == "region"][0]
    assert _asdict(TC.region_config_from_block(region)) == \
        _asdict(JC.region_config_from_block(region))


@pytest.mark.parametrize("text", [
    "train = a/train.txt\nvalid=a/test.txt\nbackup=b\nmesh=a/ape.ply\n"
    "tr_range=a/r.txt\nname=ape\ndiam=0.103\ngpus=0,1\nwidth=640\n"
    "height=480\nfx=572.4114\nfy=573.5704\nu0=325.2611\nv0=242.0489\n",
    "# occlusion\nvalid1=x.txt\nmesh1=ape.ply\ndiam1=0.1\nim_width=640\n"
    "im_height=480\nnum_workers=4\n"], ids=["linemod", "occlusion"])
def test_data_config_matches_jax(tmp_path, text):
    path = tmp_path / "obj.data"
    path.write_text(text)
    opts = TC.read_data_cfg(str(path))
    assert opts == JC.read_data_cfg(str(path))
    assert _asdict(TC.data_config_from_options(opts)) == \
        _asdict(JC.data_config_from_options(opts))


# ---------------------------------------------------------------------------
# utils
# ---------------------------------------------------------------------------


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    for n in (9, 700, 1500):                   # across the 512-point blocks
        pts = rng.randn(n, 3) * [0.05, 0.03, 0.04]
        assert TG.calc_pts_diameter(pts) == JG.calc_pts_diameter(pts)
        verts = np.concatenate([pts.T, np.ones((1, n))])
        np.testing.assert_array_equal(TG.get_3D_corners(verts),
                                      JG.get_3D_corners(verts))
    args = rng.uniform(200, 600, 4)
    np.testing.assert_array_equal(TG.get_camera_intrinsic(*args),
                                  JG.get_camera_intrinsic(*args))


def test_meshply_matches_jax(tmp_path):
    rng = np.random.RandomState(1)
    v = rng.randn(7, 3)
    rows = [" ".join(f"{a:.6f}" for a in p) + " 0.1 0.2 0.3 10 20 30"
            for p in v]
    ply = ["ply", "format ascii 1.0", "element vertex 7", "property float x",
           "element face 2", "end_header"] + rows + ["3 0 1 2", "3 2 3 4"]
    path = tmp_path / "obj.ply"
    path.write_text("\n".join(ply) + "\n")
    got, want = TM.MeshPly(str(path)), JM.MeshPly(str(path))
    for field in ("vertices", "normals", "colors", "indices"):
        assert getattr(got, field) == getattr(want, field), field


def test_labels_match_jax(tmp_path):
    rng = np.random.RandomState(2)
    full = tmp_path / "full.txt"
    np.savetxt(full, rng.rand(3, 21))
    empty = tmp_path / "empty.txt"
    empty.write_text("")
    for path in (full, empty):
        np.testing.assert_array_equal(TLb.read_truths(str(path)),
                                      JLb.read_truths(str(path)))
        np.testing.assert_array_equal(TLb.read_truths_args(str(path)),
                                      JLb.read_truths_args(str(path)))
    for p in ("/d/LINEMOD/ape/JPEGImages/000012.jpg", "/x/images/a.png"):
        assert TLb.label_path_from_image(p) == JLb.label_path_from_image(p)
        assert TLb.mask_path_from_image(p) == JLb.mask_path_from_image(p)
    (tmp_path / "sub").mkdir()
    (tmp_path / "sub" / "b.jpg").write_text("")
    assert TLb.get_all_files(str(tmp_path)) == JLb.get_all_files(str(tmp_path))
    assert TLb.num_label_floats(9) == JLb.num_label_floats(9) == 21


# ---------------------------------------------------------------------------
# augment, prefetch
# ---------------------------------------------------------------------------


def _img(seed, h=48, w=64):
    return np.random.RandomState(seed).randint(0, 256, (h, w, 3), np.uint8)


def test_color_functions_match_jax():
    img = _img(3)
    np.testing.assert_array_equal(TA.rgb_to_hsv_u8(img), JA.rgb_to_hsv_u8(img))
    np.testing.assert_array_equal(TA.hsv_to_rgb_u8(img), JA.hsv_to_rgb_u8(img))
    for args in ((0.05, 1.2, 0.8), (-0.1, 0.7, 1.5)):
        np.testing.assert_array_equal(TA.distort_hsv(img, *args),
                                      JA.distort_hsv(img, *args))
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    for _ in range(5):
        assert TA.rand_scale(a, 1.5) == JA.rand_scale(b, 1.5)
    np.testing.assert_array_equal(
        TA.random_distort(a, img, 0.1, 1.5, 1.5),
        JA.random_distort(b, img, 0.1, 1.5, 1.5))


def test_geometry_functions_match_jax():
    img, bg = _img(5), _img(6, 30, 40)
    mask = (np.random.RandomState(7).rand(48, 64) > 0.5).astype(np.uint8) * 255
    np.testing.assert_array_equal(TA.resize_nearest(img, 50, 33),
                                  JA.resize_nearest(img, 50, 33))
    for crop in ((-5, 3, 70, 40), (10, -8, 30, 60)):
        np.testing.assert_array_equal(TA.crop_resize(img, *crop, 32, 32),
                                      JA.crop_resize(img, *crop, 32, 32))
    np.testing.assert_array_equal(TA.change_background(img, mask, bg),
                                  JA.change_background(img, mask, bg))
    a, b = np.random.RandomState(8), np.random.RandomState(8)
    got = TA.data_augmentation(a, img, 64, 64, 0.2, 0.1, 1.5, 1.5)
    want = JA.data_augmentation(b, img, 64, 64, 0.2, 0.1, 1.5, 1.5)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


@pytest.mark.parametrize("recompute", [False, True])
def test_transform_truths_matches_jax(recompute):
    truths = np.random.RandomState(9).rand(3, 21)
    for t in (truths, np.zeros((0,), np.float32)):
        np.testing.assert_array_equal(
            TA.transform_truths(t, 0.1, -0.05, 1.2, 0.9,
                                recompute_extents=recompute),
            JA.transform_truths(t, 0.1, -0.05, 1.2, 0.9,
                                recompute_extents=recompute))


def test_prefetch_matches_jax():
    assert list(TPf.prefetch(range(7), depth=2)) == \
        list(JPf.prefetch(range(7), depth=2))

    def failing():
        yield 1
        raise KeyError("boom")

    it = TPf.prefetch(failing())
    assert next(it) == 1
    with pytest.raises(KeyError, match="boom"):
        next(it)


# ---------------------------------------------------------------------------
# PoseDataset + Loader on the synthetic LINEMOD set
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def linemod(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("host_linemod"))
    lm = make_linemod_fixture(root, ["ape"], n_frames=6, seed=3)
    bg_dir = os.path.join(root, "VOC", "JPEGImages")
    return os.path.join(lm, "ape", "train.txt"), \
        TLb.get_all_files(bg_dir)


def _batches(P, listfile, bgs, *, train, **kw):
    ds = P.PoseDataset(listfile, train=train, bg_file_names=bgs)
    extra = {"backend": "python"} if P is JP else {}
    return list(P.Loader(ds, 2, **kw, **extra))


@pytest.mark.parametrize("out_uint8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("seen", [0, 60], ids=["416", "multi-scale"])
def test_train_batches_equal_jax_python_backend(linemod, out_uint8, seen):
    """Seeded train batches: the schedule's widths (at ``seen`` = 60 the
    2nd stage draws from 416–640), the background swap and the
    augmentation, bit for bit."""
    listfile, bgs = linemod
    kw = dict(train=True, schedule=TP.SINGLE_SCHEDULE, seen=seen, seed=11,
              num_workers=2, out_uint8=out_uint8)
    got = _batches(TP, listfile, bgs, **kw)
    want = _batches(JP, listfile, bgs, **dict(kw, schedule=JP.SINGLE_SCHEDULE))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gi.shape == wi.shape
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    widths = [b[0].shape[1] for b in got]
    if seen:
        assert all(416 <= w <= 640 for w in widths) and set(widths) != {416}
    else:
        assert set(widths) == {416}


@pytest.mark.parametrize("out_uint8", [False, True], ids=["f32", "u8"])
def test_test_batches_equal_jax_python_backend(linemod, out_uint8):
    listfile, _ = linemod
    kw = dict(train=False, shuffle=False, schedule=None,
              fixed_shape=(96, 64), num_workers=0, drop_last=False,
              out_uint8=out_uint8)
    got = _batches(TP, listfile, [], **kw)
    want = _batches(JP, listfile, [], **kw)
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_schedule_matches_jax():
    assert TP.SINGLE_SCHEDULE.stages == JP.SINGLE_SCHEDULE.stages
    assert TP.SINGLE_SCHEDULE.all_widths == JP.SINGLE_SCHEDULE.all_widths
    a, b = np.random.RandomState(12), np.random.RandomState(12)
    for seen in range(0, 2000, 37):
        assert TP.SINGLE_SCHEDULE.draw(a, seen, 5, 8) == \
            JP.SINGLE_SCHEDULE.draw(b, seen, 5, 8)


@pytest.mark.parametrize("option", ["backend", "out_yuv420", "mesh"])
def test_loader_refuses_the_options_it_does_not_take(linemod, option):
    listfile, _ = linemod
    ds = TP.PoseDataset(listfile, train=True)
    with pytest.raises(TypeError):
        TP.Loader(ds, 2, **{option: "python" if option == "backend" else True})
