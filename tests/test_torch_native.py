"""The port's native C++ core (``singleshotpose_tpu_torch/native``) against
the JAX package's (``singleshotpose_tpu/native``).

Both libraries are built here from their own copies of ``ssp_native.cpp``
and run on the same files: decodes, fused train batches, test batches and
yuv420 planes, and the scene synthesizer's pixel core, bit for bit.  Over
them the port's ``Loader(backend="native")`` and ``auto``, its ``device``
backend's and frame bank's decode, and its synthesizer with
``native="auto"`` are held bit for bit, images and labels, to JAX's on the
JPEG frames of ``tests/linemod_fixture.py``, with a background large enough
that the native train path decodes it at a DCT scale: there the native and
the python batches differ, so equality shows that both packages picked the
same backend.  (PIL and this libjpeg decode the frames to the same bytes,
so the ``device`` backends' choice is held by the decoder they bind.)  The
build: into ``_build/`` keyed on a hash, nothing at import,
concurrent builds by renaming, and a failed build's error carried by every
option that needs the library.  Skips where JAX's own native tests skip:
when the JAX package's library does not build.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from singleshotpose_tpu import native as JN
from singleshotpose_tpu.data import pipeline as JP
from singleshotpose_tpu.data import synth_multi as JSM

from singleshotpose_tpu_torch import native as TN
from singleshotpose_tpu_torch.data import augment as TA
from singleshotpose_tpu_torch.data.device_augment import INV255
from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.data import synth_multi as TSM
from singleshotpose_tpu_torch.utils.labels import (get_all_files,
                                                   mask_path_from_image)

import torch_port_helpers  # noqa: F401  (caps torch's threads)
from linemod_fixture import make_linemod_fixture
from test_torch_multi_host import _frame, tree  # noqa: F401  (fixture)

pytestmark = pytest.mark.skipif(not JN.native_available(),
                                reason="native toolchain unavailable")

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def loaders():
    return TN.NativeLoader(nthreads=2), JN.NativeLoader(nthreads=2)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    from PIL import Image
    tmp = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(0)
    Image.fromarray(rng.randint(0, 255, (48, 64, 3), np.uint8)).save(
        tmp / "a.jpg", quality=95)
    Image.fromarray(rng.randint(0, 255, (32, 40, 3), np.uint8)).save(
        tmp / "b.png")
    Image.fromarray(rng.randint(0, 255, (16, 16), np.uint8), "L").save(
        tmp / "g.png")
    return {"jpg": str(tmp / "a.jpg"), "png": str(tmp / "b.png"),
            "gray": str(tmp / "g.png")}


@pytest.fixture(scope="module")
def linemod(tmp_path_factory):
    """Six 640×480 JPEG frames with masks and labels, and two VOC
    backgrounds, the second over twice the frame in both dims, which the
    native train path decodes at a DCT scale where PIL decodes it whole:
    (train list, background files)."""
    from PIL import Image
    root = str(tmp_path_factory.mktemp("native_linemod"))
    lm = make_linemod_fixture(root, ["ape"], n_frames=6, seed=3)
    bg_dir = os.path.join(root, "VOC", "JPEGImages")
    yy, xx = np.mgrid[0:1000, 0:1300]
    big = np.stack([xx % 256, yy % 256, (xx + yy) % 256], -1).astype(np.uint8)
    Image.fromarray(big).save(os.path.join(bg_dir, "bg1.jpg"), quality=90)
    return os.path.join(lm, "ape", "train.txt"), get_all_files(bg_dir)


def _lines(listfile):
    with open(listfile) as f:
        return [ln.strip() for ln in f if ln.strip()]


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------


def test_library_is_built_in_build_dir_keyed_on_source_and_flags():
    path = TN.library_path()
    assert os.path.dirname(path) == os.path.join(
        REPO, "singleshotpose_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libssp_native_")
    assert TN.load_native() is not None and os.path.exists(path)
    assert TN.native_error() is None


def test_nothing_is_built_at_import():
    code = ("import singleshotpose_tpu_torch.native as N, "
            "singleshotpose_tpu_torch.data.pipeline, "
            "singleshotpose_tpu_torch.data.synth_multi, "
            "singleshotpose_tpu_torch.drivers; "
            "print(N._lib is None and N._error is None)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "True"


def test_concurrent_builds_leave_one_whole_library(tmp_path, images):
    """Three processes build into one empty directory at once; each loads a
    whole library and decodes, and only the renamed library is left."""
    build = tmp_path / "_build"
    code = ("import sys, numpy as np, singleshotpose_tpu_torch.native as N; "
            "N.BUILD_DIR = sys.argv[1]; "
            "out = N.NativeLoader(nthreads=1).decode(sys.argv[2]); "
            "print(N.library_path(), int(out.sum()))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(build),
                               images["png"]], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1] for o in outs]
    lines = {o[0].strip().splitlines()[-1] for o in outs}
    assert len(lines) == 1
    (so, total), = (ln.split() for ln in lines)
    assert os.listdir(build) == [os.path.basename(so)]
    assert int(total) == int(JN.NativeLoader().decode(images["png"]).sum())


@pytest.fixture
def broken_build(tmp_path, monkeypatch):
    """The library as it builds where the libjpeg headers are missing: a
    source that includes a header that does not exist, built into an
    empty directory, with the module's load state reset."""
    src = tmp_path / "ssp_native.cpp"
    src.write_text("#include <ssp_missing_header.h>\n")
    monkeypatch.setattr(TN, "_SRC", str(src))
    monkeypatch.setattr(TN, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(TN, "_lib", None)
    monkeypatch.setattr(TN, "_error", None)
    assert TN.load_native() is None
    return TN.native_error()


def test_failed_build_reports_gxx_first_error(broken_build):
    assert broken_build.startswith("g++ failed: ")
    assert "ssp_missing_header.h" in broken_build
    assert "error" in broken_build
    assert not TN.native_available()


@pytest.mark.parametrize("what", ["NativeLoader", "NativeSynthOps",
                                  "backend_native", "out_yuv420",
                                  "synth_native_on"])
def test_options_that_need_the_library_raise_its_error(broken_build,
                                                       linemod, tmp_path,
                                                       what):
    listfile, _ = linemod
    with pytest.raises(RuntimeError, match="ssp_missing_header"):
        if what == "NativeLoader":
            TN.NativeLoader()
        elif what == "NativeSynthOps":
            TN.NativeSynthOps()
        elif what == "backend_native":
            TP.Loader(TP.PoseDataset(listfile, train=True), 2,
                      backend="native")
        elif what == "out_yuv420":
            TP.Loader(TP.PoseDataset(listfile, train=False), 2,
                      fixed_shape=(64, 64), out_yuv420=True)
        else:
            TSM.MultiObjectSynthesizer(TSM.SynthConfig(
                linemod_root=str(tmp_path), native="on"))


def test_auto_gives_way_to_python_and_logs_it(broken_build, linemod,
                                              tmp_path, capsys):
    listfile, bgs = linemod
    ld = TP.Loader(TP.PoseDataset(listfile, train=True, bg_file_names=bgs),
                   2, fixed_shape=(64, 64), num_workers=0, seed=1)
    assert ld.backend == "python"
    assert "auto: python" in capsys.readouterr().out
    got = next(iter(ld))
    want = next(iter(JP.Loader(JP.PoseDataset(listfile, train=True,
                                               bg_file_names=bgs),
                               2, fixed_shape=(64, 64), num_workers=0,
                               seed=1, backend="python")))
    np.testing.assert_array_equal(got[0], want[0])
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(
        linemod_root=str(tmp_path)))
    assert synth._native is None
    dev = TP.Loader(TP.PoseDataset(listfile, train=True), 2,
                    backend="device", device=CPU)
    assert dev._decode is TP.load_image
    assert "decoding with PIL" in capsys.readouterr().out


# ---------------------------------------------------------------------------
# the two libraries on the same files
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["jpg", "png", "gray"])
def test_decode_equals_jax(loaders, images, kind):
    t, j = loaders
    got, want = t.decode(images[kind]), j.decode(images[kind])
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[2] == 3
    np.testing.assert_array_equal(got, want)
    assert t.image_dims(images[kind]) == j.image_dims(images[kind])


def test_decode_missing_file_raises(loaders):
    with pytest.raises(IOError):
        loaders[0].decode("/nonexistent/x.jpg")


def _plans(listfile, bgs, seed):
    """The same draws through both packages' ``plan_train_sample``."""
    out = []
    for P in (TP, JP):
        ds = P.PoseDataset(listfile, train=True, bg_file_names=bgs)
        rng = np.random.RandomState(seed)
        out.append([ds.plan_train_sample(i, rng) for i in range(len(ds))])
    return out


def test_plan_train_sample_equals_jax(linemod):
    listfile, bgs = linemod
    got, want = _plans(listfile, bgs, 4)
    for g, w in zip(got, want):
        assert g[:5] == w[:5]
        np.testing.assert_array_equal(g[5], w[5])
    assert all(p[1] is not None and p[2] is not None for p in got)


@pytest.mark.parametrize("fn", ["train_batch", "train_batch_u8"])
def test_train_batches_equal_jax(loaders, linemod, fn):
    listfile, bgs = linemod
    (plans, _), (t, j) = _plans(listfile, bgs, 6), loaders
    args = ([p[0] for p in plans], [p[1] for p in plans],
            [p[2] for p in plans], np.array([p[3] for p in plans], np.int32),
            np.array([p[4] for p in plans], np.float32), 96, 80)
    got, want = getattr(t, fn)(*args), getattr(j, fn)(*args)
    assert got.shape == (6, 80, 96, 3) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fn", ["test_batch", "test_batch_u8"])
def test_test_batches_equal_jax(loaders, linemod, fn):
    paths, (t, j) = _lines(linemod[0]), loaders
    got, want = getattr(t, fn)(paths, 96, 72), getattr(j, fn)(paths, 96, 72)
    assert got.shape == (6, 72, 96, 3)
    np.testing.assert_array_equal(got, want)


def test_yuv420_planes_equal_jax(loaders, linemod):
    paths, (t, j) = _lines(linemod[0]), loaders
    (gy, gc), (wy, wc) = t.test_batch_yuv420(paths), j.test_batch_yuv420(paths)
    assert gy.shape == (6, 480, 640) and gc.shape == (6, 240, 320, 2)
    np.testing.assert_array_equal(gy, wy)
    np.testing.assert_array_equal(gc, wc)


def test_native_and_python_train_batches_differ_on_the_fixture(linemod):
    """The fixture tells the two train backends apart (the large
    background), so the loaders' equality with JAX below shows that both
    packages picked the same backend.  (PIL and this libjpeg decode the
    fixture's frames to the same bytes, so the ``device`` backend's choice
    is held by the decoder it binds, not by its pixels.)"""
    listfile, bgs = linemod
    kw = dict(fixed_shape=(96, 96), seed=5, num_workers=0)
    batches = [next(iter(TP.Loader(TP.PoseDataset(listfile, train=True,
                                                  bg_file_names=bgs), 6,
                                   backend=b, **kw)))
               for b in ("native", "python")]
    np.testing.assert_array_equal(batches[0][1], batches[1][1])
    assert not np.array_equal(batches[0][0], batches[1][0])


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------


def _both(listfile, bgs, *, train, backend, **kw):
    out = []
    for P in (TP, JP):
        ds = P.PoseDataset(listfile, train=train, bg_file_names=bgs)
        out.append(list(P.Loader(ds, 2, backend=backend, **kw)))
    return out


@pytest.mark.parametrize("backend", ["native", "auto"])
@pytest.mark.parametrize("out_uint8", [False, True], ids=["f32", "u8"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_loader_equals_jax(linemod, backend, out_uint8, train):
    """Seeded batches, train at 96² (the background swap, crop and HSV of
    the fused path) and test mode, images and labels bit for bit."""
    listfile, bgs = linemod
    kw = dict(fixed_shape=(96, 96), seed=5, num_workers=2,
              out_uint8=out_uint8)
    if not train:
        kw.update(shuffle=False, drop_last=False)
    got, want = _both(listfile, bgs, train=train, backend=backend, **kw)
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype == (np.uint8 if out_uint8
                                        else np.float32)
        assert gi.shape == (2, 96, 96, 3)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)


def test_auto_resolves_to_native_and_logs_it(linemod, capsys):
    listfile, _ = linemod
    ld = TP.Loader(TP.PoseDataset(listfile, train=True), 2)
    assert ld.backend == "native"
    assert "Loader backend auto: native" in capsys.readouterr().out


def test_native_multi_scale_train_batches_equal_jax(linemod):
    listfile, bgs = linemod
    kw = dict(schedule=None, seen=60, seed=11, num_workers=2, out_uint8=True)
    got, want = [], []
    for P, out in ((TP, got), (JP, want)):
        ds = P.PoseDataset(listfile, train=True, bg_file_names=bgs)
        out += list(P.Loader(ds, 2, backend="native",
                             **dict(kw, schedule=P.SINGLE_SCHEDULE)))
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert all(416 <= b[0].shape[1] <= 640 for b in got)


def test_yuv420_loader_equals_jax(linemod):
    listfile, _ = linemod
    got, want = _both(listfile, None, train=False, backend="auto",
                      fixed_shape=(96, 96), shuffle=False, drop_last=False,
                      out_uint8=True, out_yuv420=True)
    assert len(got) == len(want) == 3
    for ((gy, gc), gl), ((wy, wc), wl) in zip(got, want):
        assert gy.shape == (2, 480, 640) and gc.shape == (2, 240, 320, 2)
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("case", ["train", "python", "synthesizer"])
def test_loader_refuses_yuv420_where_jax_does(linemod, tmp_path, case):
    listfile, _ = linemod
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(
        linemod_root=str(tmp_path), native="off"))
    ds = TP.PoseDataset(listfile, train=case == "train",
                        synthesizer=synth if case == "synthesizer" else None)
    with pytest.raises(ValueError, match="out_yuv420 is a test-mode"):
        TP.Loader(ds, 2, fixed_shape=(64, 64), out_yuv420=True,
                  backend="python" if case == "python" else "auto")


def test_native_backend_refuses_scene_synthesis(linemod, tmp_path):
    listfile, _ = linemod
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(
        linemod_root=str(tmp_path)))
    ds = TP.PoseDataset(listfile, train=True, synthesizer=synth)
    with pytest.raises(ValueError, match="does not cover the "
                       "scene-synthesis path"):
        TP.Loader(ds, 2, backend="native")
    assert TP.Loader(ds, 2).backend == "python"     # auto


@pytest.mark.parametrize("backend", ["device", "device_bank"])
def test_device_backends_decode_as_jax_on_jpeg(linemod, backend):
    """The ``device`` backend's per-batch decode and the frame bank's build
    decode with the native decoder on both sides: u8 batches and labels
    bit for bit on JPEG frames."""
    listfile, bgs = linemod
    kw = dict(batch_size=2, seed=3, fixed_shape=(64, 64), num_workers=0,
              backend=backend)
    jl = JP.Loader(JP.PoseDataset(listfile, train=True, bg_file_names=bgs),
                   **kw)
    tl = TP.Loader(TP.PoseDataset(listfile, train=True, bg_file_names=bgs),
                   device=CPU, **kw)
    assert tl._decode.__self__.__class__ is TN.NativeLoader
    for (ji, jlab), (ti, tlab) in zip(jl, tl):
        # JAX yields f32 in [0, 1]; the port u8, which the step scales by
        # f32(1/255) (tests/test_torch_device_data.py)
        got = ti.numpy().astype(np.float32) * INV255
        np.testing.assert_array_equal(got, np.asarray(ji))
        tlab = tlab.numpy() if isinstance(tlab, torch.Tensor) else tlab
        np.testing.assert_array_equal(tlab, np.asarray(jlab))


def test_frame_bank_build_decodes_natively(linemod):
    from singleshotpose_tpu.data import device_bank as JDB
    from singleshotpose_tpu_torch.data import device_bank as TDB
    listfile, bgs = linemod
    got = TDB.build_frame_bank(TP.PoseDataset(listfile, train=True,
                                              bg_file_names=bgs),
                               decode=TN.NativeLoader().decode)
    want = JDB.build_frame_bank(JP.PoseDataset(listfile, train=True,
                                               bg_file_names=bgs),
                                decode=JN.NativeLoader().decode)
    np.testing.assert_array_equal(np.asarray(got.images),
                                  np.asarray(want.images))
    np.testing.assert_array_equal(np.asarray(got.bgs), np.asarray(want.bgs))
    np.testing.assert_array_equal(np.asarray(got.masks),
                                  np.asarray(want.masks))


# ---------------------------------------------------------------------------
# the scene synthesizer's pixel core
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_ops():
    return TN.NativeSynthOps(), JN.NativeSynthOps()


def _rand_pair(rng, h=37, w=53):
    img = rng.randint(0, 256, (h, w, 3), np.uint8)
    # hard-binary and grey mask values: the exact f32 blends
    mask = rng.choice([0, 37, 200, 255], (h, w, 3)).astype(np.uint8)
    return img, mask


@pytest.mark.parametrize("pleft,ptop,sw,sh", [
    (0, 0, 53, 37), (-7, -5, 60, 44), (10, 8, 60, 44), (3, 2, 20, 15)])
def test_masked_resize_equals_numpy_and_jax(synth_ops, pleft, ptop, sw, sh):
    rng = np.random.RandomState(0)
    img, mask = _rand_pair(rng)
    total = rng.choice([0, 255], (24, 32, 3)).astype(np.uint8)
    for flip in (False, True):
        for shift in ((0, 0), (5, -3), (-60, 41)):
            sized = [TA.crop_resize(a, pleft, ptop, sw, sh, 32, 24)
                     for a in (img, mask)]
            sized = [np.roll(a, (shift[1], shift[0]), axis=(0, 1))
                     for a in sized]
            if flip:
                sized = [a[:, ::-1] for a in sized]
            kw = dict(shift_x=shift[0], shift_y=shift[1], flip=flip)
            got = synth_ops[0].masked_resize(img, mask, pleft, ptop, sw, sh,
                                             32, 24, **kw)
            np.testing.assert_array_equal(
                got[0], TSM.mask_foreground(sized[0], sized[1]))
            np.testing.assert_array_equal(got[1], sized[1])
            gt = synth_ops[0].masked_resize(img, mask, pleft, ptop, sw, sh,
                                            32, 24, total=total, **kw)
            wt = synth_ops[1].masked_resize(img, mask, pleft, ptop, sw, sh,
                                            32, 24, total=total, **kw)
            for g, w in zip(gt, wt):
                np.testing.assert_array_equal(g, w)
            xx = sized[1].max(-1) > 200
            assert gt[2:] == (int(xx.sum()),
                              int((xx & (total.max(-1) > 200)).sum()))


def test_composite_and_change_background_equal_numpy_and_jax(synth_ops):
    rng = np.random.RandomState(1)
    fg, mask = _rand_pair(rng, 24, 32)
    canvas0 = rng.randint(0, 256, (24, 32, 3), np.uint8)
    total0 = rng.choice([0, 100, 255], (24, 32, 3)).astype(np.uint8)
    bg = rng.randint(0, 256, (17, 29, 3), np.uint8)
    outs = []
    for ops in synth_ops:
        canvas, total = canvas0.copy(), total0.copy()
        ops.composite(fg, mask, canvas, total)
        ops.change_background(canvas, total, bg)
        outs.append((canvas, total))
    want_total = TSM.superimpose_masks(mask, total0)
    want = TA.change_background(TSM.superimpose(fg, mask, canvas0),
                                want_total, bg)
    for canvas, total in outs:
        np.testing.assert_array_equal(total, want_total)
        np.testing.assert_array_equal(canvas, want)


def test_synth_ops_refuse_mismatched_shapes(synth_ops):
    img, mask = _rand_pair(np.random.RandomState(2))
    with pytest.raises(ValueError, match="mask shape"):
        synth_ops[0].masked_resize(img, mask[:-1], 0, 0, 53, 37, 32, 24)
    with pytest.raises(ValueError, match="composite"):
        synth_ops[0].composite(img, mask, img[:-1].copy())


@pytest.mark.parametrize("base,shape,seed", [("eggbox", (416, 416), 4),
                                             ("ape", (352, 352), 5)])
def test_native_scene_equals_jax_and_numpy(tree, tmp_path, base, shape,  # noqa: F811
                                           seed):
    """A synthesized scene with ``native="auto"`` on both sides (the C++
    pixel core) equals JAX's bit for bit, and the port's numpy scene."""
    lm, bgs = tree
    listfile = tmp_path / "train.txt"
    listfile.write_text(_frame(lm, base) + "\n")
    scenes = []
    for P, SM, native in ((TP, TSM, "auto"), (JP, JSM, "auto"),
                          (TP, TSM, "off")):
        synth = SM.MultiObjectSynthesizer(SM.SynthConfig(
            linemod_root=lm, max_attempts=6, native=native))
        assert (synth._native is None) == (native == "off")
        ds = P.PoseDataset(str(listfile), train=True, bg_file_names=bgs,
                           synthesizer=synth)
        scenes.append(synth(ds, _frame(lm, base), shape,
                            np.random.RandomState(seed)))
    (gi, gl) = scenes[0]
    assert gi.shape == shape + (3,) and gi.dtype == np.uint8
    for wi, wl in scenes[1:]:
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    assert int(np.cumprod(gl.reshape(50, 21)[:, 1] != 0).sum()) >= 2


def test_synth_config_native_values(tmp_path):
    assert TSM.SynthConfig(linemod_root="x").native == \
        JSM.SynthConfig(linemod_root="x").native == "auto"
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(
        linemod_root=str(tmp_path), native="on"))
    assert isinstance(synth._native, TN.NativeSynthOps)
    with pytest.raises(ValueError, match="auto, on or off"):
        TSM.MultiObjectSynthesizer(TSM.SynthConfig(
            linemod_root=str(tmp_path), native="yes"))


def test_synth_reads_through_the_dataset_cache(tree, tmp_path):  # noqa: F811
    """As in JAX, scene synthesis reads frames through the dataset's
    decoded-image cache."""
    lm, bgs = tree
    listfile = tmp_path / "train.txt"
    listfile.write_text(_frame(lm, "ape") + "\n")
    synth = TSM.MultiObjectSynthesizer(TSM.SynthConfig(linemod_root=lm,
                                                       max_attempts=2))
    ds = TP.PoseDataset(str(listfile), train=True, synthesizer=synth,
                        cache_decoded=True)
    synth(ds, _frame(lm, "ape"), (96, 96), np.random.RandomState(0))
    assert _frame(lm, "ape") in ds._img_cache
    assert mask_path_from_image(_frame(lm, "ape")) in ds._img_cache


# ---------------------------------------------------------------------------
# the trainer fed by the native loader
# ---------------------------------------------------------------------------


def test_run_training_native_backend_on_cpu(tmp_path, monkeypatch):
    """One epoch of the single trainer with ``loader_backend="native"`` on
    the CPU: the Loader is the native one and the run ends with losses."""
    from PIL import Image
    from singleshotpose_tpu_torch import drivers as TDr
    from test_drivers import TINY_CFG, _make_synthetic_linemod
    datacfg, _ = _make_synthetic_linemod(tmp_path)
    cfg = tmp_path / "tiny.cfg"
    cfg.write_text(TINY_CFG)
    bg_dir = tmp_path / "bg"
    bg_dir.mkdir()
    Image.fromarray(np.random.RandomState(1).randint(
        0, 256, (200, 300, 3), np.uint8)).save(bg_dir / "bg0.jpg")
    seen = []
    real = TP.Loader.__init__

    def spy(self, *a, **k):
        real(self, *a, **k)
        seen.append(self.backend)

    monkeypatch.setattr(TDr.Loader, "__init__", spy)
    rc = TDr.TrainRunConfig(loader_backend="native", num_workers=0,
                            eval_every=100, eval_after=100, log_every=2,
                            max_epochs_override=1, bg_dir=str(bg_dir),
                            compute_dtype=None, device="cpu")
    result = TDr.run_training(datacfg, str(cfg), None, 100, rc)
    assert seen == ["native"]
    losses = result["history"]["training_losses"]
    assert len(losses) == 3 and np.isfinite(losses).all()
