"""The port's shaded renderer (``singleshotpose_tpu_torch/data/shaded.py``)
against the JAX package's, and ``scripts/shaded_accuracy.py`` at a tiny size
on the CPU.

Renders, labels and poses are held bit for bit at fixed seeds; the files of
``make_shaded_linemod`` byte for byte (the ``.data`` file after its root
path).  The script runs the full ``yolo_pose_single`` at 64², batch 2: with
Pillow through JPEG files, and without it from the in-memory renders; its
result must carry finite metrics over the held-out frames.
"""

import importlib.util
import json
import os

import numpy as np
import pytest

from singleshotpose_tpu.data import shaded as JS

from singleshotpose_tpu_torch.data import shaded as TS

import torch_port_helpers  # noqa: F401  (caps torch's threads)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "shaded_accuracy", os.path.join(REPO, "scripts", "shaded_accuracy.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_match_jax():
    np.testing.assert_array_equal(TS.PTS, JS.PTS)
    np.testing.assert_array_equal(TS.K, JS.K)
    assert TS.BOX_HALF_EXTENTS == JS.BOX_HALF_EXTENTS
    ext = (0.03, 0.05, 0.02)
    np.testing.assert_array_equal(TS.box_points(ext), JS.box_points(ext))


@pytest.mark.parametrize("seed,kw", [
    (0, {}), (1, dict(bg_level=None, n_splats=2200)),
    (2, dict(ext=(0.03, 0.05, 0.02), cls=3, splat=4))])
def test_render_frame_matches_jax(seed, kw):
    colors = np.random.RandomState(seed).randint(60, 255, (6, 3))
    trng, jrng = np.random.RandomState(seed), np.random.RandomState(seed)
    for _ in range(2):                    # the stream carries on
        got = TS.render_frame(trng, colors, **kw)
        want = JS.render_frame(jrng, colors, **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert got[1].any() and got[2][1] != 0


@pytest.mark.parametrize("classes", [[0], [2, 0, 5]])
def test_render_scene_multi_matches_jax(classes):
    rng = np.random.RandomState(7)
    palettes = rng.randint(60, 255, (6, 6, 3)).astype(np.uint8)
    extents = rng.uniform(0.02, 0.06, (6, 3)).astype(np.float32)
    gimg, ggts = TS.render_scene_multi(np.random.RandomState(3), palettes,
                                       extents, classes, n_splats=600)
    wimg, wgts = JS.render_scene_multi(np.random.RandomState(3), palettes,
                                       extents, classes, n_splats=600)
    np.testing.assert_array_equal(gimg, wimg)
    assert len(ggts) == len(wgts) == len(classes)
    for (gc, gl, gp), (wc, wl, wp) in zip(ggts, wgts):
        assert gc == wc
        np.testing.assert_array_equal(gl, wl)
        np.testing.assert_array_equal(gp, wp)


def test_make_shaded_linemod_matches_jax(tmp_path):
    got = TS.make_shaded_linemod(str(tmp_path / "t"), n_train=2, n_test=1,
                                 seed=4, n_splats=300)
    want = JS.make_shaded_linemod(str(tmp_path / "j"), n_train=2, n_test=1,
                                  seed=4, n_splats=300)
    assert open(got).read() == open(want).read().replace(
        str(tmp_path / "j"), str(tmp_path / "t"))
    files = []
    for dirpath, _, names in os.walk(tmp_path / "t"):
        files += [os.path.join(dirpath, n) for n in names]
    assert len(files) == 2 + 1 + 1 + 3 * 3          # lists, ply, .data, 3×3
    for path in files:
        if path != got:
            other = path.replace(str(tmp_path / "t"), str(tmp_path / "j"))
            data = open(path, "rb").read()
            if path.endswith(".txt") and "labels" not in path:
                data = data.replace(str(tmp_path / "t").encode(),
                                    str(tmp_path / "j").encode())
            assert data == open(other, "rb").read(), path


def _check_result(result, n_eval, epochs):
    assert result["eval_n"] == n_eval and len(result["epoch_losses"]) == epochs
    assert np.isfinite(result["epoch_losses"]).all()
    for k in ("acc_2d_5px", "acc_add_0.1d", "acc_5cm5deg", "mean_px_err"):
        assert np.isfinite(result[k]), k
    assert result["stem"] == "unfused (off the card)"


def test_shaded_accuracy_script_on_cpu(tmp_path, capsys):
    out = tmp_path / "result.json"
    assert _script().main(["--n_train", "4", "--n_eval", "2", "--epochs",
                           "4", "--batch", "2", "--size", "64", "--device",
                           "cpu", "--out", str(out)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    result = json.loads(lines[-1])
    assert json.loads(out.read_text()) == result
    _check_result(result, 2, 4)
    assert result["jpeg_round_trip"] is True
    assert sum("mean loss" in ln for ln in lines) == 4
    assert any("JPEG round trip (quality 92) done" in ln for ln in lines)


def test_shaded_accuracy_script_without_pillow(monkeypatch, capsys):
    """No Pillow: no image file is written, the loader's decoder reads the
    renders in memory, and the result says the JPEG round trip was
    skipped."""
    script = _script()
    monkeypatch.setitem(__import__("sys").modules, "PIL", None)
    result = script.run(n_train=2, n_eval=2, epochs=1, batch=2, size=64,
                        device="cpu")
    _check_result(result, 2, 1)
    assert result["jpeg_round_trip"] is False
    assert "JPEG round trip SKIPPED" in capsys.readouterr().out
