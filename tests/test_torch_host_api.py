"""The port's host API against the JAX package's, on the CPU: the rest of the
numpy utilities (singleshotpose_tpu_torch/utils), ``make_labels`` and
``cli make-labels``, ``config.print_cfg`` and ``cli print-cfg``, the public
names ``RegionLossConfig.single``/``.multi``, ``zoo.linemod_datacfg``,
``evaluate.box3d_iou`` and ``weights.save_weights(header=, cutoff=)``, and
the lazy top-level API.

Every comparison is exact: the same numpy inputs, made from a seed, give
the same f64 rows, the same bytes in the files, the same stdout, the same
config fields and the same floats.  ``make_labels``' inputs are valid ones
only (its copy keeps the JAX file's behaviour, faults included).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from singleshotpose_tpu import cli as JCLI
from singleshotpose_tpu import evaluate as JE
from singleshotpose_tpu import make_labels as JML
from singleshotpose_tpu import weights as JW
from singleshotpose_tpu import zoo as JZ
from singleshotpose_tpu.models.darknet import DarknetSpec as JSpec
from singleshotpose_tpu.ops import losses as JLo
from singleshotpose_tpu.utils import geometry as JG
from singleshotpose_tpu.utils import labels as JLb
from singleshotpose_tpu.utils import meshply as JM

import singleshotpose_tpu_torch as TPKG
from singleshotpose_tpu_torch import evaluate as TE
from singleshotpose_tpu_torch import make_labels as TML
from singleshotpose_tpu_torch import weights as TW
from singleshotpose_tpu_torch import zoo as TZ
from singleshotpose_tpu_torch.cli import main as tcli
from singleshotpose_tpu_torch.models.darknet import DarknetSpec as TSpec
from singleshotpose_tpu_torch.ops import losses as TLo
from singleshotpose_tpu_torch.utils import geometry as TG
from singleshotpose_tpu_torch.utils import labels as TLb
from singleshotpose_tpu_torch.utils import meshply as TM

from torch_port_helpers import TINY_BLOCKS, _cfg_text, jax_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K = np.array([[572.4114, 0, 325.2611], [0, 573.5704, 242.0489], [0, 0, 1]])
W, H = 640, 480


def _rotations(n, rng):
    """``n`` random rotations (Rodrigues' formula on random axes)."""
    out = []
    for _ in range(n):
        w = rng.randn(3)
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]],
                       [-w[1], w[0], 0]]) / th
        out.append(np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx)
    return np.array(out)


def _poses(n, seed):
    rng = np.random.RandomState(seed)
    R = _rotations(n, rng)
    t = np.stack([rng.uniform(-.05, .05, n), rng.uniform(-.04, .04, n),
                  rng.uniform(.6, 1.2, n)], axis=1)
    return R, t


def _vertices(seed=0, n=40):
    """A mesh's (n, 3) vertices, meters."""
    return np.random.RandomState(seed).uniform(-.05, .05, (n, 3))


def _write_ply(path, v):
    ply = ["ply", "format ascii 1.0", f"element vertex {len(v)}",
           "property float x", "property float y", "property float z",
           "element face 0", "property list uchar int vertex_indices",
           "end_header"] + [f"{float(a)!r} {float(b)!r} {float(c)!r}"
                           for a, b, c in v]
    path.write_text("\n".join(ply) + "\n")


# ---------------------------------------------------------------------------
# the utilities
# ---------------------------------------------------------------------------


def _util_cases():
    rng = np.random.RandomState(7)
    pts = np.vstack([rng.uniform(-.1, .1, (3, 30)), np.ones((1, 30))])
    Rt = np.concatenate([_rotations(1, rng)[0], [[.01], [-.02], [.8]]], 1)
    Rt2 = np.concatenate([_rotations(1, rng)[0], [[.02], [.01], [.7]]], 1)
    R3, R4 = _rotations(4, rng).reshape(2, 2, 3, 3)
    pix = rng.uniform(0, 640, (2, 9))
    box = list(rng.uniform(0, 1, 18))
    boxes = [list(rng.uniform(0, 1, 7)) for _ in range(3)]
    return {
        "compute_projection": ((pts, Rt, K), {}),
        "compute_transformation": ((pts, Rt), {}),
        "calc_angular_distance": ((Rt[:, :3], Rt2[:, :3]), {}),
        "calc_angular_distance_batched": ((R3, R4), {}),
        "calc_angular_distance_same": ((Rt[:, :3], Rt[:, :3]), {}),
        "add_error": ((pts, Rt, Rt2), {}),
        "compute_2d_bb": ((pix,), {}),
        "compute_2d_bb_from_orig_pix": ((pix, 13), {}),
        "get_2d_bb": ((box, 416), {}),
        "scale_bboxes": ((boxes, 640, 480), {}),
    }


@pytest.mark.parametrize("case", sorted(_util_cases()))
def test_geometry_copies_match_jax(case):
    args, kw = _util_cases()[case]
    name = case.replace("_batched", "").replace("_same", "")
    got = getattr(TG, name)(*args, **kw)
    want = getattr(JG, name)(*args, **kw)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    if name == "scale_bboxes":            # the input is not mutated
        assert args[0] == _util_cases()[case][0][0]


@pytest.mark.parametrize("which", ["rows", "one_row", "empty"])
def test_read_pose_matches_jax(tmp_path, which):
    rng = np.random.RandomState(3)
    path = tmp_path / "pose.txt"
    if which == "empty":
        path.write_text("")
    else:
        np.savetxt(path, rng.rand(3 if which == "rows" else 1, 21))
    got, want = TLb.read_pose(str(path)), JLb.read_pose(str(path))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_gt,K_", [(1, 9), (3, 9), (60, 9), (0, 9),
                                     (2, 4)])
def test_pack_test_labels_matches_jax(n_gt, K_):
    t = np.random.RandomState(n_gt).rand(n_gt * (2 * K_ + 1))
    got = TLb.pack_test_labels(t, K_)
    want = JLb.pack_test_labels(t, K_)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_file_helpers_match_jax(tmp_path):
    lines = tmp_path / "list.txt"
    lines.write_text("a\nb\n\nc")
    names = tmp_path / "names.txt"
    names.write_text("ape  \ncan\n\ncat\n")
    assert TLb.file_lines(str(lines)) == JLb.file_lines(str(lines)) == 3
    assert TLb.load_class_names(str(names)) == \
        JLb.load_class_names(str(names))
    from PIL import Image
    img = tmp_path / "frame.jpg"
    Image.fromarray(np.zeros((48, 64, 3), np.uint8)).save(img)
    assert TLb.get_image_size(str(img)) == JLb.get_image_size(str(img)) \
        == (64, 48)


def test_mesh_arrays_match_jax(tmp_path):
    path = tmp_path / "obj.ply"
    _write_ply(path, _vertices(4))
    tm, jm = TM.MeshPly(str(path)), JM.MeshPly(str(path))
    for f in ("vertices_array", "homogeneous_vertices"):
        got, want = getattr(tm, f)(), getattr(jm, f)()
        assert got.dtype == want.dtype == np.float64
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# make_labels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("intrinsics", ["shared", "per_frame"])
@pytest.mark.parametrize("layout", ["n3", "3n"])
def test_label_rows_match_jax_bit_for_bit(intrinsics, layout):
    v = _vertices(1)
    R, t = _poses(6, seed=2)
    Ks = K if intrinsics == "shared" else \
        K[None] * np.random.RandomState(5).uniform(0.9, 1.1, (6, 1, 1))
    if intrinsics == "per_frame":
        Ks[:, 2] = [0, 0, 1]
    if layout == "3n":
        v = v.T
    got = TML.label_rows_for_poses(v, R, t, Ks, W, H, class_id=3)
    want = JML.label_rows_for_poses(v, R, t, Ks, W, H, class_id=3)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("names", [None, ["0001", "0002.jpg", "frame_3"]])
def test_label_files_match_jax_byte_for_byte(tmp_path, names):
    R, t = _poses(3, seed=3)
    rows = JML.label_rows_for_poses(_vertices(2), R, t, K, W, H)
    got = TML.write_label_files(rows, str(tmp_path / "t"), names)
    want = JML.write_label_files(rows, str(tmp_path / "j"), names)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want]
    for a, b in zip(got, want):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()


def _tree(root):
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("extra", [[], ["--class_id", "4", "--width", "320",
                                        "--height", "240"]],
                         ids=["npz_sizes", "flags"])
def test_cli_make_labels_writes_jax_tree(tmp_path, capsys, extra):
    mesh = tmp_path / "obj.ply"
    _write_ply(mesh, _vertices(3))
    R, t = _poses(4, seed=4)
    poses = tmp_path / "poses.npz"
    np.savez(poses, R=R, t=t, K=K, width=W, height=H,
             names=np.array(["0001", "0002.jpg", "0003", "x4"]))
    args = ["make-labels", "--mesh", str(mesh), "--poses", str(poses)]
    assert tcli(args + ["--out", str(tmp_path / "t")] + extra) == 0
    t_out = capsys.readouterr().out
    assert JCLI.main(args + ["--out", str(tmp_path / "j")] + extra) == 0
    j_out = capsys.readouterr().out
    assert t_out.replace(str(tmp_path / "t"), "OUT") == \
        j_out.replace(str(tmp_path / "j"), "OUT")
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert sorted(_tree(tmp_path / "t")) == ["0001.txt", "0002.txt",
                                              "0003.txt", "x4.txt"]


def test_cli_make_labels_missing_array(tmp_path):
    mesh = tmp_path / "obj.ply"
    _write_ply(mesh, _vertices(3))
    poses = tmp_path / "poses.npz"
    np.savez(poses, R=np.eye(3)[None], K=K)
    args = ["make-labels", "--mesh", str(mesh), "--poses", str(poses),
            "--out", str(tmp_path / "o")]
    with pytest.raises(SystemExit) as te:
        tcli(args)
    with pytest.raises(SystemExit) as je:
        JCLI.main(args)
    assert str(te.value) == str(je.value) == "--poses is missing array 't'"


# ---------------------------------------------------------------------------
# print-cfg
# ---------------------------------------------------------------------------


_ZOO = {"single": JZ.yolo_pose_single, "multi": JZ.yolo_pose_multi,
        "pretrain": JZ.yolo_pose_pretrain}


@pytest.mark.parametrize("net", sorted(_ZOO) + ["tiny"])
def test_cli_print_cfg_prints_jax_stdout(tmp_path, capsys, net):
    blocks = TINY_BLOCKS if net == "tiny" else _ZOO[net]().blocks
    path = tmp_path / f"{net}.cfg"
    path.write_text(_cfg_text(blocks))
    assert tcli(["print-cfg", str(path)]) == 0
    got = capsys.readouterr()
    assert JCLI.main(["print-cfg", str(path)]) == 0
    want = capsys.readouterr()
    assert got.out == want.out and got.err == want.err == ""
    assert got.out.count("\n") == len(blocks)       # the header + a row each


def test_cli_print_cfg_usage(capsys):
    assert tcli(["print-cfg"]) == 2
    got = capsys.readouterr()
    assert JCLI.main(["print-cfg"]) == 2
    assert got == capsys.readouterr()


# ---------------------------------------------------------------------------
# the public names
# ---------------------------------------------------------------------------


def _fields(cfg):
    d = dataclasses.asdict(cfg)
    d.pop("use_pallas", None)
    d.pop("mesh", None)
    return d


@pytest.mark.parametrize("kw", [{}, {"pretrain_num_epochs": 3},
                                {"object_scale": 2.5, "sil_thresh": 0.4}])
def test_region_loss_config_single_matches_jax(kw):
    assert _fields(TLo.RegionLossConfig.single(**kw)) == \
        _fields(JLo.RegionLossConfig.single(**kw))


@pytest.mark.parametrize("kw", [{}, {"num_classes": 4, "num_anchors": 2},
                                {"pretrain_num_epochs": 0,
                                 "class_scale": 2.0}])
def test_region_loss_config_multi_matches_jax(kw):
    got = TLo.RegionLossConfig.multi(TZ.MULTI_ANCHORS, **kw)
    want = JLo.RegionLossConfig.multi(JZ.MULTI_ANCHORS, **kw)
    assert _fields(got) == _fields(want)
    assert got.with_class_loss


@pytest.mark.parametrize("obj", sorted(JZ.LINEMOD_DIAMETERS))
def test_linemod_datacfg_matches_jax(obj):
    assert TZ.linemod_datacfg(obj) == JZ.linemod_datacfg(obj)
    assert TZ.linemod_datacfg(obj, "/data/LM", "bk") == \
        JZ.linemod_datacfg(obj, "/data/LM", "bk")


def test_linemod_datacfg_refuses_unknown():
    with pytest.raises(ValueError) as te:
        TZ.linemod_datacfg("teapot")
    with pytest.raises(ValueError) as je:
        JZ.linemod_datacfg("teapot")
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("case", ["near", "far", "same", "grid8"])
def test_box3d_iou_matches_jax(case):
    rng = np.random.RandomState({"near": 1, "far": 2, "same": 3,
                                 "grid8": 4}[case])
    ext = rng.uniform(.02, .06, 3)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)]) * ext
    R, t = _poses(2, seed=int(rng.randint(100)))
    gt = np.concatenate([R[0], t[0][:, None]], 1)
    if case == "same":
        pr = gt.copy()
    elif case == "far":
        pr = np.concatenate([R[1], t[1][:, None]], 1)
    else:
        dR = _rotations(1, rng)[0]
        dR = np.eye(3) + 0.05 * (dR - np.eye(3))
        pr = np.concatenate([dR @ R[0], (t[0] + rng.uniform(-.01, .01, 3))
                             [:, None]], 1)
    kw = {"grid": 8} if case == "grid8" else {}
    got = TE.box3d_iou(gt, pr, corners, **kw)
    want = JE.box3d_iou(gt, pr, corners, **kw)
    assert got == want
    assert 0.0 <= got <= 1.0
    if case == "same":
        assert got == 1.0


@pytest.mark.parametrize("header,cutoff", [
    (None, 0), ([1, 2, 3, 0], 0), ([0, 2, 0, 0], 3), (None, 5),
    (None, len(TINY_BLOCKS) - 1)])
def test_save_weights_header_and_cutoff_match_jax(tmp_path, header, cutoff):
    jspec, tspec = JSpec(TINY_BLOCKS), TSpec(TINY_BLOCKS)
    params, stats = jax_params(jspec, seed=9)
    state = TW.params_from_jax(tspec, params, stats)
    th = None if header is None else TW.WeightsHeader(np.array(header))
    jh = None if header is None else JW.WeightsHeader(np.array(header))
    TW.save_weights(tspec, state, str(tmp_path / "t.weights"), seen=77,
                    header=th, cutoff=cutoff)
    JW.save_weights(jspec, params, stats, str(tmp_path / "j.weights"),
                    seen=77, header=jh, cutoff=cutoff)
    got = (tmp_path / "t.weights").read_bytes()
    assert got == (tmp_path / "j.weights").read_bytes()
    if header is not None:             # the caller's header is not touched
        assert list(th.values) == header
    full = tmp_path / "full.weights"
    TW.save_weights(tspec, state, str(full), seen=77)
    assert (len(got) < full.stat().st_size) == \
        (0 < cutoff < len(tspec.layers))


# ---------------------------------------------------------------------------
# the lazy top-level API
# ---------------------------------------------------------------------------


def test_lazy_api_names_follow_jax():
    import singleshotpose_tpu as J
    want = set(J._LAZY) - {"make_mesh"} | {"make_dp_group"}
    assert set(TPKG._LAZY) == want and len(TPKG._LAZY) == 32
    assert TPKG.__all__ == ["config", "__version__"] + sorted(TPKG._LAZY)
    with pytest.raises(AttributeError, match="make_mesh"):
        TPKG.make_mesh


@pytest.mark.parametrize("name", sorted(TPKG._LAZY))
def test_lazy_api_name_resolves(name):
    module, attr = TPKG._LAZY[name]
    import importlib
    assert getattr(TPKG, name) is getattr(importlib.import_module(module),
                                          attr)


_LAZY_IMPORT = r"""
import sys
sys.modules["jax"] = None
sys.modules["singleshotpose_tpu"] = None
import singleshotpose_tpu_torch as T
loaded = sorted(m for m in sys.modules if m.startswith("singleshotpose_tpu_torch"))
assert loaded == ["singleshotpose_tpu_torch", "singleshotpose_tpu_torch.config"], loaded
assert "torch" not in sys.modules
T.aot_serving                       # one of the four names it exported eagerly
for m in ("serving", "drivers", "training"):
    assert ("singleshotpose_tpu_torch." + m in sys.modules) == (m == "serving"), m
print("ok")
"""


def test_import_is_lazy_in_a_subprocess():
    r = subprocess.run([sys.executable, "-c", _LAZY_IMPORT], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


_NO_JAX_HOST = r"""
import os, sys
sys.modules["jax"] = None
sys.modules["singleshotpose_tpu"] = None
import numpy as np
from singleshotpose_tpu_torch import evaluate, make_labels, training, weights, zoo
from singleshotpose_tpu_torch.cli import main
from singleshotpose_tpu_torch.ops.losses import RegionLossConfig
from singleshotpose_tpu_torch.utils import geometry, labels, meshply
root = sys.argv[1]
v = np.random.RandomState(0).uniform(-.05, .05, (20, 3))
with open(os.path.join(root, "m.ply"), "w") as f:
    f.write("\n".join(["ply", "format ascii 1.0", f"element vertex {len(v)}",
                       "property float x", "property float y",
                       "property float z", "element face 0",
                       "property list uchar int vertex_indices",
                       "end_header"]
                      + [" ".join(repr(float(x)) for x in r) for r in v]) + "\n")
K = np.array([[572.4114, 0, 325.2611], [0, 573.5704, 242.0489], [0, 0, 1]])
np.savez(os.path.join(root, "p.npz"), R=np.eye(3)[None].repeat(2, 0),
         t=np.array([[0, 0, .7], [.01, 0, .8]]), K=K)
assert main(["make-labels", "--mesh", os.path.join(root, "m.ply"), "--poses",
             os.path.join(root, "p.npz"), "--out",
             os.path.join(root, "labels")]) == 0
assert sorted(os.listdir(os.path.join(root, "labels"))) == ["000000.txt", "000001.txt"]
with open(os.path.join(root, "tiny.cfg"), "w") as f:
    f.write(sys.argv[2])
assert main(["print-cfg", os.path.join(root, "tiny.cfg")]) == 0
assert RegionLossConfig.single().object_scale == 5.0
assert "diam = 0.103" in zoo.linemod_datacfg("ape")
"""


def test_new_modules_run_without_jax(tmp_path):
    from torch_port_helpers import TINY_CFG
    r = subprocess.run([sys.executable, "-c", _NO_JAX_HOST, str(tmp_path),
                        TINY_CFG], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr
    assert "wrote 2 label files" in r.stdout and "layer" in r.stdout
