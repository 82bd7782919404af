"""Shared inputs and checks of the bank backends' rows under data
parallelism (``Loader(group=)``), for tests/test_torch_parallel.py (dp=2)
and tests/test_torch_tensor_parallel.py (the 2×2 grid): the corpus's
backgrounds and an OCCLUSION tree beside it, the one-process references
(JAX's ``device_bank`` batches under ``make_mesh(dp=2)`` and alone, the
port's alone; the port's ``device_synth`` batches alone) and the checks of
a rank's rows against them.  The workers' side is
``tests/torch_tp_worker.py``'s ``_bank_rows``.
"""

import os

import numpy as np

from singleshotpose_tpu_torch.data import pipeline as TP
from singleshotpose_tpu_torch.data.synth_multi import (MultiObjectSynthesizer,
                                                       SynthConfig)
from singleshotpose_tpu_torch.zoo import LINEMOD_OBJECTS, occlusion_datacfg

from linemod_fixture import make_linemod_fixture
from torch_port_helpers import TINY_MULTI_CFG

INV255 = np.float32(1) / np.float32(255)


def write_backgrounds(corpus) -> None:
    """Two PNG backgrounds of other sizes than the frames, under
    ``corpus/bg``."""
    from PIL import Image
    (corpus / "bg").mkdir()
    rng = np.random.RandomState(11)
    for k, shape in enumerate(((300, 400, 3), (500, 700, 3))):
        Image.fromarray(rng.randint(0, 256, shape, np.uint8)).save(
            corpus / "bg" / f"bg{k}.png")


def write_occlusion_tree(wd) -> None:
    """A LINEMOD tree for the multi trainer and ``device_synth``: ape's and
    can's frames to train on, ape's OCCLUSION eval (its labels given ape's
    class), a .data per grid run."""
    root = str(wd / "occ")
    lm = make_linemod_fixture(root, ("benchvise", "ape", "can"), n_frames=2,
                              occlusion_objects=("ape",), seed=50)
    lo = os.path.join(lm, "ape", "labels_occlusion")
    for name in os.listdir(lo):
        lab = np.loadtxt(os.path.join(lo, name), ndmin=2)
        lab[:, 0] = LINEMOD_OBJECTS.index("ape")
        np.savetxt(os.path.join(lo, name), lab)
    train = os.path.join(root, "train_occlusion.txt")
    with open(train, "w") as f:
        f.write("\n".join(os.path.join(lm, o, "JPEGImages", f"00{i:04d}.jpg")
                          for o in ("ape", "can") for i in range(2)) + "\n")
    with open(os.path.join(root, "occlusion_2x2.data"), "w") as f:
        f.write(occlusion_datacfg(linemod_root=lm, train_list=train,
                                  backup_root=os.path.join(root, "bk")))
    with open(os.path.join(root, "ape_occlusion.data"), "w") as f:
        f.write(occlusion_datacfg("ape", linemod_root=lm))
    with open(os.path.join(root, "tiny_multi.cfg"), "w") as f:
        f.write(TINY_MULTI_CFG)


def bank_dataset(pkg, wd):
    corpus = wd / "corpus"
    bgs = sorted(str(p) for p in (corpus / "bg").iterdir())
    return pkg.PoseDataset(str(corpus / "train.txt"), train=True,
                           bg_file_names=bgs)


def bank_references(wd):
    """``device_bank``'s batches from the rows test's seed: JAX's under
    ``make_mesh(dp=2)`` (one process: the bank replicated, the rows split
    over ``data``) and alone, in its f32, and the port's alone, u8."""
    import jax
    from singleshotpose_tpu.data import pipeline as JP
    from singleshotpose_tpu.parallel.sharding import make_mesh
    out = {}
    for tag, mesh in (("mesh", make_mesh(jax.devices()[:2], dp=2, mp=1)),
                      ("alone", None)):
        loader = JP.Loader(bank_dataset(JP, wd), 4, seed=3, num_workers=0,
                           backend="device_bank", mesh=mesh)
        out[tag] = [(np.asarray(i), np.asarray(l)) for i, l in loader]
    loader = TP.Loader(bank_dataset(TP, wd), 4, seed=3, num_workers=0,
                       backend="device_bank", device="cpu")
    out["port"] = [(i.numpy(), l.numpy()) for i, l in loader]
    return out


def synth_loader(wd, group=None):
    occ = wd / "occ"
    ds = TP.PoseDataset(
        str(occ / "train_occlusion.txt"), train=True,
        bg_file_names=[str(occ / "VOC" / "JPEGImages" / "bg0.jpg")],
        aug=TP.AugmentConfig.multi(),
        synthesizer=MultiObjectSynthesizer(SynthConfig(
            linemod_root=str(occ / "LINEMOD"))))
    return TP.Loader(ds, 4, seed=5, num_workers=0, fixed_shape=(64, 64),
                     backend="device_synth", device="cpu", synth_attempts=4,
                     group=group)


def synth_reference(wd):
    """The port's ``device_synth`` batches in one process (no group)."""
    return [(i.numpy(), l.numpy()) for i, l in synth_loader(wd)]




def unit(levels: np.ndarray) -> np.ndarray:
    """u8 levels as the train step scales them: times f32(1/255)."""
    return levels.astype(np.float32) * INV255


def check_bank_rows(r: dict, refs: dict, data_rank: int, per: int) -> None:
    """A rank's ``device_bank`` rows (``r["rows/bank/<i>/..."]``, the
    worker's) against :func:`bank_references`: those rows of the
    one-process port batch bit for bit, and of JAX's ``Loader(mesh=)``
    batches bit for bit (labels everywhere, images) except where JAX's
    program disagrees with itself: there JAX's mesh batch equals JAX's
    batch alone, the port's one-process batch is one level off both, and
    the port's value is what JAX's program computes for that pixel
    compiled at another shape (a 1×1 frame: XLA contracts the HSV chain's
    products by shape).  So the rows differ from JAX's exactly where the
    one-process port batch does — the split adds no difference — by one
    level, at most 2 of ~10⁶ values a batch on this corpus.  ``seen``
    counts the global samples."""
    rows = slice(data_rank * per, (data_rank + 1) * per)
    assert len(refs["mesh"]) == 2
    for i, ((jimg, jlab), (aimg, _), (pimg, plab)) in enumerate(
            zip(refs["mesh"], refs["alone"], refs["port"])):
        got = r[f"rows/bank/{i}/images"]
        assert got.dtype == np.uint8 and got.shape == pimg[rows].shape
        assert got.tobytes() == pimg[rows].tobytes()
        assert r[f"rows/bank/{i}/labels"].tobytes() == plab[rows].tobytes()
        np.testing.assert_array_equal(r[f"rows/bank/{i}/labels"], jlab[rows])
        np.testing.assert_array_equal(jimg, aimg)
        off = unit(got) != jimg[rows]
        np.testing.assert_array_equal(off, unit(pimg[rows]) != aimg[rows])
        assert off.sum() <= 2, off.sum()
        np.testing.assert_allclose(unit(got), jimg[rows], rtol=0,
                                   atol=1.01 / 255)
    assert int(r["rows/bank/seen"]) == 8


def check_synth_rows(r: dict, batches, data_rank: int, per: int) -> None:
    """A rank's ``device_synth`` rows against :func:`synth_reference`'s
    batches: those rows, bit for bit, images and labels."""
    rows = slice(data_rank * per, (data_rank + 1) * per)
    assert len(batches) == 1
    for i, (images, labels) in enumerate(batches):
        assert r[f"rows/synth/{i}/images"].tobytes() == \
            images[rows].tobytes()
        assert r[f"rows/synth/{i}/labels"].tobytes() == \
            labels[rows].tobytes()
