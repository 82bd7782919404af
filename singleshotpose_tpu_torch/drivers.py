"""Drivers: the reference's ``valid.py``/``train.py`` for a single object and
``valid_multi.py``/``train_multi.py`` for OCCLUSION.

Mirrors ``run_validation``, ``run_validation_multi``,
``run_validation_multi_sweep``, ``run_training`` and ``run_training_multi``
of ``singleshotpose_tpu/drivers.py``.

Validation: on the ``rgb`` transfer the host ``PoseDataset``/``Loader``
feed u8 batches (single object at the spec's test size, multi object at its
train size; decoded by the native decoder when its library builds, else by
PIL: the ``Loader``'s ``auto``); on the ``yuv420`` transfer the native
decoder's native-size YUV 4:2:0 planes, converted and resized on the device
(``ops/yuv.py``); on the ``bank`` transfer the split is decoded once into a
device-resident eval bank (``data/eval_bank.py``, LRU-cached across calls)
with the ``rgb`` transfer's pixels.  The serving function (fold → bf16 forward → decode →
box pick: the best box, or one box per class; with ``quantize`` the int8
forward of ``models/quantize.py``, calibrated on the first batch or loaded
from an ``.npz``) runs on the device, and the boxes of all batches meet the
ground truth in one batched PnP + metric pass (ADD-S with ``add_s``;
per-frame dumps with ``save``).

Training: the ``Loader`` (multi-scale, u8; ``loader_backend`` ``native``:
the C++ fused decode and augment; ``python``: host decode and augment with
PIL and numpy, for OCCLUSION over scenes from the multi-object synthesizer;
``auto``: ``native`` when its library builds, else ``python``, and
``python`` for OCCLUSION; ``device``: augment on the card; ``device_bank``:
the train split in device memory; for OCCLUSION ``device_synth``: the corpus in device
memory, f32 scenes synthesized on the card) feeds the train step — host batches through pinned
memory, device batches as they are — eager, or with ``precompile_buckets``
on a card replayed from one CUDA graph per multi-scale bucket; the
in-training eval takes the eval bank when it fits the card's free memory
(``eval_transfer="auto"``); the reference's behaviours are kept —
the step LR schedule in batches, the pretrain confidence gate, an eval every
``eval_every`` epochs after ``eval_after``, the best accuracy saved as
darknet ``model.weights``, ``costs.npz`` curves — and full-state
checkpoints (``checkpoint.py``) give a real resume; ``profile_dir`` writes a
``torch.profiler`` trace of a window of steps.
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from . import weights as W
from .checkpoint import Checkpointer
from .config import (DataConfig, data_config_from_options, occlusion_sweep,
                     read_data_cfg)
from .data.pipeline import (MULTI_SCHEDULE, SINGLE_SCHEDULE, AugmentConfig,
                            Loader, PoseDataset)
from .data import eval_bank
from .data.prefetch import prefetch
from .data.synth_multi import MultiObjectSynthesizer, SynthConfig
from .evaluate import (EvalContext, PoseErrors, accuracy_summary,
                       multi_accuracy_table, pose_metrics)
from .models.darknet import (Darknet, DarknetSpec, fold_batchnorm,
                             gather_folded, shard_folded)
from .models.quantize import (calibrate_activations, load_quantized,
                              quantize_folded)
from .ops.losses import RegionLossConfig
from .parallel.multihost import process_local_indices
from .parallel.sharding import DPGroup, all_gather_rows, pad_rows
from .serving import make_serving_fn
from .tracing import span
from .training import (TrainState, capture_train_step, gather_model_whole,
                       init_train_state, make_train_step, schedule_lr,
                       shard_train_state)
from .utils.memory import hbm_free_bytes
from .utils.labels import get_all_files
from .zoo import _resolve_model

__all__ = ["run_validation", "run_validation_multi",
           "run_validation_multi_sweep", "run_training", "run_training_multi",
           "TrainRunConfig", "load_spec", "loss_config_from_spec",
           "OCCLUSION_EVAL_OBJECTS"]


def _log(msg: str) -> None:
    """A timestamped line; under data parallelism every rank's line carries
    its rank, and goes out in one write, so the ranks' lines do not mix on
    a shared stdout."""
    rank = ""
    if dist.is_initialized() and dist.get_world_size() > 1:
        rank = f" [rank {dist.get_rank()}/{dist.get_world_size()}]"
    sys.stdout.write(f"{time.strftime('%Y-%m-%d %H:%M:%S')}{rank} {msg}\n")
    sys.stdout.flush()


def _is_writer(group: Optional[DPGroup]) -> bool:
    """Whether this process writes the run's files: rank 0 of a
    data-parallel group (the ranks hold the same bytes) — on a data ×
    model grid the rank at data and model coordinate 0 —, or the one
    process."""
    return group is None or group.leader


def _resolve_device(device) -> torch.device:
    """``device`` as given; a CUDA device that is absent raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _load_model(spec: DarknetSpec, weightfile: Optional[str],
                device: torch.device) -> Darknet:
    if weightfile is None:
        raise ValueError("a validation needs a weightfile or a model")
    model = Darknet(spec, device=device)
    model.load_state_dict(W.load_weights(spec, weightfile)[1])
    return model


def _eval_params(spec: DarknetSpec, model: Optional[Darknet], loader, *,
                 compute_dtype, device, quantize: Union[bool, str],
                 transfer: str = "rgb", group: Optional[DPGroup] = None):
    """The serving params of an eval pass and the batches to run them on
    (``singleshotpose_tpu/drivers.py:172-210``): the folded weights; with
    ``quantize="<path>.npz"`` the int8 artifact of ``cli quantize`` /
    ``save_quantized`` (no float weights needed); with ``quantize=True``
    the model quantized with per-channel activation scales calibrated on
    the loader's first batch, which is chained back in front, so it is
    decoded once.  Calibration takes eval-size frames: ``quantize=True``
    refuses the ``yuv420`` transfer, as JAX's does; an ``.npz`` composes
    with any transfer.

    On a data × model grid (``group.mp > 1``) the folded weights are this
    rank's split convs (JAX's ``folded_param_shardings``: the fold of a
    split model, or the split of a whole model's fold), and the int8
    pytree is whole on every rank (JAX replicates it)."""
    if isinstance(quantize, str):
        return load_quantized(quantize, device=device), loader
    mp = 1 if group is None else group.mp
    if model.model_shards not in (1, mp):
        raise ValueError(f"the model is split over {model.model_shards} "
                         f"model ranks, the eval's group over mp={mp}")
    folded = fold_batchnorm(model)
    if mp > 1 and quantize and model.model_shards > 1:
        folded = gather_folded(spec, folded, group)
    elif mp > 1 and not quantize and model.model_shards == 1:
        folded = shard_folded(spec, folded, group)
    if not quantize:
        return folded, loader
    if transfer == "yuv420":
        raise ValueError(
            "quantize=True requires transfer='rgb' (calibration runs on "
            "eval-size RGB batches); pre-quantized quantize='<path>.npz' "
            "composes with any transfer")
    it = iter(loader)
    first = next(it, None)
    if first is None:
        raise ValueError("quantize=True needs a non-empty loader for "
                         "calibration")
    calib = torch.as_tensor(first[0]).to(device)
    if not calib.is_floating_point():
        # JAX divides eagerly here (not the compiled serve's 1/255 multiply);
        # a device-tensor divisor keeps the card's division true
        calib = calib.float() / torch.full((), 255.0, device=device)
    amax = calibrate_activations(spec, folded, calib,
                                 compute_dtype=compute_dtype,
                                 per_channel=True)
    return quantize_folded(spec, folded, amax), itertools.chain([first], it)


def _serve_rows(serve, stream, group: DPGroup) -> List[Tuple]:
    """The data-parallel eval (``singleshotpose_tpu/drivers.py:215-302``):
    every rank reads the whole split in the same batches (the eval loader is
    not dataset-sharded); a ragged batch is zero-padded to a multiple of the
    world size, each rank serves its contiguous rows, and once every batch
    is launched one all-gather brings every rank all the boxes.  A yuv420
    batch's two planes are split by the same rows.  Returns [(boxes of the
    batch's real rows, labels)]."""
    local, batches = [], []
    for images, labels in prefetch(stream):
        planes = images if isinstance(images, tuple) else (images,)
        padded = [pad_rows(a, group.world) for a in planes]
        per = len(padded[0]) // group.world
        local.append(serve(*(a[group.rank * per:(group.rank + 1) * per]
                             for a in padded)))
        batches.append((len(planes[0]), per, labels))
    if not local:
        return []
    gathered = all_gather_rows(torch.cat(local), group)   # (world, Σper, ..)
    out, off = [], 0
    for n, per, labels in batches:
        boxes = gathered[:, off:off + per]
        out.append((boxes.reshape((-1,) + tuple(boxes.shape[2:]))[:n],
                    labels))
        off += per
    return out


def _eval_pass(spec: DarknetSpec, model: Optional[Darknet], loader,
               ctx: EvalContext, *, compute_dtype, device,
               pick: Tuple = ("best",), fix_gt_corners: bool = False,
               quantize: Union[bool, str] = False,
               add_s: bool = False,
               group: Optional[DPGroup] = None, transfer: str = "rgb",
               out_shape: Optional[Tuple[int, int]] = None
               ) -> Tuple[PoseErrors, Dict]:
    """Boxes for every batch (launched as the prefetch thread decodes the
    next batch), then one metric pass.  ``pick`` is the serving function's:
    ``("best",)`` gives a box an image; ``("per_class", conf)`` a box a
    class, and each GT is paired with the box of its own class
    (``valid_multi.py:118-123``).  ``quantize``: serve int8
    (:func:`_eval_params`), its scales rounded as JAX's eval driver rounds
    them (arguments of its compiled forward: ``x / sa``; under a group
    calibrated on the whole first batch on every rank, so the ranks'
    scales agree).  ``add_s``: score the 3D metric as ADD-S.  ``group``:
    the batches served data-parallel (:func:`_serve_rows`); every rank then
    scores all the boxes.  On a data × model grid the rows follow the data
    coordinate, the float serve's split convs are gathered over the model
    group, and the int8 params are whole (:func:`_eval_params`).  ``transfer``: the loader's (``rgb``, ``bank``:
    eval-size frames; ``yuv420``: ``(y, cbcr)`` planes, converted on the
    device to ``out_shape`` frames before the net).  Returns (PoseErrors,
    artifacts with
    ``corners_gt``, ``corners_pr`` (pixels), ``image_idx`` and the
    ``metrics``; empty when there is no ground truth)."""
    K = spec.num_keypoints
    params, stream = _eval_params(spec, model, loader,
                                  compute_dtype=compute_dtype, device=device,
                                  quantize=quantize, transfer=transfer,
                                  group=group)
    serve = make_serving_fn(spec, params, pick=pick,
                            compute_dtype=compute_dtype,
                            scales_as_constants=False,
                            transfer="yuv420" if transfer == "yuv420"
                            else "rgb", out_shape=out_shape, group=group)
    if group is None:
        pending = [(serve(*images) if isinstance(images, tuple)
                    else serve(images), labels)
                   for images, labels in prefetch(stream)]
    else:
        pending = _serve_rows(serve, stream, group)

    # the GT slots of each image up to its first empty one, in the
    # reference's image-then-slot order (valid.py:117-130)
    all_gt: List[np.ndarray] = []
    all_pr: List[np.ndarray] = []
    image_idx: List[np.ndarray] = []
    img_base = 0
    for boxes, labels in pending:
        boxes = boxes.cpu().numpy()
        B = labels.shape[0]
        lab = labels.reshape(B, 50, -1)
        valid = np.cumprod(lab[:, :, 1] != 0, axis=1).astype(bool)
        bidx, gidx = np.nonzero(valid)
        if bidx.size:
            all_gt.append(lab[bidx, gidx, 1:2 * K + 1])
            classes = lab[bidx, gidx, 0].astype(int)
            pr = boxes[bidx, classes] if boxes.ndim == 3 else boxes[bidx]
            all_pr.append(pr[:, :2 * K])
            image_idx.append(img_base + bidx)
        img_base += B

    errors = PoseErrors()
    if not all_gt:
        return errors, {}
    scale = np.tile(np.array([ctx.im_width, ctx.im_height], np.float32), K)
    gt = (np.concatenate(all_gt) * scale).reshape(-1, K, 2)
    pr = (np.concatenate(all_pr) * scale).reshape(-1, K, 2)
    metrics = pose_metrics(gt, pr, ctx, fix_gt_corners=fix_gt_corners,
                           symmetric=add_s, device=device)
    errors.extend(metrics)
    return errors, {"corners_gt": gt, "corners_pr": pr, "metrics": metrics,
                    "image_idx": np.concatenate(image_idx)}


def _eval_loader(ds: PoseDataset, out_shape: Tuple[int, int], batch_size: int,
                 num_workers: int, transfer: str, cache_key: tuple,
                 device: torch.device):
    """The batches of an eval pass: a host ``Loader`` of u8 batches
    (``rgb``), of the frames' yuv420 planes (``yuv420``, the native
    decoder's: it raises when the library does not build), or the
    LRU-cached eval bank of the rgb pixels on ``device`` (``bank``)."""
    if transfer == "bank":
        return eval_bank.get_eval_bank(ds, out_shape, batch_size,
                                       num_workers=num_workers, device=device,
                                       cache_key=cache_key + (str(device),))
    if transfer not in ("rgb", "yuv420"):
        raise ValueError(f"unknown transfer {transfer!r}")
    return Loader(ds, batch_size, shuffle=False, schedule=None,
                  fixed_shape=out_shape, num_workers=num_workers,
                  drop_last=False, out_uint8=True,
                  out_yuv420=transfer == "yuv420")


def run_validation(datacfg: str, modelcfg: Union[str, DarknetSpec],
                   weightfile: Optional[str] = None, *,
                   model: Optional[Darknet] = None, batch_size: int = 16,
                   num_workers: int = 8,
                   compute_dtype=torch.bfloat16, device="cuda",
                   transfer: str = "rgb",
                   quantize: Union[bool, str] = False, add_s: bool = False,
                   save: bool = False, verbose: bool = True,
                   group: Optional[DPGroup] = None) -> Dict[str, float]:
    """Single-object eval (reference ``valid.py``): the 6D metric suite.

    The network is ``weightfile``, a darknet binary, or an in-memory
    ``model`` (as the JAX driver takes ``params=``/``batch_stats=``; the
    trainer's eval passes its model), which must be on ``device``.
    ``device`` is where the network and PnP run; it is used as given, and a
    CUDA device that is absent raises.  ``transfer="rgb"`` streams u8
    batches from the host; ``"bank"`` decodes the split ONCE into a
    device-resident eval bank (``data/eval_bank.py``, LRU-cached across
    calls): repeated evals — the in-training cadence, reference
    ``train.py:395`` — then run with no host decode and no per-frame copy,
    on pixels bit-identical to the rgb path's.  ``"yuv420"`` streams the
    frames' native-size YUV 4:2:0 planes (the native decoder's; it raises
    when the library does not build), converted and resized on the device
    (``ops/yuv.py``): 1.5 bytes a native pixel against rgb's 3 an eval
    pixel; the pixels differ from rgb's by the JPEG chroma round trip
    (``tests/test_torch_yuv.py`` bounds it).

    ``quantize=True`` serves the backbone convs in int8 (per-channel
    weights, activation scales calibrated on the first batch:
    ``models/quantize.py``; on a card the int8 conv kernel);
    ``quantize="<path>.npz"`` serves an artifact of ``cli quantize``, with
    no weightfile.  ``add_s=True`` scores the 3D metric as ADD-S (nearest
    vertex, for symmetric objects); the default is the reference's ADD.
    ``save=True`` writes per-frame R/t/corner files under
    ``<backup>/test/{gt,pr}/`` and a predictions ``.mat``
    (``valid.py:186-197,231-233``).

    ``group``: data-parallel eval (JAX's ``mesh=``) on the group's device
    in place of ``device``: each rank serves its rows of every batch
    (:func:`_serve_rows`; the ``bank`` holds the whole split on every rank,
    which takes its rows), every rank returns the same summary, and rank 0
    alone logs and saves.
    """
    device = _resolve_device(device if group is None else group.device)
    verbose = verbose and _is_writer(group)
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    spec = _resolve_model(modelcfg)
    if model is None and not isinstance(quantize, str):
        model = _load_model(spec, weightfile, device)

    ctx = EvalContext.from_data_config(dcfg)
    ds = PoseDataset(dcfg.valid, train=False,
                     num_keypoints=spec.num_keypoints)
    out_shape = (spec.net.test_width, spec.net.test_height)
    loader = _eval_loader(ds, out_shape, batch_size, num_workers, transfer,
                          ("single", dcfg.valid, out_shape, batch_size,
                           spec.num_keypoints), device)
    if verbose:
        _log(f"   Testing {dcfg.name}...")
        _log(f"   Number of test samples: {len(ds)}")
    errors, artifacts = _eval_pass(spec, model, loader, ctx,
                                   compute_dtype=compute_dtype, device=device,
                                   quantize=quantize, add_s=add_s,
                                   group=group, transfer=transfer,
                                   out_shape=out_shape)
    summary = accuracy_summary(errors, ctx.diam)
    if save and artifacts and _is_writer(group):
        _save_predictions(dcfg, ds, artifacts)
    if verbose:
        _log(f"Results of {dcfg.name}")
        _log("   Acc using 5 px 2D Projection = "
             f"{summary['acc_2d_proj']:.2f}%")
        _log(f"   Acc using 10% threshold - {ctx.diam * 0.1} vx 3D "
             f"Transformation = {summary['acc_add_0.1d']:.2f}%")
        _log("   Acc using 5 cm 5 degree metric = "
             f"{summary['acc_5cm5deg']:.2f}%")
        _log(f"   Mean 2D pixel error is {summary['mean_err_2d']:f}, "
             f"Mean vertex error is {summary['mean_err_3d']:f}, "
             f"mean corner error is {summary['mean_corner_err_2d']:f}")
        _log(f"   Translation error: {summary['mean_err_trans']:f} m, "
             f"angle error: {summary['mean_err_angle']:f} degree")
    return summary


def _save_predictions(dcfg: DataConfig, ds: PoseDataset, artifacts) -> None:
    """Per-frame R/t/corner dumps and a consolidated ``.mat``
    (``singleshotpose_tpu/drivers.py:427-478``; reference
    ``valid.py:186-197,231-233``).  Each row maps back to its image, and a
    frame with several GTs numbers them ``_obj<k>``."""
    backup = dcfg.backup or "backup"
    m = artifacts["metrics"]
    gt_dir = os.path.join(backup, "test", "gt")
    pr_dir = os.path.join(backup, "test", "pr")
    os.makedirs(gt_dir, exist_ok=True)
    os.makedirs(pr_dir, exist_ok=True)
    image_idx = artifacts["image_idx"]
    for i in range(artifacts["corners_gt"].shape[0]):
        src = int(image_idx[i])
        stem = os.path.splitext(os.path.basename(
            ds.lines[src] if src < len(ds.lines) else f"{src:06d}"))[0]
        if (image_idx == image_idx[i]).sum() > 1:
            stem = f"{stem}_obj{int((image_idx[:i] == image_idx[i]).sum())}"
        for d, kind in ((gt_dir, "gt"), (pr_dir, "pr")):
            np.savetxt(os.path.join(d, f"R_{stem}.txt"), m[f"R_{kind}"][i])
            np.savetxt(os.path.join(d, f"t_{stem}.txt"), m[f"t_{kind}"][i])
            np.savetxt(os.path.join(d, f"corners_{stem}.txt"),
                       artifacts[f"corners_{kind}"][i])
    try:
        import scipy.io
    except ImportError:
        _log("scipy unavailable: skipped predictions .mat dump")
        return
    scipy.io.savemat(
        os.path.join(backup, f"predictions_linemod_{dcfg.name}.mat"),
        {"R_gts": m["R_gt"], "t_gts": m["t_gt"],
         "corner_gts": artifacts["corners_gt"], "R_prs": m["R_pr"],
         "t_prs": m["t_pr"], "corner_prs": artifacts["corners_pr"]})


# occlusion eval sweep objects (reference valid_multi.py:160-177)
OCCLUSION_EVAL_OBJECTS = ("ape", "can", "cat", "duck", "glue", "holepuncher")


def run_validation_multi(datacfg: Union[str, DataConfig],
                         modelcfg: Union[str, DarknetSpec],
                         weightfile: Optional[str] = None, *,
                         model: Optional[Darknet] = None,
                         batch_size: int = 16, num_workers: int = 8,
                         compute_dtype=torch.bfloat16, device="cuda",
                         transfer: str = "rgb",
                         quantize: Union[bool, str] = False,
                         verbose: bool = True,
                         group: Optional[DPGroup] = None
                         ) -> Dict[str, object]:
    """Multi-object OCCLUSION eval for one object (reference
    ``valid_multi.py:20-158``): class-picked boxes, ``fix_corner_order`` on
    the GT, the pixel-error accuracy table at 5..50 px.

    With a ``class_id`` key in the ``.data`` file each image's box of that
    class is scored; otherwise each GT is paired with the box of its own
    class, picked at the spec's ``conf_thresh``.  Frames are read at the
    spec's train size
    (``valid_multi.py:71``), labels from ``labels_occlusion/`` under the
    object's name (``dataset_multi.py:78``).  The network is
    ``weightfile`` or ``model``, as :func:`run_validation` takes them, and
    ``transfer`` as it takes it (the bank keyed on the object too: the sweep
    reads the same frames under each object's labels), ``quantize`` as it
    takes it (``True`` calibrates on this object's first batch), and
    ``group`` as it takes it.
    """
    device = _resolve_device(device if group is None else group.device)
    verbose = verbose and _is_writer(group)
    if isinstance(datacfg, DataConfig):
        options: Dict[str, str] = {}
        dcfg = datacfg
    else:
        options = read_data_cfg(datacfg)
        dcfg = data_config_from_options(options)
    spec = _resolve_model(modelcfg)
    if model is None and not isinstance(quantize, str):
        model = _load_model(spec, weightfile, device)
    conf_thresh = spec.net.conf_thresh
    name = dcfg.name
    class_id = int(options["class_id"]) if "class_id" in options else None

    def occlusion_label_path(imgpath: str) -> str:
        return (imgpath.replace("benchvise", name)
                .replace("images", "labels_occlusion")
                .replace("JPEGImages", "labels_occlusion")
                .replace(".jpg", ".txt").replace(".png", ".txt"))

    ctx = EvalContext.from_data_config(dcfg)
    ds = PoseDataset(dcfg.valid, train=False,
                     num_keypoints=spec.num_keypoints,
                     label_path_fn=occlusion_label_path)
    out_shape = (spec.net.width, spec.net.height)
    loader = _eval_loader(ds, out_shape, batch_size, num_workers, transfer,
                          ("multi", dcfg.valid, name, out_shape, batch_size,
                           spec.num_keypoints), device)
    pick = ("for_class", class_id, conf_thresh) if class_id is not None \
        else ("per_class", conf_thresh)
    if verbose:
        _log(f"   Testing {name}...")
    errors, _ = _eval_pass(spec, model, loader, ctx, pick=pick,
                           fix_gt_corners=True, compute_dtype=compute_dtype,
                           device=device, quantize=quantize, group=group,
                           transfer=transfer, out_shape=out_shape)
    table = multi_accuracy_table(errors.errs_2d)
    if verbose:
        for th, acc in table.items():
            _log(f"   Acc using {th} px 2D Projection = {acc:.2f}%")
    return {"name": name, "acc_table": table,
            "mean_err_2d": float(np.mean(errors.errs_2d))
            if len(errors) else float("nan"),
            "n_samples": len(errors)}


def run_validation_multi_sweep(occlusion_datacfg: str,
                               modelcfg: Union[str, DarknetSpec],
                               weightfile: str,
                               **kw) -> List[Dict[str, object]]:
    """Eval every object listed in a multi ``.data``'s numbered
    ``valid<i>``/``mesh<i>``/``diam<i>`` keys (``occlusion.data``), with
    one load of the weights; ``kw`` go to :func:`run_validation_multi`."""
    dcfg = data_config_from_options(read_data_cfg(occlusion_datacfg))
    spec = _resolve_model(modelcfg)
    model = _load_model(spec, weightfile,
                        _resolve_device(kw.get("device", "cuda")))
    return [run_validation_multi(entry, spec, model=model, **kw)
            for entry in occlusion_sweep(dcfg)]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def load_spec(modelcfg: Union[str, DarknetSpec]) -> DarknetSpec:
    """Accept a `.cfg` path or an already-built DarknetSpec."""
    if isinstance(modelcfg, DarknetSpec):
        return modelcfg
    return DarknetSpec.from_cfg(modelcfg)


def loss_config_from_spec(spec: DarknetSpec, *, pretrain_num_epochs: int,
                          im_width: float, im_height: float,
                          multi: bool = False,
                          honor_cfg_scales: bool = False) -> RegionLossConfig:
    """Loss config: topology from the spec's [region] block, scales as the
    reference's loss modules really use them — coord/noobject/object/class
    1/1/5/1 and threshold 0.6, whatever the cfg says
    (``singleshotpose_tpu/drivers.py:67-95``) — or, with
    ``honor_cfg_scales``, the [region] block's scales and ``thresh``;
    ``multi`` adds the class term where the region has more than one
    class.  A net with several [yolo] heads has no region loss yet
    (``ValueError``)."""
    spec.require_one_head("the region loss (training)")
    r = spec.region
    scales = dict(coord_scale=r.coord_scale, noobject_scale=r.noobject_scale,
                  object_scale=r.object_scale, class_scale=r.class_scale,
                  sil_thresh=r.thresh) if honor_cfg_scales else \
        dict(coord_scale=1.0, noobject_scale=1.0, object_scale=5.0,
             class_scale=1.0, sil_thresh=0.6)
    return RegionLossConfig(
        num_keypoints=spec.num_keypoints, num_classes=r.classes,
        num_anchors=r.num, anchors=r.anchors,
        pretrain_num_epochs=pretrain_num_epochs,
        with_class_loss=multi and r.classes > 1,
        im_width=float(im_width), im_height=float(im_height), **scales)


@dataclasses.dataclass
class TrainRunConfig:
    """Run settings beyond the reference CLI (defaults = the reference)."""
    eval_every: int = 10           # train.py:395 (epoch % 10)
    eval_after: int = 15           # train.py:395 (epoch > 15)
    # the run_validation summary key that picks the best model.weights
    # (the single-object trainer; the multi one keeps its mean acc@50 px)
    save_best_metric: str = "acc_2d_proj"
    compute_dtype: object = torch.bfloat16
    num_workers: int = 8
    eval_batch_size: int = 16
    bg_dir: str = "VOCdevkit/VOC2012/JPEGImages"
    seed: int = 0
    max_epochs_override: Optional[int] = None
    log_every: int = 20            # batches
    checkpoint_dir: Optional[str] = None   # full-state checkpoints here
    checkpoint_every_epochs: int = 10
    resume: bool = False               # restore the latest checkpoint
    device: str = "cuda"
    # the fused train stem (K3-K6); None = on for bf16 on a CUDA device,
    # off elsewhere (_resolve_fused_stem)
    fused_stem: Optional[bool] = None
    # pay for every multi-scale bucket before epoch 0: on a card, one CUDA
    # graph of the step per bucket, replayed by every step after
    # (_precompile_buckets)
    precompile_buckets: bool = False
    profile_dir: Optional[str] = None  # torch.profiler trace of a few steps
    profile_steps: Tuple[int, int] = (5, 10)
    cache_decoded: bool = False        # RAM-cache decoded images across epochs
    # train loader: auto|python|native|device|device_bank (multi:
    # auto|python|device_synth); auto: native when its library builds
    loader_backend: str = "auto"
    # device_synth's placement knobs (the multi trainer with loader_backend
    # "device_synth"): proposals per companion (None: the host
    # synthesizer's max_attempts, its drop law) and the overlap test's
    # resolution divisor (data/device_synth.py)
    synth_attempts: Optional[int] = None
    synth_propose_scale: int = 4
    # in-training eval input: "rgb" streams host batches, "yuv420" the
    # frames' native-size planes (the native decoder's, converted on the
    # device), "bank" decodes the test split once into device memory
    # (data/eval_bank.py); "auto" picks "bank" when the split fits the
    # card's free memory with headroom (_resolve_eval_transfer), else "rgb"
    eval_transfer: str = "auto"
    # data parallel (JAX's ``mesh``): this process is one rank of the group,
    # on the group's device in place of ``device`` (parallel/sharding.py)
    group: Optional[DPGroup] = None


def _resolve_fused_stem(rc: TrainRunConfig, device: torch.device) -> bool:
    """``rc.fused_stem`` when set; else on for bf16 on a CUDA device — the
    counterpart of the JAX package's "bf16 on the accelerator"
    (``singleshotpose_tpu/drivers.py:703-713``) — and off on the CPU."""
    if rc.fused_stem is not None:
        return rc.fused_stem
    return rc.compute_dtype == torch.bfloat16 and device.type == "cuda"


def _count_lines(path: str) -> int:
    with open(path) as f:
        return sum(1 for line in f if line.strip())


_EVAL_BANK_HEADROOM = 1 << 30   # keep >= 1 GB free for eval activations


def _valid_split_frames(datacfg: Union[str, DataConfig]) -> int:
    dc = datacfg if isinstance(datacfg, DataConfig) else \
        data_config_from_options(read_data_cfg(datacfg))
    try:
        return _count_lines(dc.valid)
    except OSError:
        return 0


def _bank_bytes(n_frames: int, out_shape: Tuple[int, int],
                batch: int) -> int:
    """u8 device footprint of an EvalBank: frames padded to a batch
    multiple."""
    padded = -(-max(n_frames, 1) // batch) * batch
    return padded * out_shape[0] * out_shape[1] * 3


def _resolve_eval_transfer(rc: "TrainRunConfig", need_bytes: int,
                           device: torch.device) -> str:
    """Resolve ``eval_transfer="auto"`` for one in-training eval pass
    (``singleshotpose_tpu/drivers.py:657-700``).

    The eval bank is strictly better than streaming for the repeated eval
    cadence (reference ``train.py:395``) whenever it fits, so it is the
    default — after a preflight: bank bytes for the split(s) + ≥1 GB
    activation headroom must fit the free device memory.  When tight, first
    evict the eval-bank LRU (stale banks from earlier splits), else stream
    ``rgb`` for THIS pass (the next eval resolves again, so transient
    pressure does not keep the run streaming).  Off CUDA there is no budget:
    ``bank``."""
    if rc.eval_transfer != "auto":
        return rc.eval_transfer
    group = rc.group
    if group is None:
        return _resolve_eval_transfer_local(rc, need_bytes, device)
    # the choice must be the same on every rank of the grid (a rank's free
    # memory may differ): the writer decides, everyone follows
    pick = _resolve_eval_transfer_local(rc, need_bytes, device) \
        if group.leader else "rgb"
    code = torch.tensor([int(pick == "bank")], device=group.device)
    dist.broadcast(code, group.leader_rank, group=group.grid_pg)
    return "bank" if int(code.item()) else "rgb"


def _resolve_eval_transfer_local(rc: "TrainRunConfig", need_bytes: int,
                                 device: torch.device) -> str:
    free = hbm_free_bytes(device)
    if free is None:
        return "bank"
    need = need_bytes + _EVAL_BANK_HEADROOM
    if need <= free:
        return "bank"
    cached = sum(b.nbytes() for b in eval_bank._CACHE.values())
    if cached and need <= free + cached:
        _log(f"eval_transfer=auto: evicting {cached >> 20} MB of cached "
             "eval banks to fit this split")
        eval_bank.clear_cache()
        return "bank"
    _log(f"eval_transfer=auto: bank needs {need >> 20} MB but only "
         f"{free >> 20} MB device memory free — streaming rgb for this eval")
    return "rgb"


def _init_state(spec: DarknetSpec, initweightfile: Optional[str],
                rc: TrainRunConfig, device: torch.device):
    """The train state, from ``initweightfile`` (a backbone: every layer
    but the last two blocks, ``seen`` reset to 0 as the reference does) or a
    generator seeded with ``rc.seed``; with ``rc.resume`` and a checkpoint
    in ``rc.checkpoint_dir``, from that checkpoint.  Under ``rc.group``
    every rank restores the whole state, and rank 0's is then broadcast to
    every rank (``shard_train_state``), which on a data × model grid then
    keeps this rank's slices, as JAX restores a state and then places it
    on its mesh (``singleshotpose_tpu/drivers.py:745-774``).  Returns
    (state, checkpointer or None)."""
    net = spec.net
    gen = torch.Generator().manual_seed(rc.seed)
    if initweightfile:
        _, init = W.load_weights_until_last(spec, initweightfile, gen)
        model = Darknet(spec, device=device)
        model.load_state_dict(init)
    else:
        model = Darknet(spec, generator=gen, device=device)
    state = init_train_state(model, weight_decay=net.decay * net.batch,
                             momentum=net.momentum)
    ckpt = Checkpointer(rc.checkpoint_dir, group=rc.group) \
        if rc.checkpoint_dir else None
    if rc.resume and ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(state)
        _log(f"resumed from {rc.checkpoint_dir} at seen={state.seen}")
    if rc.group is not None:
        shard_train_state(rc.group, state)
    return state, ckpt


def _train_device(rc: TrainRunConfig) -> torch.device:
    """The run's device: the group's under data parallelism, else
    ``rc.device``."""
    return _resolve_device(rc.device if rc.group is None else rc.group.device)


_BANK_BACKENDS = ("device_bank", "device_synth")


def _local_shard(ds: PoseDataset, batch_size: int, seen: int,
                 group: Optional[DPGroup],
                 backend: str = "python") -> Tuple[int, int]:
    """Data parallel (JAX's ``_multihost_local_shard``,
    ``singleshotpose_tpu/drivers.py:870-888``): restrict ``ds`` to this
    rank's shard of the dataset and divide the cfg's (global) batch over
    the ranks.  Every rank keeps the run's loader seed, so the shuffles and
    the multi-scale widths stay in lockstep; ``seen`` is global, but the
    loader's multi-scale clock counts local samples, so the local seen is
    returned.  The bank backends keep the whole dataset, the global batch
    and ``seen``, as JAX's one-process mesh does (a no-op there): each
    rank's ``Loader(group=)`` draws the global batch and computes its rows.
    Returns (the loader's batch, its seen)."""
    if group is None:
        return batch_size, seen
    if batch_size % group.world:
        raise ValueError(f"[net] batch={batch_size} must be divisible by the "
                         f"{group.world} data-parallel ranks")
    if backend in _BANK_BACKENDS:
        return batch_size, seen
    idx = process_local_indices(len(ds), process_id=group.rank,
                                num_processes=group.world)
    ds.lines = [ds.lines[i] for i in idx]
    return batch_size // group.world, seen // group.world


def _check_dp_options(rc: TrainRunConfig) -> None:
    """What a data-parallel run cannot take: captured steps over a gloo
    group, grid or not (gloo's collectives run on the host: a CUDA graph
    cannot record them; an NCCL group's step is captured, on a data ×
    model grid too)."""
    if rc.group is None:
        return
    if rc.precompile_buckets and rc.group.backend != "nccl":
        raise ValueError(
            f"precompile_buckets: a data-parallel step over a "
            f"{rc.group.backend} group cannot be captured (its collectives "
            "run on the host, outside any CUDA graph); train eagerly, or "
            "over NCCL")


def _bank_group(rc: TrainRunConfig, backend: str) -> Optional[DPGroup]:
    """The group a bank backend's loader splits its batches over (None for
    a host loader, which reads its rank's dataset shard instead)."""
    return rc.group if backend in _BANK_BACKENDS else None


def _rank_rows(batch_size: int, group: Optional[DPGroup]) -> int:
    """A step's rows on this rank: the global batch over the data ranks."""
    return batch_size if group is None else batch_size // group.world


def _whole_weights(state: TrainState, group: Optional[DPGroup]):
    """The model's state dict whole, for ``model.weights``: on a grid
    gathered over the model group (every rank of it must call this)."""
    model = state.model
    return (model if group is None
            else gather_model_whole(group, model)).state_dict()


def _train_epochs(epochs, train_one, evaluate, state: TrainState, processed,
                  ckpt: Optional[Checkpointer], rc: TrainRunConfig) -> None:
    """Per epoch: ``train_one(epoch)``, a checkpoint every
    ``rc.checkpoint_every_epochs``, ``evaluate(epoch)``; a final checkpoint.
    On any failure the latest state is saved before the error goes on."""
    try:
        for epoch in epochs:
            train_one(epoch)
            if ckpt is not None and rc.checkpoint_every_epochs and \
                    epoch % rc.checkpoint_every_epochs == 0:
                ckpt.save(processed[0], state)
            evaluate(epoch)
    except BaseException:
        # keep what was trained: a full-state save at the current batch
        # before the error goes on, with no barrier — the other ranks may
        # be gone or waiting in a collective (data parallel: the writer's;
        # on a grid gathered over a group of its own, bounded by the
        # collective timeout: Checkpointer.save_on_failure)
        if ckpt is not None:
            if _is_writer(rc.group):
                _log("checkpoint on failure")
            try:
                ckpt.save_on_failure(processed[0], state)
            except Exception as e:      # the original error matters more
                _log(f"checkpoint on failure failed: {e!r}")
        raise
    if ckpt is not None:
        ckpt.save(processed[0], state)


def run_training(datacfg: str, modelcfg: Union[str, DarknetSpec],
                 initweightfile: Optional[str] = None,
                 pretrain_num_epochs: int = 15,
                 run_cfg: Optional[TrainRunConfig] = None) -> Dict[str, object]:
    """Single-object training (reference ``train.py`` main).

    The model starts from ``initweightfile`` (a backbone: every layer but
    the last two blocks, ``seen`` reset to 0 as the reference does), or from
    a generator seeded with ``run_cfg.seed``; with ``resume`` and a
    checkpoint in ``checkpoint_dir``, from that checkpoint.  Runs on
    ``run_cfg.device``, used as given (a CUDA device that is absent raises).

    Data parallel (``run_cfg.group``, JAX's ``mesh``; a torch rank is a
    process): the cfg's batch is the global batch and must divide by the
    data ranks; with a host loader each rank trains on its
    ``process_local_indices`` shard of the dataset with the local batch and
    the run's loader seed (JAX's multi-host recipe), with ``device_bank``
    every rank holds the whole bank and computes its rows of the global
    batch (``Loader(group=)``, JAX's one-process mesh); the step sums the
    gradients and synchronises BN over the group; the lr, the weight decay
    and ``seen`` stay global; ``model.weights``, ``costs.npz`` and the
    checkpoints are the writer's (data and model coordinate 0);
    ``eval_transfer="auto"`` is the writer's choice; ``precompile_buckets``
    captures the step of an NCCL group, collectives and all, per rank.

    A data × model grid (``make_dp_group(dp, mp)``, JAX's ``make_mesh(dp,
    mp)``): the state starts whole — restored whole from a checkpoint too
    — and is split (``training.shard_train_state``); the step and the
    in-training eval run on the split model; checkpoints and
    ``model.weights`` are written from the state gathered whole
    (``Checkpointer``, ``training.gather_model_whole``), in the
    one-process formats.  ``precompile_buckets`` captures the grid's step
    over NCCL, its channel gathers and input-gradient sums recorded with
    its other collectives, after any checkpoint restore (the graphs bind
    the split tensors); over gloo it raises.

    Returns {"state": the final TrainState, "best_acc": float,
    "history": dict of the training and testing curves}.
    """
    rc = run_cfg or TrainRunConfig()
    _check_dp_options(rc)
    device = _train_device(rc)
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    spec = _resolve_model(modelcfg)
    net = spec.net

    batch_size = net.batch
    nsamples = _count_lines(dcfg.train)
    nbatches = nsamples / batch_size
    steps = [s * nbatches for s in net.steps]      # train.py:307
    scales = list(net.scales)
    max_epochs = rc.max_epochs_override or net.max_epochs
    backupdir = dcfg.backup or "backup"
    os.makedirs(backupdir, exist_ok=True)

    state, ckpt = _init_state(spec, initweightfile, rc, device)
    processed = [state.seen // batch_size]     # current, for the crash save
    init_epoch = state.seen // max(nsamples, 1)

    loss_cfg = loss_config_from_spec(spec,
                                     pretrain_num_epochs=pretrain_num_epochs,
                                     im_width=dcfg.width, im_height=dcfg.height)
    step = make_train_step(loss_cfg, compute_dtype=rc.compute_dtype,
                           fused_stem=_resolve_fused_stem(rc, device),
                           group=rc.group)
    bg_files = get_all_files(rc.bg_dir) if os.path.isdir(rc.bg_dir) else []
    ds = PoseDataset(dcfg.train, train=True, bg_file_names=bg_files,
                     num_keypoints=spec.num_keypoints,
                     cache_decoded=rc.cache_decoded)
    loader_batch, loader_seen = _local_shard(ds, batch_size, state.seen,
                                             rc.group, rc.loader_backend)
    loader = Loader(ds, loader_batch, schedule=SINGLE_SCHEDULE,
                    seen=loader_seen, num_workers=rc.num_workers,
                    seed=rc.seed, backend=rc.loader_backend, out_uint8=True,
                    device=device, group=_bank_group(rc, rc.loader_backend))
    if rc.precompile_buckets:
        step = _precompile_buckets(step, state, SINGLE_SCHEDULE.all_widths,
                                   _rank_rows(batch_size, rc.group),
                                   spec.num_keypoints)

    history: Dict[str, List] = {"training_iters": [], "training_losses": [],
                                "testing_iters": [], "testing_accuracies": [],
                                "testing_errors_pixel": [],
                                "testing_errors_angle": []}
    best = [-float("inf")]

    def train_one(epoch):
        lr = schedule_lr(net.learning_rate, processed[0], steps, scales)
        _log(f"epoch {epoch}, processed {epoch * nsamples} samples, "
             f"lr {lr:f}")
        _run_epoch_batches(epoch, loader, step, state, device, net, steps,
                           scales, nbatches, processed, rc.log_every, history,
                           window)

    def evaluate(epoch):
        if epoch % rc.eval_every == 0 and epoch > rc.eval_after:
            best[0] = _eval_and_keep_best(datacfg, spec, state, rc, device,
                                          backupdir, history, processed[0],
                                          best[0])

    window = _ProfileWindow(rc, device)
    try:
        _train_epochs(range(init_epoch, max_epochs), train_one, evaluate,
                      state, processed, ckpt, rc)
    finally:
        window.close()
    _save_final_if_unsaved(spec, state, best[0], backupdir,
                           processed[0] * batch_size, rc.group)
    return {"state": state, "best_acc": best[0], "history": history}


def run_training_multi(datacfg: str, modelcfg: Union[str, DarknetSpec],
                       initweightfile: Optional[str] = None,
                       pretrain_num_epochs: int = 0,
                       eval_datacfgs: Optional[Sequence[str]] = None,
                       linemod_root: Optional[str] = None,
                       run_cfg: Optional[TrainRunConfig] = None
                       ) -> Dict[str, object]:
    """Multi-object OCCLUSION training (reference ``train_multi.py`` main).

    What differs from :func:`run_training`, as in the reference: scenes
    from the multi-object synthesizer over the LINEMOD singles under
    ``linemod_root`` (by default inferred from the train list's paths,
    ``image_multi.py:320``), ``AugmentConfig.multi()``, the milder
    ``MULTI_SCHEDULE``, the class term of the loss, and an eval every 20
    epochs from epoch 0 over the per-object ``eval_datacfgs``
    (:func:`run_validation_multi`), the best ``model.weights`` kept on the
    mean of their acc@50 px (``train_multi.py:277``, ``417-421``).  The
    state, checkpoints, resume and device are as :func:`run_training` has
    them.  Loader backends: ``python`` (``auto``; the host synthesizer, u8,
    its pixel core native when the library builds: ``SynthConfig.native``)
    or ``device_synth`` (f32 scenes synthesized on ``run_cfg.device``, with
    ``synth_attempts``/``synth_propose_scale``; ``precompile_buckets``
    captures f32 graphs); the single-object backends raise.  Data parallel
    and the data × model grid (``run_cfg.group``) as :func:`run_training`
    runs them; ``device_synth`` as ``device_bank`` there: every rank holds
    the scene bank and synthesizes its rows of the global batch.
    """
    rc = run_cfg or TrainRunConfig(eval_every=20, eval_after=-1)
    backend = rc.loader_backend
    if backend in ("native", "device", "device_bank"):
        raise ValueError(
            f"loader_backend={backend!r} does not cover the scene-synthesis "
            "path; use 'python' (the host synthesizer, default) or "
            "'device_synth' (the corpus in device memory, "
            "data/device_synth.py)")
    if backend == "auto":
        backend = "python"
    _check_dp_options(rc)
    device = _train_device(rc)
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    spec = _resolve_model(modelcfg)
    net = spec.net

    batch_size = net.batch
    with open(dcfg.train) as f:
        train_lines = [ln.strip() for ln in f if ln.strip()]
    nsamples = len(train_lines)
    nbatches = nsamples / batch_size
    steps = [s * nbatches for s in net.steps]
    scales = list(net.scales)
    max_epochs = rc.max_epochs_override or net.max_epochs
    backupdir = dcfg.backup or "backup_multi"
    os.makedirs(backupdir, exist_ok=True)

    state, ckpt = _init_state(spec, initweightfile, rc, device)
    processed = [state.seen // batch_size]
    init_epoch = state.seen // max(nsamples, 1)

    loss_cfg = loss_config_from_spec(spec,
                                     pretrain_num_epochs=pretrain_num_epochs,
                                     im_width=dcfg.width,
                                     im_height=dcfg.height, multi=True)
    step = make_train_step(loss_cfg, compute_dtype=rc.compute_dtype,
                           fused_stem=_resolve_fused_stem(rc, device),
                           group=rc.group)
    if linemod_root is None:
        linemod_root = os.path.dirname(os.path.dirname(
            os.path.dirname(train_lines[0])))
    synth = MultiObjectSynthesizer(SynthConfig(
        linemod_root=linemod_root, num_keypoints=spec.num_keypoints))
    bg_files = get_all_files(rc.bg_dir) if os.path.isdir(rc.bg_dir) else []
    ds = PoseDataset(dcfg.train, train=True, bg_file_names=bg_files,
                     aug=AugmentConfig.multi(),
                     num_keypoints=spec.num_keypoints, synthesizer=synth,
                     cache_decoded=rc.cache_decoded)
    # device_synth yields f32 scenes on the device, the host synthesizer u8
    on_device = backend == "device_synth"
    loader_batch, loader_seen = _local_shard(ds, batch_size, state.seen,
                                             rc.group, backend)
    loader = Loader(ds, loader_batch, schedule=MULTI_SCHEDULE,
                    seen=loader_seen, num_workers=rc.num_workers, seed=rc.seed,
                    backend=backend, out_uint8=not on_device, device=device,
                    synth_attempts=rc.synth_attempts,
                    synth_propose_scale=rc.synth_propose_scale,
                    group=_bank_group(rc, backend))
    if rc.precompile_buckets:
        step = _precompile_buckets(
            step, state, MULTI_SCHEDULE.all_widths,
            _rank_rows(batch_size, rc.group), spec.num_keypoints,
            image_dtype=torch.float32 if on_device else torch.uint8)

    history: Dict[str, List] = {"training_iters": [], "training_losses": [],
                                "testing_iters": [], "testing_accuracies": []}
    best = [-float("inf")]

    def train_one(epoch):
        lr = schedule_lr(net.learning_rate, processed[0], steps, scales)
        _log(f"[multi] epoch {epoch}, lr {lr:f}")
        _run_epoch_batches(epoch, loader, step, state, device, net, steps,
                           scales, nbatches, processed, rc.log_every, history,
                           window)

    def evaluate(epoch):
        if eval_datacfgs and epoch % rc.eval_every == 0 and \
                epoch > rc.eval_after:
            best[0] = _multi_eval_and_keep_best(eval_datacfgs, spec, state,
                                                rc, device, backupdir,
                                                history, processed[0],
                                                best[0])

    window = _ProfileWindow(rc, device)
    try:
        _train_epochs(range(init_epoch, max_epochs), train_one, evaluate,
                      state, processed, ckpt, rc)
    finally:
        window.close()
    _save_final_if_unsaved(spec, state, best[0], backupdir,
                           processed[0] * batch_size, rc.group)
    return {"state": state, "best_acc": best[0], "history": history}


def _multi_eval_and_keep_best(eval_datacfgs, spec, state, rc, device,
                              backupdir, history, processed,
                              best_acc) -> float:
    """The in-training sweep of the model in memory: acc@50 px of each
    object, their mean to the curves and ``costs.npz``, and
    ``model.weights`` when the mean is a new best.  Returns the best."""
    # the sweep keeps one bank per object in the LRU: budget them all
    out_shape = (spec.net.width, spec.net.height)
    transfer = _resolve_eval_transfer(rc, sum(
        _bank_bytes(_valid_split_frames(dc), out_shape, rc.eval_batch_size)
        for dc in eval_datacfgs), device)
    accs = [run_validation_multi(dc, spec, model=state.model,
                                 batch_size=rc.eval_batch_size,
                                 num_workers=rc.num_workers,
                                 compute_dtype=rc.compute_dtype,
                                 device=device, transfer=transfer,
                                 group=rc.group)["acc_table"][50]
            for dc in eval_datacfgs]
    mean_acc = float(np.mean(accs))
    history["testing_iters"].append(processed)
    history["testing_accuracies"].append(mean_acc)
    writer = _is_writer(rc.group)
    if writer:
        np.savez(os.path.join(backupdir, "costs.npz"),
                 **{k: np.asarray(v) for k, v in history.items()})
    if not mean_acc > best_acc:
        return best_acc
    path = os.path.join(backupdir, "model.weights")
    _log(f"[multi] best model so far! save weights to {path}")
    # every rank gathers (a collective), the writer writes
    weights = _whole_weights(state, rc.group)
    if writer:
        W.save_weights(spec, weights, path, seen=state.seen)
    return mean_acc


def _to_device(a, device: torch.device) -> torch.Tensor:
    """A batch on ``device``: a tensor (a device backend's) as it is; a host
    array to a card through pinned memory, without waiting for the copy;
    the span ``ssp.train.to_device``."""
    with span("ssp.train.to_device"):
        if isinstance(a, torch.Tensor):
            return a.to(device)
        t = torch.from_numpy(a)
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t.to(device)


def _precompile_buckets(step: Callable, state: TrainState,
                        widths: Sequence[int], batch: int,
                        num_keypoints: int,
                        image_dtype: torch.dtype = torch.uint8) -> Callable:
    """Pay for every multi-scale bucket before epoch 0
    (``singleshotpose_tpu/drivers.py:905-930``).  Returns the step to train
    with.  ``batch``: the rows of one step on this rank (the loader's batch).

    On a card: ``step`` captured as one CUDA graph per width for images of
    ``image_dtype`` (u8 from the host loaders and the single-object banks,
    f32 from ``device_synth``)
    (:func:`~singleshotpose_tpu_torch.training.capture_train_step`), after
    warm-up steps that leave the state as it was; a failed capture raises.
    On the CPU, eager PyTorch has nothing to compile: ``step`` itself.
    Logs each bucket's time.  A data-parallel step (NCCL; gloo is refused
    before, :func:`_check_dp_options`) is captured with its collectives: every
    rank captures the same widths in the same order, and replays in
    lockstep.  On a data × model grid (JAX's ``_precompile_buckets`` under
    ``make_mesh(dp, mp)``) each rank captures its split step, the model
    group's channel gathers and input-gradient sums among the recorded
    collectives; ``batch`` is the data rank's rows, the same on every rank
    of its model group."""
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        _log(f"nothing to precompile on {device}: the step runs eagerly")
        return step
    t_all = time.time()
    captured = capture_train_step(step, state, widths, batch,
                                  50 * (2 * num_keypoints + 3), image_dtype)
    for shape, s in captured.capture_seconds.items():
        _log(f"captured bucket {shape[2]}px in {s:.1f}s")
    _log(f"captured {len(widths)} buckets in {time.time() - t_all:.1f}s; "
         f"{torch.cuda.memory_reserved(device) / 2**30:.2f} GiB reserved")
    return captured


class _ProfileWindow:
    """A ``torch.profiler`` trace of the steps that take the processed
    batches from ``rc.profile_steps[0]`` to ``rc.profile_steps[1]``, written
    as a chrome trace under ``rc.profile_dir`` (the JAX package's
    ``jax.profiler`` window, ``singleshotpose_tpu/drivers.py:944-955``); a
    run that ends inside the window writes what it traced.  Every thread is
    profiled, so the loader's ``ssp.loader.batch`` spans on the prefetch
    thread have their own lane beside the step's ``ssp.train.*`` spans."""

    def __init__(self, rc: TrainRunConfig, device: torch.device):
        # data parallel: rank 0 traces its own steps
        self.directory = rc.profile_dir if _is_writer(rc.group) else None
        self.start, self.stop = rc.profile_steps
        self.device = device
        self._prof = None

    def before(self, processed: int) -> None:
        if self.directory and processed == self.start:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            every_thread = torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)
            self._prof = torch.profiler.profile(
                activities=acts, experimental_config=every_thread)
            self._prof.__enter__()

    def after(self, processed: int) -> None:
        if processed == self.stop:
            self.close()

    def close(self) -> None:
        if self._prof is None:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._prof.__exit__(None, None, None)
        os.makedirs(self.directory, exist_ok=True)
        path = os.path.join(self.directory,
                            f"train_steps_{self.start}_{self.stop}.json")
        self._prof.export_chrome_trace(path)
        self._prof = None
        _log(f"profile of steps {self.start}-{self.stop} written to {path}")


def _run_epoch_batches(epoch, loader, step, state, device, net, steps, scales,
                       nbatches, processed, log_every, history,
                       window: _ProfileWindow) -> None:
    """One epoch of batches: the scheduled lr per batch, the step, the stats
    read in chunks of ``log_every``, the profiler window; ``processed[0]``
    is kept current per batch, so a failure saves the latest state."""
    batch_size = net.batch
    pending = []     # (iter, device stats)
    for bidx, (images, labels) in enumerate(prefetch(loader)):
        lr = schedule_lr(net.learning_rate, processed[0], steps, scales)
        window.before(processed[0])
        stats = step(state, _to_device(images, device),
                     _to_device(labels, device), lr / batch_size, epoch)
        pending.append((epoch * int(np.ceil(nbatches)) + bidx, stats))
        processed[0] += 1
        window.after(processed[0])
        if len(pending) >= log_every:
            _drain_stats(pending, history, epoch)
            pending = []
    _drain_stats(pending, history, epoch)


def _eval_and_keep_best(datacfg, spec, state, rc, device, backupdir, history,
                        processed, best_acc) -> float:
    """The in-training eval of the model in memory: the curves to
    ``costs.npz``, and ``model.weights`` when the 2D accuracy is a new best
    (reference ``train.py:395-409``); the accuracy is the summary's
    ``rc.save_best_metric``.  Returns the best accuracy."""
    out_shape = (spec.net.test_width, spec.net.test_height)
    transfer = _resolve_eval_transfer(rc, _bank_bytes(
        _valid_split_frames(datacfg), out_shape, rc.eval_batch_size), device)
    summary = run_validation(datacfg, spec, model=state.model,
                             batch_size=rc.eval_batch_size,
                             num_workers=rc.num_workers,
                             compute_dtype=rc.compute_dtype, device=device,
                             transfer=transfer, group=rc.group)
    acc = summary[rc.save_best_metric]
    history["testing_iters"].append(processed)
    history["testing_accuracies"].append(acc)
    history["testing_errors_pixel"].append(summary["mean_err_2d"])
    history["testing_errors_angle"].append(summary["mean_err_angle"])
    writer = _is_writer(rc.group)
    if writer:
        np.savez(os.path.join(backupdir, "costs.npz"),
                 **{k: np.asarray(v) for k, v in history.items()})
    # as the JAX trainer compares (a NaN metric is no new best)
    if not acc > best_acc:
        return best_acc
    path = os.path.join(backupdir, "model.weights")
    _log(f"best model so far! save weights to {path}")
    # every rank gathers (a collective), the writer writes
    weights = _whole_weights(state, rc.group)
    if writer:
        W.save_weights(spec, weights, path, seen=state.seen)
    return acc


def _drain_stats(pending, history, epoch) -> None:
    """Read a chunk of queued device stats on the host (the first read
    waits for the device; the rest are ready) and log the last."""
    if not pending:
        return
    for it, s in pending:
        history["training_iters"].append(int(it))
        history["training_losses"].append(float(s["loss"]))
    it, s = pending[-1]
    _log(f"epoch {epoch} iter {int(it)}: loss {float(s['loss']):.4f} "
         f"(x {float(s['loss_x']):.3f} y {float(s['loss_y']):.3f} "
         f"conf {float(s['loss_conf']):.3f} cls {float(s['loss_cls']):.3f}) "
         f"nGT {int(s['nGT'])} correct {int(s['nCorrect'])} "
         f"proposals {int(s['nProposals'])}")


def _save_final_if_unsaved(spec: DarknetSpec, state: TrainState,
                           best_acc: float, backupdir: str, seen: int,
                           group: Optional[DPGroup] = None) -> None:
    """A run that never reached the eval cadence would end with no
    ``model.weights`` (the best-model rule only writes on a new best eval):
    write the final weights once, untouched when a best save happened.
    Data parallel: the writer writes; on a grid every rank gathers first
    (the same decision on every rank: the ranks' evals agree)."""
    if best_acc != -float("inf") or not backupdir:
        return
    weights = _whole_weights(state, group)
    if not _is_writer(group):
        return
    os.makedirs(backupdir, exist_ok=True)
    path = os.path.join(backupdir, "model.weights")
    _log(f"no eval ran; saving final weights to {path}")
    W.save_weights(spec, weights, path, seen=int(seen))
