"""Drivers: the reference's ``valid.py`` and ``train.py`` for a single object.

Mirrors ``run_validation`` and ``run_training`` of
``singleshotpose_tpu/drivers.py``.

Validation, on the ``rgb`` transfer: the host ``PoseDataset``/
``Loader`` feed u8 batches at the spec's test size, the serving function
(fold → bf16 forward → decode → best box) runs on the device, and the boxes
of all batches meet the ground truth in one batched PnP + metric pass.

Training: the host ``Loader`` (multi-scale, u8) feeds the eager train
step through pinned host memory; the reference's behaviours are kept — the
step LR schedule in batches, the pretrain confidence gate, an eval every
``eval_every`` epochs after ``eval_after``, the best 2D accuracy saved as
darknet ``model.weights``, ``costs.npz`` curves — and full-state
checkpoints (``checkpoint.py``) give a real resume.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from . import weights as W
from .checkpoint import Checkpointer
from .config import data_config_from_options, read_data_cfg
from .data.pipeline import SINGLE_SCHEDULE, Loader, PoseDataset
from .data.prefetch import prefetch
from .evaluate import EvalContext, PoseErrors, accuracy_summary, pose_metrics
from .models.darknet import Darknet, DarknetSpec, fold_batchnorm
from .ops.losses import RegionLossConfig
from .serving import make_serving_fn
from .training import (TrainState, init_train_state, make_train_step,
                       schedule_lr)
from .utils.labels import get_all_files
from .zoo import _resolve_model

__all__ = ["run_validation", "run_training", "TrainRunConfig",
           "loss_config_from_spec"]


def _log(msg: str) -> None:
    print(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}", flush=True)


def _resolve_device(device) -> torch.device:
    """``device`` as given; a CUDA device that is absent raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def _eval_pass(spec: DarknetSpec, model: Darknet, loader, ctx: EvalContext, *,
               compute_dtype, device) -> Tuple[PoseErrors, Dict]:
    """Boxes for every batch (launched as the prefetch thread decodes the
    next batch), then one metric pass.  Returns (PoseErrors, artifacts with
    ``corners_gt``, ``corners_pr`` (pixels) and ``image_idx``; empty when
    there is no ground truth)."""
    K = spec.num_keypoints
    serve = make_serving_fn(spec, fold_batchnorm(model), pick=("best",),
                            compute_dtype=compute_dtype)
    pending = [(serve(images), labels) for images, labels in prefetch(loader)]

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
            all_pr.append(boxes[bidx][:, :2 * K])
            image_idx.append(img_base + bidx)
        img_base += B

    errors = PoseErrors()
    if not all_gt:
        return errors, {}
    scale = np.tile(np.array([ctx.im_width, ctx.im_height], np.float32), K)
    gt = (np.concatenate(all_gt) * scale).reshape(-1, K, 2)
    pr = (np.concatenate(all_pr) * scale).reshape(-1, K, 2)
    errors.extend(pose_metrics(gt, pr, ctx, device=device))
    return errors, {"corners_gt": gt, "corners_pr": pr,
                    "image_idx": np.concatenate(image_idx)}


def run_validation(datacfg: str, modelcfg: Union[str, DarknetSpec],
                   weightfile: Optional[str] = None, *,
                   model: Optional[Darknet] = None, batch_size: int = 16,
                   num_workers: int = 8,
                   compute_dtype=torch.bfloat16, device="cuda",
                   verbose: bool = True) -> Dict[str, float]:
    """Single-object eval (reference ``valid.py``): the 6D metric suite.

    The network is ``weightfile``, a darknet binary, or an in-memory
    ``model`` (as the JAX driver takes ``params=``/``batch_stats=``; the
    trainer's eval passes its model), which must be on ``device``.
    ``device`` is where the network and PnP run; it is used as given, and a
    CUDA device that is absent raises.
    """
    device = _resolve_device(device)
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    spec = _resolve_model(modelcfg)
    if model is None:
        if weightfile is None:
            raise ValueError("run_validation needs a weightfile or a model")
        model = Darknet(spec, device=device)
        model.load_state_dict(W.load_weights(spec, weightfile)[1])

    ctx = EvalContext.from_data_config(dcfg)
    ds = PoseDataset(dcfg.valid, train=False,
                     num_keypoints=spec.num_keypoints)
    loader = Loader(ds, batch_size, shuffle=False, schedule=None,
                    fixed_shape=(spec.net.test_width, spec.net.test_height),
                    num_workers=num_workers, drop_last=False, out_uint8=True)
    if verbose:
        _log(f"   Testing {dcfg.name}...")
        _log(f"   Number of test samples: {len(ds)}")
    errors, _ = _eval_pass(spec, model, loader, ctx,
                           compute_dtype=compute_dtype, device=device)
    summary = accuracy_summary(errors, ctx.diam)
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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def loss_config_from_spec(spec: DarknetSpec, *, pretrain_num_epochs: int,
                          im_width: float, im_height: float) -> RegionLossConfig:
    """Single-object loss config: topology from the spec's [region] block,
    scales as the reference's loss module really uses them — the config's
    defaults, coord/object/noobject 1/5/1 and threshold 0.6, whatever the
    cfg says (``singleshotpose_tpu/drivers.py:67-95``)."""
    r = spec.region
    return RegionLossConfig(
        num_keypoints=spec.num_keypoints, num_classes=r.classes,
        num_anchors=r.num, anchors=r.anchors,
        pretrain_num_epochs=pretrain_num_epochs,
        im_width=float(im_width), im_height=float(im_height))


@dataclasses.dataclass
class TrainRunConfig:
    """Run settings beyond the reference CLI (defaults = the reference)."""
    eval_every: int = 10           # train.py:395 (epoch % 10)
    eval_after: int = 15           # train.py:395 (epoch > 15)
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

    Returns {"state": the final TrainState, "best_acc": float,
    "history": dict of the training and testing curves}.
    """
    rc = run_cfg or TrainRunConfig()
    device = _resolve_device(rc.device)
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

    gen = torch.Generator().manual_seed(rc.seed)
    if initweightfile:
        _, init = W.load_weights_until_last(spec, initweightfile, gen)
        model = Darknet(spec, device=device)
        model.load_state_dict(init)
    else:
        model = Darknet(spec, generator=gen, device=device)
    state = init_train_state(model, weight_decay=net.decay * batch_size,
                             momentum=net.momentum)
    ckpt = Checkpointer(rc.checkpoint_dir) if rc.checkpoint_dir else None
    if rc.resume and ckpt is not None and ckpt.latest_step() is not None:
        ckpt.restore(state)
        _log(f"resumed from {rc.checkpoint_dir} at seen={state.seen}")
    processed = [state.seen // batch_size]     # current, for the crash save
    init_epoch = state.seen // max(nsamples, 1)

    loss_cfg = loss_config_from_spec(spec,
                                     pretrain_num_epochs=pretrain_num_epochs,
                                     im_width=dcfg.width, im_height=dcfg.height)
    step = make_train_step(loss_cfg, compute_dtype=rc.compute_dtype,
                           fused_stem=_resolve_fused_stem(rc, device))
    bg_files = get_all_files(rc.bg_dir) if os.path.isdir(rc.bg_dir) else []
    ds = PoseDataset(dcfg.train, train=True, bg_file_names=bg_files,
                     num_keypoints=spec.num_keypoints)
    loader = Loader(ds, batch_size, schedule=SINGLE_SCHEDULE, seen=state.seen,
                    num_workers=rc.num_workers, seed=rc.seed, out_uint8=True)

    history: Dict[str, List] = {"training_iters": [], "training_losses": [],
                                "testing_iters": [], "testing_accuracies": [],
                                "testing_errors_pixel": [],
                                "testing_errors_angle": []}
    best_acc = -float("inf")
    try:
        for epoch in range(init_epoch, max_epochs):
            lr = schedule_lr(net.learning_rate, processed[0], steps, scales)
            _log(f"epoch {epoch}, processed {epoch * nsamples} samples, "
                 f"lr {lr:f}")
            _run_epoch_batches(epoch, loader, step, state, device, net, steps,
                               scales, nbatches, processed, rc.log_every,
                               history)
            if ckpt is not None and rc.checkpoint_every_epochs and \
                    epoch % rc.checkpoint_every_epochs == 0:
                ckpt.save(processed[0], state)
            if epoch % rc.eval_every == 0 and epoch > rc.eval_after:
                best_acc = _eval_and_keep_best(datacfg, spec, state, rc,
                                               device, backupdir, history,
                                               processed[0], best_acc)
    except BaseException:
        # keep what was trained: a full-state save at the current batch
        # before the error goes on
        if ckpt is not None:
            _log("checkpoint on failure")
            try:
                ckpt.save(processed[0], state)
            except Exception as e:      # the original error matters more
                _log(f"checkpoint on failure failed: {e!r}")
        raise
    if ckpt is not None:
        ckpt.save(processed[0], state)
    _save_final_if_unsaved(spec, state, best_acc, backupdir,
                           processed[0] * batch_size)
    return {"state": state, "best_acc": best_acc, "history": history}


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch to ``device``; to a card through pinned memory, without
    waiting for the copy."""
    t = torch.from_numpy(a)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _run_epoch_batches(epoch, loader, step, state, device, net, steps, scales,
                       nbatches, processed, log_every, history) -> None:
    """One epoch of batches: the scheduled lr per batch, the step, the stats
    read in chunks of ``log_every``; ``processed[0]`` is kept current per
    batch, so a failure saves the latest state."""
    batch_size = net.batch
    pending = []     # (iter, device stats)
    for bidx, (images, labels) in enumerate(prefetch(loader)):
        lr = schedule_lr(net.learning_rate, processed[0], steps, scales)
        stats = step(state, _to_device(images, device),
                     _to_device(labels, device), lr / batch_size, epoch)
        pending.append((epoch * int(np.ceil(nbatches)) + bidx, stats))
        processed[0] += 1
        if len(pending) >= log_every:
            _drain_stats(pending, history, epoch)
            pending = []
    _drain_stats(pending, history, epoch)


def _eval_and_keep_best(datacfg, spec, state, rc, device, backupdir, history,
                        processed, best_acc) -> float:
    """The in-training eval of the model in memory: the curves to
    ``costs.npz``, and ``model.weights`` when the 2D accuracy is a new best
    (reference ``train.py:395-409``).  Returns the best accuracy."""
    summary = run_validation(datacfg, spec, model=state.model,
                             batch_size=rc.eval_batch_size,
                             num_workers=rc.num_workers,
                             compute_dtype=rc.compute_dtype, device=device)
    acc = summary["acc_2d_proj"]
    history["testing_iters"].append(processed)
    history["testing_accuracies"].append(acc)
    history["testing_errors_pixel"].append(summary["mean_err_2d"])
    history["testing_errors_angle"].append(summary["mean_err_angle"])
    np.savez(os.path.join(backupdir, "costs.npz"),
             **{k: np.asarray(v) for k, v in history.items()})
    if acc <= best_acc:
        return best_acc
    path = os.path.join(backupdir, "model.weights")
    _log(f"best model so far! save weights to {path}")
    W.save_weights(spec, state.model.state_dict(), path, seen=state.seen)
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
                           best_acc: float, backupdir: str, seen: int) -> None:
    """A run that never reached the eval cadence would end with no
    ``model.weights`` (the best-model rule only writes on a new best eval):
    write the final weights once, untouched when a best save happened."""
    if best_acc != -float("inf") or not backupdir:
        return
    os.makedirs(backupdir, exist_ok=True)
    path = os.path.join(backupdir, "model.weights")
    _log(f"no eval ran; saving final weights to {path}")
    W.save_weights(spec, state.model.state_dict(), path, seen=int(seen))
