"""Validation driver: the reference's ``valid.py`` for a single object.

Mirrors ``run_validation`` of ``singleshotpose_tpu/drivers.py`` on the
``rgb`` transfer: the shared host ``PoseDataset``/``Loader`` feed u8 batches
at the spec's test size, the serving function (fold → bf16 forward → decode
→ best box) runs on the device, and the boxes of all batches meet the ground
truth in one batched PnP + metric pass.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from singleshotpose_tpu.config import data_config_from_options, read_data_cfg
from singleshotpose_tpu.data.pipeline import Loader, PoseDataset
from singleshotpose_tpu.data.prefetch import prefetch

from . import weights as W
from .evaluate import EvalContext, PoseErrors, accuracy_summary, pose_metrics
from .models.darknet import Darknet, DarknetSpec, fold_batchnorm
from .serving import make_serving_fn
from .zoo import _resolve_model

__all__ = ["run_validation"]


def _log(msg: str) -> None:
    print(f"{time.strftime('%Y-%m-%d %H:%M:%S')} {msg}", flush=True)


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
                   weightfile: str, *, batch_size: int = 16,
                   num_workers: int = 8,
                   compute_dtype=torch.bfloat16, device="cuda",
                   verbose: bool = True) -> Dict[str, float]:
    """Single-object eval (reference ``valid.py``): the 6D metric suite.

    ``weightfile`` is a darknet binary.  ``device`` is where the network
    and PnP run; it is used as given, and a CUDA device that is absent
    raises.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    dcfg = data_config_from_options(read_data_cfg(datacfg))
    spec = _resolve_model(modelcfg)
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
