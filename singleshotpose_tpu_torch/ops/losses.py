"""Region loss, single object (and the class term of the multi-object one).

Mirrors ``singleshotpose_tpu/ops/losses.py``: the raw NHWC head → a scalar
loss and its stats, differentiable with autograd.  Loss algebra as there:

  * per-keypoint masked sum-squared error / 2, weighted by ``coord_scale``;
  * the confidence term weighted by ``conf_mask``;
  * with ``with_class_loss`` and more than one class, ``class_scale`` times
    the cross-entropy over responsible cells;
  * the confidence term counts only once ``epoch > pretrain_num_epochs``,
    selected with ``torch.where`` so that ``epoch`` can be a device scalar
    (a captured train step reads it from a tensor it refills each step).

Where the JAX package takes ``use_pallas`` and ``mesh``, the port has no
option: the tensors' device decides (the CUDA kernel of pass 1 on the card,
its plain version on the CPU).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple, Union

import torch

from .decode import split_activate
from .targets import BuiltTargets, build_targets

__all__ = ["RegionLossConfig", "region_loss", "activate_head"]


@dataclasses.dataclass(frozen=True)
class RegionLossConfig:
    """The defaults are the reference's single-object RegionLoss, which
    hard-codes coord/noobject/object scales 1/1/5 and threshold 0.6."""
    num_keypoints: int = 9
    num_classes: int = 1
    num_anchors: int = 1
    anchors: Tuple[float, ...] = ()
    coord_scale: float = 1.0
    noobject_scale: float = 1.0
    object_scale: float = 5.0
    class_scale: float = 1.0
    sil_thresh: float = 0.6
    pretrain_num_epochs: int = 15
    with_class_loss: bool = False   # True for the multi-object variant
    im_width: float = 640.0
    im_height: float = 480.0
    max_num_gt: int = 50

    @classmethod
    def single(cls, pretrain_num_epochs: int = 15, **kw) -> "RegionLossConfig":
        """Defaults of the single-object RegionLoss (``region_loss.py:81-93``).

        Note the reference *hard-codes* noobject_scale=1/object_scale=5 in the
        loss module and ignores the [region] block values for the driver-built
        loss (``train.py:335``); pass overrides to honor a cfg instead."""
        return cls(pretrain_num_epochs=pretrain_num_epochs, **kw)

    @classmethod
    def multi(cls, anchors: Tuple[float, ...], num_classes: int = 13,
              num_anchors: int = 5, pretrain_num_epochs: int = 15,
              **kw) -> "RegionLossConfig":
        """The multi-object loss: 13 classes, 5 anchors, the class term."""
        return cls(num_classes=num_classes, num_anchors=num_anchors,
                   anchors=anchors, with_class_loss=True,
                   pretrain_num_epochs=pretrain_num_epochs, **kw)


def activate_head(output: torch.Tensor, K: int, C: int, nA: int):
    """Split and activate the raw NHWC head with the decoder's
    :func:`~singleshotpose_tpu_torch.ops.decode.split_activate`.

    Returns (xs, ys, conf, cls_logits, pred_corners): xs/ys (B, S, K)
    in-cell offsets, conf (B, S), cls_logits (B, S, C), and pred_corners
    (B, S, 2K) normalized grid coordinates, detached (``stop_gradient`` in
    the JAX package).
    """
    B, H, W, _ = output.shape
    xs, ys, conf, cls_logits, grid_x, grid_y = split_activate(output, K, C, nA)
    px = (xs + grid_x[None, :, None]) / W
    py = (ys + grid_y[None, :, None]) / H
    pred_corners = torch.stack([px, py], dim=-1) \
        .reshape(B, nA * H * W, 2 * K).detach()
    return xs, ys, conf, cls_logits, pred_corners


def region_loss(output: torch.Tensor, target: torch.Tensor,
                epoch: Union[int, torch.Tensor], cfg: RegionLossConfig
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The region loss of a raw head (B, H, W, nA·(2K+1+C)) NHWC against
    padded labels (B, max_num_gt·(2K+3)).  ``epoch``, an int or a 0-dim
    tensor on the head's device, gates the confidence term.  Returns (loss,
    stats): the loss to differentiate, and the stats as detached device
    tensors (no host sync)."""
    K, C, nA = cfg.num_keypoints, cfg.num_classes, cfg.num_anchors
    B, H, W, _ = output.shape
    xs, ys, conf, cls_logits, pred_corners = activate_head(output.float(),
                                                           K, C, nA)
    bt: BuiltTargets = build_targets(
        pred_corners, target.float(), num_keypoints=K, num_anchors=nA,
        nH=H, nW=W, noobject_scale=cfg.noobject_scale,
        object_scale=cfg.object_scale, sil_thresh=cfg.sil_thresh,
        anchors=cfg.anchors, im_width=cfg.im_width, im_height=cfg.im_height,
        max_num_gt=cfg.max_num_gt)

    cm = bt.coord_mask[:, :, None]
    loss_x = cfg.coord_scale * 0.5 * torch.sum(cm * torch.square(xs - bt.txs))
    loss_y = cfg.coord_scale * 0.5 * torch.sum(cm * torch.square(ys - bt.tys))
    loss_conf = 0.5 * torch.sum(bt.conf_mask * torch.square(conf - bt.tconf))

    if cfg.with_class_loss and C > 1:
        logp = torch.log_softmax(cls_logits, dim=-1)
        picked = torch.gather(logp, -1, bt.tcls[:, :, None])[..., 0]
        loss_cls = cfg.class_scale * torch.sum(
            torch.where(bt.cls_mask, -picked, 0.0))
    else:
        loss_cls = torch.zeros((), device=output.device)

    base = loss_x + loss_y + loss_cls
    epoch = torch.as_tensor(epoch, device=output.device)
    loss = torch.where(epoch > cfg.pretrain_num_epochs, base + loss_conf, base)
    stats = {
        "loss": loss,
        "loss_x": loss_x,
        "loss_y": loss_y,
        "loss_conf": loss_conf,
        "loss_cls": loss_cls,
        "nGT": bt.num_gt,
        "nCorrect": bt.num_correct,
        "nProposals": (conf > 0.25).sum(),
    }
    return loss, {k: v.detach() for k, v in stats.items()}
