"""Training core: darknet-convention SGD, the LR step schedule, the train step.

Mirrors ``singleshotpose_tpu/training.py``.  Optimizer semantics, torch SGD
with dampening 0 and no Nesterov, as the reference constructs it:

    d = grad + weight_decay · param
    buf = momentum · buf + d
    param = param − lr · buf

with the darknet conventions applied by ``drivers.run_training``:
``lr = schedule_lr(...) / batch`` and ``weight_decay = decay · batch``.
``torch.optim.SGD`` with those settings is that update (the tests hold it
against the JAX package's ``sgd_apply``).  Weight decay applies to every
parameter, the reference's behavior.

The step runs eagerly on the model's device and updates the state in place
(the torch idiom) instead of returning a new one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import torch

from .models.darknet import Darknet
from .ops.losses import RegionLossConfig, region_loss

__all__ = ["TrainState", "init_train_state", "schedule_lr", "make_train_step"]


@dataclasses.dataclass
class TrainState:
    """The train state: the model (parameters and running BN statistics),
    its SGD optimizer (momentum buffers, made at the first step) and
    ``seen``, the samples processed (the darknet header's ``seen``)."""
    model: Darknet
    optimizer: torch.optim.SGD
    seen: int = 0


def init_train_state(model: Darknet, *, weight_decay: float, momentum: float,
                     seen: int = 0) -> TrainState:
    """A fresh state around ``model``: SGD (dampening 0, no Nesterov) with
    ``weight_decay`` on every parameter.  The learning rate is set by the
    step."""
    opt = torch.optim.SGD(model.parameters(), lr=0.0, momentum=momentum,
                          dampening=0.0, weight_decay=weight_decay,
                          nesterov=False)
    return TrainState(model, opt, seen)


def schedule_lr(base_lr: float, processed_batches: float,
                steps: Sequence[float], scales: Sequence[float]) -> float:
    """Darknet step schedule (reference ``train.py:34-46``).

    ``steps`` are in batches (``run_training`` multiplies the cfg's epoch
    steps by the batches per epoch).  Scales apply cumulatively once
    ``processed_batches`` reaches each step; the walk stops at the first
    future step and right after a step equal to ``processed_batches``.
    Returns the darknet lr — divide by the batch size before applying it.
    """
    lr = base_lr
    for i, step in enumerate(steps):
        scale = scales[i] if i < len(scales) else 1.0
        if processed_batches >= step:
            lr = lr * scale
            if processed_batches == step:
                break
        else:
            break
    return lr


def make_train_step(loss_cfg: RegionLossConfig, *,
                    compute_dtype=torch.bfloat16,
                    fused_stem: bool = False) -> Callable:
    """The train step ``step(state, images, target, lr, epoch) -> stats``.

    ``images`` NHWC, uint8 (divided by 255 on the device) or float in
    [0, 1]; ``target`` (B, 50·(2K+3)); ``lr`` the learning rate already
    divided by the batch size; ``epoch`` gates the confidence term.  The
    step runs forward (training-mode BN), the region loss, backward and the
    SGD update, and adds the batch size to ``state.seen``, all in place on
    ``state``.  ``stats`` are device tensors (no host sync).
    ``fused_stem``: layers 0–1 through the fused train stem where the model
    admits it (``Darknet.forward``), as the JAX step takes it.
    """
    scale_u8 = {}

    def step(state: TrainState, images: torch.Tensor, target: torch.Tensor,
             lr: float, epoch: int) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        if not images.is_floating_point():
            # a device-tensor divisor keeps it a true division on the card,
            # where a Python-scalar divisor becomes a multiply by 1/255
            div = scale_u8.get(images.device)
            if div is None:
                div = scale_u8[images.device] = torch.full(
                    (), 255.0, device=images.device)
            images = images.float() / div
        model.train()
        head = model(images, compute_dtype, fused_stem)
        loss, stats = region_loss(head, target, epoch, loss_cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        state.seen += images.shape[0]
        return stats

    return step
