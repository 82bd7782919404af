"""Training core: darknet-convention SGD, the LR step schedule, the train step,
and the train step captured as CUDA graphs, one per multi-scale bucket.

Mirrors ``singleshotpose_tpu/training.py``.  Optimizer semantics, torch SGD
with dampening 0 and no Nesterov, as the reference constructs it (JAX's
``sgd_apply``):

    d = grad + weight_decay · param
    buf = momentum · buf + d
    param = param − lr · buf

with the darknet conventions applied by ``drivers.run_training``:
``lr = schedule_lr(...) / batch`` and ``weight_decay = decay · batch``.
:func:`sgd_update` runs it with ``lr`` a 0-dim device tensor, so no step
reads a value back to the host; the momentum buffers live in the
``torch.optim.SGD`` state, where a checkpoint keeps them.  Weight decay
applies to every parameter, the reference's behavior, unless
``init_train_state(decay_bn_bias=False)`` exempts the BN affine terms and
the biases (:func:`no_decay_mask_for`).

The step runs eagerly on the model's device and updates the state in place
(the torch idiom) instead of returning a new one.  :func:`capture_train_step`
records it once per input shape as a ``torch.cuda.CUDAGraph``, the
counterpart of the JAX package's one compiled program per bucket; a
data-parallel step over NCCL, on a data × model grid too, is captured with
its collectives.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .data.device_augment import INV255
from .models.darknet import ConvBlock, Darknet, apply_folded, fold_batchnorm
from .ops.losses import RegionLossConfig, region_loss
from .parallel.sharding import (DPGroup, all_reduce_grads, all_reduce_sum_,
                                broadcast_, broadcast_model_, gather_model)
from .tracing import span

__all__ = ["TrainState", "init_train_state", "no_decay_mask_for",
           "shard_train_state", "gather_train_state", "gather_model_whole",
           "schedule_lr",
           "sgd_update", "make_train_step", "make_eval_forward",
           "CapturedTrainStep", "capture_train_step"]

Scalar = Union[float, int, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """The train state: the model (parameters and running BN statistics),
    its SGD optimizer (the container of the momentum buffers, made as zeros
    at the first step) and ``seen``, the samples processed (the darknet
    header's ``seen``)."""
    model: Darknet
    optimizer: torch.optim.SGD
    seen: int = 0


def no_decay_mask_for(model: Darknet) -> Dict[str, bool]:
    """Each parameter's name → whether weight decay skips it under
    ``decay_bn_bias=False``: True for the BN scale and bias and the conv and
    connected biases (JAX's ``"scale"``, ``"bias"``, ``"b"``,
    ``singleshotpose_tpu/training.py:99-104``; the torch names holding
    ``.bn`` or ``.bias``, reference ``train.py:383-386``), False for the
    weights."""
    return {name: name.rsplit(".", 1)[-1] in ("scale", "bias")
            for name, _ in model.named_parameters()}


def init_train_state(model: Darknet, *, weight_decay: float, momentum: float,
                     seen: int = 0, decay_bn_bias: bool = True) -> TrainState:
    """A fresh state around ``model``: SGD (dampening 0, no Nesterov) with
    ``weight_decay`` on every parameter.  The learning rate is the step's
    argument (:func:`sgd_update`).

    ``decay_bn_bias=False``: the parameters :func:`no_decay_mask_for` marks
    go into a second parameter group with weight decay 0 — where JAX's
    ``make_train_step(decay_bn_bias=False)`` went (JAX keeps the decay in
    the step, the port in the optimizer's groups, which every step and
    checkpoint carry).  A net with several [yolo] heads does not train yet
    (``ValueError``): the region loss and its targets know one grid."""
    model.spec.require_one_head("training")
    if decay_bn_bias:
        groups = [{"params": list(model.parameters())}]
    else:
        skip = no_decay_mask_for(model)
        named = list(model.named_parameters())
        groups = [{"params": [p for n, p in named if not skip[n]]},
                  {"params": [p for n, p in named if skip[n]],
                   "weight_decay": 0.0}]
    opt = torch.optim.SGD(groups, lr=0.0, momentum=momentum,
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


def _momentum_buffers(optimizer: torch.optim.SGD,
                      params: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The momentum buffers of ``params``, made as zeros where there are none
    yet, as the JAX package starts them (``momentum·0 + d == d``)."""
    bufs = []
    for p in params:
        st = optimizer.state[p]
        if st.get("momentum_buffer") is None:
            st["momentum_buffer"] = torch.zeros_like(p)
        bufs.append(st["momentum_buffer"])
    return bufs


@torch.no_grad()
def shard_train_state(group: DPGroup, state: TrainState) -> TrainState:
    """Rank 0's train state on every rank of ``group``, in place (the
    counterpart of JAX's ``parallel/sharding.shard_train_state``, which
    places every leaf on the mesh): the parameters, the BN running
    statistics, the momentum buffers (made as zeros first where there are
    none yet, which the first step would do) and ``seen``, broadcast on a
    flat buffer per dtype.  Returns ``state``.

    On a data × model grid (``group.mp > 1``) ``state`` is whole on every
    rank: rank 0's reaches its model group, then each data group, and
    every rank then keeps its output channels of each split conv
    (``Darknet.keep_model_shard``: the weight, the BN terms and running
    statistics, the bias) and of their momentum buffers."""
    model = state.model
    if group.mp > 1 and model.model_shards != 1:
        raise ValueError("shard_train_state takes a whole state; this one "
                         f"is split over {model.model_shards} model ranks")
    params = list(model.parameters())
    seen = torch.tensor([int(state.seen)], dtype=torch.int64,
                        device=group.device)
    live = [*(t.data for t in params), *model.buffers(),
            *_momentum_buffers(state.optimizer, params), seen]
    if group.mp > 1:
        broadcast_model_(live, group)
    broadcast_(live, group)
    state.seen = int(seen.item())
    if group.mp > 1:
        for p, rows in model.keep_model_shard(group):
            st = state.optimizer.state[p]
            st["momentum_buffer"] = st["momentum_buffer"][rows].clone()
    return state


def _split(model: Darknet, key: str) -> bool:
    """Whether the state-dict entry ``key`` (``<layer>.<tensor>``) belongs
    to a conv split over the model axis."""
    block = getattr(model, key.split(".", 1)[0])
    return isinstance(block, ConvBlock) and block.model_shards > 1


def _whole(model: Darknet, group: DPGroup, key: str,
           t: torch.Tensor) -> torch.Tensor:
    """The state-dict entry ``key`` of a split ``model`` whole: gathered
    over the model group where its conv is split, else a copy."""
    return gather_model(t, group) if _split(model, key) else t.clone()


@torch.no_grad()
def gather_model_whole(group: DPGroup, model: Darknet) -> Darknet:
    """A model split over ``group``'s model axis, whole: a new model on the
    same device whose split tensors are the model group's slices
    concatenated in model-rank order (bit for bit) — what ``model.weights``
    is written from.  Every rank of the model group must call it.  A whole
    model is returned as it is."""
    if model.model_shards == 1:
        return model
    full = Darknet(model.spec, device=next(model.parameters()).device)
    full.load_state_dict({k: _whole(model, group, k, v)
                          for k, v in model.state_dict().items()})
    return full


@torch.no_grad()
def gather_train_state(group: DPGroup, state: TrainState) -> TrainState:
    """The whole train state of a state split over ``group``'s model axis,
    the same on every rank: the model whole (:func:`gather_model_whole`),
    an SGD optimizer with the same parameter groups and hyperparameters
    whose momentum buffers are gathered likewise, and ``seen``.  Every rank
    of the model group must call it.  A whole state is returned as it
    is."""
    model = state.model
    if model.model_shards == 1:
        return state
    full = gather_model_whole(group, model)
    names = {p: n for n, p in model.named_parameters()}
    params = dict(full.named_parameters())
    opt = torch.optim.SGD([
        {**{k: v for k, v in g.items() if k != "params"},
         "params": [params[names[p]] for p in g["params"]]}
        for g in state.optimizer.param_groups])
    for name, p in model.named_parameters():
        buf = state.optimizer.state[p].get("momentum_buffer")
        if buf is not None:
            opt.state[params[name]]["momentum_buffer"] = \
                _whole(model, group, name, buf)
    return TrainState(full, opt, state.seen)


def sgd_update(optimizer: torch.optim.SGD, lr: Scalar) -> None:
    """One darknet SGD step on the parameters that have a gradient, in place
    (``singleshotpose_tpu/training.py:sgd_apply``), with the momentum and
    weight decay of ``optimizer``'s groups and ``lr`` a float or a 0-dim
    tensor on the parameters' device: foreach ops only, so nothing is read
    back to the host and a CUDA graph can record it.  A group with weight
    decay 0 takes the gradient itself, as JAX's masked ``sgd_apply`` does."""
    for group in optimizer.param_groups:
        params = [p for p in group["params"] if p.grad is not None]
        if not params:
            continue
        bufs = _momentum_buffers(optimizer, params)
        with torch.no_grad():
            grads = [p.grad for p in params]
            d = grads if group["weight_decay"] == 0 else \
                torch._foreach_add(grads, params, alpha=group["weight_decay"])
            torch._foreach_mul_(bufs, group["momentum"])
            torch._foreach_add_(bufs, d)
            torch._foreach_sub_(params, torch._foreach_mul(bufs, lr))


def _device_scalar(x: Scalar, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """``x`` as a 0-dim tensor on ``device``: a tensor as it is, a number by
    a fill on the device (a host copy would wait for the stream)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full((), x, dtype=dtype, device=device)


def make_train_step(loss_cfg: RegionLossConfig, *,
                    compute_dtype=torch.bfloat16,
                    fused_stem: bool = False,
                    group: Optional[DPGroup] = None) -> Callable:
    """The train step ``step(state, images, target, lr, epoch) -> stats``.

    ``images`` NHWC, uint8 (scaled to [0, 1] on the device as the JAX
    package's compiled step scales it: times f32(1/255), the multiply XLA
    makes of its ``/ 255.0``) or float in [0, 1]; ``target`` (B, 50·(2K+3)); ``lr`` the learning rate already
    divided by the batch size and ``epoch``, which gates the confidence
    term, each a number or a 0-dim tensor on the images' device.  The step
    runs forward (training-mode BN), the region loss, backward and
    :func:`sgd_update`, and adds the batch size to ``state.seen``, all in
    place on ``state``.  ``stats`` are device tensors (no host sync).
    ``fused_stem``: layers 0–1 through the fused train stem where the model
    admits it (``Darknet.forward``), as the JAX step takes it.

    ``group``: a data-parallel step (the JAX step on a ``make_mesh(dp)``
    mesh), ``images`` and ``target`` this rank's rows of the global batch.
    BN is synchronised over the group, the gradients are summed over it
    before the update (darknet's loss is a sum, so this is the global
    batch's gradient; ``lr`` and the weight decay stay the global batch's,
    as the drivers set them), the stats are summed too (the logged loss is
    the global one) and ``seen`` grows by the global batch.  The state must
    start equal on every rank (:func:`shard_train_state`);
    every rank then holds the same bytes after each step.

    ``group`` a data × model grid (``mp > 1``; JAX's step on a
    ``make_mesh(dp, mp)`` mesh): the state is split over the model axis
    (:func:`shard_train_state`) and ``images``/``target`` are the data
    rank's rows, the same on every rank of its model group.  The forward
    gathers each split conv's channels over the model group; the loss,
    K2 and the targets are computed alike by the model group; BN, the
    gradient sum, the stats sum and ``seen`` follow the data group only.
    A replicated parameter's summed gradient is then model rank 0's on
    every model rank (``broadcast_model_``).  Data peers hold the same
    bytes after each step, and so do model peers for every replicated
    tensor.
    """
    scale_u8 = {}

    def step(state: TrainState, images: torch.Tensor, target: torch.Tensor,
             lr: Scalar, epoch: Scalar) -> Dict[str, torch.Tensor]:
        model, opt = state.model, state.optimizer
        dev = images.device
        if not images.is_floating_point():
            # f32(1/255) on the device (XLA compiles the JAX step's
            # ``u8 / 255.0`` into a multiply by it), held here: a CUDA graph
            # of the step reads it
            scale = scale_u8.get(dev)
            if scale is None:
                scale = scale_u8[dev] = torch.full((), INV255, device=dev)
            images = images.float() * scale
        model.train()
        head = model(images, compute_dtype, fused_stem, group)
        loss, stats = region_loss(
            head, target, _device_scalar(epoch, torch.int64, dev), loss_cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if group is not None:
            all_reduce_grads(model.parameters(), group)
            if group.mp > 1:
                broadcast_model_(
                    [p.grad for n, p in model.named_parameters()
                     if p.grad is not None and not _split(model, n)], group)
            all_reduce_sum_(list(stats.values()), group)
        sgd_update(opt, _device_scalar(lr, torch.float32, dev))
        state.seen += images.shape[0] * (1 if group is None else group.world)
        return stats

    step.group = group
    return step


def make_eval_forward(model: Darknet, *, compute_dtype=torch.bfloat16,
                      folded: bool = False) -> Callable:
    """The inference forward ``fwd(images) -> raw head`` (decode
    separately; ``singleshotpose_tpu/training.py:154``), ``images`` NHWC
    float in [0, 1], without gradients.  ``folded=False``: the module in
    eval mode (running BN statistics; its mode is restored after);
    ``folded=True``: the BN-folded serving forward
    (``models.darknet.apply_folded`` over ``fold_batchnorm`` of the model's
    current parameters), whose stem is K1 on a card in bf16."""
    def fwd(images: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            if folded:
                return apply_folded(model.spec, fold_batchnorm(model), images,
                                    compute_dtype=compute_dtype)
            was_training = model.training
            model.eval()
            try:
                return model(images, compute_dtype)
            finally:
                model.train(was_training)

    return fwd


def _set(static: torch.Tensor, value: Scalar) -> None:
    if isinstance(value, torch.Tensor):
        static.copy_(value)
    else:
        static.fill_(value)


class CapturedTrainStep:
    """A train step replayed from CUDA graphs, one per images shape, with
    the eager step's signature ``(state, images, target, lr, epoch) ->
    stats`` (:func:`capture_train_step` builds it).

    Each call copies its arguments into the graphs' static inputs on the
    current stream, replays the graph of the images' shape, adds the batch
    (the global batch under data parallelism) to ``state.seen`` and returns
    a clone of the graph's stats, which the next replay overwrites: the
    spans ``ssp.train.copy_in``, ``ssp.train.replay`` and
    ``ssp.train.stats_clone`` while a torch profiler records.
    ``replays`` counts the replays; the kernels'
    own ``launches`` counters ran once per graph, at its capture.
    ``capture_seconds``: for each images shape captured, the host seconds
    its warm-up steps and capture took.  Any other state, images shape or
    dtype, or target shape raises.
    """

    def __init__(self, step: Callable, state: TrainState,
                 graphs: Dict[Tuple[int, ...], tuple], target: torch.Tensor,
                 lr: torch.Tensor, epoch: torch.Tensor,
                 capture_seconds: Dict[Tuple[int, ...], float]):
        # the graphs read tensors that only ``step`` holds (its u8
        # scale): freed, their memory would be reused under the graphs
        self._step = step
        self._state = state
        self._graphs = graphs          # images shape -> (graph, images, stats)
        self._target, self._lr, self._epoch = target, lr, epoch
        group = getattr(step, "group", None)
        self._world = 1 if group is None else group.world
        self.capture_seconds = capture_seconds
        self.replays = 0

    def __call__(self, state: TrainState, images: torch.Tensor,
                 target: torch.Tensor, lr: Scalar,
                 epoch: Scalar) -> Dict[str, torch.Tensor]:
        if state is not self._state:
            raise ValueError("this step was captured on another train state")
        entry = self._graphs.get(tuple(images.shape))
        if entry is None or images.dtype != entry[1].dtype:
            raise ValueError(
                f"no graph captured for images {tuple(images.shape)} "
                f"{images.dtype}; captured: {sorted(self._graphs)}")
        if target.shape != self._target.shape:
            raise ValueError(f"target {tuple(target.shape)} != the captured "
                             f"{tuple(self._target.shape)}")
        graph, static_images, stats = entry
        with span("ssp.train.copy_in"):
            static_images.copy_(images)
            self._target.copy_(target)
            _set(self._lr, lr)
            _set(self._epoch, epoch)
        with span("ssp.train.replay"):
            graph.replay()
        self.replays += 1
        state.seen += images.shape[0] * self._world
        with span("ssp.train.stats_clone"):
            return {k: v.clone() for k, v in stats.items()}


# eager steps on a side stream before each capture: they build the kernels'
# libraries, cuDNN's plans, the step's cached device constants and, for a
# data-parallel step, NCCL's communicators (each made at its first
# collective: the data group's, and on a grid the model group's), none of
# which may happen inside a capture
_WARMUP_STEPS = 2


def capture_train_step(step: Callable, state: TrainState,
                       widths: Sequence[int], batch: int, label_dim: int,
                       image_dtype: torch.dtype = torch.uint8
                       ) -> CapturedTrainStep:
    """``step`` (from :func:`make_train_step`) recorded as one CUDA graph
    per width: images (batch, w, w, 3) of ``image_dtype`` (u8, or f32 for
    the batches ``device_synth`` makes on the card), target (batch,
    label_dim), lr and epoch 0-dim tensors — the counterpart of the JAX
    package's ``_precompile_buckets`` (``singleshotpose_tpu/drivers.py:
    905-930``), which compiles the step once per multi-scale bucket.

    Before each capture the step runs ``_WARMUP_STEPS`` times on a side
    stream on zero inputs; the state's parameters, BN running statistics
    and momentum buffers (made as zeros first) are copied before the first
    and written back after the last capture, so the warm-up does not move
    the state, as JAX warms on a throwaway zero state.  The graphs share one
    memory pool: they are replayed one at a time on one stream, each reads
    only the state, its static inputs and what it writes itself (its
    gradients too: each capture allocates its own ``.grad`` tensors), and
    its stats are cloned out right after its replay.  The graphs bind the
    state's tensors, so capture after any checkpoint restore
    (``optimizer.load_state_dict`` replaces the momentum buffers).

    A data-parallel ``step`` over an NCCL group is captured collectives and
    all: each graph records the sync-BN all-reduces of the forward and the
    backward, the flat gradient all-reduce, the stats' all-reduce, K2 on
    the rank's rows and the SGD, so a replay is one data-parallel step of
    this rank (every rank captures the same widths in the same order, and
    replays in lockstep; ``batch`` is the rank's rows).  ProcessGroupNCCL
    runs each collective on its own stream joined to the capturing one by
    events, which the graph records; the warm-up steps make the
    communicator.  Nothing on the step's path reads a value back to the
    host.  A gloo group's collectives run on the host and cannot be
    recorded: its step raises.

    On a data × model grid (``group.mp > 1``, the state split by
    :func:`shard_train_state`) a graph records, in the eager step's order:
    the forward's channel gathers over the model group (conv_1's gathered
    weight, scale and bias for K3–K6 among them), the sync-BN all-reduces
    over the data group, forward and backward, the input-gradient
    all-reduces of each split conv's backward over the model group, the
    flat gradient all-reduce, the broadcast of the replicated gradients
    from model rank 0, the stats' all-reduce, K2 on the data rank's rows
    and the SGD of this rank's split state.  Every collective is
    synchronous, so the graph is one chain and every rank runs its
    collectives in one order.  The warm-up steps make both communicators,
    the data group's (of one rank at dp 1) and the model group's; the
    split parameters, momentum buffers and BN running statistics are
    among the tensors written back.  A replay adds the global batch (the
    rows times the data ranks) to ``seen``.  Free the captured step before
    ``torch.distributed.destroy_process_group``: with a live graph of a
    grid's communicators ProcessGroupNCCL's destroy waited forever.

    Needs the state on a CUDA device; a failed capture raises.
    """
    group = getattr(step, "group", None)
    if group is not None and group.backend != "nccl":
        raise ValueError(
            f"a data-parallel train step over a {group.backend} group "
            "cannot be captured: its collectives run on the host, outside "
            "any CUDA graph; run it eagerly, or over NCCL")
    device = next(state.model.parameters()).device
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph needs a CUDA device; the state is on "
                         f"{device}")
    if image_dtype not in (torch.uint8, torch.float32):
        raise ValueError(f"images are u8 or f32, not {image_dtype}")
    params = list(state.model.parameters())
    live = [*params, *state.model.buffers(),
            *_momentum_buffers(state.optimizer, params)]
    saved = [t.detach().clone() for t in live]
    seen = state.seen
    target = torch.zeros((batch, label_dim), device=device)
    lr = torch.zeros((), device=device)
    epoch = torch.zeros((), dtype=torch.int64, device=device)
    side = torch.cuda.Stream(device)
    pool = torch.cuda.graph_pool_handle()
    # NCCL's watchdog thread queries CUDA events while this thread captures,
    # which CUDA's global capture mode forbids in every thread
    mode = "global" if group is None else "thread_local"
    graphs, seconds = {}, {}
    try:
        for w in widths:
            t0 = time.perf_counter()
            images = torch.zeros((batch, w, w, 3), dtype=image_dtype,
                                 device=device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(_WARMUP_STEPS):
                    step(state, images, target, lr, epoch)
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode=mode):
                stats = step(state, images, target, lr, epoch)
            graphs[tuple(images.shape)] = (graph, images, stats)
            seconds[tuple(images.shape)] = time.perf_counter() - t0
    finally:
        with torch.no_grad():
            for t, s in zip(live, saved):
                t.copy_(s)
        state.seen = seen
    return CapturedTrainStep(step, state, graphs, target, lr, epoch, seconds)
