"""Data and tensor parallelism on ``torch.distributed``: the group (a data
× model grid), the batch shard, the state broadcast and the collectives of
the train step.

Mirrors ``singleshotpose_tpu/parallel/sharding.py``.  JAX gets its
parallelism from GSPMD: a ``("data", "model")`` mesh, the batch sharded
over ``data``, conv output channels over ``model``, and every collective
emitted by XLA.  Here a rank is a process, and the collectives are written
out — the same semantics, step for step.  Over the data axis:

  * the loss is darknet's *sum*, so the data-parallel gradient is the
    **sum** of the ranks' gradients (:func:`all_reduce_grads`; DDP's mean
    would scale it by 1/world), one flat buffer per dtype;
  * BatchNorm is synchronised: each batch statistic covers the global
    batch (``models/layers.batch_norm_train`` and the fused stem all-reduce
    their sums through :func:`sync_sum`, whose backward all-reduces the
    gradient, so the cross-rank terms reach every rank);
  * the ranks start from one state (``training.shard_train_state``
    broadcasts rank 0's through :func:`broadcast_`) and stay bit-identical:
    every value that reaches the parameters is an all-reduced sum, the same
    bytes on every rank.

Tensor parallelism (JAX's ``make_mesh(dp, mp)`` with ``mp > 1``): the
ranks form a data × model grid, global rank ``r`` at data coordinate
``r // mp`` and model coordinate ``r % mp`` (JAX's ``reshape(dp, mp)``).
A conv whose filter count divides by ``mp`` holds only its model
coordinate's output channels (:func:`shards_channels`, JAX's
``_conv_w_spec``/``_chan_spec``): the weight's rows, its BN terms and
running statistics, and their momentum.  Its input is replicated over the
model group; :func:`copy_to_model` (identity; backward: the sum over the
model group, each rank holding its filters' share of the input gradient)
enters the conv and :func:`gather_channels` (the channels in model-rank
order; backward: the rank's own slice, no sum) leaves it.  Everything
between two gathers is computed alike by every model rank, so the
gradients of the sharded tensors are whole per rank, and only the data
group sums them.  A replicated parameter's gradient is summed over the
data group and then taken from model rank 0 (:func:`broadcast_model_`),
so model peers hold the same bytes even where a backward kernel is not
bitwise deterministic.

Every collective of the step is synchronous (no ``async_op``): over NCCL
each joins the caller's stream before the step goes on, so a CUDA graph of
the step (``training.capture_train_step``) records them as one chain, in
one order on every rank — two communicators whose kernels ran
concurrently in different orders on different ranks could deadlock.
"""

from __future__ import annotations

import datetime
import socket
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["DPGroup", "make_dp_group", "batch_rows", "shard_host_batch",
           "broadcast_", "collective_timeout",
           "all_reduce_sum_", "all_reduce_grads",
           "sync_sum", "all_gather_rows", "pad_rows", "free_port",
           "shards_channels", "channel_rows", "copy_to_model",
           "gather_model", "gather_channels", "broadcast_model_"]


class DPGroup:
    """The data-parallel group — the counterpart of ``make_mesh(dp, mp)``'s
    mesh: the process group (``pg``; None is the default group), this
    rank's index and the world size in it, the device its tensors live on,
    and the backend.  :func:`make_dp_group` makes one.

    ``rank``, ``world`` and ``pg`` are always the **data** axis: the data
    coordinate, ``dp`` and the group of the ranks that share this rank's
    model coordinate (sync-BN, the gradient and stats sums, the rows a
    rank takes and the eval's row gather read them).  ``model_pg``: on a
    data × model grid the group of the ranks that share this rank's data
    coordinate (the channel gathers), ``mp`` its size and ``model_rank``
    this rank's model coordinate; without one ``mp`` is 1, ``model_rank``
    0 and ``model_pg`` None.  :attr:`grid_pg` spans every rank of both
    axes.  ``rescue_pg``: at data coordinate 0 of a grid, a gloo group of
    the model group's ranks that no step uses (the failure save gathers
    over it, ``Checkpointer.save_on_failure``), else None."""

    def __init__(self, device, pg: Optional[dist.ProcessGroup] = None, *,
                 model_pg: Optional[dist.ProcessGroup] = None,
                 rescue_pg: Optional[dist.ProcessGroup] = None):
        self.pg = pg
        self.rescue_pg = rescue_pg
        self.rank = dist.get_rank(pg)
        self.world = dist.get_world_size(pg)
        self.model_pg = model_pg
        self.mp = 1 if model_pg is None else dist.get_world_size(model_pg)
        self.model_rank = 0 if model_pg is None else dist.get_rank(model_pg)
        self.device = torch.device(device)
        self.backend = dist.get_backend(pg)

    @property
    def gather_device(self) -> torch.device:
        """Where :func:`all_gather_rows` and :func:`gather_model` run: gloo
        gathers host tensors (it takes CUDA tensors only for ``all_reduce``
        and ``broadcast``), NCCL device ones."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    @property
    def leader(self) -> bool:
        """Whether this is the rank at data and model coordinate 0: the one
        that writes a run's files."""
        return self.rank == 0 and self.model_rank == 0

    @property
    def grid_pg(self) -> Optional[dist.ProcessGroup]:
        """The group of every rank of both axes: the data group without a
        model axis, else the default process group (a grid covers it,
        :func:`make_dp_group`)."""
        return self.pg if self.model_pg is None else None

    @property
    def leader_rank(self) -> int:
        """The global rank of the :attr:`leader`: :attr:`grid_pg`'s rank
        0 (the source of the decisions the leader makes for the grid)."""
        pg = self.grid_pg
        return 0 if pg is None else dist.get_global_rank(pg, 0)

    def src(self) -> int:
        """The global rank of this group's rank 0 (the broadcast source)."""
        return 0 if self.pg is None else dist.get_global_rank(self.pg, 0)

    def barrier(self) -> None:
        """Every rank of the grid waits here for the others (an all-reduce
        of one value over :attr:`grid_pg` on the group's device, read back,
        so a CUDA rank waits for its stream too)."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.grid_pg)
        t.item()


def collective_timeout() -> Optional[datetime.timedelta]:
    """How long a collective of the default process group waits for the
    other ranks before it raises (``initialize_distributed``'s
    ``timeout``), or None where its backend does not say."""
    pg = dist.distributed_c10d._get_default_group()
    for dev in ("cpu", "cuda"):
        try:
            return pg._get_backend(torch.device(dev)).options._timeout
        except (AttributeError, RuntimeError):
            continue
    return None


def free_port() -> int:
    """A TCP port free on this host now (bound, then released: another
    process may take it before the rendezvous binds it — retry on
    ``EADDRINUSE``)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_dp_group(dp: int, mp: int = 1, *, device) -> DPGroup:
    """The group over the default process group
    (``parallel/multihost.initialize_distributed`` initialises it), its
    tensors on ``device``: data parallel at ``mp`` 1, else the data ×
    model grid of ``make_mesh(dp, mp)`` — global rank ``r`` at data
    coordinate ``r // mp`` and model coordinate ``r % mp``.  ``dp · mp``
    must be the process group's size.  With nothing initialised and ``dp``
    and ``mp`` 1, a group of one is made here (NCCL on a CUDA device, gloo
    on the CPU; a local TCP rendezvous): ``--dp 1`` runs every collective
    of the step on one rank.  A CUDA ``device`` becomes this process's
    current device (NCCL's collectives run there; NCCL takes one rank a
    card, so two ranks on one card take gloo).

    On a grid every rank makes every data group (the ranks of one model
    coordinate) and then every model group (the ranks of one data
    coordinate), in that order, as ``dist.new_group`` requires, and then
    the gloo rescue group of data coordinate 0 (``DPGroup.rescue_pg``);
    each waits as long as the default group (:func:`collective_timeout`)."""
    if dp < 1 or mp < 1:
        raise ValueError(f"dp={dp}, mp={mp}: each is at least 1")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if dp * mp != 1:
            raise RuntimeError(
                f"dp={dp}, mp={mp}: torch.distributed is not initialised "
                "(call parallel.multihost.initialize_distributed on every "
                "rank)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    size = dist.get_world_size()
    if dp * mp != size:
        raise ValueError(f"dp={dp} × mp={mp} = {dp * mp} but the process "
                         f"group has {size} ranks")
    if mp == 1:
        return DPGroup(device)
    rank = dist.get_rank()
    timeout = collective_timeout()
    data = [dist.new_group([d * mp + m for d in range(dp)], timeout=timeout)
            for m in range(mp)]
    model = [dist.new_group([d * mp + m for m in range(mp)], timeout=timeout)
             for d in range(dp)]
    rescue = dist.new_group(list(range(mp)), backend="gloo", timeout=timeout)
    return DPGroup(device, data[rank % mp], model_pg=model[rank // mp],
                   rescue_pg=rescue if rank < mp else None)


def batch_rows(n: int, group: DPGroup) -> slice:
    """This rank's contiguous rows of a global batch of ``n``: the data
    coordinate's ``n / dp`` (JAX's ``batch_sharding`` over ``data``; model
    peers take the same rows).  The batch must split evenly."""
    if n % group.world:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{group.world} ranks")
    per = n // group.world
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_host_batch(group: DPGroup, images, target):
    """This rank's contiguous rows of a global batch (numpy arrays or
    tensors), the rows JAX's ``shard_host_batch`` places on this rank's
    device.  The batch must split evenly."""
    rows = batch_rows(len(images), group)
    return images[rows], target[rows]


def _by_dtype(tensors: Iterable[torch.Tensor]) -> Dict[tuple, List[torch.Tensor]]:
    out: Dict[tuple, List[torch.Tensor]] = {}
    for t in tensors:
        out.setdefault((t.dtype, t.device), []).append(t)
    return out


def _flat_collective(tensors: Sequence[torch.Tensor], op) -> None:
    """``op(flat)`` on one flat buffer per (dtype, device) of ``tensors``,
    written back in place."""
    for ts in _by_dtype(tensors).values():
        if len(ts) == 1 and ts[0].is_contiguous():
            op(ts[0])
            continue
        flat = _flatten_dense_tensors(ts)
        op(flat)
        for t, v in zip(ts, _unflatten_dense_tensors(flat, ts)):
            t.copy_(v)


def all_reduce_sum_(tensors: Sequence[torch.Tensor], group: DPGroup) -> None:
    """Sum ``tensors`` over the ranks, in place: one all-reduce per dtype
    and device, on a flat buffer.  Every rank gets the same bytes."""
    _flat_collective(tensors, lambda t: dist.all_reduce(t, group=group.pg))


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.Tensor], group: DPGroup) -> None:
    """The data-parallel gradient: each parameter's ``.grad`` becomes the
    sum over the ranks (darknet's loss is a sum over the batch, so the
    global batch's gradient is the sum of the shards'; JAX's
    ``sharding.py:13-16``).  Parameters without a gradient are skipped —
    the same ones on every rank, since every rank runs the same graph."""
    all_reduce_sum_([p.grad for p in params if p.grad is not None], group)


def broadcast_(tensors: Sequence[torch.Tensor], group: DPGroup) -> None:
    """Rank 0's ``tensors`` on every rank, in place: one broadcast per dtype
    and device, on a flat buffer."""
    src = group.src()
    _flat_collective(tensors,
                     lambda t: dist.broadcast(t, src, group=group.pg))


class _SyncSum(torch.autograd.Function):
    """``y = Σ_ranks x``; its backward is the same all-reduce of the
    incoming gradient: every rank's loss depends on ``y``, so the global
    loss's gradient with respect to one rank's ``x`` is the sum over the
    ranks of theirs with respect to ``y``."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group.pg)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group.pg)
        return g, None


def sync_sum(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """The sum of ``x`` over the ranks, differentiable (the sync-BN
    statistics take it).  Every rank must call it, in the same order."""
    return _SyncSum.apply(x, group)


def all_gather_rows(t: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """The ranks' ``t`` (the same shape on each) stacked along a new leading
    axis in rank order, on :attr:`DPGroup.gather_device`:
    (world, *t.shape)."""
    local = t.to(group.gather_device).contiguous()
    parts = [torch.empty_like(local) for _ in range(group.world)]
    dist.all_gather(parts, local, group=group.pg)
    return torch.stack(parts)


def pad_rows(a, multiple: int):
    """``a`` (numpy or a tensor) with zero rows appended up to a multiple of
    ``multiple`` rows."""
    pad = (-len(a)) % multiple
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)])


# ---------------------------------------------------------------------------
# the model axis: output channels split over the model group
# ---------------------------------------------------------------------------


def shards_channels(filters: int, mp: int) -> bool:
    """Whether a conv of ``filters`` output channels is split over a model
    axis of ``mp`` ranks: when ``mp > 1`` divides it
    (``singleshotpose_tpu/parallel/sharding.py:_conv_w_spec``); any other
    conv, and every connected layer, is replicated."""
    return mp > 1 and filters % mp == 0


def channel_rows(filters: int, group: DPGroup) -> slice:
    """This rank's output channels of a split conv,
    ``[m·O/mp, (m+1)·O/mp)`` for model coordinate ``m``."""
    per = filters // group.mp
    return slice(group.model_rank * per, (group.model_rank + 1) * per)


def _nhwc(t: torch.Tensor) -> torch.Tensor:
    """A 4-d NCHW tensor as its NHWC view (contiguous for channels_last
    memory, the model's), so the channels are the last axis."""
    return t.permute(0, 2, 3, 1) if t.dim() == 4 else t


def _nchw(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 3, 1, 2) if t.dim() == 4 else t


class _CopyToModel(torch.autograd.Function):
    """Identity; its backward sums the incoming gradient over the model
    group (in f32, then back to its dtype): a rank's conv holds a share of
    the filters, so its input gradient is that share of the whole."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g32 = _nhwc(g).to(torch.float32, copy=True).contiguous()
        dist.all_reduce(g32, group=ctx.group.model_pg)
        return _nchw(g32).to(g.dtype), None


def copy_to_model(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """The input of a split conv: ``x`` itself (replicated over the model
    group), whose gradient is summed over the model group in the
    backward.  Every rank of the model group must call it, in the same
    order."""
    return _CopyToModel.apply(x, group)


def _all_gather_model(t: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """The model group's ``t`` (the same shape on each) concatenated along
    the last axis in model-rank order, on ``t``'s device; gloo gathers a
    host copy (it gathers no CUDA tensors)."""
    local = t.to(group.gather_device).contiguous()
    parts = [torch.empty_like(local) for _ in range(group.mp)]
    dist.all_gather(parts, local, group=group.model_pg)
    return torch.cat(parts, dim=-1).to(t.device)


class _GatherModel(torch.autograd.Function):
    """The model group's shards along the last axis; the backward keeps the
    rank's own slice of the incoming gradient, with no sum: downstream of
    the gather every model rank computes the same function, so the
    gradient that arrives is already the whole one."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.rows = slice(group.model_rank * x.shape[-1],
                         (group.model_rank + 1) * x.shape[-1])
        return _all_gather_model(x, group)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.rows], None


def gather_model(t: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """A split tensor whole: the model group's shards of its leading axis
    (a conv's OIHW weight, a per-channel vector) in model-rank order,
    differentiable (the backward keeps this rank's rows)."""
    moved = t.movedim(0, -1)
    return _GatherModel.apply(moved, group).movedim(-1, 0).contiguous()


def gather_channels(x: torch.Tensor, group: DPGroup) -> torch.Tensor:
    """A split conv's NCHW output (this rank's channels) with every
    channel, in model-rank order, differentiable (the backward keeps this
    rank's channels).  Every rank of the model group must call it, in the
    same order."""
    return _nchw(_GatherModel.apply(_nhwc(x), group))


def broadcast_model_(tensors: Sequence[torch.Tensor], group: DPGroup) -> None:
    """Model rank 0's ``tensors`` on every rank of the model group, in
    place: one broadcast per dtype and device, on a flat buffer."""
    src = dist.get_global_rank(group.model_pg, 0)
    _flat_collective(tensors,
                     lambda t: dist.broadcast(t, src, group=group.model_pg))
