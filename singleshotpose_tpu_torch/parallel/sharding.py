"""Data parallelism on ``torch.distributed``: the group, the batch shard,
the state broadcast and the collectives of the train step.

Mirrors ``singleshotpose_tpu/parallel/sharding.py`` at ``mp = 1``.  JAX
gets its data parallelism from GSPMD: a ``("data", "model")`` mesh, the
batch sharded over ``data``, and every collective emitted by XLA.  Here a
rank is a process holding a full replica, and the collectives are written
out — the same semantics, step for step:

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

Tensor parallelism (JAX's ``mp > 1``, output channels over ``model``) is
not ported: :func:`make_dp_group` refuses it (ROADMAP.md §1 item 3).
"""

from __future__ import annotations

import socket
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

__all__ = ["DPGroup", "make_dp_group", "shard_host_batch", "broadcast_",
           "all_reduce_sum_", "all_reduce_grads",
           "sync_sum", "all_gather_rows", "pad_rows", "free_port"]


class DPGroup:
    """The data-parallel group — the counterpart of ``make_mesh(dp, mp=1)``'s
    mesh: the process group (``pg``; None is the default group), this
    rank's index and the world size in it, the device its tensors live on,
    and the backend.  :func:`make_dp_group` makes one."""

    def __init__(self, device, pg: Optional[dist.ProcessGroup] = None):
        self.pg = pg
        self.rank = dist.get_rank(pg)
        self.world = dist.get_world_size(pg)
        self.device = torch.device(device)
        self.backend = dist.get_backend(pg)

    @property
    def gather_device(self) -> torch.device:
        """Where :func:`all_gather_rows` runs: gloo gathers host tensors
        (it takes CUDA tensors only for ``all_reduce`` and ``broadcast``),
        NCCL device ones."""
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def src(self) -> int:
        """The global rank of this group's rank 0 (the broadcast source)."""
        return 0 if self.pg is None else dist.get_global_rank(self.pg, 0)

    def barrier(self) -> None:
        """Every rank waits here for the others (an all-reduce of one value
        on the group's device, read back, so a CUDA rank waits for its
        stream too)."""
        t = torch.zeros(1, device=self.device)
        dist.all_reduce(t, group=self.pg)
        t.item()


def free_port() -> int:
    """A TCP port free on this host now (bound, then released: another
    process may take it before the rendezvous binds it — retry on
    ``EADDRINUSE``)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_dp_group(dp: int, mp: int = 1, *, device) -> DPGroup:
    """The data-parallel group over the default process group
    (``parallel/multihost.initialize_distributed`` initialises it), its
    tensors on ``device``.  ``dp`` must be the group's size.  With nothing
    initialised and ``dp`` 1, a group of one is made here
    (NCCL on a CUDA device, gloo on the CPU; a local TCP rendezvous):
    ``--dp 1`` runs every collective of the step on one rank.  ``mp > 1``
    (tensor parallelism) raises ``NotImplementedError``.  A CUDA
    ``device`` becomes this process's current device (NCCL's collectives
    run there)."""
    if mp != 1:
        raise NotImplementedError(
            f"mp={mp}: output-channel tensor parallelism is not ported to "
            "the PyTorch package (ROADMAP.md §1 item 3); data parallelism "
            "only (mp=1)")
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        if dp != 1:
            raise RuntimeError(
                f"dp={dp}: torch.distributed is not initialised (call "
                "parallel.multihost.initialize_distributed on every rank)")
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                                init_method=f"tcp://localhost:{free_port()}",
                                world_size=1, rank=0)
    group = DPGroup(device)
    if dp != group.world:
        raise ValueError(f"dp={dp} but the process group has {group.world} "
                         "ranks")
    return group


def _rows(n: int, group: DPGroup) -> slice:
    if n % group.world:
        raise ValueError(f"a batch of {n} does not split over "
                         f"{group.world} ranks")
    per = n // group.world
    return slice(group.rank * per, (group.rank + 1) * per)


def shard_host_batch(group: DPGroup, images, target):
    """This rank's contiguous rows of a global batch (numpy arrays or
    tensors), the rows JAX's ``shard_host_batch`` places on this rank's
    device.  The batch must split evenly."""
    rows = _rows(len(images), group)
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
