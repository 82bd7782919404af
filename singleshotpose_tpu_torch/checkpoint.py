"""Full train-state checkpoints, in place of the JAX package's Orbax ones.

Mirrors ``singleshotpose_tpu/checkpoint.py``: the darknet ``.weights`` file
keeps only the weights and ``seen``; a checkpoint here keeps the whole
train state, so a resumed run continues exactly where it stopped:

  * the model's ``state_dict`` (parameters and running BN statistics);
  * the optimizer's ``state_dict`` (SGD makes its momentum buffers at the
    first step, so they live there, not in the model);
  * ``seen`` and the step (processed batches).

Layout: ``directory/<step>.pt``, each written to a temp file in the same
directory and moved into place with ``os.replace``, so a crash never leaves
a partial checkpoint under a step's name.  The newest ``max_to_keep`` stay.

Data parallel (``group``): the ranks hold the same bytes, so rank 0 alone
writes, and every rank then meets the others at a barrier, so none reads
or resumes from a step before it is on disk; every rank restores.

A data × model grid (``group.mp > 1``; the counterpart of JAX's
``OrbaxCheckpointer`` saving a sharded state): each rank holds its slices
of the split convs, so the model group of data coordinate 0 gathers the
state whole (``training.gather_train_state``) and its rank at model
coordinate 0 — the run's writer — writes it, in the format above; the
barrier spans the grid.  A checkpoint is always whole: a grid's loads in
one process and one process's on a grid.  ``restore`` loads it into a whole
model; the caller then splits it (``training.shard_train_state``), the
order JAX restores and places a state in.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import List, Optional

import torch
import torch.distributed as dist

from .parallel.sharding import DPGroup
from .training import TrainState, gather_train_state

__all__ = ["Checkpointer", "latest_step"]

_NAME = re.compile(r"^(\d+)\.pt$")


class Checkpointer:
    """Versioned train-state checkpoints under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 group: Optional[DPGroup] = None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.group = group        # a parallel.sharding.DPGroup, or None
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The steps saved, oldest first."""
        return _steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: TrainState) -> str:
        """Write ``state`` as step ``step`` (replacing one of the same step),
        then delete all but the newest ``max_to_keep``.  Returns the path.
        Under a group: the writer (data and model coordinate 0) writes —
        on a grid the state its model group gathers; every rank of the grid
        calls this —, then every rank of the grid waits at a barrier."""
        g = self.group
        if g is None:
            return self._write(step, state)
        if g.mp > 1 and g.rank == 0:
            # the data peers hold the same slices: one model group gathers
            state = gather_train_state(g, state)
        if g.leader:
            self._write(step, state)
        g.barrier()
        return self._path(step)

    def save_on_failure(self, step: int, state: TrainState) -> Optional[str]:
        """The save of a run that raised: the writer writes ``state`` as
        step ``step`` and no rank waits for another.  Returns the path where
        this rank wrote, else None.

        On a grid every rank calls this after its failure, and the model
        group of data coordinate 0 first agrees over its rescue group
        (``DPGroup.rescue_pg``, a gloo group no step uses, so a collective
        the failure left unfinished cannot pair with this exchange):
        each of its ranks must have stopped at the same step and ``seen``
        (else ``RuntimeError``: their slices are of different states).  It
        then gathers the state over that group and the writer writes it.  A
        peer that never arrives (gone, or still in a collective of the
        step) fails the exchange after the default group's collective
        timeout, with ``RuntimeError``; the caller logs it and goes on with
        the original error."""
        g = self.group
        if g is None:
            return self._write(step, state)
        if g.mp == 1 or state.model.model_shards == 1:
            return self._write(step, state) if g.leader else None
        if g.rank != 0:
            return None          # a data peer of the writer's slices
        if g.rescue_pg is None:
            raise RuntimeError("the grid has no rescue group: make it with "
                               "parallel.sharding.make_dp_group")
        rescue = DPGroup(g.device, g.rescue_pg, model_pg=g.rescue_pg)
        mine = torch.tensor([step, state.seen], dtype=torch.int64)
        every = [torch.empty_like(mine) for _ in range(g.mp)]
        dist.all_gather(every, mine, group=g.rescue_pg)
        if any(not torch.equal(e, mine) for e in every):
            raise RuntimeError(
                "the model ranks stopped at different steps (step, seen): "
                f"{[e.tolist() for e in every]}; their slices are of "
                "different states, so none is saved")
        whole = gather_train_state(rescue, state)
        return self._write(step, whole) if g.leader else None

    def _write(self, step: int, state: TrainState) -> str:
        payload = {"model": state.model.state_dict(),
                   "optimizer": state.optimizer.state_dict(),
                   "seen": int(state.seen), "step": int(step)}
        fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=self.directory)
        os.close(fd)
        try:
            torch.save(payload, tmp)
            os.replace(tmp, self._path(step))
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        return self._path(step)

    def restore(self, state: TrainState, step: Optional[int] = None) -> int:
        """Load step ``step`` (the latest when None) into ``state`` in place:
        the model's tensors, the optimizer's momentum buffers and ``seen``.
        Returns the step.  Raises ``FileNotFoundError`` when there is none.
        ``state`` is whole (on a grid too: every rank restores the whole
        state, then ``training.shard_train_state`` keeps its slices)."""
        if state.model.model_shards != 1:
            raise ValueError(
                "restore loads a whole state: restore into a whole model, "
                "then split it with training.shard_train_state")
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.directory}")
        device = next(state.model.parameters()).device
        payload = torch.load(self._path(step), map_location=device,
                             weights_only=True)
        state.model.load_state_dict(payload["model"])
        state.optimizer.load_state_dict(payload["optimizer"])
        state.seen = int(payload["seen"])
        return int(payload["step"])


def _steps(directory: str) -> List[int]:
    found = (_NAME.match(f) for f in os.listdir(directory))
    return sorted(int(m.group(1)) for m in found if m)


def latest_step(directory: str) -> Optional[int]:
    """Latest checkpoint step under ``directory`` (None if none exist, or
    no such directory), as ``singleshotpose_tpu/checkpoint.py:
    latest_step``."""
    if not os.path.isdir(directory):
        return None
    steps = _steps(directory)
    return steps[-1] if steps else None
