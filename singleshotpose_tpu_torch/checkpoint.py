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
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import List, Optional

import torch

from .training import TrainState

__all__ = ["Checkpointer", "latest_step"]

_NAME = re.compile(r"^(\d+)\.pt$")


class Checkpointer:
    """Versioned train-state checkpoints under ``directory``."""

    def __init__(self, directory: str, max_to_keep: int = 3, group=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        if group is not None and group.mp > 1:
            raise ValueError(
                f"checkpoints of a state split over a dp×mp grid (mp="
                f"{group.mp}) are not ported yet: a rank holds a slice of "
                "the state (ROADMAP.md §1 item 3)")
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

    def save(self, step: int, state: TrainState, barrier: bool = True) -> str:
        """Write ``state`` as step ``step`` (replacing one of the same step),
        then delete all but the newest ``max_to_keep``.  Returns the path.
        Under a group: rank 0 writes, then every rank waits at a barrier
        (``barrier=False``: rank 0 writes and no rank waits)."""
        if self.group is not None:
            if self.group.rank == 0:
                self._write(step, state)
            if barrier:
                self.group.barrier()
            return self._path(step)
        return self._write(step, state)

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
        Returns the step.  Raises ``FileNotFoundError`` when there is none."""
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
