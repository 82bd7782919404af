"""Multi-process data-parallel scale-out on ``torch.distributed``.

Mirrors ``singleshotpose_tpu/parallel/multihost.py``.  A torch rank is a
process with its own card (or, for tests, its own CPU threads), so JAX's
multi-host recipe is the only data-parallel recipe here:

  1. every rank calls :func:`initialize_distributed`,
  2. each rank feeds only its shard of every batch
     (:func:`process_local_indices` partitions the dataset; the Loader runs
     per rank exactly as in one process),
  3. the train step all-reduces the gradients, the BN statistics and the
     loss's stats (``parallel/sharding.py``); nothing else moves.

JAX's ``global_batch`` has no counterpart: a rank never assembles the
global batch.  Its rows stay on its device, and the only cross-rank values
are the sums the step all-reduces.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize_distributed", "process_local_indices"]


def initialize_distributed(backend: Optional[str] = None,
                           init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           device=None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> None:
    """``torch.distributed.init_process_group`` wrapper; a no-op at a world
    of at most one rank (``world_size``, else the ``WORLD_SIZE``
    environment variable, else one).

    ``backend``: ``nccl`` when ``device`` is a CUDA device, ``gloo``
    otherwise, unless one is passed (two ranks that share one card take
    ``gloo``: NCCL refuses them).  ``init_method``: a ``tcp://host:port``
    rendezvous, or ``env://`` (the default: ``MASTER_ADDR``/``MASTER_PORT``,
    ``RANK`` and ``WORLD_SIZE`` as ``torchrun`` sets them).  A failed
    rendezvous raises.  ``timeout``: how long a collective waits for the
    other ranks before it raises (torch's default when None).
    """
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return
    if rank is None:
        rank = int(os.environ["RANK"])
    device = torch.device("cpu" if device is None else device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def process_local_indices(n_samples: int, *, process_id: int,
                          num_processes: int) -> np.ndarray:
    """This rank's contiguous shard of dataset indices.

    Equal-sized shards (truncating the remainder) so every rank contributes
    the same per-batch count — a requirement of the step's sync-BN, whose
    statistics average the ranks' equal shares."""
    per = n_samples // num_processes
    return np.arange(process_id * per, (process_id + 1) * per)
