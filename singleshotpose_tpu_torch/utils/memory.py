"""Device-memory budget accounting shared by the device-resident data banks
and the in-training eval-transfer policy.

The port's counterpart of ``singleshotpose_tpu/utils/memory.py``.  Two
subsystems park u8 corpora in device memory — the eval bank
(``data/eval_bank.py``) and the single-object frame bank
(``data/device_bank.py``) — and can collide with the parameters and
activations mid-run.  Every consumer preflights through
:func:`check_hbm_budget`, so an over-budget placement fails at once with an
actionable message instead of an out-of-memory error minutes into training.

Under data parallelism every rank parks its own bank, and ranks may share a
card (two gloo ranks on one card, the card checks' layout): the preflight
then counts every bank and every rank's headroom that lands on the card,
against the free memory all of them read before any of them placed.
"""
from __future__ import annotations

import socket
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

__all__ = ["hbm_free_bytes", "check_hbm_budget"]

# headroom kept free for parameters, activations and workspaces after a
# bank placement
DEFAULT_HEADROOM = 1 << 30


def hbm_free_bytes(device=None) -> Optional[int]:
    """Free device memory of ``device`` (default: the current CUDA device
    when there is one), or ``None`` off CUDA — on the CPU the banks live in
    host RAM and the budget question disappears.

    ``torch.cuda.mem_get_info`` counts the caching allocator's cached but
    unused blocks as used; this process can reuse them, so they are added
    back — all of them, though a CUDA graph's private pool keeps its own, so
    after a capture the figure is an upper bound.  Memory other processes
    hold stays counted as used."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    free, _total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - \
        torch.cuda.memory_allocated(device)
    return int(free + cached)


def card_key(device) -> Optional[str]:
    """Which physical card ``device`` is, the same string in every process
    that uses it (the host and the card's UUID), or None off CUDA."""
    device = torch.device(device) if device is not None else None
    if device is None or device.type != "cuda":
        return None
    props = torch.cuda.get_device_properties(device)
    card = getattr(props, "uuid", None) or getattr(props, "pci_bus_id",
                                                    device.index)
    return f"{socket.gethostname()}/{card}"


def shared_budget_failures(entries: List[Tuple[Optional[str], Optional[int]]],
                           need_bytes: int, headroom: int
                           ) -> List[Tuple[str, int, int]]:
    """The cards a placement of ``need_bytes`` on every rank overfills:
    ``entries`` holds each rank's (:func:`card_key`, free bytes); the ranks
    of one card need ``n · (need_bytes + headroom)`` of the least free
    memory any of them read.  Returns [(card, ranks, free bytes)]."""
    cards = {}
    for key, free in entries:
        if key is None or free is None:
            continue
        n, low = cards.get(key, (0, free))
        cards[key] = (n + 1, min(low, free))
    return [(key, n, low) for key, (n, low) in sorted(cards.items())
            if n * (need_bytes + headroom) > low]


def check_hbm_budget(need_bytes: int, what: str,
                     headroom: int = DEFAULT_HEADROOM, device=None,
                     group=None) -> None:
    """Raise ``RuntimeError`` if placing ``need_bytes`` on ``device`` would
    leave less than ``headroom`` free.  No-op where accounting is
    unavailable (the CPU).

    ``group`` (a ``parallel.sharding.DPGroup``): every rank of its grid is
    about to place its own ``need_bytes`` and calls this with it.  The
    ranks exchange their card and free memory first, so each card is
    charged for every rank on it (:func:`shared_budget_failures`), and every
    rank raises when any card is overfilled, so none is left waiting for
    a peer that gave up."""
    free = hbm_free_bytes(device)
    pg = None if group is None else group.grid_pg
    if group is not None and dist.get_world_size(pg) > 1:
        entries = [None] * dist.get_world_size(pg)
        dist.all_gather_object(entries, (card_key(device), free), group=pg)
        failed = shared_budget_failures(entries, need_bytes, headroom)
        if not failed:
            return
        card, n, free = failed[0]
        need_bytes, headroom = n * need_bytes, n * headroom
        what = f"{what} on {n} ranks sharing {card}"
    elif free is None or need_bytes + headroom <= free:
        return
    raise RuntimeError(
        f"{what} needs {need_bytes >> 20} MB device memory plus "
        f"{headroom >> 20} MB activation headroom, but only "
        f"{free >> 20} MB HBM is free. Options: evict cached eval banks "
        "(singleshotpose_tpu_torch.data.eval_bank.clear_cache()), use a "
        "smaller split, or switch to a host loader backend "
        "(--loader_backend python / --eval_transfer rgb).")
