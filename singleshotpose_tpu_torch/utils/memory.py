"""Device-memory budget accounting shared by the device-resident data banks
and the in-training eval-transfer policy.

The port's counterpart of ``singleshotpose_tpu/utils/memory.py``.  Two
subsystems park u8 corpora in device memory — the eval bank
(``data/eval_bank.py``) and the single-object frame bank
(``data/device_bank.py``) — and can collide with the parameters and
activations mid-run.  Every consumer preflights through
:func:`check_hbm_budget`, so an over-budget placement fails at once with an
actionable message instead of an out-of-memory error minutes into training.
"""
from __future__ import annotations

from typing import Optional

import torch

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


def check_hbm_budget(need_bytes: int, what: str,
                     headroom: int = DEFAULT_HEADROOM, device=None) -> None:
    """Raise ``RuntimeError`` if placing ``need_bytes`` on ``device`` would
    leave less than ``headroom`` free.  No-op where accounting is
    unavailable (the CPU)."""
    free = hbm_free_bytes(device)
    if free is None or need_bytes + headroom <= free:
        return
    raise RuntimeError(
        f"{what} needs {need_bytes >> 20} MB device memory plus "
        f"{headroom >> 20} MB activation headroom, but only "
        f"{free >> 20} MB HBM is free. Options: evict cached eval banks "
        "(singleshotpose_tpu_torch.data.eval_bank.clear_cache()), use a "
        "smaller split, or switch to a host loader backend "
        "(--loader_backend python / --eval_transfer rgb).")
