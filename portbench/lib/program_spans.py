"""The program's own spans (``singleshotpose_tpu_torch.tracing``), which it
records only while a torch profiler records: so in a traced run exactly
the window's.  A program without that module records none."""

from __future__ import annotations

from typing import Optional


def mean_host_ms(r: dict, name: str) -> Optional[float]:
    """Mean host milliseconds a span ``name`` of the serve's traced window,
    or None where the run was not traced, the program records no spans, or
    none of that name was recorded."""
    if r.get("kind") != "serve" or r.get("trace") is None:
        return None
    try:
        from singleshotpose_tpu_torch import tracing
    except ImportError:
        return None
    s = tracing.summary().get(name)
    if not s or not s["count"]:
        return None
    return 1e3 * s["seconds"] / s["count"]
