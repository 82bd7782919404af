"""Spans of the program's phases, recorded while a torch profiler records
in the process, and nothing otherwise.

    with span("ssp.serve.copy_in"):
        ...

A span is named ``ssp.<layer>.<phase>``.  While a ``torch.profiler``
records, a span opens a ``torch.profiler.record_function`` range of its
name, so it lands in the profiler's trace on the profiler's own clock,
beside the device's kernels and copies, and appends a :class:`Record` of
its name, start and end (``time.perf_counter_ns``) to this module's list,
from any thread, without a lock.  Otherwise ``span`` returns one shared
no-op context after a single check of
``torch.autograd.profiler._is_profiler_enabled``: the process-wide flag
every torch profiler sets while it records (the C-level
``torch._C._autograd._profiler_enabled()`` answers for its own thread only,
and costs more).  A profiler traces another thread's ranges only when it
profiles all threads (``_ExperimentalConfig(profile_all_threads=True)``);
the records are kept for every thread either way.

The records grow for as long as a profiler records; :func:`reset` clears
them.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, NamedTuple

import torch
from torch.autograd import profiler as _profiler

__all__ = ["Record", "span", "records", "reset", "summary"]


class Record(NamedTuple):
    name: str
    start_ns: int
    end_ns: int


_OFF = contextlib.nullcontext()
_RECORDS: List[Record] = []


class _Span:
    __slots__ = ("name", "start", "_range")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        self._range = torch.profiler.record_function(self.name)
        self._range.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.perf_counter_ns()
        self._range.__exit__(*exc)
        _RECORDS.append(Record(self.name, self.start, end))


def span(name: str):
    """A context that records the phase ``name`` while a torch profiler
    records in the process, and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name)


def records() -> List[Record]:
    """Every finished span since the last :func:`reset`, in the order they
    ended."""
    return _RECORDS


def reset() -> None:
    _RECORDS.clear()


def summary() -> Dict[str, Dict[str, float]]:
    """For each span name: ``count`` and ``seconds`` (host seconds in
    all)."""
    out: Dict[str, Dict[str, float]] = {}
    for r in list(_RECORDS):
        s = out.setdefault(r.name, {"count": 0, "seconds": 0.0})
        s["count"] += 1
        s["seconds"] += (r.end_ns - r.start_ns) / 1e9
    return out
