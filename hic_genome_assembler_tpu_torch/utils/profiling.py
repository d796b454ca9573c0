"""Structured timing + device profiling.

Replaces the reference's bracket-and-print time.time() scattering
(SURVEY.md §5) with:

* ``timer(name)`` — context manager accumulating wall-clock per stage
  into a process-wide registry (printed summary on demand);
* ``device_trace(logdir)`` — torch.profiler trace of the host and, where
  a card is visible, its kernels, written as a Chrome trace into
  ``logdir`` (open in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

_REGISTRY: Dict[str, list] = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        _REGISTRY[name][0] += elapsed
        _REGISTRY[name][1] += 1


_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Accumulate an event counter (printed alongside the timers)."""
    _COUNTERS[name] += n


def summary() -> Dict[str, dict]:
    return {
        name: {"total_s": round(total, 4), "calls": calls}
        for name, (total, calls) in sorted(_REGISTRY.items())
    }


def counters() -> Dict[str, int]:
    return dict(sorted(_COUNTERS.items()))


def reset() -> None:
    _REGISTRY.clear()
    _COUNTERS.clear()


def print_summary() -> None:
    for name, stats in summary().items():
        print(f"[timer] {name}: {stats['total_s']}s over {stats['calls']} call(s)")
    for name, n in counters().items():
        print(f"[counter] {name}: {n}")


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[None]:
    """torch.profiler trace of the enclosed block, written to
    ``logdir/trace_<pid>.json`` (Chrome trace format)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))

