"""Structured timing + device profiling.

Replaces the reference's bracket-and-print time.time() scattering
(SURVEY.md §5) with:

* ``timer(name)`` — context manager accumulating wall-clock per stage
  into a process-wide registry (printed summary on demand).  While a
  ``torch.profiler`` records, it is also a ``record_function`` span of
  the same name, so the stage lands in the profiler's trace on the
  kernels' clock; with no profiler it costs one flag check more;
* ``timed_coro(name, gen)`` — a search coroutine with ``timer(name)``
  around each of its resumptions only, never across a ``yield``;
* ``count(name, n)`` — event counters, beside the timers;
* ``device_trace(logdir)`` — torch.profiler trace of the host and, where
  a card is visible, its kernels, written as a Chrome trace into
  ``logdir`` (open in Perfetto or chrome://tracing).

A part resets the registry when it starts, so each name is written in
one part only: its ``partN/`` prefix.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch

_REGISTRY: Dict[str, list] = defaultdict(lambda: [0.0, 0])


@contextlib.contextmanager
def timer(name: str) -> Iterator[None]:
    # record_function costs ~10 us even with no profiler: open it only
    # while one records
    span = torch.profiler.record_function(name) if torch.autograd._profiler_enabled() else None
    if span is not None:
        span.__enter__()
    start = time.perf_counter()
    try:
        yield
    finally:
        elapsed = time.perf_counter() - start
        if span is not None:
            span.__exit__(None, None, None)
        _REGISTRY[name][0] += elapsed
        _REGISTRY[name][1] += 1


def timed_coro(name: str, gen):
    """Runs the coroutine ``gen`` to its end, yielding what it yields and
    sending it what this one is sent, with ``timer(name)`` around each of
    its resumptions: under an interleaving scheduler the timer counts this
    coroutine's own work, not the others' that run while it is suspended.
    Returns ``gen``'s value."""
    value = None
    while True:
        with timer(name):
            try:
                handles = gen.send(value)
            except StopIteration as stop:
                return stop.value
        value = yield handles


def declare(*names: str) -> None:
    """Lists each timer ``name`` in the summary, at 0 s over 0 calls until
    it runs: a stage that a part may skip reads 0, not missing."""
    for name in names:
        _REGISTRY[name]


_COUNTERS: Dict[str, int] = defaultdict(int)


def count(name: str, n: int = 1) -> None:
    """Accumulate an event counter (printed alongside the timers);
    ``n = 0`` lists it at 0."""
    _COUNTERS[name] += n


def count_copy(name: str, device) -> None:
    """Counts one copy between host memory and ``device`` under ``name``;
    nothing when ``device`` is the host."""
    if torch.device(device).type != "cpu":
        _COUNTERS[name] += 1


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
    ``logdir/trace_<pid>.json`` (Chrome trace format): the timers' spans
    (``user_annotation``), the host's torch calls and, on a card, its
    kernels and copies."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"trace_{os.getpid()}.json"))
