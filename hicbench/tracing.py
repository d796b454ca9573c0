"""Reading the profiler's trace of a window: the device's busy intervals,
each kernel's device time, and what the host was doing while the device
sat idle.

The trace is ``torch.profiler``'s Chrome trace (CPU and CUDA activity):
kernels, copies and memsets are the device's work; the benchmark's
``record_function`` spans (``user_annotation``) say which of the program's
layers the host was in.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class Trace:
    t0_us: float                                  # the window's start on the trace's clock
    t1_us: float
    device: List[Tuple[float, float, str, str]]   # (start, end, category, name)
    spans: List[Tuple[float, float, str]]         # (start, end, label)
    kernel_us: Dict[str, float] = field(default_factory=dict)
    kernel_n: Dict[str, int] = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        return (self.t1_us - self.t0_us) / 1e6

    def busy_intervals(self) -> np.ndarray:
        """The union of the device's work inside the window: [k, 2] us."""
        iv = sorted((max(a, self.t0_us), min(b, self.t1_us)) for a, b, _, _ in self.device
                    if b > self.t0_us and a < self.t1_us)
        out: List[List[float]] = []
        for a, b in iv:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return np.asarray(out, dtype=np.float64).reshape(-1, 2)

    def busy_s(self) -> float:
        iv = self.busy_intervals()
        return float((iv[:, 1] - iv[:, 0]).sum()) / 1e6

    def kernel(self, fragment: str) -> Tuple[int, float]:
        """(events, device seconds) of the kernels whose name holds ``fragment``."""
        n = sum(v for k, v in self.kernel_n.items() if fragment in k)
        us = sum(v for k, v in self.kernel_us.items() if fragment in k)
        return n, us / 1e6

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time: [[name, seconds], ...]."""
        tally: Dict[str, float] = defaultdict(float)
        for a, b, _, name in self.device:
            tally[name[:96]] += (b - a) / 1e6
        return [[k, v] for k, v in sorted(tally.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the device inside the window, split by the
        innermost benchmark span the host was in at each instant."""
        iv = self.busy_intervals()
        edges = np.concatenate([[self.t0_us], iv.ravel(), [self.t1_us]]).reshape(-1, 2)
        # one sweep in time order over span starts and ends and idle
        # starts and ends; the spans nest, so the innermost open span is
        # the top of the stack (at a tie, ends sort before starts)
        marks = [(a, 1, -1) for a, b in edges if b > a] + [(b, 0, -1) for a, b in edges if b > a]
        marks += [(sp[0], 1, i) for i, sp in enumerate(self.spans)]
        marks += [(sp[1], 0, i) for i, sp in enumerate(self.spans)]
        tally: Dict[str, float] = defaultdict(float)
        stack: List[int] = []
        idle, last = False, self.t0_us
        for t, opening, i in sorted(marks):
            if idle and t > last:
                label = self.spans[stack[-1]][2] if stack else "between spans"
                tally[label] += float(t - last) / 1e6
            last = t
            if i < 0:
                idle = bool(opening)
            elif opening:
                stack.append(i)
            elif i in stack:
                stack.remove(i)
        return [[k, v] for k, v in sorted(tally.items(), key=lambda kv: -kv[1])[:top]]


def read(path: str, window_label: str) -> Trace:
    """The trace of the span named ``window_label`` in a Chrome trace file."""
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    device, spans = [], []
    kernel_us: Dict[str, float] = defaultdict(float)
    kernel_n: Dict[str, int] = defaultdict(int)
    t0 = t1 = None
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        a = float(e["ts"])
        b = a + float(e.get("dur", 0.0))
        if cat in DEVICE_CATS:
            device.append((a, b, cat, name))
            if cat == "kernel":
                kernel_us[name] += b - a
                kernel_n[name] += 1
        elif cat == "user_annotation":
            if name == window_label:
                t0, t1 = a, b
            else:
                spans.append((a, b, name))
    if t0 is None:
        raise RuntimeError(f"the trace holds no span {window_label!r}")
    return Trace(t0, t1, device, spans, dict(kernel_us), dict(kernel_n))
