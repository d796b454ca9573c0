"""The yardstick's arithmetic: published peaks of one H100 and the least
time of a kernel launch, from its parameters alone.

Frozen copies of the bound arithmetic of the repository's chip smoke test
(``rank_bound``, ``nested_compares``, ``hmm_bound_ms``) and of the rank
kernel's prefix counting, so that a later change to the program cannot
move the yardstick.  NumPy only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet, at 700 W
FP64_OPS_PER_S = 34e12               # H100 SXM data sheet, f64 outside the tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # 132 SMs x 64 int32 lanes x ~1.98 GHz


def _prefix_sum_to(x: np.ndarray, C: int) -> np.ndarray:
    """sum_{y < x} clip(y, 0, C), elementwise over int64 ``x``."""
    inside = np.clip(x, 0, C + 1)
    return inside * (inside - 1) // 2 + np.maximum(x - C - 1, 0) * C


def batch_prefix_elements(params, n_rows: int, n_cols: int, row0: int = 0,
                          col0: int = 0) -> Tuple[int, int]:
    """(per_scan, union): the prefix elements of a batch of ``(start, cut,
    growing)`` scans on an ``n_rows x n_cols`` block at ``(row0, col0)``,
    summed over its scans, and per row the widest prefix of any scan."""
    p = np.asarray(params, dtype=np.int64).reshape(-1, 3)
    grow = p[:, 2] == 1
    fixed_w = np.clip(p[~grow, 1] - p[~grow, 0] - col0, 0, n_cols)
    a = row0 - col0 - p[grow, 0]                    # a growing scan's width at row 0
    per_scan = n_rows * int(fixed_w.sum()) + int(
        (_prefix_sum_to(a + n_rows, n_cols) - _prefix_sum_to(a, n_cols)).sum())
    widest = np.full(n_rows, int(fixed_w.max()) if len(fixed_w) else 0, dtype=np.int64)
    if grow.any():
        rows = np.arange(n_rows, dtype=np.int64)
        widest = np.maximum(widest, np.clip(rows + a.max(), 0, n_cols))
    return per_scan, int(widest.sum())


def nested_compares(params, n_rows: int, n_cols: int, row0: int = 0, col0: int = 0) -> int:
    """One compare for each element of each group's union prefix: the
    growing scans are one group, the fixed scans one group a start."""
    p = np.asarray(params, dtype=np.int64).reshape(-1, 3)
    grow = p[:, 2] == 1
    groups = [p[grow]] + [p[~grow & (p[:, 0] == s)] for s in np.unique(p[~grow, 0])]
    return sum(batch_prefix_elements(g, n_rows, n_cols, row0, col0)[1] for g in groups if len(g))


def rank_bound(params, n_rows: int, n_cols: int, elem_bytes: int, row0: int = 0,
               col0: int = 0) -> Tuple[float, str]:
    """Least time of one rank-count launch in ms and what sets it:
    bytes (the union of the batch's prefixes read once at ``elem_bytes``,
    the params read once, the int32 counts written once, at HBM's rate) or
    operations (one int32 compare a union-prefix element a group, at the
    card's int32 rate), whichever is larger."""
    _per_scan, union = batch_prefix_elements(params, n_rows, n_cols, row0, col0)
    ops = nested_compares(params, n_rows, n_cols, row0, col0)
    K = len(np.asarray(params).reshape(-1, 3))
    bytes_ms = 1e3 * (elem_bytes * union + 12 * K + 4 * K * n_rows) / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def hmm_bound_ms(name: str, T: int) -> Tuple[float, str]:
    """Least time of one HMM scan at T frames and what sets it: each input
    byte read once and each output byte written once at HBM's rate, or its
    f64 operations (forward 22, backward 22, gamma 18 and xi 32 a frame;
    Viterbi 8) at the f64 rate, whichever is larger."""
    if name == "hmm_forward_backward":
        nbytes, ops = 16 * T + 48 + 16 * T + 40, 94 * T
    else:
        nbytes, ops = 16 * T + 48 + 4 * T, 8 * T
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP64_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
