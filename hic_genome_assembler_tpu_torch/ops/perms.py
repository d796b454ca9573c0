"""Candidate enumeration for the order/orientation search.

The search compares candidates with a strict ``cost > best`` update
(orderGenome.py:457-471), so the WINNER under ties is the earliest
candidate in enumeration order.  To reproduce the reference's decisions
exactly, these generators emit candidates in the reference's order:

* ``permutations_swap_order`` — the recursive swap enumeration of
  orderGenome.py:381-394 (for i in k..n: swap(k,i); recurse(k+1); swap
  back), yielding the identity first;
* ``remove_reverse_duplicates`` — keep the first of each
  (sequence, reversed-sequence) pair, preserving order
  (orderGenome.py:396-411), halving N!;
* ``plus_minus_perms`` — all-"+" first, then for i in 0..N-1 the
  deduplicated swap-order multiset permutations of i "+" followed by
  (N-i) "-" (orderGenome.py:413-430), 2^N total.

Batch helpers return int32 numpy arrays ready for device scoring; the
flat candidate index (order-major, orientation-fastest) matches the
reference's nested loop (orderGenome.py:457-458).
"""

from __future__ import annotations

import functools
import math
from typing import List, Sequence

import numpy as np


def calc_possible_perms(n: int) -> int:
    """N! * 2**N / 2 (orderGenome.py:374-379)."""
    return math.factorial(n) * (2 ** n) // 2


def permutations_swap_order(elements: Sequence) -> List[list]:
    """All permutations in recursive-swap enumeration order."""
    elems = list(elements)
    out: List[list] = []

    def rec(k: int) -> None:
        if k == len(elems):
            out.append(list(elems))
            return
        for i in range(k, len(elems)):
            elems[k], elems[i] = elems[i], elems[k]
            rec(k + 1)
            elems[k], elems[i] = elems[i], elems[k]

    rec(0)
    return out


def remove_reverse_duplicates(perms: List[list]) -> List[list]:
    """Keep the earlier of each reverse pair, in place order."""
    seen = set()
    kept: List[list] = []
    for p in perms:
        if tuple(reversed(p)) in seen:
            continue
        seen.add(tuple(p))
        kept.append(p)
    return kept


def plus_minus_perms(n: int) -> List[List[str]]:
    """All +/- orientation vectors in the reference's emission order."""
    result: List[List[str]] = [["+"] * n]
    seen = {tuple(result[0])}
    for i in range(n):
        base = ["+"] * i + ["-"] * (n - i)
        for p in permutations_swap_order(base):
            t = tuple(p)
            if t not in seen:
                seen.add(t)
                result.append(list(p))
    return result


@functools.lru_cache(maxsize=16)
def _order_batch_cached(n: int) -> np.ndarray:
    perms = remove_reverse_duplicates(permutations_swap_order(list(range(n))))
    out = np.asarray(perms, dtype=np.int32)
    out.setflags(write=False)
    return out


def order_batch(n: int) -> np.ndarray:
    """Reverse-deduplicated index permutations as int32[B_ord, n].

    Cached (read-only view): the enumeration is identical for every
    chromosome, and the cached object's stable identity keeps the
    combo-map device cache (ops.cost._combo_index) hitting.
    """
    return _order_batch_cached(n)


@functools.lru_cache(maxsize=16)
def _orient_batch_cached(n: int) -> np.ndarray:
    signs = plus_minus_perms(n)
    out = np.asarray(
        [[0 if o == "+" else 1 for o in v] for v in signs], dtype=np.int32
    )
    out.setflags(write=False)
    return out


def orient_batch(n: int) -> np.ndarray:
    """Orientation vectors as int32[B_orient, n]; 0 == '+', 1 == '-'.
    Cached (read-only view)."""
    return _orient_batch_cached(n)
