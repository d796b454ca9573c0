"""Contact-matrix transforms on a torch device.

Counterpart of ``hic_genome_assembler_tpu/ops/matrix.py`` (jitted XLA in the
JAX package, no Pallas kernel), in plain torch.  Part 1 uses
``rank_matrix_desc`` in ``matrixMode = device``; the other transforms run
there on the host in f64 (``ops/oracle.py``) and are here so that the module
is whole.  ``matrixMode = exact`` ranks on the host with
:func:`rank_rows_desc_host`.  The rank-membership counts of the same JAX
module are ``ops/count_kernels.py``.
"""

from __future__ import annotations

import itertools
import math
import os
import threading

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.ops.count_kernels import INT16_LIMIT

_RANK_BATCH = 16      # rows a thread takes at a time
_RANK_THREADED = 1 << 24  # elements from which the rows go to threads


def rank_rows_desc_host(matrix: np.ndarray) -> np.ndarray:
    """``oracle.rank_matrix_desc``'s values, numpy's default argsort of
    each row reversed (numpy's tie order is the parity contract), as int16
    where the columns fit (else int32): the element type of the counts
    kernel's rank matrix, a quarter of int64's bytes to hold and upload.
    A large matrix's rows go to one thread a core (at most 16),
    ``_RANK_BATCH`` at a time from one shared counter, so a thread
    slowed by a busy core takes fewer rows instead of holding up the rest;
    each row is one ``np.argsort`` call, which releases the GIL."""
    m = np.ascontiguousarray(matrix)
    n_rows, n_cols = m.shape
    out = np.empty((n_rows, n_cols), dtype=np.int16 if n_cols < INT16_LIMIT else np.int32)
    workers = min(os.cpu_count() or 1, 16)
    if m.size < _RANK_THREADED or workers < 2:
        for r in range(n_rows):
            out[r] = np.argsort(m[r])[::-1]
        return out
    starts = itertools.count(0, _RANK_BATCH)  # next() is atomic under the GIL
    errors: list = []

    def worker() -> None:
        try:
            for lo in starts:
                if lo >= n_rows:
                    return
                for r in range(lo, min(lo + _RANK_BATCH, n_rows)):
                    out[r] = np.argsort(m[r])[::-1]
        except BaseException as exc:  # pragma: no cover - re-raised below
            errors.append(exc)

    threads = [threading.Thread(target=worker) for _ in range(workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def to_distance(matrix: torch.Tensor) -> torch.Tensor:
    """Row-stochastic distance transform, range [1, 2]:
    D[i, j] = (1 - M[i, j] / sum_j M[i, j]) + 1."""
    row_sums = matrix.sum(dim=1, keepdim=True)
    return (1.0 - matrix / row_sums) + 1.0


def to_similarity(matrix: torch.Tensor, row_sums: torch.Tensor) -> torch.Tensor:
    """Inverse of ``to_distance``: S[i, j] = rowSum_i * (1 - (D[i, j] - 1))."""
    return row_sums[:, None] * (1.0 - (matrix - 1.0))


def log_transform(
    matrix: torch.Tensor,
    log_base: float = 10.0,
    reverse: bool = False,
    plus_one: bool = True,
) -> torch.Tensor:
    """Elementwise log/exp on nonzero entries, zeros preserved.

    plus_one=True  : log_b(v + 1)  /  b**v - 1   (part 1)
    plus_one=False : log_b(v)      /  b**v       (part 2)
    """
    nz = matrix != 0.0
    if not reverse:
        shifted = matrix + 1.0 if plus_one else matrix
        out = torch.log(shifted) / math.log(log_base)
    else:
        powed = torch.pow(log_base, matrix)
        out = powed - 1.0 if plus_one else powed
    return torch.where(nz, out, torch.zeros_like(out))


def reorder(matrix: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """Symmetric permutation matrix[order][:, order]."""
    return matrix[order][:, order]


def rank_matrix_desc(matrix: torch.Tensor) -> torch.Tensor:
    """Per-row argsort descending, int32: a stable ascending sort, then the
    columns reversed, so a tie group resolves by descending index as
    ``numpy.argsort(...)[:, ::-1]`` and the JAX package's device mode do."""
    return torch.sort(matrix, dim=1, stable=True).indices.flip(1).to(torch.int32)
