"""Contact-matrix transforms on a torch device.

Counterpart of ``hic_genome_assembler_tpu/ops/matrix.py`` (jitted XLA in the
JAX package, no Pallas kernel), in plain torch.  Part 1 uses
``rank_matrix_desc`` in ``matrixMode = device``; the other transforms run
there on the host in f64 (``ops/oracle.py``) and are here so that the module
is whole.  The rank-membership counts of the same JAX module are
``ops/count_kernels.py``.
"""

from __future__ import annotations

import math

import torch


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
