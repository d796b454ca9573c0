"""Rank-membership counts for the part-1 breakpoint scans.

Counterpart of ``hic_genome_assembler_tpu/ops/pallas_kernels.py`` and of
the XLA counts in ``hic_genome_assembler_tpu/ops/matrix.py``.  For every
params row ``(start, cut, flag)`` and every row ``i`` of the rank matrix:

    count[i] = #{ j < hi - start : start <= R[i, j] <= hi }

with ``hi = i`` for a growing scan (flag 1) and ``hi = cut`` for a fixed
window (flag 0).

A matrix may be given as one block whose top-left element is the global
``(row0, col0)``: the block then counts only its own columns, and the
counts of a row's blocks along a mesh's model axis add up to the row's
count (:func:`counts_many_blocks`, the counterpart of the JAX mesh path's
psum along ``model``).

On a CUDA tensor every function launches the hand-written kernel in
``csrc/rank_counts.cu`` (or raises); on a CPU tensor it runs the plain
torch version beside it, which gives the identical integers.  There is no
fallback from one to the other.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

# Padded layout of the rank matrix: rows to a multiple of 512, columns to a
# multiple of 2048, pad entries -1.  The same layout as the JAX package's
# RankCounts, so its state maps one to one.
_TILE_R = 512
_TILE_C = 2048

# Kernel launches made by the wrappers below (read by chip_smoke.py to show
# that the main path went through the kernel).
LAUNCHES = 0


def pad_rank(rank_mat: torch.Tensor) -> torch.Tensor:
    """Pad a square int rank matrix to tile multiples with -1 entries
    (never in [start, hi], so padding contributes zero to every count)."""
    n = rank_mat.shape[0]
    out = torch.full(
        (n + (-n % _TILE_R), n + (-n % _TILE_C)), -1,
        dtype=torch.int32, device=rank_mat.device,
    )
    out[:n, : rank_mat.shape[1]] = rank_mat
    return out


def _as_params(params) -> torch.Tensor:
    p = torch.as_tensor(np.asarray(params, dtype=np.int32))
    if p.dim() != 2 or p.shape[1] != 3:
        raise ValueError(f"params must be int32[K, 3], got {tuple(p.shape)}")
    return p


def counts_many_plain(
    rank_mat: torch.Tensor, params, row0: int = 0, col0: int = 0
) -> torch.Tensor:
    """Plain torch version of :func:`counts_many`: int32[K, n_rows]."""
    p = _as_params(params).tolist()
    n_r, n_c = rank_mat.shape
    dev = rank_mat.device
    rows = row0 + torch.arange(n_r, dtype=torch.int64, device=dev)[:, None]
    out = torch.empty((len(p), n_r), dtype=torch.int32, device=dev)
    for k, (start, cut, flag) in enumerate(p):
        hi = rows if flag == 1 else torch.tensor(cut, dtype=torch.int64, device=dev)
        # no column at or past the largest prefix end can count
        width = min(n_c, max((row0 + n_r - 1 if flag == 1 else cut) - start - col0, 0))
        window = rank_mat[:, :width]
        cols = col0 + torch.arange(width, dtype=torch.int64, device=dev)[None, :]
        mask = (cols < hi - start) & (window >= start) & (window <= hi)
        out[k] = mask.sum(dim=1, dtype=torch.int32)
    return out


def counts_many(
    rank_mat: torch.Tensor, params, row0: int = 0, col0: int = 0
) -> torch.Tensor:
    """Counts for K ``(start, cut, flag)`` rows in one launch:
    int32[K, n_rows] on the matrix's device (counterpart of
    ``pallas_kernels._counts_call_many`` and ``matrix.counts_many``).

    ``rank_mat`` may be a column-sliced view of the padded matrix (unit
    column stride, any row stride): a fixed window never reads past its
    width.  It may also be a block whose top-left element is the global
    ``(row0, col0)``.  Padding rows give counts for phantom rows, sliced
    off by the caller."""
    if row0 < 0 or col0 < 0:
        raise ValueError(f"block offsets must be >= 0, got ({row0}, {col0})")
    if rank_mat.device.type == "cpu":
        return counts_many_plain(rank_mat, params, row0, col0)
    if rank_mat.device.type != "cuda":
        raise ValueError(f"rank counts run on cuda or cpu, not {rank_mat.device}")
    if rank_mat.dtype != torch.int32 or rank_mat.dim() != 2:
        raise ValueError(
            f"rank matrix must be 2-D int32, got {rank_mat.dtype} {tuple(rank_mat.shape)}"
        )
    if rank_mat.stride(1) != 1 or rank_mat.stride(0) < rank_mat.shape[1]:
        raise ValueError(f"rank matrix needs unit column stride, got {rank_mat.stride()}")
    p = _as_params(params)
    K = p.shape[0]
    if not 1 <= K <= 65535:
        raise ValueError(f"batch of {K} scans is outside 1..65535")
    n_r, n_c = rank_mat.shape
    if row0 + n_r >= 2**31 or col0 + n_c >= 2**31:
        raise ValueError(f"rank matrix too large: {tuple(rank_mat.shape)} at ({row0}, {col0})")
    from hic_genome_assembler_tpu_torch.ops import _build

    lib = _build.library()
    dev = rank_mat.device
    p_dev = p.to(dev)
    out = torch.empty((K, n_r), dtype=torch.int32, device=dev)
    # a launch goes to the current card: make it the tensor's (a block of
    # a mesh may lie on any card)
    with torch.cuda.device(dev):
        err = lib.rank_counts(
            rank_mat.data_ptr(), rank_mat.stride(0), n_r, n_c, row0, col0,
            p_dev.data_ptr(), K, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"rank_counts kernel launch failed: cudaError {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out


def counts_many_blocks(
    blocks: Sequence[Sequence[torch.Tensor]], params, out_device: torch.device
) -> torch.Tensor:
    """Counts over a matrix placed as ``(data, model)`` blocks of equal
    shape (``parallel.mesh.place_blocks``): one :func:`counts_many` launch
    per block with its offsets, the model-axis partials summed as int32 on
    the device of the row's first block, and the row blocks gathered on
    ``out_device``.  Returns int32[K, data * block_rows]."""
    rb, cb = blocks[0][0].shape
    rows: List[torch.Tensor] = []
    for i, row_blocks in enumerate(blocks):
        home = row_blocks[0].device
        total: Optional[torch.Tensor] = None
        for j, blk in enumerate(row_blocks):
            part = counts_many(blk, params, row0=i * rb, col0=j * cb).to(home)
            total = part if total is None else total + part
        rows.append(total.to(out_device))
    return torch.cat(rows, dim=1)


def growing_window_counts(
    rank_mat: torch.Tensor, start: int, n: Optional[int] = None
) -> torch.Tensor:
    """count[i] = #{ j < i - start : start <= R[i, j] <= i }.

    Pass ``n`` (the real row count) when ``rank_mat`` is already int32
    and padded by :func:`pad_rank`; otherwise it is padded here."""
    if n is None:
        n = rank_mat.shape[0]
        rank_mat = pad_rank(rank_mat)
    return counts_many(rank_mat, [[int(start), 0, 1]])[0, :n]


def fixed_window_counts(
    rank_mat: torch.Tensor, start: int, cut: int, n: Optional[int] = None
) -> torch.Tensor:
    """count[i] = #{ j < cut - start : start <= R[i, j] <= cut }."""
    if n is None:
        n = rank_mat.shape[0]
        rank_mat = pad_rank(rank_mat)
    return counts_many(rank_mat, [[int(start), int(cut), 0]])[0, :n]
