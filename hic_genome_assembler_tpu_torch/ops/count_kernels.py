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

The rank matrix is stored as int16 when its padded size is below
:data:`INT16_LIMIT` (every value and the -1 pad fit), else as int32
(:func:`rank_dtype`); the JAX package ships uint16 for the same reason.

On a CUDA tensor every function launches the hand-written kernel in
``csrc/rank_counts.cu`` (or raises); on a CPU tensor it runs the plain
torch version beside it, which gives the identical integers.  There is no
fallback from one to the other.

The kernel reads each row once for all the scans of a batch and uses their
nesting (see ``csrc/rank_counts.cu``).  :func:`plan_batch` is its host
side: it de-duplicates the batch's scans, groups them by start, sorts each
group and maps every caller's row back to its scan.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.utils import profiling

# Padded layout of the rank matrix: rows to a multiple of 512, columns to a
# multiple of 2048, pad entries -1.  The same layout as the JAX package's
# RankCounts, so its state maps one to one.
_TILE_R = 512
_TILE_C = 2048

# A padded size below this is stored as int16 (its values are < the size).
INT16_LIMIT = 32767

# Distinct scans one block of the kernel counts at once (its per-row bins
# sit in shared memory); a batch with more is split over gridDim.y.
CHUNK_SCANS = 1024
_CHUNK_HEADER = 8
_INT32_MAX = 2**31 - 1

# Kernel launches made by the wrappers below (read by chip_smoke.py to show
# that the main path went through the kernel).
LAUNCHES = 0


def rank_dtype(size: int) -> torch.dtype:
    """The element type of a rank matrix padded to ``size`` rows/columns."""
    return torch.int16 if size < INT16_LIMIT else torch.int32


def pad_rank(rank_mat: torch.Tensor) -> torch.Tensor:
    """Pad a square int rank matrix (values in ``[0, n)``) to tile
    multiples with -1 entries (never in [start, hi], so padding contributes
    zero to every count), as :func:`rank_dtype` of the padded width."""
    n = rank_mat.shape[0]
    rows, cols = n + (-n % _TILE_R), n + (-n % _TILE_C)
    out = torch.full((rows, cols), -1, dtype=rank_dtype(max(rows, cols)),
                     device=rank_mat.device)
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
        if flag != 1:
            profiling.count_copy("part1/pageable_copies", dev)
        hi = rows if flag == 1 else torch.tensor(cut, dtype=torch.int64, device=dev)
        # no column at or past the largest prefix end can count
        width = min(n_c, max((row0 + n_r - 1 if flag == 1 else cut) - start - col0, 0))
        window = rank_mat[:, :width]
        if window.element_size() < 4:
            # an int16 window compared with an int32 start or cut would wrap
            window = window.to(torch.int32)
        cols = col0 + torch.arange(width, dtype=torch.int64, device=dev)[None, :]
        mask = (cols < hi - start) & (window >= start) & (window <= hi)
        out[k] = mask.sum(dim=1, dtype=torch.int32)
    return out


def plan_batch(params) -> Tuple[np.ndarray, int, int, int]:
    """The kernel's view of a batch of ``(start, cut, flag)`` rows:
    ``(plan int32, n_chunks, max_bins, max_groups)``.

    The distinct scans (a growing scan is its start; a fixed scan its start
    and cut) are sorted, growing scans first by start, then fixed scans by
    start and cut, and cut into chunks of at most :data:`CHUNK_SCANS`.  A
    chunk's scans are its bins, in that order.  Its groups: the growing
    scans (first, when there are any), then one group for each fixed start,
    ordered by their prefix end ``max cut - start`` descending, so that a
    column past one group's end is past every later group's.

    ``plan``: ``[n_chunks]``, then a header of :data:`_CHUNK_HEADER` ints a
    chunk ``(n_bins, n_groups, has_growing, keys_off, groups_off, out_off,
    n_out, 0)``, then the arrays the offsets point at: ``keys[n_bins]`` (a
    growing bin's start, a fixed bin's cut), ``groups[n_groups, 4]`` =
    ``(start, end, bin0, n)`` (``end``: a column ``j`` of the group's
    prefix has ``j < end``; unused for the growing group), and ``out[n_out,
    2]`` = ``(k, bin)`` for every row ``k`` of ``params`` in the chunk."""
    p = np.asarray(params, dtype=np.int64).reshape(-1, 3)
    growing = p[:, 2] == 1
    keyed = np.stack([(~growing).astype(np.int64), p[:, 0], np.where(growing, 0, p[:, 1])], 1)
    distinct, inverse = np.unique(keyed, axis=0, return_inverse=True)
    inverse = inverse.reshape(-1)
    chunks = range(0, len(distinct), CHUNK_SCANS)
    headers, arrays = [], []
    offset = 1 + _CHUNK_HEADER * len(chunks)
    max_bins = max_groups = 1
    for c0 in chunks:
        scans = distinct[c0 : c0 + CHUNK_SCANS]
        n_bins = len(scans)
        fixed = scans[:, 0] == 1
        n_grow = int((~fixed).sum())
        groups = []
        if n_grow:
            groups.append((int(scans[0, 1]), 0, 0, n_grow))
        f_starts = scans[n_grow:, 1]
        bounds = np.flatnonzero(np.diff(f_starts)) + 1
        fixed_groups = []
        runs = zip(np.r_[0, bounds], np.r_[bounds, len(f_starts)]) if len(f_starts) else ()
        for lo, hi in runs:
            start, last_cut = int(f_starts[lo]), int(scans[n_grow + hi - 1, 2])
            end = min(max(last_cut - start, 0), _INT32_MAX)
            fixed_groups.append((start, end, n_grow + int(lo), int(hi - lo)))
        groups += sorted(fixed_groups, key=lambda g: -g[1])
        ks = np.flatnonzero((inverse >= c0) & (inverse < c0 + n_bins))
        out = np.stack([ks, inverse[ks] - c0], 1)
        keys = np.where(fixed, scans[:, 2], scans[:, 1])
        headers.append([n_bins, len(groups), int(n_grow > 0), offset, offset + n_bins,
                        offset + n_bins + 4 * len(groups), len(ks), 0])
        arrays += [keys, np.asarray(groups, dtype=np.int64).reshape(-1), out.reshape(-1)]
        offset += n_bins + 4 * len(groups) + 2 * len(ks)
        max_bins, max_groups = max(max_bins, n_bins), max(max_groups, len(groups))
    plan = np.concatenate([[len(chunks)], np.asarray(headers, dtype=np.int64).reshape(-1)]
                          + arrays)
    return plan.astype(np.int32), len(chunks), max_bins, max_groups


def _prefix_sum_to(x: np.ndarray, C: int) -> np.ndarray:
    """sum_{y < x} clip(y, 0, C), elementwise over int64 ``x``."""
    inside = np.clip(x, 0, C + 1)
    return inside * (inside - 1) // 2 + np.maximum(x - C - 1, 0) * C


def batch_prefix_elements(
    params, n_rows: int, n_cols: int, row0: int = 0, col0: int = 0
) -> Tuple[int, int]:
    """``(per_scan, union)``: the prefix elements of a batch on an
    ``n_rows x n_cols`` block at ``(row0, col0)``, summed over its scans
    (each scan reads its own prefix: what a kernel streams that reads the
    matrix once a scan), and the union (per row, the widest prefix of any
    scan: what a kernel reads that reads each row once for the batch)."""
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


def counts_many(
    rank_mat: torch.Tensor, params, row0: int = 0, col0: int = 0
) -> torch.Tensor:
    """Counts for K ``(start, cut, flag)`` rows in one launch:
    int32[K, n_rows] on the matrix's device (counterpart of
    ``pallas_kernels._counts_call_many`` and ``matrix.counts_many``).

    ``rank_mat`` (int16 or int32 on a GPU) may be a column-sliced view of
    the padded matrix (unit column stride, any row stride): a fixed window
    never reads past its width.  It may also be a block whose top-left
    element is the global ``(row0, col0)``.  Padding rows give counts for
    phantom rows, sliced off by the caller."""
    if row0 < 0 or col0 < 0:
        raise ValueError(f"block offsets must be >= 0, got ({row0}, {col0})")
    if rank_mat.device.type == "cpu":
        return counts_many_plain(rank_mat, params, row0, col0)
    if rank_mat.device.type != "cuda":
        raise ValueError(f"rank counts run on cuda or cpu, not {rank_mat.device}")
    if rank_mat.dtype not in (torch.int16, torch.int32) or rank_mat.dim() != 2:
        raise ValueError(
            f"rank matrix must be 2-D int16 or int32, got {rank_mat.dtype} "
            f"{tuple(rank_mat.shape)}"
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
    plan, n_chunks, max_bins, max_groups = plan_batch(p.numpy())
    # pinned and asynchronous: a pageable upload would wait for the stream
    plan_dev = torch.from_numpy(plan).pin_memory().to(dev, non_blocking=True)
    out = torch.empty((K, n_r), dtype=torch.int32, device=dev)
    # a launch goes to the current card: make it the tensor's (a block of
    # a mesh may lie on any card)
    with torch.cuda.device(dev):
        err = lib.rank_counts(
            rank_mat.data_ptr(), rank_mat.element_size(), rank_mat.stride(0), n_r, n_c, row0,
            col0, plan_dev.data_ptr(), n_chunks, max_bins, max_groups, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
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

    Pass ``n`` (the real row count) when ``rank_mat`` is already padded by
    :func:`pad_rank`; otherwise it is padded here."""
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
