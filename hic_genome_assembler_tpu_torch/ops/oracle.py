"""Float64 numpy oracles for the device kernels.

Two uses:
1. unit tests cross-check every jitted kernel against these;
2. the pipeline's "exact" precision mode runs decision-critical
   transforms here (f64, reference-identical tie behavior) while the
   heavy counting/scoring still runs on device.
"""

from __future__ import annotations

import numpy as np


def to_distance(matrix: np.ndarray) -> np.ndarray:
    """Distance transform feeding UPGMA: (1 - row/rowsum) + 1
    (convertMatrix, scaffoldToChromosomes.py:138-148).

    Must stay f64-bit-identical to the reference in every mode — scipy
    linkage consumes these values and the dendrogram is a byte-equality
    target — and TPU hardware has no f64, so the fast path is the fused
    threaded native kernel (native/distance_transform.cpp; same
    per-element IEEE op sequence, ~10x the naive numpy expression at
    16K).  Row sums stay on numpy: its pairwise-summation order is part
    of the parity contract.  Fallback: in-place numpy (one temporary
    instead of three, still bit-identical)."""
    row_sums = matrix.sum(axis=1, keepdims=True)
    matrix = np.ascontiguousarray(matrix, dtype=np.float64)
    if matrix.size >= (1 << 20):
        try:
            from hic_genome_assembler_tpu_torch.io import native

            if native.available():
                return native.distance_transform_f64(matrix, row_sums)
        except Exception:
            pass
    out = matrix / row_sums
    np.subtract(1.0, out, out=out)
    np.add(out, 1.0, out=out)
    return out


def to_similarity(matrix: np.ndarray, row_sums: np.ndarray) -> np.ndarray:
    """Similarity inverse rs·(1−(m−1)) (convertMatrix,
    scaffoldToChromosomes.py:150-155).  Fast path = the fused threaded
    native kernel (bit-identical: sub/sub/mul are basic IEEE ops, no
    libm involved); fallback = in-place numpy, also bit-identical."""
    rs = np.ravel(np.asarray(row_sums, dtype=np.float64))
    matrix = np.ascontiguousarray(matrix, dtype=np.float64)
    if matrix.ndim == 2 and matrix.size >= (1 << 20):
        try:
            from hic_genome_assembler_tpu_torch.io import native

            if native.available():
                return native.similarity_transform_f64(matrix, rs)
        except Exception:
            pass
    out = matrix - 1.0
    np.subtract(1.0, out, out=out)
    out *= rs[:, None]
    return out


def log_transform(matrix, log_base=10.0, reverse=False, plus_one=True):
    matrix = np.asarray(matrix)
    if matrix.ndim == 2 and matrix.size >= (1 << 24):
        # np.log/np.power use numpy's own SIMD loops, which are NOT
        # guaranteed ulp-identical to C libm — so the parallel path
        # runs numpy itself over row blocks from in-process threads
        # (ufuncs release the GIL on big contiguous arrays; rows are
        # independent, so the result is bit-identical by construction)
        out = _thread_rowmap(
            matrix,
            lambda block: _log_transform_serial(
                block, log_base=log_base, reverse=reverse, plus_one=plus_one
            ),
        )
        if out is not None:
            return out
    return _log_transform_serial(
        matrix, log_base=log_base, reverse=reverse, plus_one=plus_one
    )


def _log_transform_serial(matrix, log_base=10.0, reverse=False, plus_one=True):
    nz = matrix != 0.0
    out = np.zeros_like(matrix, dtype=np.float64)
    if not reverse:
        shifted = matrix + 1.0 if plus_one else matrix
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = np.log(shifted) / np.log(log_base)
        out[nz] = vals[nz]
    else:
        powed = np.power(float(log_base), matrix)
        vals = powed - 1.0 if plus_one else powed
        out[nz] = vals[nz]
    return out


def _thread_rowmap(matrix: np.ndarray, fn) -> "np.ndarray | None":
    """Apply a row-independent f64 transform across in-process threads
    writing disjoint row blocks of one preallocated output.

    numpy ufuncs release the GIL on large contiguous buffers, so plain
    threads scale across cores with none of the machinery the previous
    fork-based form needed (COW pages, SharedMemory staging, join
    deadlines against fork-time-lock deadlocks — ADVICE r4 #1; threads
    eliminate that hazard class instead of bounding it).  Rows are
    independent and each is produced by the same numpy ops as the
    serial path, so the result is bit-identical by construction.
    Returns None when threading is pointless (single core) or a worker
    fails — callers fall back serial."""
    import os as _os
    import threading

    workers = min(_os.cpu_count() or 1, 16)
    if workers < 2:
        return None
    try:
        n_rows, n_cols = matrix.shape
        out = np.empty((n_rows, n_cols), dtype=np.float64)
        errors: list = []

        def worker(lo: int, hi: int) -> None:
            try:
                out[lo:hi] = fn(matrix[lo:hi])
            except Exception as exc:  # pragma: no cover - defensive
                errors.append(exc)

        chunk = (n_rows + workers - 1) // workers
        threads = []
        for w in range(workers):
            lo, hi = w * chunk, min(n_rows, (w + 1) * chunk)
            if lo >= hi:
                break
            t = threading.Thread(target=worker, args=(lo, hi))
            t.start()
            threads.append(t)
        for t in threads:
            t.join()
        if errors:
            return None
        return out
    except Exception:
        return None


def permute_symmetric(matrix: np.ndarray, order) -> np.ndarray:
    """Symmetric permutation ``matrix[np.ix_(order, order)]``
    (reorderMatrix, scaffoldToChromosomes.py:157-163).

    numpy's fancy-index gather is single-threaded and cache-hostile at
    16K (2.1 GB at ~0.2 GB/s); the native threaded kernel
    (native/permute_f64.cpp) does the identical data movement at memory
    bandwidth.  Bit-identical by construction (pure copy)."""
    matrix = np.asarray(matrix)
    order = np.asarray(order)
    if order.dtype == bool:
        order = np.flatnonzero(order)
    order = order.astype(np.int64, copy=False)
    if (
        matrix.ndim == 2
        and matrix.dtype == np.float64
        and matrix.shape[0] == matrix.shape[1]
        and matrix.size >= (1 << 20)
    ):
        try:
            from hic_genome_assembler_tpu_torch.io import native

            if native.available():
                return native.permute_symmetric_f64(matrix, order)
        except Exception:
            pass
    return matrix[np.ix_(order, order)]


_NATIVE_ARGSORT_OK = None  # lazily probed once per process


def _native_argsort_matches_numpy() -> bool:
    """Probe whether the native introsort clone reproduces THIS numpy's
    argsort tie order bit-for-bit on adversarial rows.

    numpy's default argsort tie order is an implementation artifact
    (classic npysort introsort on some builds, AVX-512 x86-simd-sort on
    others — numpy 2.x dispatches by CPU), and the reference's rank
    matrix inherits it, so the native clone is only usable where the
    probe passes; elsewhere the thread-parallel numpy path below keeps
    exact parity."""
    global _NATIVE_ARGSORT_OK
    if _NATIVE_ARGSORT_OK is not None:
        return _NATIVE_ARGSORT_OK
    try:
        from hic_genome_assembler_tpu_torch.io import native

        if not native.available():
            _NATIVE_ARGSORT_OK = False
            return False
        rng = np.random.default_rng(12345)
        ok = True
        # Probe at both a small width and the ~16K production width:
        # numpy's argsort kernel dispatch is size- and CPU-sensitive
        # (small-array cutoffs, AVX-512 x86-simd-sort), so passing at
        # 2048 does not imply passing at 16384.
        for n in (2048, 16384):
            rows = np.stack([
                rng.random(n),
                rng.integers(0, 3, n).astype(np.float64),   # huge tie groups
                np.zeros(n),                                 # all equal
                np.arange(n, dtype=np.float64),
                np.arange(n, 0, -1, dtype=np.float64),
                np.concatenate([np.arange(n // 2), np.arange(n // 2)[::-1]]).astype(np.float64),
                rng.integers(0, 2, n).astype(np.float64),
            ])
            want = np.argsort(rows, axis=1)[:, ::-1]
            got = native.argsort_rows_f64(rows, reverse=True)
            if not np.array_equal(want, got):
                ok = False
                break
        _NATIVE_ARGSORT_OK = ok
    except Exception:
        _NATIVE_ARGSORT_OK = False
    return _NATIVE_ARGSORT_OK


def _thread_argsort_desc(matrix: np.ndarray, workers: int) -> np.ndarray:
    """Row-wise numpy argsort fanned across in-process threads.

    np.argsort releases the GIL on numeric rows, so threads scale
    across cores (measured 1.97x on 2 cores at 16K) while every row is
    produced by the EXACT numpy kernel the serial path uses —
    bit-identical by construction, immune to numpy's CPU-dependent
    kernel dispatch (AVX-512 x86-simd-sort vs scalar introsort), and
    free of the fork path's COW/SharedMemory staging and deadlock
    hazard this replaced.  Ascending per-row results land in one
    preallocated int64 buffer; the descending ``[:, ::-1]`` is a view."""
    import threading

    n_rows, n_cols = matrix.shape
    out = np.empty((n_rows, n_cols), dtype=np.int64)
    errors: list = []

    def worker(lo: int, hi: int) -> None:
        try:
            for r in range(lo, hi):
                out[r] = np.argsort(matrix[r])
        except Exception as exc:  # pragma: no cover - defensive
            errors.append(exc)

    chunk = (n_rows + workers - 1) // workers
    threads = []
    for w in range(workers):
        lo, hi = w * chunk, min(n_rows, (w + 1) * chunk)
        if lo >= hi:
            break
        t = threading.Thread(target=worker, args=(lo, hi))
        t.start()
        threads.append(t)
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out[:, ::-1]


def rank_matrix_desc(matrix: np.ndarray) -> np.ndarray:
    """Reference-identical rank matrix: numpy default argsort reversed
    (scaffoldToChromosomes.py:1132: ``argsort(adjMat, axis=1)[:, ::-1]``).

    The tie order of numpy's default (unstable) argsort is part of the
    parity contract — window membership counts consume it wherever an
    equal-value group (every zero contact, duplicated values) straddles
    a window prefix — so acceleration must preserve it exactly.  Two
    bit-identical fast paths, in preference order:

    1. native row-parallel introsort clone (native/argsort_rows.cpp),
       gated by a per-process probe that it matches THIS numpy build;
    2. thread-parallel numpy per row (same kernel -> same tie order;
       np.argsort releases the GIL, so plain threads scale).
    """
    matrix = np.ascontiguousarray(matrix)
    # below ~16M elements thread-start overhead beats the parallel win
    big = matrix.ndim == 2 and matrix.size >= (1 << 24)
    if big and matrix.dtype == np.float64 and _native_argsort_matches_numpy():
        from hic_genome_assembler_tpu_torch.io import native

        return native.argsort_rows_f64(matrix, reverse=True)
    if big and hasattr(np, "argsort"):
        import os as _os

        workers = min(_os.cpu_count() or 1, 16)
        if workers >= 2:
            try:
                return _thread_argsort_desc(matrix, workers)
            except Exception:
                pass
    return np.asarray(np.argsort(matrix, axis=1)[:, ::-1])


def cost_function(matrix: np.ndarray, total: float) -> float:
    """The reference cost: harmonically-weighted cumulative
    super-diagonal traces (orderGenome.py:184-191), f64, identical
    summation order."""
    cumulative, cost = 0.0, 0.0
    n = len(matrix)
    for i in range(1, n):
        cumulative += float(np.trace(matrix, offset=i))
        cost += cumulative / total / float(i)
    return cost
