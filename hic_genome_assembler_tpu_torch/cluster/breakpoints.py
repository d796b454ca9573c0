"""Hypergeometric chromosome-cut detection (part-1 default strategy).

Counterpart of ``hic_genome_assembler_tpu/cluster/breakpoints.py``.  The
decision functions (``find_matrix_pvalue_breakpoints``,
``pre_process_all_matrix_breakpoints``, ``filter_noisy_breakpoints``) are
copied with their logic unchanged: they are pure numpy, but the JAX
module that holds them imports ``jax.numpy``.  Only the counts backend
differs: ``RankCounts`` keeps the padded rank matrix as torch blocks (one
block on one device, or the blocks of a mesh) and counts through
``ops.count_kernels`` (the CUDA kernel on a GPU tensor, its plain torch
version on a CPU tensor).

Preserved quirks (as in the JAX package): the aggressive pass hardcodes
psig=.05 regardless of config; the noise filter runs to fixpoint with a
large safety cap.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import scipy.stats
import torch

from hic_genome_assembler_tpu_torch.ops import count_kernels, hypergeom
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import profiling


def hyper_geom_sf(x, M, n, N) -> np.ndarray:
    """P(X >= x) for a hypergeometric(M, n, N) draw, vectorized."""
    return scipy.stats.hypergeom.sf(np.asarray(x) - 1, M, n, N)


def sliding_window_break_signals(sig: np.ndarray, window: int) -> np.ndarray:
    """Left-half minus right-half sums per step.

    Returns empty when window >= len(sig).  Steps whose right half is
    truncated score 0.
    """
    n = len(sig)
    if window >= n:
        return np.zeros(0, dtype=np.int64)
    sig = np.asarray(sig, dtype=np.int64)
    csum = np.concatenate([[0], np.cumsum(sig)])
    i = np.arange(n - window)
    left = csum[i + window] - csum[i]
    hi = i + 2 * window
    truncated = hi > n
    right = csum[np.minimum(hi, n)] - csum[i + window]
    return np.where(truncated, 0, left - right)


# Below this size the whole count scan runs on the host in numpy.  Kept
# equal to the JAX package's threshold so that both packages take their
# device path on the same inputs and give the same cut lists; the
# crossover on an H100 has not been measured yet.
_HOST_N = 4096


def _host_growing_counts(rank_mat: np.ndarray, start: int) -> np.ndarray:
    n = rank_mat.shape[0]
    rows = np.arange(n, dtype=np.int64)[:, None]
    cols = np.arange(n, dtype=np.int64)[None, :]
    mask = (cols < rows - start) & (rank_mat >= start) & (rank_mat <= rows)
    return mask.sum(axis=1).astype(np.int32)


def _host_fixed_counts(rank_mat: np.ndarray, start: int, cut: int) -> np.ndarray:
    width = max(cut - start, 0)
    window = rank_mat[:, :width]
    return ((window >= start) & (window <= cut)).sum(axis=1).astype(np.int32)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """``t`` as a host array: a pageable readback from a card, counted in
    ``part1/pageable_copies``."""
    profiling.count_copy("part1/pageable_copies", t.device)
    return t.cpu().numpy()


def _pow2_params(rows: List[Tuple[int, int, int]]) -> np.ndarray:
    """int32[Kp, 3] params with K padded to a power of two by repeating the
    last row (bounds the distinct batch shapes)."""
    K = len(rows)
    Kp = 1 << max(K - 1, 0).bit_length()
    params = np.zeros((Kp, 3), dtype=np.int32)
    params[:K] = rows
    params[K:] = params[K - 1]
    return params


class RankCounts:
    """Device-resident rank matrix blocks + cached count scans.

    ``rank_mat`` is a numpy array, an integer torch tensor, or a list of
    consecutive row pieces of one (device mode ranks on the device, per
    mesh position).  Without a mesh, below ``_HOST_N`` rows the scans run
    on the host in numpy and tensors are read back; above, the matrix is
    one block on ``device`` (a 1x1 placement).

    ``mesh`` (a ``parallel.mesh.Mesh``): ``_HOST_N`` is bypassed, as in the
    JAX package, and the matrix is placed as ``(data, model)`` blocks.
    Either way the matrix is square-padded with -1 to a multiple of
    ``32 * lcm(data, model)`` (every block row starts on a 16-byte
    boundary), stored as ``count_kernels.rank_dtype`` of that size (int16
    below 32,767, else int32), and each tensor piece is copied into its
    blocks from where it lies, without a trip through the host.  Every scan launches the counts kernel
    on each block with its offsets; the model-axis partials are summed on
    the row block's first device and the row blocks gathered on the mesh's
    first device before any readback (``count_kernels.counts_many_blocks``).
    The kernel's loop stops at each row's prefix end, so a fixed window
    reads only its own columns.  Counts are integers: equal on every
    placement.
    """

    def __init__(
        self,
        rank_mat: Union[np.ndarray, torch.Tensor, Sequence[torch.Tensor]],
        device: torch.device,
        mesh: Optional[pm.Mesh] = None,
    ):
        pieces = list(rank_mat) if isinstance(rank_mat, (list, tuple)) else [rank_mat]
        self.n = sum(int(p.shape[0]) for p in pieces)
        self._host: Optional[np.ndarray] = None
        self._blocks: List[List[torch.Tensor]] = []
        # (start,) / (start, cut) -> counts: the cut-noise filter re-requests
        # the same windows across its convergence rounds
        self._cache: Dict[tuple, np.ndarray] = {}
        # dispatched batches whose readback is deferred: (keys, device_out),
        # read back together when any of their keys is first consumed
        self._pending: List[tuple] = []
        if mesh is None and self.n < _HOST_N:
            self.where = "host"
            self._host = np.concatenate(
                [np.asarray(_to_host(p) if isinstance(p, torch.Tensor) else p, dtype=np.int32)
                 for p in pieces]
            )
            return
        self._mesh = pm.make_mesh((1, 1), devices=[device]) if mesh is None else mesh
        t = pm.pad_to_multiple(self.n, 32 * math.lcm(*self._mesh.devices.shape))
        pieces = [
            p if isinstance(p, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(p))
            for p in pieces
        ]
        self._blocks = pm.place_blocks(self._mesh, pieces, t, t, fill=-1,
                                       dtype=count_kernels.rank_dtype(t))
        # "cuda:0" for one block, else the mesh ("mesh 2x2 cuda:0")
        self.where = str(self._blocks[0][0].device) if mesh is None else mesh.describe()

    # -- batched dispatch plumbing ---------------------------------------

    def _dispatch_many(self, params: np.ndarray):
        """One batched count launch per block for (start, cut, flag) rows;
        returns the device tensor [Kp, n_rows], not read back."""
        return count_kernels.counts_many_blocks(self._blocks, params, self._mesh.first)

    def _in_pending(self, key: tuple) -> bool:
        return any(key in keys for keys, _out in self._pending)

    def _materialize_pending(self, key: tuple) -> bool:
        """If ``key`` sits in a pending batch, read back EVERY pending batch
        and cache their rows."""
        if not self._in_pending(key):
            return False
        for keys, out in self._pending:
            rows = _to_host(out[:, : self.n])
            for k2, row in zip(keys, rows):
                if k2 is not None and k2 not in self._cache:
                    self._cache[k2] = np.ascontiguousarray(row, dtype=np.int32)
        self._pending.clear()
        return True

    def prefetch_growing(self, starts: Sequence[int], limit: int = 16) -> None:
        """Dispatch growing scans for many starts in ONE launch, readback
        deferred: each scan's hit list predicts later scan starts."""
        if self._host is not None:
            return
        todo: List[int] = []
        for s in starts:
            s = int(s)
            if not (0 <= s < self.n):
                continue
            if (s,) in self._cache or self._in_pending((s,)) or s in todo:
                continue
            todo.append(s)
            if len(todo) >= limit:
                break
        if not todo:
            return
        params = _pow2_params([(s, 0, 1) for s in todo])
        out = self._dispatch_many(params)
        keys = [(s,) for s in todo] + [None] * (len(params) - len(todo))
        self._pending.append((keys, out))

    def prefetch_fixed_pairs(self, pairs: Sequence[tuple], chunk: int = 2048) -> None:
        """Batch-load fixed counts for explicit (start, cut) pairs: one
        launch per block + one readback per ``chunk``."""
        missing = []
        seen = set()
        for s, c in pairs:
            k = (int(s), int(c))
            if k not in self._cache and not self._in_pending(k) and k not in seen:
                seen.add(k)
                missing.append(k)
        if not missing or self._host is not None:
            # host mode computes only the windows actually consulted
            return
        if self._mesh.first.type == "cpu":
            # plain CPU counts: a batch only adds the pow2 padding rows
            for s, c in missing:
                self.fixed(s, c)
            return
        for ofs in range(0, len(missing), chunk):
            blk = missing[ofs : ofs + chunk]
            params = _pow2_params([(s, c, 0) for s, c in blk])
            rows = _to_host(self._dispatch_many(params)[: len(blk), : self.n])
            for k2, row in zip(blk, rows):
                self._cache[k2] = np.ascontiguousarray(row, dtype=np.int32)

    def _scan(self, key: tuple, params: List[int], host_fn) -> np.ndarray:
        """One count scan: cached, or read from a pending batch, or run on
        the host or launched on the blocks."""
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        if self._pending and self._materialize_pending(key):
            return self._cache[key]
        if self._host is not None:
            out = host_fn(self._host, *key)
        else:
            out = _to_host(self._dispatch_many(np.array([params]))[0, : self.n])
        self._cache[key] = out
        return out

    def growing(self, start: int) -> np.ndarray:
        return self._scan((int(start),), [int(start), 0, 1], _host_growing_counts)

    def fixed(self, start: int, cut: int) -> np.ndarray:
        return self._scan((int(start), int(cut)), [int(start), int(cut), 0], _host_fixed_counts)

    def prefetch_fixed(self, start: int, cuts: Sequence[int]) -> None:
        """Batch-load fixed counts for every (start, cut) not yet cached."""
        self.prefetch_fixed_pairs([(int(start), int(c)) for c in cuts])


def find_matrix_pvalue_breakpoints(
    counts: RankCounts,
    start: int,
    min_size: int,
    world_size: int,
    psig: float = 0.05,
) -> Tuple[np.ndarray, np.ndarray]:
    """Leftmost-breakpoint scan from ``start``.

    Returns (cut strengths, cut indices relative to ``start``).
    """
    n = counts.n
    M = world_size
    ws = min_size
    break_sig = 0
    loop_count = 0
    row_counts = counts.growing(start)  # independent of M: compute once

    pre_cut_vals: np.ndarray = np.zeros(0)
    pre_cut_inds: np.ndarray = np.zeros(0, dtype=np.int64)
    while True:
        while True:
            rows = np.arange(start + 1, n)
            curr = rows - start
            sig = hypergeom.ge_significant(row_counts[rows], M, curr, curr, psig)
            # dist_sigs[0] = 0 sentinel, then one flag per row
            dist_sigs = np.concatenate([[0], sig.astype(np.int64)])
            loop_count += 1
            if dist_sigs.sum() / len(dist_sigs) >= 0.9:
                prev_M = M
                M = int(M - start)
                print(f"- M value (world_size) changed to dynamic {prev_M} --> {M}")
            else:
                break_sig = 1
            if break_sig == 1 or loop_count >= 5:
                break

        signals = sliding_window_break_signals(dist_sigs, ws)
        hits = np.nonzero(signals == min_size)[0]
        pre_cut_vals = signals[hits]
        pre_cut_inds = hits + min_size
        if len(pre_cut_inds) > 0:
            break
        prev_ws = ws
        ws -= 1
        if ws == 0:
            print(
                "- Warning - No cut index found after scanning through all "
                "window sizes between 1 and {}".format(min_size)
            )
            break
        print(
            "- Warning - No cut index found with window size of {}, "
            "decreasing by one to {}".format(prev_ws, ws)
        )
    return pre_cut_vals, pre_cut_inds


def pre_process_all_matrix_breakpoints(
    counts: RankCounts,
    min_size: int = 5,
    min_frac: float = 0.05,
    psig: float = 0.05,
) -> List[int]:
    """Aggressive leftmost-cut scan repeated from each new cut.

    NOTE: the inner scan always runs at psig=.05 (the reference hardcodes
    it); ``psig`` is accepted for signature parity.
    """
    n = counts.n
    stop_ind = int(n - (n * min_frac))
    ind = 0
    cinds: List[int] = []
    if min_frac == 1:
        return cinds
    while True:
        _vals, inds = find_matrix_pvalue_breakpoints(counts, ind, min_size, n - ind, psig=0.05)
        if len(inds) == 0:
            break
        prev_ind = ind
        ind += int(inds[0])
        cinds.append(ind)
        # the scan's own hit list predicts the upcoming scan starts
        counts.prefetch_growing([prev_ind + int(h) for h in inds])
        print(ind, inds)
        if ind >= stop_ind or (n - ind) <= min_size:
            break
    print("- Breakpoints found {}".format(len(cinds)))
    return cinds


def filter_noisy_breakpoints(
    counts: RankCounts,
    original_inds: Sequence[int],
    psig: float = 0.05,
    max_global_rounds: int = 1000,
) -> List[int]:
    """Smooth an aggressive cut set to the most probable set.

    Per cut c: counted rank memberships + row-level sf; then a
    second-level sf on significant-row counts between cut indices; merge
    cuts with significant cross-links keeping the rightmost; iterate to
    fixpoint.
    """
    if len(original_inds) == 0:
        return []
    n = counts.n
    MD = int(n / 5)
    MAX_ROUNDS = 10 * len(original_inds)

    altered = list(original_inds)
    # every fixed window the filter can request is (s, c) with s in
    # {0} U cuts and c a LATER cut; prefetch each start's next-_DEPTH
    # neighbor windows in one batch, and bulk-load the rest mid-round on
    # the rare deep sweep
    _DEPTH = 16
    _cuts = sorted(int(c) for c in altered)
    _pairs = [(0, c) for c in _cuts[:_DEPTH]]
    for si, s in enumerate(_cuts):
        _pairs += [(s, c) for c in _cuts[si : si + _DEPTH]]
    if len(_pairs) <= 4096:
        counts.prefetch_fixed_pairs(_pairs)
    prev_filtered: Dict[int, str] = {"__sentinel__": ""}  # never equal on round 1
    filtered: Dict[int, str] = {}
    # sig flags depend only on (start, c) and counts.fixed is cached:
    # memoize across the convergence rounds
    _sig_memo: Dict[tuple, np.ndarray] = {}

    def _sig_for(start: int, c: int) -> np.ndarray:
        k = (int(start), int(c))
        hit = _sig_memo.get(k)
        if hit is None:
            row_counts = counts.fixed(start, c)
            hit = _sig_memo[k] = hypergeom.ge_significant(
                row_counts, n - start, c - start, c - start, psig
            )
        return hit
    for _global_round in range(max_global_rounds):
        start = 0
        filtered = {}
        round_count = 0
        while True:
            if round_count >= MAX_ROUNDS:
                print(
                    "- WARNING - Maximum number of rounds {} exceeded... Data "
                    "appears to be extremely noisy or something went wrong".format(MAX_ROUNDS)
                )
                break
            M = n - start
            noise_found = 0
            select_from = None
            if any(
                (int(start), int(c)) not in counts._cache
                for c in altered[: _DEPTH]
            ):
                counts.prefetch_fixed(start, altered)
            for i, c in enumerate(altered):
                if i == _DEPTH and len(altered) > _DEPTH:
                    # deep sweep: bulk-load the rest
                    counts.prefetch_fixed(start, altered)
                local_size = c - start
                rows = np.arange(n)
                sig = _sig_for(start, c)
                sig_flags = np.where(
                    (rows - start) > MD, 0, sig.astype(np.int64)
                )

                right_most = None
                right_most_ind = None
                sigs = []
                fc_prev = start
                for ai_ind, ai in enumerate(altered):
                    ps = sig_flags[fc_prev:ai]
                    if ai == fc_prev:
                        continue
                    fc_prev = ai
                    if len(ps) == 0:
                        break
                    x = int(ps.sum())
                    noise_pval = float(hyper_geom_sf(x, M, local_size, len(ps)))
                    if noise_pval < psig:
                        right_most = ai
                        right_most_ind = ai_ind
                        sigs.append([ai, [x, M, local_size, len(ps), noise_pval]])
                if sigs:
                    start = right_most
                    filtered[right_most] = ""
                    noise_found = 1
                    select_from = right_most_ind
                    print("- Right most sig pvalue coordinate found {}".format(right_most))
                    break
                else:
                    filtered[c] = ""
                    select_from = i
            round_count += 1
            if noise_found == 0:
                print("- Exiting algorithm... No significant connections found between current inds")
                break
            altered = altered[select_from:]
        if prev_filtered == filtered:
            print(
                "- Algorithm appears to have converged as previous cutindices "
                "match current cutindices. Exiting..."
            )
            break
        altered = sorted(filtered)
        prev_filtered = filtered
    return_inds = sorted(filtered)
    print("- Original cut indices {}".format(list(original_inds)))
    print("- Filtered cut indices {}".format(return_inds))
    return return_inds
