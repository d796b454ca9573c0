"""Part 2 — order & orient scaffolds within each chromosome.

Counterpart of ``hic_genome_assembler_tpu/models/part2_order.py``.  Per
chromosome: brute force over the nScaffolds largest scaffolds, greedy
insertion of the rest, then sliding-window refinement, every stage scored
on the device through ``ops.cost`` and decided on the host in f64.

The search coroutines and the scaffold model are copied from the JAX
module (which imports jax through its cost module), unchanged apart from
the run's ``PrecisionStats`` (carried by the ``ChromosomeScorer``): a
coroutine yields a tuple of launched device tensors and receives their
numpy copies.  ``_run_interleaved`` advances many chromosomes round-robin
so that one chromosome's device work overlaps the others' host decisions;
decisions are exactly the serial ones.  Every copy between the host and
the card goes through ``utils/transfer``: uploads from pinned memory
without waiting, readbacks started as soon as a coroutine yields and
waited for once per device and pass.

With a mesh (``parallel.mesh.Mesh``) the genome matrix is staged as
``(data, model)`` blocks and candidate batches are split over the data
axis.  With ``process_count`` > 1 each process searches its round-robin
shard of the chromosomes and writes a shard file; process 0 waits for the
shards that carry this run's fingerprint, merges them and writes the
order and plot-order files (``parallel.distributed``).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.io import filebus, hicpro
from hic_genome_assembler_tpu_torch.ops import cost as cost_ops
from hic_genome_assembler_tpu_torch.ops import perms
from hic_genome_assembler_tpu_torch.parallel import distributed
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import plots, profiling, transfer


@dataclass
class Scaffold:
    """Ordering state: orientation uniquely determines bin sequence
    ("+" = ascending binID = 5'->3')."""

    name: str
    bins_asc: List[int]
    orientation: str = "+"

    @property
    def bin_seq(self) -> List[int]:
        return self.bins_asc if self.orientation == "+" else self.bins_asc[::-1]

    @property
    def n_bins(self) -> int:
        return len(self.bins_asc)


def initiate_bins_and_scaffolds(
    node_list: Sequence[Sequence],
) -> Tuple[List[Scaffold], Dict[str, Scaffold]]:
    """Group [binID, scaffName] rows into size-descending Scaffolds.

    First-appearance dict order + stable size sort reproduces the
    reference's tie order.
    """
    by_name: Dict[str, Scaffold] = {}
    for bin_id, name in node_list:
        if name not in by_name:
            by_name[name] = Scaffold(name, [])
        by_name[name].bins_asc.append(bin_id)
    for s in by_name.values():
        s.bins_asc.sort()
    print("Scaffolds to order for this chromosome " + str(len(by_name)))
    ordered = sorted(by_name.values(), key=lambda s: len(s.bins_asc), reverse=True)
    return ordered, by_name


def get_chromosome_outline_coords(genome_order: List[List[Scaffold]]) -> List[int]:
    """Cumulative bin counts per chromosome."""
    coords, index = [], 0
    for group in genome_order:
        for s in group:
            index += s.n_bins
        coords.append(index)
    return coords


class _ChromosomeContext:
    """Full-genome matrix + binID -> row index lookup.

    The genome matrix is staged once (float32) as the ``(data, model)``
    blocks of the mesh, or as one block on ``device`` without one
    (``put_matrix_padded``); chromosome submatrices are assembled from the
    blocks on the placement's first device, the context's ``device``
    (``gather_device``), so a chromosome's scorer never copies its matrix
    from the host."""

    def __init__(
        self,
        matrix: np.ndarray,
        bin_list: List[hicpro.Bin],
        device: torch.device,
        mesh: Optional[pm.Mesh] = None,
    ):
        self.matrix = np.asarray(matrix, dtype=np.float64)
        self.bin_index = {b.ID: i for i, b in enumerate(bin_list)}
        self.mesh = mesh
        # where the matrix's blocks lie: the mesh, or one block on device
        self._place = pm.make_mesh((1, 1), devices=[device]) if mesh is None else mesh
        self.device = self._place.first
        self._blocks: Optional[List[List[torch.Tensor]]] = None

    def gather(self, bin_ids: Sequence[int]) -> np.ndarray:
        idx = [self.bin_index[b] for b in bin_ids]
        return self.matrix[np.ix_(idx, idx)]

    def gather_device(self, bin_ids: Sequence[int]) -> torch.Tensor:
        """The float32 submatrix for the given bins on ``device``, from the
        matrix's blocks: each block selects the requested rows and columns
        it holds, and the pieces are written into place."""
        idx = np.fromiter((self.bin_index[b] for b in bin_ids), dtype=np.int64)
        if self._blocks is None:
            self._blocks, _n = pm.put_matrix_padded(self._place, self.matrix.astype(np.float32))
        rb, cb = self._blocks[0][0].shape
        out = torch.empty((idx.size, idx.size), dtype=torch.float32, device=self.device)
        for i, row_blocks in enumerate(self._blocks):
            rsel = np.nonzero(idx // rb == i)[0]
            if not rsel.size:
                continue
            for j, blk in enumerate(row_blocks):
                csel = np.nonzero(idx // cb == j)[0]
                if not csel.size:
                    continue
                rloc = transfer.to_device(idx[rsel] - i * rb, blk.device)
                cloc = transfer.to_device(idx[csel] - j * cb, blk.device)
                piece = blk.index_select(0, rloc).index_select(1, cloc).to(self.device)
                if rsel.size == csel.size == idx.size:
                    return piece  # one block holds every requested bin
                r_d = transfer.to_device(rsel, self.device)
                c_d = transfer.to_device(csel, self.device)
                out[r_d[:, None], c_d[None, :]] = piece
        return out


def _drive(gen):
    """Run a search coroutine to completion serially."""
    try:
        handles = next(gen)
        while True:
            pending = transfer.start_readback(handles)
            with profiling.timer("part2/scheduler_readback_wait"):
                (host,) = transfer.finish_readback([pending])
            handles = gen.send(host)
    except StopIteration as e:
        return e.value


def _run_interleaved(coros: List, max_live: Optional[int] = None) -> List:
    """Round-robin scheduler for independent search coroutines.

    At most ``max_live`` chromosomes are in flight (default 10, env
    HIC_INTERLEAVE_WINDOW): each live search keeps its pair table and
    candidate batches on the device.  A coroutine's readback starts as
    soon as it yields (``transfer.start_readback``: copies into pinned
    host memory, queued behind its kernels, as the JAX package's
    ``_host_async``), so the card copies while the host advances the
    others.  Each pass then waits for every live coroutine's readbacks
    with one fence per device (``transfer.finish_readback``, the JAX
    package's one ``device_get``), and advances each coroutine with its
    own values.  A coroutine's control flow depends only on what it
    receives, so decisions are exactly the serial ones.
    """
    if max_live is None:
        max_live = max(1, int(os.environ.get("HIC_INTERLEAVE_WINDOW", "10")))
    results = [None] * len(coros)
    pending = [None] * len(coros)
    live: List[int] = []
    next_up = 0

    def _fill():
        nonlocal next_up
        while next_up < len(coros) and len(live) < max_live:
            i = next_up
            next_up += 1
            try:
                pending[i] = transfer.start_readback(next(coros[i]))
                live.append(i)
            except StopIteration as e:
                results[i] = e.value

    _fill()
    while live:
        batch = list(live)
        live.clear()
        with profiling.timer("part2/scheduler_readback_wait"):
            all_host = transfer.finish_readback([pending[i] for i in batch])
        for i, host in zip(batch, all_host):
            try:
                with profiling.timer("part2/host_decide"):
                    handles = coros[i].send(host)
                pending[i] = transfer.start_readback(handles)
                live.append(i)
            except StopIteration as e:
                results[i] = e.value
        _fill()
    return results


def brute_force_best(
    chrom: cost_ops.ChromosomeScorer,
    head_ids: List[int],
    names: Sequence[str],
) -> Tuple[List[int], List[int], float]:
    """Stage 1: exhaustive search over the largest scaffolds.

    Returns (order ids, orientation flags, best cost)."""
    return _drive(_brute_force_coro(chrom, head_ids, names))


def _brute_force_coro(
    chrom: cost_ops.ChromosomeScorer,
    head_ids: List[int],
    names: Sequence[str],
):
    sub = chrom.subset(head_ids)
    orders = perms.order_batch(len(head_ids))
    orients = perms.orient_batch(len(head_ids))
    if sub.degenerate:
        print(
            "WARNING/ERROR - Zero contact values found between scaffolds "
            "assigned to chromosome group "
            + ",".join(names[i] for i in head_ids)
        )
        print(
            "This chromosome will be returned with an arbitrary order and "
            "orientation. This error is likely caused by too small of "
            "scaffolds being included in the assembly process whereby they "
            "do not share any contact values"
        )
        print(
            "It is recommended that these small scaffolds be removed from "
            "the validpairs file produced by HiCpro prior to ICE "
            "normalization to generate a cleaner contact map"
        )
        return list(map(int, orders[0])), list(map(int, orients[0])), 0.0
    n_cand = len(orders) * len(orients)
    print("Initial permutations to test " + str(n_cand) + "...")
    R = len(orients)
    handles, finish = sub.score_batch_topk_async(orders, orients)
    host = yield handles
    cand_idx, _vals, floor = finish(host)
    winner, best = cost_ops.argmax_reference_ties_sparse(
        cand_idx,
        rescore=lambda i: sub.score_host(orders[i // R], orients[i % R]),
        fast_vals=_vals,
        second_floor=floor,
        escalate=lambda: sub.score_batch(orders, orients),
        stats=chrom.stats,
    )
    return list(map(int, orders[winner // R])), list(map(int, orients[winner % R])), best


def order_remainder_scaffolds(
    chrom: cost_ops.ChromosomeScorer,
    order_ids: List[int],
    orient_flags: List[int],
    remaining_ids: List[int],
) -> Tuple[List[int], List[int], float]:
    """Stage 2: greedy insertion, including the final self-reinsertion
    when ``remaining`` is empty.  Per step, the 2(K+1) slot x orientation
    candidates are scored in one device batch."""
    return _drive(_greedy_coro(chrom, order_ids, orient_flags, remaining_ids))


def _greedy_coro(
    chrom: cost_ops.ChromosomeScorer,
    order_ids: List[int],
    orient_flags: List[int],
    remaining_ids: List[int],
):
    W = chrom.cand_width
    B_max = ((2 * (chrom.S + 1) + 15) // 16) * 16  # 2(S+1) rounded up to 16
    pad = chrom.pad_id
    best_cost = 0.0
    while True:
        if remaining_ids:
            new = remaining_ids.pop(0)
            new_state = 0  # scaffolds enter greedy as "+"
        else:
            new = order_ids.pop(-1)
            new_state = orient_flags.pop(-1)
        K = len(order_ids)
        n_cand = 2 * (K + 1)
        cand_orders = np.full((B_max, W), pad, dtype=np.int32)
        cand_orients = np.zeros((B_max, W), dtype=np.int32)
        meta: List[Tuple[int, int]] = []
        state = new_state
        row = 0
        for slot in range(K + 1):
            for orientation in (state, 1 - state):
                ids = order_ids[:slot] + [new] + order_ids[slot:]
                flags = orient_flags[:slot] + [orientation] + orient_flags[slot:]
                cand_orders[row, : K + 1] = ids
                cand_orients[row, : K + 1] = flags
                meta.append((slot, orientation))
                row += 1
            state = 1 - state
        cand_orders[row:] = cand_orders[row - 1]
        cand_orients[row:] = cand_orients[row - 1]

        sub = chrom.subset(order_ids + [new])
        handles, finish = sub.score_pairs_async(cand_orders, cand_orients)
        host = yield handles
        costs = finish(host)[:n_cand]
        # fast-precision near-zero maxima still go through f64 re-scoring
        # (the reference accepts only candidates with exact cost > 0)
        scale = max(float(np.abs(costs).max()), 1.0)
        near = 1e-6 * scale
        cmax = float(costs.max()) if len(costs) else 0.0
        guard = -cost_ops._F32_MARGIN * scale
        skip = sub.degenerate or cmax <= guard
        if not skip and cmax <= -near:
            # gray zone between the cheap skip band and the hard f32 error
            # budget: confirm in f64 that NO candidate above the budget is
            # actually positive
            ex_max = -np.inf
            for ci in np.nonzero(costs > guard)[0]:
                ex = sub.score_host(cand_orders[int(ci)], cand_orients[int(ci)])
                chrom.stats.observe(float(costs[ci]), ex)
                ex_max = max(ex_max, ex)
            skip = ex_max <= 0.0
        if skip:
            slot, orientation = 0, 0
            best_cost = 0.0
        else:
            winner, best_cost = cost_ops.argmax_reference_ties(
                costs,
                rescore=lambda i: sub.score_host(cand_orders[i], cand_orients[i]),
                stats=chrom.stats,
            )
            if best_cost <= 0.0:
                slot, orientation = 0, 0
            else:
                slot, orientation = meta[winner]
        order_ids.insert(slot, new)
        orient_flags.insert(slot, orientation)
        if len(remaining_ids) == 0:
            break
    return order_ids, orient_flags, best_cost


def scan_ordering(
    chrom: cost_ops.ChromosomeScorer,
    order_ids: List[int],
    orient_flags: List[int],
    best_cost: float,
    scan_scaffolds: int = 5,
) -> Tuple[List[int], List[int], float]:
    """Stage 3: sliding-window refinement against the full chromosome
    matrix; sweeps repeat until a full pass makes no improvement."""
    return _drive(
        _scan_coro(chrom, order_ids, orient_flags, best_cost, scan_scaffolds)
    )


def _scan_coro(
    chrom: cost_ops.ChromosomeScorer,
    order_ids: List[int],
    orient_flags: List[int],
    best_cost: float,
    scan_scaffolds: int = 5,
):
    sub = chrom.full()
    w = scan_scaffolds
    S = len(order_ids)
    orders_w = perms.order_batch(w)
    orients_w = perms.orient_batch(w)
    R = len(orients_w)
    B_w = len(orders_w) * R  # candidates per window position
    # Speculative batching: every window position up to the FIRST
    # improvement sees the sweep's current ordering unchanged, so a block
    # of upcoming windows is scored in one launch; on an improvement at
    # window k, positions > k are discarded and re-speculated.
    spec_depth = 16

    W = chrom.cand_width

    idx_w = np.repeat(np.asarray(orders_w, dtype=np.int64), R, axis=0)  # [B_w, w]
    orient_blk = np.tile(
        np.asarray(orients_w, dtype=np.int32), (len(orders_w), 1)
    )  # [B_w, w]

    def _window_candidates(i0: int, n_win: int) -> Tuple[np.ndarray, np.ndarray]:
        base_o = np.full(W, chrom.pad_id, dtype=np.int32)
        base_o[:S] = order_ids
        base_f = np.zeros(W, dtype=np.int32)
        base_f[:S] = orient_flags
        cand_orders = np.tile(base_o, (spec_depth * B_w, 1))
        cand_orients = np.tile(base_f, (spec_depth * B_w, 1))
        for k in range(n_win):
            i = i0 + k
            blk = slice(k * B_w, (k + 1) * B_w)
            cand_orders[blk, i : i + w] = base_o[i + idx_w]
            cand_orients[blk, i : i + w] = orient_blk
        return cand_orders, cand_orients

    # f64 re-score cache keyed by the candidate's FULL ordering
    f64_cache: dict = {(tuple(order_ids), tuple(map(int, orient_flags))): best_cost}

    round_number = 0
    while True:
        improved = False
        print("Working on round " + str(round_number + 1) + " of final step...")
        i = 0
        while i <= S - w:
            n_win = min(spec_depth, S - w + 1 - i)
            cand_orders, cand_orients = _window_candidates(i, n_win)
            handles, finish = sub.score_pairs_async(cand_orders, cand_orients)
            host = yield handles
            costs_all = finish(host)
            scale = max(abs(best_cost), 1.0)
            trigger = best_cost - 1e-5 * scale
            guard = best_cost - cost_ops._F32_MARGIN * scale
            advanced = n_win
            for k in range(n_win):
                costs = costs_all[k * B_w : (k + 1) * B_w]
                if sub.degenerate:
                    continue
                iw = i + k

                def _rescore(c: int, iw=iw) -> float:
                    o, r = orders_w[c // R], orients_w[c % R]
                    full_o = list(order_ids)
                    full_r = list(orient_flags)
                    full_o[iw : iw + w] = [order_ids[iw + kk] for kk in o]
                    full_r[iw : iw + w] = list(map(int, r))
                    key = (tuple(full_o), tuple(full_r))
                    if key not in f64_cache:
                        profiling.count("part2/f64_rescore_miss")
                        f64_cache[key] = sub.score_host(full_o, full_r)
                    else:
                        profiling.count("part2/f64_rescore_hit")
                    return f64_cache[key]

                cmax = float(costs.max())
                if cmax <= trigger:
                    if cmax > guard:
                        # gray zone between the skip trigger and the f32
                        # error budget: confirm the skip in f64 for EVERY
                        # candidate above the guard
                        ex_max = -np.inf
                        for ci in np.nonzero(costs > guard)[0]:
                            ex = _rescore(int(ci))
                            chrom.stats.observe(float(costs[ci]), ex)
                            ex_max = max(ex_max, ex)
                        if ex_max <= best_cost:
                            continue
                        # fast precision erred past the trigger: fall
                        # through to the exact decision
                    else:
                        continue

                winner, exact = cost_ops.argmax_reference_ties(
                    costs, rescore=_rescore, stats=chrom.stats
                )
                if exact > best_cost:
                    best_cost = exact
                    o, r = orders_w[winner // R], orients_w[winner % R]
                    order_ids[iw : iw + w] = [order_ids[iw + kk] for kk in o]
                    orient_flags[iw : iw + w] = list(map(int, r))
                    improved = True
                    # results past this window were computed against the
                    # pre-adoption ordering: re-speculate from iw + 1
                    advanced = k + 1
                    break
            i += advanced
        round_number += 1
        if not improved:
            break
    print("Sliding window conversion after " + str(round_number) + " rounds")
    print("Best cost at the end of the final step = " + str(best_cost))
    return order_ids, orient_flags, best_cost


def _order_chromosome_coro(
    chrom_group: Sequence[Sequence],
    ctx: _ChromosomeContext,
    stats: cost_ops.PrecisionStats,
    n_scaffolds: int = 6,
    scan_scaffolds: int = 5,
):
    if n_scaffolds >= 9:
        print("Number of initial scaffolds to order by brute force method is set too high...")
        print(str(perms.calc_possible_perms(n_scaffolds)) + " Different permutations would need to be calculated with current setting")
        print("Setting number of initial scaffolds to 8")
        n_scaffolds = 8
    if scan_scaffolds > n_scaffolds:
        scan_scaffolds = n_scaffolds

    scaffold_list, _ = initiate_bins_and_scaffolds(chrom_group)
    sizes = [s.n_bins for s in scaffold_list]
    names = [s.name for s in scaffold_list]
    canonical_bins = [b for s in scaffold_list for b in s.bins_asc]
    with profiling.timer("part2/pair_table_build"):
        chrom = cost_ops.ChromosomeScorer(
            ctx.gather(canonical_bins),
            sizes,
            ctx.device,
            device_sub=ctx.gather_device(canonical_bins),
            stats=stats,
            mesh=ctx.mesh,
        )
    head_ids = list(range(min(n_scaffolds, len(scaffold_list))))
    tail_ids = list(range(len(head_ids), len(scaffold_list)))
    # under the interleaved scheduler these stage timers measure the
    # coroutine's SPAN (other chromosomes' work overlaps inside it)
    with profiling.timer("part2/brute_force"):
        order_ids, orient_flags, _bf = yield from _brute_force_coro(
            chrom, head_ids, names
        )
    with profiling.timer("part2/greedy_insertion"):
        order_ids, orient_flags, best_cost = yield from _greedy_coro(
            chrom, order_ids, orient_flags, tail_ids
        )
    print("BestCost at the end of first two steps " + str(best_cost))
    if len(order_ids) > n_scaffolds:
        with profiling.timer("part2/sliding_window"):
            order_ids, orient_flags, best_cost = yield from _scan_coro(
                chrom, order_ids, orient_flags, best_cost, scan_scaffolds
            )
    print("Final ordering...")
    ordered: List[Scaffold] = []
    for gid, e in zip(order_ids, orient_flags):
        s = scaffold_list[gid]
        s.orientation = "-" if e else "+"
        ordered.append(s)
        print(s.name, s.orientation)
    return ordered


def order_chromosome(
    chrom_group: Sequence[Sequence],
    ctx: _ChromosomeContext,
    n_scaffolds: int = 6,
    scan_scaffolds: int = 5,
    stats: Optional[cost_ops.PrecisionStats] = None,
) -> List[Scaffold]:
    """One chromosome's full search, run serially: brute force, greedy
    insertion and the sliding window against one pair-profile table."""
    stats = cost_ops.PrecisionStats() if stats is None else stats
    return _drive(_order_chromosome_coro(chrom_group, ctx, stats, n_scaffolds, scan_scaffolds))


def order_genome(
    matrix: np.ndarray,
    chrom_list: List[List[List[object]]],
    bin_list: List[hicpro.Bin],
    resolution: int,
    device: torch.device,
    n_scaffolds: int = 6,
    scan_scaffolds: int = 5,
    plot_chrom: bool = True,
    save_plot_dir: Optional[str] = None,
    plot_title_suffix: Optional[str] = None,
    stats: Optional[cost_ops.PrecisionStats] = None,
    mesh: Optional[pm.Mesh] = None,
    chrom_indices: Optional[Sequence[int]] = None,
) -> List[Optional[List[Scaffold]]]:
    """All chromosomes, interleaved so that their device work overlaps.
    ``stats`` collects the run's fast-vs-exact observations (a fresh
    ``PrecisionStats`` when omitted).

    ``chrom_indices``: the chromosome shard of this process in an EP run
    (``distributed.shard_chromosomes``); only those chromosomes are
    searched, and the returned list holds ``None`` for the others so that
    global numbering is kept for the shard writer."""
    start = time.time()
    stats = cost_ops.PrecisionStats() if stats is None else stats
    ctx = _ChromosomeContext(matrix, bin_list, device, mesh=mesh)
    owned = set(range(len(chrom_list))) if chrom_indices is None else set(chrom_indices)

    def _with_header(i, chrom_group):
        print("#####################\n#####################")
        print("Working on Chr_" + str(i + 1) + "...")
        result = yield from _order_chromosome_coro(
            chrom_group, ctx, stats, n_scaffolds=n_scaffolds, scan_scaffolds=scan_scaffolds
        )
        return result

    owned_order = [i for i in range(len(chrom_list)) if i in owned]
    results = _run_interleaved([_with_header(i, chrom_list[i]) for i in owned_order])
    by_index = dict(zip(owned_order, results))
    genome_order = [by_index.get(i) for i in range(len(chrom_list))]

    if plot_chrom and save_plot_dir and plots.available():
        for i, chrom_order in enumerate(genome_order):
            if chrom_order is None:
                continue
            name = "Chr_" + str(i + 1)
            plots.plot_contact_map(
                ctx.gather([b for s in chrom_order for b in s.bin_seq]),
                resolution=resolution,
                tick_count=11,
                w_inches=24,
                h_inches=24,
                low_pct=1,
                high_pct=98,
                save_plot=save_plot_dir + "/" + name + ".png",
                title=name,
                title_suffix=plot_title_suffix,
            )
    print("RunTime for total genome with plotting and saving .pngs = " + str(time.time() - start))
    return genome_order


def _reconstruct_genome_order(
    chrom_list: List[List[List[object]]], order_file: str
) -> List[List[Scaffold]]:
    """The whole genome order (Scaffolds with bin sequences) from a merged
    chromosome-order file and the part-1 groups: orientation determines
    the bin sequence, so the merging process can write the plot order of
    chromosomes it did not search."""
    orderings = filebus.read_chromosome_ordering(order_file)
    genome_order: List[List[Scaffold]] = []
    for chrom_group, ordering in zip(chrom_list, orderings):
        _, by_name = initiate_bins_and_scaffolds(chrom_group)
        ordered = []
        for name, orientation in ordering:
            s = by_name[name]
            s.orientation = orientation
            ordered.append(s)
        genome_order.append(ordered)
    return genome_order


def _wait_for_shards(
    paths: Sequence[str], fingerprint: str, timeout_s: float, poll_s: float = 0.5
) -> None:
    """Barrier on shard files that carry this run's fingerprint: a
    leftover file with another header (or none) counts as missing until
    its owner overwrites it."""
    deadline = time.time() + timeout_s
    while True:
        missing = [p for p in paths if distributed.shard_fingerprint(p) != fingerprint]
        if not missing:
            return
        if time.time() > deadline:
            raise TimeoutError(
                f"shards with run fingerprint {fingerprint!r} never appeared: {missing}"
            )
        time.sleep(poll_s)


def run_pipeline(
    hic_pro_bed_file: str,
    hic_pro_bias_file: str,
    hic_pro_matrix_file: str,
    chromosome_group_file: str,
    chromosome_order_file: str,
    save_plots_directory: str,
    chromosome_plot_suffix: str,
    full_genome_plot: str,
    full_genome_plot_title: str,
    plot_order_file: str,
    n_scaffolds: int,
    scan_scaffolds: int,
    resolution: int,
    device: torch.device,
    mesh: Optional[pm.Mesh] = None,
    process_index: int = 0,
    process_count: int = 1,
    shard_wait_s: float = 3600.0,
) -> cost_ops.PrecisionStats:
    """Part 2 on ``device`` (or on ``mesh``); returns the run's precision
    statistics.

    ``process_index`` / ``process_count``: chromosome sharding across
    processes (EP).  Each process searches its round-robin shard and writes
    ``chromosome_order_file + '.shard<p>'`` atomically; processes other
    than 0 then return, and process 0 waits up to ``shard_wait_s`` for the
    shards carrying this run's fingerprint, merges them and writes the
    order and plot-order files, as in the JAX package."""
    print("########################################")
    print("### Working on Part2 of the pipeline ###")
    start = time.time()
    profiling.reset()
    stats = cost_ops.PrecisionStats()
    with profiling.timer("part2/ingest"):
        bin_dict = filebus.read_groupings_to_valid_bins(chromosome_group_file)
        bin_list = hicpro.initiate_loci(hic_pro_bed_file, hic_pro_bias_file, binID_dict=bin_dict)
        adj = hicpro.build_adjacency_matrix(hic_pro_matrix_file, bin_list)
        chrom_list = filebus.read_chroms_from_file(chromosome_group_file)

    chrom_indices = None
    run_fp = None
    if process_count > 1:
        # Each rank removes its own stale shard; every other leftover is
        # ignored by the barrier unless it carries this run's fingerprint
        # (a deterministic run with identical inputs writes the same bytes).
        run_fp = distributed.run_fingerprint(
            chromosome_group_file, n_scaffolds, scan_scaffolds, resolution, process_count,
            data_files=(hic_pro_bed_file, hic_pro_bias_file, hic_pro_matrix_file),
        )
        try:
            os.remove(chromosome_order_file + f".shard{process_index}")
        except FileNotFoundError:
            pass
        chrom_indices = distributed.shard_chromosomes(len(chrom_list), process_index, process_count)
        print(
            "- EP shard: process {}/{} owns chromosomes {}".format(
                process_index, process_count, [c + 1 for c in chrom_indices]
            )
        )

    genome_order = order_genome(
        adj,
        chrom_list,
        bin_list,
        resolution,
        device,
        n_scaffolds=n_scaffolds,
        scan_scaffolds=scan_scaffolds,
        plot_chrom=True,
        save_plot_dir=save_plots_directory,
        plot_title_suffix=chromosome_plot_suffix,
        stats=stats,
        mesh=mesh,
        chrom_indices=chrom_indices,
    )

    if process_count > 1:
        shard_path = chromosome_order_file + f".shard{process_index}"
        distributed.write_shard_orderings(
            {
                i + 1: [(s.name, s.orientation) for s in group]
                for i, group in enumerate(genome_order)
                if group is not None
            },
            shard_path,
            fingerprint=run_fp,
        )
        if process_index != 0:
            print("Total run-time  for Part2 = " + str(time.time() - start))
            print("- " + stats.summary())
            print(
                "- Part 2 shard {} written; process 0 merges the canonical "
                "order file".format(shard_path)
            )
            return stats
        shard_files = [chromosome_order_file + f".shard{p}" for p in range(process_count)]
        _wait_for_shards(shard_files, run_fp, shard_wait_s)
        distributed.merge_shard_orderings(
            shard_files, len(chrom_list), chromosome_order_file, fingerprint=run_fp
        )
        genome_order = _reconstruct_genome_order(chrom_list, chromosome_order_file)

    if full_genome_plot and plots.available():
        outline = get_chromosome_outline_coords(genome_order)
        ctx = _ChromosomeContext(adj, bin_list, device)
        full_bins = [b for group in genome_order for s in group for b in s.bin_seq]
        plots.plot_contact_map(
            ctx.gather(full_bins),
            resolution=resolution,
            tick_count=11,
            highlight_chroms=outline,
            w_inches=32,
            h_inches=32,
            low_pct=2,
            high_pct=98,
            save_plot=full_genome_plot,
            title=full_genome_plot_title,
        )
    filebus.write_scaffold_orderings(
        [[(s.name, s.orientation) for s in group] for group in genome_order],
        chromosome_order_file,
    )
    filebus.write_bin_ids_ordering(
        [(s.name, s.bin_seq) for group in genome_order for s in group],
        plot_order_file,
    )
    print("Total run-time  for Part2 = " + str(time.time() - start))
    profiling.print_summary()
    print("- " + stats.summary())
    print("- Part 2 (chromosome ordering) completed successfully")
    return stats
