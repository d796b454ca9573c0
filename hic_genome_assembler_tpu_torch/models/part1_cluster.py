"""Part 1 — cluster contact-map rows into chromosome groups.

Counterpart of ``hic_genome_assembler_tpu/models/part1_cluster.py``, every
branch: ``hyperGeom`` with ``matrixMode`` ``exact`` or ``device``, and
``hmm`` with ``hmmMode`` ``fast`` or ``exact``.  Ingest, distance
transform, the f64 similarity, log and (exact mode) rank matrix and the
Louvain tail are the port's copies of the JAX package's host modules (the
exact rank matrix by ``ops/matrix.rank_rows_desc_host``: numpy's argsort of
each row, rows shared out to threads a batch at a time).  On the given
torch device run: UPGMA's linkage on a CUDA device (``ops/linkage.py``,
scipy's bits), the rank-count scans of the breakpoint search (the port's
``RankCounts``), the rank argsort in device mode (``ops/matrix.py``) and
the HMM fits of the HMM branch (``cluster/hmm_cuts.py``), on one device
or, for the rank matrix, on the blocks of a mesh.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.cluster import breakpoints, hmm_cuts, louvain, upgma
from hic_genome_assembler_tpu_torch.io import filebus, hicpro
from hic_genome_assembler_tpu_torch.ops import matrix, oracle
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import plots, profiling


def permute_checked(adj: np.ndarray, order) -> np.ndarray:
    """``oracle.permute_symmetric`` after a bounds check: its native path
    (large f64 matrices) does not check ``order`` and would read out of
    bounds where ``np.ix_`` raises."""
    idx = np.asarray(order, dtype=np.int64)
    n = adj.shape[0]
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= n):
        raise IndexError(
            f"order holds indices in [{int(idx.min())}, {int(idx.max())}], outside [0, {n})"
        )
    return oracle.permute_symmetric(adj, idx)


# ---------------------------------------------------------------------------
# Louvain tail resolution
# ---------------------------------------------------------------------------

def modularity_remaining_data(
    adj: np.ndarray,
    bin_list: List[hicpro.Bin],
    cut_indices: List[int],
    n_rounds: int = 20,
    seed: int = 0,
) -> Tuple[np.ndarray, List[hicpro.Bin], List[int]]:
    """Partition the matrix tail past the last cut via Louvain; reorder
    the tail rows by community (large->small) and extend the cut list."""
    start_time = time.time()
    if len(cut_indices) == 0:
        print(
            "- Attempting to resolve groupings by modularity alone... This "
            "could take a while if matrix size is large and n_rounds is set "
            "high as well..."
        )
        cut_indices = [0]
    cut_indices = sorted(cut_indices)
    start = cut_indices[-1]
    adj = np.asarray(adj)
    tail = adj[start:, start:]

    print("- Maximizing so-called modularity...")
    print(
        "- Graph created with {} nodes, and {} edges".format(
            tail.shape[0], tail.shape[0] * (tail.shape[0] + 1) // 2
        )
    )
    print("- Performing {} rounds of the louvain method...".format(n_rounds))
    partition, _score = louvain.modularity_rounds(tail, louvain_rounds=n_rounds, seed=seed)

    group_sizes = Counter(partition[i] for i in range(tail.shape[0]))
    group_count = len(group_sizes)
    remaining_groups = [
        k for k, _v in sorted(group_sizes.items(), key=lambda kv: kv[1], reverse=True)
    ]

    remaining_order: List[int] = []
    for rg in remaining_groups:
        remaining_order.extend(
            start + i for i in range(tail.shape[0]) if partition[i] == rg
        )
        cut_indices.append(cut_indices[-1] + group_sizes[rg])

    new_order = list(range(start)) + remaining_order
    adj = permute_checked(adj, new_order)
    bin_list = [bin_list[i] for i in new_order]

    if cut_indices[0] == 0:
        cut_indices.pop(0)
    if cut_indices and cut_indices[-1] == len(adj):
        cut_indices.pop(-1)

    total_groups = len(cut_indices) + 1
    print("- Modularity maximization total time = " + str(time.time() - start_time))
    print(
        "- Chromosomes found via HMMs or Hyper geometrics = {}".format(
            total_groups - group_count
        )
    )
    print("- Chromosomes found via modularity maximization = " + str(group_count))
    print("- Total chromosomes found {}".format(total_groups))
    return adj, bin_list, cut_indices


# ---------------------------------------------------------------------------
# Scaffold -> chromosome assignment
# ---------------------------------------------------------------------------

def assess_cluster_list(
    c_lines: Sequence[str],
    scaffold_bins: Dict[str, List[Tuple[int, str]]],
    out,
    percent_to_assign: float = 51.0,
) -> Tuple[List[Tuple[int, str]], int, int]:
    """Assign scaffolds to one chromosome group by majority vote."""
    in_group: Dict[str, List[int]] = {}
    for line in c_lines:
        cols = line.split("\t")
        bin_id, scaff = int(cols[0]), cols[1]
        in_group.setdefault(scaff, []).append(bin_id)
    final: List[Tuple[int, str]] = []
    false_positives = 0
    assigned = 0
    out.write("#Scaffold\tNodesAssigend\tTotalNodes\tAssigned%\n")
    for scaff, nodes in in_group.items():
        nodes_assigned, total_nodes = len(nodes), len(scaffold_bins[scaff])
        pct = round((float(nodes_assigned) / float(total_nodes)) * 100.0, 2)
        out.write(f"{scaff}\t{nodes_assigned}\t{total_nodes}\t{pct}%\n")
        if pct >= percent_to_assign:
            final += scaffold_bins[scaff]
            assigned += 1
        else:
            false_positives += nodes_assigned
    out.write("Total scaffolds clustered to chromosome " + str(len(in_group)) + "\n")
    out.write("Total scaffolds assigned to chromosome " + str(assigned) + "\n")
    return final, false_positives, assigned


def assess_chromosome_clustering(
    chrom_list: List[List[str]],
    stats_file: str,
    percent_to_assign: float = 51.0,
) -> List[List[Tuple[int, str]]]:
    """All groups + stats file."""
    scaffold_bins: Dict[str, List[Tuple[int, str]]] = {}
    all_lines = [line for group in chrom_list for line in group]
    for line in all_lines:
        cols = line.split("\t")
        bin_id, scaff = int(cols[0]), cols[1]
        scaffold_bins.setdefault(scaff, []).append((bin_id, scaff))
    for scaff in scaffold_bins:
        scaffold_bins[scaff].sort(key=lambda pair: pair[0])

    final_groups: List[List[Tuple[int, str]]] = []
    false_positives = 0
    total_assigned = 0
    with open(stats_file, "w") as out:
        for i, group in enumerate(chrom_list):
            out.write("### Chromosome" + str(i + 1) + " ###\n")
            nodes, fp, assigned = assess_cluster_list(
                group, scaffold_bins, out, percent_to_assign
            )
            if len(nodes) > 0:
                final_groups.append(nodes)
            false_positives += fp
            total_assigned += assigned
            out.write("####################\n")
        total_nodes = len(all_lines)
        out.write("Total Nodes " + str(total_nodes) + "\n")
        out.write("Properly clustered nodes " + str(total_nodes - false_positives) + "\n")
        out.write("Falsely clustered nodes " + str(false_positives) + "\n")
        out.write("Total scaffolds assigned to chromosomes " + str(total_assigned) + "\n")
        out.write(
            "Error rate ~"
            + str(round((float(false_positives) / float(total_nodes)) * 100.0, 2))
            + "%\n"
        )
    return final_groups


# ---------------------------------------------------------------------------
# Part 1 driver
# ---------------------------------------------------------------------------

def run_pipeline(
    hic_pro_bed_file: str,
    hic_pro_bias_file: str,
    hic_pro_matrix_file: str,
    hic_pro_scaff_size_file: str,
    dendrogram_order_file: str,
    avg_cluster_plot: str,
    avg_cluster_plot_outlined: str,
    bin_group_file: str,
    assessment_file: str,
    chromosome_group_file: str,
    hyper_geom: bool,
    hmm: bool,
    min_size: int,
    modularity: float,
    louvain_rounds: int,
    psig: float,
    convergence_rounds: int,
    look_ahead,
    resolution: int,
    device: torch.device,
    louvain_seed: int = 0,
    matrix_mode: str = "exact",
    hmm_mode: str = "fast",
    mesh: Optional[pm.Mesh] = None,
) -> Tuple[Optional[str], List[int]]:
    """Part 1 on ``device``.  Returns where the rank-count scans ran
    (``RankCounts.where``: ``"host"`` or the torch device; ``None`` when
    ``hyper_geom`` is off) and the final cut list.

    ``matrix_mode`` (``hyper_geom`` only): ``exact`` ranks the f64
    similarity on the host with numpy's tie order, the parity mode;
    ``device`` ranks its f32 cast on ``device`` (stable ascending sort,
    columns reversed) and hands the device tensor to ``RankCounts``.  Not
    a parity mode against ``exact``: f32 values collide where f64 values
    differ, and numpy's tie order is its own.

    ``hmm_mode`` (``hmm`` only, when ``hyper_geom`` is off): ``fast`` or
    ``exact``, as ``ops/gaussian_hmm.GaussianHMM2`` describes.

    ``mesh`` (a ``parallel.mesh.Mesh``): the rank-count scans run on the
    mesh's blocks (integer counts, equal to the single-device ones), and in
    device mode the rows are ranked per mesh position."""
    print("########################################")
    print("### Working on Part1 of the pipeline ###")
    total_start = time.time()
    profiling.reset()
    # read as 0 where the branch skips them (``hicbench/metrics``)
    profiling.declare("part1/log_transform", "part1/hmm_boundary")
    profiling.count("part1/pageable_copies", 0)
    profiling.count("part1/kmeans_lloyd_iterations", 0)

    # --- ingest + cluster ---------------------------------------------------
    start = time.time()
    with profiling.timer("part1/ingest"):
        bin_list = hicpro.initiate_loci(hic_pro_bed_file, hic_pro_bias_file)
        adj = hicpro.build_adjacency_matrix(hic_pro_matrix_file, bin_list)
        adj, bin_list = hicpro.remove_zero_rows(adj, bin_list)
    with profiling.timer("part1/distance_transform"):
        adj = oracle.to_distance(adj)
    labels = [b.chrom + "_" + str(b.ID) for b in bin_list]
    with profiling.timer("part1/upgma"):
        dendro = upgma.average_cluster_leaf_order(adj, labels, device=device)
    filebus.write_dendrogram_leaf_order(dendro["ivl"], dendro["leaves"], dendrogram_order_file)
    dendro = filebus.read_dendrogram_leaf_order(dendrogram_order_file)
    leaves = dendro["leaves"]
    adj = permute_checked(adj, leaves)
    bin_list = [bin_list[i] for i in leaves]
    if avg_cluster_plot:
        plots.plot_contact_map(adj, resolution=resolution, save_plot=avg_cluster_plot)
    print("Total run-time to cluster and plot = " + str(time.time() - start))

    # --- cut detection ------------------------------------------------------
    start = time.time()
    row_sums = np.asarray([b.rowSum for b in bin_list])
    rank_where = None
    with profiling.timer(
        "part1/cut_detection_hmm" if hmm else "part1/cut_detection_hypergeom"
    ):
        if hyper_geom:
            adj = oracle.to_similarity(adj, row_sums)
            if matrix_mode == "device":
                # the order-preserving f32 cast of the host f64 similarity
                # is ranked on the device: each mesh position (or the one
                # device) ranks its row block, and the blocks, cut back to
                # n rows, stay where they lie for the counts
                n_bins = adj.shape[0]
                place = pm.make_mesh((1, 1), devices=[device]) if mesh is None else mesh
                blocks, _ = pm.put_rows_padded(place, adj.astype(np.float32))
                rb = blocks[0].shape[0]
                rank_mat = [
                    matrix.rank_matrix_desc(b)[: n_bins - k * rb]
                    for k, b in enumerate(blocks)
                    if k * rb < n_bins
                ]
                del blocks
            else:
                rank_mat = matrix.rank_rows_desc_host(adj)
            counts = breakpoints.RankCounts(rank_mat, device, mesh=mesh)
            del rank_mat
            initial = breakpoints.pre_process_all_matrix_breakpoints(
                counts, min_size=min_size, min_frac=modularity, psig=psig
            )
            cut_indices = breakpoints.filter_noisy_breakpoints(counts, initial, psig=psig)
            rank_where = counts.where
            del counts  # frees the device copy of the rank matrix
            if (modularity and modularity > 0.0) or (
                avg_cluster_plot_outlined and plots.available()
            ):  # only the Louvain tail and the outlined plot read the log matrix
                with profiling.timer("part1/log_transform"):
                    adj = oracle.log_transform(adj, log_base=10, plus_one=True)
        elif hmm:
            adj = oracle.to_similarity(adj, row_sums)
            with profiling.timer("part1/log_transform"):
                adj = oracle.log_transform(adj, log_base=10, plus_one=True)
            cut_indices = hmm_cuts.identify_chromosome_groups_hmm(
                adj,
                bin_list,
                min_size=min_size,
                modularity=modularity,
                convergence_rounds=convergence_rounds,
                look_ahead=look_ahead,
                louvain_rounds=louvain_rounds,
                hmm_mode=hmm_mode,
                device=device,
            )
        else:
            cut_indices = []

    # --- modularity tail ----------------------------------------------------
    if modularity and modularity > 0.0:
        with profiling.timer("part1/louvain_tail"):
            adj, bin_list, cut_indices = modularity_remaining_data(
                adj, bin_list, cut_indices, n_rounds=louvain_rounds, seed=louvain_seed
            )

    # --- persist + plot -----------------------------------------------------
    if avg_cluster_plot_outlined and plots.available():
        adj_plot = oracle.to_distance(
            oracle.log_transform(adj, log_base=10, reverse=True, plus_one=True)
        )
        plots.plot_contact_map(
            adj_plot,
            resolution=resolution,
            highlight_chroms=cut_indices,
            save_plot=avg_cluster_plot_outlined,
        )
    filebus.write_bin_groupings(cut_indices, bin_list, bin_group_file)
    print(
        "Total run-time to identify chromosome boundaries = "
        + str(time.time() - start)
    )

    # --- scaffold assignment ------------------------------------------------
    start = time.time()
    with profiling.timer("part1/scaffold_assignment"):
        size_dict = hicpro.read_size_file_to_dict(hic_pro_scaff_size_file)
        bin_groups = filebus.read_bin_groupings(bin_group_file)
        chrom_groups = assess_chromosome_clustering(bin_groups, assessment_file)
        filebus.write_chromosome_groupings(chrom_groups, size_dict, chromosome_group_file)
    print(
        "Total run-time to assign scaffolds to chromosomes = "
        + str(time.time() - start)
    )
    print("Total run-time of Part1 = " + str(time.time() - total_start))
    profiling.print_summary()
    print("CutIndices = " + str(cut_indices))
    print("- Part 1 (grouping bins to groups) completed successfully")
    return rank_where, list(cut_indices)
