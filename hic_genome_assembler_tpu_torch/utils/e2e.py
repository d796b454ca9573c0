"""Whole-pipeline runs on planted-truth fixtures.

The genome generator, HiC-Pro writer, file-bus readers and FASTA reader
are the port's copies of the JAX package's host modules; this module adds the 16K north-star
layout, the HMM scale genome with its settings and golden record, the
config file for a CLI run, and the planted-truth checks of the JAX
package's ``benchmarks/run_benchmarks.py::config_e2e_16k``.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Tuple

import numpy as np

from hic_genome_assembler_tpu_torch.io import fasta, filebus
from hic_genome_assembler_tpu_torch.utils import fixtures

# Part 1/2 settings of the 16K north-star run: min_size=15 recovers the
# planted chromosomes of this fixture (the reference's docs recommend
# 5-15 for Hi-C data); no Louvain tail.
E2E_SETTINGS = {
    "hyperGeom": "True",
    "hmm": "False",
    "minSize": "15",
    "modularity": "0",
    "psig": ".05",
    "convergenceRounds": "10",
    "lookAhead": ".5",
    "louvainRounds": "3",
    "nScaffolds": "6",
    "scanScaffolds": "5",
}


# Part-1 settings of the JAX package's HMM scale run
# (``benchmarks/run_benchmarks.py::config_hmm_scale``): the hmm=True cut
# search with a Louvain tail.
HMM_SETTINGS = {
    "hyperGeom": "False",
    "hmm": "True",
    "minSize": "5",
    "modularity": ".05",
    "convergenceRounds": "5",
    "lookAhead": ".2",
    "louvainRounds": "2",
    "hmmMode": "fast",
}

# The JAX CLI's part-1 result on ``make_hmm_genome(8192)`` (see the file).
HMM_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hmm_golden_3715.json")


def make_hmm_genome(n: int = 4096, n_chroms: int = 12) -> fixtures.SyntheticGenome:
    """The HMM scale genome of ``config_hmm_scale``: ``n_chroms``
    chromosomes of 4-7 Pareto-sized scaffolds from ``default_rng(7)``,
    scaled by ``n / 2900``; seed 7, noise 0.02, cross noise 0.004.
    ``n`` = 640, 4096 and 8192 give 306, 1,838 and 3,715 bins."""
    rng = np.random.default_rng(7)
    layout = []
    for _ in range(n_chroms):
        k = int(rng.integers(4, 8))
        sizes = np.maximum(
            (rng.pareto(2.0, k) * 15 * (n / 2900.0) + 7 * (n / 2900.0)).astype(int), 3
        )
        layout.append(tuple(int(s) for s in sizes))
    return fixtures.make_genome(
        chrom_scaffold_bins=tuple(layout), seed=7, noise=0.02, cross_noise_frac=0.004,
    )


def e2e_layout(n_chroms: int = 25) -> Tuple[Tuple[int, ...], ...]:
    """Scaffold bin counts of the 16K fixture: 25 chromosomes x 52
    Pareto-sized scaffolds from ``default_rng(3)``; ``n_chroms`` keeps the
    first chromosomes of the same draw."""
    rng = np.random.default_rng(3)
    layout = []
    for _ in range(25):
        sizes = np.maximum((rng.pareto(2.0, 52) * 12 + 2).astype(int), 1)
        layout.append(tuple(int(v) for v in sizes))
    return tuple(layout[:n_chroms])


def make_e2e_genome(n_chroms: int = 25) -> fixtures.SyntheticGenome:
    """The 16K north-star genome (17,162 bins, 1,300 scaffolds at 25
    chromosomes)."""
    return fixtures.make_genome(
        chrom_scaffold_bins=e2e_layout(n_chroms), seed=3, noise=0.003,
        cross_noise_frac=0.0,
    )


def prepare(
    workdir: str,
    n_chroms: int = 25,
    genome: Optional[fixtures.SyntheticGenome] = None,
    settings: Optional[Dict[str, str]] = None,
) -> Tuple[fixtures.SyntheticGenome, str, Dict[str, str]]:
    """Make the 16K genome (or its first ``n_chroms`` chromosomes, or take
    ``genome``), write its HiC-Pro files under ``workdir/hicpro`` and a CLI
    config with the north-star settings updated by ``settings``; returns
    (genome, config path, HiC-Pro paths)."""
    if genome is None:
        genome = make_e2e_genome(n_chroms)
    paths = fixtures.write_hicpro_files(genome, os.path.join(workdir, "hicpro"))
    config = write_config(
        os.path.join(workdir, "config.txt"), workdir, paths, genome.resolution, settings
    )
    return genome, config, paths


def write_config(
    path: str,
    workdir: str,
    hicpro_paths: Dict[str, str],
    resolution: int,
    settings: Optional[Dict[str, str]] = None,
) -> str:
    """Write a complete CLI config whose outputs land in
    ``workdir/files`` and ``workdir/plots``; ``settings`` overrides
    :data:`E2E_SETTINGS`.  Returns ``path``."""
    files_dir = os.path.join(workdir, "files")
    plots_dir = os.path.join(workdir, "plots")
    os.makedirs(files_dir, exist_ok=True)
    os.makedirs(plots_dir, exist_ok=True)
    values = {
        "resolution": str(resolution),
        "saveFilesDirectory": files_dir,
        "savePlotsDirectory": plots_dir,
        "hicProBedFile": hicpro_paths["bed"],
        "hicProBiasFile": hicpro_paths["bias"],
        "hicProMatrixFile": hicpro_paths["matrix"],
        "hicProScaffSizeFile": hicpro_paths["sizes"],
        "chromosomeGroupFile": "chromosomeGroupings.txt",
        "chromosomeOrderFile": "chromosomeOrdering.txt",
        "finalOrderingsFile": "finalChromosomeOrdering.txt",
        "dendrogramOrderFile": "dendrogramOrder.txt",
        "avgClusterPlot": "avgCluster.png",
        "avgClusterPlot_outlined": "avgCluster_outlined.png",
        "binGroupFile": "binGroupings.txt",
        "assessmentFile": "clusterAssessment.txt",
        "chromosomePlotSuffix": " (fixture)",
        "fullGenomePlot": "fullGenome.png",
        "fullGenomePlotTitle": "fixture genome",
        "plotOrderFile": "plotOrder.txt",
        "lengthCutoff": str(resolution),
        "restrictionSiteFile": hicpro_paths["restriction"],
        "validPairFile": hicpro_paths["validpairs"],
        "originalFastaFile": hicpro_paths["fasta"],
        "assembledFastaFile": "assembled.fasta",
    }
    values.update(E2E_SETTINGS)
    values.update(settings or {})
    with open(path, "w") as handle:
        for key, value in values.items():
            handle.write(f"{key} = {value}\n")
    return path


def truth_checks(genome: fixtures.SyntheticGenome, files_dir: str) -> Dict[str, object]:
    """Compare a finished run's file bus and FASTA with the planted truth.

    ``chromosomes_covered_by_ordered_segments`` counts planted chromosomes
    whose scaffolds all lie in groups that are each a contiguous,
    internally ordered segment of the planted order (a chromosome split in
    two still counts); ``entry_lengths_ok`` counts assembled entries whose
    length is the sum of their scaffolds plus 100 bp per gap."""
    path = lambda name: os.path.join(files_dir, name)  # noqa: E731
    got_groups = [
        frozenset(row[1] for row in chrom)
        for chrom in filebus.read_chroms_from_file(path("chromosomeGroupings.txt"))
    ]
    want_sets = {frozenset(v): c for c, v in genome.true_groups().items()}

    ordering = filebus.read_chromosome_ordering(path("finalChromosomeOrdering.txt"))
    orders_recovered = 0
    orders_checked = 0
    for group in ordering:
        names = [row[0] for row in group]
        c = want_sets.get(frozenset(names))
        if c is None:
            continue  # group does not match a planted chromosome
        orders_checked += 1
        want = [name for name, _o in genome.true_order(c)]
        if names == want or names == want[::-1]:
            orders_recovered += 1

    def _is_contig_segment(names, want_order):
        for cand in (names, names[::-1]):
            for ofs in range(len(want_order) - len(cand) + 1):
                if want_order[ofs : ofs + len(cand)] == cand:
                    return True
        return False

    covered = 0
    for c, names_want in genome.true_groups().items():
        want_order = [n for n, _o in genome.true_order(c)]
        segs = [
            [r[0] for r in g] for g in ordering if {r[0] for r in g} <= set(names_want)
        ]
        content_ok = sorted(n for seg in segs for n in seg) == sorted(names_want)
        if content_ok and all(_is_contig_segment(seg, want_order) for seg in segs):
            covered += 1

    entries = fasta.read_fasta(path("assembled.fasta"))
    sizes_of = {s.name: s.size_bp for s in genome.scaffolds}
    lengths_ok = 0
    for i, group in enumerate(ordering):
        name = f"Chr_{i + 1}"
        want_len = sum(sizes_of[r[0]] for r in group) + 100 * (len(group) - 1)
        if name in entries and len(entries[name]) == want_len:
            lengths_ok += 1
    return {
        "bins": genome.n_bins,
        "scaffolds": len(genome.scaffolds),
        "planted_chromosomes": len(want_sets),
        "groups_found": len(got_groups),
        "groups_match_truth": sorted(got_groups, key=sorted) == sorted(want_sets, key=sorted),
        "orders_recovered": orders_recovered,
        "orders_checked": orders_checked,
        "chromosomes_covered_by_ordered_segments": covered,
        "assembled_entries": len(entries),
        "entry_lengths_ok": lengths_ok,
        "assembled_total_bp": sum(len(v) for v in entries.values()),
    }
