"""Synthetic HiC-Pro fixture generator.

The reference ships no test data and no tests (SURVEY.md §4); this module
creates a fully self-consistent synthetic "genome" with known
chromosome/scaffold structure and emits every HiC-Pro-format file the
pipeline consumes (bed / bias / iced.matrix / sizes / FASTA /
restriction sites / validPairs), so correctness is testable end-to-end
without real data.

Ground truth model: each chromosome is a sequence of scaffolds in a true
order with true orientations.  The draft assembly (what the bed file and
FASTA describe) stores scaffolds in a scrambled order and with each
scaffold's own 5'->3' coordinates; a scaffold whose true strand is "-"
runs antiparallel to its chromosome.  Contact values decay exponentially
with true genomic distance, so the planted grouping / ordering /
orientation is recoverable by the pipeline's objective functions.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class ScaffoldTruth:
    name: str
    chrom: int            # true chromosome index
    order_in_chrom: int   # true position among the chromosome's scaffolds
    strand: str           # true strand: "+" or "-"
    n_bins: int
    size_bp: int
    bin_ids: List[int] = field(default_factory=list)   # bed-order bin IDs
    true_bin_pos: List[int] = field(default_factory=list)  # chromosome-bin coordinate per bin


@dataclass
class SyntheticGenome:
    resolution: int
    scaffolds: List[ScaffoldTruth]           # in draft (bed-file) order
    matrix: np.ndarray                       # dense symmetric contact map over all bins
    bin_scaffold: List[str]                  # owning scaffold per bin (bed order)
    bias: List[str]                          # bias file line per bin
    seed: int

    @property
    def n_bins(self) -> int:
        return self.matrix.shape[0]

    def scaffold(self, name: str) -> ScaffoldTruth:
        return next(s for s in self.scaffolds if s.name == name)

    def true_groups(self) -> Dict[int, List[str]]:
        groups: Dict[int, List[str]] = {}
        for s in self.scaffolds:
            groups.setdefault(s.chrom, []).append(s.name)
        return groups

    def true_order(self, chrom: int) -> List[Tuple[str, str]]:
        members = [s for s in self.scaffolds if s.chrom == chrom]
        members.sort(key=lambda s: s.order_in_chrom)
        return [(s.name, s.strand) for s in members]


def make_genome(
    chrom_scaffold_bins: Sequence[Sequence[int]] = ((12, 8, 6, 4, 3), (10, 7, 5, 2)),
    resolution: int = 10_000,
    decay_alpha: float = 1.0,
    contact_scale: float = 100.0,
    noise: float = 0.01,
    cross_noise_frac: float = 0.002,
    seed: int = 0,
    flip_strands: bool = True,
) -> SyntheticGenome:
    """Build the in-memory truth + contact matrix.

    ``chrom_scaffold_bins[c][k]`` is the bin count of the k-th scaffold
    (in true order) of chromosome c.  Scaffold draft order is a seeded
    shuffle across the whole genome; strands alternate pseudo-randomly
    when ``flip_strands``.
    """
    rng = np.random.default_rng(seed)
    scaffolds: List[ScaffoldTruth] = []
    for c, bin_counts in enumerate(chrom_scaffold_bins):
        for k, n_bins in enumerate(bin_counts):
            strand = "+"
            if flip_strands and n_bins > 1 and rng.random() < 0.5:
                strand = "-"
            size_bp = n_bins * resolution - int(rng.integers(0, resolution // 4))
            scaffolds.append(
                ScaffoldTruth(
                    name=f"scaf_c{c}k{k}",
                    chrom=c,
                    order_in_chrom=k,
                    strand=strand,
                    n_bins=n_bins,
                    size_bp=size_bp,
                )
            )

    # Draft (bed) order = seeded shuffle of all scaffolds.
    order = rng.permutation(len(scaffolds))
    scaffolds = [scaffolds[i] for i in order]

    # Assign bin IDs in bed order and true chromosome-bin coordinates.
    next_id = 0
    chrom_offsets: Dict[int, List[int]] = {}
    for c, bin_counts in enumerate(chrom_scaffold_bins):
        starts = np.concatenate([[0], np.cumsum(bin_counts)[:-1]]).tolist()
        chrom_offsets[c] = starts
    bin_scaffold: List[str] = []
    for s in scaffolds:
        s.bin_ids = list(range(next_id, next_id + s.n_bins))
        next_id += s.n_bins
        start = chrom_offsets[s.chrom][s.order_in_chrom]
        within = list(range(s.n_bins))
        if s.strand == "-":
            within = within[::-1]
        s.true_bin_pos = [start + w for w in within]
        bin_scaffold.extend([s.name] * s.n_bins)

    n = next_id
    chrom_of = np.empty(n, dtype=np.int64)
    pos_of = np.empty(n, dtype=np.int64)
    for s in scaffolds:
        for bid, pos in zip(s.bin_ids, s.true_bin_pos):
            chrom_of[bid] = s.chrom
            pos_of[bid] = pos

    same = chrom_of[:, None] == chrom_of[None, :]
    dist = np.abs(pos_of[:, None] - pos_of[None, :])
    # power-law contact decay ~ P(s) of real Hi-C: long-range
    # intra-chromosome signal stays well above inter-chromosome noise
    matrix = np.where(same, contact_scale / (1.0 + dist) ** decay_alpha, 0.0)
    np.fill_diagonal(matrix, contact_scale)

    if noise > 0:
        jitter = rng.random((n, n)) * noise * contact_scale
        jitter = np.triu(jitter, 1)
        matrix = matrix + np.where(same, jitter + jitter.T, 0.0)
    if cross_noise_frac > 0:
        mask = np.triu(rng.random((n, n)) < cross_noise_frac, 1)
        cross = np.where(mask & ~same, noise * contact_scale, 0.0)
        matrix = matrix + cross + cross.T

    bias = [f"{v:.6f}" for v in rng.uniform(0.8, 1.2, n)]
    return SyntheticGenome(
        resolution=resolution,
        scaffolds=scaffolds,
        matrix=matrix,
        bin_scaffold=bin_scaffold,
        bias=bias,
        seed=seed,
    )


# ---------------------------------------------------------------------------
# HiC-Pro format emission
# ---------------------------------------------------------------------------

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def _random_seq(rng: np.random.Generator, length: int) -> str:
    return _BASES[rng.integers(0, 4, length)].tobytes().decode("ascii")


def write_hicpro_files(genome: SyntheticGenome, outdir: str) -> Dict[str, str]:
    """Emit bed / bias / matrix / sizes / fasta / restriction / validpairs.

    Returns {kind: path}.  COO matrix holds the upper triangle including
    the diagonal, one triplet per nonzero, mirroring HiC-Pro's iced
    matrix layout (scaffoldToChromosomes.py:70-98 consumes it
    symmetrically).
    """
    os.makedirs(outdir, exist_ok=True)
    res = genome.resolution
    paths = {
        "bed": os.path.join(outdir, "fixture_abs.bed"),
        "bias": os.path.join(outdir, "fixture_iced.matrix.biases"),
        "matrix": os.path.join(outdir, "fixture_iced.matrix"),
        "sizes": os.path.join(outdir, "fixture.sizes"),
        "fasta": os.path.join(outdir, "fixture.fasta"),
        "restriction": os.path.join(outdir, "fixture_restriction.bed"),
        "validpairs": os.path.join(outdir, "fixture.allValidPairs"),
    }

    with open(paths["bed"], "w") as bed, open(paths["bias"], "w") as bias:
        i = 0
        for s in genome.scaffolds:
            for k in range(s.n_bins):
                start = k * res
                stop = min((k + 1) * res, s.size_bp)
                bed.write(f"{s.name}\t{start}\t{stop}\t{s.bin_ids[k]}\n")
                bias.write(genome.bias[i] + "\n")
                i += 1

    with open(paths["matrix"], "w") as mat:
        n = genome.n_bins
        iu = np.triu_indices(n)
        vals = genome.matrix[iu]
        nz = vals != 0.0
        for a, b, v in zip(iu[0][nz], iu[1][nz], vals[nz]):
            mat.write(f"{a}\t{b}\t{v:.8f}\n")

    with open(paths["sizes"], "w") as sizes:
        for s in genome.scaffolds:
            sizes.write(f"{s.name}\t{s.size_bp}\n")

    rng = np.random.default_rng(genome.seed + 1)
    with open(paths["fasta"], "w") as fa:
        for s in genome.scaffolds:
            fa.write(f">{s.name}\n")
            seq = _random_seq(rng, s.size_bp)
            for ofs in range(0, len(seq), 60):
                fa.write(seq[ofs : ofs + 60] + "\n")

    with open(paths["restriction"], "w") as restr:
        for s in genome.scaffolds:
            coord = 0
            while coord < s.size_bp:
                step = int(rng.integers(300, 700))
                coord += step
                if coord >= s.size_bp:
                    break
                restr.write(f"{s.name}\tHIC_frag\t{coord}\n")

    _write_validpairs(genome, paths["validpairs"], rng)
    return paths


def _write_validpairs(genome: SyntheticGenome, path: str, rng: np.random.Generator, pairs_per_junction: int = 400) -> None:
    """Sample read pairs concentrated near true scaffold junctions.

    Each pair's coordinates are expressed in each scaffold's own 5'->3'
    frame, honoring the scaffold's true strand, so part3's
    cutsite-normalized near-edge counting (orientSmallScaffolds.py:179-366)
    recovers the planted orientations.
    """
    def to_scaffold_coord(s: ScaffoldTruth, chrom_bp: float) -> int:
        # chrom_bp = distance from the scaffold's chromosome-leftmost edge
        if s.strand == "+":
            return int(np.clip(chrom_bp, 0, s.size_bp - 1))
        return int(np.clip(s.size_bp - 1 - chrom_bp, 0, s.size_bp - 1))

    with open(path, "w") as vp:
        read_id = 0
        by_chrom: Dict[int, List[ScaffoldTruth]] = {}
        for s in genome.scaffolds:
            by_chrom.setdefault(s.chrom, []).append(s)
        for chrom, members in by_chrom.items():
            members.sort(key=lambda s: s.order_in_chrom)
            for left, right in zip(members, members[1:]):
                for _ in range(pairs_per_junction):
                    # distances into each scaffold from the junction
                    d1 = rng.exponential(genome.resolution / 2.0)
                    d2 = rng.exponential(genome.resolution / 2.0)
                    c1 = to_scaffold_coord(left, left.size_bp - 1 - d1)
                    c2 = to_scaffold_coord(right, d2)
                    vp.write(
                        f"read_{read_id}\t{left.name}\t{c1}\t+\t{right.name}\t{c2}\t-\t42\tHIC_frag\tHIC_frag\t42\t42\n"
                    )
                    read_id += 1
