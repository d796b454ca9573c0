"""The benchmark's genome: a planted-truth Hi-C data set made from a seed,
written as the HiC-Pro files the assembler reads.

A configuration's ``genome`` recipe fixes the layout (how many chromosomes,
how many scaffolds each, their bin counts) from its ``layout_seed``, and the
draft (strands, base-pair sizes, draft order) from its ``draft_seed``: the
deployment's draft assembly.  A map seed draws the Hi-C map over that
draft (the contact jitter, which pairs of bins across chromosomes touch, the
biases), and ``--seed`` the sequence, restriction sites and read pairs.  A
recipe with ``map_seeds`` has a fixed pool of maps, which every ``--seed``
runs, in an order of its own (``pool``): the map sets how much work an
assembly is, so every seed gets the same; without it ``--seed`` is the one
map seed.  The contact model is a power-law decay with distance inside a
chromosome, a uniform jitter, and sparse contacts between chromosomes.

The draws follow the order of the repository's synthetic fixture
generator: the map's stream is ``default_rng(map_seed)`` advanced past the
draft's draws, so at ``map_seed == draft_seed`` the matrix, bed, bias and sizes
files are the fixture's bytes.  The matrix is built one block of rows at a
time and its text is formatted with array arithmetic, not a Python loop a
line.  The sequence, restriction sites and read pairs are drawn in bulk
from the seed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np

_BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
_ROW_BLOCK = 256
_FASTA_WIDTH = 60


@dataclass
class Scaffold:
    name: str
    chrom: int
    order_in_chrom: int
    strand: str
    n_bins: int
    size_bp: int
    first_bin: int = 0


@dataclass
class Genome:
    resolution: int
    scaffolds: List[Scaffold]       # in draft (bed) order
    chrom_of: np.ndarray            # int64 [n]: true chromosome of each bin
    pos_of: np.ndarray              # int64 [n]: true chromosome coordinate of each bin
    bias: List[str]
    seed: int
    noise: float
    cross_noise: float
    contact_scale: float
    matrix_state: dict              # the map stream's state where the matrix's draws begin

    @property
    def n_bins(self) -> int:
        return int(self.chrom_of.size)


def layout(recipe: Dict) -> Tuple[Tuple[int, ...], ...]:
    """Scaffold bin counts per chromosome, in true order, from the recipe's
    ``layout_seed``: ``scaffolds`` a chromosome (a number, or an inclusive
    ``[lo, hi]`` drawn per chromosome), bin counts
    ``max(int(pareto(a) * scale * stretch + offset * stretch), min_bins)``."""
    rng = np.random.default_rng(recipe["layout_seed"])
    count = recipe["scaffolds"]
    stretch = float(recipe.get("stretch", 1.0))
    out = []
    for _ in range(recipe["chromosomes"]):
        k = int(rng.integers(count[0], count[1] + 1)) if isinstance(count, list) else int(count)
        raw = rng.pareto(recipe["pareto_a"], k) * recipe["scale"] * stretch + recipe["offset"] * stretch
        sizes = np.maximum(raw.astype(int), recipe["min_bins"])
        out.append(tuple(int(s) for s in sizes))
    return tuple(out)


def _draft(chroms: Tuple[Tuple[int, ...], ...], res: int,
           rng: np.random.Generator) -> List[Scaffold]:
    """Strands and base-pair sizes of each scaffold, in true order, then
    the draft (bed) order: a shuffle of them all."""
    made: List[Scaffold] = []
    for c, counts in enumerate(chroms):
        for k, nb in enumerate(counts):
            strand = "-" if nb > 1 and rng.random() < 0.5 else "+"
            size = nb * res - int(rng.integers(0, res // 4))
            made.append(Scaffold(f"scaf_c{c}k{k}", c, k, strand, nb, size))
    return [made[i] for i in rng.permutation(len(made))]


def pool(recipe: Dict, seed: int) -> List[int]:
    """The map seeds a run of ``seed`` assembles, in its order: the
    recipe's ``map_seeds`` permuted by ``seed``, or ``seed`` alone."""
    maps = recipe.get("map_seeds") or [seed]
    return [int(maps[i]) for i in np.random.default_rng([seed, 4]).permutation(len(maps))]


def make(recipe: Dict, seed: int, n_chroms: int = 0, map_seed: int = None) -> Genome:
    """The genome of ``recipe`` and ``seed``; ``n_chroms`` > 0 keeps the
    first chromosomes of the layout (the warm-up genome).  The draft
    (strands, sizes, draft order) is the recipe's own, from its
    ``draft_seed``; ``map_seed`` (``seed`` unless given) draws the contact
    map over it and the biases here, ``seed`` the sequence, restriction
    sites and read pairs in ``write_hicpro``."""
    chroms = layout(recipe)
    if n_chroms:
        chroms = chroms[:n_chroms]
    res = int(recipe["resolution"])
    scaffolds = _draft(chroms, res, np.random.default_rng(recipe["draft_seed"]))
    rng = np.random.default_rng(seed if map_seed is None else map_seed)
    _draft(chroms, res, rng)  # the map's stream starts where the fixture's does
    starts = {c: np.concatenate([[0], np.cumsum(counts)[:-1]]) for c, counts in enumerate(chroms)}
    n = sum(s.n_bins for s in scaffolds)
    chrom_of = np.empty(n, dtype=np.int64)
    pos_of = np.empty(n, dtype=np.int64)
    nxt = 0
    for s in scaffolds:
        s.first_bin = nxt
        within = np.arange(s.n_bins)
        if s.strand == "-":
            within = within[::-1]
        chrom_of[nxt : nxt + s.n_bins] = s.chrom
        pos_of[nxt : nxt + s.n_bins] = starts[s.chrom][s.order_in_chrom] + within
        nxt += s.n_bins
    # the matrix's own draws (jitter, then the cross-contact mask) come
    # next in the stream: skip them here and draw them while writing
    state = rng.bit_generator.state
    rng.bit_generator.advance(n * n * (2 if recipe["cross_noise"] > 0 else 1))
    bias = [f"{v:.6f}" for v in rng.uniform(0.8, 1.2, n)]
    return Genome(res, scaffolds, chrom_of, pos_of, bias, seed, float(recipe["noise"]),
                  float(recipe["cross_noise"]), float(recipe["contact_scale"]), state)


def _upper_rows(g: Genome, rng_j: np.random.Generator, rng_x, r0: int, r1: int):
    """Row block [r0, r1) of the contact matrix's upper triangle (diagonal
    included): (rows, cols, values) of its nonzero entries, row-major."""
    n = g.n_bins
    rows = np.arange(r0, r1)[:, None]
    cols = np.arange(n)[None, :]
    same = g.chrom_of[r0:r1, None] == g.chrom_of[None, :]
    dist = np.abs(g.pos_of[r0:r1, None] - g.pos_of[None, :])
    m = np.where(same, g.contact_scale / (1.0 + dist) ** 1.0, 0.0)
    m[rows == cols] = g.contact_scale
    upper = cols > rows
    if g.noise > 0:
        jitter = rng_j.random((r1 - r0, n)) * g.noise * g.contact_scale
        m = m + np.where(same & upper, jitter, 0.0)
    if rng_x is not None:
        mask = (rng_x.random((r1 - r0, n)) < g.cross_noise) & upper & ~same
        m = m + np.where(mask, g.noise * g.contact_scale, 0.0)
    keep = (cols >= rows) & (m != 0.0)
    r, c = np.nonzero(keep)
    return r + r0, c, m[r, c]


def _digits(x: np.ndarray, width: int) -> Tuple[np.ndarray, np.ndarray]:
    """Decimal digits of non-negative int64 ``x``, right-aligned in
    ``width`` columns (uint8 [N, width]), and the mask of the significant
    ones (at least one digit)."""
    powers = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    d = (x[:, None] // powers[None, :]) % 10
    n_dig = 1 + (x[:, None] >= powers[None, :-1]).sum(axis=1)
    mask = np.arange(width)[None, :] >= (width - n_dig)[:, None]
    return (d + ord("0")).astype(np.uint8), mask


def format_triplets(a: np.ndarray, b: np.ndarray, v: np.ndarray) -> bytes:
    """``f"{a}\\t{b}\\t{v:.8f}\\n"`` for each entry, as one bytes object."""
    if a.size == 0:
        return b""
    scaled = v * 1e8
    q = np.rint(scaled).astype(np.int64)
    # a product that lies this close to a rounding tie may round the other
    # way than the decimal value does: format those few as Python does
    near = np.abs(scaled - np.floor(scaled) - 0.5) < 1e-3
    for i in np.nonzero(near)[0]:
        ip, fp = f"{v[i]:.8f}".split(".")
        q[i] = int(ip) * 10 ** 8 + int(fp)
    ip, fp = q // 10 ** 8, q % 10 ** 8
    wa = len(str(int(max(a.max(), b.max()))))
    wi = len(str(int(ip.max())))
    da, ma = _digits(a.astype(np.int64), wa)
    db, mb = _digits(b.astype(np.int64), wa)
    di, mi = _digits(ip, wi)
    df, _ = _digits(fp, 8)
    N = a.size

    def const(ch: bytes):
        return np.full((N, 1), ord(ch), np.uint8), np.ones((N, 1), bool)

    parts = [(da, ma), const(b"\t"), (db, mb), const(b"\t"), (di, mi), const(b"."),
             (df, np.ones_like(df, dtype=bool)), const(b"\n")]
    chars = np.concatenate([p[0] for p in parts], axis=1)
    mask = np.concatenate([p[1] for p in parts], axis=1)
    return chars[mask].tobytes()


def write_hicpro(g: Genome, outdir: str) -> Dict[str, str]:
    """Write bed / bias / matrix / sizes / fasta / restriction / validpairs
    under ``outdir``; returns {kind: path}."""
    os.makedirs(outdir, exist_ok=True)
    res = g.resolution
    paths = {k: os.path.join(outdir, f) for k, f in (
        ("bed", "genome_abs.bed"), ("bias", "genome_iced.matrix.biases"),
        ("matrix", "genome_iced.matrix"), ("sizes", "genome.sizes"),
        ("fasta", "genome.fasta"), ("restriction", "genome_restriction.bed"),
        ("validpairs", "genome.allValidPairs"))}
    bed = []
    for s in g.scaffolds:
        for k in range(s.n_bins):
            bed.append(f"{s.name}\t{k * res}\t{min((k + 1) * res, s.size_bp)}\t{s.first_bin + k}\n")
    with open(paths["bed"], "w") as fh:
        fh.write("".join(bed))
    with open(paths["bias"], "w") as fh:
        fh.write("".join(b + "\n" for b in g.bias))

    rng_j = np.random.default_rng(0)
    rng_j.bit_generator.state = g.matrix_state
    rng_x = None
    if g.cross_noise > 0:
        rng_x = np.random.default_rng(0)
        rng_x.bit_generator.state = g.matrix_state
        rng_x.bit_generator.advance(g.n_bins * g.n_bins)
    with open(paths["matrix"], "wb") as fh:
        for r0 in range(0, g.n_bins, _ROW_BLOCK):
            r1 = min(r0 + _ROW_BLOCK, g.n_bins)
            fh.write(format_triplets(*_upper_rows(g, rng_j, rng_x, r0, r1)))
    with open(paths["sizes"], "w") as fh:
        fh.write("".join(f"{s.name}\t{s.size_bp}\n" for s in g.scaffolds))

    rng = np.random.default_rng([g.seed, 1])
    with open(paths["fasta"], "wb") as fh:
        for s in g.scaffolds:
            seq = _BASES[rng.integers(0, 4, s.size_bp)]
            full = s.size_bp // _FASTA_WIDTH
            block = np.empty((full, _FASTA_WIDTH + 1), np.uint8)
            block[:, :_FASTA_WIDTH] = seq[: full * _FASTA_WIDTH].reshape(full, _FASTA_WIDTH)
            block[:, _FASTA_WIDTH] = ord("\n")
            tail = seq[full * _FASTA_WIDTH :].tobytes()
            fh.write(b">" + s.name.encode() + b"\n" + block.tobytes()
                     + (tail + b"\n" if tail else b""))

    sites = np.random.default_rng([g.seed, 2])
    with open(paths["restriction"], "w") as fh:
        out = []
        for s in g.scaffolds:
            steps = sites.integers(300, 700, s.size_bp // 300 + 1)
            coords = np.cumsum(steps)
            out.extend(f"{s.name}\tHIC_frag\t{c}\n" for c in coords[coords < s.size_bp])
        fh.write("".join(out))
    _write_validpairs(g, paths["validpairs"], np.random.default_rng([g.seed, 3]))
    return paths


def _write_validpairs(g: Genome, path: str, rng: np.random.Generator, per_junction: int = 400):
    """Read pairs across each true scaffold junction, in each scaffold's
    own 5'->3' frame (its strand honoured), for part 3's edge counts."""
    by_chrom: Dict[int, List[Scaffold]] = {}
    for s in g.scaffolds:
        by_chrom.setdefault(s.chrom, []).append(s)

    def frame(s: Scaffold, bp: np.ndarray) -> np.ndarray:
        own = bp if s.strand == "+" else s.size_bp - 1 - bp
        return np.clip(own, 0, s.size_bp - 1).astype(np.int64)

    lines, rid = [], 0
    for members in by_chrom.values():
        members.sort(key=lambda s: s.order_in_chrom)
        for left, right in zip(members, members[1:]):
            d1 = rng.exponential(g.resolution / 2.0, per_junction)
            d2 = rng.exponential(g.resolution / 2.0, per_junction)
            c1 = frame(left, left.size_bp - 1 - d1)
            c2 = frame(right, d2)
            lines.extend(
                f"read_{rid + i}\t{left.name}\t{a}\t+\t{right.name}\t{b}\t-\t42\tHIC_frag\tHIC_frag\t42\t42\n"
                for i, (a, b) in enumerate(zip(c1.tolist(), c2.tolist())))
            rid += per_junction
    with open(path, "w") as fh:
        fh.write("".join(lines))


def write_config(path: str, workdir: str, paths: Dict[str, str], resolution: int,
                 settings: Dict[str, str]) -> str:
    """A complete CLI config whose outputs land in ``workdir/files``;
    ``settings`` (the configuration's) fills in the strategy keys."""
    files = os.path.join(workdir, "files")
    plots = os.path.join(workdir, "plots")
    os.makedirs(files, exist_ok=True)
    os.makedirs(plots, exist_ok=True)
    values = {
        "resolution": str(resolution), "saveFilesDirectory": files,
        "savePlotsDirectory": plots, "hicProBedFile": paths["bed"],
        "hicProBiasFile": paths["bias"], "hicProMatrixFile": paths["matrix"],
        "hicProScaffSizeFile": paths["sizes"], "chromosomeGroupFile": "chromosomeGroupings.txt",
        "chromosomeOrderFile": "chromosomeOrdering.txt",
        "finalOrderingsFile": "finalChromosomeOrdering.txt",
        "dendrogramOrderFile": "dendrogramOrder.txt", "avgClusterPlot": "avgCluster.png",
        "avgClusterPlot_outlined": "avgCluster_outlined.png", "binGroupFile": "binGroupings.txt",
        "assessmentFile": "clusterAssessment.txt", "chromosomePlotSuffix": " (benchmark)",
        "fullGenomePlot": "fullGenome.png", "fullGenomePlotTitle": "benchmark genome",
        "plotOrderFile": "plotOrder.txt", "restrictionSiteFile": paths["restriction"],
        "validPairFile": paths["validpairs"], "originalFastaFile": paths["fasta"],
        "assembledFastaFile": "assembled.fasta",
    }
    values.update(settings)
    with open(path, "w") as fh:
        fh.write("".join(f"{k} = {v}\n" for k, v in values.items()))
    return path
