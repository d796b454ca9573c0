"""HiC-Pro output ingestion: bed / bias / COO matrix / scaffold sizes.

Formats (scaffoldToChromosomes.py:35-98,968-979):

* ``_abs.bed``     TSV ``chrom  start  stop  binID``
* ``.matrix.biases`` one float (or the literal ``nan``) per line, parallel
  to the bed file; ``nan``-bias bins are dropped from the analysis
* ``iced.matrix``  COO triplets ``binID1  binID2  value`` (1 entry per
  unordered pair; symmetrized on load)
* scaffold sizes   TSV ``scaffoldName  size``

Unlike the reference (python list-of-lists, scaffoldToChromosomes.py:76),
ingestion here lands directly in dense numpy arrays sized for device
transfer; parsing is vectorized via numpy.loadtxt-style splitting and an
optional native C++ fast path (hic_genome_assembler_tpu_torch.io.native).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np


@dataclass
class Bin:
    """One genomic locus of the contact map (scaffoldToChromosomes.py:24-33).

    Attributes mirror the reference Bin record: HiC-Pro bin ID, owning
    chromosome/scaffold, coordinates, ICE bias, and the row sum of the
    pruned adjacency matrix (filled by ``remove_zero_rows``).
    """

    ID: int
    chrom: str
    start: int
    stop: int
    bias: float
    rowSum: float = 0.0


def initiate_loci(
    bed_file: str,
    bias_file: str,
    binID_dict: Optional[Dict[int, object]] = None,
) -> List[Bin]:
    """Read bed+bias in parallel into Bin records.

    Skips bins whose bias line is the literal ``nan``; a bias value that
    fails to parse as float is stored as 0.0; an optional binID whitelist
    filters rows (used by part2).  Mirrors scaffoldToChromosomes.py:35-68.
    """
    bins: List[Bin] = []
    with open(bed_file, "r") as bed, open(bias_file, "r") as bias:
        for bed_line, bias_line in zip(bed, bias):
            cols = bed_line.strip("\r").strip("\n").split("\t")
            chrom, start, stop, bID = cols[0], int(cols[1]), int(cols[2]), int(cols[3])
            bias_txt = bias_line.strip("\r").strip("\n")
            if binID_dict is not None and bID not in binID_dict:
                continue
            if bias_txt == "nan":
                continue
            try:
                bias_value = float(bias_txt)
            except ValueError:
                bias_value = 0.0
            bins.append(Bin(bID, chrom, start, stop, bias_value, 0.0))
    print("Genomic loci found\t" + str(len(bins)))
    return bins


def read_coo_matrix(matrix_file: str) -> np.ndarray:
    """Read the raw ``iced.matrix`` COO triplets into an (nnz, 3) array.

    Fast path: the native multithreaded mmap parser
    (native/coo_parser.cpp via io.native) — the matrix file holds up to
    ~10^8 triplets at 100 Kb resolution on a 1.6 Gb genome.  Falls back
    to pandas' C parser (~10x numpy.loadtxt), then numpy.loadtxt.
    """
    try:
        from hic_genome_assembler_tpu_torch.io import native

        arr = native.parse_coo(matrix_file)
        if arr is not None:
            return arr
    except Exception:
        pass
    try:
        import pandas as pd

        frame = pd.read_csv(
            matrix_file, sep="\t", header=None, dtype=np.float64, engine="c"
        )
        return frame.to_numpy()
    except Exception:
        rows = np.loadtxt(matrix_file, dtype=np.float64, ndmin=2)
        if rows.size == 0:
            return np.zeros((0, 3), dtype=np.float64)
        return rows


def build_adjacency_matrix(
    matrix_file: str,
    bin_list: List[Bin],
) -> np.ndarray:
    """COO triplets -> symmetric dense float64 matrix over bin_list order.

    Unknown bin IDs are skipped; later duplicate triplets overwrite
    earlier ones (last-write-wins, matching the reference's repeated
    assignment, scaffoldToChromosomes.py:70-98).
    """
    n = len(bin_list)
    adjacency = np.zeros((n, n), dtype=np.float64)
    index_of = {b.ID: i for i, b in enumerate(bin_list)}
    max_id = max(index_of) if index_of else -1
    lookup = np.full(max_id + 2, -1, dtype=np.int64)
    for bID, i in index_of.items():
        lookup[bID] = i

    coo = read_coo_matrix(matrix_file)
    if coo.shape[0]:
        id1 = coo[:, 0].astype(np.int64)
        id2 = coo[:, 1].astype(np.int64)
        val = coo[:, 2]
        ok = (id1 <= max_id) & (id2 <= max_id) & (id1 >= 0) & (id2 >= 0)
        i1 = np.where(ok, lookup[np.clip(id1, 0, max_id)], -1)
        i2 = np.where(ok, lookup[np.clip(id2, 0, max_id)], -1)
        keep = (i1 >= 0) & (i2 >= 0)
        i1, i2, val = i1[keep], i2[keep], val[keep]
        # last-write-wins for duplicates: np fancy assignment keeps the
        # final occurrence, same as the reference's per-line assignment.
        adjacency[i1, i2] = val
        adjacency[i2, i1] = val
        edge_count = int(keep.sum())
    else:
        edge_count = 0
    print("Edges added to adjacency matrix\t" + str(edge_count))
    print("Rows in adjacency matrix " + str(n))
    return adjacency


def remove_rows(
    matrix: np.ndarray,
    bin_list: List[Bin],
    zero_rows: bool = True,
    bias_vals=False,
) -> "tuple[np.ndarray, List[Bin]]":
    """Row/col pruning with both reference filters
    (removeRows, scaffoldToChromosomes.py:100-136).

    ``zero_rows``: drop rows/cols whose row sum is exactly zero.
    ``bias_vals``: optional (lo, hi) — additionally drop rows whose
    Bin.bias falls OUTSIDE lo < bias < hi (strict inequalities,
    scaffoldToChromosomes.py:118-120; the reference's ``continue``
    only guards against double-appending an index, which boolean
    masking is already immune to).

    Fills each surviving Bin's ``rowSum`` with its row sum in the
    *pruned* matrix, as the reference does after deletion (:135).
    """
    row_sums = matrix.sum(axis=1)
    remove = np.zeros(len(bin_list), dtype=bool)
    if zero_rows:
        remove |= row_sums == 0.0
    if bias_vals is not False and bias_vals is not None:
        lo, hi = bias_vals
        bias = np.asarray([b.bias for b in bin_list], dtype=np.float64)
        remove |= (bias > hi) | (bias < lo)
    keep = ~remove
    print("Rows/columns to remove " + str(int(remove.sum())))
    from hic_genome_assembler_tpu_torch.ops import oracle

    pruned = oracle.permute_symmetric(matrix, keep)
    kept_bins = [b for b, k in zip(bin_list, keep) if k]
    for b, s in zip(kept_bins, pruned.sum(axis=1)):
        b.rowSum = float(s)
    return pruned, kept_bins


def remove_zero_rows(
    matrix: np.ndarray,
    bin_list: List[Bin],
) -> "tuple[np.ndarray, List[Bin]]":
    """Zero-sum pruning only — the pipeline's default call shape
    (scaffoldToChromosomes.py:1117)."""
    return remove_rows(matrix, bin_list, zero_rows=True, bias_vals=False)


def read_size_file_to_dict(size_file: str) -> Dict[str, int]:
    """Scaffold-size TSV -> {name: size} (scaffoldToChromosomes.py:968-979)."""
    sizes: Dict[str, int] = {}
    with open(size_file, "r") as handle:
        for line in handle:
            cols = line.strip("\r").strip("\n").split("\t")
            sizes[cols[0]] = int(cols[1])
    return sizes
