"""The intermediate "file bus": every pipeline part persists its state to
text files and every part can be rerun from them (the reference's only
checkpoint/resume mechanism; README.md:31-32, run_hicAssembler.py:273-297).

Formats are byte-compatible with the reference so that outputs can be
equality-tested part-by-part:

* dendrogram order  ``label<TAB>leafIndex``  (scaffoldToChromosomes.py:210-234)
* bin groups        ``### Chromosome group i ###`` sections of
                    ``binID  chrom  start  stop  bias``  (:945-964)
* chromosome groups ``### Chromosome group i ###`` sections of
                    ``binID  scaffold``  (:1079-1100)
* scaffold orders   ``### Chromosome grouping i ###`` sections of
                    ``scaffold  orientation``  (orderGenome.py:630-644)
* binID order       ``#ScaffoldID  HiCPro-BinID`` header then
                    ``scaffold  binID`` rows  (orderGenome.py:646-660)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from hic_genome_assembler_tpu_torch.io.hicpro import Bin


# ---------------------------------------------------------------------------
# Dendrogram leaf order
# ---------------------------------------------------------------------------

def write_dendrogram_leaf_order(ivl: Sequence[str], leaves: Sequence[int], out_path: str) -> None:
    """``label<TAB>leaf`` rows, no trailing newline on the last row."""
    with open(out_path, "w") as out:
        lines = [f"{label}\t{leaf}" for label, leaf in zip(ivl, leaves)]
        out.write("\n".join(lines))


def read_dendrogram_leaf_order(path: str) -> Dict[str, list]:
    dendro: Dict[str, list] = {"ivl": [], "leaves": []}
    with open(path, "r") as handle:
        for line in handle:
            cols = line.strip("\r").strip("\n").split("\t")
            dendro["ivl"].append(cols[0])
            dendro["leaves"].append(int(cols[-1]))
    return dendro


# ---------------------------------------------------------------------------
# Bin groups (part1 clustering output at bin granularity)
# ---------------------------------------------------------------------------

def write_bin_groupings(cut_indices: Sequence[int], bin_list: List[Bin], out_path: str) -> None:
    """Split bin_list at cut_indices into sections (scaffoldToChromosomes.py:945-964)."""
    groups = []
    prev = 0
    for cut in cut_indices:
        groups.append(bin_list[prev:cut])
        prev = cut
    groups.append(bin_list[prev:])
    with open(out_path, "w") as out:
        for i, group in enumerate(groups):
            out.write(f"### Chromosome group {i + 1} ###\n")
            for b in group:
                out.write(f"{b.ID}\t{b.chrom}\t{b.start}\t{b.stop}\t{b.bias}\n")


def read_bin_groupings(path: str) -> List[List[str]]:
    """Sections -> list of raw line lists (scaffoldToChromosomes.py:981-999)."""
    groups: List[List[str]] = []
    current: List[str] = []
    with open(path, "r") as handle:
        handle.readline()  # leading section header
        for line in handle:
            line = line.strip("\n").strip("\r")
            if line and line[0] != "#":
                current.append(line)
            else:
                groups.append(current)
                current = []
    groups.append(current)
    print(str(len(groups)) + " chromosomes read in from file")
    return groups


# ---------------------------------------------------------------------------
# Chromosome groups (part1 final output: binID/scaffold per chromosome)
# ---------------------------------------------------------------------------

def write_chromosome_groupings(
    chrom_list: List[List[Tuple[int, str]]],
    scaff_size_dict: Dict[str, int],
    out_path: str,
) -> None:
    """Rename groups Chr_1..N by descending total scaffold bp
    (scaffoldToChromosomes.py:1079-1100)."""
    sizes = []
    for group in chrom_list:
        scaffs = {pair[1]: None for pair in group}
        sizes.append(sum(scaff_size_dict[s] for s in scaffs))
    ordered = [g for g, _ in sorted(zip(chrom_list, sizes), key=lambda p: p[1], reverse=True)]
    with open(out_path, "w") as out:
        for i, group in enumerate(ordered):
            out.write(f"### Chromosome group {i + 1} ###\n")
            for binID, scaff in group:
                out.write(f"{binID}\t{scaff}\n")


def read_groupings_to_valid_bins(path: str) -> Dict[int, str]:
    """{binID: ''} whitelist from a chromosome-group file (orderGenome.py:200-214)."""
    ids: Dict[int, str] = {}
    with open(path, "r") as handle:
        for line in handle:
            line = line.strip("\r").strip("\n")
            if line and line[0] != "#":
                ids[int(line.split("\t")[0])] = ""
    return ids


def read_chroms_from_file(path: str) -> List[List[List[object]]]:
    """Chromosome-group file -> [[[binID, scaffold], ...], ...]
    (orderGenome.py:216-237)."""
    chroms: List[List[List[object]]] = []
    current: List[List[object]] = []
    with open(path, "r") as handle:
        handle.readline()
        for line in handle:
            line = line.strip("\r").strip("\n")
            if line and line[0] != "#":
                cols = line.split("\t")
                current.append([int(cols[0]), cols[1]])
            else:
                chroms.append(current)
                current = []
    chroms.append(current)
    print("Chromosomes found " + str(len(chroms)))
    print("Nodes found " + str(sum(len(c) for c in chroms)))
    return chroms


# ---------------------------------------------------------------------------
# Scaffold ordering files (part2/part3 output)
# ---------------------------------------------------------------------------

def write_scaffold_orderings(
    orderings: List[List[Tuple[str, str]]],
    out_path: str,
) -> None:
    """[(name, orientation)] per chromosome -> sectioned TSV
    (orderGenome.py:630-644, orientSmallScaffolds.py:393-413)."""
    chrom_count, scaffs_written = 0, 0
    with open(out_path, "w") as out:
        for group in orderings:
            chrom_count += 1
            out.write(f"### Chromosome grouping {chrom_count} ###\n")
            for name, orientation in group:
                out.write(f"{name}\t{orientation}\n")
                scaffs_written += 1
    print("Chromosome groups written to file " + str(chrom_count))
    print("Scaffolds written to file " + str(scaffs_written))


def read_chromosome_ordering(path: str) -> List[List[List[str]]]:
    """Ordering file -> [[[scaffold, orientation], ...], ...]
    (writeAssembledFasta.py:34-53, orientSmallScaffolds.py:33-55)."""
    groups: List[List[List[str]]] = []
    current: List[List[str]] = []
    with open(path, "r") as handle:
        handle.readline()
        for line in handle:
            line = line.strip("\r").strip("\n")
            if line and line[0] != "#":
                cols = line.split("\t")
                current.append([cols[0], cols[1]])
            else:
                groups.append(current)
                current = []
    groups.append(current)
    return groups


def write_bin_ids_ordering(
    scaffold_orders: List[Tuple[str, Sequence[int]]],
    out_path: str,
) -> None:
    """``scaffold<TAB>binID`` rows after a header line; newline-prefixed
    row writes to match the reference byte stream (orderGenome.py:646-660)."""
    bins_written = 0
    with open(out_path, "w") as out:
        out.write("#ScaffoldID\tHiCPro-BinID")
        for name, bin_ids in scaffold_orders:
            for bID in bin_ids:
                out.write(f"\n{name}\t{bID}")
                bins_written += 1
    print("BinIDs written to file " + str(bins_written))
