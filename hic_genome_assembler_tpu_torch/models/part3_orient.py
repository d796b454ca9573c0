"""Part 3 — re-orient scaffolds smaller than one contact-map bin.

Uses raw HiC-Pro validPairs read pairs, normalized by restriction-site
counts near scaffold edges, to orient "triplet" members (scaffolds whose
binCount == 1) relative to their neighbors.  Behavior-parity port of
orientSmallScaffolds.py:1-430, including both chromosome-edge special
cases (which split the edge scaffold in half) and the >= tie-break
toward "+".

The validPairs file can be tens of GB; it is streamed line-by-line and
only pairs matching pre-built adjacent-scaffold keys are retained
(orientSmallScaffolds.py:159-177).  A native C++ scanner
(hic_genome_assembler_tpu_torch.io.native) accelerates the stream when built;
the pure-Python fallback is always available.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List, Sequence, Tuple, Union

from hic_genome_assembler_tpu_torch.utils import profiling

Triplet = List["RestrictionScaffold"]


class RestrictionScaffold:
    """Per-scaffold restriction-site bookkeeping
    (orientSmallScaffolds.py:7-31)."""

    def __init__(self, name: str, orientation: str, size: float, res_coords: List[int]):
        self.name = name
        self.orientation = orientation
        self.size = size
        self.resCoords = res_coords
        self.binCount = 0
        self.resLeft = 1
        self.resRight = 1

    def get_bin_count(self, resolution: int) -> None:
        self.binCount = math.ceil(float(self.size) / float(resolution))

    def get_res_counts(self, length_cutoff: float) -> None:
        """Cut sites within length_cutoff of each end, floored at 1."""
        left = right = 0
        for c in self.resCoords:
            if c <= length_cutoff:
                left += 1
            elif c > (self.size - length_cutoff):
                right += 1
        self.resLeft = left if left else 1
        self.resRight = right if right else 1


# ---------------------------------------------------------------------------
# Ingestion
# ---------------------------------------------------------------------------

def read_preliminary_orientation(
    orientation_file: str,
) -> Tuple[List[List[RestrictionScaffold]], Dict[str, RestrictionScaffold]]:
    """Ordering file -> per-chromosome RestrictionScaffold lists + dict
    (orientSmallScaffolds.py:33-55)."""
    groups: List[List[RestrictionScaffold]] = []
    current: List[RestrictionScaffold] = []
    scaff_dict: Dict[str, RestrictionScaffold] = {}
    with open(orientation_file, "r") as handle:
        handle.readline()
        for line in handle:
            line = line.strip("\r").strip("\n")
            if line and line[0] == "#":
                groups.append(current)
                current = []
            elif line:
                cols = line.split("\t")
                s = RestrictionScaffold(cols[0], cols[1], 0.0, [])
                scaff_dict[cols[0]] = s
                current.append(s)
    groups.append(current)
    return groups, scaff_dict


def read_scaff_size_file(
    size_file: str, scaff_dict: Dict[str, RestrictionScaffold], resolution: int
) -> Dict[str, RestrictionScaffold]:
    with open(size_file, "r") as handle:
        for line in handle:
            cols = line.strip("\r").strip("\n").split("\t")
            if cols[0] in scaff_dict:
                scaff_dict[cols[0]].size = float(cols[1])
                scaff_dict[cols[0]].get_bin_count(resolution)
    return scaff_dict


def read_restrictions_file(
    restriction_file: str, scaff_dict: Dict[str, RestrictionScaffold]
) -> Dict[str, RestrictionScaffold]:
    with open(restriction_file, "r") as handle:
        for line in handle:
            cols = line.strip("\r").strip("\n").split("\t")
            if cols[0] in scaff_dict:
                scaff_dict[cols[0]].resCoords.append(int(cols[2]))
    for s in scaff_dict.values():
        s.resCoords.sort()
    return scaff_dict


def initiate_scaffold_objects(orientation_file, size_file, restriction_file, resolution):
    groups, scaff_dict = read_preliminary_orientation(orientation_file)
    scaff_dict = read_scaff_size_file(size_file, scaff_dict, resolution)
    scaff_dict = read_restrictions_file(restriction_file, scaff_dict)
    return groups, scaff_dict


# ---------------------------------------------------------------------------
# Triplets + read-pair streaming
# ---------------------------------------------------------------------------

def pull_triplets(scaffold_list: Sequence[RestrictionScaffold]) -> List[Triplet]:
    """binCount==1 scaffolds with neighbors; 2-tuples at chromosome
    edges (pullTriplets, orientSmallScaffolds.py:106-137)."""
    triplets: List[Triplet] = []
    for i, s in enumerate(scaffold_list):
        if s.binCount != 1:
            continue
        s0 = scaffold_list[i - 1] if i != 0 else None
        s2 = scaffold_list[i + 1] if i <= len(scaffold_list) - 2 else None
        if s0 is not None and s2 is not None:
            triplets.append([s0, s, s2])
        elif s0 is None and s2 is not None:
            triplets.append([s, s2])
        elif s0 is not None and s2 is None:
            triplets.append([s0, s])
    return triplets


def produce_read_pair_keys(all_triplets: List[List[Triplet]]) -> Dict[Tuple[str, str], list]:
    keys: Dict[Tuple[str, str], list] = {}
    for chrom_triplets in all_triplets:
        for trip in chrom_triplets:
            if len(trip) == 3:
                pairs = [(0, 1), (1, 0), (1, 2), (2, 1)]
            else:
                pairs = [(0, 1), (1, 0)]
            for a, b in pairs:
                keys[(trip[a].name, trip[b].name)] = []
    return keys


def read_valid_pair_file(
    pair_file: str, pair_dict: Dict[Tuple[str, str], list]
) -> Dict[Tuple[str, str], list]:
    """Stream the allValidPairs file, keeping only matching pairs
    (readValidPairFile, orientSmallScaffolds.py:159-177).

    Tries the native C++ scanner first; falls back to pure Python.
    """
    try:
        from hic_genome_assembler_tpu_torch.io import native

        if native.available():
            return native.scan_validpairs(pair_file, pair_dict)
    except Exception:
        # any native failure (missing toolchain, IO error, OOM in the
        # scan) falls back to the identical pure-Python stream below
        pass
    examined = 0
    with open(pair_file, "r") as handle:
        for line in handle:
            cols = line.strip("\r").strip("\n").split("\t")
            key = (cols[1], cols[4])
            if key in pair_dict:
                pair_dict[key].append([cols[1], cols[4], int(cols[2]), int(cols[5])])
            examined += 1
            if examined % 10_000_000 == 0:
                print("Read pairs looked at " + str(examined) + "...")
    return pair_dict


# ---------------------------------------------------------------------------
# Orientation deciders (exact reference decision rules)
# ---------------------------------------------------------------------------

def _find_key(pair_dict, a: RestrictionScaffold, b: RestrictionScaffold):
    """Locate the populated key for pair (a, b); returns (key, coord map)
    where coord maps scaffold name -> record column (2 or 3)."""
    if len(pair_dict[(a.name, b.name)]) != 0:
        return (a.name, b.name), {a.name: 2, b.name: 3}
    if len(pair_dict[(b.name, a.name)]) != 0:
        return (b.name, a.name), {b.name: 2, a.name: 3}
    return None, None


def orient_true_triplet(triplet: Triplet, pair_dict, length_cutoff: float) -> Tuple[str, str]:
    """Middle scaffold vs both neighbors
    (orientTrueTriplet, orientSmallScaffolds.py:179-241)."""
    for s in triplet:
        s.get_res_counts(length_cutoff)
    s0, s1, s2 = triplet
    p, m = 0, 0

    key, coord = _find_key(pair_dict, s1, s2)
    if key is not None:
        for rp in pair_dict[key]:
            s2_coord = rp[coord[s2.name]]
            if s2.orientation == "+":
                if s2_coord <= length_cutoff:
                    p += 1
            elif (s2.size) - s2_coord <= length_cutoff:
                p += 1
        if s2.orientation == "+":
            p = float(p) / float(s1.resRight + s2.resLeft)
        else:
            p = float(p) / float(s1.resRight + s2.resRight)

    key, coord = _find_key(pair_dict, s1, s0)
    if key is not None:
        for rp in pair_dict[key]:
            s0_coord = rp[coord[s0.name]]
            if s0.orientation == "-":
                if s0_coord <= length_cutoff:
                    m += 1
            elif (s0.size) - s0_coord <= length_cutoff:
                m += 1
        if s0.orientation == "-":
            m = float(m) / float(s1.resRight + s0.resLeft)
        else:
            m = float(m) / float(s1.resRight + s0.resRight)

    return (s1.name, "+") if p >= m else (s1.name, "-")


def orient_left_edge_case(
    scaff_left: RestrictionScaffold,
    scaff_right: RestrictionScaffold,
    pair_dict,
    length_cutoff: float,
) -> Tuple[str, str]:
    """Chromosome-leftmost sub-bin scaffold: split in half
    (orientLeftEdgeCase, orientSmallScaffolds.py:243-288)."""
    scaff_left.get_res_counts(float(scaff_left.size / 2.0))
    scaff_right.get_res_counts(length_cutoff)
    p, m = 0, 0
    key, coord = _find_key(pair_dict, scaff_left, scaff_right)
    if key is not None:
        if scaff_right.orientation == "+":
            min_r, max_r = 0, length_cutoff
        else:
            min_r, max_r = scaff_right.size - length_cutoff, scaff_right.size
        for rp in pair_dict[key]:
            lc, rc = rp[coord[scaff_left.name]], rp[coord[scaff_right.name]]
            if (lc >= float(scaff_left.size / 2.0)) and (min_r <= rc <= max_r):
                p += 1
            elif min_r <= rc <= max_r:
                m += 1
    if scaff_right.orientation == "+":
        p = float(p) / float(scaff_left.resRight + scaff_right.resLeft)
        m = float(m) / float(scaff_left.resLeft + scaff_right.resLeft)
    else:
        p = float(p) / float(scaff_left.resRight + scaff_right.resRight)
        m = float(m) / float(scaff_left.resLeft + scaff_right.resRight)
    return (scaff_left.name, "+") if p >= m else (scaff_left.name, "-")


def orient_right_edge_case(
    scaff_left: RestrictionScaffold,
    scaff_right: RestrictionScaffold,
    pair_dict,
    length_cutoff: float,
) -> Tuple[str, str]:
    """Chromosome-rightmost sub-bin scaffold: split in half
    (orientRightEdgeCase, orientSmallScaffolds.py:290-335)."""
    scaff_left.get_res_counts(length_cutoff)
    scaff_right.get_res_counts(float(scaff_right.size / 2.0))
    p, m = 0, 0
    key, coord = _find_key(pair_dict, scaff_left, scaff_right)
    if key is not None:
        if scaff_left.orientation == "+":
            min_l, max_l = scaff_left.size - length_cutoff, scaff_left.size
        else:
            min_l, max_l = 0, length_cutoff
        for rp in pair_dict[key]:
            lc, rc = rp[coord[scaff_left.name]], rp[coord[scaff_right.name]]
            if (rc < float(scaff_right.size / 2.0)) and (min_l <= lc <= max_l):
                p += 1
            elif min_l <= lc <= max_l:
                m += 1
    if scaff_left.orientation == "+":
        p = float(p) / float(scaff_left.resRight + scaff_right.resLeft)
        m = float(m) / float(scaff_left.resRight + scaff_right.resRight)
    else:
        p = float(p) / float(scaff_left.resLeft + scaff_right.resLeft)
        m = float(m) / float(scaff_left.resLeft + scaff_right.resRight)
    return (scaff_right.name, "+") if p >= m else (scaff_right.name, "-")


def orient_triplet(
    triplet: Triplet,
    scaff_list: Sequence[RestrictionScaffold],
    pair_dict,
    length_cutoff: float,
) -> Tuple[str, str]:
    """Dispatcher (orientTriplet, orientSmallScaffolds.py:337-366)."""
    if len(triplet) == 3:
        return orient_true_triplet(triplet, pair_dict, length_cutoff)
    s0, s1 = triplet[0], triplet[1]
    if s0.name == scaff_list[0].name:
        return orient_left_edge_case(s0, s1, pair_dict, length_cutoff)
    return orient_right_edge_case(s0, s1, pair_dict, length_cutoff)


def give_final_chrom_ordering(
    trips: List[List[Triplet]],
    scaff_groups: List[List[RestrictionScaffold]],
    scaff_dict: Dict[str, RestrictionScaffold],
    valid_pairs,
    resolution: int,
    length_cutoff: float = 500_000,
) -> List[List[List[str]]]:
    """Apply triplet orientations; emit final per-chromosome orders
    (giveFinalChromOrdering, orientSmallScaffolds.py:368-391)."""
    if length_cutoff < resolution:
        print("lengthCutoff variable is set too low... Setting equal to resolution variable")
        length_cutoff = resolution
    orders: List[List[List[str]]] = []
    for chrom_triplets, chrom_scaffs in zip(trips, scaff_groups):
        if len(chrom_triplets) != 0:
            for trip in chrom_triplets:
                name, orientation = orient_triplet(
                    trip, chrom_scaffs, valid_pairs, length_cutoff=length_cutoff
                )
                scaff_dict[name].orientation = orientation
        orders.append([[s.name, s.orientation] for s in chrom_scaffs])
    return orders


def run_pipeline(
    chromosome_order_file: str,
    scaff_size_file: str,
    restriction_site_file: str,
    valid_pair_file: str,
    final_ordering_file: str,
    length_cutoff: int,
    resolution: int,
) -> None:
    """Part 3 driver (orientSmallScaffolds.py:418-430)."""
    print("########################################")
    print("### Working on Part3 of the pipeline ###")
    start = time.time()
    with profiling.timer("part3/orient"):
        scaff_groups, scaff_dict = initiate_scaffold_objects(
            chromosome_order_file, scaff_size_file, restriction_site_file, resolution
        )
        trips = [pull_triplets(group) for group in scaff_groups]
        valid_pairs = produce_read_pair_keys(trips)
    with profiling.timer("part3/read_pairs"):
        valid_pairs = read_valid_pair_file(valid_pair_file, valid_pairs)
    with profiling.timer("part3/orient"):
        final_groups = give_final_chrom_ordering(
            trips, scaff_groups, scaff_dict, valid_pairs,
            resolution=resolution, length_cutoff=length_cutoff,
        )
        from hic_genome_assembler_tpu_torch.io import filebus

        filebus.write_scaffold_orderings(
            [[(name, orientation) for name, orientation in group] for group in final_groups],
            final_ordering_file,
        )
    print("Total run-time  for Part3 = " + str(time.time() - start))
    print(
        "- Part 3 (optional orientation of scaffolds smaller than resulution "
        "size) completed successfully"
    )
