"""The comparison that decides ``correct``: every file a job wrote, held
against the plain reference (``reference.py``), each number beside its
limit.

The reference is computed once for each of a run's inputs, after the
window: the jobs of an input assemble the same genome, so each distinct set
of their outputs is judged once and every job's files are read.  Part 1 and
part 2 are held to the reference's own; part 3 to the job's part 2, part 4
to the job's part 3.  Imports NumPy, SciPy and the reference only.
"""

from __future__ import annotations

import hashlib
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

import reference as ref

# Each number compared and its limit (see PERF.md for the readings they
# were set from).  Counts of differing lines are exact comparisons.
LIMITS = {
    "dendrogram_diff": 0,     # leaves out of place in part 1's dendrogram order
    "cuts_diff": 0,           # cuts in one cut list and not the other
    "bin_groups_diff": 0,     # lines of part 1's bin groups out of place
    "groups_diff": 0,         # lines of part 1's chromosome groups out of place
    "orders_diff": 0,         # lines of part 2's orders out of place
    "cost_rel_err": 1e-10,    # part 2's printed float64 costs against the reference's, relative
    "final_diff": 0,          # lines of part 3's final orders out of place
    "fasta_diff": 0,          # lines of part 4's assembled FASTA out of place
    "sub_bin_scaffolds": 0,   # scaffolds part 3 would re-orient (the reference has no such path)
}

JOB_FILES = ("dendrogramOrder.txt", "binGroupings.txt", "chromosomeGroupings.txt",
             "chromosomeOrdering.txt", "finalChromosomeOrdering.txt", "assembled.fasta")


def _digest(files_dir: str) -> str:
    h = hashlib.sha256()
    for name in JOB_FILES:
        with open(os.path.join(files_dir, name), "rb") as fh:
            for chunk in iter(lambda: fh.read(1 << 24), b""):
                h.update(chunk)
    return h.hexdigest()


def _lines(path: str) -> List[str]:
    with open(path) as fh:
        return fh.read().split("\n")


class Reference:
    """The reference's view of one run's inputs, built once: its own part 1
    (dendrogram, cut list, bin and chromosome groups) and its own part 2 on
    its own groups."""

    def __init__(self, paths: Dict[str, str], config: Dict, dtype=np.float64,
                 note=lambda message: None):
        self.settings = settings = config["settings"]
        self.dtype = dtype
        self.note = note
        self.resolution = int(config["genome"]["resolution"])
        self.inp = inp = ref.Inputs(paths)
        note("reference: inputs read")
        self.leaves, d, rs = ref.cluster(inp, dtype)
        note("reference: clustered")
        min_frac = float(settings["modularity"])
        if settings["hyperGeom"] == "True":
            counts = ref.Counts(ref.rank_desc(d, rs))
            cuts = ref.hypergeom_cuts(counts, int(settings["minSize"]), min_frac,
                                      float(settings["psig"]))
            del counts
        elif settings["hmm"] == "True":
            look = settings["lookAhead"]
            cuts = ref.hmm_cuts(
                ref.log_similarity(d, rs), int(settings["minSize"]), min_frac,
                int(settings["convergenceRounds"]), False if look == "False" else float(look),
                2 if settings["hmmMode"] == "fast" else 10)
        else:
            cuts = []
        positions = list(range(len(self.leaves)))
        if min_frac > 0:
            positions, cuts = ref.louvain_tail(ref.log_similarity(d, rs), cuts,
                                               int(settings["louvainRounds"]))
        del d
        self.cuts = cuts
        self.order = [self.leaves[p] for p in positions]
        self.bins = ref.bin_groups(inp, self.order, cuts)
        self.groups = ref.chromosome_groups(inp, self.bins)
        note("reference: cut list and groups found")
        rows = [[(int(r.split("\t")[0]), r.split("\t")[1]) for r in sec]
                for sec in ref.sections(self.groups)]
        self.searched = [ref.order_chromosome(ref.Chromosome(inp, g, dtype),
                                              int(settings["nScaffolds"]),
                                              int(settings["scanScaffolds"])) for g in rows]
        note("reference: part 2 searched")
        self.fasta = ref.read_fasta(paths["fasta"])

    def judge(self, files_dir: str) -> Dict[str, float]:
        """Every number of one job's files."""
        path = lambda name: os.path.join(files_dir, name)  # noqa: E731
        out: Dict[str, float] = {}
        dendro = [line.split("\t") for line in _lines(path("dendrogramOrder.txt")) if line]
        want = [f"{self.inp.labels[i]}\t{i}" for i in self.leaves]
        out["dendrogram_diff"] = ref.differing_lines(["\t".join(r) for r in dendro], want)

        bins = ref.read_sections(path("binGroupings.txt"))
        prog_cuts = list(np.cumsum([len(g) for g in bins])[:-1])
        out["cuts_diff"] = len(set(prog_cuts) ^ set(self.cuts))
        out["bin_groups_diff"] = ref.differing_lines(
            [x for g in bins for x in g], [x for g in self.bins for x in g])
        got_groups = [x for x in _lines(path("chromosomeGroupings.txt")) if x]
        out["groups_diff"] = ref.differing_lines(got_groups, self.groups)

        want_orders = [o for o, _, _ in self.searched]
        orders = [[tuple(r.split("\t")) for r in sec]
                  for sec in ref.read_sections(path("chromosomeOrdering.txt"))]
        out["orders_diff"] = ref.differing_lines(_flat(orders), _flat(want_orders))
        printed = printed_costs(os.path.join(os.path.dirname(files_dir), "log.txt"))
        out["cost_rel_err"] = cost_error(printed, self.searched)

        # part 3 from the assembler's orders, part 4 from its final orders
        final = [tuple(r.split("\t")) for sec in ref.read_sections(path("finalChromosomeOrdering.txt"))
                 for r in sec]
        out["final_diff"] = ref.differing_lines(final, [r for sec in orders for r in sec])
        out["sub_bin_scaffolds"] = ref.sub_bin_scaffolds(self.inp, self.resolution)

        finals = [[tuple(r.split("\t")) for r in sec]
                  for sec in ref.read_sections(path("finalChromosomeOrdering.txt"))]
        want_fa = ref.assembled_fasta(self.fasta, finals)
        with open(path("assembled.fasta"), "rb") as fh:
            got_fa = fh.read()
        out["fasta_diff"] = 0 if got_fa == want_fa else ref.differing_lines(
            got_fa.split(b"\n"), want_fa.split(b"\n"))
        return out


INSERTED = "BestCost at the end of first two steps "
FINAL = "Best cost at the end of the final step = "


def printed_costs(log_path: str) -> Tuple[List[float], List[float]]:
    """Part 2's costs as a job printed them: after the insertions, and after
    the sliding windows (in the order the chromosomes finished)."""
    inserted, final = [], []
    with open(log_path) as fh:
        for line in fh:
            if line.startswith(INSERTED):
                inserted.append(float(line[len(INSERTED):]))
            elif line.startswith(FINAL):
                final.append(float(line[len(FINAL):]))
    return inserted, final


def cost_error(printed: Tuple[List[float], List[float]], searched: List) -> float:
    """The largest relative gap between the printed costs and the
    reference's, each list sorted; infinite when their counts differ."""
    worst = 0.0
    want = ([c for _, c, _ in searched], [c for _, _, c in searched if c is not None])
    for got, exp in zip(printed, want):
        if len(got) != len(exp):
            return float("inf")
        for a, b in zip(sorted(got), sorted(exp)):
            worst = max(worst, abs(a - b) / max(abs(b), 1e-300))
    return worst


def _flat(sections) -> List:
    """Sections as one list, each opened by a header."""
    out: List = []
    for i, sec in enumerate(sections):
        out.append(("###", i))
        out.extend(tuple(r) for r in sec)
    return out


def judge_jobs(reference: Reference, job_dirs: Sequence[str]) -> Tuple[bool, Dict[str, float]]:
    """The worst reading of each number over the jobs, and whether every
    one is within its limit.  Jobs whose files are byte-equal are judged
    once."""
    seen: Dict[str, Dict[str, float]] = {}
    worst: Dict[str, float] = {}
    for d in job_dirs:
        files = os.path.join(d, "files")
        try:
            key = _digest(files)
        except FileNotFoundError as exc:
            return False, {"missing_file": 1, "missing": str(exc)}  # type: ignore[dict-item]
        if key not in seen:
            seen[key] = reference.judge(files)
        for k, v in seen[key].items():
            worst[k] = max(worst.get(k, v), v)
    ok = bool(job_dirs) and all(v <= LIMITS[k] for k, v in worst.items())
    return ok, worst


def judge_runs(inputs: Sequence[Dict[str, str]], job_dirs: Sequence[str], config: Dict,
               note=lambda message: None) -> Tuple[bool, Dict[str, float]]:
    """``judge_jobs`` over a window whose job k assembled
    ``inputs[k % len(inputs)]``: each input's jobs by its own float64
    reference, built once and freed before the next; the worst reading of
    each number over them all."""
    ok, worst = bool(job_dirs), {}
    for i, paths in enumerate(inputs):
        dirs = job_dirs[i :: len(inputs)]
        if not dirs:
            continue
        reference = Reference(paths, config, np.float64, note)
        ok_i, numbers = judge_jobs(reference, dirs)
        del reference
        if "missing_file" in numbers:
            return False, numbers
        ok = ok and ok_i
        for k, v in numbers.items():
            worst[k] = max(worst.get(k, v), v)
    return ok, worst


def write_outputs(reference: Reference, files_dir: str) -> None:
    """Write the reference's own assembly where a job writes its files:
    with a float32 reference this is the control, the reference put in the
    assembler's place one precision down."""
    os.makedirs(files_dir, exist_ok=True)
    inp = reference.inp
    path = lambda name: os.path.join(files_dir, name)  # noqa: E731
    with open(path("dendrogramOrder.txt"), "w") as fh:
        fh.write("\n".join(f"{inp.labels[i]}\t{i}" for i in reference.leaves))
    with open(path("binGroupings.txt"), "w") as fh:
        for i, g in enumerate(reference.bins):
            fh.write(f"### Chromosome group {i + 1} ###\n" + "".join(x + "\n" for x in g))
    with open(path("chromosomeGroupings.txt"), "w") as fh:
        fh.write("".join(x + "\n" for x in reference.groups))
    orders = [o for o, _, _ in reference.searched]
    with open(os.path.join(os.path.dirname(files_dir), "log.txt"), "w") as fh:
        for _, inserted, final in reference.searched:
            fh.write(INSERTED + str(float(inserted)) + "\n")
            if final is not None:
                fh.write(FINAL + str(float(final)) + "\n")
    for name in ("chromosomeOrdering.txt", "finalChromosomeOrdering.txt"):
        with open(path(name), "w") as fh:
            for i, sec in enumerate(orders):
                fh.write(f"### Chromosome grouping {i + 1} ###\n"
                         + "".join(f"{n}\t{o}\n" for n, o in sec))
    with open(path("assembled.fasta"), "wb") as fh:
        fh.write(ref.assembled_fasta(reference.fasta, orders))
