#!/usr/bin/env python3
"""Splits part 2's host decisions (``part2/host_decide``) on one CUDA card
with cProfile, for the new copies and the parent's.

    python3 tools/part2_host_profile.py [WORKDIR]

Makes the 16K north-star genome of ``chip_smoke.py``'s phase 4
(``utils/e2e.prepare``: 17,162 bins, 25 chromosomes) in WORKDIR (default: a
temporary directory) and runs ``-part1`` on the card (``-mesh off``, plots
skipped) once to warm up.  Then, in this process, ``-part1`` four times in
turns of the parent's copies (``chip_smoke.parent_copies``: pageable
uploads, a blocking ``.cpu()`` a handle) and the new ones, old, new, new,
old, printing each run's part-1 wall and stage timers (part 1's rank matrix
goes up through the same helper), and ``-part2`` on the warm-up's files
four times in the same turns.  The profiler runs only inside the
``part2/host_decide`` timer, the span in which the scheduler hands a search
coroutine its values and the coroutine decides and launches its next batch.  For each run it prints the timer, the
profiled total and its split by cumulative time:

* ``uploads``: ``transfer.to_device`` / ``copy_into`` (or the parent's
  pageable forms), wherever they are called;
* ``rescore_f64``: ``SubsetScorer.score_host``, the reference-exact f64
  re-scoring on the host;
* ``table_build``: ``SubsetScorer.__init__`` (harmonic weights, the
  ``h @ Wm`` table) less its uploads;
* ``kernel_wrappers``: the scoring kernels' wrappers (argument checks and
  launches);
* ``window_candidates``: the sliding window's candidate batches in numpy
  (greedy insertion builds its few rows inline, in the rest);
* ``rest``: Python search control, decision rules and numpy bookkeeping.

The turns are ``chip_smoke.phase_part2_turns`` (phase 4c) with the
profiler around each run.  cProfile adds a cost to every Python call, so
the Python-heavy shares are inflated; the timers of a run without it are
phase 4c's.  The files of every run must equal the warm-up's (part 1) or
the first run's (part 2).  The last line is a JSON object of every run's
numbers.
"""

import contextlib
import cProfile
import filecmp
import json
import os
import pstats
import re
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TURNS = ("old", "new", "new", "old")
LOG = str(REPO / "build" / "part2_host_profile_{}.log")
WRAPPERS = ("pair_scores", "combo_score_topk", "combo_score_topk_partials", "block_scores",
            "block_score_topk", "block_score_topk_partials", "fold_group_triples",
            "pair_profiles")
UPLOADS = ("to_device", "copy_into", "pageable_to_device", "pageable_copy_into")


def _cum(stats, file_tail, names):
    """Cumulative seconds of the functions ``names`` in files ending in
    ``file_tail``."""
    return sum(v[3] for k, v in stats.items() if k[0].endswith(file_tail) and k[2] in names)


def split(stats):
    """The host-decide profile's split (seconds), as the docstring lists it."""
    from hic_genome_assembler_tpu_torch.ops import cost

    up_keys = [k for k in stats if k[2] in UPLOADS and k[0].endswith(("transfer.py",
                                                                      "chip_smoke.py"))]
    # an upload's seconds once: copy_into called by to_device is inside it
    uploads = sum(stats[k][3] - sum(ct for caller, (_cc, _nc, _tt, ct) in stats[k][4].items()
                                    if caller in up_keys) for k in up_keys)
    rescore = _cum(stats, "ops/cost.py", ("score_host",))
    line = cost.SubsetScorer.__init__.__code__.co_firstlineno
    init = [k for k in stats if k[0].endswith("ops/cost.py") and k[1:] == (line, "__init__")]
    table = sum(stats[k][3] for k in init) - sum(
        ct for k in up_keys for caller, (_cc, _nc, _tt, ct) in stats[k][4].items()
        if caller in init)
    wrappers = _cum(stats, "ops/score_kernels.py", WRAPPERS)
    window = _cum(stats, "models/part2_order.py", ("_window_candidates",))
    total = sum(v[2] for v in stats.values())   # every function's own time
    parts = {"uploads": uploads, "rescore_f64": rescore, "table_build": table,
             "kernel_wrappers": wrappers, "window_candidates": window}
    parts["rest"] = total - sum(parts.values())
    return total, parts


@contextlib.contextmanager
def profiled_host_decide(prof):
    """Patches ``profiling.timer`` so that ``prof`` runs inside every
    ``part2/host_decide`` span, for the time of the block."""
    from hic_genome_assembler_tpu_torch.utils import profiling

    timer = profiling.timer

    @contextlib.contextmanager
    def timed(name):
        with timer(name):
            if name != "part2/host_decide":
                yield
                return
            prof.enable()
            try:
                yield
            finally:
                prof.disable()

    profiling.timer = timed
    try:
        yield
    finally:
        profiling.timer = timer


def part1_turns(torch, workdir, main_dir, config, paths, resolution):
    """Part 1 on the card once into ``main_dir`` (the warm-up: kernel builds
    and first calls; part 2 starts from its files), then once for each of
    ``TURNS``, the parent's copies patched in for "old" (its rank matrix
    goes up through the mesh helpers' ``transfer.copy_into``); every turn's
    files must equal the warm-up's.  Prints and returns each turn's part-1
    wall and stage timers (the upload lies in ``cut_detection_hypergeom``)."""
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.utils import e2e

    runs = []
    for k, mode in enumerate(("warm-up",) + TURNS):
        run_dir = main_dir if k == 0 else os.path.join(workdir, f"part1_{k}_{mode}")
        cfg = config if k == 0 else e2e.write_config(
            os.path.join(run_dir, "config.txt"), run_dir, paths, resolution)
        patch = chip_smoke.parent_copies() if mode == "old" else contextlib.nullcontext(None)
        log_path = LOG.format(f"part1_{k}")
        with open(log_path, "w") as log, contextlib.redirect_stdout(log), patch as calls:
            cli.main(["-part1", "-config", cfg, "-device", "cuda", "-mesh", "off"])
            torch.cuda.synchronize()
        if calls is not None:
            chip_smoke.check(calls["copy_into"] > 0, f"the parent's copies were not patched in: "
                             f"{calls}")
        chip_smoke.check(all(filecmp.cmp(os.path.join(run_dir, "files", name),
                                         os.path.join(main_dir, "files", name), shallow=False)
                             for name in chip_smoke.PART1_FILES),
                         f"part-1 run {k} ({mode}) wrote other files than the warm-up")
        text = Path(log_path).read_text()
        run = {"run": k, "copies": mode,
               "part1_wall_s": float(re.findall(r"Total run-time of Part1 = ([0-9.]+)", text)[-1]),
               **{f"{name}_s": float(v) for name, v in
                  re.findall(r"^\[timer\] part1/(\w+): ([0-9.]+)s", text, flags=re.M)}}
        print(f"part-1 run {k} ({mode}) on {chip_smoke.CARD}: " + json.dumps(run))
        if k:
            runs.append(run)
    return runs


def main():
    import torch

    chip_smoke.phase_device(torch)
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.utils import e2e

    sys.modules["matplotlib"] = None  # plots off the device path, as in phase 4
    (REPO / "build").mkdir(exist_ok=True)
    workdir = sys.argv[1] if len(sys.argv) > 1 else tempfile.mkdtemp(prefix="part2_profile_")
    main_dir = os.path.join(workdir, "16k")
    genome, config, paths = e2e.prepare(main_dir, chip_smoke.N_CHROMS)
    part1 = part1_turns(torch, workdir, main_dir, config, paths, genome.resolution)
    profs = []

    def around(_k, _mode):
        profs.append(cProfile.Profile())
        return profiled_host_decide(profs[-1])

    runs = chip_smoke.phase_part2_turns(torch, workdir, main_dir, paths, genome.resolution,
                                        turns=TURNS, log_path=LOG, around=around)
    for k, (run, prof) in enumerate(zip(runs, profs)):
        total, parts = split(pstats.Stats(prof).stats)
        run.update(profiled_s=total, **{f"{name}_s": v for name, v in parts.items()})
        print(f"run {k + 1} ({run['copies']} copies) on {chip_smoke.CARD}: " + json.dumps(run))
        with open(LOG.format(k), "a") as log:
            pstats.Stats(prof, stream=log).sort_stats("cumulative").print_stats(40)
    print(json.dumps({"card": chip_smoke.CARD, "part1_runs": part1, "runs": runs}))


if __name__ == "__main__":
    main()
