"""The measured window: whole assembly jobs through the assembler's CLI,
back to back, and what a traced run records around them.

A job is one call of ``hic_genome_assembler_tpu_torch.cli.main`` with the
mix's parts and ``-config <file> -device <device> -mesh off``; its standard
output goes to a log file in its own directory.  The window starts a new
job while less than the run's seconds have passed and ends when the last
job it started ends; job k assembles the k-th of the run's inputs, taken in
turn.

Each job has a deadline, from its own start: past it a ``SIGALRM`` raises
``JobDeadline`` in the main thread (again every second, should the
program catch it), so the job counts as failed and ends the window.  A
watchdog thread armed with the job calls the run's ``overrun`` if the job
has still not returned ``GRACE_S`` after its deadline (the main thread
stuck in a C call, or the program swallowing every raise); ``overrun``
prints the run's result and ends the process.

In a traced run the benchmark wraps the program's functions, without
editing them, at each layer's entry: a ``torch.profiler.record_function``
span around each, a snapshot of the program's stage timers and counters
after parts 1 and 2 (each part resets them when it starts), and recorders
of the rank-count and HMM scan launches' parameters.  An untraced run
wraps nothing.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import signal
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import genome

PKG = "hic_genome_assembler_tpu_torch"
GRACE_S = 30.0   # the watchdog acts this long after a job's deadline
REPEAT_S = 1.0   # a job past its deadline is raised at again this often

# (module, attribute) of each function a traced run wraps in a span, the
# entries of the program's layers; parts 3 and 4 are spans as wholes.
SPANS = (
    ("models.part1_cluster", "run_pipeline"),
    ("io.hicpro", "initiate_loci"),
    ("io.hicpro", "build_adjacency_matrix"),
    ("io.hicpro", "remove_zero_rows"),
    ("ops.oracle", "to_distance"),
    ("cluster.upgma", "average_cluster_leaf_order"),
    ("ops.oracle", "to_similarity"),
    ("ops.oracle", "rank_matrix_desc"),
    ("ops.oracle", "log_transform"),
    ("ops.oracle", "permute_symmetric"),
    ("cluster.breakpoints", "pre_process_all_matrix_breakpoints"),
    ("cluster.breakpoints", "filter_noisy_breakpoints"),
    ("cluster.hmm_cuts", "identify_chromosome_groups_hmm"),
    ("ops.kmeans", "kmeans2"),
    ("models.part1_cluster", "modularity_remaining_data"),
    ("models.part1_cluster", "assess_chromosome_clustering"),
    ("models.part2_order", "run_pipeline"),
    ("models.part2_order", "_run_interleaved"),
    ("ops.cost", "argmax_reference_ties"),
    ("ops.cost", "argmax_reference_ties_sparse"),
    ("utils.transfer", "finish_readback"),
    ("models.part3_orient", "run_pipeline"),
    ("models.part4_fasta", "run_pipeline"),
)


@dataclass
class Job:
    """What one job did: its wall seconds, the CLI's seconds per part, the
    program's stage timers (seconds) and counters, and its kernel launches
    by table."""

    wall_s: float
    part_seconds: Dict[str, float]
    timers: Dict[str, float] = field(default_factory=dict)
    counters: Dict[str, int] = field(default_factory=dict)
    launches: Dict[str, int] = field(default_factory=dict)


@dataclass
class Readings:
    """Everything a per-layer metric's reader may read."""

    jobs: List[Job]
    trace: Optional[object] = None          # tracing.Trace of the window
    rank_calls: List[Dict] = field(default_factory=list)
    hmm_calls: List[int] = field(default_factory=list)


def _launches() -> Dict[str, int]:
    """The program's kernel launch tables, summed by table."""
    ck = importlib.import_module(f"{PKG}.ops.count_kernels")
    sk = importlib.import_module(f"{PKG}.ops.score_kernels")
    hk = importlib.import_module(f"{PKG}.ops.hmm_kernels")
    return {"count_kernels": int(ck.LAUNCHES), "score_kernels": int(sum(sk.LAUNCHES.values())),
            "hmm_kernels": int(sum(hk.LAUNCHES.values()))}


@contextlib.contextmanager
def _patched(patches: List[tuple]):
    """Each (object, attribute, make) replaced by ``make(original)`` inside
    the block."""
    originals = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    try:
        for (obj, name, make), (_, _, original) in zip(patches, originals):
            setattr(obj, name, make(original))
        yield
    finally:
        for obj, name, original in originals:
            setattr(obj, name, original)


class Tracing:
    """The traced run's wrappers: spans, snapshots and launch recorders."""

    def __init__(self):
        self.snapshot: Dict[str, Dict] = {}
        self.rank_calls: List[Dict] = []
        self.hmm_calls: List[int] = []

    @contextlib.contextmanager
    def installed(self):
        import torch

        profiling = importlib.import_module(f"{PKG}.utils.profiling")
        patches = []
        for mod_name, attr in SPANS:
            mod = importlib.import_module(f"{PKG}.{mod_name}")
            label = f"{mod_name.split('.')[-1]}.{attr}"

            def make(original, label=label, part=attr == "run_pipeline"):
                def spanned(*args, **kwargs):
                    with torch.profiler.record_function(label):
                        out = original(*args, **kwargs)
                    if part:
                        # the part's timers, before the next part resets them
                        self.snapshot[label] = {"timers": {k: v["total_s"] for k, v in
                                                           profiling.summary().items()},
                                                "counters": profiling.counters()}
                    return out
                return spanned

            patches.append((mod, attr, make))
        ck = importlib.import_module(f"{PKG}.ops.count_kernels")
        hk = importlib.import_module(f"{PKG}.ops.hmm_kernels")

        def rank_recorder(original):
            def recording(rank_mat, params, row0=0, col0=0):
                if rank_mat.device.type == "cuda":
                    import numpy as np

                    self.rank_calls.append({
                        "params": np.asarray(params, dtype=np.int64).reshape(-1, 3).copy(),
                        "shape": tuple(rank_mat.shape), "offsets": (row0, col0),
                        "elem_bytes": rank_mat.element_size()})
                return original(rank_mat, params, row0, col0)
            return recording

        def hmm_recorder(original):
            def recording(log_b, log_start, log_trans):
                if log_b.device.type == "cuda":
                    self.hmm_calls.append(int(log_b.shape[0]))
                return original(log_b, log_start, log_trans)
            return recording

        patches.append((ck, "counts_many", rank_recorder))
        patches.append((hk, "forward_backward", hmm_recorder))
        with _patched(patches):
            yield


class JobDeadline(Exception):
    """A job ran past its deadline."""


@contextlib.contextmanager
def deadline(seconds: float, job: str, overrun: Callable[[str], None]):
    """Stop the block, which must run in the main thread, ``seconds`` after
    it starts: raise ``JobDeadline`` in it, and call ``overrun`` with what
    happened from a watchdog thread if it has not returned ``GRACE_S``
    later."""
    done = threading.Event()

    def alarm(signum, frame):
        raise JobDeadline(f"job {job} ran past its deadline of {seconds:g} s")

    def watch():
        if not done.wait(seconds + GRACE_S):
            overrun(f"job {job} had not returned {GRACE_S:g} s after its deadline of "
                    f"{seconds:g} s")

    watchdog = threading.Thread(target=watch, name=f"hicbench-watchdog-{job}", daemon=True)
    previous = signal.signal(signal.SIGALRM, alarm)
    signal.setitimer(signal.ITIMER_REAL, seconds, REPEAT_S)
    watchdog.start()
    try:
        yield
    finally:
        try:
            signal.setitimer(signal.ITIMER_REAL, 0)
        finally:
            done.set()
            signal.signal(signal.SIGALRM, previous)
            watchdog.join()


def run_job(workdir: str, paths: Dict[str, str], config: Dict, parts: List[str],
            device: str, deadline_s: float, overrun: Callable[[str], None],
            tracing: Optional[Tracing] = None) -> Job:
    """One assembly: a config whose outputs land in ``workdir/files``, the
    CLI on it with its output in ``workdir/log.txt``, stopped past
    ``deadline_s`` (``deadline``; the job is named by its directory)."""
    cli = importlib.import_module(f"{PKG}.cli")
    cfg = genome.write_config(os.path.join(workdir, "config.txt"), workdir, paths,
                              config["genome"]["resolution"], config["settings"])
    argv = [f"-{p}" for p in parts] + ["-config", cfg, "-device", device, "-mesh", "off"]
    before = _launches()
    if tracing is not None:
        tracing.snapshot.clear()
    t0 = time.perf_counter()
    with open(os.path.join(workdir, "log.txt"), "w") as log, contextlib.redirect_stdout(log), \
            deadline(deadline_s, os.path.basename(workdir), overrun):
        report = cli.main(argv)
    wall = time.perf_counter() - t0
    after = _launches()
    job = Job(wall, dict(report.part_seconds),
              launches={k: after[k] - before[k] for k in after})
    if tracing is not None:
        for snap in tracing.snapshot.values():
            job.timers.update(snap["timers"])
            job.counters.update(snap["counters"])
    return job


def run_window(seconds: float, make_dir: Callable[[int], str], inputs: List[Dict[str, str]],
               config: Dict, parts: List[str], device: str, deadline_s: float,
               overrun: Callable[[str], None], tracing: Optional[Tracing] = None) -> tuple:
    """Jobs back to back until ``seconds`` have passed, job k on
    ``inputs[k % len(inputs)]``, each stopped past ``deadline_s``; returns
    (jobs, the job directories, window seconds, the exception that ended a
    job)."""
    jobs, dirs, error = [], [], None
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        d = make_dir(len(dirs))
        paths = inputs[len(dirs) % len(inputs)]
        dirs.append(d)
        try:
            jobs.append(run_job(d, paths, config, parts, device, deadline_s, overrun, tracing))
        except Exception as exc:  # a job that fails counts as failed, and ends the window
            error = exc
            break
    return jobs, dirs, time.perf_counter() - t0, error
