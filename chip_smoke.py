#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (hic_genome_assembler_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc).  Phases, each of which
passes or fails the run:

1. device: the card's nvidia-smi name and power limit, torch and CUDA
   versions;
2. build: the host IO library from csrc/hostio/*.cpp with g++ into
   build/hostio/, then csrc/*.cu with nvcc into build/kernels/, printing
   each kernel's registers, shared memory and spills as ptxas reports them;
3. kernels: the rank-count kernel against its plain torch version on the
   card, exact integer equality at the 16K genome's shapes and at the
   test shapes, in int16 (pad_rank's choice at this size) and int32, then
   the K=8 growing and K=64 fixed batches timed (CUDA events a call, the
   device time from torch.profiler, and with launches queued behind a spin
   kernel, ``queued_ms``) beside the read-once bound (the
   union of the batch's prefixes) and the bytes a kernel streams that
   reads each scan's own prefix;
4. main path: the 16K-bin north-star genome through
   ``hic_genome_assembler_tpu_torch.cli.main`` (-part1 -part2 -part3
   -part4, device cuda, mesh off), with the planted-truth checks; part 2
   must launch the scoring kernels exactly as often as the fixture needs
   (``MAIN_SCORE_LAUNCHES``: 29 profiles, 29 combo top-k, 1,206 pair scores,
   no block scores), call no plain scoring version on the card and report
   0 precision violations.  Every rank-count launch's batch is recorded
   (K, growing or fixed, the prefix elements a scan and the union; the
   batches in build/chip_smoke_rank_batches.json), every pair-score
   launch's (B, W, real ids a row), and every profile build's and combo
   launch's inputs (copies on the card: ``score_input_recorder``), and
   summarized.
   Then -part2 with -device cpu (the plain versions) on the same part-1
   files: its chromosomeOrdering.txt and plotOrder.txt must be byte-equal
   to the card's.  Last, -part2 on the card again under torch.profiler:
   device busy and idle shares, its copies by direction and host memory
   (none may touch pageable memory: every upload and readback of part 2
   goes through pinned memory, ``utils/transfer``), the kernels with most
   device time; then -part1 the same way: part 1's device busy share and
   the rank-count kernel's device time.  Output in
   build/chip_smoke_pipeline.log, build/chip_smoke_part2_cpu.log,
   build/chip_smoke_part2_profile.log and build/chip_smoke_part1_profile.log;
4c. copy turns: -part2 on phase 4's part-1 files four times in this
   process, the new copies and the parent's (pageable uploads, a blocking
   .cpu() a handle at the drain, patched in by ``parent_copies``) in turns
   new, old, old, new: each run's part-2 wall, scheduler_readback_wait and
   host_decide timers, and its files, byte-equal to phase 4's.  Output in
   build/chip_smoke_turn{0..3}.log;
4b. replay: every rank-count batch of phase 4, in order, on phase 3's
   random matrix padded as RankCounts pads it (17,184), in int16 and int32:
   each output equal to the plain version, then each batch's device time
   (``queued_ms``, L2 flushed before each launch) beside its read-once
   bound, summed, and the largest batch's; the previous kernel's times
   (``OLD_REPLAY``, from another run) are printed beside them, and stay out
   of the kernels' JSON record;
5. HMM kernels: the chunked-scan forward-backward and Viterbi kernels
   timed with CUDA events at T = 3,715 and 17,162 (before any plain loop
   runs), then held against their plain torch loops on the card at T = 1,
   2, 31, 511, 512, 513, 1023, 1024, 1025, 3,715, 17,162 and 100,003
   (empty chunks, chunk edges, T far above the block), with a -inf
   transmat entry, and on integer inputs whose sums are exact (constant
   rows: every step a tie; per-state rows: frequent ties), within
   ``hmm_kernels``' bounds (the log-likelihood relatively to (T + 8) *
   2**-52, gamma to 1e-9 absolute, the xi sums relatively to 1e-9 plus
   twice the log-likelihood's bound), no NaN, identical paths; their times
   a call (CUDA events) and on the device (torch.profiler) are printed
   beside their bounds and the plain loops' times;
5b. scoring kernels: pair profiles, combo top-k (and its group epilogue),
   block scores and pair scores against their plain torch versions on the
   card at the main path's shapes and bench.py's combo shape (5.16M
   candidates): integer-valued inputs exactly (values, argmaxes, second
   maxima, ties included), seeded floats within ``sum_bound``, two launches
   bit-identical; each timed with CUDA events beside its plain version and
   its bound (bytes: each input read once, of the table only the distinct
   values the launch gathers, of the matrix only the off-diagonal blocks
   the profile kernel reads), and the table product h @ Wm at its most
   frequent shape.  The block kernel runs in its grid form (the
   escalation's chunk and the whole escalation at S = 8, R not a multiple
   of 4 or 32, repeated ids) and its top-k form (a one-scaffold
   chromosome's 1 x 2, its only caller, and 20,160 orders at S = 9 with all
   512 orientations and with 64 random rows, which no caller reaches), with
   the two-launch form and the JAX function's formulation in two PyTorch
   calls (a gather, then addmm: ``library_ms``) timed beside it;
   ``group_topk`` alone is timed at the parent's mesh epilogue's shape and
   one tile.  The mesh epilogue (``mesh_epilogue``) runs at its callers'
   two shapes, S = 6 (23,040 candidates) and bench.py's build_problem at S =
   8 (5,160,960), on a virtual (2, 2) mesh of the card: through
   ``SubsetScorer.score_batch_topk`` (2 combo launches of partial group
   triples, 1 ``topk_fold``, the selection equal to one device's), then the
   new form and the parent's (``combo_scores`` a block, ``pm.gather``,
   ``group_argmax``) bit-equal to each other and to the plain version on an
   integer table, each timed in turns, whole and its epilogue alone, beside
   the bytes it moves to the scorer's device and its bound.  The pair-score
   batches include one shaped as the sliding window builds it; the previous kernels' times
   (``OLD_PAIR``, ``OLD_BLOCK``, from another run) are printed beside them,
   and stay out of the kernels' JSON record.  The
   top-k sweep (``topk_sweep``: 1, 2, 3 and 20+ tiles, ragged groups,
   integer ties, 5 seeds) runs three times.  The profile and combo
   kernels' previous times at these shapes (``OLD_PROFILES``,
   ``OLD_COMBO``, another run) are printed beside this run's and stay out of
   the JSON record.  Then phase 4's profile builds and combo launches are
   replayed on their own inputs (``phase_score_replay``): each held to its
   plain version, two launches bit-identical, and each set's device time
   (``queued_ms``) printed beside its summed bound.  Then
   part 2's brute force with a forced escalation over six and over eight
   one-bin scaffolds (5,160,960 dense scores), on the card and on the CPU:
   the same decision, and the block kernel launched; at eight, the
   escalation's split (the block launches' device time, the readback,
   pinned and as pageable copies, and the host's dense decision);
6. HMM path: the CLI (-part1 -part2 -part3 -part4, device cuda, hmm = True)
   on the 3,715-bin HMM genome; its cut list and part-1 files must equal
   the JAX package's golden record (utils/hmm_golden_3715.json); output in
   build/chip_smoke_hmm.log;
7. device mode: -part1 with matrixMode = device on the 16K genome of phase
   4; the rank matrix is ranked and counted on the card, and 64 of its rows
   must equal numpy's stable argsort, reversed, of the same f32 input;
   output in build/chip_smoke_device.log;
8. mesh kernels: phase 3's 17,162-bin matrix and batches in the (2, 2) and
   (4, 1) block layouts of a mesh, in int16 and int32; the kernel with each
   block's offsets must
   equal its plain version (max abs err 0) and the blocks' sums one launch
   on the whole matrix; a virtual-mesh RankCounts must equal the
   single-device one; the K=8 growing batch timed over the (2, 2) blocks
   against one launch;
9. mesh path: part 1 then part 2 (``cli.run_parts``) on phase 4's genome
   with a virtual (2, 2) mesh whose positions are all cuda:0; their files
   must be byte-equal to phase 4's, and the scoring kernels (each combo
   batch's blocks emitting partial group triples, folded once: no score
   gathered) launched as ``MESH_SCORE_LAUNCHES`` says, no plain version on
   the card.  With
   two cards or more, the CLI with -mesh auto over the real cards runs too.
   Output in build/chip_smoke_mesh.log;
10. EP: two CLI processes (-part2, RANK 0 and 1, WORLD_SIZE 2, a free
   localhost port) share the card on phase 4's part-1 files; the merged
   chromosomeOrdering.txt and plotOrder.txt must be byte-equal to phase 4's,
   and each process prints its scoring kernels' launches, which must cover
   the three of its shard's path and sum to phase 4's.  Output in build/chip_smoke_ep{0,1}.log;
11. working example: examples/working_example_torch.py --device cuda on a
   copy of its committed config with the workdir in this run's temporary
   directory, through its truth check; it must launch the profile, combo
   (S = 4) and pair-score kernels and no plain scoring version on the
   card.  Output in build/chip_smoke_working_example.log.

Each of phases 4, 5b (each forced escalation), 6, 7, 9 and 11 sets the launch
counts of its kernels to 0 just before it drives its path and fails if a
kernel of that path was not launched; phase 10's processes start from 0.
Phase 1 prints the card's nvidia-smi name and power limit, and phases 3,
4b and 5b repeat them beside each time they print.  A device time from
torch.profiler is printed only where the trace holds one event for each
launch the wrapper counted (``device_ms``), else "not measured".  The
second-to-last stdout line is the kernels' JSON record (each kernel's
launches from its path: block_score's from the forced escalations,
topk_fold's from phase 9's mesh, the others' from phase 4), the last line
{"ok": true, "device": {...}}.
Without a CUDA device, or without the package beside it, the script exits
non-zero and prints no result.
"""

import contextlib
import filecmp
import hashlib
import json
import math
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
LOG = REPO / "build" / "chip_smoke_pipeline.log"
N_CHROMS = 25          # all 25 planted chromosomes: 17,162 bins
N_RANK = 17162         # rank-matrix size of the kernel phase (= the genome's bins)
KERNEL_SOURCE = "hic_genome_assembler_tpu_torch/csrc/rank_counts.cu"
REPLACES = "hic_genome_assembler_tpu/ops/pallas_kernels.py:45"
HMM_LOG = REPO / "build" / "chip_smoke_hmm.log"
DEVICE_LOG = REPO / "build" / "chip_smoke_device.log"
HMM_SOURCE = "hic_genome_assembler_tpu_torch/csrc/hmm_scan.cu"
HMM_REPLACES = {
    "hmm_forward_backward": "hic_genome_assembler_tpu/ops/gaussian_hmm.py:62",
    "hmm_viterbi": "hic_genome_assembler_tpu/ops/gaussian_hmm.py:264",
}
# 3,715: the HMM path's largest fit; 17,162: the 16K genome; the rest put
# the chunk edges of the 512- and 1024-thread blocks (T - 1 steps about the
# block size) and T far above them under test
HMM_T = (1, 2, 31, 511, 512, 513, 1023, 1024, 1025, 3715, 17162, 100003)
HMM_EXTRA = ((3715, "neg_inf"), (17162, "neg_inf"), (1025, "ties"), (17162, "ties"),
             (3715, "int"), (100003, "int"))
HMM_TIMED_T = (3715, 17162)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
FP64_OPS_PER_S = 34e12             # H100 SXM data sheet, f64 outside the tensor cores
INT32_OPS_PER_S = 132 * 64 * 1.98e9  # H100 SXM: 132 SMs x 64 int32 lanes x ~1.98 GHz
HMM_GENOME_N = 8192                # make_hmm_genome(8192): 3,715 bins
N_RANK_ROWS = 64                   # device-mode rank rows held against numpy
MESH_LOG = REPO / "build" / "chip_smoke_mesh.log"
EP_LOG = str(REPO / "build" / "chip_smoke_ep{}.log")
MESH_LAYOUTS = ((2, 2), (4, 1))    # phase 8's block layouts
SCORE_SOURCE = "hic_genome_assembler_tpu_torch/csrc/score_kernels.cu"
SCORE_REPLACES = {
    "pair_profiles": "hic_genome_assembler_tpu/ops/cost.py:82",
    "combo_score_topk": "hic_genome_assembler_tpu/ops/cost.py:382",
    "block_score": "hic_genome_assembler_tpu/ops/cost.py:203",
    "pair_score": "hic_genome_assembler_tpu/ops/cost.py:402",
    "topk_fold": "hic_genome_assembler_tpu/ops/cost.py:251",
}
# the main path's launches are checked for these; block_score runs on escalation only
# the scoring kernels' launches on the 16K run (29 chromosome groups; they
# depend on the fixture, not the device): block scores only on escalation
MAIN_SCORE_LAUNCHES = {"pair_profiles": 29, "combo_score_topk": 29, "block_score": 0,
                       "pair_score": 1206, "group_argmax": 0, "topk_fold": 0}
# on a (2, 2) mesh each combo and pair launch runs once a data-axis block (the
# combo launches as partial group triples), and the fold once a combo batch;
# no score is gathered, so group_argmax runs no time
MESH_SCORE_LAUNCHES = {"pair_profiles": 29, "combo_score_topk": 58, "block_score": 0,
                       "pair_score": 2412, "group_argmax": 0, "topk_fold": 29}
FP32_OPS_PER_S = 67e12             # H100 SXM data sheet, f32 outside the tensor cores
SCORE_SP, SCORE_CP1 = 56, 769      # the 16K run's widest tables: 12,544 rows x 769 columns
SCORE_W = 56                       # its candidate width (55 scaffolds rounded up to 8)
SCORE_LOG = REPO / "build" / "chip_smoke_part2_cpu.log"
PROFILE_LOG = REPO / "build" / "chip_smoke_part2_profile.log"
PART1_PROFILE_LOG = REPO / "build" / "chip_smoke_part1_profile.log"
TURNS_LOG = str(REPO / "build" / "chip_smoke_turn{}.log")
COPY_TURNS = ("new", "old", "old", "new")    # 4c: part 2's copies, new and the parent's
EXAMPLE_LOG = REPO / "build" / "chip_smoke_working_example.log"
EXAMPLE_SCRIPT = REPO / "examples" / "working_example_torch.py"
EXAMPLE_CONFIG = REPO / "configs" / "hicAssembler_config_fixtureExample_torch.txt"
EXAMPLE_WORKDIR = "/tmp/hic_working_example_torch"   # the committed config's
EXAMPLE_S = 4                      # its nScaffolds: the combo launches' S
BATCHES_LOG = REPO / "build" / "chip_smoke_rank_batches.json"  # phase 4's rank-count batches
REPLAY_REPS = 3                    # device-timed launches of each replayed batch
# The previous kernels' times at the same shapes, printed beside this run's
# and never put in its JSON record: phases 4b and 5b of this script run on
# the kernels of commit 7c07379 (the replay timed by torch.profiler, which
# caught every event there; the pair scores with launches queued), on an
# NVIDIA H100 80GB HBM3 at 700.00 W, in another run.
_OLD_FROM = "commit 7c07379's kernels, another run, NVIDIA H100 80GB HBM3, 700.00 W"
OLD_REPLAY = {"from": _OLD_FROM, "batches_ms": 90.5032, "largest_ms": 35.1792}
OLD_PAIR = {"from": _OLD_FROM,
            "window B=30720": {"ms": 0.4123, "queued_ms": 0.4115},
            "window-shaped B=30720": {"ms": 0.1116, "queued_ms": 0.1111},
            "greedy B=112": {"ms": 0.0251, "queued_ms": 0.0068}}
# The profile and combo kernels of commit a210703 at phase 5b's shapes: this
# script's phase 5b in another run (queued device times, NVIDIA H100 80GB
# HBM3, 700.00 W); printed beside this run's and never put in its JSON record.
_OLD_FROM_A210703 = "commit a210703's kernels, another run, NVIDIA H100 80GB HBM3, 700.00 W"
OLD_PROFILES = {"from": _OLD_FROM_A210703, "cmax=384": 0.0531, "cmax=128": 0.0201}
OLD_COMBO = {"from": _OLD_FROM_A210703, "S=6 360x64": 0.0111, "S=8 20160x256": 0.2489}
# The block kernel of commit 9ea1eec at phase 5b's shapes (queued device
# times; its top-k form is block_scores, then group_argmax), measured in
# another run in turns with this script's kernels; printed, never put in
# the JSON record.
OLD_BLOCK = {"from": "commit 9ea1eec's kernels, another run, NVIDIA H100 80GB HBM3, 700.00 W",
             "S=8 2048x256": 0.0174, "S=8 20160x256": 0.1143, "S=9 20160x512 top-k": 0.2762}
REPLAY_ITERS = 5                   # queued launches a replayed profile build or combo launch
# the scoring phase's shapes: pair-score batches (label, B, real ids a row,
# rows random, shaped as the sliding window's, or with pads scattered
# inside), combo batches (S, Sp, C + 1 of the table),
# block batches (S, orders, every orientation or so many random rows) of
# the grid and the top-k form, profile builds (largest scaffold, cmax);
# the first of each is the one timed on the main path
SCORE_SHAPES = {
    "pair": (("window B=30720", 30720, 55, "random"),
             ("window-shaped B=30720", 30720, 55, "window"),
             ("greedy B=112", 112, 30, "random"), ("pads inside B=509", 509, 40, "scatter")),
    "combo": ((6, SCORE_SP, SCORE_CP1), (8, 9, 2049)),
    "block": ((8, 2048, "all"), (8, 20160, "all"), (6, 360, "all"), (8, 500, 37), (8, 500, 100)),
    "block_topk": ((1, 1, "all"), (9, 20160, "all"), (9, 20160, 64)),
    "profiles": ((380, 384), (120, 128)),
}
PART1_FILES = ("dendrogramOrder.txt", "binGroupings.txt", "clusterAssessment.txt",
               "chromosomeGroupings.txt")
PART2_FILES = ("chromosomeOrdering.txt", "plotOrder.txt")
# one EP rank: the CLI's part 2, plots skipped as in phase 4
EP_CHILD = """
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, sys.argv[1])
from hic_genome_assembler_tpu_torch import cli
cli.main(["-part2", "-config", sys.argv[2], "-device", "cuda"])
import json
from hic_genome_assembler_tpu_torch.ops import score_kernels
print("[launches] " + json.dumps(score_kernels.LAUNCHES))
"""


CARD = "the card"                  # phase 1's nvidia-smi line: name, power limit


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` warm calls, CUDA events,
    after ``iters // 10`` calls (at least one) that bring the clocks up."""
    for _ in range(max(1, iters // 10)):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fn, kernel, launches, iters=20):
    """Mean device milliseconds that a call of ``fn`` spends in the CUDA
    kernels whose names hold ``kernel`` (a string, or a tuple of them: a
    call of several kernels, the one every call launches first), from
    torch.profiler's trace of ``iters`` warm calls (free of the host's time
    per call, which CUDA events over back-to-back calls include once it
    exceeds the kernel's).  ``launches()`` reads the wrapper's launch count:
    the trace must hold one event of the first kernel for each launch the
    wrapper counted in the window, and of each other kernel none or as many.
    Otherwise the trace missed events and the time is None (printed as "not
    measured"): never a number from another window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    before = launches()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    launched = launches() - before
    names = (kernel,) if isinstance(kernel, str) else kernel
    found = [(sum(e.count for e in prof.key_averages() if name in e.key),
              sum(e.self_device_time_total for e in prof.key_averages() if name in e.key))
             for name in names]
    events = [count for count, _us in found]
    if launched == 0 or events[0] != launched or any(c not in (0, launched) for c in events):
        print(f"  device time of {names} not measured: {events} trace events for {launched} "
              "launches")
        return None
    return sum(us for _count, us in found) / 1e3 / iters


def queued_ms(torch, fn, iters=20, cold=None):
    """Mean milliseconds a call of ``fn`` takes on the device when the host
    runs ahead: the stream is held by a spin kernel of about 25 ms while the
    host enqueues a start event, ``iters`` calls and an end event, so the
    card runs them back to back and the events hold no host time.  None
    where the card reached the start event before the host had enqueued the
    end (a wrapper that waits for the device, or a spin too short).
    ``cold()``, where given, runs on the device before the spin (an L2
    flush)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if cold is not None:
        cold()
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    ahead = not start.query()
    end.synchronize()
    return start.elapsed_time(end) / iters if ahead else None


def sha256(path):
    with open(path, "rb") as handle:
        return hashlib.sha256(handle.read()).hexdigest()


def log_counter(log_path, name):
    """The value of part 1's ``[counter] part1/<name>`` line in a run's log."""
    with open(log_path) as log:
        for line in log:
            if line.startswith(f"[counter] part1/{name}:"):
                return int(line.rsplit(":", 1)[1])
    raise SmokeFailure(f"no part1/{name} counter in {log_path}")


def echo_timers(log_path):
    with open(log_path) as log:
        for line in log:
            if line.startswith(("[timer]", "[counter]", "- precision")):
                print("  " + line.rstrip())


def reset_launches():
    """Set every kernel's launch count to 0 (before a path is driven)."""
    from hic_genome_assembler_tpu_torch.ops import count_kernels, hmm_kernels, score_kernels

    count_kernels.LAUNCHES = 0
    for counts in (hmm_kernels.LAUNCHES, score_kernels.LAUNCHES):
        for name in counts:
            counts[name] = 0


def score_launches():
    from hic_genome_assembler_tpu_torch.ops import score_kernels

    return dict(score_kernels.LAUNCHES)


PLAIN_SCORERS = ("pair_profiles_plain", "combo_scores_plain", "combo_score_topk_plain",
                 "block_scores_plain", "block_score_topk_plain", "pair_scores_plain",
                 "_group_argmax", "combo_score_topk_partials_plain",
                 "block_score_topk_partials_plain", "_group_partials",
                 "fold_group_triples_plain")


@contextlib.contextmanager
def plain_scorers_on_cuda():
    """Counts the calls of the scoring kernels' plain versions on CUDA
    tensors while the block runs (yields the dict of counts)."""
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    calls = {name: 0 for name in PLAIN_SCORERS}
    originals = {name: getattr(sk, name) for name in PLAIN_SCORERS}

    def counting(name):
        def wrapper(*args, **kwargs):
            if args[0].device.type == "cuda":
                calls[name] += 1
            return originals[name](*args, **kwargs)
        return wrapper

    for name in PLAIN_SCORERS:
        setattr(sk, name, counting(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(sk, name, fn)


def precision_line(log_path):
    """The numbers of part 2's ``- precision: ...`` summary in a run's log."""
    with open(log_path) as log:
        found = re.findall(r"- precision: (\d+) rescored, max rel err (\S+), (\d+) escalations, "
                           r"(\d+) violations", log.read())
    check(found, f"no part-2 precision summary in {log_path}")
    n, max_rel, esc, viol = found[-1]
    return {"rescored": int(n), "max_rel": float(max_rel), "escalations": int(esc),
            "violations": int(viol)}


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    global CARD
    CARD = smi[0]
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")


def phase_build():
    from hic_genome_assembler_tpu_torch.io import native
    from hic_genome_assembler_tpu_torch.ops import _build

    t0 = time.time()
    check(native.available(), "the host IO library (csrc/hostio/*.cpp) did not build with g++")
    print(f"build: host IO library {native._SO_PATH} ready in {time.time() - t0:.2f} s")
    seconds = _build.build()
    _build.library()
    print(f"build: nvcc {seconds:.2f} s into {_build.BUILD_DIR} "
          "(0.00 = library already current)")
    for line in _build.LOG.read_text().splitlines():
        if line.startswith("==") or "Function properties" in line or "Used" in line \
                or "spill" in line:
            print("  " + line.strip())


def phase_kernels(torch, np):
    """Exact equality of kernel and plain version; returns the kernel record."""
    from hic_genome_assembler_tpu_torch.ops import count_kernels as ck

    dev = torch.device("cuda")
    max_err = 0

    def compare(label, mat, params):
        nonlocal max_err
        got = ck.counts_many(mat, params)
        want = ck.counts_many_plain(mat, params)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max().item())
        max_err = max(max_err, err)
        check(err == 0, f"{label}: kernel differs from plain version (max abs err {err})")
        print(f"kernel == plain: {label} ({len(params)} scans, {tuple(mat.shape)}"
              f"{'' if mat.is_contiguous() else ' view'})")

    n = N_RANK
    t0 = time.time()
    R = ck.pad_rank(random_rank(torch, np, n, 0))
    # the element type pad_rank chooses (int16 at this size) and int32: two
    # instantiations of the kernel, both held to the plain version
    kinds = [R.dtype] + ([torch.int32] if R.dtype != torch.int32 else [])
    mats = {dtype: R.to(dtype) for dtype in kinds}
    print(f"rank matrix n={n}: padded {tuple(R.shape)} {R.dtype} on {R.device} "
          f"({time.time() - t0:.1f} s to make); held in {[str(k) for k in kinds]}")
    starts, growing, fixed = kernel_batches(np, n)
    for dtype in kinds:
        small = ck.pad_rank(random_rank(torch, np, 603, 2)).to(dtype)
        rect = ck.pad_rank(random_rank(torch, np, 3000, 5)).to(dtype)
        for label, mat, params in (
                ("growing K=8 at 16K", mats[dtype], growing),
                ("fixed K=64 at 16K", mats[dtype], fixed),
                ("fixed K=64 at 16K, 2048-column view", mats[dtype][:, :2048], fixed),
                ("fixed K=64 at 16K, 4096-column view", mats[dtype][:, :4096], fixed),
                ("growing + fixed K=72 at 16K", mats[dtype], growing + fixed),
                ("growing n=603", small, [[s, 0, 1] for s in (0, 1, 7, 300, 601)]),
                ("fixed n=603", small, [[0, 5, 0], [3, 77, 0], [100, 400, 0], [0, 602, 0]]),
                ("fixed n=3000, 2048-column view", rect[:, :2048],
                 [[0, 5, 0], [3, 77, 0], [100, 640, 0], [900, 2500, 0], [2940, 2999, 0]])):
            compare(f"{label} {dtype}", mat, params)
        del small, rect

    # timing: warm, CUDA events over repeated launches, and the device time
    n_r, n_c = R.shape
    launches = lambda: ck.LAUNCHES  # noqa: E731
    timed = {}
    for label, params in (("growing K=8", growing), ("fixed K=64", fixed)):
        for dtype in kinds:
            mat = mats[dtype]
            bound, bound_by, per_scan, union, ops = rank_bound(
                np, ck, params, n_r, n_c, mat.element_size())
            ms = cuda_ms(torch, lambda: ck.counts_many(mat, params), 20)
            dev_ms = device_ms(torch, lambda: ck.counts_many(mat, params), "rank_counts_",
                               launches)
            queued = queued_ms(torch, lambda: ck.counts_many(mat, params))
            timed[(label, dtype)] = (ms, dev_ms, queued, bound, bound_by)
            on_device, in_queue = ("not measured" if x is None else (
                f"{x:.4f} ms, {100 * bound / x:.1f}% of the bound") for x in (dev_ms, queued))
            print(f"{label} at n={n}, {dtype} on {CARD}: kernel {ms:.4f} ms a call, on the "
                  f"device {on_device} (profiler), {in_queue} with launches queued (CUDA "
                  f"events); bound {bound:.4f} ms ({bound_by}: the union of the "
                  f"prefixes read once, {union / 1e6:.1f}M elements, "
                  f"{mat.element_size() * union / 1e9:.3f} GB, "
                  f"and the int32 counts; {ops / 1e6:.1f}M nested compares); a kernel that "
                  f"reads each scan's own prefix streams {per_scan / 1e6:.1f}M elements, "
                  f"{mat.element_size() * per_scan / 1e9:.3f} GB")
    plain_ms = cuda_ms(torch, lambda: ck.counts_many_plain(R, growing), 5)
    print(f"growing K=8 at n={n}: plain {plain_ms:.4f} ms; no single PyTorch call computes "
          "a masked count over a per-row prefix")
    ms, dev_ms, queued, bound, bound_by = timed[("growing K=8", R.dtype)]
    record = {"name": "rank_counts", "route": "cuda", "source": KERNEL_SOURCE,
              "replaces": REPLACES, "max_abs_err": max_err, "shape": f"growing K=8 {R.dtype}",
              "ms": ms, "device_ms": dev_ms, "queued_ms": queued, "plain_ms": plain_ms,
              "bound_ms": bound, "bound_by": bound_by, "library_ms": None}
    for (label, dtype), (ms, dev_ms, queued, bound, bound_by) in timed.items():
        if (label, dtype) != ("growing K=8", R.dtype):
            record[f"at {label} {dtype}"] = {"ms": ms, "device_ms": dev_ms, "queued_ms": queued,
                                             "bound_ms": bound, "bound_by": bound_by}
    del R, mats
    torch.cuda.empty_cache()
    return record


def nested_compares(np, ck, params, n_rows, n_cols, row0=0, col0=0):
    """One compare for each element of each group's union prefix: the
    growing scans are one group, the fixed scans one group a start."""
    p = np.asarray(params, dtype=np.int64).reshape(-1, 3)
    grow = p[:, 2] == 1
    groups = [p[grow]] + [p[~grow & (p[:, 0] == s)] for s in np.unique(p[~grow, 0])]
    return sum(ck.batch_prefix_elements(g, n_rows, n_cols, row0, col0)[1]
               for g in groups if len(g))


def rank_bound(np, ck, params, n_rows, n_cols, elem_bytes, row0=0, col0=0):
    """The least time of one rank-count launch: ``(ms, "bytes" or
    "operations", per-scan elements, union elements, compares)``.  Bytes:
    the union of the batch's prefixes (per row, the widest), each element
    read once at ``elem_bytes``, the params read once and the int32 counts
    written once, at HBM's rate.  Operations: one int32 compare for each
    element of each group's union prefix (``nested_compares``), at the
    card's int32 rate."""
    per_scan, union = ck.batch_prefix_elements(params, n_rows, n_cols, row0, col0)
    ops = nested_compares(np, ck, params, n_rows, n_cols, row0, col0)
    K = len(params)
    bytes_ms = 1e3 * (elem_bytes * union + 12 * K + 4 * K * n_rows) / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OPS_PER_S
    bound, by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    return bound, by, per_scan, union, ops


def random_rank(torch, np, n, seed):
    """An n x n int32 matrix of row permutations on the card."""
    rng = np.random.default_rng(seed)
    rows = rng.permuted(np.broadcast_to(np.arange(n, dtype=np.int32), (n, n)), axis=1)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(torch.device("cuda"))


def kernel_batches(np, n):
    """Phase 3's scan starts, K=8 growing batch and K=64 fixed batch."""
    starts = [0, 1, 471, 4096, 8191, 12149, n - 9, n - 1]
    growing = [[s, 0, 1] for s in starts]
    rng = np.random.default_rng(1)
    fixed = []
    for _ in range(58):
        s = int(rng.integers(0, n - 1))
        fixed.append([s, int(min(n - 1, s + rng.integers(1, 6000))), 0])
    fixed += [[9000, 8000, 0], [n - 1, 0, 0], [0, n - 1, 0], [4000, n - 1, 0],
              [n - 2, n - 1, 0], [0, 5, 0]]
    check(len(fixed) == 64, "fixed batch must hold 64 scans")
    return starts, growing, fixed


def phase_main_path(torch, workdir):
    """The full CLI pipeline on the planted 16K genome in ``workdir``;
    returns the rank-count kernel's launches, the scoring kernels' launches,
    its cut list, and the genome's HiC-Pro paths and resolution."""
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.ops import count_kernels
    from hic_genome_assembler_tpu_torch.utils import e2e

    # plots are host-side output off the device path; a 17K-bin heatmap
    # would dominate the run, so the pipeline runs as without matplotlib
    sys.modules["matplotlib"] = None
    LOG.parent.mkdir(exist_ok=True)
    t0 = time.time()
    genome, config, paths = e2e.prepare(workdir, N_CHROMS)
    fixture_s = time.time() - t0
    print(f"fixture: {genome.n_bins} bins, {len(genome.scaffolds)} scaffolds, "
          f"{N_CHROMS} chromosomes, {fixture_s:.1f} s to make and write")
    # one card even where several are visible: phases 9 and 10 compare
    # their meshes and processes with this run
    argv = ["-part1", "-part2", "-part3", "-part4", "-config", config, "-device", "cuda",
            "-mesh", "off"]
    with plain_scorers_on_cuda() as plain_calls, pair_recorder() as pair_record, \
            rank_recorder() as rank_record, score_input_recorder() as score_record:
        reset_launches()
        t0 = time.time()
        with open(LOG, "w") as log, contextlib.redirect_stdout(log):
            report = cli.main(argv)
        total_s = time.time() - t0
        launches, scoring = count_kernels.LAUNCHES, score_launches()
    truth = e2e.truth_checks(genome, os.path.join(workdir, "files"))
    summarize_rank_launches(rank_record)
    summarize_pair_launches(pair_record)
    summarize_score_inputs(score_record)
    with open(BATCHES_LOG, "w") as handle:
        json.dump([dict(rec, params=rec["params"].tolist()) for rec in rank_record], handle)
    precision = precision_line(LOG)
    echo_timers(LOG)
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in report.part_seconds.items())
    print(f"main path: {parts}; total {total_s:.1f} s")
    print(f"main path: rank counts on {report.rank_counts_on}, {launches} kernel launches")
    print(f"main path: scoring kernel launches {json.dumps(scoring)}; plain scoring versions "
          f"called on cuda tensors {sum(plain_calls.values())} times; part 2 {json.dumps(precision)}")
    check(scoring == MAIN_SCORE_LAUNCHES,
          f"the main path's scoring launches {scoring} are not {MAIN_SCORE_LAUNCHES}")
    check(not any(plain_calls.values()),
          f"a plain scoring version ran on the card: {plain_calls}")
    check(precision["violations"] == 0, f"part 2 reported precision violations: {precision}")
    print(f"truth: {json.dumps(truth)}")
    print(f"groups found {truth['groups_found']} (JAX record on its TPU: 29); orders "
          f"recovered {truth['orders_recovered']}/{truth['orders_checked']} (JAX record: 24/24)")
    check(launches > 0, "the main path launched the rank-count kernel no time")
    check(str(report.rank_counts_on).startswith("cuda"),
          f"rank matrix lay on {report.rank_counts_on}, not cuda")
    check(truth["chromosomes_covered_by_ordered_segments"] == N_CHROMS,
          f"only {truth['chromosomes_covered_by_ordered_segments']}/{N_CHROMS} planted "
          "chromosomes covered by ordered segments")
    check(truth["assembled_entries"] == truth["groups_found"] == truth["entry_lengths_ok"],
          "assembled FASTA entries or their lengths are wrong")
    check(len(rank_record) == launches, f"{len(rank_record)} recorded rank-count batches for "
                                        f"{launches} launches")
    check(len(score_record["pair_profiles"]) == scoring["pair_profiles"]
          and len(score_record["combo_score_topk"]) == scoring["combo_score_topk"],
          "the recorded profile and combo calls are not the launches counted")
    return (launches, scoring, report.cut_indices, paths, genome.resolution, rank_record,
            score_record)


@contextlib.contextmanager
def rank_recorder():
    """Records the batch of every ``counts_many`` call on a CUDA matrix
    while the block runs: {"params": int32 [K, 3], "shape": (n_rows,
    n_cols), "offsets": (row0, col0), "dtype": the matrix's element type}."""
    import numpy as np

    from hic_genome_assembler_tpu_torch.ops import count_kernels as ck

    calls = []
    original = ck.counts_many

    def recording(rank_mat, params, row0=0, col0=0):
        if rank_mat.device.type == "cuda":
            calls.append({"params": np.asarray(params, dtype=np.int32).reshape(-1, 3).copy(),
                          "shape": tuple(rank_mat.shape), "offsets": (row0, col0),
                          "dtype": str(rank_mat.dtype)})
        return original(rank_mat, params, row0, col0)

    ck.counts_many = recording
    try:
        yield calls
    finally:
        ck.counts_many = original


@contextlib.contextmanager
def pair_recorder():
    """Records every ``pair_scores`` call on a CUDA table while the block
    runs: (B, W, real ids of each row, a device tensor read afterwards)."""
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    calls = []
    original = sk.pair_scores

    def recording(F_flat, sizes, cand, c0):
        if F_flat.device.type == "cuda":
            W = cand.shape[1] // 2
            calls.append((cand.shape[0], W, (sizes[cand[:, :W].long()] > 0).sum(dim=1)))
        return original(F_flat, sizes, cand, c0)

    sk.pair_scores = recording
    try:
        yield calls
    finally:
        sk.pair_scores = original


@contextlib.contextmanager
def score_input_recorder():
    """Records the inputs of every ``pair_profiles`` and ``combo_score_topk``
    call on a CUDA tensor while the block runs, as copies on the card:
    {"pair_profiles": [(sub, sizes, cmax)], "combo_score_topk": [(F_flat,
    idx4, cid, orients, c0, k)]}."""
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    calls = {"pair_profiles": [], "combo_score_topk": []}
    originals = {name: getattr(sk, name) for name in calls}

    def recording(name):
        def wrapper(*args):
            if args[0].device.type == "cuda":
                calls[name].append(tuple(a.clone() if hasattr(a, "clone") else a for a in args))
            return originals[name](*args)
        return wrapper

    for name in calls:
        setattr(sk, name, recording(name))
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(sk, name, fn)


def summarize_score_inputs(record):
    """Prints phase 4's profile builds (Sp, C, largest scaffold, cmax) and
    combo launches (S, orders x orientations, combos, k) as histograms."""
    for name, key in (("pair_profiles", lambda a: (a[1].shape[0], a[0].shape[0],
                                                    int(a[1].max()), a[2])),
                      ("combo_score_topk", lambda a: (a[3].shape[1], f"{a[2].shape[0]}x"
                                                       f"{a[3].shape[0]}", a[1].shape[0], a[5]))):
        hist = {}
        for args in record[name]:
            hist[key(args)] = hist.get(key(args), 0) + 1
        label = "(Sp, C, largest, cmax)" if name == "pair_profiles" else "(S, Bo x R, n_combo, k)"
        print(f"main path {name}: {len(record[name])} launches; {label}: launches "
              + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items(), key=lambda kv: str(kv[0]))))


def summarize_rank_launches(record):
    """Prints phase 4's rank-count batches: growing or fixed, K, distinct
    starts, the prefix elements read once a scan and read once a batch."""
    import numpy as np

    from hic_genome_assembler_tpu_torch.ops import count_kernels as ck

    kinds = {}
    total_scan = total_union = 0
    for i, rec in enumerate(record):
        p = rec["params"]
        grow = p[:, 2] == 1
        kind = "growing" if grow.all() else ("fixed" if not grow.any() else "mixed")
        per_scan, union = ck.batch_prefix_elements(p, *rec["shape"], *rec["offsets"])
        total_scan, total_union = total_scan + per_scan, total_union + union
        distinct = len(np.unique(np.c_[grow, p[:, 0], np.where(grow, 0, p[:, 1])], axis=0))
        kinds.setdefault(kind, []).append(len(p))
        print(f"  rank_counts launch {i}: {kind} K={len(p)} ({distinct} distinct scans, "
              f"{len(np.unique(p[:, 0]))} starts) on {rec['shape']} {rec['dtype']}; prefix "
              f"elements {per_scan} a scan, {union} the union")
    print(f"main path rank_counts: {len(record)} launches "
          + ", ".join(f"{kind} {len(ks)} (K {sorted(ks)})" for kind, ks in kinds.items())
          + f"; prefix elements {total_scan} read once a scan ({4 * total_scan / 1e9:.1f} GB "
          f"int32), {total_union} read once a batch ({2 * total_union / 1e9:.2f} GB int16, "
          f"{4 * total_union / 1e9:.2f} GB int32)")


def summarize_pair_launches(calls):
    """Prints phase 4's pair-score launches as a histogram of (B, W, real
    ids a row)."""
    hist = {}
    for B, W, real in calls:
        values = sorted(set(real.cpu().tolist()))
        key = (B, W, values[0] if len(values) == 1 else f"{values[0]}-{values[-1]}")
        hist[key] = hist.get(key, 0) + 1
    print(f"main path pair_score: {len(calls)} launches; (B, W, real ids a row): launches "
          + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items(), key=lambda kv: -kv[1])))


def part2_config(workdir, main_dir, paths, resolution):
    """A config in ``workdir`` over phase 4's genome whose part 2 starts from
    phase 4's chromosome groups."""
    from hic_genome_assembler_tpu_torch.utils import e2e

    config = e2e.write_config(os.path.join(workdir, "config.txt"), workdir, paths, resolution)
    shutil.copy(os.path.join(main_dir, "files", "chromosomeGroupings.txt"),
                os.path.join(workdir, "files", "chromosomeGroupings.txt"))
    return config


def phase_part2_cpu(workdir, main_dir, paths, resolution):
    """Part 2 with ``-device cpu`` (the scoring kernels' plain versions) on
    phase 4's part-1 files: its files must be byte-equal to phase 4's."""
    from hic_genome_assembler_tpu_torch import cli

    config = part2_config(workdir, main_dir, paths, resolution)
    t0 = time.time()
    with open(SCORE_LOG, "w") as log, contextlib.redirect_stdout(log):
        cli.main(["-part2", "-config", config, "-device", "cpu", "-mesh", "off"])
    for name in PART2_FILES:
        check(filecmp.cmp(os.path.join(workdir, "files", name),
                          os.path.join(main_dir, "files", name), shallow=False),
              f"part 2 on the CPU: {name} differs from phase 4's on the card")
    print(f"part 2 with -device cpu: {time.time() - t0:.1f} s (part-2 wall "
          f"{part2_wall(SCORE_LOG):.2f} s, {json.dumps(precision_line(SCORE_LOG))}); "
          f"{' and '.join(PART2_FILES)} byte-equal to phase 4's on the card")


def phase_part2_profile(torch, workdir, main_dir, paths, resolution):
    """Part 2 on the card again, on phase 4's part-1 files, under
    torch.profiler (CUDA activity only): the device time its kernels and
    copies take against the run's wall (busy and idle shares; one stream,
    so the device intervals barely overlap), its copies by direction and
    host memory, and the kernels that take most device time.  Its files
    must equal phase 4's, and no copy may touch pageable host memory:
    every upload and readback goes through pinned memory
    (``utils/transfer``)."""
    from torch.profiler import ProfilerActivity, profile

    from hic_genome_assembler_tpu_torch import cli

    config = part2_config(workdir, main_dir, paths, resolution)
    t0 = time.time()
    with open(PROFILE_LOG, "w") as log, contextlib.redirect_stdout(log):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            cli.main(["-part2", "-config", config, "-device", "cuda", "-mesh", "off"])
            torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0)
    for name in PART2_FILES:
        check(filecmp.cmp(os.path.join(workdir, "files", name),
                          os.path.join(main_dir, "files", name), shallow=False),
              f"profiled part 2: {name} differs from phase 4's")
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    copies = {(way, mem): [0, 0.0] for way in ("HtoD", "DtoH") for mem in ("Pageable", "Pinned")}
    for e in events:
        for (way, mem), tally in copies.items():
            if way in e.key and mem in e.key:
                tally[0] += e.count
                tally[1] += e.self_device_time_total / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled part 2 on {CARD}: wall {wall_ms:.0f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.1f}%; copies "
          + ", ".join(f"{way} {mem} {n} ({ms:.1f} ms)" for (way, mem), (n, ms) in copies.items())
          + "; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top))
    check(copies["HtoD", "Pageable"][0] == 0 and copies["DtoH", "Pageable"][0] == 0,
          f"part 2 copied through pageable host memory: {copies}")
    check(copies["HtoD", "Pinned"][0] > 0 and copies["DtoH", "Pinned"][0] > 0,
          f"part 2's profile shows no pinned copy both ways: {copies}")


def phase_part1_profile(torch, workdir, paths, resolution, exact_cuts):
    """-part1 on phase 4's genome on the card under torch.profiler (CUDA
    activity only): its device busy and idle shares, and the device time of
    every rank_counts launch, its events held to the launches counted."""
    from torch.profiler import ProfilerActivity, profile

    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.ops import count_kernels
    from hic_genome_assembler_tpu_torch.utils import e2e

    config = e2e.write_config(os.path.join(workdir, "config.txt"), workdir, paths, resolution)
    reset_launches()
    t0 = time.time()
    with open(PART1_PROFILE_LOG, "w") as log, contextlib.redirect_stdout(log):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            report = cli.main(["-part1", "-config", config, "-device", "cuda", "-mesh", "off"])
            torch.cuda.synchronize()
    wall_ms = 1e3 * (time.time() - t0)
    check(report.cut_indices == exact_cuts, "profiled part 1 found other cuts than phase 4")
    events = [e for e in prof.key_averages() if e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    rank = [e for e in events if "rank_counts_" in e.key]
    n_events = sum(e.count for e in rank)
    rank_ms = sum(e.self_device_time_total for e in rank) / 1e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
    measured = n_events == count_kernels.LAUNCHES
    print(f"profiled part 1 on {CARD}: wall {wall_ms:.0f} ms (profiler on), device busy "
          f"{busy_ms:.1f} ms, idle {100 * (1 - busy_ms / wall_ms):.1f}%; rank_counts "
          + (f"{rank_ms:.3f} ms on the device over {n_events} launches" if measured else
             f"not measured ({n_events} trace events for {count_kernels.LAUNCHES} launches)")
          + "; most device time: " + "; ".join(
              f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}" for e in top))
    return rank_ms if measured else None


@contextlib.contextmanager
def parent_copies():
    """Part 2's copies as the parent commit made them, patched into
    ``utils/transfer`` for the turns of phase 4c: pageable uploads
    (``torch.from_numpy(...).to(device)``, ``dst.copy_(src)``) and readbacks
    that start nothing and take a blocking ``.cpu()`` a handle at the drain.
    Yields the count of calls of each patched function."""
    import numpy as np
    import torch

    from hic_genome_assembler_tpu_torch.utils import transfer

    calls = {"to_device": 0, "copy_into": 0, "finish_readback": 0}

    class Blocking:
        def __init__(self, handles, into):
            self.handles, self.into = list(handles), into

    def pageable_to_device(a, device, dtype=None):
        calls["to_device"] += 1
        if isinstance(a, torch.Tensor):
            t = a if dtype is None else a.to(transfer.torch_dtype(dtype))
        else:
            t = torch.from_numpy(np.require(a, dtype, ["C", "W"]))
        return t.to(device)

    def pageable_copy_into(dst, src):
        calls["copy_into"] += 1
        return dst.copy_(torch.from_numpy(src) if isinstance(src, np.ndarray) else src)

    def blocking_finish(readbacks):
        calls["finish_readback"] += 1
        return [[h.cpu().numpy() for h in r.handles] if r.into is None else
                [d.copy_(h).numpy() for d, h in zip(r.into, r.handles)] for r in readbacks]

    patched = {"to_device": pageable_to_device, "copy_into": pageable_copy_into,
               "start_readback": lambda handles, into=None: Blocking(handles, into),
               "finish_readback": blocking_finish}
    originals = {name: getattr(transfer, name) for name in patched}
    for name, fn in patched.items():
        setattr(transfer, name, fn)
    try:
        yield calls
    finally:
        for name, fn in originals.items():
            setattr(transfer, name, fn)


def part2_timer(log_path, name):
    """(seconds, calls) of part 2's ``[timer] part2/<name>`` line in a log."""
    with open(log_path) as log:
        found = re.findall(rf"^\[timer\] part2/{name}: ([0-9.]+)s over (\d+) call",
                           log.read(), flags=re.M)
    check(found, f"no part2/{name} timer in {log_path}")
    return float(found[-1][0]), int(found[-1][1])


def phase_part2_turns(torch, workdir, main_dir, paths, resolution, turns=COPY_TURNS,
                      log_path=TURNS_LOG, around=None):
    """4c: part 2 on phase 4's part-1 files once for each of ``turns``, in
    this process: "new" copies and the parent's ("old", patched in by
    ``parent_copies``).  Prints each run's part-2 wall, its
    ``scheduler_readback_wait`` and ``host_decide`` timers, and checks its
    files, which must equal phase 4's (the first run's where ``main_dir``
    holds no part-2 files).  ``around(k, mode)``, where given, makes a
    context manager entered around run ``k``'s part 2 (a profiler, in
    ``tools/part2_host_profile.py``).  Returns each run's numbers."""
    from hic_genome_assembler_tpu_torch import cli

    ref = os.path.join(main_dir, "files")
    if not all(os.path.exists(os.path.join(ref, name)) for name in PART2_FILES):
        ref = os.path.join(workdir, f"0_{turns[0]}", "files")
    runs = []
    for k, mode in enumerate(turns):
        config = part2_config(os.path.join(workdir, f"{k}_{mode}"), main_dir, paths, resolution)
        patch = parent_copies() if mode == "old" else contextlib.nullcontext(None)
        hook = contextlib.nullcontext() if around is None else around(k, mode)
        with open(log_path.format(k), "w") as log, contextlib.redirect_stdout(log), \
                patch as calls, hook:
            cli.main(["-part2", "-config", config, "-device", "cuda", "-mesh", "off"])
            torch.cuda.synchronize()
        if calls is not None:
            check(calls["to_device"] > 0 and calls["finish_readback"] > 0,
                  f"the parent's copies were not patched in: {calls}")
        same = {name: filecmp.cmp(os.path.join(workdir, f"{k}_{mode}", "files", name),
                                  os.path.join(ref, name), shallow=False)
                for name in PART2_FILES}
        wait, decide = (part2_timer(log_path.format(k), name)
                        for name in ("scheduler_readback_wait", "host_decide"))
        wall = part2_wall(log_path.format(k))
        print(f"copy turn {k + 1} ({mode} copies) on {CARD}: part-2 wall "
              f"{wall} s; scheduler_readback_wait {wait[0]} s over "
              f"{wait[1]} calls; host_decide {decide[0]} s over {decide[1]} calls; byte-equal to "
              f"phase 4's: {json.dumps(same)}"
              + (f"; parent's copies patched in: {json.dumps(calls)}" if calls else ""))
        check(all(same.values()), f"copy turn {k + 1} ({mode}): files differ from phase 4's")
        runs.append({"run": k + 1, "copies": mode, "part2_wall_s": wall,
                     "readback_wait_s": wait[0], "host_decide_s": decide[0],
                     "host_decide_calls": decide[1]})
    return runs


def phase_working_example(torch, workdir):
    """11: ``examples/working_example_torch.py --device cuda`` through its
    truth check, on a copy of the committed config whose workdir lies in
    ``workdir``: it must launch the profile, combo (S = 4) and pair-score
    kernels and run no plain scoring version on the card."""
    import importlib.util

    config = os.path.join(workdir, "config.txt")
    os.makedirs(workdir, exist_ok=True)
    with open(config, "w") as handle:
        handle.write(EXAMPLE_CONFIG.read_text().replace(EXAMPLE_WORKDIR, workdir))
    spec = importlib.util.spec_from_file_location("working_example_torch", EXAMPLE_SCRIPT)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with plain_scorers_on_cuda() as plain_calls, score_input_recorder() as record:
        reset_launches()
        t0 = time.time()
        with open(EXAMPLE_LOG, "w") as log, contextlib.redirect_stdout(log):
            example.main(["--device", "cuda", "--config", config])
        seconds = time.time() - t0
        scoring = score_launches()
    text = EXAMPLE_LOG.read_text()
    combo_s = sorted({args[3].shape[1] for args in record["combo_score_topk"]})
    print(f"working example on {CARD}: {seconds:.1f} s; scoring kernel launches "
          f"{json.dumps(scoring)}; combo S {combo_s}; "
          + "; ".join(line for line in text.splitlines()
                      if line.startswith(("chromosome groups match", "assembled entries"))))
    check("chromosome groups match planted truth: True" in text,
          "the working example failed its truth check")
    check(all(scoring[name] > 0 for name in ("pair_profiles", "combo_score_topk", "pair_score")),
          f"the working example left a scoring kernel unlaunched: {scoring}")
    check(combo_s == [EXAMPLE_S], f"the working example's combo launches ran at S {combo_s}")
    check(not any(plain_calls.values()), f"a plain scoring version ran on the card: {plain_calls}")


def phase_replay(torch, np, record):
    """4b: every rank-count batch phase 4 launched, in order, on phase 3's
    random 17,162-bin matrix padded as RankCounts pads it (the bytes depend
    on the batches, not the values), in the element type RankCounts chooses
    and in int32: each output held to the plain version, then each batch
    timed on the device (``queued_ms``: CUDA events with the host ahead) with
    L2 flushed before each launch, as the main path meets the matrix cold.
    Returns the replay's record."""
    from hic_genome_assembler_tpu_torch.ops import count_kernels as ck
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda")
    n = N_RANK
    t = pm.pad_to_multiple(n, 32)
    dtype = ck.rank_dtype(t)
    full = random_rank(torch, np, n, 0)
    mats = {}
    for dt in dict.fromkeys([dtype, torch.int32]):
        mats[dt] = torch.full((t, t), -1, dtype=dt, device=dev)
        mats[dt][:n, :n] = full
    del full
    check(all(rec["shape"] == (t, t) and rec["offsets"] == (0, 0) for rec in record),
          f"phase 4's batches were not launched on one {t}x{t} block")
    max_err = 0
    for rec in record:
        want = ck.counts_many_plain(mats[dtype], rec["params"])
        for dt, mat in mats.items():
            err = int((ck.counts_many(mat, rec["params"]).long() - want.long()).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"replay {dt} K={len(rec['params'])}: kernel differs from plain")
    print(f"replay: {len(record)} batches of phase 4 == plain in {[str(d) for d in mats]} "
          f"on {tuple(mats[dtype].shape)} (max abs err {max_err})")
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device=dev)
    largest = max(range(len(record)), key=lambda i: len(record[i]["params"]))
    out = {"batches": len(record), "max_abs_err": max_err,
           "largest_K": len(record[largest]["params"])}
    for dt, mat in mats.items():
        per = [[queued_ms(torch, lambda: ck.counts_many(mat, rec["params"]), 1, flush.zero_)
                for _ in range(REPLAY_REPS)] for rec in record]
        bounds = [rank_bound(np, ck, rec["params"], t, t, mat.element_size()) for rec in record]
        bound_ms = sum(b[0] for b in bounds)
        scan_gb = mat.element_size() * sum(b[2] for b in bounds) / 1e9
        union_gb = mat.element_size() * sum(b[3] for b in bounds) / 1e9
        by = "/".join(sorted({b[1] for b in bounds}))
        if any(None in times for times in per):
            print(f"replay {dt} on {CARD}: device times not measured (a launch reached the "
                  f"card before the host was ahead); bound {bound_ms:.4f} ms")
            out[str(dt)] = {"device_ms": None, "bound_ms": bound_ms, "bound_by": by}
            continue
        per = [sum(times) / REPLAY_REPS for times in per]
        total = sum(per)
        print(f"replay {dt} on {CARD}: {len(record)} batches {total:.4f} ms on the device "
              f"(CUDA events, mean of {REPLAY_REPS}, L2 flushed, the plan's upload included), "
              f"the K={out['largest_K']} batch {per[largest]:.4f} ms; read-once bound "
              f"{bound_ms:.4f} ms ({by}: union {union_gb:.3f} GB), {100 * bound_ms / total:.1f}% "
              f"of it; a kernel that reads each scan's own prefix streams {scan_gb:.1f} GB")
        print("  per batch (K, device ms, bound ms): " + ", ".join(
            f"({len(rec['params'])}, {ms:.4f}, {b[0]:.4f})"
            for rec, ms, b in zip(record, per, bounds)))
        out[str(dt)] = {"device_ms": total, "largest_ms": per[largest], "bound_ms": bound_ms,
                        "bound_by": by}
    print(f"replay with the previous kernel ({OLD_REPLAY['from']}): "
          f"{OLD_REPLAY['batches_ms']} ms for the batches, {OLD_REPLAY['largest_ms']} ms for "
          f"the K={out['largest_K']} batch")
    del mats, flush
    torch.cuda.empty_cache()
    return out


def hmm_inputs(torch, np, T, seed, kind="random"):
    """log_b [T, 2], log_start [2], log_trans [2, 2] on the card.  ``kind``:
    "random" (normal log-densities), "neg_inf" (a zero transmat entry),
    "ties" (constant rows of small integers, equal transitions: every step
    ties) or "int" (small integers per state: frequent ties; every sum is
    exact, so any association gives the same scores)."""
    rng = np.random.default_rng(seed)
    if kind in ("ties", "int"):
        cols = 1 if kind == "ties" else 2
        log_b = np.repeat(rng.integers(-3, 1, (T, cols)).astype(np.float64), 3 - cols, axis=1)
        trans = [[-1.0, -1.0], [-1.0, -1.0]] if kind == "ties" else [[-1.0, -2.0], [-2.0, -1.0]]
        host = (log_b, np.array([-1.0, -1.0]), np.array(trans))
    else:
        log_b = rng.normal(0.0, 3.0, (T, 2))
        trans = np.array([[1.0, 0.0], [0.3, 0.7]]) if kind == "neg_inf" else np.array(
            [[0.9, 0.1], [1e-4, 0.9999]])
        with np.errstate(divide="ignore"):
            host = (log_b, np.log([0.5, 0.5]), np.log(trans))
    return [torch.from_numpy(np.ascontiguousarray(a)).to(torch.device("cuda")) for a in host]


def hmm_bound_ms(name, T):
    """The least time of one call at T frames and what sets it ("bytes" or
    "operations"), the larger of two: each input byte read once and each
    output byte written once over HBM's rate, and its f64 operations over
    the f64 rate.  Operations: each add, max and compare counted once, and
    each exp and log too, though the card computes them as sequences of
    several FMAs (so the operations' time is a floor): forward 22, backward
    22, gamma 18 and xi 32 a frame; Viterbi 8."""
    if name == "hmm_forward_backward":
        nbytes, ops = 16 * T + 48 + 16 * T + 40, 94 * T
    else:
        nbytes, ops = 16 * T + 48 + 4 * T, 8 * T
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP64_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_hmm_kernels(torch, np):
    """Both chunked-scan HMM kernels timed, then held against their plain
    loops, which are timed last; returns their kernel records."""
    from hic_genome_assembler_tpu_torch.ops import hmm_kernels as hk

    # timed before any plain loop runs: after a plain loop's many small
    # launches the host is slower for a while, and Viterbi at T = 3,715
    # (~20 us) is close to the wrapper's own host time per call
    times = {}
    calls = (("hmm_forward_backward", hk.forward_backward, hk.forward_backward_plain),
             ("hmm_viterbi", hk.viterbi, hk.viterbi_plain))
    timed_args = {T: hmm_inputs(torch, np, T, T) for T in HMM_TIMED_T}
    for T, args in timed_args.items():
        for name, fn, _plain in calls:
            times[(name, T)] = [cuda_ms(torch, lambda: fn(*args), 200),
                                device_ms(torch, lambda: fn(*args), name[4:] + "_kernel",
                                          lambda: hk.LAUNCHES[name]),
                                queued_ms(torch, lambda: fn(*args))]
    worst = {"logprob_rel": 0.0, "gamma_abs": 0.0, "xi_rel": 0.0, "max_abs": 0.0}
    flips = 0
    cases = [(T, "random") for T in HMM_T] + list(HMM_EXTRA)
    for T, kind in cases:
        args = hmm_inputs(torch, np, T, T, kind)
        got = hk.forward_backward(*args)
        path = hk.viterbi(*args)
        torch.cuda.synchronize()
        errors, ok = hk.forward_backward_errors(got, hk.forward_backward_plain(*args))
        for key, value in errors.items():
            worst[key] = max(worst[key], value)
        check(ok, f"T={T} {kind}: forward-backward differs from the plain loops beyond the "
                  f"bounds (log-likelihood rtol {hk.logprob_rtol(T):.3g}): {errors}")
        mismatched = int((path != hk.viterbi_plain(*args)).sum().item())
        flips = max(flips, mismatched)
        check(mismatched == 0, f"T={T} {kind}: Viterbi path differs from the plain loop at "
                               f"{mismatched} frames")
        print(f"HMM kernels within bounds of plain: T={T} {kind}, logprob {got[0].item():.6f}, "
              f"errors {json.dumps({k: float(f'{v:.3g}') for k, v in errors.items()})}, "
              f"paths equal")
    print(f"HMM kernels: largest differences from the plain loops over {len(cases)} cases: "
          f"{json.dumps(worst)}; Viterbi paths identical everywhere")
    for T, args in timed_args.items():
        for name, _fn, plain in calls:
            (ms, dev_ms, queued), (bound, bound_by) = times[(name, T)], hmm_bound_ms(name, T)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 1)
            times[(name, T)] += [plain_ms, bound, bound_by]
            on_device, in_queue = ("not measured" if x is None else (
                f"{x:.4f} ms, {100 * bound / x:.4f}% of the bound") for x in (dev_ms, queued))
            print(f"{name} T={T}: kernel {ms:.4f} ms a call ({1e6 * ms / T:.1f} ns per frame), "
                  f"on the device {on_device} (profiler), {in_queue} with launches queued (CUDA "
                  f"events); plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({bound_by})")
    records = []
    for name in ("hmm_forward_backward", "hmm_viterbi"):
        (ms, dev, queued, plain_ms, bound, bound_by), (ms2, dev2, queued2, plain2, bound2,
                                                       bound_by2) = (
            times[(name, T)] for T in HMM_TIMED_T)
        records.append({
            "name": name, "route": "cuda", "source": HMM_SOURCE, "replaces": HMM_REPLACES[name],
            "max_abs_err": flips if name == "hmm_viterbi" else worst["max_abs"],
            "max_err": {"paths_differ_frames": flips} if name == "hmm_viterbi" else worst,
            "T": HMM_TIMED_T[0], "ms": ms, "device_ms": dev, "queued_ms": queued,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "at_T_17162": {"ms": ms2, "device_ms": dev2, "queued_ms": queued2, "plain_ms": plain2,
                           "bound_ms": bound2, "bound_by": bound_by2},
        })
    return records


def phase_hmm_path(torch, workdir):
    """The CLI with hmm = True on the 3,715-bin HMM genome, held to the JAX
    package's golden record; returns the HMM kernels' launches."""
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.ops import hmm_kernels
    from hic_genome_assembler_tpu_torch.utils import e2e

    with open(e2e.HMM_GOLDEN) as handle:
        golden = json.load(handle)
    t0 = time.time()
    genome, config, paths = e2e.prepare(
        workdir, genome=e2e.make_hmm_genome(HMM_GENOME_N), settings=e2e.HMM_SETTINGS)
    print(f"HMM fixture: {genome.n_bins} bins, {len(genome.scaffolds)} scaffolds, "
          f"{time.time() - t0:.1f} s to make and write")
    check(sha256(paths["matrix"]) == golden["matrix_sha256"],
          "the HMM genome's matrix file differs from the one the golden record was made from")
    argv = ["-part1", "-part2", "-part3", "-part4", "-config", config, "-device", "cuda"]
    reset_launches()
    t0 = time.time()
    with open(HMM_LOG, "w") as log, contextlib.redirect_stdout(log):
        report = cli.main(argv)
    total_s = time.time() - t0
    launches = dict(hmm_kernels.LAUNCHES)
    fits, iters = (log_counter(HMM_LOG, name) for name in ("hmm_fits", "hmm_em_iterations"))
    truth = e2e.truth_checks(genome, os.path.join(workdir, "files"))
    echo_timers(HMM_LOG)
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in report.part_seconds.items())
    print(f"HMM path: {parts}; total {total_s:.1f} s; {fits} EM fits, {iters} EM iterations; "
          f"launches {json.dumps(launches)}")
    print(f"HMM path: cuts {report.cut_indices}")
    print(f"HMM truth: {json.dumps(truth)}")
    check(all(n > 0 for n in launches.values()),
          f"the HMM path left a kernel unlaunched: {launches}")
    check(report.cut_indices == golden["cut_indices"],
          f"HMM cut list {report.cut_indices} differs from the JAX golden "
          f"{golden['cut_indices']}")
    for name, want in golden["files_sha256"].items():
        check(sha256(os.path.join(workdir, "files", name)) == want,
              f"{name} differs from the JAX golden record")
    check(truth["assembled_entries"] == truth["groups_found"] == truth["entry_lengths_ok"] > 0,
          "assembled FASTA entries or their lengths are wrong on the HMM path")
    return launches


def score_bound_ms(nbytes, ops):
    """The least time of one call and what sets it: its bytes over HBM's
    rate, or its f32 adds and compares over the f32 rate."""
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def phase_score_kernels(torch, np, device="cuda"):
    """The four scoring kernels against their plain versions on the card, at
    the main path's shapes and bench.py's combo shape: integer-valued inputs
    exactly (every f32 sum exact, frequent ties), seeded float inputs within
    ``sum_bound`` (a group's argmax equal where its top two differ by more
    than twice the bound), two launches bit-identical; then each timed with
    CUDA events beside its plain version and its bound.  Returns the kernel
    records, keyed by name.  (``device="cpu"`` rehearses the phase's own
    code with the plain versions on both sides.)"""
    from hic_genome_assembler_tpu_torch.ops import cost, perms
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    dev = torch.device(device)
    rng = np.random.default_rng(5)
    worst = dict.fromkeys(SCORE_REPLACES, 0.0)
    n_cases = dict.fromkeys(SCORE_REPLACES, 0)

    def up(a, dtype):
        return torch.from_numpy(np.require(a, dtype, ["C", "W"])).to(dev)

    def table(Sp, Cp1, kind, sizes_np=None):
        """A random table; with ``sizes_np``, the rows of size-0 (pad)
        ids are zero, as in every table built from pair profiles."""
        shape = (Sp, Sp, 4, Cp1)
        vals = rng.integers(0, 16, shape) if kind == "int" else rng.random(shape)
        if sizes_np is not None:
            vals[(sizes_np[:, None] == 0) | (sizes_np[None, :] == 0)] = 0
        return up(vals.reshape(-1), np.float32)

    def scalar(kind):
        return up(np.float32(7.0 if kind == "int" else 5 * rng.random()), np.float32).reshape(())

    def widen(args):
        return [a.double() if a.dtype == torch.float32 else a for a in args]

    def held(name, label, kind, fn, plain, args, n_terms, extra=()):
        """Kernel ``fn`` against ``plain`` on ``args`` (+ ``extra`` ints);
        returns the kernel's output."""
        got, again = fn(*args, *extra), fn(*args, *extra)
        want = plain(*args, *extra)
        torch.cuda.synchronize()
        pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
        check(all(torch.equal(a, b) for a, b in pairs), f"{name} {label}: two launches differ")
        if isinstance(got, tuple):
            vals, idx, second = got
            wvals, widx, wsecond = want
            # a group's bound is its largest score's (the terms are non-negative)
            flat = fn_scores[name](*widen(args)).reshape(-1)
            k = vals.shape[0]
            flat = torch.cat([flat, flat.new_zeros((-flat.shape[0]) % k)]).reshape(k, -1)
            bound = torch.from_numpy(sk.sum_bound(n_terms, flat.max(dim=1).values.cpu().numpy())
                                     ).to(dev)
            if kind == "int":
                check(torch.equal(vals, wvals) and torch.equal(idx, widx)
                      and torch.equal(second, wsecond),
                      f"{name} {label}: top-k differs from the plain version on integer input")
                err = 0.0
            else:
                # equal values first: -inf in groups of padding alone
                dv, ds = (torch.where(x == y, 0.0, (x.double() - y.double()).abs())
                          for x, y in ((vals, wvals), (second, wsecond)))
                err = float(torch.maximum(dv, ds).max())
                clear = (wvals.double() - wsecond.double()) > 2 * bound
                check(bool((dv <= bound).all() and (ds <= bound).all()),
                      f"{name} {label}: top-k values beyond the bound (max {err:.3g})")
                check(torch.equal(idx[clear], widx[clear]),
                      f"{name} {label}: an argmax differs where the top two are apart")
        else:
            if kind == "int":
                check(torch.equal(got, want), f"{name} {label}: differs from the plain version "
                                              "on integer input")
                err = 0.0
            else:
                exact = plain(*widen(args), *extra)
                bound = torch.from_numpy(sk.sum_bound(n_terms, exact.abs().cpu().numpy())).to(dev)
                diff = (got.double() - want.double()).abs()
                err = float(diff.max())
                check(bool(torch.isfinite(got).all()), f"{name} {label}: non-finite output")
                check(bool((diff <= bound).all()),
                      f"{name} {label}: beyond sum_bound (max abs err {err:.3g})")
        worst[name] = max(worst[name], err)
        n_cases[name] += 1
        print(f"kernel == plain: {name} {label}, {kind} input (max abs err {err:.3g}), "
              "two launches bit-identical")
        return got

    fn_scores = {"combo_score_topk": sk.combo_scores_plain, "block_score": sk.block_scores_plain}

    def distinct(flat_idx):
        """How many distinct table values a launch gathers (the bound reads
        each once), from its flat int64 indices."""
        return int(torch.unique(flat_idx).numel())

    def table_indices(sizes, orders, orients, pi, pj, Cp1, rows=2048):
        """The flat table indices of the pairs (pi, pj) of each row of
        ``orders`` / ``orients`` (int64 [B, W], one orientation row for
        each order), as the plain versions form them, less the pairs with a
        pad id (size 0), which the kernels skip; in batches of ``rows``."""
        Sp, found = sizes.shape[0], []
        for r0 in range(0, orders.shape[0], rows):
            o, f = orders[r0:r0 + rows], orients[r0:r0 + rows]
            sz = sizes[o]
            offs = torch.cumsum(sz, dim=1) - sz
            idx = ((o[:, pi] * Sp + o[:, pj]) * 4 + f[:, pi] * 2 + f[:, pj]) * Cp1 \
                + offs[:, pj] - offs[:, pi]
            found.append(torch.unique(idx[(sz[:, pi] > 0) & (sz[:, pj] > 0)]))
        return torch.cat(found)
    sizes_np = np.zeros(SCORE_SP, dtype=np.int64)
    sizes_np[: SCORE_SP - 1] = rng.integers(1, 25, SCORE_SP - 1)
    check(sizes_np.sum() <= SCORE_CP1 - 1, "scoring fixture sizes overrun the table")
    sizes = up(sizes_np, np.int64)
    pad = SCORE_SP - 1
    timing, library = {}, {}

    # -- pair scores: greedy (B = 112, K + 1 real ids then pads), sliding
    # window (B = 30,720: random rows of every id, and rows shaped as the
    # window builds them), and pads scattered inside rows
    def cand(B, n_real, shape):
        ids = np.full((B, SCORE_W), pad, dtype=np.int32)
        flags = rng.integers(0, 2, (B, SCORE_W)).astype(np.int32)
        if shape == "window":
            # part2_order._scan_coro's _window_candidates: a base order of
            # the real ids, 16 window positions x (60 orders x 32 orientations
            # of its 5 slots), the rest of each row the base's
            w = 5
            orders_w, orients_w = perms.order_batch(w), perms.orient_batch(w)
            B_w = len(orders_w) * len(orients_w)
            check(B == 16 * B_w, f"a window batch holds 16 x {B_w} rows, not {B}")
            idx_w = np.repeat(np.asarray(orders_w, dtype=np.int64), len(orients_w), axis=0)
            orient_blk = np.tile(np.asarray(orients_w, dtype=np.int32), (len(orders_w), 1))
            base_o, base_f = ids[0].copy(), flags[0].copy()
            base_o[:n_real] = rng.permutation(SCORE_SP - 1)[:n_real]
            ids[:], flags[:] = base_o, base_f
            for k in range(16):
                blk = slice(k * B_w, (k + 1) * B_w)
                ids[blk, k:k + w] = base_o[k + idx_w]
                flags[blk, k:k + w] = orient_blk
            return up(np.concatenate([ids, flags], axis=1), np.int32)
        for b in range(B):
            row = rng.permutation(SCORE_SP - 1)[:n_real]
            if shape == "scatter":
                ids[b, np.sort(rng.choice(SCORE_W, n_real, replace=False))] = row
            else:
                ids[b, :n_real] = row
        return up(np.concatenate([ids, flags], axis=1), np.int32)

    n_pair = SCORE_W * (SCORE_W - 1) // 2 + 1
    pair_cases = {label: cand(B, n_real, shape)
                  for label, B, n_real, shape in SCORE_SHAPES["pair"]}
    for kind in ("int", "float"):
        F, c0 = table(SCORE_SP, SCORE_CP1, kind, sizes_np), scalar(kind)
        for label, cands in pair_cases.items():
            held("pair_score", label, kind, sk.pair_scores, sk.pair_scores_plain,
                 [F, sizes, cands, c0], n_pair)
    for label, B, _n, shape in SCORE_SHAPES["pair"]:
        if shape == "scatter":
            continue
        cands = pair_cases[label]
        args = (F, sizes, cands, c0)
        # the distinct table values the batch gathers (pad pairs skipped): a
        # small batch needs a few of the table's rows, a large one not every
        # column either
        n_real = (cands[:, :SCORE_W] != pad).sum(dim=1).double()
        gathers = int((n_real * (n_real - 1) / 2).sum())
        pi, pj = (torch.from_numpy(a).to(dev) for a in np.triu_indices(SCORE_W, k=1))
        table_bytes = 4 * distinct(table_indices(
            sizes, cands[:, :SCORE_W].long(), cands[:, SCORE_W:].long(), pi, pj, SCORE_CP1))
        nbytes = cands.numel() * 4 + table_bytes + sizes.numel() * 8 + 4 + B * 4
        timing[("pair_score", label)] = (
            cuda_ms(torch, lambda: sk.pair_scores(*args), 50),
            device_ms(torch, lambda: sk.pair_scores(*args), "pair_score_",
                      lambda: sk.LAUNCHES["pair_score"]),
            queued_ms(torch, lambda: sk.pair_scores(*args)),
            cuda_ms(torch, lambda: sk.pair_scores_plain(*args), 10),
            *score_bound_ms(nbytes, gathers + B),
            f"{gathers} gathers; table term {table_bytes / 1e6:.2f} MB of "
            f"{4 * F.numel() / 1e6:.1f}")
    del F, pair_cases

    # -- combo top-k: the main path's S = 6 (360 x 64 candidates, k = 64) on
    # the pair table, and bench.py's S = 8 (20,160 x 256) on a C = 2048 table
    for S, Sp, Cp1 in SCORE_SHAPES["combo"]:
        combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
        label = f"S={S} {combo['cid'].shape[0]}x{2 ** S}"
        cid = up(combo["cid"], np.int32)
        orients = up(perms.orient_batch(S), np.int32)
        P = S * (S - 1) // 2
        for kind in ("int", "float"):
            F, c0 = table(Sp, Cp1, kind), scalar(kind)
            idx4 = up(rng.integers(0, F.numel(), (combo["n_combo"], 4)), np.int64)
            args = [F, idx4, cid, orients, c0]
            held("combo_score_topk", label, kind, sk.combo_score_topk, sk.combo_score_topk_plain,
                 args, P + 1, extra=(64,))
            # the parent's mesh form: scores of a padded batch, then the group epilogue
            pad_cid = torch.cat([cid, cid[-1:].expand(3, -1)]).contiguous()
            scores = held("combo_score_topk", label + " scores, 3 pad rows", kind,
                          sk.combo_scores, sk.combo_scores_plain,
                          [F, idx4, pad_cid, orients, c0], P + 1)
            for k in (64, 7):
                got, want = sk.group_argmax(scores.reshape(-1), k), sk._group_argmax(
                    scores.reshape(-1), k)
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"group_argmax k={k} on {label} scores differs from the plain version")
            print(f"kernel == plain: group_argmax k=64 and k=7 (ragged) on {label} scores")
        N = cid.shape[0] * orients.shape[0]
        nbytes = idx4.numel() * 8 + 4 * distinct(idx4) + cid.numel() * 4 \
            + orients.numel() * 4 + 4 + 64 * 16
        timing[("combo_score_topk", label)] = (
            cuda_ms(torch, lambda: sk.combo_score_topk(*args, 64), 50),
            device_ms(torch, lambda: sk.combo_score_topk(*args, 64),
                      ("combo_kernel", "topk_merge"),
                      lambda: sk.LAUNCHES["combo_score_topk"]),
            queued_ms(torch, lambda: sk.combo_score_topk(*args, 64)),
            cuda_ms(torch, lambda: sk.combo_score_topk_plain(*args, 64), 10),
            *score_bound_ms(nbytes, N * (P + 2)), f"{N} candidates")
    del F

    # -- block scores, the grid form: the escalation's chunk (2,048 orders x
    # 256 at S = 8: its path, timed first), the whole escalation (20,160 x
    # 256) in one launch, the main path's S = 6, repeated ids, and R not a
    # multiple of 4 or 32; the top-k form: a one-scaffold chromosome (1 x 2,
    # k = 2: part 2's only caller of it, timed first), and 20,160 orders at
    # S = 9 with every orientation (timed) and with 64 random rows, shapes
    # no caller reaches (nScaffolds is at most 8, and an order of distinct
    # ids at S >= 2 takes the combo path)
    ids9 = rng.permutation(SCORE_SP - 1)[:9]

    def block_case(S, Bo, rows):
        label = f"S={S} {Bo}x{2 ** S}" if rows == "all" else f"S={S} {Bo}x{rows} random rows"
        orients_np = perms.orient_batch(S) if rows == "all" else rng.integers(0, 2, (rows, S))
        return label, (ids9[:S][perms.order_batch(S)[:Bo]], orients_np)

    grid_cases = dict(block_case(*c) for c in SCORE_SHAPES["block"])
    grid_cases["S=5 repeated ids 300x32"] = (rng.integers(0, 20, (300, 5)), perms.orient_batch(5))
    topk_cases = {label + " top-k": case
                  for label, case in (block_case(*c) for c in SCORE_SHAPES["block_topk"])}
    timed = list(grid_cases)[:2] + list(topk_cases)[:2]

    def topk_k(args):
        """The top-k form's groups as the non-combo path asks for them."""
        return min(64, args[2].shape[0] * args[3].shape[0])

    block_inputs = {}
    for kind in ("int", "float"):
        F, c0 = table(SCORE_SP, SCORE_CP1, kind, sizes_np), scalar(kind)
        for label, (orders_np, orients_np) in {**grid_cases, **topk_cases}.items():
            S = orders_np.shape[1]
            args = [F, sizes, up(orders_np, np.int32), up(orients_np, np.int32), c0]
            if label in topk_cases:
                held("block_score", label, kind, sk.block_score_topk, sk.block_score_topk_plain,
                     args, S * (S - 1) // 2 + 1, extra=(topk_k(args),))
            else:
                held("block_score", label, kind, sk.block_scores, sk.block_scores_plain, args,
                     S * (S - 1) // 2 + 1)
            if label in timed:
                block_inputs[label] = args
    for label in timed:
        args = block_inputs[label]
        orders, orients = args[2], args[3]
        (Bo, S), R = orders.shape, orients.shape[0]
        topk = label in topk_cases
        # each order gathers the four orientations' values of each of its pairs
        pi, pj = (torch.from_numpy(a).to(dev) for a in np.triu_indices(S, k=1))
        base = table_indices(sizes, orders.long(), torch.zeros_like(orders.long()), pi, pj,
                             SCORE_CP1)
        gathered = base[:, None] + SCORE_CP1 * torch.arange(4, device=dev)[None, :]
        k = topk_k(args)
        nbytes = Bo * S * 4 + R * S * 4 + SCORE_SP * 8 + 4 * distinct(gathered) + 4 \
            + (k * 20 if topk else Bo * R * 4)
        per_order, per_cand = sk.block_adds(S, R)
        ops = Bo * per_order + Bo * R * (per_cand + topk)
        if topk:
            fn = lambda: sk.block_score_topk(*args, k)  # noqa: E731
            plain = lambda: sk.block_score_topk_plain(*args, k)  # noqa: E731
        else:
            fn = lambda: sk.block_scores(*args)  # noqa: E731
            plain = lambda: sk.block_scores_plain(*args)  # noqa: E731
        form = "halves" if sk.block_halves(S, R) else "direct sums"
        timing[("block_score", label)] = (
            cuda_ms(torch, fn, 50),
            device_ms(torch, fn, ("block_kernel", "topk_merge"),
                      lambda: sk.LAUNCHES["block_score"]),
            queued_ms(torch, fn), cuda_ms(torch, plain, 10), *score_bound_ms(nbytes, ops),
            f"{Bo * R} candidates, {form}; {Bo * R * (S * (S - 1) // 2 + 1)} adds summed directly")
        if topk:
            two = queued_ms(torch, lambda: sk.group_argmax(sk.block_scores(*args).reshape(-1), k))
            print(f"block_score {label} on {CARD}: the two-launch form (block_scores, then "
                  f"group_argmax) {two} ms on the device with launches queued")
        else:
            # the JAX function's formulation in two PyTorch calls, its indices
            # and one-hot selector built beforehand: a gather, then addmm
            idx = sk._block_indices(sizes, orders.long(), pi, pj, SCORE_CP1)
            E = sk._orient_selector(orients.long(), pi, pj, torch.float32)
            F, c0 = args[0], args[4]
            library[("block_score", label)] = cuda_ms(
                torch, lambda: torch.addmm(c0, F[idx].reshape(Bo, -1), E), 20)
    old = OLD_BLOCK
    print(f"block_score with the previous kernel ({old['from']}): " + ", ".join(
        f"{label} {ms} ms on the device" for label, ms in old.items() if label != "from"))
    del F, block_inputs, args

    # -- pair profiles at cmax 128 and 384 (Sp = 56), both plain builds
    for top, cmax in SCORE_SHAPES["profiles"]:
        label = f"cmax={cmax}"
        p_sizes = np.zeros(SCORE_SP, dtype=np.int64)
        p_sizes[: SCORE_SP - 1] = [top] + list(rng.integers(1, 1 + top // 20, SCORE_SP - 2))
        C = int(p_sizes.sum())
        sz = up(p_sizes, np.int64)
        for kind in ("int", "float"):
            m = rng.integers(0, 8, (C, C)) if kind == "int" else rng.random((C, C))
            M = up(m, np.float32)
            for chunk, build in ((None, "skew"), (1, "scatter")):
                if build == "scatter" and kind == "float":
                    continue  # the scatter build adds with atomics: integers only
                held("pair_profiles", f"{label} C={C} vs the {build} build", kind,
                     sk.pair_profiles,
                     lambda *a, chunk=chunk: sk.pair_profiles_plain(*a, chunk_elems=chunk),
                     [M, sz], cmax, extra=(cmax,))
        L = 2 * cmax - 1
        # the kernel reads the off-diagonal blocks of M (s = t rows are zero)
        # and writes every row of h
        off_diagonal = C * C - int((p_sizes ** 2).sum())
        nbytes = off_diagonal * 4 + SCORE_SP * 8 + 4 * SCORE_SP ** 2 * L * 4
        ops = 2 * off_diagonal
        timing[("pair_profiles", label)] = (
            cuda_ms(torch, lambda: sk.pair_profiles(M, sz, cmax), 50),
            device_ms(torch, lambda: sk.pair_profiles(M, sz, cmax),
                      "pair_profiles_kernel", lambda: sk.LAUNCHES["pair_profiles"]),
            queued_ms(torch, lambda: sk.pair_profiles(M, sz, cmax)),
            cuda_ms(torch, lambda: sk.pair_profiles_plain(M, sz, cmax), 10),
            *score_bound_ms(nbytes, ops), f"C={C}")
        if cmax == SCORE_SHAPES["profiles"][-1][1]:
            h = sk.pair_profiles(M, sz, cmax)
            Wm = up(rng.random((L, SCORE_CP1)), np.float32)
            matmul_ms = cuda_ms(torch, lambda: torch.matmul(h, Wm), 50)
            print(f"table F = h @ Wm, [{h.shape[0]}, {L}] @ [{L}, {SCORE_CP1}] (the 16K run's "
                  f"most frequent shape): torch.matmul {matmul_ms:.4f} ms on {CARD}")
            del h, Wm
    del M

    # -- group_topk alone (topk_tiles, then topk_merge where a group spans
    # tiles): the mesh path's gathered combo scores (23,040 at k = 64), and
    # one tile of 64 scores (k = 1), the launch's floor
    group_topk = {}
    for N, k in ((23040, 64), (64, 1)):
        label = f"N={N} k={k}"
        x = up(rng.integers(0, 2**20, N), np.float32)
        got, want = sk.group_argmax(x, k), sk._group_argmax(x, k)
        check(all(torch.equal(a, b) for a, b in zip(got, want)),
              f"group_argmax {label} differs from the plain version")
        bound, bound_by = score_bound_ms(N * 4 + k * 20, N)
        fn = lambda: sk.group_argmax(x, k)  # noqa: E731
        group_topk[label] = {"ms": cuda_ms(torch, fn, 50), "queued_ms": queued_ms(torch, fn),
                             "plain_ms": cuda_ms(torch, lambda: sk._group_argmax(x, k), 10),
                             "bound_ms": bound, "bound_by": bound_by}
        print(f"group_topk {label} on {CARD}: == plain; {group_topk[label]['ms']:.4f} ms a call, "
              f"{group_topk[label]['queued_ms']} ms on the device with launches queued, plain "
              f"{group_topk[label]['plain_ms']:.4f} ms, bound {bound:.6f} ms ({bound_by})")
    del x

    records = {}
    for (name, label), (ms, dev_ms, queued, plain_ms, bound, bound_by, note) in timing.items():
        on_device = "not measured" if dev_ms is None else (
            f"{dev_ms:.4f} ms ({100 * bound / dev_ms:.1f}% of the bound)")
        in_queue = "not measured" if queued is None else (
            f"{queued:.4f} ms ({100 * bound / queued:.1f}% of the bound)")
        print(f"{name} {label} on {CARD}: kernel {ms:.4f} ms a call, {on_device} on the device "
              f"(profiler), {in_queue} on the device with launches queued (CUDA events), "
              f"plain {plain_ms:.4f} ms, bound {bound:.6f} ms ({bound_by}; {note}), "
              f"{100 * bound / ms:.2f}% of it a call")
        if (name, label) in library:
            print(f"  {name} {label}: the JAX function's formulation in PyTorch, two calls (a "
                  f"gather, then addmm), {library[name, label]:.4f} ms a call")
        old = OLD_PAIR.get(label) if name == "pair_score" else None
        if old:
            print(f"  {name} {label} with the previous kernel ({OLD_PAIR['from']}): "
                  f"{old['queued_ms']} ms on the device with launches queued, {old['ms']} ms "
                  "a call")
        old = {"pair_profiles": OLD_PROFILES, "combo_score_topk": OLD_COMBO}.get(name, {})
        if label in old:
            print(f"  {name} {label} with the previous kernel ({old['from']}): {old[label]} ms "
                  "on the device with launches queued")
        rec = records.setdefault(name, {
            "name": name, "route": "cuda", "source": SCORE_SOURCE,
            "replaces": SCORE_REPLACES[name], "max_abs_err": worst[name], "cases": n_cases[name],
            "library_ms": None})
        entry = {"ms": ms, "device_ms": dev_ms, "queued_ms": queued, "plain_ms": plain_ms,
                 "bound_ms": bound, "bound_by": bound_by,
                 "library_ms": library.get((name, label))}
        if "ms" not in rec:  # the first timed shape is the main path's
            rec.update(entry, shape=label)
        else:
            rec[f"at {label}"] = entry
    records["pair_profiles"]["table_matmul_ms"] = matmul_ms
    records["combo_score_topk"]["group_topk"] = group_topk
    records["topk_fold"] = mesh_epilogue(torch, np, device)
    for run in range(TOPK_SWEEP_RUNS):
        cases = topk_sweep(torch, np, device)
        print(f"top-k sweep {run + 1}/{TOPK_SWEEP_RUNS}: {cases} cases of combo_score_topk and "
              f"group_argmax == plain (1, 2, 3 and 20+ tiles of {sk.TOPK_TILE}, ragged groups, "
              "integer ties)")
    records["combo_score_topk"]["topk_sweep_cases"] = cases * TOPK_SWEEP_RUNS
    records["pair_profiles"]["library_calls"] = library_bounds(torch, np, device)
    torch.cuda.empty_cache()
    return records


# the mesh epilogue's shapes: the 16K run's S = 6 chromosome (360 orders x 64
# orientations, scaffold sizes as phase 5b's table draws them) and bench.py's
# build_problem at S = 8 (20,160 x 256, C = 2,048)
MESH_EPILOGUE_SIZES = {6: None, 8: (512, 384, 320, 256, 224, 160, 128, 64)}
MESH_EPILOGUE_K = 64
MESH_EPILOGUE_TURNS = ("parent", "new", "new", "parent")


def epilogue_problem(np, S, rng):
    """A chromosome of S scaffolds: bench.py's build_problem matrix (a
    distance decay plus noise) over MESH_EPILOGUE_SIZES[S], or sizes drawn
    as phase 5b's table draws them."""
    sizes = MESH_EPILOGUE_SIZES[S]
    sizes = list(sizes) if sizes else [int(c) for c in rng.integers(1, 25, S)]
    C = sum(sizes)
    pos = np.arange(C)
    m = 100.0 / (1.0 + np.abs(pos[:, None] - pos[None, :])) + rng.random((C, C)) * 0.01
    return np.triu(m) + np.triu(m, 1).T, sizes


def mesh_epilogue(torch, np, device="cuda"):
    """5b: the mesh paths' group top-k at its callers' two shapes (S = 6 and
    8), on a virtual (2, 2) mesh of the card.  First through
    ``SubsetScorer.score_batch_topk``: 2 combo launches (each block's partial
    triples), 1 fold, no ``group_argmax``, and the selection equal to one
    device's bit for bit.  Then on the scorer's own device inputs with an
    integer table: the new form (partials a block, the fold) and the parent's
    (``combo_scores`` a block, ``pm.gather``, ``group_argmax``) bit-equal to
    each other and to the plain version; each form's device time
    (``queued_ms``, in turns parent, new, new, parent), whole and its
    epilogue alone (after the blocks' sums: the fold; the gather and
    ``group_argmax``), the bytes it moves to the scorer's device, and the
    bounds; one device's ``combo_score_topk`` beside them.  Returns the fold's
    kernel record (its main shape: S = 6)."""
    from hic_genome_assembler_tpu_torch.ops import cost, perms
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm

    dev = torch.device(device, 0) if device == "cuda" else torch.device(device)
    mesh = pm.make_mesh((2, 2), [dev] * 4)
    rng = np.random.default_rng(9)
    k = MESH_EPILOGUE_K
    shapes, record = {}, None
    for S in MESH_EPILOGUE_SIZES:
        m, sizes = epilogue_problem(np, S, rng)
        local = cost.ChromosomeScorer(m, sizes, dev).full()
        sharded = cost.ChromosomeScorer(m, sizes, dev, mesh=mesh).full()
        orders, orients_np = perms.order_batch(S), perms.orient_batch(S)
        R = len(orients_np)
        label = f"S={S} {len(orders)}x{R}"
        before = dict(sk.LAUNCHES)
        got = sharded.score_batch_topk(orders, orients_np, k=k)
        launched = {name: sk.LAUNCHES[name] - before[name] for name in sk.LAUNCHES}
        want = local.score_batch_topk(orders, orients_np, k=k)
        on_card = dev.type == "cuda"  # a CPU rehearsal launches nothing
        check((launched["combo_score_topk"], launched["topk_fold"], launched["group_argmax"])
              == ((2, 1, 0) if on_card else (0, 0, 0)),
              f"mesh top-k {label}: launches {launched}, not 2 combo, 1 fold, 0 group_argmax")
        check(np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
              and got[2] == want[2], f"mesh top-k {label}: the selection differs from one "
                                     "device's")
        # the scorer's device inputs, with an integer table of the same size
        combo = cost._combo_index(orders.astype(np.int64))
        cid_blocks = sharded._blocks(combo["cid"])
        cid = local._blocks(combo["cid"])[0]
        F = torch.from_numpy(rng.integers(0, 16, sharded._F_flat.numel()).astype(np.float32)
                             ).to(dev)
        idx4 = sharded._put(sharded._combo_f_indices(combo))
        orients = sharded._put(orients_np, np.int32)
        c0 = torch.tensor(3.0, device=dev)
        n = cid_blocks[0].shape[0] * R
        n_glob, D = n * len(cid_blocks), len(cid_blocks)

        def partials(i, out):
            return sk.combo_score_topk_partials(F, idx4, cid_blocks[i], orients, c0, k, i * n,
                                                n_glob, out=out)

        def new():
            return sharded._fold_blocks(partials, k)

        def block_scores():
            return [sk.combo_scores(F, idx4, blk, orients, c0) for blk in cid_blocks]

        def parent():
            return sk.group_argmax(pm.gather(block_scores(), dev).reshape(-1), k)

        def plain():
            return sk._group_argmax(torch.cat([sk.combo_scores_plain(F, idx4, blk, orients, c0)
                                               for blk in cid_blocks]).reshape(-1), k)

        forms = {"new": new(), "parent": parent(), "plain": plain()}
        torch.cuda.synchronize()
        check(all(torch.equal(a, b) and torch.equal(a, c)
                  for a, b, c in zip(forms["new"], forms["parent"], forms["plain"])),
              f"mesh top-k {label}: the new form, the parent's and the plain version differ")
        stacked = sk.empty_triples(D, k, torch.float32, dev)
        for i in range(D):
            partials(i, tuple(t[i] for t in stacked))
        scored = block_scores()
        fold_want = sk.fold_group_triples_plain(*stacked)
        check(all(torch.equal(a, b) for a, b in zip(sk.fold_group_triples(*stacked), fold_want)),
              f"mesh top-k {label}: topk_fold differs from its plain version")
        epilogue = {"new": lambda: sk.fold_group_triples(*stacked),
                    "parent": lambda: sk.group_argmax(pm.gather(scored, dev).reshape(-1), k)}
        whole = {"new": new, "parent": parent}
        times = {("whole", form): [] for form in whole}
        times.update({("epilogue", form): [] for form in epilogue})
        for form in MESH_EPILOGUE_TURNS:
            times["whole", form].append(queued_ms(torch, whole[form]))
            times["epilogue", form].append(queued_ms(torch, epilogue[form]))
        one_device = queued_ms(torch, lambda: sk.combo_score_topk(F, idx4, cid, orients, c0, k))
        P = S * (S - 1) // 2
        moved = {"new": D * k * 16, "parent": n_glob * 4}
        bounds = {
            ("epilogue", "new"): score_bound_ms(D * k * 16 + k * 16, D * k),
            ("epilogue", "parent"): score_bound_ms(n_glob * 4 + k * 16, n_glob),
            ("whole", "new"): score_bound_ms(
                idx4.numel() * 8 + 4 * int(torch.unique(idx4).numel()) + cid.numel() * 4
                + orients.numel() * 4 + 4 + k * 16, n_glob * (P + 2)),
        }
        bounds["whole", "parent"] = bounds["whole", "new"]
        plain_ms = cuda_ms(torch, plain, 3)
        shown = {key: ("not measured" if None in ts else
                       "/".join(f"{t:.4f}" for t in ts)) for key, ts in times.items()}
        for part in ("whole", "epilogue"):
            for form in ("parent", "new"):
                bound, by = bounds[part, form]
                print(f"mesh top-k {label} k={k} on {CARD}, {form} form, {part}: "
                      f"{shown[part, form]} ms on the device (queued, turns "
                      f"{'/'.join(MESH_EPILOGUE_TURNS)}), {moved[form]} bytes to the scorer's "
                      f"device, bound {bound:.6f} ms ({by})")
        print(f"mesh top-k {label}: one device's combo_score_topk {one_device} ms on the device "
              f"(queued); plain version {plain_ms:.4f} ms a call; new == parent == plain, "
              "bit for bit")
        shapes[label] = {
            "whole_ms": {form: times["whole", form] for form in whole},
            "epilogue_ms": {form: times["epilogue", form] for form in epilogue},
            "bytes_to_scorer": moved, "one_device_ms": one_device, "plain_ms": plain_ms,
            "bound_ms": {f"{part} {form}": b[0] for (part, form), b in bounds.items()}}
        if record is None:
            fold = epilogue["new"]
            bound, by = bounds["epilogue", "new"]
            record = {
                "name": "topk_fold", "route": "cuda", "source": SCORE_SOURCE,
                "replaces": SCORE_REPLACES["topk_fold"], "max_abs_err": 0.0,
                "ms": cuda_ms(torch, fold, 50), "queued_ms": queued_ms(torch, fold),
                "plain_ms": cuda_ms(torch, lambda: sk.fold_group_triples_plain(*stacked), 10),
                "bound_ms": bound, "bound_by": by, "library_ms": None,
                "shape": f"[{D}, {k}] triples ({label})"}
        del local, sharded, F, idx4, stacked, scored, forms
    record["mesh_epilogue"] = shapes
    torch.cuda.empty_cache()
    return record


TOPK_SWEEP_SEEDS = 5
TOPK_SWEEP_RUNS = 3
# (S, k) of the combo sweep: 23,040 candidates at S = 6 in groups of 1 (k 8,
# ragged k 7), 2 (k 4) and 3 (k 2) tiles, 5.16M at S = 8 in groups of 20
# (k 64) and 115 (ragged k 11) tiles
TOPK_SWEEP_COMBOS = ((6, 8), (6, 7), (6, 4), (6, 2), (8, 64), (8, 11))


def topk_sweep(torch, np, device="cuda"):
    """``combo_score_topk`` and ``group_argmax`` held exactly to the plain
    ``_group_argmax`` on integer scores (ties within and across tiles):
    groups of 1, 2, 3 and 20 or more tiles of ``TOPK_TILE``, ragged last
    groups, ``TOPK_SWEEP_SEEDS`` seeds.  Returns the cases held."""
    from hic_genome_assembler_tpu_torch.ops import cost, perms
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    dev = torch.device(device)
    tile = sk.TOPK_TILE
    combos = {}
    for S, _k in TOPK_SWEEP_COMBOS:
        if S not in combos:
            index = cost._combo_index(perms.order_batch(S).astype(np.int64))
            combos[S] = (index["n_combo"], torch.from_numpy(np.require(index["cid"], np.int32, "C")
                                                           ).to(dev),
                         torch.from_numpy(np.array(perms.orient_batch(S))).to(dev))
    cases = 0
    for seed in range(TOPK_SWEEP_SEEDS):
        rng = np.random.default_rng(seed)
        c0 = torch.tensor(3.0, device=dev)
        for S, k in TOPK_SWEEP_COMBOS:
            n_combo, cid, orients = combos[S]
            F = torch.from_numpy(rng.integers(0, 2, 9 * 9 * 4 * 65).astype(np.float32)).to(dev)
            idx4 = torch.from_numpy(rng.integers(0, F.numel(), (n_combo, 4))).to(dev)
            got = sk.combo_score_topk(F, idx4, cid, orients, c0, k)
            want = sk.combo_score_topk_plain(F, idx4, cid, orients, c0, k)
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"combo_score_topk S={S} k={k} seed {seed} differs from the plain version")
            cases += 1
        for tiles in (1, 2, 3, 21):
            # groups of exactly `tiles` tiles, one short (a ragged last
            # group), and one over (the last tile holds one candidate)
            k = 3
            for N in (k * tiles * tile, k * tiles * tile - 5, k * (tiles * tile + 1)):
                for top in (4, 2**20):
                    x = torch.from_numpy(rng.integers(0, top, N).astype(np.float32)).to(dev)
                    got, want = sk.group_argmax(x, k), sk._group_argmax(x, k)
                    check(all(torch.equal(a, b) for a, b in zip(got, want)),
                          f"group_argmax N={N} k={k} values < {top} seed {seed} differs from "
                          "the plain version")
                    cases += 1
    return cases


def topk_error(torch, sk, label, got, want, exact, n_terms):
    """Holds a top-k triple to its plain version's: values and second maxima
    within ``sum_bound`` of each group's largest exact score, the argmax equal
    where the group's top two differ by more than twice the bound; returns
    the largest difference."""
    vals, idx, second = got
    wvals, widx, wsecond = want
    k = vals.shape[0]
    flat = exact.reshape(-1)
    flat = torch.cat([flat, flat.new_zeros((-flat.shape[0]) % k)]).reshape(k, -1)
    bound = torch.from_numpy(sk.sum_bound(n_terms, flat.max(dim=1).values.cpu().numpy())
                             ).to(vals.device)
    dv, ds = (torch.where(x == y, 0.0, (x.double() - y.double()).abs())
              for x, y in ((vals, wvals), (second, wsecond)))
    err = float(torch.maximum(dv, ds).max())
    check(bool((dv <= bound).all() and (ds <= bound).all()),
          f"{label}: top-k values beyond the bound (max {err:.3g})")
    clear = (wvals.double() - wsecond.double()) > 2 * bound
    check(torch.equal(idx[clear], widx[clear]), f"{label}: an argmax differs where the top two "
                                                "are apart")
    return err


def phase_score_replay(torch, np, record):
    """5b: phase 4's profile builds and combo launches replayed on their own
    inputs (recorded by ``score_input_recorder``): each held to its plain
    version (profiles within ``sum_bound``; the top-k as ``topk_error``
    says; two launches bit-identical), then timed on the device
    (``queued_ms``) beside its bound.  Prints and returns each set's totals:
    {name: {"launches", "max_abs_err", "device_ms", "bound_ms", "bound_by"}}."""
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    out = {}
    for name, calls in record.items():
        worst, times, bounds = 0.0, [], []
        for i, args in enumerate(calls):
            if name == "pair_profiles":
                sub, sizes, cmax = args
                fn = lambda: sk.pair_profiles(sub, sizes, cmax)  # noqa: E731
                got, again, want = fn(), fn(), sk.pair_profiles_plain(sub, sizes, cmax)
                exact = sk.pair_profiles_plain(sub.double(), sizes, cmax)
                bound = torch.from_numpy(sk.sum_bound(cmax, exact.abs().cpu().numpy())
                                         ).to(sub.device)
                diff = (got.double() - want.double()).abs()
                check(bool((diff <= bound).all()),
                      f"replayed pair_profiles {i}: beyond sum_bound (max {float(diff.max()):.3g})")
                err = float(diff.max())
                sz = sizes.cpu().numpy()
                C, Sp, L = sub.shape[0], sz.shape[0], 2 * cmax - 1
                off_diagonal = C * C - int((sz ** 2).sum())
                bounds.append(score_bound_ms(off_diagonal * 4 + Sp * 8 + 16 * Sp * Sp * L,
                                             2 * off_diagonal))
            else:
                F, idx4, cid, orients, c0, k = args
                fn = lambda: sk.combo_score_topk(F, idx4, cid, orients, c0, k)  # noqa: E731
                got, again = fn(), fn()
                want = sk.combo_score_topk_plain(F, idx4, cid, orients, c0, k)
                S = orients.shape[1]
                P = S * (S - 1) // 2
                exact = sk.combo_scores_plain(F.double(), idx4, cid, orients, c0.double())
                err = topk_error(torch, sk, f"replayed combo_score_topk {i}", got, want, exact,
                                 P + 1)
                N = cid.shape[0] * orients.shape[0]
                nbytes = idx4.numel() * 8 + 4 * int(torch.unique(idx4).numel()) \
                    + cid.numel() * 4 + orients.numel() * 4 + 4 + k * 16
                bounds.append(score_bound_ms(nbytes, N * (P + 2)))
            torch.cuda.synchronize()
            pairs = zip(got, again) if isinstance(got, tuple) else [(got, again)]
            check(all(torch.equal(a, b) for a, b in pairs),
                  f"replayed {name} {i}: two launches differ")
            worst = max(worst, err)
            times.append(queued_ms(torch, fn, REPLAY_ITERS))
        bound_ms = sum(b[0] for b in bounds)
        by = "/".join(sorted({b[1] for b in bounds}))
        total = None if None in times else sum(times)
        shown = "not measured" if total is None else (
            f"{total:.4f} ms on the device (CUDA events, launches queued, mean of "
            f"{REPLAY_ITERS} a launch), {100 * bound_ms / total:.1f}% of the bound")
        print(f"replay {name} on {CARD}: phase 4's {len(calls)} launches == plain (max abs err "
              f"{worst:.3g}), two launches bit-identical; {shown}; summed bound {bound_ms:.6f} ms "
              f"({by}); largest launch {max(times) if total is not None else None} ms")
        out[name] = {"launches": len(calls), "max_abs_err": worst, "device_ms": total,
                     "bound_ms": bound_ms, "bound_by": by}
    old = {"pair_profiles": OLD_PROFILES, "combo_score_topk": OLD_COMBO}
    for name, figures in old.items():
        print(f"{name} with the previous kernel ({figures['from']}): " + ", ".join(
            f"{label} {ms} ms on the device" for label, ms in figures.items() if label != "from"))
    torch.cuda.empty_cache()
    return out


def library_bounds(torch, np, device="cuda"):
    """Times and bounds of two device functions the port leaves to PyTorch
    calls, as the JAX package left them to XLA: device mode's rank sort
    (``ops/matrix.rank_matrix_desc``, f32 [n, n] in, int32 [n, n] out,
    about n^2 log2 n compares) at the 16K genome's n, and one EM iteration's
    products (``ops/gaussian_hmm._log_gaussian_diag`` and ``_m_step``: X and
    X**2, f64 [T, D], read twice; 16 T D f64 operations) at the HMM path's
    largest possible fit, T = D = 3,715 (D <= T), on seeded random inputs.
    Prints them and returns {name: (ms a call, bound ms, bound by)}."""
    from hic_genome_assembler_tpu_torch.ops import gaussian_hmm, matrix

    dev = torch.device(device)
    n, T = N_RANK, 3715
    rank_ms, rank_by = score_bound_ms(8 * n * n, n * n * math.log2(n))
    hmm_bytes, hmm_ops = 32 * T * T + 64 * T, 16 * T * T
    bytes_ms, ops_ms = 1e3 * hmm_bytes / HBM_BYTES_PER_S, 1e3 * hmm_ops / FP64_OPS_PER_S
    hmm_ms, hmm_by = (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")
    gen = torch.Generator(device=dev).manual_seed(11)
    M = torch.rand((n, n), generator=gen, device=dev)
    sort_ms = cuda_ms(torch, lambda: matrix.rank_matrix_desc(M), 5)
    del M
    X = torch.rand((T, T), generator=gen, device=dev, dtype=torch.float64)
    X2 = X ** 2
    means = torch.rand((2, T), generator=gen, device=dev, dtype=torch.float64)
    covars = 0.5 + torch.rand((2, T), generator=gen, device=dev, dtype=torch.float64)
    gamma = torch.softmax(torch.rand((T, 2), generator=gen, device=dev, dtype=torch.float64), 1)
    xi_sum = torch.rand((2, 2), generator=gen, device=dev, dtype=torch.float64)

    def em_step():
        gaussian_hmm._log_gaussian_diag(X, X2, means, covars)
        return gaussian_hmm._m_step(X, X2, gamma, xi_sum)

    em_ms = cuda_ms(torch, em_step, 20)
    del X, X2
    torch.cuda.empty_cache()
    print(f"PyTorch calls on {CARD}: rank_matrix_desc at n={n} {sort_ms:.4f} ms a call, bound "
          f"{rank_ms:.4f} ms ({rank_by}); an EM iteration's _log_gaussian_diag + _m_step at "
          f"T=D={T} {em_ms:.4f} ms a call, bound {hmm_ms:.4f} ms ({hmm_by})")
    return {"rank_matrix_desc": (sort_ms, rank_ms, rank_by),
            "em_iteration": (em_ms, hmm_ms, hmm_by)}


def forced_escalation(torch, np, device, n):
    """Part 2's brute force (``part2_order.brute_force_best``) over ``n``
    one-bin scaffolds: a one-bin scaffold reads the same in both
    orientations, so all 2**n orientations of an order score exactly alike,
    the winner's group holds its ties, the top-k floor (the largest second
    maximum) reaches the exact best, and the decision escalates to the dense
    block scores (``score_batch``).  Returns the decision, the run's
    escalations, the block kernel's launches, the host seconds in
    ``score_batch`` and in ``cost._decide``, and the scorer."""
    from hic_genome_assembler_tpu_torch.models import part2_order
    from hic_genome_assembler_tpu_torch.ops import cost
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    rng = np.random.default_rng(7)
    m = np.triu(rng.integers(1, 50, (n, n)).astype(np.float64), 1)
    scorer = cost.ChromosomeScorer(m + m.T, [1] * n, device)
    seconds = {"score_batch": 0.0, "decide": 0.0}
    originals = {"score_batch": cost.SubsetScorer.score_batch, "decide": cost._decide}

    def timed(key):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            out = originals[key](*args, **kwargs)
            seconds[key] += time.perf_counter() - t0
            return out
        return wrapper

    cost.SubsetScorer.score_batch, cost._decide = timed("score_batch"), timed("decide")
    before = sk.LAUNCHES["block_score"]
    try:
        decision = part2_order.brute_force_best(scorer, list(range(n)),
                                                [f"s{i}" for i in range(n)])
    finally:
        cost.SubsetScorer.score_batch, cost._decide = originals.values()
    return (decision, scorer.stats.escalations, sk.LAUNCHES["block_score"] - before, seconds,
            scorer)


READBACK_REPS = 5                  # timed drains of the escalation's scores, each way


def escalation_split(torch, np, scorer):
    """The S = 8 escalation's dense scores again on ``scorer``'s table: the
    block launches' device time (``queued_ms``), then their readback to one
    float64 host array two ways, each timed ``READBACK_REPS`` times in turns
    on the host clock: ``cost._drain_rows`` (one pinned buffer, one
    synchronisation) and a pageable ``.cpu()`` a chunk (the port's
    readback before it); both must give the same bytes.  Returns the three
    times in ms (the readbacks' means)."""
    from hic_genome_assembler_tpu_torch.ops import cost, perms
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    sub = scorer.full()
    orders, orients = perms.order_batch(scorer.S), perms.orient_batch(scorer.S)
    Bo, R, chunk = orders.shape[0], orients.shape[0], 2048
    dev = sub.device
    orients_d = torch.from_numpy(np.array(orients, np.int32)).to(dev)
    chunks = [torch.from_numpy(np.array(orders[o:o + chunk], np.int32)).to(dev)
              for o in range(0, Bo, chunk)]

    def launch():
        return [sk.block_scores(sub._F_flat, sub._sizes_d, c, orients_d, sub._c0_d)
                for c in chunks]

    device = queued_ms(torch, launch, iters=5)
    parts = [(o * chunk, c.shape[0], t) for o, (c, t) in enumerate(zip(chunks, launch()))]
    torch.cuda.synchronize()

    def pageable():
        out = np.empty((Bo, R), dtype=np.float64)
        for ofs, n, t in parts:
            out[ofs:ofs + n] = t.cpu().numpy()[:n]
        return out

    def pinned():
        return cost._drain_rows(parts, (Bo, R))

    check(np.array_equal(pageable(), pinned()), "the pinned drain differs from the pageable copies")
    times = {pageable: [], pinned: []}
    for rep in range(READBACK_REPS):
        for fn in ((pageable, pinned) if rep % 2 == 0 else (pinned, pageable)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            times[fn].append(1e3 * (time.perf_counter() - t0))
    return device, float(np.mean(times[pinned])), float(np.mean(times[pageable]))


def phase_escalation(torch, np):
    """The forced escalation over six and over eight one-bin scaffolds, on the
    card and on the CPU: the same decision, an escalation on both, and the
    block kernel launched on the card (the counts set to 0 before each run).
    At eight, the escalation's split: its block launches on the device, its
    readback, and the host's dense decision.  Returns the block kernel's
    launches in each run and the split."""
    launches, split = {}, {}
    for n in (6, 8):
        reset_launches()
        got = forced_escalation(torch, np, torch.device("cuda"), n)
        launches[n] = got[2]
        want = forced_escalation(torch, np, torch.device("cpu"), n)
        print(f"forced escalation over {n} one-bin scaffolds ({math.factorial(n) // 2} x {2 ** n} "
              f"candidates): decision {got[0]} on the card, "
              f"{want[0]} on the CPU; {got[1]} escalations; block_score launched {got[2]} times")
        check(got[0] == want[0], f"the forced escalation over {n} decided otherwise on the card")
        check(got[1] > 0 and want[1] > 0, f"the forced escalation over {n} did not escalate")
        check(got[2] > 0, f"the forced escalation over {n} launched block_score no time")
        if n == 8:
            device, pinned, pageable = escalation_split(torch, np, got[4])
            split = {"block_score_device_ms": device, "readback_ms": pinned,
                     "readback_pageable_ms": pageable,
                     "score_batch_s": got[3]["score_batch"], "decide_s": got[3]["decide"]}
            print(f"escalation split over 8 on {CARD}: block_score's {launches[8]} launches "
                  f"{device} ms on the device (launches queued); readback to host f64 "
                  f"{pinned:.3f} ms pinned, one synchronisation ({pageable:.3f} ms with a "
                  f"pageable .cpu() a chunk, the port's readback before); the run's score_batch "
                  f"{got[3]['score_batch']:.4f} s and dense _decide {got[3]['decide']:.4f} s on "
                  "the host clock")
    return launches, split


def phase_device_mode(torch, np, workdir, paths, resolution, exact_cuts):
    """-part1 with matrixMode = device on the 16K genome of phase 4."""
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.models import part1_cluster
    from hic_genome_assembler_tpu_torch.ops import count_kernels
    from hic_genome_assembler_tpu_torch.utils import e2e

    config = e2e.write_config(os.path.join(workdir, "config.txt"), workdir, paths, resolution,
                              {"matrixMode": "device"})
    sampled = {}
    rank_desc = part1_cluster.matrix.rank_matrix_desc

    def recording_rank(sim32):
        # keep the sampled rows of the run's own input and output
        out = rank_desc(sim32)
        n = sim32.shape[0]
        inner = np.random.default_rng(0).choice(np.arange(1, n - 1), N_RANK_ROWS - 2,
                                                replace=False)
        rows = np.sort(np.concatenate([[0, n - 1], inner]))
        idx = torch.from_numpy(rows).to(sim32.device)
        sampled.update(rows=rows, sim=sim32[idx].cpu().numpy(), rank=out[idx].cpu().numpy(),
                       device=str(out.device))
        return out

    part1_cluster.matrix.rank_matrix_desc = recording_rank
    reset_launches()
    t0 = time.time()
    try:
        with open(DEVICE_LOG, "w") as log, contextlib.redirect_stdout(log):
            report = cli.main(["-part1", "-config", config, "-device", "cuda", "-mesh", "off"])
    finally:
        part1_cluster.matrix.rank_matrix_desc = rank_desc
    total_s = time.time() - t0
    launches = count_kernels.LAUNCHES
    echo_timers(DEVICE_LOG)
    cuts = report.cut_indices
    differ = len(set(cuts) ^ set(exact_cuts))
    print(f"device mode: part1 {report.part_seconds['part1']:.1f} s (total {total_s:.1f} s); "
          f"rank matrix ranked on {sampled.get('device')}, counts on {report.rank_counts_on}, "
          f"{launches} kernel launches")
    print(f"device mode cuts ({len(cuts)}): {cuts}")
    print(f"exact mode cuts  ({len(exact_cuts)}): {exact_cuts}")
    print(f"device mode: {differ} cuts in one list and not the other (not a parity mode)")
    check(sampled.get("device", "").startswith("cuda"), "the rank argsort did not run on cuda")
    check(str(report.rank_counts_on).startswith("cuda"),
          f"device-mode rank matrix lay on {report.rank_counts_on}, not cuda")
    check(launches > 0, "device mode launched the rank-count kernel no time")
    want = np.argsort(sampled["sim"], axis=1, kind="stable")[:, ::-1]
    bad = int((want != sampled["rank"]).any(axis=1).sum())
    check(bad == 0, f"{bad} of {len(sampled['rows'])} sampled device rank rows differ from numpy")
    print(f"device mode: {len(sampled['rows'])} sampled rank rows (first and last included) "
          "equal numpy's stable argsort, reversed")


def phase_mesh_kernels(torch, np):
    """The kernel with block offsets on phase 3's matrix and batches; returns
    the largest difference from the plain version and the two times."""
    from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
    from hic_genome_assembler_tpu_torch.ops import count_kernels as ck
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm

    dev = torch.device("cuda")
    n = N_RANK
    full = random_rank(torch, np, n, 0)
    padded = ck.pad_rank(full)
    starts, growing, fixed = kernel_batches(np, n)
    max_err = 0
    timing_blocks = None
    for layout in MESH_LAYOUTS:
        d, m = layout
        # RankCounts' layout: block rows start on 64-byte boundaries
        t = pm.pad_to_multiple(n, 32 * math.lcm(d, m))
        mesh = pm.make_mesh(layout, [dev] * (d * m))
        rb, cb = t // d, t // m
        # RankCounts' element type at this size, and int32
        for dtype in dict.fromkeys([ck.rank_dtype(t), torch.int32]):
            blocks = pm.place_blocks(mesh, [full], t, t, fill=-1, dtype=dtype)
            for label, params in (("growing K=8", growing), ("fixed K=64", fixed)):
                for i in range(d):
                    for j in range(m):
                        got = ck.counts_many(blocks[i][j], params, row0=i * rb, col0=j * cb)
                        want = ck.counts_many_plain(blocks[i][j], params, row0=i * rb,
                                                    col0=j * cb)
                        err = int((got.long() - want.long()).abs().max().item())
                        max_err = max(max_err, err)
                        check(err == 0, f"{layout} {dtype} block ({i}, {j}), {label}: kernel "
                                        f"differs from plain version (max abs err {err})")
                summed = ck.counts_many_blocks(blocks, params, dev)[:, :n]
                whole = ck.counts_many(padded, params)[:, :n]
                check(torch.equal(summed, whole),
                      f"{layout} {dtype} {label}: the blocks' counts do not add up to one launch's")
                print(f"kernel with offsets == plain on every {d}x{m} {dtype} block of {rb}x{cb}, "
                      f"{label}; block sums == one launch on {tuple(padded.shape)}")
            if layout == (2, 2) and dtype == ck.rank_dtype(t):
                timing_blocks = blocks
            else:
                del blocks
    torch.cuda.synchronize()

    mesh = pm.make_mesh((2, 2), [dev] * 4)
    local, sharded = bp.RankCounts(full, dev), bp.RankCounts(full, dev, mesh=mesh)
    check(sharded.where == f"mesh 2x2 {dev}", f"virtual-mesh RankCounts lay on {sharded.where}")
    pairs = [(s, c) for s, c, _flag in fixed]
    sharded.prefetch_growing(starts)
    sharded.prefetch_fixed_pairs(pairs)
    for s in starts:
        check(np.array_equal(sharded.growing(s), local.growing(s)),
              f"virtual-mesh RankCounts growing({s}) differs from the single-device one")
    for s, c in pairs:
        check(np.array_equal(sharded.fixed(s, c), local.fixed(s, c)),
              f"virtual-mesh RankCounts fixed({s}, {c}) differs from the single-device one")
    print(f"virtual-mesh RankCounts ({sharded.where}) == single-device: {len(starts)} growing "
          f"and {len(pairs)} fixed scans")
    del local, sharded

    mesh_ms = cuda_ms(torch, lambda: ck.counts_many_blocks(timing_blocks, growing, dev), 20)
    single_ms = cuda_ms(torch, lambda: ck.counts_many(padded, growing), 20)
    print(f"growing K=8 at n={n}: over the 2x2 blocks (4 launches, partials summed, rows "
          f"gathered) {mesh_ms:.4f} ms; one launch {single_ms:.4f} ms")
    del full, padded, timing_blocks
    torch.cuda.empty_cache()
    return max_err, mesh_ms, single_ms


def phase_mesh_path(torch, workdir, main_dir, paths, resolution):
    """Part 1 then part 2 on a virtual (2, 2) mesh of cuda:0, byte-equal to
    phase 4; returns the counts kernel's and the scoring kernels' launches
    in that run."""
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch import device as device_mod
    from hic_genome_assembler_tpu_torch.ops import count_kernels
    from hic_genome_assembler_tpu_torch.parallel import mesh as pm
    from hic_genome_assembler_tpu_torch.parallel import runtime
    from hic_genome_assembler_tpu_torch.utils import e2e

    dev = device_mod.resolve("cuda")
    config = e2e.write_config(os.path.join(workdir, "config.txt"), workdir, paths, resolution)
    var = cli.load_config(config)
    rt = runtime.RuntimeContext(pm.make_mesh((2, 2), [dev] * 4), 0, 1, dev)
    with plain_scorers_on_cuda() as plain_calls:
        reset_launches()
        t0 = time.time()
        with open(MESH_LOG, "w") as log, contextlib.redirect_stdout(log):
            report = cli.run_parts(var, ["part1", "part2"], rt)
        total_s = time.time() - t0
        launches, scoring = count_kernels.LAUNCHES, score_launches()
    echo_timers(MESH_LOG)
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in report.part_seconds.items())
    print(f"mesh path ({rt.mesh.describe()}): {parts}; total {total_s:.1f} s; rank counts on "
          f"{report.rank_counts_on}, {launches} kernel launches; scoring kernel launches "
          f"{json.dumps(scoring)}")
    check(launches > 0, "the mesh path launched the rank-count kernel no time")
    # on a mesh the combo kernel reduces each block to partial group triples
    # and one fold a batch merges them
    check(scoring == MESH_SCORE_LAUNCHES,
          f"the mesh path's scoring launches {scoring} are not {MESH_SCORE_LAUNCHES}")
    check(not any(plain_calls.values()),
          f"a plain scoring version ran on the card on the mesh path: {plain_calls}")
    check(report.rank_counts_on == "mesh 2x2 " + str(dev),
          f"mesh path rank counts lay on {report.rank_counts_on}")
    runs = [("virtual 2x2", workdir)]
    if torch.cuda.device_count() >= 2:
        auto_dir = os.path.join(workdir, "auto")
        auto_cfg = e2e.write_config(os.path.join(auto_dir, "config.txt"), auto_dir, paths,
                                    resolution)
        with open(MESH_LOG, "a") as log, contextlib.redirect_stdout(log):
            auto = cli.main(["-part1", "-part2", "-config", auto_cfg, "-device", "cuda",
                             "-mesh", "auto"])
        auto_parts = ", ".join(f"{k} {v:.1f} s" for k, v in auto.part_seconds.items())
        print(f"mesh path: -mesh auto over {torch.cuda.device_count()} cards, rank counts on "
              f"{auto.rank_counts_on}; {auto_parts}")
        runs.append(("-mesh auto", auto_dir))
        print("mesh path ran: a virtual 2x2 mesh of one card, and -mesh auto over the cards")
    else:
        print("mesh path ran: a virtual 2x2 mesh of one card (1 card visible, -mesh auto "
              "builds no mesh)")
    for label, run_dir in runs:
        for name in PART1_FILES + PART2_FILES:
            check(filecmp.cmp(os.path.join(run_dir, "files", name),
                              os.path.join(main_dir, "files", name), shallow=False),
                  f"{label}: {name} differs from phase 4's")
        print(f"mesh path ({label}): {len(PART1_FILES + PART2_FILES)} part-1 and part-2 files "
              "byte-equal to phase 4's")
    return launches, scoring


def part2_wall(log_path):
    with open(log_path) as log:
        found = re.findall(r"Total run-time  for Part2 = ([0-9.]+)", log.read())
    check(found, f"no part-2 wall in {log_path}")
    return float(found[-1])


def phase_ep(workdir, main_dir, paths, resolution):
    """Two CLI processes share the card and part 2's chromosomes; the merged
    files must equal phase 4's, and each process must have launched the
    scoring kernels of its shard; returns each rank's launches."""
    config = part2_config(workdir, main_dir, paths, resolution)
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    env.pop("HIC_MESH", None)
    procs, logs = [], []
    t0 = time.time()
    try:
        for rank in (0, 1):
            logs.append(open(EP_LOG.format(rank), "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", EP_CHILD, str(REPO), config],
                stdout=logs[-1], stderr=subprocess.STDOUT, cwd=workdir,
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
            ))
        for p in procs:
            p.wait(timeout=600)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    total_s = time.time() - t0
    rank_launches = []
    for rank, p in enumerate(procs):
        check(p.returncode == 0, f"EP rank {rank} exited with {p.returncode}; see "
                                 f"{EP_LOG.format(rank)}")
        with open(EP_LOG.format(rank)) as log:
            text = log.read()
        check(f"- EP shard: process {rank}/2 owns" in text, f"EP rank {rank} searched no shard")
        found = re.findall(r"^\[launches\] (.*)$", text, flags=re.M)
        check(found, f"EP rank {rank} printed no launch counts")
        rank_launches.append(json.loads(found[-1]))
        check(all(rank_launches[-1][name] > 0
                  for name in ("pair_profiles", "combo_score_topk", "pair_score")),
              f"EP rank {rank} left a scoring kernel unlaunched: {rank_launches[-1]}")
    summed = {name: sum(r[name] for r in rank_launches) for name in MAIN_SCORE_LAUNCHES}
    check(summed == MAIN_SCORE_LAUNCHES,
          f"the EP ranks' scoring launches sum to {summed}, not {MAIN_SCORE_LAUNCHES}")
    for name in PART2_FILES:
        check(filecmp.cmp(os.path.join(workdir, "files", name),
                          os.path.join(main_dir, "files", name), shallow=False),
              f"EP: merged {name} differs from phase 4's")
    walls = [part2_wall(EP_LOG.format(rank)) for rank in (0, 1)]
    print(f"EP: 2 processes, both done in {total_s:.1f} s; part-2 wall rank 0 "
          f"{walls[0]:.2f} s (waits for rank 1 and merges), rank 1 {walls[1]:.2f} s; "
          f"single process (phase 4) {part2_wall(LOG):.2f} s")
    print(f"EP: merged {' and '.join(PART2_FILES)} byte-equal to phase 4's; scoring kernel "
          f"launches rank 0 {json.dumps(rank_launches[0])}, rank 1 {json.dumps(rank_launches[1])}")
    return rank_launches


def main():
    t0 = time.time()
    import torch

    phase_device(torch)
    import numpy as np

    phase_build()
    record = phase_kernels(torch, np)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_dir, hmm_dir, dev_dir = (os.path.join(workdir, d) for d in ("16k", "hmm", "device"))
        (record["launches"], scoring, exact_cuts, paths, resolution, batches,
         score_inputs) = phase_main_path(torch, main_dir)
        phase_part2_cpu(os.path.join(workdir, "cpu"), main_dir, paths, resolution)
        phase_part2_profile(torch, os.path.join(workdir, "profile"), main_dir, paths, resolution)
        phase_part2_turns(torch, os.path.join(workdir, "turns"), main_dir, paths, resolution)
        record["main_path_device_ms"] = phase_part1_profile(
            torch, os.path.join(workdir, "profile1"), paths, resolution, exact_cuts)
        record["replay"] = phase_replay(torch, np, batches)
        record["max_abs_err"] = max(record["max_abs_err"], record["replay"]["max_abs_err"])
        hmm_records = phase_hmm_kernels(torch, np)
        score_records = phase_score_kernels(torch, np)
        for name, replay in phase_score_replay(torch, np, score_inputs).items():
            score_records[name]["replay"] = replay
        del score_inputs
        escalation_launches, escalation = phase_escalation(torch, np)
        hmm_launches = phase_hmm_path(torch, hmm_dir)
        # the rank-count record keeps phase 4's count; phase 7 checks its own
        phase_device_mode(torch, np, dev_dir, paths, resolution, exact_cuts)
        offset_err, mesh_ms, single_ms = phase_mesh_kernels(torch, np)
        record["max_abs_err"] = max(record["max_abs_err"], offset_err)
        record.update(offset_max_abs_err=offset_err, mesh_2x2_ms=round(mesh_ms, 4),
                      one_launch_ms=round(single_ms, 4))
        record["mesh_launches"], mesh_scoring = phase_mesh_path(
            torch, os.path.join(workdir, "mesh"), main_dir, paths, resolution)
        ep_launches = phase_ep(os.path.join(workdir, "ep"), main_dir, paths, resolution)
        phase_working_example(torch, os.path.join(workdir, "example"))
    for rec in hmm_records:
        rec["launches"] = hmm_launches[rec["name"]]
    for name, rec in score_records.items():
        # each kernel's launches come from its path: phase 4's 16K run, the
        # forced escalations of phase 5b (block_score, which runs on
        # escalation only), or phase 9's mesh (topk_fold, the mesh epilogue)
        rec["launches"] = {"block_score": sum(escalation_launches.values()),
                           "topk_fold": mesh_scoring[name]}.get(name, scoring[name])
        rec.update(main_path_launches=scoring[name], mesh_launches=mesh_scoring[name],
                   ep_launches=[counts[name] for counts in ep_launches])
    score_records["combo_score_topk"]["mesh_group_argmax_launches"] = mesh_scoring["group_argmax"]
    score_records["block_score"].update(
        escalation_launches={f"n={n}": c for n, c in escalation_launches.items()},
        escalation_split=escalation)
    print(f"smoke: every phase passed in {time.time() - t0:.1f} s")
    print(json.dumps({"kernels": [record] + hmm_records
                      + [score_records[name] for name in SCORE_REPLACES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
