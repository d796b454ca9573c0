#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (hic_genome_assembler_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA GPU and the CUDA toolkit (nvcc).  Phases, each of which
passes or fails the run:

1. device: the card's nvidia-smi name and power limit, torch and CUDA
   versions;
2. build: compile csrc/*.cu with nvcc into build/kernels/;
3. kernels: the rank-count kernel against its plain torch version on the
   card, exact integer equality at the 16K genome's shapes and at the
   test shapes, then both timed with CUDA events;
4. main path: the 16K-bin north-star genome through
   ``hic_genome_assembler_tpu_torch.cli.main`` (-part1 -part2 -part3
   -part4, device cuda), with the planted-truth checks; the pipeline's own
   output goes to build/chip_smoke_pipeline.log;
5. HMM kernels: the forward-backward and Viterbi kernels against their
   plain torch versions on the card at T = 1, 2, 257, 3,715 and 17,162 and
   with a -inf transmat entry (rtol 1e-10, no NaN, identical paths), then
   both timed with CUDA events at T = 3,715 and 17,162;
6. HMM path: the CLI (-part1 -part2 -part3 -part4, device cuda, hmm = True)
   on the 3,715-bin HMM genome; its cut list and part-1 files must equal
   the JAX package's golden record (utils/hmm_golden_3715.json); output in
   build/chip_smoke_hmm.log;
7. device mode: -part1 with matrixMode = device on the 16K genome of phase
   4; the rank matrix is ranked and counted on the card, and 64 of its rows
   must equal numpy's stable argsort, reversed, of the same f32 input;
   output in build/chip_smoke_device.log.

Each of phases 4, 6 and 7 sets the launch counts of its kernels to 0 just
before it drives its path and fails if a kernel of that path was not
launched.  The second-to-last stdout line is the kernels' JSON record, the
last line {"ok": true, "device": {...}}.  Without a CUDA device, or without
the package beside it, the script exits non-zero and prints no result.
"""

import contextlib
import hashlib
import json
import os
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
HMM_T = (1, 2, 257, 3715, 17162)   # 3,715: the HMM path's largest fit; 17,162: the 16K genome
HMM_TIMED_T = (3715, 17162)
HMM_RTOL = 1e-10                   # both sides run the same f64 steps; only exp/log may differ
HMM_GENOME_N = 8192                # make_hmm_genome(8192): 3,715 bins
N_RANK_ROWS = 64                   # device-mode rank rows held against numpy


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(torch, fn, iters):
    """Mean milliseconds of ``fn`` over ``iters`` warm calls, CUDA events."""
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
    from hic_genome_assembler_tpu_torch.ops import count_kernels, hmm_kernels

    count_kernels.LAUNCHES = 0
    for name in hmm_kernels.LAUNCHES:
        hmm_kernels.LAUNCHES[name] = 0


def phase_device(torch):
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")


def phase_build():
    from hic_genome_assembler_tpu_torch.ops import _build

    seconds = _build.build()
    _build.library()
    print(f"build: nvcc {seconds:.2f} s into {_build.BUILD_DIR} "
          "(0.00 = library already current)")


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

    def rank_matrix(n, seed):
        rng = np.random.default_rng(seed)
        rows = rng.permuted(np.broadcast_to(np.arange(n, dtype=np.int32), (n, n)), axis=1)
        return ck.pad_rank(torch.from_numpy(np.ascontiguousarray(rows)).to(dev))

    n = N_RANK
    t0 = time.time()
    R = rank_matrix(n, 0)
    print(f"rank matrix n={n}: padded {tuple(R.shape)} int32 on {R.device} "
          f"({time.time() - t0:.1f} s to make)")
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
    compare("growing K=8 at 16K", R, growing)
    compare("fixed K=64 at 16K", R, fixed)
    compare("fixed K=64 at 16K, 2048-column view", R[:, :2048], fixed)
    compare("fixed K=64 at 16K, 4096-column view", R[:, :4096], fixed)
    small = rank_matrix(603, 2)
    compare("growing n=603", small, [[s, 0, 1] for s in (0, 1, 7, 300, 601)])
    compare("fixed n=603", small, [[0, 5, 0], [3, 77, 0], [100, 400, 0], [0, 602, 0]])
    rect = rank_matrix(3000, 5)
    compare("fixed n=3000, 2048-column view", rect[:, :2048],
            [[0, 5, 0], [3, 77, 0], [100, 640, 0], [900, 2500, 0], [2940, 2999, 0]])

    # timing: the K=8 growing batch, warm, CUDA events over repeated launches
    n_r, n_c = R.shape
    rows = np.arange(n_r)
    kernel_bytes = 4 * sum(int(np.clip(rows - s, 0, n_c).sum()) for s in starts)
    plain_bytes = 4 * sum(n_r * min(n_c, max(n_r - 1 - s, 0)) for s in starts)
    ms = cuda_ms(torch, lambda: ck.counts_many(R, growing), 20)
    plain_ms = cuda_ms(torch, lambda: ck.counts_many_plain(R, growing), 5)
    print(f"growing K=8 at n={n}: kernel {ms:.4f} ms, {kernel_bytes / ms / 1e6:.1f} GB/s "
          f"of the {kernel_bytes / 1e9:.3f} GB prefix triangle it reads; "
          f"plain {plain_ms:.4f} ms, {plain_bytes / plain_ms / 1e6:.1f} GB/s of the "
          f"{plain_bytes / 1e9:.3f} GB column slices it scans (one pass each; its "
          f"temporaries add more)")
    del R, small, rect
    torch.cuda.empty_cache()
    return {"name": "rank_counts", "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES, "max_abs_err": max_err,
            "ms": round(ms, 4), "plain_ms": round(plain_ms, 4)}


def phase_main_path(torch, workdir):
    """The full CLI pipeline on the planted 16K genome in ``workdir``;
    returns the kernel launches it made, its cut list, and the genome's
    HiC-Pro paths and resolution."""
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
    argv = ["-part1", "-part2", "-part3", "-part4", "-config", config, "-device", "cuda"]
    reset_launches()
    t0 = time.time()
    with open(LOG, "w") as log, contextlib.redirect_stdout(log):
        report = cli.main(argv)
    total_s = time.time() - t0
    launches = count_kernels.LAUNCHES
    truth = e2e.truth_checks(genome, os.path.join(workdir, "files"))
    echo_timers(LOG)
    parts = ", ".join(f"{k} {v:.1f} s" for k, v in report.part_seconds.items())
    print(f"main path: {parts}; total {total_s:.1f} s")
    print(f"main path: rank counts on {report.rank_counts_on}, {launches} kernel launches")
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
    return launches, report.cut_indices, paths, genome.resolution


def phase_hmm_kernels(torch, np):
    """Both HMM kernels against their plain versions, then timed; returns
    their kernel records."""
    from hic_genome_assembler_tpu_torch.ops import hmm_kernels as hk

    dev = torch.device("cuda")

    def inputs(T, seed, neg_inf=False):
        rng = np.random.default_rng(seed)
        log_b = rng.normal(0.0, 3.0, (T, 2))
        trans = np.array([[1.0, 0.0], [0.3, 0.7]]) if neg_inf else np.array(
            [[0.9, 0.1], [1e-4, 0.9999]])
        with np.errstate(divide="ignore"):
            host = (log_b, np.log([0.5, 0.5]), np.log(trans))
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in host]

    err = {"hmm_forward_backward": 0.0, "hmm_viterbi": 0}
    cases = [(T, T, False) for T in HMM_T] + [(3715, 99, True)]
    for T, seed, neg_inf in cases:
        args = inputs(T, seed, neg_inf)
        got = hk.forward_backward(*args)
        path = hk.viterbi(*args)
        torch.cuda.synchronize()
        want = hk.forward_backward_plain(*args)
        for name, g, w in zip(("logprob", "gamma", "xi_sum"), got, want):
            check(not torch.isnan(g).any().item(), f"T={T}: {name} from the kernel holds NaN")
            diff = (g - w).abs()
            bound = HMM_RTOL * w.abs() + 1e-300
            check(bool((diff <= bound).all().item()),
                  f"T={T}: {name} differs from the plain version beyond rtol {HMM_RTOL}")
            err["hmm_forward_backward"] = max(err["hmm_forward_backward"], diff.max().item())
        mismatched = int((path != hk.viterbi_plain(*args)).sum().item())
        err["hmm_viterbi"] = max(err["hmm_viterbi"], mismatched)
        check(mismatched == 0, f"T={T}: Viterbi path differs from the plain version at "
                               f"{mismatched} frames")
        print(f"HMM kernels == plain: T={T}{' with a -inf transmat entry' if neg_inf else ''}, "
              f"logprob {got[0].item():.6f}")
    times = {}
    for T in HMM_TIMED_T:
        args = inputs(T, T)
        for name, fn, plain in (
            ("hmm_forward_backward", hk.forward_backward, hk.forward_backward_plain),
            ("hmm_viterbi", hk.viterbi, hk.viterbi_plain),
        ):
            ms = cuda_ms(torch, lambda: fn(*args), 20)
            plain_ms = cuda_ms(torch, lambda: plain(*args), 1)
            times[(name, T)] = (ms, plain_ms)
            print(f"{name} T={T}: kernel {ms:.4f} ms ({1e6 * ms / T:.1f} ns per step), "
                  f"plain {plain_ms:.4f} ms")
    T0 = HMM_TIMED_T[0]
    return [{"name": name, "route": "cuda", "source": HMM_SOURCE,
             "replaces": HMM_REPLACES[name], "max_abs_err": err[name],
             "ms": round(times[(name, T0)][0], 4), "plain_ms": round(times[(name, T0)][1], 4)}
            for name in ("hmm_forward_backward", "hmm_viterbi")]


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
            report = cli.main(["-part1", "-config", config, "-device", "cuda"])
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


def main():
    import torch

    phase_device(torch)
    import numpy as np

    phase_build()
    record = phase_kernels(torch, np)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
        main_dir, hmm_dir, dev_dir = (os.path.join(workdir, d) for d in ("16k", "hmm", "device"))
        record["launches"], exact_cuts, paths, resolution = phase_main_path(torch, main_dir)
        hmm_records = phase_hmm_kernels(torch, np)
        hmm_launches = phase_hmm_path(torch, hmm_dir)
        # the rank-count record keeps phase 4's count; phase 7 checks its own
        phase_device_mode(torch, np, dev_dir, paths, resolution, exact_cuts)
    for rec in hmm_records:
        rec["launches"] = hmm_launches[rec["name"]]
    print(json.dumps({"kernels": [record] + hmm_records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
