"""One run of one benchmark cell:

    python3 hicbench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's genomes, one for each map of its pool in
the order ``--seed`` gives (``genome.pool``), and writes their HiC-Pro
files under the run's temporary directory, then runs one warm-up job on the
first genome's first chromosomes (it loads the kernels and the host IO
library, built on the checkout's first run, and cuBLAS).  The window runs
whole jobs back to back (``window.py``), on the genomes in turn, each
stopped past its deadline (``job_deadline``), which counts it as failed.
After it the plain reference judges every job's files (``compare.py``);
when no job finished there is nothing to judge and no reference is built.
A mix's ``threads`` sets the compute threads of OpenMP, the BLAS and
PyTorch.  The last line of standard output is the result as one JSON
object; the numbers compared, each beside its limit, are the last lines of
standard error and the result's last key.

With ``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a window run under
``torch.profiler`` by the readers in ``metrics/``.
"""

import time

START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
sys.path.insert(1, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "hic_genome_assembler_tpu")
WINDOW_SPAN = "hicbench.window"
WARMUP_CHROMOSOMES = 2  # the warm-up job assembles the genome's first chromosomes
DEADLINE_WINDOWS = 4    # a job's deadline: this many times --seconds,
MIN_DEADLINE_S = 120.0  # and never less
THREAD_VARIABLES = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def note(message: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"hicbench: {time.time() - START:.1f} s: {message}", file=sys.stderr, flush=True)


def fail(message: str, code: int = 2):
    print(f"hicbench: {message}", file=sys.stderr)
    sys.exit(code)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(workload: str, bench: dict = None):
    """The cell's entry in ``bench`` (BENCHMARK.json by default), its
    configuration, its mix and its metrics: (workload, config, mix,
    end_to_end, per_layer)."""
    bench = bench if bench is not None else benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        fail(f"no workload {workload!r} in BENCHMARK.json")
    with open(os.path.join(HERE, "configs", entry["config"] + ".json")) as fh:
        config = json.load(fh)
    with open(os.path.join(HERE, "mixes", entry["traffic"] + ".json")) as fh:
        mix = json.load(fh)
    mine = lambda m: workload in m.get("workloads", [workload])  # noqa: E731
    e2e = [m for m in bench["end_to_end"] if mine(m)]
    layer = [m for m in bench["per_layer"] if mine(m)]
    return entry, config, mix, e2e, layer


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"hicbench_metric_{name}", os.path.join(HERE, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    entry, config, mix, e2e, layer = cell(args.workload)

    # every cache the program builds lives at a fixed path in the checkout
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
    sys.modules["matplotlib"] = None  # plots off: the configuration's reduction
    threads = mix.get("threads")
    if threads:  # the mix's compute threads, before NumPy's and PyTorch's pools start
        for name in THREAD_VARIABLES:
            os.environ[name] = str(threads)

    import torch

    if threads:
        torch.set_num_threads(int(threads))
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"needs {entry['chips']} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return measure(args, entry, config, mix, e2e, layer, "cuda")


def job_deadline(seconds: float) -> float:
    """Each job's deadline, the warm-up's included, from the job's own
    start: ``DEADLINE_WINDOWS`` windows, and never under ``MIN_DEADLINE_S``."""
    return max(DEADLINE_WINDOWS * seconds, MIN_DEADLINE_S)


def report(result: dict, checks: dict, out) -> int:
    """Each check on standard error, then the result line on ``out`` with
    the checks as its last key; a run that loaded JAX or the JAX package
    prints no result.  Returns the exit code."""
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr, flush=True)
    found = forbidden_modules()
    if found:
        print("hicbench: the run loaded " + ", ".join(found), file=sys.stderr, flush=True)
        return 3
    print(json.dumps(dict(result, checks=checks)), file=out, flush=True)
    return 0


def measure(args, entry, config, mix, e2e, layer, device: str, deadline_s: float = None) -> int:
    """Set-up, window, readings and the comparison of one run on
    ``device``; prints the result line.  Each job is stopped past
    ``deadline_s`` (``job_deadline(args.seconds)`` unless given).  Returns
    the exit code."""
    import torch

    import compare
    import genome
    import window

    seed = args.seed % (1 << 63)
    deadline_s = job_deadline(args.seconds) if deadline_s is None else deadline_s
    out = sys.stdout  # a job sends sys.stdout to its log; the result line comes here
    progress = {"attempted": 1, "setup_s": None}  # the warm-up, until the window starts
    tmp = tempfile.mkdtemp(prefix="hicbench-")

    def device_info() -> dict:
        return {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                "count": entry["chips"],
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0}

    def overrun(message: str) -> None:
        """The watchdog's end of the run, from its own thread: no job is
        judged, every one attempted counts as failed."""
        note(message)
        metrics = {}
        if progress["setup_s"] is not None and not args.trace:
            metrics["setup_s"] = {"value": progress["setup_s"], "unit": "s"}
        n = progress["attempted"]
        code = report({"correct": False, "attempted": n, "failed": n, "metrics": metrics,
                       "device": device_info()},
                      {"job_deadline_s": {"value": deadline_s, "limit": None},
                       "job_error": {"value": message, "limit": None}}, out)
        shutil.rmtree(tmp, ignore_errors=True)
        os._exit(code)

    try:
        recipe = config["genome"]
        maps = genome.pool(recipe, seed)
        inputs = []
        for k, map_seed in enumerate(maps):
            g = genome.make(recipe, seed, map_seed=map_seed)
            inputs.append(genome.write_hicpro(g, os.path.join(tmp, "hicpro", str(k))))
            note(f"genome of {g.n_bins} bins written, map seed {map_seed}")
            del g
        warm = genome.make(recipe, seed, n_chroms=WARMUP_CHROMOSOMES, map_seed=maps[0])
        warm_dir = os.path.join(tmp, "warmup")
        warm_paths = genome.write_hicpro(warm, os.path.join(warm_dir, "hicpro"))
        try:
            window.run_job(warm_dir, warm_paths, config, mix["parts"], device, deadline_s, overrun)
        except window.JobDeadline as exc:  # a stopped warm-up ends the run, with no window
            jobs, dirs, window_s, error, trace, tracing = [], [warm_dir], 0.0, exc, None, None
        else:
            shutil.rmtree(warm_dir)
            note("warm-up job done")
            jobs, dirs, window_s, error, trace, tracing = timed_window(
                args, tmp, inputs, config, mix["parts"], device, deadline_s, overrun, progress)
            note(f"window: {len(jobs)} job(s) in {window_s:.1f} s")
            for k, job in enumerate(jobs):
                parts = " ".join(f"{p} {s:.3f}" for p, s in job.part_seconds.items())
                note(f"job {k}: {job.wall_s:.3f} s ({parts})")
        dev = device_info()
        metrics = {}
        breakdown = None
        if not args.trace:
            if jobs:
                metrics["job_s"] = {"value": window_s / len(jobs), "unit": "s"}
            if progress["setup_s"] is not None:
                metrics["setup_s"] = {"value": progress["setup_s"], "unit": "s"}
            metrics = {m["name"]: metrics[m["name"]] for m in e2e if m["name"] in metrics}
        elif tracing is not None:
            readings = window.Readings(jobs, trace, tracing.rank_calls, tracing.hmm_calls)
            for m in layer:
                value = reader(m["name"])(readings)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            if trace is not None:
                dev["busy_s"] = trace.busy_s()
                dev["window_s"] = trace.window_s
                breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
            del readings
        del trace, tracing
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # the comparison, once the program's state is freed; with no job
        # finished there is nothing to judge, and no reference is built
        if jobs:
            ok, numbers = compare.judge_runs(inputs, dirs[: len(jobs)], config, note)
            note("comparison done")
        else:
            ok, numbers = False, {}
            note("no job finished: no reference built")
        failed = (len(dirs) - len(jobs)) + (0 if ok else len(jobs))
        checks = {k: {"value": v, "limit": compare.LIMITS.get(k)} for k, v in numbers.items()}
        checks["job_deadline_s"] = {"value": deadline_s, "limit": None}
        if error is not None:
            traceback.print_exception(error, file=sys.stderr)
            checks["job_error"] = {"value": repr(error)[:300], "limit": None}
        result = {"correct": bool(ok and error is None), "attempted": len(dirs),
                  "failed": failed, "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        return report(result, checks, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def timed_window(args, tmp, inputs, config, parts, device, deadline_s, overrun, progress):
    """The measured window, under ``torch.profiler`` with ``--trace 1``:
    (jobs, job directories, window seconds, the error that ended a job,
    the window's trace, the tracing wrappers).  Notes the set-up seconds
    and each job attempted in ``progress``."""
    import torch

    import window

    if device == "cuda":
        torch.cuda.synchronize()
    tracing = window.Tracing() if args.trace else None
    jobs_dir = os.path.join(tmp, "jobs")

    def job_dir(k: int) -> str:
        progress["attempted"] = k + 1
        d = os.path.join(jobs_dir, str(k))
        os.makedirs(d)
        return d

    progress["setup_s"] = time.time() - START
    if tracing is None:
        return (*window.run_window(args.seconds, job_dir, inputs, config, parts, device,
                                   deadline_s, overrun), None, None)
    from torch.profiler import ProfilerActivity, profile

    import tracing as tracing_mod

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with tracing.installed(), profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW_SPAN):
            jobs, dirs, window_s, error = window.run_window(
                args.seconds, job_dir, inputs, config, parts, device, deadline_s, overrun, tracing)
        if device == "cuda":
            torch.cuda.synchronize()
    trace_path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(trace_path)
    del prof
    trace = tracing_mod.read(trace_path, WINDOW_SPAN)
    os.remove(trace_path)
    return jobs, dirs, window_s, error, trace, tracing


if __name__ == "__main__":
    sys.exit(main())
