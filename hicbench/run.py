"""One run of one benchmark cell:

    python3 hicbench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the configuration's genome from ``--seed`` and writes its
HiC-Pro files under the run's temporary directory, then runs one warm-up
job on the genome's first chromosomes (it loads the kernels and the host
IO library, built on the checkout's first run, and cuBLAS).  The window
runs whole jobs back to back (``window.py``).  After it the plain
reference judges every job's files (``compare.py``).  The last line of
standard output is the result as one JSON object; the numbers compared,
each beside its limit, are the last lines of standard error and the
result's last key.

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

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        fail(f"needs {entry['chips']} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    return measure(args, entry, config, mix, e2e, layer, "cuda")


def measure(args, entry, config, mix, e2e, layer, device: str) -> int:
    """Set-up, window, readings and the comparison of one run on
    ``device``; prints the result line.  Returns the exit code."""
    import numpy as np
    import torch

    import compare
    import genome
    import window

    seed = args.seed % (1 << 63)
    tmp = tempfile.mkdtemp(prefix="hicbench-")
    try:
        recipe = config["genome"]
        g = genome.make(recipe, seed)
        paths = genome.write_hicpro(g, os.path.join(tmp, "hicpro"))
        note(f"genome of {g.n_bins} bins written")
        del g
        warm = genome.make(recipe, seed, n_chroms=WARMUP_CHROMOSOMES)
        warm_paths = genome.write_hicpro(warm, os.path.join(tmp, "warmup", "hicpro"))
        window.run_job(os.path.join(tmp, "warmup"), warm_paths, config, mix["parts"], device)
        shutil.rmtree(os.path.join(tmp, "warmup"))
        note("warm-up job done")
        if device == "cuda":
            torch.cuda.synchronize()
        tracing = window.Tracing() if args.trace else None
        jobs_dir = os.path.join(tmp, "jobs")

        def job_dir(k: int) -> str:
            d = os.path.join(jobs_dir, str(k))
            os.makedirs(d)
            return d

        setup_s = time.time() - START
        trace = None
        if tracing is None:
            jobs, dirs, window_s, error = window.run_window(
                args.seconds, job_dir, paths, config, mix["parts"], device)
        else:
            from torch.profiler import ProfilerActivity, profile

            import tracing as tracing_mod

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
            with tracing.installed(), profile(activities=acts) as prof:
                with torch.profiler.record_function(WINDOW_SPAN):
                    jobs, dirs, window_s, error = window.run_window(
                        args.seconds, job_dir, paths, config, mix["parts"], device, tracing)
                if device == "cuda":
                    torch.cuda.synchronize()
            trace_path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(trace_path)
            del prof
            trace = tracing_mod.read(trace_path, WINDOW_SPAN)
            os.remove(trace_path)

        note(f"window: {len(jobs)} job(s) in {window_s:.1f} s")
        for k, job in enumerate(jobs):
            parts = " ".join(f"{p} {s:.3f}" for p, s in job.part_seconds.items())
            note(f"job {k}: {job.wall_s:.3f} s ({parts})")
        dev = {"platform": "gpu" if device == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
               "count": entry["chips"],
               "memory_peak_bytes": int(torch.cuda.max_memory_allocated()) if device == "cuda" else 0}
        metrics = {}
        breakdown = None
        if not args.trace:
            if jobs:
                metrics["job_s"] = {"value": window_s / len(jobs), "unit": "s"}
            metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            metrics = {m["name"]: metrics[m["name"]] for m in e2e if m["name"] in metrics}
        else:
            readings = window.Readings(jobs, trace, tracing.rank_calls, tracing.hmm_calls)
            for m in layer:
                value = reader(m["name"])(readings)
                if value is not None:
                    metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
            if trace is not None:
                dev["busy_s"] = trace.busy_s()
                dev["window_s"] = trace.window_s
                breakdown = {"device_ops": trace.device_ops(), "idle_gaps": trace.idle_gaps()}
            del readings, trace, tracing
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

        # the comparison, once the program's state is freed
        ref = compare.Reference(paths, config, np.float64, note)
        ok, numbers = compare.judge_jobs(ref, dirs[: len(jobs)]) if jobs else (False, {})
        note("comparison done")
        del ref
        failed = (len(dirs) - len(jobs)) + (0 if ok else len(jobs))
        checks = {k: {"value": v, "limit": compare.LIMITS.get(k)} for k, v in numbers.items()}
        if error is not None:
            traceback.print_exception(error, file=sys.stderr)
            checks["job_error"] = {"value": repr(error)[:300], "limit": None}
        for k, v in checks.items():
            print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)

        found = forbidden_modules()
        if found:
            fail("the run loaded " + ", ".join(found), 3)
        result = {"correct": bool(ok and error is None), "attempted": len(dirs),
                  "failed": failed, "metrics": metrics, "device": dev}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["checks"] = checks
        print(json.dumps(result))
        return 0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
