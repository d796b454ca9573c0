"""The port's tracing: ``utils/profiling``'s timers as ``torch.profiler``
spans, part 2's stages timed per resumption, the new spans and counters
of a CPU run of parts 1-4, and the benchmark's readers of them.

* A timer puts one ``user_annotation`` event of its name into a profiler's
  Chrome trace, and enters no ``record_function`` while no profiler runs.
* ``timed_coro`` opens its span around each resumption only: no span of
  it overlaps the driver's work between two resumptions.
* Parts 1-4 of the CLI on the HMM fixture genome (12 chromosomes, so part
  2 interleaves them): part 2's three stage timers sum to at most part 2's
  wall seconds, ``part2/f64_rescore`` counts every ``oracle.cost_function``
  call part 2 makes, and part 1's stage timers lie inside its cut search.
* ``hicbench/metrics``' five readers of these, on hand-made readings.
"""

import importlib.util
import json
import os
from pathlib import Path

import pytest
import torch

from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.ops import oracle
from hic_genome_assembler_tpu_torch.utils import e2e, fixtures, profiling
from hic_genome_assembler_tpu_torch.viz import plot as torch_plot_mod

REPO = Path(__file__).resolve().parent.parent
HICBENCH = REPO / "hicbench"


@pytest.fixture(autouse=True)
def _fresh_registry():
    profiling.reset()
    yield
    profiling.reset()


def _trace_events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        return json.load(fh)["traceEvents"]


def _spans(events, name):
    return sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
                  for e in events
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                  and e.get("name") == name)


def test_timer_is_one_profiler_span(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.timer("test/stage"):
            torch.ones(32, 32).matmul(torch.ones(32, 32)).sum()
    assert len(_spans(_trace_events(prof, tmp_path), "test/stage")) == 1
    assert profiling.summary()["test/stage"]["calls"] == 1


def test_timer_enters_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for _ in range(3):
        with profiling.timer("test/stage"):
            pass
    assert profiling.summary()["test/stage"]["calls"] == 3


def _stepper(log):
    """A search coroutine: three yields, each value built from what it was
    sent, returning their sum."""
    total = 0
    for step in range(3):
        with torch.profiler.record_function("test/inner"):
            torch.ones(8).sum()
        got = yield (step, total)
        log.append(got)
        total += got
    return total


def test_timed_coro_opens_no_span_across_a_yield(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    log = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gen = profiling.timed_coro("test/stage", _stepper(log))
        out = next(gen)
        try:
            while True:
                # the driver's work between two resumptions
                with torch.profiler.record_function("test/driver"):
                    torch.ones(8).sum()
                out = gen.send(out[0] + 10)
        except StopIteration as stop:
            result = stop.value
    assert log == [10, 11, 12] and result == 33
    events = _trace_events(prof, tmp_path)
    stage, driver, inner = (_spans(events, n) for n in ("test/stage", "test/driver", "test/inner"))
    # one span a resumption: the first step, two sends, the send that ends it
    assert len(stage) == 4 and len(driver) == 3 and len(inner) == 3
    for a, b in driver:
        assert all(b <= s or e <= a for s, e in stage), "a stage span is open while suspended"
    for a, b in inner:
        assert any(s <= a and b <= e for s, e in stage), "the coroutine's work is outside its spans"
    assert profiling.summary()["test/stage"]["calls"] == 4


# ---------------------------------------------------------------------------
# Parts 1-4 of the CLI on the CPU
# ---------------------------------------------------------------------------

# 12 chromosomes of 4-7 scaffolds, 306 bins (part 1 makes 17 groups); four
# brute-forced scaffolds, so that groups of five or more scaffolds run all
# three stages of part 2
SETTINGS = dict(e2e.HMM_SETTINGS, nScaffolds="4", scanScaffolds="3")


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """Parts 1-4 on the CPU: part 1's and part 2's timers and counters, the
    CLI's seconds per part, part 2's ``oracle.cost_function`` calls, and
    the timers after parts 3-4."""
    genome = e2e.make_hmm_genome(640)
    root = tmp_path_factory.mktemp("tracing")
    paths = fixtures.write_hicpro_files(genome, str(root / "hicpro"))
    cfg = e2e.write_config(str(root / "run.cfg"), str(root / "run"), paths,
                           genome.resolution, SETTINGS)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
        base = ["-config", cfg, "-device", "cpu", "-mesh", "off"]
        part1 = cli.main(["-part1"] + base)
        p1 = (profiling.summary(), profiling.counters())
        calls = []
        cost_function = oracle.cost_function

        def counting(*args, **kwargs):
            calls.append(1)
            return cost_function(*args, **kwargs)

        mp.setattr(oracle, "cost_function", counting)
        part2 = cli.main(["-part2"] + base)
        mp.setattr(oracle, "cost_function", cost_function)
        p2 = (profiling.summary(), profiling.counters())
        rest = cli.main(["-part3", "-part4"] + base)
        p34 = profiling.summary()
    finally:
        mp.undo()
        profiling.reset()
    return {"part1": p1, "part2": p2, "part34": p34, "cost_calls": len(calls),
            "seconds": {**part1.part_seconds, **part2.part_seconds, **rest.part_seconds}}


def test_part2_stage_timers_sum_within_part2(cpu_run):
    """The stages' resumptions, the ingest and the pair-table builds are
    disjoint stretches of part 2: their timers sum to at most its wall
    seconds (a stage timer that ran across a ``yield`` also counted the
    other chromosomes' work)."""
    timers, _ = cpu_run["part2"]
    stages = [timers[f"part2/{s}"] for s in ("brute_force", "greedy_insertion", "sliding_window")]
    assert all(t["calls"] > 0 for t in stages)
    disjoint = sum(t["total_s"] for t in stages) + sum(
        timers[f"part2/{s}"]["total_s"] for s in ("ingest", "pair_table_build"))
    assert disjoint <= cpu_run["seconds"]["part2"]


def test_f64_rescore_counts_every_cost_function_call(cpu_run):
    """Every ``oracle.cost_function`` call of part 2 is a re-scored
    candidate, and the timer counts its batches: one a call of the batch
    re-scorer, at most one a candidate."""
    timers, counters = cpu_run["part2"]
    calls = cpu_run["cost_calls"]
    assert calls > 0
    assert counters["part2/f64_rescore_candidates"] == calls
    assert 0 < timers["part2/f64_rescore"]["calls"] <= calls
    assert counters["part2/f64_rescore_elements"] >= calls  # K(K - 1)/2 >= 1 each
    assert counters["part2/f64_rescore_launches"] == 0      # no card: no kernel
    assert counters["part2/f64_rescore_launch_elements"] == 0
    # the matrix goes to the device once a chromosome that re-scores
    assert 0 < timers["part2/f64_upload"]["calls"] <= timers["part2/f64_rescore"]["calls"]
    # the sliding window's misses are some of them; its hits are not counted
    assert counters.get("part2/f64_rescore_miss", 0) <= calls
    assert "part2/f64_rescore_hit" not in counters


def test_f64_bin_orders_time_every_rescoring_call(cpu_run):
    """Every call of the batch re-scorer builds its rows' bin orders under
    ``part2/f64_bin_orders``, memo hits included, so the rows expanded
    number at least the candidates re-scored."""
    timers, counters = cpu_run["part2"]
    assert timers["part2/f64_bin_orders"]["calls"] >= timers["part2/f64_rescore"]["calls"] > 0
    assert counters["part2/f64_bin_order_rows"] >= counters["part2/f64_rescore_candidates"] > 0


def test_part1_spans_lie_in_the_cut_search(cpu_run):
    timers, counters = cpu_run["part1"]
    fits = counters["part1/hmm_fits"]
    assert fits > 0 and timers["part1/log_transform"]["calls"] == 1
    assert timers["part1/hmm_upload"]["calls"] == fits  # fast mode: one upload a fit
    assert timers["part1/hmm_boundary"]["calls"] == fits
    inside = sum(timers[f"part1/{s}"]["total_s"] for s in (
        "log_transform", "hmm_kmeans", "hmm_em", "hmm_decode", "hmm_upload", "hmm_boundary"))
    assert inside <= timers["part1/cut_detection_hmm"]["total_s"]


def test_kmeans_counts_its_lloyd_iterations(cpu_run):
    """Every fit's k-means runs two inits of at least one Lloyd iteration
    each (fast mode)."""
    counters = cpu_run["part1"][1]
    assert counters["part1/kmeans_lloyd_iterations"] >= 2 * counters["part1/hmm_fits"] > 0


def test_copy_counters_read_zero_on_the_cpu(cpu_run):
    assert cpu_run["part1"][1]["part1/pageable_copies"] == 0
    assert cpu_run["part2"][1]["part2/pageable_copies"] == 0


def test_parts_3_and_4_timers(cpu_run):
    timers = cpu_run["part34"]
    assert timers["part3/read_pairs"]["calls"] == 1
    assert timers["part3/orient"]["calls"] == 2
    assert timers["part4/read_draft"]["calls"] == 1 and timers["part4/write"]["calls"] == 1
    assert (timers["part4/read_draft"]["total_s"] + timers["part4/write"]["total_s"]
            <= cpu_run["seconds"]["part4"])


def test_cli_trace_writes_the_program_spans(tmp_path, monkeypatch):
    """``-trace DIR``: one Chrome trace holding the program's spans."""
    genome = fixtures.make_genome(chrom_scaffold_bins=((8, 6, 4), (7, 5, 3)), seed=3)
    paths = fixtures.write_hicpro_files(genome, str(tmp_path / "hicpro"))
    cfg = e2e.write_config(str(tmp_path / "run.cfg"), str(tmp_path / "run"), paths,
                           genome.resolution, {"minSize": "3", "nScaffolds": "3",
                                               "scanScaffolds": "2"})
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg, "-device", "cpu",
              "-mesh", "off", "-trace", str(tmp_path / "trace")])
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    for name in ("part1/upgma", "part1/log_transform", "part2/brute_force",
                 "part2/f64_rescore", "part2/f64_bin_orders", "part3/read_pairs", "part4/write"):
        assert name in names, name


# ---------------------------------------------------------------------------
# The benchmark's readers
# ---------------------------------------------------------------------------


@pytest.fixture
def window(monkeypatch):
    monkeypatch.syspath_prepend(str(HICBENCH))
    import window as window_mod

    return window_mod


def _reader(name):
    spec = importlib.util.spec_from_file_location(
        f"hicbench_metric_{name}", os.path.join(HICBENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _job(window, timers=(), counters=(), parts=("part1", "part2", "part3", "part4")):
    return window.Job(2.0, {p: 0.5 for p in parts}, dict(timers), dict(counters))


@pytest.mark.parametrize("name, timer", [
    ("hmm_boundary_s", "part1/hmm_boundary"),
    ("log_transform_s", "part1/log_transform"),
    ("fasta_write_s", "part4/write"),
    ("f64_rescore_s", "part2/f64_rescore"),
    ("f64_bin_orders_s", "part2/f64_bin_orders"),
])
def test_span_readers(window, name, timer):
    read = _reader(name)
    jobs = [_job(window, {timer: 0.1}), _job(window, {timer: 0.3})]
    assert read(window.Readings(jobs)) == pytest.approx(0.2)
    # the part ran and the span never opened: listed at 0
    assert read(window.Readings([_job(window, {timer: 0.0})])) == 0.0
    # a program without the span, or a run without the part: nothing
    assert read(window.Readings([_job(window)])) is None
    assert read(window.Readings([_job(window, {timer: 0.1}), _job(window)])) is None
    assert read(window.Readings([])) is None


def test_pageable_copies_reader(window):
    read = _reader("pageable_copies")
    jobs = [_job(window, counters={"part1/pageable_copies": 300, "part2/pageable_copies": 4}),
            _job(window, counters={"part1/pageable_copies": 400, "part2/pageable_copies": 0})]
    assert read(window.Readings(jobs)) == pytest.approx(352.0)
    zero = _job(window, counters={"part1/pageable_copies": 0, "part2/pageable_copies": 0})
    assert read(window.Readings([zero])) == 0.0
    only_part1 = _job(window, counters={"part1/pageable_copies": 7}, parts=("part1",))
    assert read(window.Readings([only_part1])) == 7.0
    assert read(window.Readings([_job(window)])) is None
    assert read(window.Readings([])) is None
