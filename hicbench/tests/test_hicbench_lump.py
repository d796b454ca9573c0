"""The 16K hypergeometric cell on its one lumping map
(``hic16k_hypergeom_lump.assemble``): the recipe, the readers of its
re-scoring metrics, and a small-recipe run on the CPU."""

import argparse
import json
import os
import sys

import pytest

from conftest import BENCH, SMALL

CELL = "hic16k_hypergeom_lump.assemble"
LUMP_MAP = 4300000005


def _recipe(name):
    with open(os.path.join(BENCH, "configs", name + ".json")) as fh:
        return json.load(fh)


def test_recipe_is_the_16k_recipe_on_one_map():
    """Every key of the 16K recipe, byte for byte, plus the pinned map and
    the line saying why; the same cuts."""
    old, new = _recipe("hic16k_hypergeom"), _recipe("hic16k_hypergeom_lump")
    assert new["genome"].pop("map_seeds") == [LUMP_MAP]
    assert new["assumed"].pop("maps")
    assert new == old
    assert new["reduced"] == ["sequence_bp_per_bin", "plots"]


@pytest.mark.parametrize("seed", (0, 5, 2 ** 31 + 77, LUMP_MAP, 9876543210))
def test_every_seed_assembles_the_lumping_map(seed):
    import genome

    assert genome.pool(_recipe("hic16k_hypergeom_lump")["genome"], seed) == [LUMP_MAP]


def test_cell_and_its_metrics_in_the_benchmark():
    import run

    entry, config, mix, e2e, layer = run.cell(CELL)
    assert entry["chips"] == 1 and entry["config"] == "hic16k_hypergeom_lump"
    assert {m["name"] for m in e2e} == {"job_s", "setup_s"}
    assert {m["name"] for m in layer} == {"f64_rescore_candidates", "f64_rescore_roofline",
                                          "rank_counts_roofline"}


def _reader(name):
    import run

    return run.reader(name)


def _job(counters=None):
    import window

    return window.Job(3.0, {"part1": 1.0, "part2": 1.0}, {}, dict(counters or {}))


class _Trace:
    """A stand-in for ``tracing.Trace``: ``n`` events of the kernel over
    ``seconds`` of device time."""

    def __init__(self, n, seconds):
        self.n, self.seconds = n, seconds

    def kernel(self, fragment):
        assert fragment == "f64_rescore_kernel"
        return self.n, self.seconds


def test_candidates_reader():
    import window

    read = _reader("f64_rescore_candidates")
    jobs = [_job({"part2/f64_rescore_candidates": 900}), _job({"part2/f64_rescore_candidates": 0})]
    assert read(window.Readings(jobs)) == pytest.approx(450.0)
    # a program without the counter, or no job: nothing
    assert read(window.Readings([_job()])) is None
    assert read(window.Readings([jobs[0], _job()])) is None
    assert read(window.Readings([])) is None


def _counters(launches, launch_elements, bins, elements):
    return {"part2/f64_rescore_launches": launches,
            "part2/f64_rescore_launch_elements": launch_elements,
            "part2/f64_rescore_bins": bins, "part2/f64_rescore_elements": elements}


def test_roofline_reader():
    """The least time is the bytes' (8 for each element a launch reads at
    least, 4 a bin-order entry, at HBM's rate) where they exceed the adds'
    (one an element summed, at half the f64 operations a second), and the
    adds' where a launch's many candidates sum more than its bytes take;
    over the kernel's device time."""
    import bounds
    import window

    read = _reader("f64_rescore_roofline")
    jobs = [_job(_counters(3, 3_000_000, 2_000, 6_000_000)),
            _job(_counters(1, 1_000_000, 1_000, 4_000_000))]
    least = (8 * 4_000_000 + 4 * 3_000) / bounds.HBM_BYTES_PER_S
    assert least > 10_000_000 / (bounds.FP64_OPS_PER_S / 2)
    assert read(window.Readings(jobs, _Trace(4, 2 * least))) == pytest.approx(50.0)
    # 64 candidates of one launch: the adds take longer than the bytes
    wide = [_job(_counters(1, 1_000_000, 64_000, 64_000_000))]
    least = 64_000_000 / (bounds.FP64_OPS_PER_S / 2)
    assert least > (8 * 1_000_000 + 4 * 64_000) / bounds.HBM_BYTES_PER_S
    assert read(window.Readings(wide, _Trace(1, 4 * least))) == pytest.approx(25.0)
    # no trace, a program without the counters, no launch: nothing
    assert read(window.Readings(jobs)) is None
    assert read(window.Readings([_job()], _Trace(0, 0.0))) is None
    assert read(window.Readings([_job(_counters(0, 0, 0, 0))], _Trace(0, 0.0))) is None


def test_roofline_reader_raises_when_the_trace_lost_events():
    import window

    read = _reader("f64_rescore_roofline")
    jobs = [_job(_counters(3, 3_000_000, 2_000, 6_000_000))]
    with pytest.raises(RuntimeError, match="2 f64_rescore events for 3 launches"):
        read(window.Readings(jobs, _Trace(2, 0.001)))


def test_small_recipe_run_is_correct(capsys):
    """The cell's harness on the CPU at the 16K recipe's small cut (its first
    3 chromosomes, 10 scaffolds each) on the lumping map: correct, both
    end-to-end metrics reported."""
    import run

    entry, config, mix, e2e, layer = run.cell(CELL)
    config["genome"].update(SMALL["hic16k_hypergeom.assemble"])
    args = argparse.Namespace(workload=CELL, seed=2 ** 33 + 5, seconds=1.0, trace=0)
    sys.modules["matplotlib"] = None
    rc = run.measure(args, entry, config, mix, e2e, layer, "cpu")
    out, _err = capsys.readouterr()
    result = json.loads(out.strip().splitlines()[-1])
    assert rc == 0 and result["correct"] is True, result
    assert set(result["metrics"]) == {"job_s", "setup_s"}
    assert result["failed"] == 0
