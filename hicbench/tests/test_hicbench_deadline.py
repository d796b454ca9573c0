"""Each job's deadline on the CPU: a job past it is stopped and counts as
failed, a stopped warm-up ends the run with no window, a run with no
finished job builds no reference, and a job that swallows the deadline
is ended by the watchdog with a result line.  Each passes a deadline of
2 s to ``run.measure``."""

import argparse
import importlib
import json
import subprocess
import sys
import time

import pytest

from conftest import ROOT

PKG = "hic_genome_assembler_tpu_torch"
WORKLOAD = "hic3k_hmm.assemble"
DEADLINE_S = 2.0


def test_deadline_is_four_windows_and_never_under_two_minutes():
    import run

    assert run.job_deadline(51) == 204.0
    assert run.job_deadline(10) == 120.0
    assert run.job_deadline(0.5) == 120.0


@pytest.fixture
def stuck_jobs(monkeypatch):
    """``cli.main`` replaced: the first ``healthy`` calls run the program,
    later ones sleep in a Python loop until stopped.  Returns the list of
    the stopped calls' seconds."""
    cli = importlib.import_module(f"{PKG}.cli")
    original = cli.main
    stopped = []

    def install(healthy: int):
        calls = []

        def main(argv):
            calls.append(argv)
            if len(calls) <= healthy:
                return original(argv)
            t0 = time.perf_counter()
            try:
                while True:
                    time.sleep(0.01)
            finally:
                stopped.append(time.perf_counter() - t0)

        monkeypatch.setattr(cli, "main", main)
        return stopped

    return install


@pytest.fixture
def references(monkeypatch):
    """Every ``compare.Reference`` built: a spy on the class."""
    import compare

    built = []

    class Spy(compare.Reference):
        def __init__(self, *args, **kwargs):
            built.append(args)
            super().__init__(*args, **kwargs)

    monkeypatch.setattr(compare, "Reference", Spy)
    return built


def measure(small_cell, capsys, trace=0):
    import run

    entry, config, mix, e2e, layer = small_cell(WORKLOAD)
    args = argparse.Namespace(workload=WORKLOAD, seed=5, seconds=1.0, trace=trace)
    sys.modules["matplotlib"] = None
    rc = run.measure(args, entry, config, mix, e2e, layer, "cpu", deadline_s=DEADLINE_S)
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("trace", [0, 1])
def test_job_past_its_deadline_is_stopped_and_builds_no_reference(
        small_cell, capsys, stuck_jobs, references, trace):
    stopped = stuck_jobs(healthy=1)  # the warm-up runs, the window's first job sticks
    rc, result, err = measure(small_cell, capsys, trace)
    assert rc == 0 and result["correct"] is False
    assert len(stopped) == 1 and DEADLINE_S - 0.1 < stopped[0] < DEADLINE_S + 1.0, stopped
    assert result["attempted"] == 1 and result["failed"] == 1
    checks = result["checks"]
    assert "deadline" in checks["job_error"]["value"] and "job 0" in checks["job_error"]["value"]
    assert checks["job_deadline_s"] == {"value": DEADLINE_S, "limit": None}
    assert references == []
    assert "no reference built" in err
    if trace:  # no job finished: no job's metric, though the window's trace is read
        assert not {"part1_s", "part2_s", "setup_s"} & set(result["metrics"])
    else:
        assert set(result["metrics"]) == {"setup_s"}


def test_stopped_warm_up_ends_the_run_with_no_window(small_cell, capsys, stuck_jobs, references):
    stopped = stuck_jobs(healthy=0)
    rc, result, err = measure(small_cell, capsys)
    assert rc == 0 and result["correct"] is False
    assert len(stopped) == 1 and stopped[0] < DEADLINE_S + 1.0
    assert result["attempted"] == 1 and result["failed"] == 1
    assert "job warmup" in result["checks"]["job_error"]["value"]
    assert result["metrics"] == {}  # no window: not even its set-up seconds
    assert "window:" not in err and references == []


SWALLOWING = """
import argparse, importlib, sys, time
sys.path[:0] = ['hicbench', 'hicbench/tests']
sys.modules['matplotlib'] = None
import run, window
from conftest import SMALL, cell
window.GRACE_S = 1.0
cli = importlib.import_module('{pkg}.cli')
original, calls = cli.main, []

def main(argv):
    calls.append(argv)
    if len(calls) <= {healthy}:
        return original(argv)
    while True:  # the deadline is caught, every time
        try:
            while True:
                time.sleep(0.01)
        except window.JobDeadline:
            pass

cli.main = main
e, c, m, a, l = cell('{workload}')
c['genome'].update(SMALL['{workload}'])
args = argparse.Namespace(workload='{workload}', seed=3, seconds=1.0, trace=0)
run.measure(args, e, c, m, a, l, 'cpu', deadline_s={deadline})
print('not reached')
"""


@pytest.mark.parametrize("healthy", [0, 1], ids=["warm-up", "window"])
def test_watchdog_ends_a_job_that_swallows_its_deadline(healthy):
    code = SWALLOWING.format(pkg=PKG, healthy=healthy, workload=WORKLOAD, deadline=DEADLINE_S)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert len(lines) == 1, proc.stdout
    result = json.loads(lines[0])
    assert result["correct"] is False
    assert result["attempted"] == 1 and result["failed"] == 1
    assert set(result["metrics"]) == ({"setup_s"} if healthy else set())
    error = result["checks"]["job_error"]["value"]
    assert "deadline" in error and ("job 0" if healthy else "job warmup") in error
    assert result["checks"]["job_deadline_s"] == {"value": DEADLINE_S, "limit": None}
    assert list(result)[-1] == "checks"
    assert "reference:" not in proc.stderr
