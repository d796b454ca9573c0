"""The harness end to end on the CPU at a small genome: the window, the
metric readers, the reference, the result line, and what the command does
without a card or without the program."""

import argparse
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SMALL

CELLS = sorted(SMALL)


def measure(small_cell, capsys, workload, trace, seed=5, seconds=1.0):
    import run

    entry, config, mix, e2e, layer = small_cell(workload)
    args = argparse.Namespace(workload=workload, seed=seed, seconds=seconds, trace=trace)
    sys.modules["matplotlib"] = None
    rc = run.measure(args, entry, config, mix, e2e, layer, "cpu")
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("workload", CELLS)
def test_untraced_run_is_correct_and_reports_end_to_end(small_cell, capsys, workload):
    rc, result, err = measure(small_cell, capsys, workload, trace=0)
    assert rc == 0 and result["correct"] is True, result
    assert set(result["metrics"]) == {"job_s", "setup_s"}
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert list(result)[-1] == "checks"
    assert result["checks"]["job_deadline_s"] == {"value": 120.0, "limit": None}
    assert all(v["value"] <= v["limit"] for v in result["checks"].values()
               if v["limit"] is not None)
    assert err.strip().splitlines()[-1].startswith("check ")


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_every_listed_layer_metric(small_cell, capsys, workload):
    rc, result, _ = measure(small_cell, capsys, workload, trace=1)
    assert rc == 0 and result["correct"] is True
    _, _, _, _, layer = small_cell(workload)
    # no device ran on the CPU: the rooflines have nothing to read
    want = {m["name"] for m in layer if not m["name"].endswith("_roofline")}
    assert want <= set(result["metrics"]), want - set(result["metrics"])
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_same_seed_same_genome_files(tmp_path):
    import genome
    import run

    _, config, *_ = run.cell("hic3k_hmm.assemble")
    config["genome"].update(SMALL["hic3k_hmm.assemble"])
    a = genome.write_hicpro(genome.make(config["genome"], 2 ** 31 + 77), str(tmp_path / "a"))
    b = genome.write_hicpro(genome.make(config["genome"], 2 ** 31 + 77), str(tmp_path / "b"))
    c = genome.write_hicpro(genome.make(config["genome"], 2 ** 31 + 78), str(tmp_path / "c"))
    for k in a:
        with open(a[k], "rb") as x, open(b[k], "rb") as y:
            assert x.read() == y.read(), k
    with open(a["fasta"], "rb") as x, open(c["fasta"], "rb") as z:
        assert x.read() != z.read()


def test_command_fails_without_a_card():
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload", "hic3k_hmm.assemble",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_run_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, a
    run ends with an error and no result line."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "hicbench", ignore=shutil.ignore_patterns("__pycache__"))
    code = (
        "import argparse, sys; sys.path.insert(0, 'hicbench'); sys.modules['matplotlib'] = None\n"
        "import run\n"
        "e, c, m, a, l = run.cell('hic3k_hmm.assemble')\n"
        "c['genome'].update(chromosomes=2, stretch=0.5)\n"
        "args = argparse.Namespace(workload='hic3k_hmm.assemble', seed=1, seconds=1, trace=0)\n"
        "sys.exit(run.measure(args, e, c, m, a, l, 'cpu'))\n")
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=300, cwd=tmp_path, env=env)
    assert proc.returncode != 0
    assert "hic_genome_assembler_tpu_torch" in proc.stderr
    assert "{" not in proc.stdout


def _top_level_modules(code: str) -> set:
    proc = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                           "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(json.loads(proc.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    code = (
        "import argparse, glob, os, sys; sys.path[:0] = ['hicbench', 'hicbench/tests']\n"
        "sys.modules['matplotlib'] = None\n"
        "import run, control, tracing, bounds\n"
        "from conftest import cell\n"
        "for f in glob.glob('hicbench/metrics/*.py'): run.reader(os.path.basename(f)[:-3])\n"
        "e, c, m, a, l = cell('hic16k_hypergeom.assemble')\n"
        "c['genome'].update(chromosomes=2, scaffolds=8, scale=4)\n"
        "args = argparse.Namespace(workload='hic16k_hypergeom.assemble', seed=1, seconds=0.5, trace=1)\n"
        "run.measure(args, e, c, m, a, l, 'cpu')\n")
    loaded = _top_level_modules(code)
    assert "hic_genome_assembler_tpu_torch" in loaded  # the program ran
    assert not loaded & {"jax", "jaxlib", "flax", "hic_genome_assembler_tpu"}


def test_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules("import sys; sys.path.insert(0, 'hicbench')\n"
                                "import reference, compare")
    assert not loaded & {"hic_genome_assembler_tpu_torch", "hic_genome_assembler_tpu",
                         "torch", "jax"}


@pytest.mark.gpu
def test_cell_on_the_card(tmp_path):
    """One short run of each cell on the card: correct, with its metrics."""
    import run
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in [w["name"] for w in run.benchmark()["workloads"]]:
        proc = subprocess.run(
            [sys.executable, os.path.join(BENCH, "run.py"), "--workload", workload,
             "--seed", "11", "--seconds", "1", "--trace", "0"],
            capture_output=True, text=True, timeout=1200, cwd=ROOT)
        assert proc.returncode == 0, proc.stderr[-3000:]
        result = json.loads(proc.stdout.strip().splitlines()[-1])
        assert result["correct"] is True and result["device"]["platform"] == "gpu"
