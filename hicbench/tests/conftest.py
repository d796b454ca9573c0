"""CPU tests of the benchmark harness (``python -m pytest hicbench/tests``).

Small genomes of each configuration's recipe, run through the harness's
own code on ``-device cpu``; tests marked ``gpu`` need the card.
"""

import os
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)
for path in (BENCH, ROOT):
    if path not in sys.path:
        sys.path.insert(0, path)

# each configuration's recipe cut to a few hundred bins: the 16K recipe's
# first 3 chromosomes with 10 scaffolds each, the HMM recipe's first 4
SMALL = {
    "hic16k_hypergeom.assemble": {"chromosomes": 3, "scaffolds": 10, "scale": 4},
    "hic3k_hmm.assemble": {"chromosomes": 4, "stretch": 0.6},
}


# the 16K recipe runs no cell of BENCHMARK.json yet (PERF.md, Open
# questions); its hypergeometric path stays under test as this cell
CELL_16K = {"name": "hic16k_hypergeom.assemble", "config": "hic16k_hypergeom",
            "traffic": "assemble", "chips": 1}
HMM_ONLY = ("hmm_kmeans_s", "hmm_forward_backward_roofline")


def cell(workload):
    """``run.cell`` over BENCHMARK.json with the 16K cell added, reading
    every per-layer metric but the HMM branch's."""
    import run

    bench = run.benchmark()
    bench["workloads"].append(dict(CELL_16K))
    for m in bench["per_layer"]:
        if m["name"] not in HMM_ONLY:
            m["workloads"] = m["workloads"] + [CELL_16K["name"]]
    return run.cell(workload, bench)


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA GPU and nvcc; skips without one")


@pytest.fixture
def small_cell():
    """(entry, config, mix, end_to_end, per_layer) of a cell, its genome
    cut to the small recipe."""
    def make(workload):
        entry, config, mix, e2e, layer = cell(workload)
        config["genome"].update(SMALL[workload])
        return entry, config, mix, e2e, layer

    return make
