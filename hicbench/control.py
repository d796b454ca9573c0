"""The control of the comparison: the plain reference computed in float32
(one precision below the configuration's float64), put in the assembler's
place, and judged by the float64 reference as a run judges a job.  It has
to come out not correct.

    python3 hicbench/control.py --workload <config>.<mix> --seeds 1 2 3

Prints one JSON line for each seed and map of the run's pool
(``genome.pool``), with each number compared beside its limit.
Needs no card: the reference is NumPy and SciPy on the host.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import compare  # noqa: E402
import genome  # noqa: E402
import run  # noqa: E402


def control(config: dict, seed: int, workdir: str, map_seed: int) -> dict:
    """The control's numbers on the genome of ``seed`` and ``map_seed``."""
    g = genome.make(config["genome"], seed % (1 << 63), map_seed=map_seed)
    paths = genome.write_hicpro(g, os.path.join(workdir, "hicpro"))
    del g
    compare.write_outputs(compare.Reference(paths, config, np.float32),
                          os.path.join(workdir, "control", "files"))
    ok, numbers = compare.judge_jobs(compare.Reference(paths, config, np.float64),
                                     [os.path.join(workdir, "control")])
    return {"seed": seed, "map_seed": map_seed, "correct": ok,
            "checks": {k: {"value": v, "limit": compare.LIMITS.get(k)} for k, v in numbers.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    _entry, config, _mix, _e2e, _layer = run.cell(args.workload)
    for seed in args.seeds:
        for map_seed in genome.pool(config["genome"], seed % (1 << 63)):
            tmp = tempfile.mkdtemp(prefix="hicbench-control-")
            try:
                print(json.dumps(control(config, seed, tmp, map_seed)), flush=True)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
