"""The port runs where jax is not installed (as on the GPU machines).

A subprocess whose import hook makes ``import jax`` (and matplotlib and
scikit-learn, which the GPU machines lack too) fail runs the port's CLI on
a small fixture, once on the default branch and once with ``hmm = True``;
it must succeed, skip its plots with one notice, and leave none of those
modules loaded.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib.abc, json, sys

BLOCKED = ("jax", "jaxlib", "matplotlib", "sklearn")

class _NotInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _NotInstalled())
sys.path.insert(0, sys.argv[1])
workdir = sys.argv[2]
settings = json.loads(sys.argv[3])

from hic_genome_assembler_tpu.utils import fixtures
from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.cluster import breakpoints
from hic_genome_assembler_tpu_torch.utils import e2e

breakpoints._HOST_N = 0  # run the device count path (plain torch on the CPU)
genome = fixtures.make_genome(seed=3)
paths = fixtures.write_hicpro_files(genome, workdir + "/hicpro")
cfg = e2e.write_config(workdir + "/c.cfg", workdir, paths, genome.resolution,
                       dict({"minSize": "5", "nScaffolds": "4", "scanScaffolds": "3"}, **settings))
report = cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg, "-device", "cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("RESULT " + json.dumps({"loaded": loaded, "rank": report.rank_counts_on}))
"""


def _run(tmp_path, settings):
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(tmp_path), json.dumps(settings)],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=env,
    )
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.count("plots skipped: matplotlib not installed") == 1
    assert os.path.getsize(tmp_path / "files" / "assembled.fasta") > 0
    return proc.stdout, json.loads(proc.stdout.split("RESULT ", 1)[1])


def test_port_cli_runs_without_jax(tmp_path):
    _out, result = _run(tmp_path, {})
    assert result == {"loaded": [], "rank": "cpu"}


def test_port_hmm_cli_runs_without_jax_or_sklearn(tmp_path):
    out, result = _run(tmp_path, {"hyperGeom": "False", "hmm": "True", "modularity": ".05"})
    assert result == {"loaded": [], "rank": None}
    assert "Working on iterative 2 state HMMs" in out
