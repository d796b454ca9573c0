"""The port runs where neither jax nor the JAX package is installed (as on
the GPU machines).

A subprocess whose import hook makes ``import jax`` and ``import
hic_genome_assembler_tpu`` (and matplotlib and scikit-learn, which the GPU
machines lack too) fail makes its fixture through the port's own copy of
the fixtures module and runs the port's CLI on
a small fixture: on the default branch, with ``hmm = True``, and on a
``-mesh 2x2`` virtual CPU mesh; it must succeed, skip its plots with one
notice, and leave none of those modules loaded.  Then two such processes
run part 2 as one EP pair (``RANK`` 0 and 1, ``WORLD_SIZE`` 2, a gloo
rendezvous on localhost) and merge to the single-process files.
"""

import json
import os
import socket
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCK = r"""
import importlib.abc, json, sys

BLOCKED = ("jax", "jaxlib", "matplotlib", "sklearn", "hic_genome_assembler_tpu")

class _NotInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _NotInstalled())
sys.path.insert(0, sys.argv[1])
"""

_SCRIPT = _BLOCK + r"""
workdir = sys.argv[2]
settings = json.loads(sys.argv[3])
extra = json.loads(sys.argv[4])

from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.cluster import breakpoints
from hic_genome_assembler_tpu_torch.utils import e2e, fixtures

breakpoints._HOST_N = 0  # run the device count path (plain torch on the CPU)
genome = fixtures.make_genome(seed=3)
paths = fixtures.write_hicpro_files(genome, workdir + "/hicpro")
cfg = e2e.write_config(workdir + "/c.cfg", workdir, paths, genome.resolution,
                       dict({"minSize": "5", "nScaffolds": "4", "scanScaffolds": "3"}, **settings))
report = cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg, "-device", "cpu"]
                  + extra)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("RESULT " + json.dumps({"loaded": loaded, "rank": report.rank_counts_on}))
"""

# one EP rank: the CLI's part 2 to 4 on an existing config
_EP_SCRIPT = _BLOCK + r"""
from hic_genome_assembler_tpu_torch import cli
cli.main(["-part2", "-part3", "-part4", "-config", sys.argv[2], "-device", "cpu"])
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("RESULT " + json.dumps({"loaded": loaded}))
"""


def _env():
    return {k: v for k, v in os.environ.items()
            if not k.startswith(("JAX_", "XLA_")) and k not in ("HIC_MESH", "WORLD_SIZE", "RANK")}


def _run(tmp_path, settings, extra=()):
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT, REPO, str(tmp_path), json.dumps(settings),
         json.dumps(list(extra))],
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path), env=_env(),
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


def test_port_mesh_cli_runs_without_jax(tmp_path):
    out, result = _run(tmp_path, {}, ["-mesh", "2x2"])
    assert result == {"loaded": [], "rank": "mesh 2x2 cpu"}
    assert "- Parallel runtime: 1 devices, mesh {'data': 2, 'model': 2}, process 0/1" in out


def test_port_ep_pair_runs_without_jax(tmp_path):
    _run(tmp_path, {})
    files = tmp_path / "files"
    want = {name: (files / name).read_bytes()
            for name in ("chromosomeOrdering.txt", "plotOrder.txt", "assembled.fasta")}
    for name in want:
        (files / name).unlink()
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(_env(), WORLD_SIZE="2", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _EP_SCRIPT, REPO, str(tmp_path / "c.cfg")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(tmp_path),
            env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)),
        )
        for rank in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
        assert json.loads(out.split("RESULT ", 1)[1]) == {"loaded": []}
    assert "- EP shard: process 0/2 owns chromosomes [1]" in outs[0]
    assert "- Parts 3 and 4 run on process 0 only" in outs[1]
    for name, data in want.items():
        assert (files / name).read_bytes() == data, name
