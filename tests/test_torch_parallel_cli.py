"""The port's CLI on a virtual mesh, and part 2's chromosome sharding
across processes (EP), against the JAX package and the single-process run.

* ``-mesh 4x2 -device cpu``, parts 1-4, in exact mode and in
  ``matrixMode = device`` with ``_HOST_N = 0``: every file-bus file and the
  FASTA byte-equal to the JAX CLI's ``-mesh 4x2`` run (8 virtual CPU
  devices) and to the port's ``-mesh off`` run;
* EP: rank 1 then rank 0 in this process, two real jax-free processes,
  stale shards, a staggered launch, and EP on a (2, 2) virtual mesh in
  each process; every merged order and plot-order file byte-equal to the
  single-process run.
"""

import filecmp
import json
import os
import subprocess
import sys
import time

import pytest

from hic_genome_assembler_tpu import cli as jax_cli
from hic_genome_assembler_tpu.cluster import breakpoints as jax_bp
from hic_genome_assembler_tpu.models import part1_cluster as jax_part1
from hic_genome_assembler_tpu.models import part2_order as jax_part2
from hic_genome_assembler_tpu.parallel import distributed as jax_distributed
from hic_genome_assembler_tpu.utils import fixtures
from hic_genome_assembler_tpu.viz import plot as plot_mod
from hic_genome_assembler_tpu_torch import cli
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
from hic_genome_assembler_tpu_torch.models import part2_order
from hic_genome_assembler_tpu_torch.parallel import distributed
from hic_genome_assembler_tpu_torch.utils import e2e
from hic_genome_assembler_tpu_torch.viz import plot as torch_plot_mod

import torch  # noqa: E402  (after the packages, as the other port tests)

CPU = torch.device("cpu")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = (
    "dendrogramOrder.txt",
    "binGroupings.txt",
    "clusterAssessment.txt",
    "chromosomeGroupings.txt",
    "chromosomeOrdering.txt",
    "plotOrder.txt",
    "finalChromosomeOrdering.txt",
    "assembled.fasta",
)
PARTS = ["-part1", "-part2", "-part3", "-part4"]
SETTINGS = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4", "scanScaffolds": "3"}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    monkeypatch.setattr(plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setenv("HIC_JAX_CACHE", "off")
    monkeypatch.delenv("HIC_MESH", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)


@pytest.fixture(scope="module")
def fixture_genome(tmp_path_factory):
    """The pipeline tests' genome: 3 chromosomes, 123 bins."""
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13, noise=0.005, cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, str(tmp_path_factory.mktemp("hicpro")))
    return genome, paths


# -- (i) the CLI on a virtual mesh ---------------------------------------------------


@pytest.mark.parametrize("mode", ["exact", "device"])
def test_cli_mesh_4x2_byte_equal_to_jax_and_mesh_off(fixture_genome, tmp_path, monkeypatch, mode):
    genome, paths = fixture_genome
    settings = dict(SETTINGS, matrixMode=mode)
    if mode == "device":
        monkeypatch.setattr(bp, "_HOST_N", 0)
        monkeypatch.setattr(jax_bp, "_HOST_N", 0)

    def config(tag):
        return e2e.write_config(
            str(tmp_path / f"{tag}.cfg"), str(tmp_path / tag), paths, genome.resolution, settings
        )

    report = cli.main(PARTS + ["-config", config("mesh"), "-device", "cpu", "-mesh", "4x2"])
    off = cli.main(PARTS + ["-config", config("off"), "-device", "cpu", "-mesh", "off"])
    jax_cli.main(PARTS + ["-config", config("jax"), "-mesh", "4x2"])
    assert report.rank_counts_on == "mesh 4x2 cpu"
    assert off.rank_counts_on == ("cpu" if mode == "device" else "host")
    assert report.cut_indices == off.cut_indices
    for name in FILES:
        ours = os.path.join(tmp_path, "mesh", "files", name)
        for other in ("off", "jax"):
            theirs = os.path.join(tmp_path, other, "files", name)
            assert filecmp.cmp(ours, theirs, shallow=False), (name, other)
    truth = e2e.truth_checks(genome, os.path.join(tmp_path, "mesh", "files"))
    assert truth["groups_match_truth"]


# -- (j) chromosome sharding across processes ------------------------------------------


@pytest.fixture(scope="module")
def ep_setup(tmp_path_factory):
    """test_ep_distributed.py's genome and settings; part 1 by the JAX
    package, then the port's single-process part 2 as the reference."""
    work = tmp_path_factory.mktemp("ep")
    g = fixtures.make_genome(chrom_scaffold_bins=((6, 5, 4), (5, 4, 3), (4, 3, 2)), seed=23)
    paths = fixtures.write_hicpro_files(g, str(work / "data"))
    single = work / "single"
    single.mkdir()
    f = lambda name: str(single / name)  # noqa: E731
    jax_part1.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        f("dendro.txt"), "", "", f("bingroups.txt"), f("assessment.txt"), f("chromgroups.txt"),
        hyper_geom=True, hmm=False, min_size=5, modularity=0, louvain_rounds=3, psig=0.05,
        convergence_rounds=5, look_ahead=0.2, resolution=g.resolution,
    )
    _part2(g, paths, f("chromgroups.txt"), f("chromorder.txt"), f("plotorder.txt"))
    want = {name: (single / name).read_bytes() for name in ("chromorder.txt", "plotorder.txt")}
    return g, paths, work, f("chromgroups.txt"), want


def _part2(g, paths, groups, order, plot, **kwargs):
    return part2_order.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], groups, order, "", "", "", "ep", plot,
        n_scaffolds=3, scan_scaffolds=2, resolution=g.resolution, device=CPU, **kwargs,
    )


def _merged(out):
    return {name: open(os.path.join(out, name), "rb").read()
            for name in ("chromorder.txt", "plotorder.txt")}


# A rank of part 2 in its own process, with jax and scikit-learn unimportable.
_RANK_SCRIPT = r"""
import importlib.abc, json, sys

class _NotInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "sklearn"):
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _NotInstalled())
sys.path.insert(0, sys.argv[1])
args = json.loads(sys.argv[2])
import torch
from hic_genome_assembler_tpu_torch.models import part2_order
from hic_genome_assembler_tpu_torch.parallel import mesh as pm

cpu = torch.device("cpu")
mesh = None
if args["mesh"]:
    rows, cols = args["mesh"]
    mesh = pm.make_mesh((rows, cols), [cpu] * (rows * cols))
part2_order.run_pipeline(
    *args["files"], "", "", "", "ep", args["plot"],
    n_scaffolds=3, scan_scaffolds=2, resolution=args["resolution"], device=cpu,
    mesh=mesh, process_index=args["rank"], process_count=2, shard_wait_s=300.0,
)
print("LOADED", sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "sklearn")))
"""


def _start_rank(g, paths, groups, out, rank, mesh=None):
    args = {
        "files": [paths["bed"], paths["bias"], paths["matrix"], groups,
                  os.path.join(out, "chromorder.txt")],
        "plot": os.path.join(out, "plotorder.txt"),
        "resolution": g.resolution, "rank": rank, "mesh": mesh,
    }
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    return subprocess.Popen(
        [sys.executable, "-c", _RANK_SCRIPT, REPO, json.dumps(args)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=out,
    )


def _finish(procs):
    try:
        for p in procs:
            out = p.communicate(timeout=300)[0]
            assert p.returncode == 0, out[-3000:]
            assert "LOADED []" in out
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def _run_ranks(ep_setup, tag, mesh=None):
    g, paths, work, groups, _want = ep_setup
    out = str(work / tag)
    os.makedirs(out, exist_ok=True)
    _finish([_start_rank(g, paths, groups, out, rank, mesh) for rank in (0, 1)])
    return out


def test_ep_in_process_rank1_then_rank0(ep_setup, tmp_path):
    g, paths, _work, groups, want = ep_setup
    order, plot = str(tmp_path / "chromorder.txt"), str(tmp_path / "plotorder.txt")
    _part2(g, paths, groups, order, str(tmp_path / "plot_p1.txt"),
           process_index=1, process_count=2)
    assert os.path.exists(order + ".shard1") and not os.path.exists(order)
    # the JAX package's rank 1 writes the same shard, byte for byte
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    jax_part2.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], groups, str(jax_dir / "chromorder.txt"),
        "", "", "", "ep", str(jax_dir / "plot.txt"), n_scaffolds=3, scan_scaffolds=2,
        resolution=g.resolution, process_index=1, process_count=2,
    )
    assert (jax_dir / "chromorder.txt.shard1").read_bytes() == open(order + ".shard1", "rb").read()
    fp = jax_distributed.run_fingerprint(
        groups, 3, 2, g.resolution, 2, data_files=(paths["bed"], paths["bias"], paths["matrix"]))
    assert distributed.shard_fingerprint(order + ".shard1") == fp
    _part2(g, paths, groups, order, plot, process_index=0, process_count=2, shard_wait_s=5)
    assert _merged(str(tmp_path)) == want


def test_ep_two_jax_free_processes(ep_setup):
    assert _merged(_run_ranks(ep_setup, "mp")) == ep_setup[4]


def test_ep_stale_shards_ignored(ep_setup):
    """Leftover shards, an hour old or written just now, never reach the
    merge: the barrier takes only shards with this run's fingerprint."""
    work = ep_setup[2]
    out = str(work / "mp_stale")
    os.makedirs(out, exist_ok=True)
    for p, age in ((0, 3600.0), (1, 0.0)):
        path = os.path.join(out, f"chromorder.txt.shard{p}")
        with open(path, "w") as fh:
            fh.write("#run deadbeef\n### Chromosome grouping 1 ###\nSTALE_SCAFFOLD\t+\n")
        if age:
            old = time.time() - age
            os.utime(path, (old, old))
    merged = _merged(_run_ranks(ep_setup, "mp_stale"))
    assert b"STALE_SCAFFOLD" not in merged["chromorder.txt"]
    assert merged == ep_setup[4]


def test_ep_staggered_launch(ep_setup):
    """Rank 1 finishes before rank 0 starts; rank 0 keeps its shard."""
    g, paths, work, groups, want = ep_setup
    out = str(work / "mp_staggered")
    os.makedirs(out, exist_ok=True)
    _finish([_start_rank(g, paths, groups, out, 1)])
    shard1 = os.path.join(out, "chromorder.txt.shard1")
    old = time.time() - 120.0
    os.utime(shard1, (old, old))
    _finish([_start_rank(g, paths, groups, out, 0)])
    assert _merged(out) == want


def test_ep_with_virtual_mesh_in_each_process(ep_setup):
    assert _merged(_run_ranks(ep_setup, "mp_mesh", mesh=[2, 2])) == ep_setup[4]
