"""The port's graft entry (``__graft_entry_torch__.py``) against the JAX
package's (``__graft_entry__.py``), on the CPU.

``entry(device="cpu")``'s scores must lie within ``score_kernels.sum_bound``
(16 non-negative float32 terms a score: 15 pairs and ``c0``) of the JAX
block kernel's on the JAX ``entry()``'s arguments at its scorer's table
width, with the same argmax; the JAX ``entry`` itself passes a narrower
width, and a second test shows that this stride is the whole difference.
The dry run's file buses at n = 1, 2, 4 and 8 positions (the mesh,
mesh-less, EP and EP-on-submesh runs) must be byte-equal to the JAX
package's mesh-less parts 1-2 on the same fixture and arguments.  Then the
dry run itself, its refusal of ``cuda`` without a card, its round-robin
positions over the cards, and a subprocess that runs it with jax, the JAX
package, scikit-learn and matplotlib unimportable.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import __graft_entry__ as jax_graft
import __graft_entry_torch__ as graft
from hic_genome_assembler_tpu.models import part1_cluster as jax_part1
from hic_genome_assembler_tpu.models import part2_order as jax_part2
from hic_genome_assembler_tpu.ops import cost as jax_cost
from hic_genome_assembler_tpu.utils import fixtures as jax_fixtures
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_scores_close(got, want):
    assert got.shape == want.shape == (360, 64)
    assert got.dtype == want.dtype == np.float32
    assert np.all(np.abs(got.astype(np.float64) - want) <= sk.sum_bound(16, np.abs(want)))
    assert int(np.argmax(got)) == int(np.argmax(want))


def test_entry_equals_jax_scorer_on_the_jax_entry_inputs():
    """The port's step against the JAX ``_block_score_kernel`` on the JAX
    entry's own arguments, at its scorer's table width (``C_pad + 1``, as
    ``BlockScorer.score_batch`` passes it), and against the f64 host score
    of the best candidate."""
    fn, args = graft.entry(device="cpu")
    assert fn is sk.block_scores
    F_flat, sizes, orders, orients, c0 = args
    assert all(a.device.type == "cpu" for a in args)
    assert orders.dtype == orients.dtype == torch.int32
    assert tuple(orders.shape) == (360, 6) and tuple(orients.shape) == (64, 6)
    got = fn(*args).numpy()
    _jfn, jargs = jax_graft.entry()
    width = int(jargs[0].shape[0]) // (4 * int(jargs[1].shape[0]) ** 2)
    assert width == 257  # C_pad + 1 of C = 132 bins
    _assert_scores_close(got, np.asarray(jax_cost._block_score_kernel(*jargs, width)))
    rng = np.random.default_rng(0)
    sizes_list = [40, 32, 24, 16, 12, 8]
    m = rng.random((132, 132))
    scorer = jax_cost.BlockScorer(m + m.T, sizes_list, dtype=np.float32)
    o, r = np.unravel_index(int(np.argmax(got)), got.shape)
    exact = scorer.score_host(orders[o].numpy(), orients[r].numpy())
    assert abs(float(got[o, r]) - exact) <= sk.sum_bound(16, exact) + 2.0**-24 * exact


def test_jax_entry_reads_its_table_at_width_c_plus_1():
    """The JAX entry's ``fn(*args)`` passes ``Cp1 = C + 1`` (133) to a table
    ``C_pad + 1`` (257) wide: the port's kernel on the same table cut to
    its first ``4 * Sp * Sp * 133`` values, where it reads the width 133,
    gives the JAX entry's numbers.  So the two entries differ by that
    stride alone, and the port's entry keeps the table's own width."""
    fn, args = graft.entry(device="cpu")
    jfn, jargs = jax_graft.entry()
    Sp = int(args[1].shape[0])
    cut = args[0][: 4 * Sp * Sp * 133].contiguous()
    _assert_scores_close(fn(cut, *args[1:]).numpy(), np.asarray(jfn(*jargs)))


@pytest.fixture(scope="module")
def jax_bus(tmp_path_factory):
    """The JAX package's mesh-less parts 1-2 on the dry run's fixture, with
    the JAX dry run's arguments (``__graft_entry__.py:106-128``)."""
    work = tmp_path_factory.mktemp("jax_dryrun")
    g = jax_fixtures.make_genome(chrom_scaffold_bins=((5, 4, 3, 2, 2), (4, 3, 2)), seed=11)
    paths = jax_fixtures.write_hicpro_files(g, str(work / "data"))
    f = lambda name: str(work / name)  # noqa: E731
    jax_part1.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], paths["sizes"],
        f("dendro.txt"), "", "", f("bingroups.txt"), f("assessment.txt"), f("chromgroups.txt"),
        hyper_geom=True, hmm=False, min_size=5, modularity=0, louvain_rounds=3, psig=0.05,
        convergence_rounds=5, look_ahead=0.2, resolution=g.resolution, mesh=None,
    )
    jax_part2.run_pipeline(
        paths["bed"], paths["bias"], paths["matrix"], f("chromgroups.txt"),
        f("chromorder.txt"), "", "", "", "dryrun", f("plotorder.txt"),
        n_scaffolds=3, scan_scaffolds=2, resolution=g.resolution, mesh=None,
    )
    return {name: (work / name).read_bytes() for name in graft.BUS_FILES}


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_dryrun_buses_equal_jax(jax_bus, n):
    buses = graft._dryrun_buses(n, device="cpu")
    want = ["local", "mesh", "ep"] + (["ep_mesh"] if n >= 2 else [])
    assert sorted(buses) == sorted(want)
    for run, bus in buses.items():
        assert bus, run
        for name, data in bus.items():
            assert data == jax_bus[name], (run, name)
    assert set(buses["local"]) == set(graft.BUS_FILES)
    assert len(jax_bus["chromorder.txt"].splitlines()) > 1


def test_dryrun_multichip_on_cpu(capsys):
    assert graft.dryrun_multichip(4, device="cpu") is None
    out = capsys.readouterr().out
    assert out.count("dryrun_multichip OK: 4 positions over 1 device (cpu)") == 1
    assert "each driving a 2-position submesh" in out


@pytest.mark.parametrize("call", [
    lambda: graft.entry(),
    lambda: graft.dryrun_multichip(2),
    lambda: graft._dryrun_buses(2),
], ids=["entry", "dryrun", "buses"])
def test_cuda_without_a_card_raises(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        call()


@pytest.mark.parametrize("n,cards,want", [
    (8, 1, [0] * 8), (4, 4, [0, 1, 2, 3]), (8, 3, [0, 1, 2, 0, 1, 2, 0, 1]), (2, 4, [0, 1]),
])
def test_positions_take_the_cards_round_robin(monkeypatch, n, cards, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    mesh, dev = graft._mesh_of(n, "cuda")
    assert mesh.shape == {"data": n, "model": 1}
    assert [d for d in mesh.devices[:, 0]] == [torch.device("cuda", i) for i in want]
    assert dev == torch.device("cuda", 0)
    with pytest.raises(ValueError):
        graft._mesh_of(0, "cuda")


_NO_JAX = r"""
import importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "matplotlib", "sklearn", "hic_genome_assembler_tpu")

class _NotInstalled(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ModuleNotFoundError(f"No module named {name!r}", name=name)
        return None

sys.meta_path.insert(0, _NotInstalled())
sys.path.insert(0, sys.argv[1])
import __graft_entry_torch__ as g
g.dryrun_multichip(4, device="cpu")
fn, args = g.entry(device="cpu")
assert tuple(fn(*args).shape) == (360, 64)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
"""


def test_dryrun_runs_without_jax(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k not in ("HIC_MESH", "WORLD_SIZE", "RANK")}
    proc = subprocess.run([sys.executable, "-c", _NO_JAX, REPO], capture_output=True, text=True,
                          timeout=300, cwd=str(tmp_path), env=env)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "dryrun_multichip OK: 4 positions over 1 device (cpu)" in proc.stdout
    assert proc.stdout.rstrip().endswith("LOADED []")
