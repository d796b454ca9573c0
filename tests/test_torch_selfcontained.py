"""The port keeps its own copies of the JAX package's jax-free modules.

First, no module of ``hic_genome_assembler_tpu_torch`` and not
``chip_smoke.py`` imports ``hic_genome_assembler_tpu`` (checked on the
syntax tree, one case per file).  Then each copied host module is held to
its JAX original on the same seeded inputs with exact equality: the
hypergeometric decisions, the permutation enumerations, the f64 oracle
transforms, UPGMA, Louvain, FASTA, the file bus, config parsing, the
fixtures, and the native validPairs scanner, whose thread count the port's
copy clamps.  Last, the port's ``device_trace`` traces with torch.profiler.
"""

import ast
import io
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu import config as jax_config
from hic_genome_assembler_tpu.cluster import louvain as jax_louvain
from hic_genome_assembler_tpu.cluster import upgma as jax_upgma
from hic_genome_assembler_tpu.io import fasta as jax_fasta
from hic_genome_assembler_tpu.io import filebus as jax_filebus
from hic_genome_assembler_tpu.io import hicpro as jax_hicpro
from hic_genome_assembler_tpu.ops import hypergeom as jax_hypergeom
from hic_genome_assembler_tpu.ops import oracle as jax_oracle
from hic_genome_assembler_tpu.ops import perms as jax_perms
from hic_genome_assembler_tpu.parallel import distributed as jax_distributed
from hic_genome_assembler_tpu.utils import fixtures as jax_fixtures
from hic_genome_assembler_tpu_torch import config
from hic_genome_assembler_tpu_torch.cluster import louvain, upgma
from hic_genome_assembler_tpu_torch.io import fasta, filebus, hicpro, native
from hic_genome_assembler_tpu_torch.models import part3_orient
from hic_genome_assembler_tpu_torch.ops import hypergeom, oracle, perms
from hic_genome_assembler_tpu_torch.parallel import distributed
from hic_genome_assembler_tpu_torch.utils import fixtures, profiling

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(
    str(p.relative_to(REPO)) for p in (REPO / "hic_genome_assembler_tpu_torch").rglob("*.py")
) + ["chip_smoke.py"]
JAX_PACKAGE = "hic_genome_assembler_tpu"


def _names_the_jax_package(module) -> bool:
    return module == JAX_PACKAGE or (module or "").startswith(JAX_PACKAGE + ".")


@pytest.mark.parametrize("rel", PORT_FILES)
def test_port_file_imports_nothing_of_the_jax_package(rel):
    tree = ast.parse((REPO / rel).read_text(), filename=rel)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _names_the_jax_package(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _names_the_jax_package(node.module):
                found.append(node.module)
        elif isinstance(node, ast.Call) and node.args:
            # importlib.import_module("...") and __import__("...")
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            arg = node.args[0]
            if (name in ("import_module", "__import__") and isinstance(arg, ast.Constant)
                    and isinstance(arg.value, str) and _names_the_jax_package(arg.value)):
                found.append(arg.value)
    assert not found, f"{rel} imports {found}"


def test_port_file_list_covers_the_copies():
    for rel in ("config.py", "io/native.py", "ops/oracle.py", "viz/plot.py",
                "utils/fixtures.py", "models/part4_fasta.py"):
        assert f"hic_genome_assembler_tpu_torch/{rel}" in PORT_FILES
    hostio = REPO / "hic_genome_assembler_tpu_torch" / "csrc" / "hostio"
    sources = sorted(p.name for p in hostio.glob("*.cpp"))
    assert sources == sorted(os.path.basename(s) for s in native._SOURCES)


def test_hypergeom_decisions_equal_jax():
    rng = np.random.default_rng(0)
    M = rng.integers(50, 5000, 4000)
    n = rng.integers(1, M)
    N = rng.integers(1, M)
    x = rng.integers(0, np.minimum(n, N) + 2)
    for psig in (0.05, 1e-3, 0.5):
        want = jax_hypergeom.ge_significant(x, M, n, N, psig)
        got = hypergeom.ge_significant(x, M, n, N, psig)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    # one distribution, many counts: the dedup path
    xs = rng.integers(0, 300, 5000)
    assert np.array_equal(hypergeom.ge_significant(xs, 3000, 400, 500, 0.05),
                          jax_hypergeom.ge_significant(xs, 3000, 400, 500, 0.05))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7])
def test_perms_enumerations_equal_jax(n):
    assert perms.calc_possible_perms(n) == jax_perms.calc_possible_perms(n)
    assert perms.permutations_swap_order(list(range(n))) == \
        jax_perms.permutations_swap_order(list(range(n)))
    assert perms.plus_minus_perms(n) == jax_perms.plus_minus_perms(n)
    for fn in ("order_batch", "orient_batch"):
        got, want = getattr(perms, fn)(n), getattr(jax_perms, fn)(n)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _contacts(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.gamma(0.5, 3.0, (n, n)) * (rng.random((n, n)) < 0.4)
    return np.triu(a) + np.triu(a, 1).T


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return got.dtype == want.dtype and got.shape == want.shape and np.array_equal(
        got, want, equal_nan=got.dtype.kind == "f")


def test_oracle_transforms_equal_jax():
    m = _contacts(97, 1)
    m[5] = m[:, 5] = 0.0  # a zero row
    rs = m.sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        pairs = [
            (oracle.to_distance(m), jax_oracle.to_distance(m)),
            (oracle.to_similarity(m, rs), jax_oracle.to_similarity(m, rs)),
            (oracle.log_transform(m), jax_oracle.log_transform(m)),
            (oracle.log_transform(m, 2.0, True, False),
             jax_oracle.log_transform(m, 2.0, True, False)),
            (oracle.rank_matrix_desc(m), jax_oracle.rank_matrix_desc(m)),
        ]
    order = np.random.default_rng(2).permutation(97)[:80]
    pairs.append((oracle.permute_symmetric(m, order), jax_oracle.permute_symmetric(m, order)))
    for i, (got, want) in enumerate(pairs):
        assert _same(got, want), i
    total = jax_oracle.upper_triangle_total(m)
    assert oracle.cost_function(m, total) == jax_oracle.cost_function(m, total)


def test_upgma_leaf_order_equals_jax():
    rng = np.random.default_rng(3)
    d = rng.random((60, 60)) + 1.0
    d = (d + d.T) / 2
    np.fill_diagonal(d, 0.0)
    labels = [f"bin{i}" for i in range(60)]
    assert upgma.average_cluster_leaf_order(d, labels) == \
        jax_upgma.average_cluster_leaf_order(d, labels)


@pytest.mark.parametrize("seed", [0, 4])
def test_louvain_sweep_equals_jax(seed):
    adj = _contacts(48, 10 + seed)
    assert louvain.best_partition(adj, seed=seed) == jax_louvain.best_partition(adj, seed=seed)
    a_tilde, k, two_m = louvain._prep(adj)
    got = louvain._one_level(a_tilde, k, two_m, np.random.default_rng(seed))
    want = jax_louvain._one_level(a_tilde, k, two_m, np.random.default_rng(seed))
    assert np.array_equal(got, want)
    part, score = louvain.modularity_rounds(adj, 3, seed)
    assert (part, score) == jax_louvain.modularity_rounds(adj, 3, seed)


def test_fasta_reverse_complement_and_writing_equal_jax(tmp_path):
    rng = np.random.default_rng(5)
    seqs = {f"s{i}": "".join(rng.choice(list("ACGTN"), int(rng.integers(0, 180))))
            for i in range(6)}
    for seq in seqs.values():
        assert fasta.reverse_complement(seq) == jax_fasta.reverse_complement(seq)
        for width in (50, 7):
            ours, theirs = io.StringIO(), io.StringIO()
            fasta.write_wrapped_seq(ours, seq, width)
            jax_fasta.write_wrapped_seq(theirs, seq, width)
            assert ours.getvalue() == theirs.getvalue()
    with pytest.raises(KeyError):
        fasta.reverse_complement("ACGX")
    path = tmp_path / "x.fasta"
    with open(path, "w") as handle:
        for name, seq in seqs.items():
            handle.write(f">{name}\n")
            fasta.write_wrapped_seq(handle, seq)
    assert fasta.read_fasta(str(path)) == jax_fasta.read_fasta(str(path)) == seqs


def test_filebus_round_trips_equal_jax(tmp_path):
    bins = [hicpro.Bin(i + 1, f"scaf{i // 4}", 100 * i, 100 * (i + 1), 0.5 + i / 7)
            for i in range(20)]
    jbins = [jax_hicpro.Bin(b.ID, b.chrom, b.start, b.stop, b.bias) for b in bins]
    chroms = [[(b.ID, b.chrom) for b in bins[:12]], [(b.ID, b.chrom) for b in bins[12:]]]
    sizes = {f"scaf{i}": 1000 * (5 - i) for i in range(5)}
    orderings = [[("scaf1", "+"), ("scaf0", "-")], [("scaf4", "+")]]
    bin_ids = [("scaf1", [5, 6, 7]), ("scaf0", [1, 2])]
    writes = [
        ("dendro.txt", "write_dendrogram_leaf_order", ([b.chrom for b in bins], list(range(20))),
         "read_dendrogram_leaf_order"),
        ("bins.txt", "write_bin_groupings", ([4, 9], None), "read_bin_groupings"),
        ("groups.txt", "write_chromosome_groupings", (chroms, sizes), "read_chroms_from_file"),
        ("order.txt", "write_scaffold_orderings", (orderings,), "read_chromosome_ordering"),
        ("binids.txt", "write_bin_ids_ordering", (bin_ids,), None),
    ]
    for name, writer, args, reader in writes:
        ours, theirs = tmp_path / ("t_" + name), tmp_path / ("j_" + name)
        if writer == "write_bin_groupings":
            getattr(filebus, writer)(args[0], bins, str(ours))
            getattr(jax_filebus, writer)(args[0], jbins, str(theirs))
        else:
            getattr(filebus, writer)(*args, str(ours))
            getattr(jax_filebus, writer)(*args, str(theirs))
        assert ours.read_bytes() == theirs.read_bytes(), name
        if reader:
            assert getattr(filebus, reader)(str(ours)) == getattr(jax_filebus, reader)(str(theirs))
    assert filebus.read_groupings_to_valid_bins(str(tmp_path / "t_groups.txt")) == \
        jax_filebus.read_groupings_to_valid_bins(str(tmp_path / "j_groups.txt"))
    shards = {1: orderings[0], 3: orderings[1]}
    distributed.write_shard_orderings(shards, str(tmp_path / "t.shard0"), "fp")
    jax_distributed.write_shard_orderings(shards, str(tmp_path / "j.shard0"), "fp")
    assert (tmp_path / "t.shard0").read_bytes() == (tmp_path / "j.shard0").read_bytes()


@pytest.mark.parametrize("cfg", sorted(p.name for p in (REPO / "configs").glob("*.txt")))
def test_config_parsing_equals_jax(cfg):
    path = str(REPO / "configs" / cfg)
    var = config.read_config_file_to_variables(path)
    assert var == jax_config.read_config_file_to_variables(path)
    assert config.ensure_all_variables_are_set(dict(var)) == \
        jax_config.ensure_all_variables_are_set(dict(var))
    assert config.default_variables() == jax_config.default_variables()


def test_fixtures_write_the_same_bytes_as_jax(tmp_path):
    kw = dict(chrom_scaffold_bins=((6, 5, 4), (5, 4, 3)), seed=23)
    ours = fixtures.write_hicpro_files(fixtures.make_genome(**kw), str(tmp_path / "t"))
    theirs = jax_fixtures.write_hicpro_files(jax_fixtures.make_genome(**kw), str(tmp_path / "j"))
    assert sorted(ours) == sorted(theirs)
    for kind in ours:
        assert Path(ours[kind]).read_bytes() == Path(theirs[kind]).read_bytes(), kind
    m = hicpro.read_coo_matrix(ours["matrix"])
    assert _same(m, jax_hicpro.read_coo_matrix(theirs["matrix"]))


def test_validpairs_scan_clamps_huge_thread_counts(tmp_path, monkeypatch):
    """``HIC_SCAN_THREADS=1000000`` runs at most 4 threads a core and
    returns the records of the default scan."""
    assert native.available(), "the port's native IO library did not build"
    genome = fixtures.make_genome(chrom_scaffold_bins=((6, 5, 4), (5, 4, 3)), seed=23)
    paths = fixtures.write_hicpro_files(genome, str(tmp_path))
    names = [s.name for s in genome.scaffolds]
    keys = {(a, b): [] for a in names for b in names if a != b}

    def scan():
        return native.scan_validpairs(paths["validpairs"], {k: [] for k in keys})

    monkeypatch.delenv("HIC_SCAN_THREADS", raising=False)
    want = scan()
    assert sum(map(len, want.values())) > 0
    monkeypatch.setenv("HIC_SCAN_THREADS", "1000000")
    assert scan() == want
    # and both equal the pure-Python stream of part 3
    monkeypatch.setattr(native, "available", lambda: False)
    assert part3_orient.read_valid_pair_file(paths["validpairs"], {k: [] for k in keys}) == want


def test_device_trace_writes_a_chrome_trace(tmp_path):
    """The port's ``profiling.device_trace`` is ``torch.profiler``, not
    ``jax.profiler``: it writes a Chrome trace of the enclosed work."""
    with profiling.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    (trace,) = (tmp_path / "trace").glob("trace_*.json")
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("matmul" in str(event.get("name", "")) for event in events)
