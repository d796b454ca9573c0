"""The port keeps its own copies of the JAX package's jax-free modules.

First, no module of ``hic_genome_assembler_tpu_torch``, not
``chip_smoke.py``, not ``__graft_entry_torch__.py`` and no example twin
(``examples/*_torch.py``) imports
``hic_genome_assembler_tpu`` (checked on the syntax tree, one case per
file).  Then each copied host module is held to
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
) + ["chip_smoke.py", "__graft_entry_torch__.py"] + sorted(
    str(p.relative_to(REPO)) for p in (REPO / "examples").glob("*_torch.py"))
JAX_PACKAGE = "hic_genome_assembler_tpu"


def _publish_jax_native():
    """Builds the JAX package's native IO library before any test runs.

    The JAX package links ``native/libhicio.so`` in place (``g++ -o``) the
    first time a process needs it, and loads any file it finds there, so a
    test worker that starts while another links the library loads a
    half-written file (``OSError: ... file too short``).  Every test worker
    imports this module while it collects, before it runs a test: here one
    worker at a time (a file lock) builds the library under a private name
    and renames it into place when it is missing or older than its sources,
    so the JAX package then only loads a whole file.  The port's own library
    is linked under a private name and renamed, and needs no such step."""
    import fcntl
    import subprocess

    from hic_genome_assembler_tpu.io import native as jax_native

    def current():
        return os.path.exists(jax_native._SO_PATH) and all(
            os.path.getmtime(src) <= os.path.getmtime(jax_native._SO_PATH)
            for src in jax_native._SOURCES)

    if current():
        return
    lock = os.open(jax_native._NATIVE_DIR, os.O_RDONLY)  # the directory is the lock
    try:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if current():
            return
        tmp = f"{jax_native._SO_PATH}.{os.getpid()}.tmp"
        built = subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread", "-o", tmp,
             *jax_native._SOURCES], capture_output=True).returncode == 0
        if built:
            os.replace(tmp, jax_native._SO_PATH)
        elif os.path.exists(tmp):
            os.remove(tmp)
    finally:
        os.close(lock)


_publish_jax_native()


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
                "utils/fixtures.py", "models/part4_fasta.py", "utils/transfer.py"):
        assert f"hic_genome_assembler_tpu_torch/{rel}" in PORT_FILES
    for rel in ("working_example_torch.py", "run_fixture_pipeline_torch.py"):
        assert f"examples/{rel}" in PORT_FILES
    assert "__graft_entry_torch__.py" in PORT_FILES
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


# ---------------------------------------------------------------------------
# The CUDA sources, their ctypes binding and the scoring wrappers' checks
# ---------------------------------------------------------------------------

CU_FILES = sorted(p.name for p in (REPO / "hic_genome_assembler_tpu_torch" / "csrc").glob("*.cu"))


def _entry_points(text):
    """``{name: [parameter declarations]}`` of the ``extern "C"`` functions."""
    import re

    found = re.findall(r'extern "C" int (\w+)\(([^)]*)\)', text)
    return {name: [p.strip() for p in params.split(",")] for name, params in found}


@pytest.mark.parametrize("cu", CU_FILES)
def test_cuda_source_stands_alone_and_names_what_it_replaces(cu):
    """Each kernel source includes only system headers (it builds from the
    checkout alone), names the JAX function it replaces, and says what
    bounds it on the card."""
    text = (REPO / "hic_genome_assembler_tpu_torch" / "csrc" / cu).read_text()
    includes = [line for line in text.splitlines() if line.startswith("#include")]
    assert includes and all(line.startswith("#include <") for line in includes), includes
    header = text.split("#include", 1)[0]
    assert "hic_genome_assembler_tpu/ops/" in header
    assert "bounds it on this card" in text


def test_every_entry_point_has_its_ctypes_signature():
    """``_build.SIGNATURES`` holds every ``extern "C"`` function of csrc/*.cu
    with one ctypes type a parameter: c_void_p for pointers and the stream,
    c_int64 for int64_t, c_double for double, c_int for int."""
    import ctypes

    from hic_genome_assembler_tpu_torch.ops import _build

    entries = {}
    for cu in CU_FILES:
        entries.update(_entry_points((REPO / "hic_genome_assembler_tpu_torch" / "csrc" / cu)
                                     .read_text()))
    assert set(entries) == set(_build.SIGNATURES)
    assert {"pair_profiles", "combo_score_topk", "group_topk", "topk_fold", "block_score",
            "pair_score"} <= set(entries)
    for name, params in entries.items():
        want = [ctypes.c_void_p if ("*" in p or "cudaStream_t" in p)
                else ctypes.c_int64 if p.startswith("int64_t")
                else ctypes.c_double if p.startswith("double") else ctypes.c_int
                for p in params]
        assert _build.SIGNATURES[name] == want, name


def test_library_binds_every_entry_point(monkeypatch):
    """``_build.library()`` sets each symbol's argument and result types on
    the loaded library (here a stand-in for the nvcc-built one)."""
    import types

    from hic_genome_assembler_tpu_torch.ops import _build

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            fn = types.SimpleNamespace()
            setattr(self, name, fn)
            return fn

    monkeypatch.setattr(_build, "build", lambda: 0.0)
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    _build.library.cache_clear()
    try:
        lib = _build.library()
        assert lib.path.endswith("libkernels.so")
        for name, argtypes in _build.SIGNATURES.items():
            assert getattr(lib, name).argtypes == argtypes
            assert getattr(lib, name).restype is _build.ctypes.c_int
    finally:
        _build.library.cache_clear()


def _score_args():
    """Valid CPU arguments of the pair, combo, block and profile wrappers."""
    Sp, Cp1, W, S = 3, 5, 4, 3
    F = torch.zeros(4 * Sp * Sp * Cp1)
    sizes = torch.tensor([1, 2, 0])
    c0 = torch.tensor(0.0)
    cand = torch.zeros((2, 2 * W), dtype=torch.int32)
    combo = (F, torch.zeros((4, 4), dtype=torch.int64), torch.zeros((2, 3), dtype=torch.int32),
             torch.zeros((8, S), dtype=torch.int32), c0)
    block = (F, sizes, torch.zeros((2, S), dtype=torch.int32),
             torch.zeros((8, S), dtype=torch.int32), c0)
    return {"pair": (F, sizes, cand, c0), "combo": combo, "block": block, "block_topk": block,
            "profiles": (torch.zeros((3, 3)), sizes, 64)}


def _call(kind, args):
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    if kind == "combo":
        return sk.combo_score_topk(*args, 4)
    if kind == "block_topk":
        return sk.block_score_topk(*args, 4)
    return {"pair": sk.pair_scores, "block": sk.block_scores,
            "profiles": sk.pair_profiles}[kind](*args)


def _meta_table():
    """A table too wide for int32 deltas, on the meta device (no memory)."""
    return torch.empty(4 * 9 * 2**31, device="meta")


_BAD_ARGS = {
    # name: (wrapper, position, replacement or a function of the valid argument)
    "pair: int64 candidates": ("pair", 2, lambda a: a.long()),
    "pair: odd candidate width": ("pair", 2, lambda a: a[:, :7].contiguous()),
    "pair: strided candidates": ("pair", 2, lambda a: torch.zeros((8, 2), dtype=torch.int32).t()),
    "pair: int32 sizes": ("pair", 1, lambda a: a.int()),
    "pair: float64 c0 with a float32 table": ("pair", 3, lambda a: a.double()),
    "pair: table not a multiple of 4*Sp*Sp": ("pair", 0, lambda a: a[:-1]),
    "pair: 2-D table": ("pair", 0, lambda a: a.reshape(4, -1)),
    "pair: sizes on another device": ("pair", 1, lambda a: a.to("meta")),
    "combo: cid not [Bo, S*(S-1)/2]": ("combo", 2, lambda a: torch.zeros((2, 4), dtype=torch.int32)),
    "combo: idx4 not [n, 4]": ("combo", 1, lambda a: torch.zeros((4, 3), dtype=torch.int64)),
    "combo: int64 orientations": ("combo", 3, lambda a: a.long()),
    "block: orients of another width": ("block", 3, lambda a: torch.zeros((8, 2), dtype=torch.int32)),
    "block: S above 31": ("block", 2, lambda a: torch.zeros((2, 32), dtype=torch.int32)),
    "block top-k: int64 orders": ("block_topk", 2, lambda a: a.long()),
    "block top-k: orients of another width": ("block_topk", 3,
                                              lambda a: torch.zeros((8, 2), dtype=torch.int32)),
    "profiles: a matrix that is not square": ("profiles", 0, lambda a: torch.zeros((3, 4))),
    "profiles: cmax past shared memory": ("profiles", 2, lambda a: 20000),
}


@pytest.mark.parametrize("case", list(_BAD_ARGS))
def test_score_wrappers_reject_bad_arguments(case):
    """The argument checks run before either version: on the CPU too."""
    kind, pos, bad = _BAD_ARGS[case]
    args = list(_score_args()[kind])
    _call(kind, args)  # the valid arguments pass
    args[pos] = bad(args[pos])
    with pytest.raises(ValueError):
        _call(kind, args)


def test_score_wrappers_check_the_int64_index_range_and_k():
    """A table whose width C + 1 reaches 2**31 (deltas are int32 in the
    kernels) is refused, as are group counts outside 1..65535 and devices
    other than cuda and cpu."""
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    meta = torch.device("meta")
    sizes = torch.zeros(3, dtype=torch.int64, device=meta)
    c0 = torch.zeros((), device=meta)
    cand = torch.zeros((2, 8), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError, match="2\\*\\*31"):
        sk.pair_scores(_meta_table(), sizes, cand, c0)
    with pytest.raises(ValueError, match="cuda or cpu"):
        sk.pair_scores(torch.zeros(4 * 9 * 5, device=meta), sizes, cand, c0)
    combo = _score_args()["combo"]
    block = _score_args()["block"]
    for k in (0, 65536):
        with pytest.raises(ValueError):
            sk.combo_score_topk(*combo, k)
        with pytest.raises(ValueError):
            sk.block_score_topk(*block, k)
    with pytest.raises(ValueError):
        sk.group_argmax(torch.zeros((2, 2)), 1)
