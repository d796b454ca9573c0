"""The port on a CUDA GPU against the same port on the CPU.

Every test here needs a GPU and nvcc and skips without them.  The GPU
machines have no jax, so this file imports neither jax nor the JAX
package and runs without the repository's conftest (which imports jax):

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import filecmp
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hic_genome_assembler_tpu_torch import cli  # noqa: E402
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp  # noqa: E402
from hic_genome_assembler_tpu_torch.models import part2_order  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import cost  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import count_kernels as ck  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import gaussian_hmm, hmm_kernels, matrix  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import perms  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk  # noqa: E402
from hic_genome_assembler_tpu_torch.parallel import mesh as pm  # noqa: E402
from hic_genome_assembler_tpu_torch.io import hicpro  # noqa: E402
from hic_genome_assembler_tpu_torch.utils import e2e, fixtures, transfer  # noqa: E402

pytestmark = pytest.mark.gpu
CPU = torch.device("cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    return torch.device("cuda")


def _rank(n, seed):
    rng = np.random.default_rng(seed)
    return np.argsort(rng.random((n, n)), axis=1).astype(np.int32)


def test_kernel_matches_plain_and_counts_launches(cuda):
    rank = torch.from_numpy(_rank(603, 0))
    padded = ck.pad_rank(rank.to(cuda))
    params = np.array([[0, 0, 1], [7, 0, 1], [3, 77, 0], [400, 100, 0], [0, 602, 0]], np.int32)
    before = ck.LAUNCHES
    for mat in (padded, padded[:, :1024]):
        assert torch.equal(ck.counts_many(mat, params), ck.counts_many_plain(mat, params))
    assert ck.LAUNCHES == before + 2
    np.testing.assert_array_equal(
        ck.growing_window_counts(rank.to(cuda), 7).cpu().numpy(),
        ck.growing_window_counts(rank, 7).numpy(),
    )
    with pytest.raises(ValueError):
        ck.counts_many(padded.to(torch.int64), params)
    with pytest.raises(ValueError):
        ck.counts_many(padded.t(), params)


@pytest.mark.parametrize("layout", [(2, 2), (4, 1), (3, 2)])
def test_kernel_with_offsets_matches_plain_on_blocks(cuda, layout):
    """Every block of a 2-D layout: the kernel with the block's offsets
    equals its plain version, and the blocks' sums equal one launch on the
    whole matrix."""
    n = 603
    rank = torch.from_numpy(_rank(n, 1)).to(cuda)
    d, m = layout
    t = pm.pad_to_multiple(n, int(np.lcm(d, m)))
    mesh = pm.make_mesh(layout, [cuda] * (d * m))
    blocks = pm.place_blocks(mesh, [rank], t, t, fill=-1)
    params = np.array([[0, 0, 1], [7, 0, 1], [590, 0, 1], [3, 77, 0], [400, 100, 0],
                       [0, 602, 0], [250, 560, 0]], np.int32)
    rb, cb = t // d, t // m
    for i in range(d):
        for j in range(m):
            got = ck.counts_many(blocks[i][j], params, row0=i * rb, col0=j * cb)
            want = ck.counts_many_plain(blocks[i][j], params, row0=i * rb, col0=j * cb)
            assert torch.equal(got, want), (i, j)
    before = ck.LAUNCHES
    summed = ck.counts_many_blocks(blocks, params, cuda)[:, :n]
    assert ck.LAUNCHES == before + d * m
    assert torch.equal(summed, ck.counts_many(ck.pad_rank(rank), params)[:, :n])


def test_virtual_mesh_rankcounts_on_cuda_equals_local(cuda):
    rank = _rank(2500, 4)
    mesh = pm.make_mesh((2, 2), [cuda] * 4)
    local, sharded = bp.RankCounts(rank, cuda), bp.RankCounts(rank, cuda, mesh=mesh)
    assert sharded.where == f"mesh 2x2 {cuda}"
    starts = [0, 7, 123, 2049, 2491]
    sharded.prefetch_growing(starts)
    for s in starts:
        np.testing.assert_array_equal(sharded.growing(s), local.growing(s))
    pairs = [(0, 5), (17, 900), (900, 17), (5, 2499), (2498, 2499), (10, 2100)]
    sharded.prefetch_fixed_pairs(pairs)
    assert all(p in sharded._cache for p in pairs)
    for s, c in pairs:
        np.testing.assert_array_equal(sharded.fixed(s, c), local.fixed(s, c))


def test_virtual_mesh_scorer_decisions_on_cuda(cuda):
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((12, 9, 7, 6, 5, 4, 3, 2, 2, 1),), seed=5, noise=0.01
    )
    scaffolds = sorted(genome.scaffolds, key=lambda s: s.n_bins, reverse=True)
    bins = [b for s in scaffolds for b in sorted(s.bin_ids)]
    sub, sizes = genome.matrix[np.ix_(bins, bins)], [s.n_bins for s in scaffolds]
    mesh = pm.make_mesh((2, 2), [cuda] * 4)
    local = cost.ChromosomeScorer(sub, sizes, cuda)
    sharded = cost.ChromosomeScorer(sub, sizes, cuda, mesh=mesh)
    head, tail = list(range(6)), list(range(6, len(sizes)))
    names = [s.name for s in scaffolds]
    bf = part2_order.brute_force_best(sharded, head, names)
    assert bf == part2_order.brute_force_best(local, head, names)
    gr = part2_order.order_remainder_scaffolds(sharded, list(bf[0]), list(bf[1]), list(tail))
    assert gr == part2_order.order_remainder_scaffolds(local, list(bf[0]), list(bf[1]), list(tail))


def test_counts_on_blocks_over_two_cards():
    """A mesh over two real cards: blocks on cuda:1 launch on cuda:1 while
    cuda:0 is the current card, and ``RankCounts`` on a (2, 2) mesh of
    cuda:0 and cuda:1 gives the single-device counts."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs and nvcc")
    cards = [torch.device("cuda", i) for i in (0, 1)]
    torch.cuda.set_device(cards[0])
    n = 603
    rank = torch.from_numpy(_rank(n, 5))
    params = np.array([[0, 0, 1], [7, 0, 1], [3, 77, 0], [250, 560, 0]], np.int32)
    mesh = pm.make_mesh((2, 2), [cards[0], cards[1], cards[1], cards[0]])
    blocks = pm.place_blocks(mesh, [rank], 608, 608, fill=-1)
    assert blocks[0][1].device == cards[1] and blocks[1][0].device == cards[1]
    before = ck.LAUNCHES
    summed = ck.counts_many_blocks(blocks, params, cards[0])[:, :n]
    assert ck.LAUNCHES == before + 4
    assert torch.equal(summed.cpu(), ck.counts_many_plain(rank, params))
    local, sharded = bp.RankCounts(_rank(n, 5), cards[0]), bp.RankCounts(
        _rank(n, 5), cards[0], mesh=mesh
    )
    assert sharded.where == "mesh 2x2 cuda:0,cuda:1"
    for s in (0, 7, 590):
        np.testing.assert_array_equal(sharded.growing(s), local.growing(s))
    for s, c in ((0, 5), (17, 600), (250, 560)):
        np.testing.assert_array_equal(sharded.fixed(s, c), local.fixed(s, c))


def test_mesh_topk_over_two_cards():
    """The mesh top-k paths with blocks on cuda:1: each block's partial
    triples are copied to the scorer's card (cuda:0) and folded there; the
    selection equals one card's (no mesh padding: the same groups)."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs and nvcc")
    cards = [torch.device("cuda", i) for i in (0, 1)]
    torch.cuda.set_device(cards[0])
    rng = np.random.default_rng(8)
    m = np.triu(rng.integers(0, 9, (40, 40)).astype(np.float64), 1)
    sizes = [9, 8, 7, 6, 5, 5]
    mesh = pm.make_mesh((2, 1), cards)
    local = cost.ChromosomeScorer(m + m.T, sizes, cards[0]).full()
    sharded = cost.ChromosomeScorer(m + m.T, sizes, cards[0], mesh=mesh).full()
    orders, orients = perms.order_batch(6), perms.orient_batch(6)
    before = dict(sk.LAUNCHES)
    got = sharded.score_batch_topk(orders, orients, k=7)
    assert sk.LAUNCHES["combo_score_topk"] == before["combo_score_topk"] + 2
    assert sk.LAUNCHES["topk_fold"] == before["topk_fold"] + 1
    want = local.score_batch_topk(orders, orients, k=7)
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(a, b)
    assert got[2] == want[2]


def _cli_genome(tmp_path):
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13, noise=0.005, cross_noise_frac=0.001,
    )
    return genome, fixtures.write_hicpro_files(genome, str(tmp_path / "hicpro"))


_CLI_SETTINGS = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4", "scanScaffolds": "3"}


def test_cli_mesh_auto_over_cards_byte_equal_to_off(tmp_path, monkeypatch):
    """``-mesh auto`` over every visible card (2 or more) gives the files
    of ``-mesh off``, and its rank counts ran on the cards' mesh."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs and nvcc")
    monkeypatch.delenv("HIC_MESH", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    genome, paths = _cli_genome(tmp_path)
    runs = {}
    for spec in ("auto", "off"):
        cfg = e2e.write_config(str(tmp_path / f"{spec}.cfg"), str(tmp_path / spec), paths,
                               genome.resolution, _CLI_SETTINGS)
        runs[spec] = cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg,
                               "-device", "cuda", "-mesh", spec])
    k = torch.cuda.device_count()
    cards = ",".join(f"cuda:{i}" for i in range(k))
    assert runs["auto"].rank_counts_on == f"mesh {k}x1 {cards}"
    files = sorted(os.listdir(tmp_path / "off" / "files"))
    assert "assembled.fasta" in files
    for name in files:
        assert filecmp.cmp(tmp_path / "auto" / "files" / name,
                           tmp_path / "off" / "files" / name, shallow=False), name


_EP_CHILD = """
import sys
sys.modules["matplotlib"] = None
sys.path.insert(0, sys.argv[1])
from hic_genome_assembler_tpu_torch import cli
cli.main(["-part2", "-config", sys.argv[2], "-device", "cuda", "-mesh", "auto"])
"""


def test_ep_processes_take_their_own_cards(tmp_path, monkeypatch):
    """Two EP processes on one host of 2 or more cards (``LOCAL_WORLD_SIZE``
    2, as ``torchrun --nproc-per-node 2`` sets it): each runs on its own
    half of the cards, and the merged files equal the single process's."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs and nvcc")
    import shutil
    import socket
    import subprocess

    monkeypatch.delenv("HIC_MESH", raising=False)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    genome, paths = _cli_genome(tmp_path)
    single_cfg = e2e.write_config(str(tmp_path / "single.cfg"), str(tmp_path / "single"), paths,
                                  genome.resolution, _CLI_SETTINGS)
    cli.main(["-part1", "-part2", "-config", single_cfg, "-device", "cuda", "-mesh", "off"])
    ep_cfg = e2e.write_config(str(tmp_path / "ep.cfg"), str(tmp_path / "ep"), paths,
                              genome.resolution, _CLI_SETTINGS)
    shutil.copy(tmp_path / "single" / "files" / "chromosomeGroupings.txt",
                tmp_path / "ep" / "files" / "chromosomeGroupings.txt")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2", MASTER_ADDR="127.0.0.1",
               MASTER_PORT=str(port))
    procs = [
        subprocess.Popen([sys.executable, "-c", _EP_CHILD, repo, ep_cfg],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
        for r in (0, 1)
    ]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    per = torch.cuda.device_count() // 2
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out[-3000:]
        if per > 1:  # -mesh auto builds a mesh over this process's cards only
            assert f"- Parallel runtime: {per} devices, mesh {{'data': {per}, 'model': 1}}, " \
                   f"process {r}/2" in out, out[-3000:]
        else:
            assert "- Parallel runtime:" not in out
    for name in ("chromosomeOrdering.txt", "plotOrder.txt"):
        assert filecmp.cmp(tmp_path / "ep" / "files" / name,
                           tmp_path / "single" / "files" / name, shallow=False), name


def test_rankcounts_on_cuda_equals_cpu(cuda, monkeypatch):
    """The CUDA path, including its batched fixed windows (taken on CUDA
    only), gives the CPU path's counts and cut lists."""
    monkeypatch.setattr(bp, "_HOST_N", 0)
    rank = _rank(2500, 4)
    gpu, cpu = bp.RankCounts(rank, cuda), bp.RankCounts(rank, CPU)
    assert gpu.where.startswith("cuda")
    starts = [0, 7, 123, 2049, 2491]
    gpu.prefetch_growing(starts)
    for s in starts:
        np.testing.assert_array_equal(gpu.growing(s), cpu.growing(s))
    pairs = [(0, 5), (17, 900), (900, 17), (5, 2499), (2498, 2499), (10, 2100)]
    gpu.prefetch_fixed_pairs(pairs)
    assert all(p in gpu._cache for p in pairs)
    for s, c in pairs:
        np.testing.assert_array_equal(gpu.fixed(s, c), cpu.fixed(s, c))
    assert bp.pre_process_all_matrix_breakpoints(gpu, min_frac=0.0) == \
        bp.pre_process_all_matrix_breakpoints(cpu, min_frac=0.0)


def test_scores_and_decisions_on_cuda_equal_cpu(cuda):
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((12, 9, 7, 6, 5, 4, 3, 2, 2, 1),), seed=5, noise=0.01
    )
    scaffolds = sorted(genome.scaffolds, key=lambda s: s.n_bins, reverse=True)
    bins = [b for s in scaffolds for b in sorted(s.bin_ids)]
    sub, sizes = genome.matrix[np.ix_(bins, bins)], [s.n_bins for s in scaffolds]
    gpu, cpu = cost.ChromosomeScorer(sub, sizes, cuda), cost.ChromosomeScorer(sub, sizes, CPU)
    orders, orients = perms.order_batch(6), perms.orient_batch(6)
    head = list(range(6))
    np.testing.assert_allclose(
        gpu.subset(head).score_batch(orders, orients),
        cpu.subset(head).score_batch(orders, orients), rtol=1e-5, atol=0,
    )
    names = [s.name for s in scaffolds]
    assert part2_order.brute_force_best(gpu, head, names) == \
        part2_order.brute_force_best(cpu, head, names)


def test_cli_on_cuda_byte_equal_to_cpu(cuda, tmp_path, monkeypatch):
    monkeypatch.setattr(bp, "_HOST_N", 0)
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
        seed=13, noise=0.005, cross_noise_frac=0.001,
    )
    paths = fixtures.write_hicpro_files(genome, str(tmp_path / "hicpro"))
    settings = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4", "scanScaffolds": "3"}
    parts = ["-part1", "-part2", "-part3", "-part4"]
    runs = {}
    for name in ("cuda", "cpu"):
        cfg = e2e.write_config(
            str(tmp_path / f"{name}.cfg"), str(tmp_path / name), paths, genome.resolution, settings
        )
        before = dict(sk.LAUNCHES)
        runs[name] = cli.main(parts + ["-config", cfg, "-device", name])
        if name == "cuda":  # part 2 ran through the scoring kernels
            for kernel in ("pair_profiles", "combo_score_topk", "pair_score"):
                assert sk.LAUNCHES[kernel] > before[kernel], kernel
    assert runs["cuda"].rank_counts_on.startswith("cuda")
    files = sorted(os.listdir(tmp_path / "cpu" / "files"))
    assert "assembled.fasta" in files
    for name in files:
        assert filecmp.cmp(tmp_path / "cuda" / "files" / name,
                           tmp_path / "cpu" / "files" / name, shallow=False), name


def _scan_inputs(T, seed, kind="random"):
    rng = np.random.default_rng(seed)
    log_b = rng.normal(0.0, 3.0, (T, 2))
    trans = np.array([[0.9, 0.1], [1e-4, 0.9999]])
    if kind == "neg_inf":
        trans = np.array([[1.0, 0.0], [0.3, 0.7]])
    if kind == "ties":
        log_b[:, 1] = log_b[:, 0]
        trans = np.full((2, 2), 0.5)
    if kind == "int":
        # small integers: every sum is exact in any order, and ties are frequent
        log_b = rng.integers(-3, 1, (T, 2)).astype(np.float64)
        return [torch.from_numpy(a) for a in (log_b, np.array([-1.0, -1.0]),
                                               np.array([[-1.0, -2.0], [-2.0, -1.0]]))]
    with np.errstate(divide="ignore"):
        return [torch.from_numpy(a) for a in (log_b, np.log([0.5, 0.5]), np.log(trans))]


# empty chunks (T - 1 < 1024 threads), chunk edges, and T far above the block
_SCAN_T = (1, 2, 31, 511, 512, 513, 1023, 1024, 1025, 3715, 17162, 100003)


@pytest.mark.parametrize(
    "T,kind", [(T, "random") for T in _SCAN_T] + [
        (300, "neg_inf"), (17162, "neg_inf"), (64, "ties"), (17162, "ties"), (3715, "int"),
        (100003, "int")],
)
def test_hmm_kernels_match_plain(cuda, T, kind):
    args = [a.to(cuda) for a in _scan_inputs(T, T, kind)]
    before = dict(hmm_kernels.LAUNCHES)
    got = hmm_kernels.forward_backward(*args)
    path = hmm_kernels.viterbi(*args)
    torch.cuda.synchronize()
    assert hmm_kernels.LAUNCHES["hmm_forward_backward"] == before["hmm_forward_backward"] + 1
    assert hmm_kernels.LAUNCHES["hmm_viterbi"] == before["hmm_viterbi"] + 1
    errors, ok = hmm_kernels.forward_backward_errors(got, hmm_kernels.forward_backward_plain(*args))
    assert ok, errors
    assert torch.equal(path, hmm_kernels.viterbi_plain(*args))
    with pytest.raises(ValueError):
        hmm_kernels.forward_backward(args[0].float(), *args[1:])


@pytest.mark.parametrize("mode", ["fast", "exact"])
def test_gaussian_hmm_on_cuda_equals_cpu(cuda, mode):
    rng = np.random.default_rng(5)
    X = np.concatenate([rng.normal(0.0, 1.0, (140, 12)), rng.normal(1.5, 1.0, (90, 12))])
    gpu = gaussian_hmm.GaussianHMM2(seed=0, mode=mode, device=cuda)
    cpu = gaussian_hmm.GaussianHMM2(seed=0, mode=mode, device=CPU)
    np.testing.assert_array_equal(gpu.fit_predict(X), cpu.fit_predict(X))
    for attr in ("means_", "covars_", "transmat_"):
        np.testing.assert_allclose(getattr(gpu, attr), getattr(cpu, attr), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("n", [97, 2500])
def test_rank_matrix_desc_on_cuda_equals_numpy(cuda, n):
    rng = np.random.default_rng(n)
    m = rng.choice(np.array([0.0, -0.0, 1.5, 2.25, 1e-7], dtype=np.float32), (n, n))
    m[:, ::7] = -0.0
    m[3] = rng.random(n).astype(np.float32)
    got = matrix.rank_matrix_desc(torch.from_numpy(m).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, np.argsort(m, axis=1, kind="stable")[:, ::-1])


@pytest.mark.parametrize("case", ["hmm_fast", "hmm_exact", "device"])
def test_other_part1_branches_on_cuda_byte_equal_to_cpu(cuda, tmp_path, monkeypatch, case):
    if case.startswith("hmm"):
        genome = fixtures.make_genome(
            chrom_scaffold_bins=((7, 6, 4, 3), (6, 5, 5), (4, 4, 2, 2)),
            seed=5, noise=0.004, cross_noise_frac=0.001, decay_alpha=0.0,
        )
        settings = {"hyperGeom": "False", "hmm": "True", "minSize": "11", "modularity": "0",
                    "louvainRounds": "3", "convergenceRounds": "5", "lookAhead": ".5",
                    "hmmMode": case[4:], "nScaffolds": "4", "scanScaffolds": "3"}
    else:
        monkeypatch.setattr(bp, "_HOST_N", 0)
        genome = fixtures.make_genome(
            chrom_scaffold_bins=((14, 12, 10, 8, 6), (12, 11, 9, 8), (10, 9, 8, 6)),
            seed=13, noise=0.005, cross_noise_frac=0.001,
        )
        settings = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4",
                    "scanScaffolds": "3", "matrixMode": "device"}
    paths = fixtures.write_hicpro_files(genome, str(tmp_path / "hicpro"))
    runs = {}
    launches = dict(hmm_kernels.LAUNCHES)
    for name in ("cuda", "cpu"):
        cfg = e2e.write_config(
            str(tmp_path / f"{name}.cfg"), str(tmp_path / name), paths, genome.resolution, settings
        )
        runs[name] = cli.main(["-part1", "-part2", "-part3", "-part4", "-config", cfg,
                               "-device", name])
    assert runs["cuda"].cut_indices == runs["cpu"].cut_indices
    if case.startswith("hmm"):
        assert hmm_kernels.LAUNCHES["hmm_forward_backward"] > launches["hmm_forward_backward"]
        assert hmm_kernels.LAUNCHES["hmm_viterbi"] > launches["hmm_viterbi"]
    else:
        assert runs["cuda"].rank_counts_on.startswith("cuda")
    files = sorted(os.listdir(tmp_path / "cpu" / "files"))
    assert "assembled.fasta" in files
    for name in files:
        assert filecmp.cmp(tmp_path / "cuda" / "files" / name,
                           tmp_path / "cpu" / "files" / name, shallow=False), name


# ---------------------------------------------------------------------------
# the scoring kernels against their plain versions, at the main path's shapes
# ---------------------------------------------------------------------------


def _close_or_equal(got, want, kind, n_terms, abs_sum):
    """Integer-valued inputs: equal; floats: within ``sum_bound``."""
    if kind == "int":
        assert torch.equal(got, want)
    else:
        bound = torch.from_numpy(sk.sum_bound(n_terms, abs_sum.abs().cpu().numpy()))
        assert bool(((got.double() - want.double()).abs().cpu() <= bound).all())


def _score_table(rng, Sp, Cp1, kind, sizes=None):
    shape = (Sp, Sp, 4, Cp1)
    vals = rng.integers(0, 16, shape) if kind == "int" else rng.random(shape)
    if sizes is not None:  # a pad id's rows are zero, as in every table from profiles
        vals[(sizes[:, None] == 0) | (sizes[None, :] == 0)] = 0
    return torch.from_numpy(vals.astype(np.float32).reshape(-1))


def _scalar(rng, kind):
    return torch.tensor(7.0 if kind == "int" else float(5 * rng.random()), dtype=torch.float32)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("B,n_real", [(112, 30), (4096, 55), (64, 1)])
def test_pair_scores_kernel_matches_plain(cuda, B, n_real, kind):
    """The 16K run's table (Sp = 56, C + 1 = 769) and width (W = 56):
    greedy rows of K + 1 ids then pads, sliding-window rows, one-id rows."""
    rng = np.random.default_rng(B + n_real)
    Sp, Cp1, W = 56, 769, 56
    sizes = np.zeros(Sp, dtype=np.int64)
    sizes[: Sp - 1] = rng.integers(1, 14, Sp - 1)
    ids = np.full((B, W), Sp - 1, dtype=np.int32)
    for b in range(B):
        ids[b, :n_real] = rng.permutation(Sp - 1)[:n_real]
    cand = np.concatenate([ids, rng.integers(0, 2, (B, W)).astype(np.int32)], axis=1)
    F = _score_table(rng, Sp, Cp1, kind, sizes).to(cuda)
    args = (F, torch.from_numpy(sizes).to(cuda), torch.from_numpy(cand).to(cuda),
            _scalar(rng, kind).to(cuda))
    before = sk.LAUNCHES["pair_score"]
    got, again = sk.pair_scores(*args), sk.pair_scores(*args)
    assert sk.LAUNCHES["pair_score"] == before + 2 and torch.equal(got, again)
    exact = sk.pair_scores_plain(args[0].double(), args[1], args[2], args[3].double())
    _close_or_equal(got, sk.pair_scores_plain(*args), kind, W * (W - 1) // 2 + 1, exact)
    with pytest.raises(ValueError):
        sk.pair_scores(args[0].double(), args[1], args[2], args[3].double())


def _topk_matches(got, want, kind, n_terms, group_max):
    if kind == "int":
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    bound = torch.from_numpy(sk.sum_bound(n_terms, group_max.cpu().numpy())).to(got[0].device)
    for x, y in ((got[0], want[0]), (got[2], want[2])):
        assert bool((torch.where(x == y, 0.0, (x.double() - y.double()).abs()) <= bound).all())
    clear = (want[0].double() - want[2].double()) > 2 * bound
    assert torch.equal(got[1][clear], want[1][clear])


def _group_max(scores, k):
    flat = scores.reshape(-1)
    return torch.cat([flat, flat.new_zeros((-flat.shape[0]) % k)]).reshape(k, -1).max(dim=1).values


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("S,k", [(6, 64), (8, 64), (5, 7)])
def test_combo_topk_kernel_matches_plain(cuda, S, k, kind):
    """The main path's S = 6 batch (23,040 candidates), bench.py's S = 8
    (5.16M) and a ragged k = 7; the mesh form (scores, then the group
    epilogue) on a padded batch too."""
    rng = np.random.default_rng(S * k)
    combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
    F = _score_table(rng, 9, 2049, kind).to(cuda)
    args = [F, torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4))).to(cuda),
            torch.from_numpy(np.ascontiguousarray(combo["cid"], dtype=np.int32)).to(cuda),
            torch.from_numpy(np.array(perms.orient_batch(S))).to(cuda), _scalar(rng, kind).to(cuda)]
    n_terms = S * (S - 1) // 2 + 1
    got, again = sk.combo_score_topk(*args, k), sk.combo_score_topk(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    exact = sk.combo_scores_plain(args[0].double(), *args[1:4], args[4].double())
    _topk_matches(got, sk.combo_score_topk_plain(*args, k), kind, n_terms, _group_max(exact, k))
    padded = list(args)
    padded[2] = torch.cat([args[2], args[2][-1:].expand(3, -1)]).contiguous()
    scores = sk.combo_scores(*padded)
    _close_or_equal(scores, sk.combo_scores_plain(*padded), kind, n_terms,
                    sk.combo_scores_plain(args[0].double(), *padded[1:4], args[4].double()))
    flat = scores.reshape(-1)
    assert all(torch.equal(a, b) for a, b in zip(sk.group_argmax(flat, k),
                                                 sk._group_argmax(flat, k)))


def _mesh_blocks(args, D, rows_arg):
    """``args`` with the candidate rows (argument ``rows_arg``) split into D
    equal blocks, as a mesh's data axis splits them."""
    rows = args[rows_arg]
    n = rows.shape[0] // D
    out = []
    for i in range(D):
        blk = list(args)
        blk[rows_arg] = rows[i * n:(i + 1) * n].contiguous()
        out.append(blk)
    return out


@pytest.mark.parametrize("D", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["combo", "block"])
def test_mesh_partials_and_fold_match_plain(cuda, monkeypatch, form, D):
    """Each of D mesh blocks' partial triples (``TOPK_TILE`` 100: a group
    spans several tiles inside a block, and k = 7 and 64 groups cross the
    blocks' edges) equals its plain version bit for bit on integer scores,
    and the fold equals the plain fold and ``_group_argmax`` of the gathered
    plain scores; D launches and one fold."""
    monkeypatch.setattr(sk, "TOPK_TILE", 100)
    rng = np.random.default_rng(D)
    if form == "combo":
        S = 6
        combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
        F = torch.from_numpy(rng.integers(0, 5, 9 * 9 * 4 * 65).astype(np.float32)).to(cuda)
        args = [F, torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4))).to(cuda),
                torch.from_numpy(np.ascontiguousarray(combo["cid"], dtype=np.int32)).to(cuda),
                torch.from_numpy(np.array(perms.orient_batch(S))).to(cuda),
                torch.tensor(3.0, device=cuda)]
        wrapper, plain, scores, launch = (sk.combo_score_topk_partials,
                                          sk.combo_score_topk_partials_plain,
                                          sk.combo_scores_plain, "combo_score_topk")
    else:
        S = 5
        ids = rng.permutation(55)[:S]
        args = _block_args(cuda, rng, "int", ids[perms.order_batch(S)], perms.orient_batch(S))
        wrapper, plain, scores, launch = (sk.block_score_topk_partials,
                                          sk.block_score_topk_partials_plain,
                                          sk.block_scores_plain, "block_score")
    blocks = _mesh_blocks(args, D, 2)
    n = blocks[0][2].shape[0] * args[3].shape[0]
    n_glob = D * n
    gathered = torch.cat([scores(*blk).reshape(-1) for blk in blocks])
    for k in (7, 64):
        before = dict(sk.LAUNCHES)
        stacked = sk.empty_triples(D, k, torch.float32, cuda)
        for i, blk in enumerate(blocks):
            row = tuple(t[i] for t in stacked)
            assert wrapper(*blk, k, i * n, n_glob, out=row) is row
            again = wrapper(*blk, k, i * n, n_glob)
            assert all(torch.equal(a, b) for a, b in zip(row, again))
            assert all(torch.equal(a, b) for a, b in zip(row, plain(*blk, k, i * n, n_glob)))
        got = sk.fold_group_triples(*stacked)
        assert sk.LAUNCHES[launch] == before[launch] + 2 * D
        assert sk.LAUNCHES["topk_fold"] == before["topk_fold"] + 1
        for a, b, c in zip(got, sk.fold_group_triples_plain(*stacked),
                           sk._group_argmax(gathered, k)):
            assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("form", ["combo", "block"])
def test_one_device_topk_keeps_its_bits_as_partials(cuda, form):
    """With n0 = 0 and the batch its own (n_glob = N), the partials form is
    the one-device launch: the same bits, one launch each (k = 64, 7 and
    3: groups of one and of several tiles)."""
    rng = np.random.default_rng(11)
    if form == "combo":
        S = 8
        combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
        F = torch.from_numpy(rng.integers(0, 3, 9 * 9 * 4 * 65).astype(np.float32)).to(cuda)
        args = [F, torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4))).to(cuda),
                torch.from_numpy(np.ascontiguousarray(combo["cid"][:700], dtype=np.int32)
                                 ).to(cuda),
                torch.from_numpy(np.array(perms.orient_batch(S))).to(cuda),
                torch.tensor(3.0, device=cuda)]
        whole, partials, launch = sk.combo_score_topk, sk.combo_score_topk_partials, \
            "combo_score_topk"
    else:
        S = 6
        ids = rng.permutation(55)[:S]
        args = _block_args(cuda, rng, "int", ids[perms.order_batch(S)], perms.orient_batch(S))
        whole, partials, launch = sk.block_score_topk, sk.block_score_topk_partials, \
            "block_score"
    n = args[2].shape[0] * args[3].shape[0]
    for k in (64, 7, 3):
        before = sk.LAUNCHES[launch]
        got, want = partials(*args, k, 0, n), whole(*args, k)
        assert sk.LAUNCHES[launch] == before + 2
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def _block_args(cuda, rng, kind, orders, orients):
    """The 16K run's table (Sp = 56, C + 1 = 769) with ``orders`` of its ids."""
    Sp, Cp1 = 56, 769
    sizes = np.zeros(Sp, dtype=np.int64)
    sizes[: Sp - 1] = rng.integers(1, 14, Sp - 1)
    F = _score_table(rng, Sp, Cp1, kind, sizes).to(cuda)
    return [F, torch.from_numpy(sizes).to(cuda),
            torch.from_numpy(np.array(orders, dtype=np.int32)).to(cuda),
            torch.from_numpy(np.array(orients, dtype=np.int32)).to(cuda),
            _scalar(rng, kind).to(cuda)]


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("S,Bo", [(8, 2048), (8, 20160), (6, 360), (1, 1)])
def test_block_scores_kernel_matches_plain(cuda, S, Bo, kind):
    """The escalation's chunk and the whole escalation at S = 8, the main
    path's S = 6 batch, and a one-scaffold chromosome (no pairs: every score
    is c0); their top-k in one launch too."""
    rng = np.random.default_rng(S + Bo)
    ids = rng.permutation(55)[:S]
    args = _block_args(cuda, rng, kind, ids[perms.order_batch(S)[:Bo]], perms.orient_batch(S))
    before = sk.LAUNCHES["block_score"]
    got, again = sk.block_scores(*args), sk.block_scores(*args)
    assert torch.equal(got, again)
    exact = sk.block_scores_plain(args[0].double(), *args[1:4], args[4].double())
    n_terms = S * (S - 1) // 2 + 1
    _close_or_equal(got, sk.block_scores_plain(*args), kind, n_terms, exact)
    k = min(64, got.numel())
    _topk_matches(sk.block_score_topk(*args, k), sk.block_score_topk_plain(*args, k), kind,
                  n_terms, _group_max(exact, k))
    assert sk.LAUNCHES["block_score"] == before + 3


# the block kernel's other shapes: (S, orders, orientation rows: "all" or so
# many random rows, ids "perm" or "repeat", k)
_BLOCK_SHAPES = {
    "S=9 every orientation, 20,160 orders (the non-combo chunk)": (9, 20160, "all", "perm", 64),
    "S=9 64 random rows": (9, 20160, 64, "perm", 64),
    "S=8 R=37 (no multiple of 4)": (8, 500, 37, "perm", 7),
    "S=8 R=100 (a multiple of 4, not 32)": (8, 500, 100, "perm", 64),
    "S=5 repeated ids": (5, 300, "all", "repeat", 7),
    "S=10 R=2,100 (two mask chunks)": (10, 40, 2100, "perm", 11),
    "S=12 (direct sums, loops not unrolled)": (12, 300, 100, "perm", 64),
    "S=2": (2, 1, "all", "perm", 2),
}


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shape,halves", [
    (shape, halves) for shape, (S, *_rest) in _BLOCK_SHAPES.items()
    for halves in (True, False) if not halves or S <= sk.BLOCK_HALVES_MAX_S])
def test_block_kernel_forms_match_plain(cuda, monkeypatch, shape, halves, kind):
    """Both sums (the halves tables where S allows them, and direct), the
    grid form (float4 rows where R is a multiple of 4, else scalar) and the
    top-k form, against the plain versions."""
    S, Bo, rows, ids_how, k = _BLOCK_SHAPES[shape]
    monkeypatch.setattr(sk, "block_halves", lambda S, R: halves)
    rng = np.random.default_rng(S * Bo)
    if ids_how == "repeat":
        orders = rng.integers(0, 20, (Bo, S))
    else:
        ids = rng.permutation(55)[:S]
        orders = ids[perms.order_batch(S)[:Bo]] if S <= 9 else np.stack(
            [rng.permutation(ids) for _ in range(Bo)])
    orients = perms.orient_batch(S) if rows == "all" else rng.integers(0, 2, (rows, S))
    args = _block_args(cuda, rng, kind, orders, orients)
    n_terms = S * (S - 1) // 2 + 1
    exact = sk.block_scores_plain(args[0].double(), *args[1:4], args[4].double())
    got = sk.block_scores(*args)
    _close_or_equal(got, sk.block_scores_plain(*args), kind, n_terms, exact)
    top, again = sk.block_score_topk(*args, k), sk.block_score_topk(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(top, again))
    _topk_matches(top, sk.block_score_topk_plain(*args, k), kind, n_terms, _group_max(exact, k))


@pytest.mark.parametrize("tile", [1, 100, 360, 5000])
@pytest.mark.parametrize("S,k", [(6, 64), (6, 11), (5, 7), (9, 3)])
def test_block_topk_kernel_blocks_clipped_inside_orders(cuda, monkeypatch, S, k, tile):
    """Blocks of ``tile`` candidates cut groups and orders at their edges; a
    group of several blocks goes through the merge launch.  Integer scores:
    exact."""
    monkeypatch.setattr(sk, "TOPK_TILE", tile)
    rng = np.random.default_rng(S * k + tile)
    ids = rng.permutation(55)[:S]
    args = _block_args(cuda, rng, "int", ids[perms.order_batch(S)[:600]], perms.orient_batch(S))
    got = sk.block_score_topk(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(got, sk.block_score_topk_plain(*args, k)))


def test_block_kernel_nan_for_bad_orders_and_flags(cuda, monkeypatch):
    """An id outside [0, Sp), a negative size or sizes that reach C + 1
    give NaN for the whole order, a flag other than 0 or 1 for its row; the
    other scores equal the plain version's."""
    rng = np.random.default_rng(11)
    S = 6
    ids = rng.permutation(50)[:S]
    orders = ids[perms.order_batch(S)[:40]].copy()
    orients = np.array(perms.orient_batch(S))
    orders[3, 2] = 56                                     # past Sp
    orders[4, 0] = -1
    orders[5, :] = [50, 51, 52, 53, 54, 55]               # sizes that reach C + 1
    orders[6, 1] = 54                                     # a negative size
    orients[5, 1] = 2
    args = _block_args(cuda, rng, "int", orders, orients)
    sizes = args[1].cpu().numpy()
    sizes[50:55] = 200
    sizes[54] = -3
    args[1] = torch.from_numpy(sizes).to(cuda)
    for halves in (True, False):
        monkeypatch.setattr(sk, "block_halves", lambda S, R, h=halves: h)
        scores = sk.block_scores(*args).cpu().numpy()
        bad_rows, bad_cols = [3, 4, 5, 6], [5]
        assert np.isnan(scores[bad_rows]).all() and np.isnan(scores[:, bad_cols]).all()
        good = np.ones_like(scores, dtype=bool)
        good[bad_rows] = False
        good[:, bad_cols] = False
        keep = np.setdiff1d(np.arange(40), bad_rows)
        want = sk.block_scores_plain(args[0], args[1], args[2][keep].contiguous(), args[3],
                                     args[4]).cpu().numpy()
        np.testing.assert_array_equal(scores[keep][:, np.setdiff1d(np.arange(64), bad_cols)],
                                      np.delete(want, bad_cols, axis=1))
        assert np.isfinite(scores[good]).all()


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("top,cmax", [(120, 128), (380, 384)])
def test_pair_profiles_kernel_matches_plain(cuda, top, cmax, kind):
    """Sp = 56 with the largest scaffold filling cmax, against the skew
    build and (integers: its atomics are exact there) the scatter build."""
    rng = np.random.default_rng(top)
    sizes = np.zeros(56, dtype=np.int64)
    sizes[:55] = [top] + list(rng.integers(1, 1 + top // 20, 54))
    C = int(sizes.sum())
    m = rng.integers(0, 8, (C, C)) if kind == "int" else rng.random((C, C))
    M, sz = torch.from_numpy(m.astype(np.float32)).to(cuda), torch.from_numpy(sizes).to(cuda)
    got, again = sk.pair_profiles(M, sz, cmax), sk.pair_profiles(M, sz, cmax)
    assert torch.equal(got, again) and got.shape == (4 * 56 * 56, 2 * cmax - 1)
    exact = sk.pair_profiles_plain(M.double(), sz, cmax)
    _close_or_equal(got, sk.pair_profiles_plain(M, sz, cmax), kind, cmax, exact)
    if kind == "int":
        assert torch.equal(got, sk.pair_profiles_plain(M, sz, cmax, 1))


# the profile kernel's edges: (sizes, cmax); a block holds up to 8 pairs of a
# wrapped diagonal, a pair's diagonals spread over the block's 512 threads
_PROFILE_EDGES = {
    "one scaffold (Sp = 1)": ([37], 64),
    "two large scaffolds: a pair larger than a warp's share": ([300, 280, 7, 1, 0], 320),
    "every scaffold at cmax, with pads": ([64] * 11 + [0] * 5, 64),
    "cmax at the shared-memory limit: one pair a block": ([3000, 5, 0], 14400),
    "Sp = 600: ids past the scan's first chunk of 512": ([int(x) for x in np.arange(600) % 7 + 1],
                                                           8),
}


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("edge", list(_PROFILE_EDGES))
def test_pair_profiles_kernel_edges_match_plain(cuda, edge, kind):
    """Integer inputs exact, floats within ``sum_bound``, two launches
    bit-identical."""
    sizes, cmax = _PROFILE_EDGES[edge]
    sizes = np.asarray(sizes, dtype=np.int64)
    rng = np.random.default_rng(len(sizes) + cmax)
    C = int(sizes.sum())
    m = rng.integers(0, 8, (C, C)) if kind == "int" else rng.random((C, C))
    M, sz = torch.from_numpy(m.astype(np.float32)).to(cuda), torch.from_numpy(sizes).to(cuda)
    got, again = sk.pair_profiles(M, sz, cmax), sk.pair_profiles(M, sz, cmax)
    assert torch.equal(got, again)
    exact = sk.pair_profiles_plain(M.double(), sz, cmax)
    _close_or_equal(got, sk.pair_profiles_plain(M, sz, cmax), kind, cmax, exact)


@pytest.mark.parametrize("sizes", [[8, 8, 8, 0], [3, 70, 2, 0], [5, -1, 2], [4, 4, 4]])
def test_pair_profiles_kernel_nan_for_a_layout_that_overruns(cuda, sizes):
    """A size below 0 or above cmax, or past the matrix (C = 20), makes
    NaN rows for every pair that names the id; the other rows hold
    numbers."""
    C, cmax = 20, 64
    M = torch.rand((C, C), device=cuda)
    sz = torch.tensor(sizes, device=cuda)
    got = sk.pair_profiles(M, sz, cmax).reshape(len(sizes), len(sizes), 4, -1)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    bad = np.array([c < 0 or c > cmax or o + c > C for o, c in zip(offs, sizes)])
    want_nan = torch.from_numpy(bad[:, None] | bad[None, :]).to(cuda)
    assert torch.equal(torch.isnan(got).all(dim=3).all(dim=2), want_nan)
    assert not torch.isnan(got[~want_nan]).any()


@pytest.mark.parametrize("tile", [1, 100, 360, 5000])
@pytest.mark.parametrize("S,k", [(6, 64), (6, 11), (5, 7), (8, 3)])
def test_combo_topk_kernel_blocks_clipped_inside_orders(cuda, monkeypatch, S, k, tile):
    """Blocks of ``tile`` candidates cut groups (G = 360 at S = 6, k = 64: no
    multiple of R = 64) and orders at their edges; a group of several
    blocks goes through the merge launch.  Integer scores: exact."""
    monkeypatch.setattr(sk, "TOPK_TILE", tile)
    rng = np.random.default_rng(S * k + tile)
    combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
    cid = np.ascontiguousarray(combo["cid"][: 600 if S == 8 else None], dtype=np.int32)
    F = torch.from_numpy(rng.integers(0, 3, 4 * 9 * 9 * 65).astype(np.float32)).to(cuda)
    args = [F, torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4))).to(cuda),
            torch.from_numpy(cid).to(cuda),
            torch.from_numpy(np.array(perms.orient_batch(S))).to(cuda),
            torch.tensor(3.0, device=cuda)]
    got, again = sk.combo_score_topk(*args, k), sk.combo_score_topk(*args, k)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, sk.combo_score_topk_plain(*args, k)))
    assert torch.equal(sk.combo_scores(*args), sk.combo_scores_plain(*args))


def test_combo_kernel_nan_for_bad_combos_and_flags(cuda):
    """A cid outside [0, n_combo), an idx4 value outside F, or a flag other
    than 0 or 1: NaN for that order's or orientation's candidates only."""
    S = 5
    combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
    rng = np.random.default_rng(3)
    F = torch.rand(4 * 9 * 9 * 65, device=cuda)
    idx4 = rng.integers(0, F.numel(), (combo["n_combo"], 4))
    cid = np.ascontiguousarray(combo["cid"], dtype=np.int32)
    orients = np.array(perms.orient_batch(S))
    cid[3, 2] = combo["n_combo"]
    idx4[cid[7, 0], 1] = F.numel()           # V4[c, 1] is NaN for one combo of order 7
    orients[5, 1] = 2
    scores = sk.combo_scores(F, torch.from_numpy(idx4).to(cuda), torch.from_numpy(cid).to(cuda),
                             torch.from_numpy(orients).to(cuda),
                             torch.tensor(1.0, device=cuda)).cpu().numpy()
    # the NaN pattern in numpy: V4 NaN where idx4 leaves F, a bad cid or flag NaN
    f = F.cpu().numpy().astype(np.float64)
    v4 = np.where(idx4 < f.size, f[np.minimum(idx4, f.size - 1)], np.nan)
    good_cid = cid < combo["n_combo"]
    vals = np.where(good_cid[:, :, None], v4[np.where(good_cid, cid, 0)], np.nan)  # [Bo, P, 4]
    pi, pj = np.triu_indices(S, k=1)
    e = np.minimum(orients[:, pi], 1) * 2 + np.minimum(orients[:, pj], 1)      # [R, P]
    want = vals[:, np.arange(len(pi))[None, :], e].sum(axis=2)                  # [Bo, R]
    want[:, (orients > 1).any(axis=1)] = np.nan
    assert np.isnan(scores[3]).all() and np.isnan(scores[:, 5]).all()
    np.testing.assert_array_equal(np.isnan(scores), np.isnan(want))


@pytest.mark.parametrize("n", [6, 8])
def test_forced_escalation_on_cuda_equals_cpu(cuda, n):
    """Six or eight one-bin scaffolds: every orientation of an order ties
    exactly, so the brute force escalates to the dense block scores (at
    eight, 5,160,960 of them); the card decides as the CPU does, through the
    block kernel."""
    rng = np.random.default_rng(7)
    m = np.triu(rng.integers(1, 50, (n, n)).astype(np.float64), 1)
    names = [f"s{i}" for i in range(n)]
    decisions = {}
    for dev in (cuda, CPU):
        scorer = cost.ChromosomeScorer(m + m.T, [1] * n, dev)
        before = sk.LAUNCHES["block_score"]
        decisions[dev.type] = part2_order.brute_force_best(scorer, list(range(n)), names)
        assert scorer.stats.escalations > 0
        if dev.type == "cuda":
            assert sk.LAUNCHES["block_score"] > before
    assert decisions["cuda"] == decisions["cpu"]


# ---------------------------------------------------------------------------
# the combo top-k over tile counts, ragged groups and ties; the redesigned
# rank-count and pair-score kernels in both of their forms
# ---------------------------------------------------------------------------


# (S, k): 23,040 candidates at S = 6 in groups of 1 (k 8, ragged k 7), 2 (k 4)
# and 3 (k 2) tiles of TOPK_TILE; 5.16M at S = 8 in groups of 20 (k 64) and
# 115 (ragged k 11) tiles
_SWEEP_COMBOS = [(6, 8), (6, 7), (6, 4), (6, 2), (8, 64), (8, 11)]
# group_argmax over k = 3 groups of `tiles` tiles: exact, one short (ragged
# last group), one over (a last tile of one candidate)
_SWEEP_GROUPS = [(tiles, shape) for tiles in (1, 2, 3, 21) for shape in ("exact", "short", "over")]


@pytest.mark.parametrize("seed", range(5))
@pytest.mark.parametrize("case", [("combo", c) for c in _SWEEP_COMBOS]
                         + [("group", g) for g in _SWEEP_GROUPS], ids=str)
def test_topk_sweep_matches_plain_exactly(cuda, case, seed):
    """Integer scores tie within and across tiles: values, argmaxes (the
    lowest index) and second maxima equal ``_group_argmax`` bit for bit."""
    rng = np.random.default_rng(seed)
    kind, shape = case
    if kind == "combo":
        S, k = shape
        combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
        F = torch.from_numpy(rng.integers(0, 2, 9 * 9 * 4 * 65).astype(np.float32)).to(cuda)
        args = [F, torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4))).to(cuda),
                torch.from_numpy(np.ascontiguousarray(combo["cid"], dtype=np.int32)).to(cuda),
                torch.from_numpy(np.array(perms.orient_batch(S))).to(cuda),
                torch.tensor(3.0, device=cuda)]
        got, want = sk.combo_score_topk(*args, k), sk.combo_score_topk_plain(*args, k)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
        return
    tiles, form = shape
    k, tile = 3, sk.TOPK_TILE
    N = {"exact": k * tiles * tile, "short": k * tiles * tile - 5,
         "over": k * (tiles * tile + 1)}[form]
    for top in (4, 2**20):
        x = torch.from_numpy(rng.integers(0, top, N).astype(np.float32)).to(cuda)
        assert all(torch.equal(a, b) for a, b in zip(sk.group_argmax(x, k), sk._group_argmax(x, k)))


def _count_batch(rng, n, K):
    """K scans over n rows: growing and fixed, a few starts shared by many
    fixed scans, and (K > 4) the pow2 padding's repeated last row."""
    starts = rng.integers(0, n, max(1, K // 16))
    rows = []
    for _ in range(K - K // 4 if K > 4 else K):
        s = int(rng.choice(starts))
        rows.append((s, 0, 1) if rng.random() < 0.3 else (s, s + int(rng.integers(-5, 2500)), 0))
    params = bp._pow2_params(rows)
    assert len(params) == K
    return params


@pytest.mark.parametrize("dtype", [torch.int16, torch.int32])
@pytest.mark.parametrize("K", [1, 8, 512, 2048])
def test_rank_counts_kernel_batches_match_plain(cuda, dtype, K):
    """Both element types at K = 1 to 2,048 (over one chunk of
    CHUNK_SCANS), on the padded matrix (phantom pad rows included), a
    column view, an unaligned view (scalar loads) and a block with its
    offsets."""
    n = 3000
    rng = np.random.default_rng(K)
    padded = ck.pad_rank(torch.from_numpy(_rank(n, 2)).to(cuda)).to(dtype)
    params = _count_batch(rng, n, K)
    if K == 2048:
        assert ck.plan_batch(params)[1] > 1
    before = ck.LAUNCHES
    views = ((padded, 0, 0), (padded[:, :2048], 0, 0), (padded[:, 3:2000], 0, 3),
             (padded[1024:2048, 512:2560], 1024, 512))
    for mat, row0, col0 in views:
        got = ck.counts_many(mat, params, row0=row0, col0=col0)
        assert torch.equal(got, ck.counts_many_plain(mat, params, row0=row0, col0=col0)), \
            (tuple(mat.shape), row0, col0)
    assert ck.LAUNCHES == before + len(views)


def _pair_candidates(rng, B, shape, Sp=56, W=56):
    """``B`` rows of 55 real ids and a pad: random, or (``window``) the
    first B rows of a sliding-window batch of 16 positions x 1,920."""
    ids = np.full((B, W), Sp - 1, dtype=np.int32)
    flags = rng.integers(0, 2, (B, W)).astype(np.int32)
    if shape == "random":
        for b in range(B):
            ids[b, :55] = rng.permutation(Sp - 1)[:55]
        return np.concatenate([ids, flags], axis=1)
    orders_w, orients_w = perms.order_batch(5), perms.orient_batch(5)
    B_w = len(orders_w) * len(orients_w)
    idx_w = np.repeat(np.asarray(orders_w, dtype=np.int64), len(orients_w), axis=0)
    orient_blk = np.tile(np.asarray(orients_w, dtype=np.int32), (len(orders_w), 1))
    base_o, base_f = ids[0].copy(), flags[0].copy()
    base_o[:55] = rng.permutation(Sp - 1)[:55]
    full_o, full_f = np.tile(base_o, (16 * B_w, 1)), np.tile(base_f, (16 * B_w, 1))
    for k in range(16):
        blk = slice(k * B_w, (k + 1) * B_w)
        full_o[blk, k:k + 5] = base_o[k + idx_w]
        full_f[blk, k:k + 5] = orient_blk
    return np.concatenate([full_o[:B], full_f[:B]], axis=1)


@pytest.mark.parametrize("kind", ["int", "float"])
@pytest.mark.parametrize("shape", ["random", "window"])
@pytest.mark.parametrize("B", [1, 112, 509, 30720])
def test_pair_scores_batches_match_plain(cuda, B, shape, kind):
    """B = 1 to 30,720, random and sliding-window rows: integer inputs
    exact, floats within ``sum_bound``, two launches bit-identical."""
    rng = np.random.default_rng(B)
    Sp, Cp1, W = 56, 769, 56
    sizes = np.zeros(Sp, dtype=np.int64)
    sizes[: Sp - 1] = rng.integers(1, 14, Sp - 1)
    cand = _pair_candidates(rng, B, shape)
    args = (_score_table(rng, Sp, Cp1, kind, sizes).to(cuda), torch.from_numpy(sizes).to(cuda),
            torch.from_numpy(cand).to(cuda), _scalar(rng, kind).to(cuda))
    got, again = sk.pair_scores(*args), sk.pair_scores(*args)
    assert torch.equal(got, again)
    exact = sk.pair_scores_plain(args[0].double(), args[1], args[2], args[3].double())
    _close_or_equal(got, sk.pair_scores_plain(*args), kind, W * (W - 1) // 2 + 1, exact)


# ---------------------------------------------------------------------------
# Part 2's copies: pinned uploads and readbacks (utils/transfer)
# ---------------------------------------------------------------------------

_SPIN = 50_000_000  # cycles of torch.cuda._sleep: about 25 ms of a held stream


def test_uploads_survive_their_sources(cuda, monkeypatch):
    """2,000 distinct small arrays queued behind a spin kernel, each source
    dropped as soon as ``to_device`` returns, then a chunked upload and a
    write into a strided view: every value arrives (the caching host
    allocator reuses no staging block while its copy is in flight)."""
    rng = np.random.default_rng(0)
    torch.cuda._sleep(_SPIN)
    outs, want = [], []
    for i in range(2000):
        a = rng.standard_normal(1 + i % 97) + i
        dtype = (np.float32, np.float64, np.int64)[i % 3]
        want.append(a.astype(dtype))
        outs.append(transfer.to_device(a, cuda, dtype))
        del a
    monkeypatch.setattr(transfer, "CHUNK_BYTES", 4096)
    big = rng.standard_normal((300, 257)).astype(np.float32)
    want.append(big.copy())
    outs.append(transfer.to_device(big, cuda))
    del big
    blk = torch.full((40, 64), -1.0, device=cuda)
    part = rng.standard_normal((25, 30))
    transfer.copy_into(blk[5:30, 2:32], part)          # cast on the host, strided target
    torch.cuda.synchronize()
    for got, w in zip(outs, want):
        assert got.device.type == "cuda" and str(got.dtype).endswith(w.dtype.name)
        np.testing.assert_array_equal(got.cpu().numpy(), w)
    host = blk.cpu().numpy()
    np.testing.assert_array_equal(host[5:30, 2:32], part.astype(np.float32))
    assert (host[:5] == -1).all() and (host[30:] == -1).all() and (host[:, 32:] == -1).all()


def test_readback_bit_equal_and_kept_alive(cuda):
    """``start_readback`` / ``finish_readback`` give ``.cpu()``'s bits for
    handles queued behind a spin kernel, the arrays of every earlier pass
    stay intact while later passes draw on the allocator, and readbacks
    given out of the order they started are all waited for."""
    gen = torch.Generator(device=cuda).manual_seed(3)
    kept = []
    for p in range(60):
        handles = (torch.randn(1 + p * 7, device=cuda, generator=gen),
                   torch.randint(-2**40, 2**40, (9,), device=cuda, generator=gen),
                   torch.randn((), device=cuda, dtype=torch.float64, generator=gen))
        torch.cuda._sleep(_SPIN // 25)
        pending = [transfer.start_readback(handles), transfer.start_readback(handles[:1])]
        assert len(pending[0].events) == 1
        got = transfer.finish_readback(pending[::-1] if p % 2 else pending)
        if p % 2:
            got = got[::-1]
        want = [h.cpu().numpy() for h in handles]
        for g, w in zip(got[0] + got[1], want + want[:1]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
        kept.append((got, want))
    for got, want in kept:
        for g, w in zip(got[0], want):
            assert g.tobytes() == w.tobytes()
    # the escalation's drain: rows into one pinned buffer
    parts = [(0, 3, torch.randn(5, 4, device=cuda, generator=gen)),
             (3, 2, torch.randn(2, 4, device=cuda, generator=gen))]
    got = cost._drain_rows(parts, (5, 4))
    want = np.concatenate([t[:n].cpu().numpy() for _o, n, t in parts]).astype(np.float64)
    np.testing.assert_array_equal(got, want)


def test_part2_scheduler_makes_no_pageable_copy(cuda):
    """Part 2's interleaved search over real scorers on the card, under
    torch.profiler: pinned copies both ways and no pageable one; its
    orders equal the CPU's."""
    from torch.profiler import ProfilerActivity, profile

    genome = fixtures.make_genome(
        chrom_scaffold_bins=((9, 7, 6, 5, 4, 3), (8, 6, 5, 4), (7, 6, 5, 4, 3, 2)), seed=11)
    bins = [hicpro.Bin(bid, s.name, 0, 0, 1.0, 0.0) for s in genome.scaffolds for bid in s.bin_ids]
    groups = [[[bid, name] for name in names for bid in genome.scaffold(name).bin_ids]
              for _c, names in sorted(genome.true_groups().items())]

    def run(device):
        out = part2_order.order_genome(genome.matrix, groups, bins, genome.resolution, device,
                                       n_scaffolds=4, scan_scaffolds=3, plot_chrom=False)
        return [[(s.name, s.orientation) for s in g] for g in out]

    want = run(CPU)
    run(cuda)  # warm: kernels built, allocator primed
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = run(cuda)
        torch.cuda.synchronize()
    assert got == want
    copies = {e.key: e.count for e in prof.key_averages() if "Memcpy" in e.key}
    assert not [k for k in copies if "Pageable" in k], copies
    assert any("HtoD" in k and "Pinned" in k for k in copies), copies
    assert any("DtoH" in k and "Pinned" in k for k in copies), copies


def test_readback_from_two_cards():
    """Handles on cuda:1 (the second card current or not) are read back on
    cuda:1's stream with its own event; a scorer whose mesh starts on
    cuda:1 uploads there and reads back the CPU's scores."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA GPUs and nvcc")
    cards = [torch.device("cuda", i) for i in (0, 1)]
    torch.cuda.set_device(cards[0])
    a = torch.arange(10.0, device=cards[0])
    with torch.cuda.device(cards[1]):
        torch.cuda._sleep(_SPIN)
    b = torch.arange(6, device=cards[1]) * 3
    r = transfer.start_readback([a, b])
    assert sorted(key[0] for key in r.events) == [0, 1]
    r1 = transfer.start_readback([b + 1])
    got = transfer.finish_readback([r1, r])
    assert got[1][0].tolist() == list(range(10)) and got[1][1].tolist() == [3 * i for i in range(6)]
    assert got[0][0].tolist() == [3 * i + 1 for i in range(6)]

    rng = np.random.default_rng(8)
    m = np.triu(rng.integers(0, 9, (40, 40)).astype(np.float64), 1)
    sizes = [9, 8, 7, 6, 5, 5]
    on_second = cost.ChromosomeScorer(m + m.T, sizes, cards[0],
                                      mesh=pm.make_mesh((1, 1), [cards[1]])).full()
    assert on_second.device == cards[1] and on_second._F_flat.device == cards[1]
    cpu = cost.ChromosomeScorer(m + m.T, sizes, CPU).full()
    orders = np.tile(np.arange(6, dtype=np.int32), (4, 1))
    orients = rng.integers(0, 2, (4, 6)).astype(np.int32)
    np.testing.assert_allclose(on_second.score_pairs(orders, orients),
                               cpu.score_pairs(orders, orients), rtol=1e-5, atol=0)
