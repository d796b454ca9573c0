"""The port's RankCounts and cut detection against the JAX package's, above
``_HOST_N`` so that both take their device count path (XLA on the CPU for
the JAX package, the plain torch counts for the port)."""

import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu.cluster import breakpoints as jax_bp
from hic_genome_assembler_tpu.ops import oracle
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
from hic_genome_assembler_tpu_torch.utils import state

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def random_rank():
    rng = np.random.default_rng(4)
    n = bp._HOST_N + 160
    # valid rank matrix: each row a permutation (what rank_matrix_desc yields)
    return np.argsort(rng.random((n, n)), axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def planted_rank():
    """Rank matrix of a similarity map with five planted chromosomes, in
    dendrogram order, n = _HOST_N + 160: the cut search finds real cuts."""
    rng = np.random.default_rng(11)
    sizes = (1200, 1000, 900, 800, bp._HOST_N + 160 - 3900)
    labels = np.repeat(np.arange(len(sizes)), sizes)
    n = len(labels)
    pos = np.arange(n)
    same = labels[:, None] == labels[None, :]
    sim = np.where(same, 100.0 / (1.0 + np.abs(pos[:, None] - pos[None, :])), 0.0)
    noise = np.triu(rng.random((n, n)) * 0.5, 1)
    sim = sim + noise + noise.T
    return oracle.rank_matrix_desc(sim).astype(np.int32)


def test_pending_speculation_matches_host_counts(random_rank):
    """prefetch_growing / prefetch_fixed_pairs / pending materialization
    give the host scan's counts (mirrors tests/test_part1.py)."""
    n = random_rank.shape[0]
    dev = bp.RankCounts(random_rank, CPU)
    assert dev._host is None and dev.where == "cpu"
    assert len(dev._blocks) == len(dev._blocks[0]) == 1
    assert dev._blocks[0][0].shape == (n + (-n % 32),) * 2

    starts = [0, 7, 123, 2049, n - 9]
    dev.prefetch_growing(starts)
    assert dev._pending
    for s in starts:
        np.testing.assert_array_equal(
            dev.growing(s), jax_bp._host_growing_counts(random_rank, s)
        )
    assert not dev._pending  # materialized wholesale

    pairs = [(0, 5), (17, 900), (900, 17), (5, n - 1), (n - 2, n - 1)]
    dev.prefetch_fixed_pairs(pairs)
    for s, c in pairs:
        np.testing.assert_array_equal(
            dev.fixed(s, c), jax_bp._host_fixed_counts(random_rank, s, c)
        )


def test_counts_equal_jax_rankcounts(random_rank):
    """Growing and fixed counts equal the JAX RankCounts' device path."""
    n = random_rank.shape[0]
    ours = bp.RankCounts(random_rank, CPU)
    theirs = jax_bp.RankCounts(random_rank)
    assert theirs._host is None
    for s in (0, 1, 2048, n - 1):
        np.testing.assert_array_equal(ours.growing(s), theirs.growing(s))
    for s, c in ((0, 4096), (100, 3000), (3000, 100), (n - 300, n - 1)):
        np.testing.assert_array_equal(ours.fixed(s, c), theirs.fixed(s, c))


def test_cut_lists_equal_jax(planted_rank):
    """pre_process_all_matrix_breakpoints and filter_noisy_breakpoints give
    the JAX package's cut lists on the same rank matrix."""
    ours = bp.RankCounts(planted_rank, CPU)
    theirs = jax_bp.RankCounts(planted_rank)
    assert ours._host is None and theirs._host is None
    init_ours = bp.pre_process_all_matrix_breakpoints(ours, min_size=15, min_frac=0.0)
    init_theirs = jax_bp.pre_process_all_matrix_breakpoints(theirs, min_size=15, min_frac=0.0)
    assert init_ours == init_theirs
    assert {1200, 2200, 3100} <= set(init_ours)
    filt_ours = bp.filter_noisy_breakpoints(ours, init_ours, psig=0.05)
    filt_theirs = jax_bp.filter_noisy_breakpoints(theirs, init_theirs, psig=0.05)
    assert filt_ours == filt_theirs
    assert {1200, 2200, 3100} <= set(filt_ours)


def test_host_path_below_threshold_matches_jax():
    rng = np.random.default_rng(9)
    rank = np.argsort(rng.random((300, 300)), axis=1).astype(np.int32)
    ours = bp.RankCounts(rank, CPU)
    theirs = jax_bp.RankCounts(rank)
    assert ours.where == "host" and theirs._host is not None
    ours.prefetch_growing([0, 5])  # host mode: nothing to launch
    assert not ours._pending
    np.testing.assert_array_equal(ours.growing(5), theirs.growing(5))
    np.testing.assert_array_equal(ours.fixed(3, 200), theirs.fixed(3, 200))


def test_state_round_trip_from_jax_rankcounts(random_rank):
    """rank_counts_from_numpy takes the JAX RankCounts' device array (and
    a uint16-style 65535-padded layout) and counts identically."""
    n = random_rank.shape[0]
    theirs = jax_bp.RankCounts(random_rank)
    ours = state.rank_counts_from_numpy(np.asarray(theirs._dev), n, CPU)
    padded = np.full((n + (-n % 512), n + (-n % 2048)), 65535, dtype=np.int32)
    padded[:n, :n] = random_rank
    ours_padded = state.rank_counts_from_numpy(padded, n, CPU)
    for s in (0, 17, n - 5):
        want = theirs.growing(s)
        np.testing.assert_array_equal(ours.growing(s), want)
        np.testing.assert_array_equal(ours_padded.growing(s), want)
    np.testing.assert_array_equal(ours.fixed(10, 2500), theirs.fixed(10, 2500))
    block = ours._blocks[0][0]
    assert torch.equal(block[:n, :n], torch.from_numpy(random_rank))
    assert (block[n:] == -1).all() and (block[:, n:] == -1).all()
    with pytest.raises(ValueError):
        state.rank_counts_from_numpy(padded[:100], n, CPU)
