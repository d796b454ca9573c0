"""The port's scoring engine against the JAX package's, on the CPU.

Fast f32 scores may differ in the last bits (another summation order), so
they are held to a relative 1e-5 of the score, far inside the 1e-4
decision margin of docs/PRECISION.md; f64 decisions must be identical.
"""

import warnings

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from hic_genome_assembler_tpu.models import part2_order as jax_part2  # noqa: E402
from hic_genome_assembler_tpu.ops import cost as jax_cost  # noqa: E402
from hic_genome_assembler_tpu.ops import oracle, perms  # noqa: E402
from hic_genome_assembler_tpu.utils import fixtures  # noqa: E402
from hic_genome_assembler_tpu_torch.models import part2_order  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import cost  # noqa: E402
from hic_genome_assembler_tpu_torch.utils import state  # noqa: E402

CPU = torch.device("cpu")
RTOL = 1e-5  # f32 summation-order allowance, relative to the score


@pytest.fixture(scope="module")
def chromosome():
    """One fixture chromosome in part 2's canonical layout (scaffolds
    size-descending, bins ascending): (submatrix, sizes)."""
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((12, 9, 7, 6, 5, 4, 3, 2, 2, 1),), seed=5, noise=0.01
    )
    scaffolds = sorted(genome.scaffolds, key=lambda s: s.n_bins, reverse=True)
    bins = [b for s in scaffolds for b in sorted(s.bin_ids)]
    return genome.matrix[np.ix_(bins, bins)], [s.n_bins for s in scaffolds]


@pytest.fixture(scope="module")
def scorers(chromosome):
    sub, sizes = chromosome
    return (
        cost.ChromosomeScorer(sub, sizes, CPU),
        jax_cost.ChromosomeScorer(sub, sizes, dtype=np.float32),
    )


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=0)


def test_profiles_and_host_bookkeeping_match(scorers):
    ours, theirs = scorers
    for key in ("Sp", "cmax", "L", "C_pad", "S", "C"):
        assert getattr(ours, key) == getattr(theirs, key), key
    for key in ("intra_profile", "intra_total", "cross_total", "sizes"):
        np.testing.assert_array_equal(getattr(ours, key), getattr(theirs, key), err_msg=key)
    h_ours, h_theirs = ours._h.numpy(), np.asarray(theirs._h)
    assert h_ours.shape == h_theirs.shape and h_ours.dtype == np.float32
    np.testing.assert_allclose(h_ours, h_theirs, rtol=0, atol=RTOL * np.abs(h_theirs).max())


def test_scatter_profile_build_matches(chromosome, scorers, monkeypatch):
    """The scatter-add build (taken when the skew chunk would exceed its
    budget) gives the skew build's profiles, in both packages."""
    sub, sizes = chromosome
    monkeypatch.setattr(cost.sk, "SKEW_CHUNK_ELEMS", 1)
    monkeypatch.setattr(jax_cost, "_SKEW_CHUNK_ELEMS", 1)
    scatter = cost.ChromosomeScorer(sub, sizes, CPU)._h.numpy()
    jax_scatter = np.asarray(jax_cost.ChromosomeScorer(sub, sizes, dtype=np.float32)._h)
    skew = scorers[0]._h.numpy()
    atol = RTOL * np.abs(skew).max()
    np.testing.assert_allclose(scatter, skew, rtol=0, atol=atol)
    np.testing.assert_allclose(scatter, jax_scatter, rtol=0, atol=atol)


def test_combo_and_block_scores_match(scorers):
    """Brute force over the 6 largest scaffolds: the dense block scores,
    and the combo top-k values, equal the JAX package's."""
    ours, theirs = scorers
    head = list(range(6))
    sub_o, sub_t = ours.subset(head), theirs.subset(head)
    assert sub_o.c0 == sub_t.c0 and sub_o.total == sub_t.total
    orders, orients = perms.order_batch(6), perms.orient_batch(6)
    dense_o = sub_o.score_batch(orders, orients)
    dense_t = sub_t.score_batch(orders, orients)
    _close(dense_o, dense_t)
    idx, vals, floor = sub_o.score_batch_topk(orders, orients, k=16)
    idx_t, _vals_t, _floor_t = sub_t.score_batch_topk(orders, orients, k=16)
    assert len(idx) == 16
    _close(vals, dense_t[idx])
    assert int(idx[np.argmax(vals)]) == int(idx_t[np.argmax(_vals_t)])
    assert floor <= vals.max()


def test_block_topk_path_matches(scorers):
    """More than 8 scaffolds takes the block top-k path (not the combo
    factorization); its values equal the JAX package's dense scores."""
    ours, theirs = scorers
    head = list(range(9))
    rng = np.random.default_rng(2)
    orders = np.stack([rng.permutation(9) for _ in range(64)])
    orients = rng.integers(0, 2, (64, 9)).astype(np.int32)
    sub_o, sub_t = ours.subset(head), theirs.subset(head)
    dense_t = sub_t.score_batch(orders, orients)
    _close(sub_o.score_batch(orders, orients), dense_t)
    idx, vals, floor = sub_o.score_batch_topk(orders, orients, k=32, chunk_orders=48)
    _close(vals, dense_t[idx])
    idx_t, vals_t, floor_t = sub_t.score_batch_topk(orders, orients, k=32, chunk_orders=48)
    assert int(idx[np.argmax(vals)]) == int(idx_t[np.argmax(vals_t)])
    assert floor == pytest.approx(floor_t, rel=RTOL)


def test_pair_scores_match(scorers):
    """Per-candidate scoring with pad slots, as greedy insertion and the
    sliding window call it."""
    ours, theirs = scorers
    rng = np.random.default_rng(3)
    W = ours.cand_width
    include = [0, 2, 3, 5, 7, 9]
    orders = np.full((40, W), ours.pad_id, dtype=np.int32)
    orients = np.zeros((40, W), dtype=np.int32)
    for b in range(40):
        orders[b, : len(include)] = rng.permutation(include)
        orients[b, : len(include)] = rng.integers(0, 2, len(include))
    got = ours.subset(include).score_pairs(orders, orients)
    want = theirs.subset(include).score_pairs(orders, orients)
    _close(got, want)


def test_group_argmax_ties_lowest_index_first():
    """Value, index and second max agree with the JAX package's, with
    planted ties inside and across groups and a padded last group."""
    flat = np.array(
        [1.0, 5.0, 5.0, 2.0, 7.0, 7.0, 7.0, 0.5, -1.0, 3.0, 3.0, 9.0, 9.0, 2.0, 4.0,
         4.0, 6.0, 6.0, 1.0, 0.0, 8.0, 8.0, 8.0, 8.0, 3.5],
        dtype=np.float32,
    )
    for k in (5, 7, 25, 1):
        vals, idx, second = (t.numpy() for t in cost._group_argmax(torch.from_numpy(flat), k))
        want = [np.asarray(a) for a in jax_cost._group_argmax(jnp.asarray(flat), k)]
        np.testing.assert_array_equal(vals, want[0])
        np.testing.assert_array_equal(idx, want[1])
        np.testing.assert_array_equal(second, want[2])
        # lowest index among a group's ties (np.argmax takes the first)
        G = -(-len(flat) // k)
        padded = np.concatenate([flat, np.full(G * k - len(flat), -np.inf, np.float32)])
        for g, i in enumerate(idx):
            assert i == g * G + int(np.argmax(padded[g * G : (g + 1) * G]))


def test_f64_decisions_identical(chromosome):
    """The three search stages make the JAX package's decisions, with the
    identical f64 best costs."""
    sub, sizes = chromosome
    ours = cost.ChromosomeScorer(sub, sizes, CPU)
    theirs = jax_cost.ChromosomeScorer(sub, sizes, dtype=np.float32)
    names = [f"s{i}" for i in range(len(sizes))]
    head, tail = list(range(6)), list(range(6, len(sizes)))
    bf = part2_order.brute_force_best(ours, head, names)
    assert bf == jax_part2.brute_force_best(theirs, head, names)
    gr = part2_order.order_remainder_scaffolds(ours, list(bf[0]), list(bf[1]), list(tail))
    gr_t = jax_part2.order_remainder_scaffolds(theirs, list(bf[0]), list(bf[1]), list(tail))
    assert gr == gr_t
    sc = part2_order.scan_ordering(ours, list(gr[0]), list(gr[1]), gr[2], 4)
    assert sc == jax_part2.scan_ordering(theirs, list(gr[0]), list(gr[1]), gr[2], 4)
    assert ours.stats.n > 0 and ours.stats.violations == 0


def test_scorer_state_round_trip(chromosome, scorers):
    """chromosome_scorer_from_numpy carries the JAX scorer's state: scores
    from the JAX table equal the JAX package's, no profile rebuilt."""
    sub, sizes = chromosome
    theirs = scorers[1]
    arrays = {k: np.asarray(getattr(theirs, k)) for k in (
        "_h", "_sizes_d", "sizes", "_sub", "intra_profile", "intra_total", "cross_total")}
    arrays.update({k: getattr(theirs, k) for k in ("Sp", "cmax", "L", "C_pad")})
    carried = state.chromosome_scorer_from_numpy(arrays, CPU)
    np.testing.assert_array_equal(carried._h.numpy(), np.asarray(theirs._h))
    orders, orients = perms.order_batch(5), perms.orient_batch(5)
    head = [0, 1, 2, 3, 4]
    _close(carried.subset(head).score_batch(orders, orients),
           theirs.subset(head).score_batch(orders, orients))
    names = [f"s{i}" for i in range(len(sizes))]
    assert part2_order.brute_force_best(carried, head, names) == \
        jax_part2.brute_force_best(theirs, head, names)
    with pytest.raises(ValueError):
        state.chromosome_scorer_from_numpy({"_h": arrays["_h"]}, CPU)


# ---------------------------------------------------------------------------
# cases of the tests/test_margins.py adversarial battery, on the port
# ---------------------------------------------------------------------------


def _serial_reference_search(m, sizes):
    """Strict-> running max over the reference enumeration order, every
    candidate scored by the f64 oracle kernel."""
    S = len(sizes)
    total = cost.upper_triangle_total(m)
    best, best_idx, idx = -np.inf, None, 0
    for o in perms.order_batch(S):
        for r in perms.orient_batch(S):
            bin_order = cost.bin_order_of_block(o, r, sizes)
            c = oracle.cost_function(m[np.ix_(bin_order, bin_order)], total)
            if c > best:
                best, best_idx = c, idx
            idx += 1
    return best_idx, best


def _device_search(m, sizes, k=16):
    scorer = cost.ChromosomeScorer(m.astype(np.float64), sizes, CPU).full()
    orders, orients = perms.order_batch(len(sizes)), perms.orient_batch(len(sizes))
    R = len(orients)
    idx, vals, floor = scorer.score_batch_topk(orders, orients, k=k)
    return cost.argmax_reference_ties_sparse(
        idx,
        rescore_many=lambda idx: scorer.score_host_many(orders[idx // R], orients[idx % R]),
        fast_vals=vals,
        second_floor=floor,
        escalate=lambda: scorer.score_batch(orders, orients),
        stats=scorer.stats,
    )


def _block_matrix(rng, sizes):
    C = sum(sizes)
    pos = np.arange(C, dtype=np.float64)
    m = 50.0 / (1.0 + np.abs(pos[:, None] - pos[None, :]))
    m += rng.random((C, C))
    m = np.triu(m, 1)
    return m + m.T


def test_duplicate_scaffolds_exact_ties_earliest_wins():
    rng = np.random.default_rng(7)
    sizes = [4, 4, 3, 2]
    m = _block_matrix(rng, sizes)
    a0, a1, rest = slice(0, 4), slice(4, 8), slice(8, None)
    m[a1, a1] = m[a0, a0]
    m[a1, rest] = m[a0, rest]
    m[rest, a1] = m[rest, a0]
    m[a0, a1] = m[a0, a0]
    m[a1, a0] = m[a0, a0]
    ref_idx, ref_best = _serial_reference_search(m, sizes)
    dev_idx, dev_best = _device_search(m, sizes)
    assert dev_idx == ref_idx
    assert dev_best == pytest.approx(ref_best, rel=1e-11)


@pytest.mark.parametrize("eps_rel", [1e-9, 1e-7, 1e-5, 1e-4])
def test_engineered_near_tie_straddling_f32(eps_rel):
    rng = np.random.default_rng(int(1 / eps_rel) % 2**31)
    sizes = [3, 3, 2, 2]
    m = _block_matrix(rng, sizes)
    a0, a1, rest = slice(0, 3), slice(3, 6), slice(6, None)
    m[a1, a1] = m[a0, a0]
    m[a1, rest] = m[a0, rest] * (1.0 + eps_rel)
    m[rest, a1] = m[a1, rest].T
    m[a0, a1] = m[a0, a0]
    m[a1, a0] = m[a0, a0]
    ref_idx, ref_best = _serial_reference_search(m, sizes)
    dev_idx, dev_best = _device_search(m, sizes)
    assert dev_idx == ref_idx
    assert dev_best == pytest.approx(ref_best, rel=1e-11)


def test_dense_escalation_recovers_suppressed_winner():
    """The winner's fast score is pushed under a decoy's: the adaptive
    loop finds it, and the run's own stats flag the discrepancy."""
    n = 200
    exact_vals = np.linspace(1.0, 9.0, n)
    exact_vals[137] = 10.0
    fast = exact_vals.copy()
    fast[137] = 10.0 - 5e-5 * 10.0
    exact_vals[42] = 9.99995
    fast[42] = 9.9995 + 4e-5 * 10.0
    stats = cost.PrecisionStats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        w, b = cost.argmax_reference_ties(
            fast, rescore_many=lambda idx: exact_vals[idx], k=4, stats=stats
        )
    assert (w, b) == (137, 10.0)
    assert stats.violations > 0
    assert cost.PrecisionStats().violations == 0  # nothing process-wide


def test_part2_pipeline_immune_to_submargin_noise(monkeypatch):
    """Sub-margin noise on every fast score leaves every part-2 decision
    unchanged, and the run's PrecisionStats reports the violations."""
    from hic_genome_assembler_tpu.io import hicpro

    amp = 3.0e-5  # < _F32_MARGIN, > _F32_MARGIN / 8
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((9, 7, 5, 3, 2), (8, 6, 4, 2)), seed=21, noise=0.004,
        cross_noise_frac=0.0,
    )
    bins = [hicpro.Bin(bid, s.name, 0, 0, 1.0, 0.0) for s in genome.scaffolds for bid in s.bin_ids]
    chrom_list = []
    for _c, names in sorted(genome.true_groups().items()):
        chrom_list.append(
            [[bid, name] for name in names for bid in genome.scaffold(name).bin_ids]
        )

    def run(stats):
        out = part2_order.order_genome(
            genome.matrix, chrom_list, bins, genome.resolution, CPU,
            n_scaffolds=4, scan_scaffolds=4, plot_chrom=False, stats=stats,
        )
        return [[(s.name, s.orientation) for s in g] for g in out]

    clean_stats = cost.PrecisionStats()
    clean = run(clean_stats)
    rng = np.random.default_rng(3)
    orig_pairs = cost.SubsetScorer.score_pairs_async
    orig_topk = cost.SubsetScorer.score_batch_topk_async

    def noisy_pairs(self, orders, orients):
        handles, fin = orig_pairs(self, orders, orients)

        def fin2(host):
            out = fin(host)
            if out.size:
                scale = max(float(np.abs(out).max()), 1.0)
                out = out + amp * scale * rng.uniform(-1, 1, out.shape)
            return out

        return handles, fin2

    def noisy_topk(self, orders, orients, k=64, chunk_orders=20160):
        handles, fin = orig_topk(self, orders, orients, k=k, chunk_orders=chunk_orders)

        def fin2(host):
            idx, vals, floor = fin(host)
            if len(vals):
                scale = max(float(np.abs(vals).max()), 1.0)
                vals = vals + amp * scale * rng.uniform(-1, 1, vals.shape)
                floor = floor + amp * scale
            return idx, vals, floor

        return handles, fin2

    monkeypatch.setattr(cost.SubsetScorer, "score_pairs_async", noisy_pairs)
    monkeypatch.setattr(cost.SubsetScorer, "score_batch_topk_async", noisy_topk)
    noisy_stats = cost.PrecisionStats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        noisy = run(noisy_stats)
    assert noisy == clean
    assert clean_stats.violations == 0
    assert noisy_stats.violations > 0
    assert noisy_stats.max_rel == pytest.approx(amp, rel=0.9)
