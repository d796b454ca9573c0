"""The port's ``BlockScorer`` and dense escalation against the JAX package's.

``cost.BlockScorer`` (``ChromosomeScorer(...).full()`` in both packages) is
driven through the cases of the JAX package's ``tests/test_cost.py``,
``tests/test_topk.py`` and ``tests/test_margins.py`` on ``-device cpu``
(where its scoring wrappers run their plain versions), and each result is
held against the JAX ``BlockScorer``'s on the same numpy inputs: float64
scores within a relative 1e-12 of each other (two summation orders) and
1e-9 of the reference formula, top-k sets and f64 decisions equal.  Last,
part 2's brute force over eight one-bin scaffolds escalates to the dense
scores (5,160,960 candidates) in both packages and decides alike.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from hic_genome_assembler_tpu.models import part2_order as jax_part2  # noqa: E402
from hic_genome_assembler_tpu.ops import cost as jax_cost  # noqa: E402
from hic_genome_assembler_tpu.ops import oracle, perms  # noqa: E402
from hic_genome_assembler_tpu.parallel import mesh as jax_pm  # noqa: E402
from hic_genome_assembler_tpu_torch.models import part2_order  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import cost  # noqa: E402
from hic_genome_assembler_tpu_torch.parallel import mesh as pm  # noqa: E402

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _reset_jax_precision():
    jax_cost.PRECISION.reset()
    yield
    jax_cost.PRECISION.reset()


def _problem(seed, sizes, diag=True, scale=1.0):
    """tests/test_cost.py's random_block_problem and tests/test_topk.py's
    _problem: a random symmetric matrix with a random diagonal."""
    rng = np.random.default_rng(seed)
    C = sum(sizes)
    m = np.triu(rng.random((C, C)) * scale, 1)
    m = m + m.T + (np.diag(rng.random(C)) if diag else 0.0)
    return m, list(sizes)


def _scorers(m, sizes, mesh=None, jax_mesh=None):
    return (cost.BlockScorer(m, sizes, CPU, dtype=np.float64, mesh=mesh),
            jax_cost.BlockScorer(m, sizes, dtype=np.float64, mesh=jax_mesh))


def _batch(S):
    return perms.order_batch(S), perms.orient_batch(S)


@pytest.mark.parametrize("seed,sizes", [(4, (4, 3, 2, 1)), (5, (1, 1, 1, 2))],
                         ids=["exhaustive (test_cost.py:30)", "single bins (test_cost.py:52)"])
def test_dense_scores_match_jax_and_the_reference(seed, sizes):
    """Every (order, orientation) of a 4-scaffold brute force: the dense
    scores equal the JAX BlockScorer's and the reference formula's, and the
    host f64 path is reference-exact."""
    m, sizes = _problem(seed, sizes, scale=10.0)
    ours, theirs = _scorers(m, sizes)
    orders, orients = _batch(len(sizes))
    got = ours.score_batch(orders, orients)
    np.testing.assert_allclose(got, theirs.score_batch(orders, orients), rtol=1e-12, atol=0)
    assert got.shape == (perms.calc_possible_perms(len(sizes)),)
    idx = 0
    for o in orders:
        for r in orients:
            bo = cost.bin_order_of_block(o, r, sizes)
            want = oracle.cost_function(m[np.ix_(bo, bo)], ours.total)
            assert got[idx] == pytest.approx(want, rel=1e-9)
            assert ours.score_host(o, r) == want == theirs.score_host(o, r)
            idx += 1


@pytest.mark.parametrize("seed,k,chunk_orders", [(0, 16, 20160), (3, 8, 5)],
                         ids=["top-k (test_topk.py:17)", "chunked merge (test_topk.py:29)"])
def test_topk_matches_jax(seed, k, chunk_orders):
    """The top-k path (the combo factorization at S = 4) returns the JAX
    package's candidates and values, holds the dense winner, and the sparse
    tie rule picks the dense rule's winner in both packages."""
    m, sizes = _problem(seed, (5, 4, 3, 2))
    ours, theirs = _scorers(m, sizes)
    orders, orients = _batch(len(sizes))
    R = len(orients)
    full = ours.score_batch(orders, orients)
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=k, chunk_orders=chunk_orders)
    idx_t, vals_t, floor_t = theirs.score_batch_topk(orders, orients, k=k,
                                                     chunk_orders=chunk_orders)
    assert int(np.argmax(full)) in set(idx.tolist())
    np.testing.assert_allclose(vals, full[idx], rtol=1e-9)
    np.testing.assert_array_equal(np.sort(idx), np.sort(np.asarray(idx_t)))
    assert floor == pytest.approx(floor_t, rel=1e-12)

    def rescore_many(idx):
        return ours.score_host_many(orders[idx // R], orients[idx % R])

    w_sparse, _ = cost.argmax_reference_ties_sparse(idx, rescore_many=rescore_many,
                                                    stats=ours.stats)
    w_dense, _ = cost.argmax_reference_ties(full, rescore_many=rescore_many, stats=ours.stats)
    w_jax, _ = jax_cost.argmax_reference_ties_sparse(
        np.asarray(idx_t), rescore=lambda i: theirs.score_host(orders[i // R], orients[i % R]))
    assert w_sparse == w_dense == w_jax


def test_topk_on_a_mesh_matches_jax():
    """test_topk.py:50 on a virtual (8, 1) mesh of CPU positions against the
    JAX package's 8 virtual CPU devices: the blocks' scores are gathered and
    grouped as in the JAX mesh path."""
    m, sizes = _problem(4, (5, 4, 3, 2))
    orders, orients = _batch(len(sizes))
    local = cost.BlockScorer(m, sizes, CPU, dtype=np.float64)
    ours, theirs = _scorers(m, sizes, mesh=pm.make_mesh((8, 1), [CPU] * 8),
                            jax_mesh=jax_pm.make_mesh((8, 1)))
    full = local.score_batch(orders, orients)
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=16)
    idx_t, vals_t, floor_t = theirs.score_batch_topk(orders, orients, k=16)
    assert int(np.argmax(full)) in set(idx.tolist())
    np.testing.assert_allclose(vals, full[idx], rtol=1e-12)
    np.testing.assert_array_equal(np.sort(idx), np.sort(np.asarray(idx_t)))
    np.testing.assert_allclose(ours.score_batch(orders, orients), full, rtol=1e-12, atol=0)


def test_sparse_floor_escalation_pulls_full_vector():
    """test_margins.py:118: the device top-k missed the true winner, and the
    floor forces the dense escalation, in both packages."""
    n = 1000
    exact_vals = np.linspace(0.0, 5.0, n)
    true_winner = 700
    exact_vals[true_winner] = 5.001
    fast = exact_vals.copy()
    cand = np.array([999, 500, 100])
    results = []
    for module, kwargs in ((cost, {"stats": cost.PrecisionStats(),
                                   "rescore_many": lambda idx: exact_vals[idx]}),
                           (jax_cost, {"rescore": lambda i: float(exact_vals[i])})):
        called = []
        results.append(module.argmax_reference_ties_sparse(
            cand, fast_vals=fast[cand],
            second_floor=float(fast[true_winner]),
            escalate=lambda: called.append(1) or fast, **kwargs))
        assert called == [1]
    assert results[0] == results[1] == (true_winner, 5.001)
    assert jax_cost.PRECISION.escalations >= 1


def test_sparse_prefiltered_candidate_readded_by_escalation():
    """test_margins.py:166: a candidate the f32 prefilter dropped comes back
    when the exact winner lands within the margin of its fast score."""
    import warnings

    exact_vals = {10: 7.0, 20: 6.99999, 30: 1.0}
    fast = np.array([7.0 - 6e-5 * 7, 6.99999 + 5e-5 * 7, 1.0])
    cand = np.array([10, 20, 30])
    stats = cost.PrecisionStats()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        ours = cost.argmax_reference_ties_sparse(
            cand, rescore_many=lambda idx: [exact_vals[i] for i in idx], fast_vals=fast,
            stats=stats)
        theirs = jax_cost.argmax_reference_ties_sparse(cand, rescore=lambda i: exact_vals[i],
                                                       fast_vals=fast)
    assert ours == theirs == (10, 7.0)
    assert stats.escalations == jax_cost.PRECISION.escalations > 0


def test_brute_force_over_eight_one_bin_scaffolds_escalates_alike():
    """Eight one-bin scaffolds: every orientation of an order ties, so the
    top-k floor reaches the best and both packages pull the dense scores of
    all 5,160,960 candidates (``score_batch``) and decide alike."""
    rng = np.random.default_rng(7)
    m = np.triu(rng.integers(1, 50, (8, 8)).astype(np.float64), 1)
    m = m + m.T
    names = [f"s{i}" for i in range(8)]
    calls = []
    dense = cost.SubsetScorer.score_batch

    def counting(self, orders, orients, *args, **kwargs):
        calls.append(orders.shape[0] * orients.shape[0])
        return dense(self, orders, orients, *args, **kwargs)

    cost.SubsetScorer.score_batch = counting
    try:
        scorer = cost.ChromosomeScorer(m, [1] * 8, CPU)
        ours = part2_order.brute_force_best(scorer, list(range(8)), names)
    finally:
        cost.SubsetScorer.score_batch = dense
    theirs = jax_part2.brute_force_best(jax_cost.ChromosomeScorer(m, [1] * 8), list(range(8)),
                                        names)
    assert calls == [5160960]
    assert scorer.stats.escalations > 0 and jax_cost.PRECISION.escalations > 0
    assert ours[0] == list(theirs[0]) and ours[1] == list(theirs[1])
    assert ours[2] == theirs[2]
