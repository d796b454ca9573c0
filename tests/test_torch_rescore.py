"""Part 2's exact float64 re-scoring in batches, on the CPU.

* A plain-Python model of ``csrc/f64_rescore.cu``'s walk over one diagonal
  (chunks of numpy's buffer, pairwise inside each: groups of 8 with eight
  accumulators, each leaf folded into a stack of pending right children)
  is bit-equal to ``np.trace`` at diagonal lengths across numpy's 8, 128
  and 8,192-element edges, and its ``cost_function`` to the oracle's.
* The batched decision functions give the winners, exact costs, precision
  statistics and escalations of one-at-a-time re-scoring, on seeded
  candidate sets with planted ties.
* The CLI's part-2 files on a genome whose part 1 lumps chromosomes into
  one group, so that the sliding window re-scores, are byte-equal to the
  JAX CLI's.
"""

import filecmp
import warnings

import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu_torch.ops import cost, oracle
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk
from hic_genome_assembler_tpu_torch.utils import profiling

jax_cost = pytest.importorskip("hic_genome_assembler_tpu.ops.cost")

LEAF = 128


def kernel_trace(d, chunk):
    """One lane of ``f64_rescore_kernel`` over the diagonal ``d``: groups of
    8 from the start, the chunk's pairwise tree walked leaf by leaf with a
    stack of pending right children, a leaf's eight accumulators, the last
    leaf's rest in sequence."""
    L = len(d)
    stack = []          # [right start, right length, left value or None]
    trace = 0.0
    state = {}

    def descend(s, n):
        while n > LEAF:
            n2 = (n >> 1) & ~7
            stack.append([s + n2, n - n2, None])
            n = n2
        state.update(start=s, end=s + n, main=s if n < 8 else s + n - (n & 7))

    def start_chunk(s):
        state["chunk_end"] = min(s + chunk, L)
        descend(s, state["chunk_end"] - s)

    def finish_leaf(x):
        nonlocal trace
        while stack:
            top = stack[-1]
            if top[2] is None:
                top[2] = x
                descend(top[0], top[1])
                return
            x = top[2] + x
            stack.pop()
        trace += x
        if state["chunk_end"] < L:
            start_chunk(state["chunk_end"])
        else:
            state["done"] = True

    start_chunk(0)
    r = [0.0] * 8
    res = 0.0
    for j in range(0, L, 8):
        if state.get("done"):
            break
        a = [float(d[j + k]) if j + k < L else 0.0 for k in range(8)]
        if j < state["main"]:
            r = a if j == state["start"] else [x + y for x, y in zip(r, a)]
            if j + 8 == state["main"]:
                res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
                if state["end"] == state["main"]:
                    finish_leaf(res)
        else:
            if state["main"] == state["start"]:
                res = 0.0
            for k in range(state["end"] - j):
                res += a[k]
            finish_leaf(res)
    return trace


def kernel_cost(m, bo, total, chunk):
    """The kernel's cost of bin order ``bo``: each diagonal's trace, then the
    cumulative sums, the divisions and the cost, in order."""
    K = len(bo)
    g = m[np.ix_(bo, bo)]
    cumulative, cost_value = 0.0, 0.0
    for i in range(1, K):
        cumulative += kernel_trace(np.diagonal(g, i), chunk)
        cost_value += cumulative / total / float(i)
    return cost_value


LENGTHS = list(range(1, 10)) + [127, 128, 129, 8191, 8192, 8193, 16384, 16385]


@pytest.mark.parametrize("L", LENGTHS)
def test_kernel_walk_is_np_trace(L):
    """The walk equals ``np.trace`` of a strided diagonal bit for bit, with
    values over nine orders of magnitude."""
    rng = np.random.default_rng(L)
    chunk = sk.trace_chunk()
    for _trial in range(3):
        # an L x (L + 1) matrix whose first superdiagonal is a strided view
        # of 3L values (every third), as a gathered matrix's diagonals are
        # strided views: np.trace takes its non-contiguous path
        buf = rng.random(3 * L + 3) * 10.0 ** rng.uniform(-3, 6, 3 * L + 3)
        m = np.lib.stride_tricks.as_strided(buf, shape=(L, L + 1), strides=(16, 8),
                                            writeable=False)
        diagonal = np.diagonal(m, 1)
        assert diagonal.strides == (24,) and len(diagonal) == L
        assert kernel_trace(diagonal, chunk) == float(np.trace(m, offset=1))


def test_kernel_cost_is_cost_function():
    rng = np.random.default_rng(3)
    K = 300
    m = rng.random((K + 5, K + 5)) ** 3 * 10.0 ** rng.uniform(-2, 3, (K + 5, K + 5))
    bo = rng.permutation(K + 5)[:K]
    total = float(m.sum())
    assert kernel_cost(m, bo, total, sk.trace_chunk()) == oracle.cost_function(
        m[np.ix_(bo, bo)], total)


# ---------------------------------------------------------------------------
# The batched decision functions against the JAX package's one-at-a-time ones
# ---------------------------------------------------------------------------

def _planted(seed, n=300, near=30):
    """Exact costs with planted exact ties at the top and ``near`` near-ties
    within the f32 margin of them, more than a top-k holds, and fast costs
    off by up to ``_F32_MARGIN / 2`` relatively (some observations past the
    violation budget, so that the decisions escalate)."""
    rng = np.random.default_rng(seed)
    exact = rng.uniform(50.0, 100.0, n)
    top = rng.choice(n, near, replace=False)
    exact[top[:3]] = 100.5                                          # exact ties
    exact[top[3:]] = 100.5 * (1.0 - rng.uniform(0, 3e-5, near - 3))  # near-ties
    fast = exact * (1.0 + rng.uniform(-5e-5, 5e-5, n))
    return exact, fast


def _stats(s):
    return (s.n, s.max_rel, s.escalations, s.violations)


def _ours_and_theirs(monkeypatch, call):
    """``call(module, rescore_kwargs, stats_kwargs)`` on the port with a
    batch re-scorer and on the JAX package with one candidate a call: the
    results, the statistics, the candidates each re-scored (in order) and
    the port's batches."""
    runs = []
    for module in (cost, jax_cost):
        fresh = jax_cost.PrecisionStats()
        monkeypatch.setattr(jax_cost, "PRECISION", fresh)
        stats = cost.PrecisionStats() if module is cost else fresh
        seen, batches = [], []
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            result = call(module, seen, batches, stats)
        runs.append((result, _stats(stats), seen, batches))
    return runs


@pytest.mark.parametrize("seed", range(6))
def test_dense_decision_batches_alike(monkeypatch, seed):
    exact, fast = _planted(seed)

    def call(module, seen, batches, stats):
        if module is cost:
            def rescore_many(idx):
                batches.append(len(idx))
                seen.extend(int(i) for i in idx)
                return exact[idx]
            return cost.argmax_reference_ties(fast, rescore_many=rescore_many, k=8,
                                              stats=stats)

        def rescore(i):
            seen.append(int(i))
            return float(exact[i])
        return jax_cost.argmax_reference_ties(fast, rescore=rescore, k=8)

    (ours, s_ours, seen_ours, batches), (theirs, s_theirs, seen_theirs, _) = \
        _ours_and_theirs(monkeypatch, call)
    assert ours == theirs and s_ours == s_theirs
    assert seen_ours == seen_theirs
    # one batch for the prefiltered top-k and one an escalation
    assert s_ours[2] > 0
    assert len(batches) == 1 + s_ours[2] and sum(batches) == len(seen_ours)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("floor", ["none", "far", "near"])
def test_sparse_decision_batches_alike(monkeypatch, seed, floor):
    """The device top-k form: a candidate subset with fast values, a floor
    far below the winner, or within its margin (the dense escalation)."""
    exact, fast = _planted(seed + 10)
    order = np.argsort(-fast, kind="stable")
    cand = order[:24]
    second = {"none": None, "far": float(fast[order[24]]) - 10.0,
              "near": float(fast[order[24]])}[floor]

    def call(module, seen, batches, stats):
        kwargs = dict(fast_vals=fast[cand], second_floor=second, escalate=lambda: fast)
        if module is cost:
            def rescore_many(idx):
                batches.append(len(idx))
                seen.extend(int(i) for i in idx)
                return exact[idx]
            return cost.argmax_reference_ties_sparse(cand, rescore_many=rescore_many,
                                                     stats=stats, **kwargs)

        def rescore(i):
            seen.append(int(i))
            return float(exact[i])
        return jax_cost.argmax_reference_ties_sparse(cand, rescore=rescore, **kwargs)

    (ours, s_ours, seen_ours, batches), (theirs, s_theirs, seen_theirs, _) = \
        _ours_and_theirs(monkeypatch, call)
    assert ours == theirs and s_ours == s_theirs and seen_ours == seen_theirs
    assert len(batches) <= 1 + s_ours[2] and sum(batches) == len(seen_ours)
    if floor == "near":  # the floor within the margin: the dense decision ran
        assert len(set(seen_ours) - set(cand.tolist())) > 0


def test_score_host_many_memoizes_and_batches():
    """Candidates sharing a bin order (a one-bin scaffold's two
    orientations) are re-scored once, in one batch, and each cost equals
    ``score_host``'s and the oracle's."""
    rng = np.random.default_rng(4)
    sizes = [5, 4, 3, 1]
    C = sum(sizes)
    m = rng.random((C, C))
    m = m + m.T
    scorer = cost.ChromosomeScorer(m, sizes, torch.device("cpu")).full()
    orders = np.array([[0, 1, 2, 3]] * 2 + [[3, 2, 1, 0]], dtype=np.int32)
    orients = np.array([[0, 1, 0, 0], [0, 1, 0, 1], [1, 1, 1, 1]], dtype=np.int32)
    profiling.reset()
    got = scorer.score_host_many(orders, orients)
    assert profiling.counters()["part2/f64_rescore_candidates"] == 2
    assert profiling.summary()["part2/f64_rescore"]["calls"] == 1
    assert got[0] == got[1]
    for o, r, value in zip(orders, orients, got):
        bo = cost.bin_order_of_block(o, r, sizes)
        assert value == scorer.score_host(o, r) == oracle.cost_function(
            m[np.ix_(bo, bo)], scorer.total)
    assert profiling.counters()["part2/f64_rescore_candidates"] == 2  # all memo hits
    profiling.reset()


# ---------------------------------------------------------------------------
# A call's bin orders, built for all its rows at once
# ---------------------------------------------------------------------------

def _sizes(rng, S, largest):
    """``S`` scaffold sizes from 1 to ``largest``, a third of them one bin,
    size-descending as the canonical layout has them."""
    sizes = rng.integers(1, largest + 1, S)
    sizes[rng.random(S) < 1 / 3] = 1
    return np.sort(sizes)[::-1].astype(np.int64)


def _rows(rng, S, B, W, counts):
    """``B`` rows of width ``W``: row b holds ``counts[b]`` distinct real
    ids in random orientations, then pad ids (``S`` and above) in every
    place after them."""
    orders = rng.integers(S, S + 4, (B, W))
    orients = rng.integers(0, 2, (B, W))
    for b, n in enumerate(counts):
        orders[b, :n] = rng.permutation(S)[:n]
    return orders.astype(np.int32), orients.astype(np.int32)


def _split(bins, ks):
    ends = np.cumsum(ks)
    return [bins[e - k : e] for e, k in zip(ends, ks)]


@pytest.mark.parametrize("S, largest", [(1, 2), (2, 1), (6, 5), (40, 30), (150, 40), (260, 40)])
def test_bin_orders_of_rows_is_bin_order_of_block(S, largest):
    """Row for row equal to ``bin_order_of_block`` of the row's real ids:
    groups from 2 to a few thousand bins, real counts that differ within a
    call (pads in every place after them), one-bin scaffolds both ways."""
    rng = np.random.default_rng(S * 1000 + largest)
    sizes = _sizes(rng, S, largest)
    if S == 1:
        sizes[0] = 2
    offsets = np.cumsum(sizes) - sizes
    W = -(-S // 8) * 8
    counts = [S, 1] + rng.integers(1, S + 1, 14).tolist()
    orders, orients = _rows(rng, S, len(counts), W, counts)
    ones = np.nonzero(sizes == 1)[0]
    if len(ones):  # a one-bin scaffold alone, in each orientation
        orders[:2, 0], orients[:2, 0] = ones[0], [0, 1]
        orders[1, 1:] = S
    bins, ks = cost.bin_orders_of_rows(orders, orients, sizes, offsets)
    assert bins.dtype == np.int32 and len(ks) == len(orders)
    for b, got in enumerate(_split(bins, ks)):
        real = orders[b] < S
        want = cost.bin_order_of_block(orders[b][real], orients[b][real], sizes)
        assert got.dtype == want.dtype and np.array_equal(got, want), b
    if len(ones):
        assert np.array_equal(_split(bins, ks)[1], [offsets[ones[0]]])


def _parent_batches(scorer, orders, orients):
    """The misses a call's rows give, as each row's ``bin_order_of_block``
    keys them: one batch of the distinct bin orders in first-seen order."""
    seen = {}
    for o, r in zip(orders, orients):
        real = o < scorer.S
        bo = cost.bin_order_of_block(o[real], r[real], scorer.sizes)
        seen.setdefault(bo.tobytes(), bo)
    return list(seen.values())


@pytest.mark.parametrize("seed", range(4))
def test_score_host_many_builds_a_call_at_once(seed, monkeypatch):
    """On rows with pads, real counts that differ and one-bin scaffolds both
    ways: each cost is the oracle's of the row's bin order, the batch sent
    to ``exact_costs`` is the one the rows' own bin orders give, re-scored in
    one ``part2/f64_rescore`` call, and ``part2/f64_bin_order_rows`` counts
    the rows.  A second call of the same rows is all memo hits."""
    rng = np.random.default_rng(100 + seed)
    S = 24
    sizes = _sizes(rng, S, 9)
    sizes[-5:] = [2, 1, 1, 1, 1]
    C = int(sizes.sum())
    m = rng.random((C, C)) ** 2
    m = m + m.T
    scorer = cost.ChromosomeScorer(m, sizes, torch.device("cpu")).full()
    batches = []
    original = cost.ChromosomeScorer.exact_costs

    def recording(self, bin_orders, total):
        batches.append(bin_orders.copy())
        return original(self, bin_orders, total)

    monkeypatch.setattr(cost.ChromosomeScorer, "exact_costs", recording)

    def check(orders, orients):
        """One call of ``score_host_many`` against the parent's keys and
        batch, and the oracle's costs."""
        want = _parent_batches(scorer, orders, orients)
        calls = profiling.summary().get("part2/f64_rescore", {"calls": 0})["calls"]
        rows = profiling.counters().get("part2/f64_bin_order_rows", 0)
        got = scorer.score_host_many(orders, orients)
        assert np.array_equal(batches[-1], np.stack(want))
        assert profiling.summary()["part2/f64_rescore"]["calls"] == calls + 1
        assert profiling.counters()["part2/f64_bin_order_rows"] == rows + len(orders)
        for o, r, value in zip(orders, orients, got):
            bo = cost.bin_order_of_block(o[o < S], r[o < S], sizes)
            assert value == oracle.cost_function(m[np.ix_(bo, bo)], scorer.total)
        return got, len(want)

    profiling.reset()
    # every scaffold; rows 0-2 one bin order, a one-bin scaffold turned in 2
    orders, orients = _rows(rng, S, 6, 32, [S] * 6)
    orders[1:3], orients[1:3] = orders[0], orients[0]
    one = np.nonzero(orders[2] == S - 1)[0][0]
    orients[2, one] = 1 - orients[0, one]
    got, n = check(orders, orients)
    assert got[0] == got[1] == got[2] and n == 4
    assert profiling.counters()["part2/f64_rescore_candidates"] == 4
    assert np.array_equal(scorer.score_host_many(orders, orients), got)
    assert len(batches) == 1 and profiling.counters()["part2/f64_bin_order_rows"] == 12
    # C - 2 bins from S - 2 real ids (two one-bin scaffolds left out) and
    # from S - 1 (the two-bin one left out): one batch
    orders, orients = _rows(rng, S, 6, 32, [S - 2] * 3 + [S - 1] * 3)
    for b, drop in enumerate([(S - 1, S - 2)] * 3 + [(S - 5,)] * 3):
        keep = [i for i in rng.permutation(S) if i not in drop]
        orders[b, : len(keep)] = keep
    assert len({int(sizes[o[o < S]].sum()) for o in orders}) == 1
    assert check(orders, orients)[1] == 6 and len(batches) == 2
    profiling.reset()


# ---------------------------------------------------------------------------
# The CLI on a genome whose part 1 lumps chromosomes
# ---------------------------------------------------------------------------

FILES = ("dendrogramOrder.txt", "binGroupings.txt", "clusterAssessment.txt",
         "chromosomeGroupings.txt", "chromosomeOrdering.txt", "plotOrder.txt")


def test_cli_part2_on_a_lumped_group_byte_equal_to_jax(tmp_path, monkeypatch):
    """Three chromosomes with many contacts across them: part 1 puts all
    three into one group, part 2's window re-scores on it (misses counted),
    and the part-1 and part-2 files equal the JAX CLI's."""
    jax_cli = pytest.importorskip("hic_genome_assembler_tpu.cli")
    from hic_genome_assembler_tpu.viz import plot as plot_mod
    from hic_genome_assembler_tpu_torch import cli
    from hic_genome_assembler_tpu_torch.utils import e2e, fixtures
    from hic_genome_assembler_tpu_torch.viz import plot as torch_plot_mod

    monkeypatch.setattr(plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setattr(torch_plot_mod, "plot_contact_map", lambda *a, **k: None)
    monkeypatch.setenv("HIC_JAX_CACHE", "off")
    genome = fixtures.make_genome(
        chrom_scaffold_bins=((9, 7, 6, 5, 4, 3), (8, 7, 5, 4, 3), (8, 6, 5, 4, 3, 2)),
        seed=2, noise=0.005, cross_noise_frac=1.0)
    paths = fixtures.write_hicpro_files(genome, str(tmp_path / "hicpro"))
    settings = {"minSize": "5", "louvainRounds": "5", "nScaffolds": "4", "scanScaffolds": "3"}
    cfgs = {side: e2e.write_config(str(tmp_path / f"{side}.cfg"), str(tmp_path / side), paths,
                                   genome.resolution, settings) for side in ("torch", "jax")}
    cli.main(["-part1", "-config", cfgs["torch"], "-device", "cpu"])
    cli.main(["-part2", "-config", cfgs["torch"], "-device", "cpu"])
    counters = profiling.counters()
    jax_cli.main(["-part1", "-part2", "-config", cfgs["jax"], "-mesh", "off"])
    groups = (tmp_path / "torch" / "files" / "chromosomeGroupings.txt").read_text()
    chroms = [{line.split()[1].split("k")[0] for line in block.strip().splitlines()[1:]}
              for block in groups.split("### Chromosome group")[1:]]
    assert max(len(c) for c in chroms) == 3
    assert counters["part2/f64_rescore_miss"] > 0
    assert counters["part2/f64_rescore_candidates"] > 0
    for name in FILES:
        assert filecmp.cmp(tmp_path / "torch" / "files" / name,
                           tmp_path / "jax" / "files" / name, shallow=False), name
    profiling.reset()
