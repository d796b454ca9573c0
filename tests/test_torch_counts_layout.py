"""The int16 layout of the rank matrix, and the counts kernel's nested rule.

An int16-stored matrix counts as the JAX package does (its Pallas kernel in
interpret mode and its XLA formulation), exactly as the int32 one does.
The CUDA kernel's per-element rule (a binary search in the scans of the
element's start group, one bin, then a prefix or suffix sum over each
group's bins) is written once here in numpy, over the plan that the
wrapper's host code (``count_kernels.plan_batch``) builds, and held exactly
to the plain version on drawn batches: the kernel itself only runs on a
card (tests/test_torch_gpu.py).
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

jnp = pytest.importorskip("jax.numpy")

from hic_genome_assembler_tpu.ops import matrix as jax_dev  # noqa: E402
from hic_genome_assembler_tpu.ops import pallas_kernels as pk  # noqa: E402
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import count_kernels as ck  # noqa: E402
from hic_genome_assembler_tpu_torch.parallel import mesh as pm  # noqa: E402

CPU = torch.device("cpu")


def _rank(n, seed):
    return np.argsort(-np.random.default_rng(seed).random((n, n)), axis=1).astype(np.int32)


_BATCHES = {
    "growing": [[s, 0, 1] for s in (0, 1, 7, 300, 601)],
    "fixed": [[0, 5, 0], [3, 77, 0], [100, 400, 0], [0, 602, 0], [400, 100, 0], [3, 90, 0]],
    "mixed": [[0, 0, 1], [7, 0, 1], [3, 77, 0], [100, 400, 0], [601, 0, 1], [400, 100, 0],
              [0, 602, 0], [0, 602, 0]],
}


@pytest.mark.parametrize("batch", sorted(_BATCHES))
def test_int16_matrix_counts_equal_jax(batch):
    """The padded matrix is int16 at this size; it and its int32 copy give
    the batched Pallas call's and the XLA counts row for row."""
    rank = _rank(603, 0)
    n = rank.shape[0]
    params = np.array(_BATCHES[batch], dtype=np.int32)
    want = np.asarray(pk._counts_call_many(pk.pad_rank(jnp.asarray(rank)), jnp.asarray(params),
                                           interpret=True))[:, :n]
    xla = np.asarray(jax_dev.counts_many(jnp.asarray(rank), jnp.asarray(params)))
    padded = ck.pad_rank(torch.from_numpy(rank))
    assert padded.dtype == torch.int16
    np.testing.assert_array_equal(want, xla)
    for mat in (padded, padded.to(torch.int32)):
        np.testing.assert_array_equal(ck.counts_many(mat, params)[:, :n].numpy(), want)


def test_int16_column_view_and_block_offsets_equal_jax():
    """Fixed windows on a 2048-column int16 view, and int16 blocks of a
    (2, 2) layout counted with their offsets, equal the Pallas kernel."""
    n = 3000
    rank = _rank(n, 5)
    padded_j = pk.pad_rank(jnp.asarray(rank))
    view = ck.pad_rank(torch.from_numpy(rank))[:, :2048]
    assert view.dtype == torch.int16 and not view.is_contiguous()
    params = np.array([[0, 5, 0], [3, 77, 0], [100, 640, 0], [900, 2500, 0], [2940, 2999, 0]],
                      dtype=np.int32)
    for row in params:
        want = np.asarray(pk._counts_call(padded_j[:, :2048], jnp.asarray(row),
                                          interpret=True))[:n]
        np.testing.assert_array_equal(ck.counts_many(view, row[None])[0, :n].numpy(), want)
    mixed = np.concatenate([params, [[0, 0, 1], [7, 0, 1], [2990, 0, 1]]]).astype(np.int32)
    mesh = pm.make_mesh((2, 2), [CPU] * 4)
    t = pm.pad_to_multiple(n, 64)
    blocks = pm.place_blocks(mesh, [torch.from_numpy(rank)], t, t, fill=-1,
                             dtype=ck.rank_dtype(t))
    assert blocks[1][1].dtype == torch.int16
    want = np.asarray(pk._counts_call_many(padded_j, jnp.asarray(mixed), interpret=True))[:, :n]
    got = ck.counts_many_blocks(blocks, mixed, CPU)[:, :n].numpy()
    np.testing.assert_array_equal(got, want)


def test_rank_dtype_by_padded_size(monkeypatch):
    """int16 below INT16_LIMIT, int32 from it: in pad_rank, and in
    RankCounts on one device, on a mesh and from device-mode row pieces,
    with equal counts either way (shown at a small n under a lowered
    limit)."""
    monkeypatch.setattr(bp, "_HOST_N", 0)
    n = 100
    rank = _rank(n, 3)
    pieces = [torch.from_numpy(rank[:40]), torch.from_numpy(rank[40:])]
    mesh = pm.make_mesh((2, 2), [CPU] * 4)
    assert ck.rank_dtype(32766) == torch.int16 and ck.rank_dtype(32767) == torch.int32
    built = {}
    for limit, dtype in ((ck.INT16_LIMIT, torch.int16), (64, torch.int32)):
        monkeypatch.setattr(ck, "INT16_LIMIT", limit)
        assert ck.pad_rank(torch.from_numpy(rank)).dtype == dtype
        built[dtype] = [bp.RankCounts(rank, CPU), bp.RankCounts(rank, CPU, mesh=mesh),
                        bp.RankCounts(pieces, CPU)]
        for counts in built[dtype]:
            assert {blk.dtype for row in counts._blocks for blk in row} == {dtype}
    for a, b in zip(built[torch.int16], built[torch.int32]):
        for s in (0, 7, 60):
            np.testing.assert_array_equal(a.growing(s), b.growing(s))
        for s, c in ((0, 10), (5, 80), (60, 99)):
            np.testing.assert_array_equal(a.fixed(s, c), b.fixed(s, c))


# ---------------------------------------------------------------------------
# the nested rule, in numpy, on the wrapper's plan
# ---------------------------------------------------------------------------


def _plan_chunks(params):
    """The chunks of ``plan_batch``'s plan as (keys, groups, out map)."""
    plan, n_chunks, max_bins, max_groups = ck.plan_batch(params)
    chunks = []
    for c in range(n_chunks):
        n_bins, n_groups, has_growing, keys_off, groups_off, out_off, n_out, _ = \
            plan[1 + 8 * c: 9 + 8 * c]
        keys = plan[keys_off: keys_off + n_bins].astype(np.int64)
        groups = plan[groups_off: groups_off + 4 * n_groups].reshape(-1, 4).astype(np.int64)
        out = plan[out_off: out_off + 2 * n_out].reshape(-1, 2)
        assert n_bins <= max_bins <= ck.CHUNK_SCANS and n_groups <= max_groups
        chunks.append((keys, groups, bool(has_growing), out))
    return chunks


def kernel_rule(rank, params, row0=0, col0=0):
    """The counts as the kernel forms them: per element and group, the
    first scan that counts it (a search in the group's sorted keys) gets
    one in its bin; a suffix sum (growing: starts ascending) or prefix sum
    (fixed: cuts ascending) over the group's bins gives each scan's count;
    each caller's row k reads its scan's bin.  A row's columns stop at its
    union prefix, and a column at the first fixed group it has passed."""
    R = np.asarray(rank, dtype=np.int64)
    n_r, n_c = R.shape
    out = np.full((len(params), n_r), -1, dtype=np.int64)
    gi = row0 + np.arange(n_r)[:, None]
    j = col0 + np.arange(n_c)[None, :]
    rows = np.broadcast_to(np.arange(n_r)[:, None], R.shape)
    for keys, groups, has_growing, out_map in _plan_chunks(params):
        fixed = groups[1:] if has_growing else groups
        assert (np.diff(fixed[:, 1]) <= 0).all(), "fixed groups must be sorted by end"
        end = np.zeros((n_r, 1), dtype=np.int64)
        if has_growing:
            end = gi - keys[groups[0, 2]]
        if len(fixed):
            end = np.maximum(end, fixed[0, 1])
        inside = j - col0 < np.clip(end - col0, 0, n_c)     # the row's union prefix
        hist = np.zeros((n_r, len(keys)), dtype=np.int64)
        for g, (start, g_end, bin0, n) in enumerate(groups):
            gk = keys[bin0: bin0 + n]
            if has_growing and g == 0:
                q = np.searchsorted(gk, np.minimum(R, gi - j - 1), side="right")
                hit = inside & (R <= gi) & (q > 0)
                np.add.at(hist, (rows[hit], bin0 + q[hit] - 1), 1)
            else:
                q = np.searchsorted(gk, np.maximum(j + start + 1, R), side="left")
                hit = inside & (j < g_end) & (R >= start) & (q < n)
                np.add.at(hist, (rows[hit], bin0 + q[hit]), 1)
        for g, (_start, _end, bin0, n) in enumerate(groups):
            seg = hist[:, bin0: bin0 + n]
            hist[:, bin0: bin0 + n] = (seg[:, ::-1].cumsum(1)[:, ::-1] if has_growing and g == 0
                                       else seg.cumsum(1))
        out[out_map[:, 0]] = hist[:, out_map[:, 1]].T
    assert (out >= 0).all(), "a caller's row was not written"
    return out


def register_rule(rank, params, row0=0, col0=0):
    """The counts as the kernel forms them for a chunk of one group of at
    most 16 scans: per element one threshold (growing: min(v, i - j - 1)
    where v <= i; fixed: max(j + s + 1, v) where j < the group's end and
    v >= s), and per scan one compare of it against the scan's key, over the
    row's union prefix."""
    [(keys, groups, has_growing, out_map)] = _plan_chunks(params)
    assert len(groups) == 1 and len(keys) <= 16
    start, end, _bin0, n = groups[0]
    R = np.asarray(rank, dtype=np.int64)
    n_r, n_c = R.shape
    gi = row0 + np.arange(n_r)[:, None]
    j = col0 + np.arange(n_c)[None, :]
    union_end = gi - keys[0] if has_growing else np.full((n_r, 1), end)
    inside = j - col0 < np.clip(union_end - col0, 0, n_c)
    if has_growing:
        ok, x = inside & (R <= gi), np.minimum(R, gi - j - 1)
        counts = [(ok & (x >= key)).sum(1) for key in keys]
    else:
        ok, x = inside & (j < end) & (R >= start), np.maximum(j + start + 1, R)
        counts = [(ok & (x <= key)).sum(1) for key in keys]
    out = np.zeros((len(params), n_r), dtype=np.int64)
    out[out_map[:, 0]] = np.array(counts)[out_map[:, 1]]
    return out


@st.composite
def _batches(draw):
    """A rank-like block (values in [-1, n + 2), -1 the pad) with offsets,
    and a batch of scans: growing and fixed, several starts, repeated rows
    of the pow2 padding, starts past the rows, cut < start, empty prefixes;
    half of them one group (all growing, or all fixed of one start)."""
    n_r = draw(st.integers(1, 24))
    n_c = draw(st.integers(1, 24))
    row0 = draw(st.integers(0, 30))
    col0 = draw(st.integers(0, 30))
    top = n_r + row0 + n_c + col0
    seed = draw(st.integers(0, 2**31))
    rank = np.random.default_rng(seed).integers(-1, top + 2, (n_r, n_c)).astype(np.int32)
    start = st.integers(-2, top + 3)
    scan = st.tuples(start, start, st.sampled_from([0, 1]))
    rows = draw(st.lists(scan, min_size=1, max_size=14))
    if draw(st.booleans()):  # one group: all growing, or all fixed of one start
        s0 = draw(start)
        grow = draw(st.booleans())
        rows = [(r[0], 0, 1) if grow else (s0, r[1], 0) for r in rows]
        return rank, bp._pow2_params(rows), row0, col0, draw(st.sampled_from([0, 1, 3]))
    few = draw(st.lists(start, min_size=1, max_size=3))
    shared = st.tuples(st.sampled_from(few), start)
    rows += [(s, c, 0) for s, c in draw(st.lists(shared, max_size=10))]
    params = bp._pow2_params(rows)
    return rank, params, row0, col0, draw(st.sampled_from([0, 1, 3]))


@settings(max_examples=300, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_batches())
def test_nested_rule_on_the_plan_equals_plain(case):
    """Exact equality with counts_many_plain on int16 and int32 blocks and
    on a column view, with chunks of CHUNK_SCANS and of 3 scans (a batch
    split over several chunks)."""
    rank, params, row0, col0, extra = case
    wide = np.full((rank.shape[0], rank.shape[1] + extra), -1, dtype=np.int32)
    wide[:, : rank.shape[1]] = rank
    view = torch.from_numpy(wide)[:, : rank.shape[1]]
    want = ck.counts_many_plain(view, params, row0, col0).numpy()
    np.testing.assert_array_equal(
        ck.counts_many_plain(view.to(torch.int16), params, row0, col0).numpy(), want)
    np.testing.assert_array_equal(kernel_rule(rank, params, row0, col0), want)
    _plan, n_chunks, max_bins, max_groups = ck.plan_batch(params)
    if max_groups == 1 and max_bins <= 16:
        np.testing.assert_array_equal(register_rule(rank, params, row0, col0), want)
    chunk = ck.CHUNK_SCANS
    try:
        ck.CHUNK_SCANS = 3
        np.testing.assert_array_equal(kernel_rule(rank, params, row0, col0), want)
    finally:
        ck.CHUNK_SCANS = chunk


def test_plan_groups_sorts_and_maps_back():
    """De-duplication (the pow2 padding's repeats, a growing scan's ignored
    cut), the growing group first by start, fixed groups by start sorted by
    cut and ordered by prefix end, and every caller's row mapped to its
    scan's bin."""
    params = np.array([[9, 40, 0], [5, 9, 0], [2, 7, 1], [0, 0, 1], [5, 30, 0], [9, 12, 0],
                       [2, 0, 1], [9, 12, 0]], dtype=np.int32)
    [(keys, groups, has_growing, out_map)] = _plan_chunks(params)
    assert has_growing
    np.testing.assert_array_equal(keys, [0, 2, 9, 30, 12, 40])
    np.testing.assert_array_equal(groups, [[0, 0, 0, 2], [9, 31, 4, 2], [5, 25, 2, 2]])
    bins = dict(map(tuple, out_map))
    assert [bins[k] for k in range(len(params))] == [5, 2, 1, 0, 3, 4, 1, 4]
    assert ck.plan_batch(params)[1:] == (1, 6, 3)


@settings(max_examples=200, deadline=None, database=None)
@given(_batches())
def test_batch_prefix_elements_equal_a_brute_count(case):
    rank, params, row0, col0, _extra = case
    n_r, n_c = rank.shape
    widths = []
    for start, cut, flag in params.astype(np.int64):
        hi = row0 + np.arange(n_r) if flag == 1 else np.full(n_r, cut)
        widths.append(np.clip(hi - start - col0, 0, n_c))
    widths = np.array(widths)
    assert ck.batch_prefix_elements(params, n_r, n_c, row0, col0) == (
        int(widths.sum()), int(widths.max(axis=0).sum()))


# ---------------------------------------------------------------------------
# pair_score's folded walk, in numpy
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", list(range(0, 26)) + [30, 31, 55, 56])
@pytest.mark.parametrize("team", [32])  # the warp that walks a candidate
def test_pair_walk_visits_each_pair_once(n, team):
    """The pair kernel's folded walk (``pair_walk`` in csrc/score_kernels.cu):
    item u is step u // n, position u % n; row t folded with row n - 2 - t;
    each lane's items a warp apart, advanced by a constant.  Over every
    lane it visits each pair i < j of n slots exactly once, from n = 0 to
    past the warp's width."""
    seen = []
    steps = n // 2
    items = steps * n
    for rank in range(team):
        step, pos = divmod(rank, n) if n else (0, 0)
        u = rank
        while u < items:
            first = n - 1 - step
            if pos < first:
                seen.append((step, step + 1 + pos))
            elif step != n - 2 - step:
                i = n - 2 - step
                seen.append((i, i + 1 + pos - first))
            pos += team % n
            step += team // n
            if pos >= n:
                pos -= n
                step += 1
            u += team
    want = [(i, j) for i in range(n) for j in range(i + 1, n)]
    assert sorted(seen) == want
