"""The mesh paths' group top-k: partial triples a data-axis block, one fold.

A batch of ``n_glob`` candidates in k groups of G = ceil(n_glob / k) is
split over D mesh blocks; each block's launch of ``combo_score_topk`` or
``block_score`` clips its tiles to the block's span and writes every
group's partial (max, argmax, second) triple, and ``topk_fold`` merges the
D blocks' triples.  The CUDA kernels run only on a card
(tests/test_torch_gpu.py); here their rule of which tile holds which
candidates is written once in numpy and held to the plain versions, and the
plain partials and fold are held to the JAX package's ``_group_argmax`` of
the gathered scores.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from hic_genome_assembler_tpu.ops import cost as jax_cost
from hic_genome_assembler_tpu_torch.ops import cost, perms
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk
from hic_genome_assembler_tpu_torch.parallel import mesh as pm

CPU = torch.device("cpu")
NEG = -np.inf
INT32_MAX, INT64_MAX = 2**31 - 1, 2**63 - 1


# ---------------------------------------------------------------------------
# the kernels' ranges, in numpy
# ---------------------------------------------------------------------------


def span_hi(n0, n, n_glob, k, G):
    """topk_span_hi: a block's span ends at its last candidate + 1, or, for
    the block that ends the batch, at the end of the last group's padding."""
    return n0 + n if n0 + n < n_glob else k * G


def tile_ranges(n0, n, n_glob, k, tile):
    """{(g, t): (lo, hi)} of every thread block of one mesh block's launch,
    as score_grid and block_range compute them: the groups [g0, g0 + ng)
    that the span touches, ``tiles`` a group (global candidates; lo >= hi is
    a tile past the group's part in the span).  Returns (ranges, G, tiles,
    g0, ng)."""
    G = -(-n_glob // k)
    end = span_hi(n0, n, n_glob, k, G)
    tiles = -(-min(G, end - n0) // tile)
    g0 = n0 // G
    ng = (end - 1) // G + 1 - g0
    out = {}
    for g in range(g0, g0 + ng):
        for t in range(tiles):
            lo = max(g * G, n0) + t * tile
            out[g, t] = (lo, min(lo + tile, (g + 1) * G, end))
    return out, G, tiles, g0, ng


@st.composite
def _mesh_batches(draw):
    D = draw(st.integers(1, 6))
    rows = draw(st.integers(1, 24))
    R = draw(st.sampled_from([1, 2, 3, 16, 64]))
    n_glob = D * rows * R
    k = draw(st.integers(1, min(n_glob + 3, 300)))
    tile = draw(st.sampled_from([1, 3, 7, 64, 100, sk.TOPK_TILE]))
    return D, rows * R, n_glob, k, tile


@settings(max_examples=150, deadline=None, database=None)
@given(_mesh_batches())
def test_tile_ranges_cover_each_block_and_group_once(case):
    """Each block's launch covers the groups its span touches, each with a
    non-empty first tile; its non-empty ranges lie inside one group and
    inside its span, hold at most ``tile`` candidates (int32 offsets), and
    cover the span once; the D spans cover [0, k * G) once, padding
    included; the wrappers allocate the tile scratch the kernels index."""
    D, n, n_glob, k, tile = case
    covered = np.zeros(k * -(-n_glob // k), dtype=np.int64)
    for i in range(D):
        n0 = i * n
        ranges, G, tiles, g0, ng = tile_ranges(n0, n, n_glob, k, tile)
        end = span_hi(n0, n, n_glob, k, G)
        assert 0 <= g0 and g0 + ng <= k
        assert all(ranges[g, 0][0] < ranges[g, 0][1] for g in range(g0, g0 + ng))
        mine = np.zeros_like(covered)
        for (g, _t), (lo, hi) in ranges.items():
            if lo >= hi:
                continue
            assert g * G <= lo < hi <= (g + 1) * G and n0 <= lo and hi <= end
            assert hi - lo <= tile <= INT32_MAX
            mine[lo:hi] += 1
        assert (mine[n0:end] == 1).all() and mine.sum() == end - n0
        covered += mine
        assert sk._partial_span(n, k, n0, n_glob) == (G, end - n0)
        default, sk.TOPK_TILE = sk.TOPK_TILE, tile
        try:
            parts = sk._topk_outputs(k, G, CPU, end - n0)[3]
        finally:
            sk.TOPK_TILE = default
        assert parts.shape[0] == (k * tiles if tiles > 1 else 1)
    assert (covered == 1).all()


def _merge(a, b):
    """csrc merge(): the better max (the lower index on a tie) wins; the
    union's second is the larger of the winner's second and the loser's max."""
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[2] < b[2])
    w, lose = (a, b) if a_wins else (b, a)
    return (w[0], max(w[1], lose[0]), w[2])


def _warp_fold(triples):
    """fold_group: lane l merges triples l, l + 32, ..., then the butterfly."""
    lanes = [(NEG, NEG, INT64_MAX)] * 32
    for t, x in enumerate(triples):
        lanes[t % 32] = _merge(lanes[t % 32], x)
    for o in (16, 8, 4, 2, 1):
        lanes = [_merge(lanes[j], lanes[j ^ o]) for j in range(32)]
    return lanes[0]


def block_triples_model(scores, n0, n_glob, k, tile):
    """One mesh block's triples [k] as its launch writes them: each range's
    candidates merged (the padding past n_glob as its first index alone),
    the empty triple for a range of none, a group's tiles by topk_merge,
    and the empty triple of each group the span does not touch."""
    n = len(scores)
    ranges, G, tiles, g0, ng = tile_ranges(n0, n, n_glob, k, tile)
    out = []
    for g in range(k):
        if not g0 <= g < g0 + ng:
            out.append((NEG, NEG, INT64_MAX))
            continue
        parts = []
        for t in range(tiles):
            lo, hi = ranges[g, t]
            x = (NEG, NEG, INT32_MAX)  # the lane's int32 offset from lo
            for c in range(lo, min(hi, n0 + n)):
                x = _merge(x, (float(scores[c - n0]), NEG, c - lo))
            if lo < hi and min(hi, n0 + n) < hi:
                x = _merge(x, (NEG, NEG, max(lo, n0 + n) - lo))
            parts.append((NEG, NEG, INT64_MAX) if x[2] == INT32_MAX else (x[0], x[1], lo + x[2]))
        out.append(parts[0] if tiles == 1 else _warp_fold(parts))
    return out


def _stack(blocks):
    """D blocks' [k] triples (lists of (v1, v2, i1)) as the [D, k] arrays."""
    vals = torch.tensor([[x[0] for x in b] for b in blocks], dtype=torch.float32)
    idx = torch.tensor([[x[2] for x in b] for b in blocks], dtype=torch.int64)
    second = torch.tensor([[x[1] for x in b] for b in blocks], dtype=torch.float32)
    return vals, idx, second


@settings(max_examples=120, deadline=None, database=None)
@given(_mesh_batches(), st.integers(0, 2**16), st.sampled_from([2, 5, 2**20]))
def test_block_triples_model_equals_plain_partials_and_fold(case, seed, top):
    """Integer scores (ties within and across blocks): the modelled launch's
    triples equal ``_group_partials``' bit for bit, and the modelled fold of
    the D blocks equals ``_group_argmax`` of the gathered scores."""
    D, n, n_glob, k, tile = case
    scores = np.random.default_rng(seed).integers(0, top, n_glob).astype(np.float32)
    blocks = []
    for i in range(D):
        part = scores[i * n:(i + 1) * n]
        got = block_triples_model(part, i * n, n_glob, k, tile)
        want = sk._group_partials(torch.from_numpy(part), k, i * n, n_glob)
        for a, b in zip(_stack([got]), want):
            assert torch.equal(a[0], b)
        blocks.append(got)
    folded = [_warp_fold([b[g] for b in blocks]) for g in range(k)]
    for a, b in zip(_stack([folded]), sk._group_argmax(torch.from_numpy(scores), k)):
        assert torch.equal(a[0], b)


# ---------------------------------------------------------------------------
# the plain partials and fold against the JAX package's _group_argmax
# ---------------------------------------------------------------------------


def _fold_plain_blocks(flat, D, k):
    """The plain partials of D equal blocks of ``flat``, folded."""
    n = flat.shape[0] // D
    stacked = sk.empty_triples(D, k, flat.dtype, CPU)
    for i in range(D):
        sk._copied(sk._group_partials(flat[i * n:(i + 1) * n], k, i * n, flat.shape[0]),
                   tuple(t[i] for t in stacked))
    return sk.fold_group_triples(*stacked)


def _held_to_jax(flat, D, k):
    got = _fold_plain_blocks(torch.from_numpy(flat), D, k)
    want = jax_cost._group_argmax(jnp.asarray(flat), k)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))
    return got


_CASES = {
    # name: (scores, D, k)
    "groups straddle blocks (k = 7 over D = 4)": (np.arange(48) % 5, 4, 7),
    "ties across blocks: the lowest global index wins": (np.full(24, 3.0), 4, 5),
    "a tie split by a block edge": (np.array([1, 2, 9, 4, 9, 0, 9, 9]), 2, 2),
    "the -inf-padded last group": (np.arange(30) % 7, 3, 8),
    "groups of padding alone (G = 1)": (np.arange(10) % 3, 2, 14),
    "blocks that hold no candidate of a group": (np.arange(96) % 11, 6, 2),
    "one block": (np.arange(17) % 4, 1, 5),
    "NaN scores, as the gathered form treats them": (
        np.array([1, np.nan, 3, 3, np.nan, 2, 5, 5, 1, np.nan, np.nan, 0]), 3, 4),
    "NaN as a group's only maximum in another block": (
        np.array([9, 9, 1, 1, np.nan, 0, 2, 2]), 4, 1),
    "-inf scores": (np.array([NEG, NEG, 1, NEG, NEG, NEG, 0, NEG]), 2, 3),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_plain_partials_and_fold_equal_jax_group_argmax(case):
    scores, D, k = _CASES[case]
    _held_to_jax(np.asarray(scores, dtype=np.float32), D, k)


def test_partials_wrappers_equal_the_gathered_form_on_integers():
    """``combo_score_topk_partials`` and ``block_score_topk_partials`` over
    D = 3 blocks of a padded batch, folded: equal to ``_group_argmax`` of the
    gathered scores (the parent's form), in float32 and float64."""
    rng = np.random.default_rng(3)
    S = 4
    combo = cost._combo_index(perms.order_batch(S).astype(np.int64))
    cid = np.concatenate([combo["cid"], combo["cid"][-1:]])      # 12 orders + 1 pad row: 13
    cid = np.concatenate([cid, cid[-1:].repeat(2, axis=0)])         # 15 = 3 x 5 rows
    orients = np.array(perms.orient_batch(S), dtype=np.int32)
    for dtype in (torch.float32, torch.float64):
        F = torch.from_numpy(rng.integers(0, 9, 4 * 5 * 5 * 33)).to(dtype)
        idx4 = torch.from_numpy(rng.integers(0, F.numel(), (combo["n_combo"], 4)))
        c0 = torch.tensor(2.0, dtype=dtype)
        o = torch.from_numpy(orients)
        blocks = [torch.from_numpy(np.ascontiguousarray(cid[i * 5:(i + 1) * 5], np.int32))
                  for i in range(3)]
        n, n_glob = 5 * 16, 15 * 16
        for k in (7, 16, 64):
            gathered = torch.cat([sk.combo_scores(F, idx4, b, o, c0).reshape(-1) for b in blocks])
            stacked = sk.empty_triples(3, k, dtype, CPU)
            for i, b in enumerate(blocks):
                row = tuple(t[i] for t in stacked)
                assert sk.combo_score_topk_partials(F, idx4, b, o, c0, k, i * n, n_glob,
                                                    out=row) is row
            for a, b in zip(sk.fold_group_triples(*stacked), sk._group_argmax(gathered, k)):
                assert torch.equal(a, b)
        sizes = torch.tensor([3, 1, 2, 4, 0])
        orders = [torch.from_numpy(rng.integers(0, 5, (4, S)).astype(np.int32)) for _ in range(3)]
        gathered = torch.cat([sk.block_scores(F, sizes, b, o, c0).reshape(-1) for b in orders])
        parts = [sk.block_score_topk_partials(F, sizes, b, o, c0, 9, i * 64, 3 * 64)
                 for i, b in enumerate(orders)]
        folded = sk.fold_group_triples(*(torch.stack(t) for t in zip(*parts)))
        for a, b in zip(folded, sk._group_argmax(gathered, 9)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("n0,n,n_glob,k", [(-1, 4, 8, 2), (5, 4, 8, 2), (0, 4, 8, 0),
                                           (0, 4, 8, 65536), (0, 0, 8, 2)])
def test_partial_span_rejects_a_block_outside_its_batch(n0, n, n_glob, k):
    with pytest.raises(ValueError):
        sk._partial_span(n, k, n0, n_glob)


def test_partials_and_fold_check_their_arguments():
    F = torch.zeros(4 * 9 * 5)
    combo = (F, torch.zeros((4, 4), dtype=torch.int64), torch.zeros((2, 3), dtype=torch.int32),
             torch.zeros((8, 3), dtype=torch.int32), torch.tensor(0.0))
    sk.combo_score_topk_partials(*combo, 4, 16, 48)
    with pytest.raises(ValueError):
        sk.combo_score_topk_partials(*combo, 4, 40, 48)   # past the batch's end
    with pytest.raises(ValueError):                         # an out of another length
        sk.combo_score_topk_partials(*combo, 4, 0, 48, out=sk.empty_triples(1, 3, F.dtype, CPU))
    with pytest.raises(ValueError):                         # an out of another type
        out = tuple(t[0] for t in sk.empty_triples(1, 4, torch.float64, CPU))
        sk.combo_score_topk_partials(*combo, 4, 0, 48, out=out)
    vals, idx, second = sk.empty_triples(2, 4, torch.float32, CPU)
    with pytest.raises(ValueError):
        sk.fold_group_triples(vals, idx.int(), second)
    with pytest.raises(ValueError):
        sk.fold_group_triples(vals, idx[:1], second)
    with pytest.raises(ValueError):
        sk.fold_group_triples(vals[0], idx[0], second[0])


# ---------------------------------------------------------------------------
# no score crosses devices on a mesh top-k path
# ---------------------------------------------------------------------------


def _problem(seed, sizes):
    rng = np.random.default_rng(seed)
    C = sum(sizes)
    m = np.triu(rng.random((C, C)), 1)
    return m + m.T, list(sizes)


def test_mesh_topk_paths_gather_no_score(monkeypatch):
    """On a (4, 2) mesh the combo and the chunked top-k paths call
    ``pm.gather`` no time: each batch's D blocks' [k] triples reach the
    scorer's device and are folded once ([4, k]); the dense ``score_batch``
    (the escalation) gathers its scores."""
    gathered, folded = [], []
    gather, fold = pm.gather, sk.fold_group_triples

    def counting_gather(parts, device, dim=0):
        gathered.append([tuple(p.shape) for p in parts])
        return gather(parts, device, dim)

    def counting_fold(vals, idx, second):
        folded.append(tuple(vals.shape))
        return fold(vals, idx, second)

    monkeypatch.setattr(pm, "gather", counting_gather)
    monkeypatch.setattr(sk, "fold_group_triples", counting_fold)
    mesh = pm.make_mesh((4, 2), [CPU] * 8)
    local = cost.ChromosomeScorer(*_problem(0, (5, 4, 3, 2)), CPU, dtype=np.float64).full()
    ours = cost.ChromosomeScorer(*_problem(0, (5, 4, 3, 2)), CPU, dtype=np.float64,
                                 mesh=mesh).full()
    orders, orients = perms.order_batch(4), perms.orient_batch(4)
    idx, vals, floor = ours.score_batch_topk(orders, orients, k=16)
    assert gathered == [] and folded == [(4, 16)]
    idx_l, vals_l, floor_l = local.score_batch_topk(orders, orients, k=16)
    np.testing.assert_array_equal(idx, idx_l)  # 12 orders: no mesh padding, the same groups
    np.testing.assert_allclose(vals, vals_l, rtol=1e-12, atol=0)
    assert floor == pytest.approx(floor_l, rel=1e-12)

    rng = np.random.default_rng(5)
    nine = cost.ChromosomeScorer(*_problem(4, (5, 4, 3, 3, 2, 2, 2, 1, 1)), CPU,
                                 dtype=np.float64, mesh=mesh).full()
    orders9 = np.stack([rng.permutation(9) for _ in range(21)])
    orients9 = rng.integers(0, 2, (6, 9)).astype(np.int32)
    folded.clear()
    nine.score_batch_topk(orders9, orients9, k=12, chunk_orders=8)
    assert gathered == [] and folded == [(4, 12)] * 3
    nine.score_batch(orders9, orients9, chunk_orders=8)
    assert gathered and all(len(shapes) == 4 for shapes in gathered)


def test_fold_blocks_copies_the_triples_of_blocks_on_another_device(monkeypatch):
    """Blocks whose device is not the scorer's (the mesh's first; here
    ``cpu:0`` positions after a ``cpu`` one, which compare unequal) return
    their triples, which are copied into the stacked rows: the same
    selection as blocks that all write their rows in place."""
    calls = []
    partials = sk.combo_score_topk_partials

    def recording(*args, out=None):
        calls.append(out is None)
        return partials(*args, out=out)

    monkeypatch.setattr(sk, "combo_score_topk_partials", recording)
    orders, orients = perms.order_batch(4), perms.orient_batch(4)
    got = {}
    for label, dev in (("in place", CPU), ("copied", torch.device("cpu", 0))):
        mesh = pm.make_mesh((4, 1), [CPU] + [dev] * 3)
        scorer = cost.ChromosomeScorer(*_problem(3, (5, 4, 3, 2)), CPU, dtype=np.float64,
                                       mesh=mesh).full()
        calls.clear()
        got[label] = scorer.score_batch_topk(orders, orients, k=7)
        assert calls == [False] + [label == "copied"] * 3  # True: no out, copied
    for a, b in zip(got["in place"][:2], got["copied"][:2]):
        np.testing.assert_array_equal(a, b)
    assert got["in place"][2] == got["copied"][2]
