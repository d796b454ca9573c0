"""The scoring kernels' plain versions against the JAX package's functions.

``ops/score_kernels.py`` holds part 2's four device functions (pair
profiles, combo top-k, block scores, pair scores) with the group epilogue;
on the CPU each wrapper runs its plain torch version, which is also the
oracle of the kernel on the card.  Each is held here against the JAX
function it replaces, run on the CPU with x64 as ``tests/conftest.py`` sets
it, on the same seeded numpy inputs.  Integer-valued inputs make every f32
sum exact in any order: values, argmaxes and second maxima must be equal,
ties included.  Float inputs are held to ``sum_bound``, the largest
difference of two summation orders of n non-negative terms, and a group's
argmax must agree wherever its top two scores lie more than twice that bound
apart.
"""

import numpy as np
import pytest
import torch

jnp = pytest.importorskip("jax.numpy")

from hic_genome_assembler_tpu.ops import cost as jax_cost  # noqa: E402
from hic_genome_assembler_tpu.ops import perms  # noqa: E402
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk  # noqa: E402

KINDS = ("int", "float")


def _t(a, dtype=None):
    return torch.from_numpy(np.require(a, dtype, ["C", "W"]))


def _table(rng, Sp, Cp1, kind, high=16, sizes=None):
    """A random table [4*Sp*Sp*(C+1)]; with ``sizes``, the rows of size-0
    (pad) ids are zero, as in every table built from pair profiles."""
    shape = (Sp, Sp, 4, Cp1)
    vals = rng.integers(0, high, shape) if kind == "int" else rng.random(shape)
    if sizes is not None:
        vals[(sizes[:, None] == 0) | (sizes[None, :] == 0)] = 0
    return vals.astype(np.float32).reshape(-1)


def _c0(rng, kind):
    return np.float32(7.0 if kind == "int" else 5 * rng.random())


def _sizes(rng, S, Sp, high=9):
    sizes = np.zeros(Sp, dtype=np.int64)
    sizes[:S] = rng.integers(1, high, S)
    return sizes


def _assert_close(got, want, kind, n_terms, abs_sum):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    if kind == "int":
        np.testing.assert_array_equal(got, want)
    else:
        assert np.all(np.abs(got - want) <= sk.sum_bound(n_terms, np.abs(abs_sum)))


def _assert_topk(got, want, kind, n_terms, group_max):
    """``got`` (torch) and ``want`` (JAX) (vals, idx, second) triples;
    ``group_max``: each group's largest exact score."""
    vals, idx, second = (t.numpy() for t in got)
    wvals, widx, wsecond = (np.asarray(a) for a in want)
    assert vals.shape == wvals.shape == idx.shape == second.shape
    if kind == "int":
        np.testing.assert_array_equal(vals, wvals)
        np.testing.assert_array_equal(idx, widx)
        np.testing.assert_array_equal(second, wsecond)
        return
    bound = sk.sum_bound(n_terms, group_max)
    with np.errstate(invalid="ignore"):  # -inf - -inf in groups of padding alone
        for x, y in ((vals, wvals), (second, wsecond)):
            assert np.all((x == y) | (np.abs(x.astype(np.float64) - y) <= bound))
        clear = (wvals.astype(np.float64) - wsecond) > 2 * bound
    np.testing.assert_array_equal(idx[clear], widx[clear])


def _group_max(scores64, k):
    flat = np.asarray(scores64, np.float64).ravel()
    flat = np.concatenate([flat, np.zeros((-flat.size) % k)])
    return flat.reshape(k, -1).max(axis=1)


# ---------------------------------------------------------------------------
# pair profiles
# ---------------------------------------------------------------------------

_PROFILE_CASES = [
    # (scaffold sizes, Sp, cmax): a small chromosome, one whose largest
    # scaffold fills its cmax bucket, and one with one-bin scaffolds
    ((5, 3, 2, 2, 1), 9, 64),
    ((70, 9, 5, 4, 4, 3, 2, 2, 1, 1, 1), 16, 128),
    ((1, 1, 1, 1), 9, 64),
]


def _profile_inputs(sizes, Sp, kind, seed):
    rng = np.random.default_rng(seed)
    C = sum(sizes)
    m = rng.integers(0, 8, (C, C)) if kind == "int" else rng.random((C, C))
    m = np.triu(m, 1) + np.triu(m, 1).T + np.diag(np.diag(m))
    padded = np.zeros(Sp, dtype=np.int64)
    padded[: len(sizes)] = sizes
    return m.astype(np.float32), padded


def _jax_skew(m, sizes, Sp, cmax, k):
    """``_skew_profile_chunk`` assembled over its chunks of ``k`` rows, as
    the JAX ``ChromosomeScorer`` builds it."""
    C = m.shape[0]
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    blk_idx = np.full((Sp, cmax), C, dtype=np.int64)
    for s, (o, c) in enumerate(zip(offsets, sizes)):
        blk_idx[s, :c] = np.arange(o, o + c)
    m_pad = jnp.asarray(np.pad(m, ((0, 1), (0, 1))))
    chunks = []
    for s0 in range(0, Sp, k):
        kk = min(k, Sp - s0)
        chunks.append(np.asarray(jax_cost._skew_profile_chunk(
            m_pad, jnp.asarray(blk_idx), jnp.asarray(sizes), s0, Sp, kk)))
    return np.concatenate(chunks).reshape(4 * Sp * Sp, 2 * cmax - 1)


def _jax_scatter(m, sizes, Sp, cmax):
    sid = np.repeat(np.arange(Sp), sizes)
    loc = np.concatenate([np.arange(c) for c in sizes])
    return np.asarray(jax_cost._build_pair_profiles(
        jnp.asarray(m), jnp.asarray(sid), jnp.asarray(loc), jnp.asarray(sizes), Sp,
        2 * cmax - 1, cmax))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", range(len(_PROFILE_CASES)))
def test_pair_profiles_equal_both_jax_builds(case, kind):
    """Both of the port's plain builds (the skew in chunks, the scatter-add)
    and the wrapper on the CPU equal both JAX builds: the skew assembled
    over chunks of 3 rows and the scatter-add."""
    sizes, Sp, cmax = _PROFILE_CASES[case]
    m, padded = _profile_inputs(sizes, Sp, kind, seed=case)
    M, sz = _t(m), _t(padded)
    three_rows = 3 * cmax * Sp * cmax
    skew = sk.pair_profiles_plain(M, sz, cmax, three_rows).numpy()
    scatter = sk.pair_profiles_plain(M, sz, cmax, 1).numpy()
    wrapper = sk.pair_profiles(M, sz, cmax).numpy()
    exact = sk.pair_profiles_plain(M.double(), sz, cmax, 1).numpy()
    assert skew.shape == (4 * Sp * Sp, 2 * cmax - 1) and skew.dtype == np.float32
    np.testing.assert_array_equal(wrapper, sk.pair_profiles_plain(M, sz, cmax).numpy())
    for want in (_jax_skew(m, padded, Sp, cmax, 3), _jax_scatter(m, padded, Sp, cmax)):
        for got in (skew, scatter):
            _assert_close(got, want, kind, cmax, exact)
    # s = t rows and pad slots are zero
    h4 = skew.reshape(Sp, Sp, 4, -1)
    assert not h4[np.arange(Sp), np.arange(Sp)].any()
    assert not h4[len(sizes):].any() and not h4[:, len(sizes):].any()


# ---------------------------------------------------------------------------
# group epilogue
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 4, 7, 25, 64])
def test_group_argmax_equals_jax_with_ties(k):
    """Exact ties within and across groups, a ragged last group (N % k != 0)
    and, for k = 64 > N / 2, groups made of padding alone."""
    rng = np.random.default_rng(k)
    flat = rng.integers(0, 3, 101).astype(np.float32)
    got = sk.group_argmax(_t(flat), k)
    want = jax_cost._group_argmax(jnp.asarray(flat), k)
    _assert_topk(got, want, "int", 1, None)
    assert got[1].dtype == torch.int64


# ---------------------------------------------------------------------------
# combo top-k
# ---------------------------------------------------------------------------


def _combo_inputs(S, kind, seed, high=16):
    rng = np.random.default_rng(seed)
    Sp, Cp1 = 9, 97
    combo = jax_cost._combo_index(perms.order_batch(S))
    F = _table(rng, Sp, Cp1, kind, high)
    idx4 = rng.integers(0, F.size, (combo["n_combo"], 4)).astype(np.int64)
    orients = perms.orient_batch(S)
    return F, idx4, combo["cid"], orients, _c0(rng, kind)


def _jax_combo_topk(F, idx4, cid, orients, c0, k):
    S = orients.shape[1]
    P, R = S * (S - 1) // 2, orients.shape[0]
    E = jax_cost._orient_onehot(S, orients, np.dtype(np.float32)).reshape(P, 4, R)
    return jax_cost._combo_score_topk_kernel(
        jnp.asarray(F), jnp.asarray(idx4), jnp.asarray(cid), jnp.asarray(E), jnp.float32(c0), k)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("S,k", [(2, 1), (3, 4), (4, 7), (5, 64), (6, 64), (6, 7), (7, 64),
                                 (8, 64)])
def test_combo_topk_equals_jax(S, k, kind):
    """S = 2..8 over the enumeration batches of ``perms``; k = 7 leaves a
    ragged last group; integer values of 0..2 at S = 6 and 7 make exact
    ties within and across groups."""
    high = 3 if S in (6, 7) else 16
    F, idx4, cid, orients, c0 = _combo_inputs(S, kind, seed=10 * S + k, high=high)
    args = [_t(F), _t(idx4), _t(cid, np.int32), _t(orients, np.int32), _t(c0)]
    k = min(k, cid.shape[0] * orients.shape[0])
    got = sk.combo_score_topk(*args, k)
    want = _jax_combo_topk(F, idx4, cid, orients, c0, k)
    exact = sk.combo_scores_plain(args[0].double(), *args[1:4], args[4].double())
    _assert_topk(got, want, kind, S * (S - 1) // 2 + 1, _group_max(exact, k))
    scores = sk.combo_scores(*args)
    assert scores.shape == (cid.shape[0], orients.shape[0])
    _assert_topk(sk.group_argmax(scores.reshape(-1), k), want, kind,
                 S * (S - 1) // 2 + 1, _group_max(exact, k))


def test_combo_topk_on_a_mesh_padded_batch():
    """The mesh path: a batch padded by repeating its last order, scored,
    then grouped over the padded scores as the JAX mesh path groups them."""
    F, idx4, cid, orients, c0 = _combo_inputs(5, "int", seed=3, high=3)
    padded = np.concatenate([cid, np.repeat(cid[-1:], 2, axis=0)])
    args = [_t(F), _t(idx4), _t(padded, np.int32), _t(orients, np.int32), _t(c0)]
    got = sk.group_argmax(sk.combo_scores(*args).reshape(-1), 64)
    _assert_topk(got, _jax_combo_topk(F, idx4, padded, orients, c0, 64), "int", 1, None)


# ---------------------------------------------------------------------------
# block scores
# ---------------------------------------------------------------------------

_BLOCK_CASES = {
    # name: (S, orders of ids drawn how)
    "S=1 (one scaffold, no pairs)": (1, "perm"), "S=2": (2, "perm"), "S=3": (3, "perm"),
    "S=5": (5, "perm"), "S=7": (7, "perm"),
    "S=8": (8, "perm"), "S=9 (above the combo path)": (9, "random"),
    "repeated ids": (5, "repeat"), "pad ids": (6, "pads"),
}


def _block_inputs(S, how, kind, seed):
    rng = np.random.default_rng(seed)
    Sp, Cp1 = 16, 161
    sizes = _sizes(rng, 12, Sp)
    assert S * sizes.max() < Cp1  # every row's offsets stay inside the table
    if how == "perm":
        ids = rng.permutation(12)[:S]
        orders = ids[perms.order_batch(S)[:150]]
    elif how == "random":
        orders = np.stack([rng.permutation(12)[:S] for _ in range(70)])
    elif how == "repeat":
        orders = rng.integers(0, 4, (90, S))
    else:
        orders = np.where(rng.random((80, S)) < 0.3, 12, rng.integers(0, 12, (80, S)))
    orients = rng.integers(0, 2, (2 ** min(S, 6), S))
    F = _table(rng, Sp, Cp1, kind, sizes=sizes)
    return F, sizes, orders.astype(np.int32), orients.astype(np.int32), _c0(rng, kind), Cp1


@pytest.mark.parametrize("topk", ["group_argmax of the scores", "block_score_topk"])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("case", list(_BLOCK_CASES))
def test_block_scores_equal_jax(case, kind, topk):
    """Full scores and their top-k (the JAX ``_block_score_topk_kernel``),
    through the group epilogue of the scores or the fused wrapper, with
    permuted, repeated and pad ids, k = 64 and a ragged k = 7."""
    S, how = _BLOCK_CASES[case]
    F, sizes, orders, orients, c0, Cp1 = _block_inputs(S, how, kind, seed=len(case) + S)
    args = [_t(F), _t(sizes), _t(orders), _t(orients), _t(c0)]
    got = sk.block_scores(*args)
    pi, pj = (jnp.asarray(a) for a in np.triu_indices(S, k=1))
    E = jnp.asarray(jax_cost._orient_onehot(S, orients, np.dtype(np.float32)))
    jargs = (jnp.asarray(F), jnp.asarray(sizes), jnp.asarray(orders.astype(np.int64)), E, pi, pj,
             jnp.float32(c0))
    want = np.asarray(jax_cost._block_score_kernel(*jargs, Cp1))
    exact = sk.block_scores_plain(args[0].double(), *args[1:4], args[4].double()).numpy()
    n_terms = S * (S - 1) // 2 + 1
    _assert_close(got.numpy(), want, kind, n_terms, exact)
    for k in (64, 7):
        ours = sk.group_argmax(got.reshape(-1), k) if topk.startswith("group") else \
            sk.block_score_topk(*args, k)
        _assert_topk(ours, jax_cost._block_score_topk_kernel(*jargs, Cp1, k), kind, n_terms,
                     _group_max(exact, k))


# ---------------------------------------------------------------------------
# pair scores
# ---------------------------------------------------------------------------


def _pair_inputs(W, n_real, kind, seed, scatter):
    rng = np.random.default_rng(seed)
    Sp, Cp1 = 24, 257
    S = Sp - 1
    sizes = _sizes(rng, S, Sp, high=12)
    assert sizes.sum() < Cp1
    B = 45
    orders = np.full((B, W), S, dtype=np.int32)
    for b in range(B):
        ids = rng.permutation(S)[:n_real]
        slots = np.sort(rng.choice(W, n_real, replace=False)) if scatter else np.arange(n_real)
        orders[b, slots] = ids
    orients = rng.integers(0, 2, (B, W)).astype(np.int32)
    return _table(rng, Sp, Cp1, kind, sizes=sizes), sizes, orders, orients, _c0(rng, kind), Cp1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("W,n_real,scatter", [(8, 8, False), (13, 9, False), (13, 10, True),
                                              (24, 23, False), (56, 20, True), (3, 1, False),
                                              (1, 1, False)])
def test_pair_scores_equal_jax(W, n_real, scatter, kind):
    """Widths that are and are not multiples of 8, pads at the end (greedy
    insertion) and scattered inside rows, rows with one real id, and W = 1."""
    F, sizes, orders, orients, c0, Cp1 = _pair_inputs(W, n_real, kind, W + n_real, scatter)
    args = [_t(F), _t(sizes), _t(np.concatenate([orders, orients], axis=1)), _t(c0)]
    got = sk.pair_scores(*args).numpy()
    pi, pj = (jnp.asarray(a) for a in np.triu_indices(W, k=1))
    want = np.asarray(jax_cost._pair_score_kernel(
        jnp.asarray(F), jnp.asarray(sizes), jnp.asarray(orders.astype(np.int64)),
        jnp.asarray(orients.astype(np.int64)), pi, pj, jnp.float32(c0), Cp1))
    exact = sk.pair_scores_plain(args[0].double(), args[1], args[2], args[3].double()).numpy()
    _assert_close(got, want, kind, W * (W - 1) // 2 + 1, exact)


def test_sum_bound():
    assert sk.sum_bound(1, 5.0) == 0.0
    assert sk.sum_bound(3, 1.0) == 4 * 2.0**-24
    np.testing.assert_array_equal(sk.sum_bound(np.array([2, 5]), np.array([2.0, 1.0])),
                                  [4 * 2.0**-24, 8 * 2.0**-24])
