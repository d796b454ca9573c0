"""The work division of the block-score kernel, in numpy.

``block_kernel`` (``csrc/score_kernels.cu``) runs only on a card
(tests/test_torch_gpu.py).  Its rules of who computes what are written once
here in numpy and held exactly to the plain versions on integer tables
(every float32 sum exact in any order), on drawn shapes:

* blocks of ``tile`` candidates: whole orders for the grid form (one a
  warp, ``score_kernels.BLOCK_WARPS`` of them), a range of
  ``score_kernels.TOPK_TILE`` clipped to one group for the top-k form;
* the orientation masks in chunks (bit 31 for a flag other than 0 or 1), the
  pairs' (i, j) decoded once a block;
* a warp an order: the ids and sizes of lanes q < S, a shuffle scan of the
  sizes, NaN for the order where an id leaves [0, Sp), a size is negative or
  a prefix reaches C + 1; the 4P values gathered;
* the halves split (``score_kernels.block_halves`` picks it): the tables TB
  and X_j (X_a with the pairs inside A), each entry one lane's sum, and a
  score TB + the X_j + c0; else the direct sums over p ascending;
* the grid form's stores, four orientations a lane where R is a multiple of
  4, else one; the top-k form's lane triples (each candidate pushed where
  the masks fit one chunk, else merged), merged by the warps' xor
  butterflies and the block, the padding past N as its first index, a
  group of several blocks folded as ``topk_merge`` folds it.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hic_genome_assembler_tpu_torch.ops import perms
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

WARPS = sk.BLOCK_WARPS  # a block of the block kernel (kThreads / 32)
MASK_CHUNK = 2048    # kComboMaskChunk
INT32_MAX, INT64_MAX = 2**31 - 1, 2**63 - 1
NEG = -np.inf
F32 = np.float32


def _merge(a, b):
    """The kernels' exact (max, second, argmax) merge; lowest index on ties."""
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[2] < b[2])
    w, lose = (a, b) if a_wins else (b, a)
    return (w[0], max(w[1], lose[0]), w[2])


def _push(x, v, i):
    """The kernel's push: merge(x, (v, -inf, i)) where x is empty or i is
    above its argmax."""
    assert x[2] == INT32_MAX or i > x[2]
    wins = not v <= x[0] or x[2] == INT32_MAX
    return (v, max(NEG, x[0]), i) if wins else (x[0], max(x[1], v), x[2])


def _butterfly(xs, empty):
    """A warp's xor-shuffle merge of its 32 lanes' triples (lane 0's)."""
    xs = list(xs) + [empty] * (32 - len(xs))
    for o in (16, 8, 4, 2, 1):
        xs = [_merge(xs[lane], xs[lane ^ o]) for lane in range(32)]
    return xs[0]


def _pairs(S):
    """Each thread p < P decodes its pair as the kernel does."""
    out = []
    for p in range(S * (S - 1) // 2):
        i, rest = 0, p
        while rest >= S - 1 - i:
            rest -= S - 1 - i
            i += 1
        out.append((i, i + 1 + rest))
    return out


def _pair_index(i, j, S):
    return i * (2 * S - i - 1) // 2 + (j - i - 1)


def _load_order(order, sizes, Cp1):
    """Lanes q < S: ids, exclusive offsets (a shuffle scan) and bad."""
    S, Sp = len(order), len(sizes)
    bad, sz = [], []
    for q in range(S):
        b = not 0 <= order[q] < Sp
        s = 0 if b else int(sizes[order[q]])
        bad.append(b or s < 0)
        sz.append(s)
    incl = np.cumsum(sz)
    bad = any(bad) or any(int(v) >= Cp1 for v in incl)
    return bad, [int(v) for v in incl - np.asarray(sz)]


def _halves_tables(values, S):
    """TB [2^b], X [b][2^(a+1)] (X_a with the pairs inside A): entry t is
    one lane's sum."""
    a, b = S // 2, S - S // 2
    nA, nB = 2**a, 2**b
    tabs = []
    for t in range(nB + b * 2 * nA):
        acc = F32(0)
        if t < nB:
            for i in range(a, S):
                for j in range(i + 1, S):
                    acc = F32(acc + values[4 * _pair_index(i, j, S) + ((t >> (i - a)) & 1) * 2
                                           + ((t >> (j - a)) & 1)])
        else:
            u = t - nB
            j, mA, bj = a + u // (2 * nA), (u & (2 * nA - 1)) >> 1, u & 1
            for i in range(a):
                acc = F32(acc + values[4 * _pair_index(i, j, S) + ((mA >> i) & 1) * 2 + bj])
            if j == a:
                for i in range(a):
                    for i2 in range(i + 1, a):
                        acc = F32(acc + values[4 * _pair_index(i, i2, S) + ((mA >> i) & 1) * 2
                                               + ((mA >> i2) & 1)])
        tabs.append(acc)
    return tabs


def _halves_sum(tabs, m, S):
    a, b = S // 2, S - S // 2
    nA, nB = 2**a, 2**b
    acc = F32(tabs[(m >> a) & (nB - 1)])
    for jj in range(b):
        acc = F32(acc + tabs[nB + 2 * (m & (nA - 1)) + jj * 2 * nA + ((m >> (a + jj)) & 1)])
    return acc


def _direct_sum(values, m, S):
    acc, p = F32(0), 0
    for i in range(S - 1):
        for j in range(i + 1, S):
            acc = F32(acc + values[4 * p + ((m >> i) & 1) * 2 + ((m >> j) & 1)])
            p += 1
    return acc


def block_model(F, sizes, orders, orients, c0, k, tile, halves, mask_chunk=MASK_CHUNK):
    """block_kernel's rules: (vals, idx, second) for k > 0, scores [N] for
    k = 0 (each written exactly once)."""
    F, sizes, orders, orients = map(np.asarray, (F, sizes, orders, orients))
    F = F.astype(F32)
    Bo, S = orders.shape
    R = orients.shape[0]
    Sp = len(sizes)
    Cp1 = F.size // (4 * Sp * Sp)
    N = Bo * R
    G = -(-N // k) if k else N
    tiles = -(-G // tile)
    if not k:
        assert tile % R == 0
    vec4 = R % 4 == 0
    # a chunk's masks hold rows [r0, r1); row r's is masks[r] here
    masks = [sum(int(f) << q for q, f in enumerate(row)) | (1 << 31 if any(f not in (0, 1)
                                                                       for f in row) else 0)
             for row in orients]
    pairs = _pairs(S)
    P = len(pairs)
    costs = np.full(N, 777.0, dtype=F32)
    written = np.zeros(N, dtype=np.int64)
    parts = {}
    for g in range(k if k else 1):
        for t in range(tiles):
            lo = g * G + t * tile if k else t * tile
            hi = min(lo + tile, (g + 1) * G if k else N)
            real_hi = min(hi, N)
            lanes = [[(NEG, NEG, INT32_MAX)] * 32 for _ in range(WARPS)]
            for r0 in range(0, R, mask_chunk):
                r1 = min(R, r0 + mask_chunk)
                if lo >= real_hi:
                    continue
                for warp in range(WARPS):
                    for b in range(lo // R + warp, (real_hi - 1) // R + 1, WARPS):
                        nb = b * R
                        rl, rh = max(r0, lo - nb), min(r1, real_hi - nb)
                        if rl >= rh:
                            continue
                        bad, offs = _load_order(orders[b], sizes, Cp1)
                        if not bad:
                            values = [F[((int(orders[b, i]) * Sp + int(orders[b, j])) * 4 + e)
                                        * Cp1 + offs[j] - offs[i]]
                                      for i, j in pairs for e in range(4)]
                            assert len(values) == 4 * P
                            tabs = _halves_tables(values, S) if halves else None

                        def score(m):
                            if bad or m >> 31:
                                return F32(np.nan)
                            acc = _halves_sum(tabs, m, S) if halves else _direct_sum(values, m, S)
                            return F32(acc + F32(c0))

                        for lane in range(32):
                            if k:
                                for r in range(r0 + lane, rh, 32):
                                    if r >= rl:
                                        x, v = lanes[warp][lane], score(masks[r])
                                        lanes[warp][lane] = (
                                            _push(x, v, nb + r - lo) if R <= mask_chunk
                                            else _merge(x, (v, NEG, nb + r - lo)))
                            elif vec4:  # whole orders: rl = r0, rh = r1
                                assert (rl, rh) == (r0, r1)
                                for r in range(r0 + 4 * lane, rh, 128):
                                    for q in range(4):
                                        costs[nb + r + q] = score(masks[r + q])
                                        written[nb + r + q] += 1
                            else:
                                for r in range(r0 + lane, rh, 32):
                                    costs[nb + r] = score(masks[r])
                                    written[nb + r] += 1
            if not k:
                continue
            if real_hi < hi:  # the padding past N: its first index alone
                lanes[0][0] = _merge(lanes[0][0], (NEG, NEG, max(lo, N) - lo))
            empty = (NEG, NEG, INT32_MAX)
            v1, v2, i1 = _butterfly([_butterfly(w, empty) for w in lanes], empty)
            parts[g, t] = (v1, v2, lo + i1)
    if not k:
        assert (written == 1).all()
        return costs
    out = []
    for g in range(k):
        if tiles == 1:
            x = parts[g, 0]
        else:  # topk_merge: lanes strided over the tiles, then a butterfly
            lanes = [(NEG, NEG, INT64_MAX)] * 32
            for t in range(tiles):
                lanes[t % 32] = _merge(lanes[t % 32], parts[g, t])
            x = _butterfly(lanes, (NEG, NEG, INT64_MAX))
        out.append(x)
    return (np.array([o[0] for o in out], dtype=F32), np.array([o[2] for o in out]),
            np.array([o[1] for o in out], dtype=F32))


def _inputs(S, Bo, R, seed, ids="perm", Sp=12, Cp1=97):
    """An integer table, sizes of Sp - 1 scaffolds and a pad id, Bo orders
    of S ids and R orientation rows (every orientation when R = 2**S)."""
    rng = np.random.default_rng(seed)
    sizes = np.zeros(Sp, dtype=np.int64)
    sizes[: Sp - 1] = rng.integers(1, 9, Sp - 1)
    F = rng.integers(0, 5, 4 * Sp * Sp * Cp1).astype(F32)
    if ids == "repeat":
        orders = rng.integers(0, Sp, (Bo, S))
    else:
        orders = np.stack([rng.permutation(Sp - 1)[:S] for _ in range(Bo)])
    orients = np.array(perms.orient_batch(S)) if R == 2**S else rng.integers(0, 2, (R, S))
    assert S * sizes.max() < Cp1  # every order's offsets stay inside the table
    return F, sizes, orders.astype(np.int32), orients.astype(np.int32)


def _plain(F, sizes, orders, orients, c0, k):
    args = [torch.from_numpy(a) for a in (F, sizes, orders, orients)]
    args.append(torch.tensor(c0, dtype=torch.float32))
    if k:
        return tuple(t.numpy() for t in sk.block_score_topk_plain(*args, k))
    return sk.block_scores_plain(*args).numpy().reshape(-1)


@st.composite
def _block_cases(draw):
    S = draw(st.integers(1, 10))
    full = draw(st.booleans()) and S <= 8
    R = 2**S if full else draw(st.integers(1, 70))
    P = S * (S - 1) // 2
    Bo = draw(st.integers(1, max(1, 3000 // (R * (P + 1)))))
    k = draw(st.sampled_from([0, 0, 1, 2, 7, 11, 64]))
    tile = WARPS * R if k == 0 else draw(st.sampled_from([1, 5, 32, 100, 360, sk.TOPK_TILE]))
    halves = draw(st.sampled_from(["rule", True, False])) if S >= 2 else False
    chunk = draw(st.sampled_from([MASK_CHUNK, 8, 36]))
    ids = draw(st.sampled_from(["perm", "repeat"]))
    return S, Bo, R, k, tile, halves, chunk, ids, draw(st.integers(0, 2**16))


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_block_cases())
def test_block_model_equals_plain_on_integers(case):
    """Bo no multiple of the orders a block, groups cut inside orders,
    groups of padding alone, several blocks a group, masks in several
    chunks, R ragged, repeated ids; both sums."""
    S, Bo, R, k, tile, halves, chunk, ids, seed = case
    if halves == "rule" or S > sk.BLOCK_HALVES_MAX_S:
        halves = sk.block_halves(S, R) if halves == "rule" else False
    F, sizes, orders, orients = _inputs(S, Bo, R, seed, ids)
    got = block_model(F, sizes, orders, orients, 3.0, k, tile, halves, chunk)
    want = _plain(F, sizes, orders, orients, 3.0, k)
    for a, b in zip(got if k else [got], want if k else [want]):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=200, deadline=None, database=None)
@given(st.lists(st.sampled_from([0.0, 1.0, 2.0, NEG]), min_size=1, max_size=12))
def test_push_equals_merge_for_ascending_indices(scores):
    """A lane's candidates arrive with ascending indices when the masks fit
    one chunk: pushing them gives merge's triple, ties and -inf included."""
    pushed = merged = (NEG, NEG, INT32_MAX)
    for i, v in enumerate(scores):
        pushed, merged = _push(pushed, v, i), _merge(merged, (v, NEG, i))
        assert pushed == merged


@pytest.mark.parametrize("S,k", [(8, 0), (8, 64), (9, 64), (6, 7), (1, 2), (1, 1), (1, 0)])
def test_block_model_at_the_escalations_shape(S, k):
    """Every orientation of 40 orders at S = 8 (the escalation's chunk
    shape, R = 256), of 16 at S = 6 and 9 (groups that cut orders) and of
    one at S = 1 (a one-scaffold chromosome's top-k, the non-combo path's
    only caller), with the wrappers' tiles and choice of sums."""
    R, Bo = 2**S, {8: 40, 1: 1}.get(S, 16)
    F, sizes, orders, orients = _inputs(S, Bo, R, S + k)
    tile = WARPS * R if k == 0 else sk.TOPK_TILE
    got = block_model(F, sizes, orders, orients, 3.0, k, tile, sk.block_halves(S, R))
    want = _plain(F, sizes, orders, orients, 3.0, k)
    for a, b in zip(got if k else [got], want if k else [want]):
        np.testing.assert_array_equal(a, b)


def test_block_model_nan_for_bad_orders_and_flags():
    """An id outside [0, Sp), a negative size or sizes that reach C + 1 give
    NaN for the order's scores, a flag other than 0 or 1 for its row's; the
    other scores are the plain version's, in both sums."""
    F, sizes, _orders, orients = _inputs(6, 24, 64, 1)
    sizes, orients = sizes.copy(), orients.copy()
    orders = np.array(perms.order_batch(6)[:24], dtype=np.int32)  # ids 0..5
    orders[3, 2] = 12                     # past Sp
    orders[4, 0] = -1
    orders[5, :] = 7                      # 6 x 17 reaches C + 1 = 97
    sizes[7] = 17
    orders[6, 1] = 8                      # a negative size
    sizes[8] = -2
    orients[9, 4] = 3
    keep = np.array([b for b in range(24) if b not in (3, 4, 5, 6)])
    want = _plain(F, sizes, orders[keep], orients, 3.0, 0).reshape(len(keep), 64)
    for halves in (True, False):
        scores = block_model(F, sizes, orders, orients, 3.0, 0, WARPS * 64, halves).reshape(24, 64)
        assert np.isnan(scores[[3, 4, 5, 6]]).all() and np.isnan(scores[:, 9]).all()
        np.testing.assert_array_equal(np.delete(scores[keep], 9, axis=1),
                                      np.delete(want, 9, axis=1))


@pytest.mark.parametrize("S,R,want", [(8, 256, True), (9, 512, True), (9, 64, True),
                                      (8, 37, True), (6, 64, True), (5, 32, True),
                                      (4, 16, True), (3, 8, False), (10, 64, False),
                                      (11, 2048, False), (1, 1, False)])
def test_block_halves_rule(S, R, want):
    """The halves tables where the adds the rows save outweigh the tables'
    adds, and only for 2 <= S <= BLOCK_HALVES_MAX_S; ``block_adds`` counts
    the form taken."""
    assert sk.block_halves(S, R) is want
    per_order, per_cand = sk.block_adds(S, R)
    P = S * (S - 1) // 2
    if want:
        assert per_cand == S - S // 2 + 1
        assert R * (P + 1) > per_order + R * per_cand
    else:
        assert (per_order, per_cand) == (0, P + 1)
