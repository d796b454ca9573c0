"""The partition rules of the redesigned profile and combo kernels, in numpy.

The CUDA kernels of ``csrc/score_kernels.cu`` run only on a card
(tests/test_torch_gpu.py).  Their rules of who computes what are written
once here in numpy and held exactly to the plain versions on integer inputs
(every float32 sum exact), on drawn shapes:

* ``pair_profiles``: blocks of ``profile_pairs_per_block(cmax)`` pairs of
  one wrapped diagonal, (s, (s + k) mod Sp); the offsets from a block scan
  of the sizes in chunks of 512 ids; each pair's state (sums, zero, NaN);
  the list of the block's diagonals dealt to its 512 threads, each sum over
  rows in ascending order; each pair's span stored as float4s, the block's
  pairs in turn.
* ``combo_score_topk``: blocks of ``tile`` candidates clipped to their
  group; 8 warps taking whole orders; orientation masks in chunks; lanes on
  orientations r = lane + 32i of the range; a lane's (max, argmax, second)
  with an int32 offset, merged by the warps' xor butterflies and the block,
  the padding past N merged as its first index, and a group of several
  blocks folded as ``topk_merge`` folds it.
"""

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from hic_genome_assembler_tpu_torch.ops import cost, perms
from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

THREADS = 512        # a block of the profile kernel (kProfileThreads)
WARPS = 8            # a block of the combo kernel (kThreads / 32)
MASK_CHUNK = 2048    # kComboMaskChunk
INT32_MAX, INT64_MAX = 2**31 - 1, 2**63 - 1
NEG = -np.inf


# ---------------------------------------------------------------------------
# pair_profiles
# ---------------------------------------------------------------------------


def profile_model(m, sizes, cmax):
    """h [4*Sp*Sp, L] as pair_profiles_kernel computes it, block by block."""
    m = np.asarray(m, dtype=np.float32)
    sizes = np.asarray(sizes, dtype=np.int64)
    C, Sp, L = m.shape[0], len(sizes), 2 * cmax - 1
    L4, shift, per = 4 * L, cmax - 1, sk.profile_pairs_per_block(cmax)
    h = np.full((Sp * Sp, L4), 12345.0, dtype=np.float32)  # every float is stored
    blocks = [(s0, k) for k in range(Sp) for s0 in range(0, Sp, per)]
    for s0, k in blocks:
        P = min(per, Sp - s0)
        pairs = [(s, (s + k) % Sp) for s in range(s0, s0 + P)]
        # 1. a block scan of the sizes, in chunks of THREADS ids, to the last id named
        last = max(max(s, t) for s, t in pairs)
        offs, carry = {}, 0
        for base in range(0, last + 1, THREADS):
            chunk = sizes[base:min(base + THREADS, last + 1)]
            for j, excl in zip(range(base, base + len(chunk)), carry + np.cumsum(chunk) - chunk):
                offs[j] = int(excl)
            carry += int(chunk.sum())
        info = []
        for s, t in pairs:
            cs, ct = int(sizes[s]), int(sizes[t])
            bad = cs < 0 or ct < 0 or cs > cmax or ct > cmax or offs[s] + cs > C \
                or offs[t] + ct > C
            state = "nan" if bad else "zero" if (s == t or cs == 0 or ct == 0) else "sums"
            nd = cs + ct - 1 if state == "sums" else 0
            info.append(dict(state=state, cs=cs, ct=ct, nd=nd, os=offs[s], ot=offs[t]))
        item0 = np.concatenate([[0], np.cumsum([p["nd"] for p in info])])
        n_items = int(item0[-1])
        # 2. the sums: thread tid takes items tid, tid + THREADS, ...
        sums = np.zeros((P, 2, L), dtype=np.float32)
        for tid in range(THREADS):
            i = 0
            for it in range(tid, n_items, THREADS):
                while it >= item0[i] + info[i]["nd"]:
                    i += 1
                p, d = info[i], it - item0[i]
                blk = m[p["os"]:p["os"] + p["cs"], p["ot"]:p["ot"] + p["ct"]]
                su = sd = np.float32(0)
                for a in range(max(0, d - p["ct"] + 1), min(p["cs"] - 1, d) + 1):
                    su = np.float32(su + blk[a, d - a])
                off = d - p["cs"] + 1
                for a in range(max(0, -off), min(p["cs"] - 1, p["ct"] - 1 - off) + 1):
                    sd = np.float32(sd + blk[a, a + off])
                sums[i, 0, d], sums[i, 1, d] = su, sd

        def value(i, r):
            p = info[i]
            if p["state"] != "sums":
                return np.nan if p["state"] == "nan" else 0.0
            e = (r >= L) + (r >= 2 * L) + (r >= 3 * L)
            mm = r - e * L
            x = mm + p["cs"] - 1 - shift if e in (0, 2) else p["ct"] - 1 + shift - mm
            return sums[i, 1 if e in (0, 3) else 0, x] if 0 <= x < p["nd"] else 0.0

        # 3. each pair's span as L float4s, the block's pairs in turn
        for tid in range(THREADS):
            j, v = divmod(tid, L)
            for _f4 in range(tid, P * L, THREADS):
                s, t = pairs[j]
                for q in range(4):
                    h[s * Sp + t, 4 * v + q] = value(j, 4 * v + q)
                v += THREADS
                while v >= L:
                    v, j = v - L, j + 1
    return h.reshape(4 * Sp * Sp, L)


@st.composite
def _profile_cases(draw):
    Sp = draw(st.integers(1, 9))
    cmax = draw(st.sampled_from([1, 2, 3, 7, 16, 64]))
    n_pad = draw(st.integers(0, Sp - 1))
    sizes = [draw(st.integers(1, cmax)) for _ in range(Sp - n_pad)] + [0] * n_pad
    if draw(st.booleans()):  # a scaffold at cmax, somewhere
        sizes[draw(st.integers(0, Sp - 1))] = cmax
    return np.array(sizes, dtype=np.int64), cmax, draw(st.integers(0, 2**16))


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_profile_cases())
def test_profile_model_equals_plain_on_integers(case):
    sizes, cmax, seed = case
    C = int(sizes.sum())
    m = np.random.default_rng(seed).integers(0, 9, (max(C, 1), max(C, 1))).astype(np.float32)
    want = sk.pair_profiles_plain(torch.from_numpy(m), torch.from_numpy(sizes), cmax).numpy()
    np.testing.assert_array_equal(profile_model(m, sizes, cmax), want)


@pytest.mark.parametrize("cmax,per", [(1, 8), (64, 8), (128, 8), (384, 8), (704, 4),
                                      (3072, 1), (14400, 1)])
def test_profile_pairs_per_block(cmax, per):
    """As many pairs as 48 KB of sums hold, 1 to 8; a pair's sums alone
    fit the card's shared memory up to cmax 14,400 (the first kernel's
    limit was 11,622)."""
    assert sk.profile_pairs_per_block(cmax) == per
    assert 8 * (2 * cmax - 1) * per <= max(sk.PROFILE_SMEM, 8 * (2 * cmax - 1))
    sk._check_profiles(torch.zeros((2, 2)), torch.ones(2, dtype=torch.int64), cmax)
    with pytest.raises(ValueError):
        sk._check_profiles(torch.zeros((2, 2)), torch.ones(2, dtype=torch.int64), 14401)


def test_profile_model_nan_rows_for_a_layout_that_overruns():
    """Sizes past the matrix or above cmax: NaN rows for the pairs that
    name them, zero rows for s = t of a good id, sums elsewhere."""
    m = np.arange(64, dtype=np.float32).reshape(8, 8)
    h = profile_model(m, [3, 4, 2], 8)        # id 2 overruns C = 8
    rows = np.isnan(h).all(axis=1).reshape(3, 3, 4).all(axis=2)
    assert rows[2].all() and rows[:, 2].all() and rows.sum() == 5
    h4 = h.reshape(3, 3, 4, -1)
    assert (h4[0, 0] == 0).all() and not np.isnan(h4[0, 1]).any() and h4[0, 1].any()
    want = sk.pair_profiles_plain(torch.from_numpy(m), torch.tensor([3, 4, 1, 0]), 8).numpy()
    np.testing.assert_array_equal(profile_model(m, [3, 4, 1, 0], 8), want)
    assert np.isnan(profile_model(m, [3, 9, 0, 0], 8)).reshape(4, 4, 4, -1)[1].all()


# ---------------------------------------------------------------------------
# combo_score_topk
# ---------------------------------------------------------------------------


def _merge(a, b):
    """The kernels' exact (max, second, argmax) merge; lowest index on ties."""
    a_wins = a[0] > b[0] or (a[0] == b[0] and a[2] < b[2])
    w, lose = (a, b) if a_wins else (b, a)
    return (w[0], max(w[1], lose[0]), w[2])


def _butterfly(xs, empty):
    """A warp's xor-shuffle merge of its 32 lanes' triples (lane 0's)."""
    xs = list(xs) + [empty] * (32 - len(xs))
    for o in (16, 8, 4, 2, 1):
        xs = [_merge(xs[lane], xs[lane ^ o]) for lane in range(32)]
    return xs[0]


def combo_model(F, idx4, cid, orients, c0, k, tile, mask_chunk=MASK_CHUNK):
    """combo_kernel's rules: (vals, idx, second) for k > 0, scores [N] for k = 0."""
    F, idx4, cid, orients = map(np.asarray, (F, idx4, cid, orients))
    Bo, P = cid.shape
    R, S = orients.shape
    N = Bo * R
    G = -(-N // k) if k else N
    tiles = -(-G // tile)
    masks = [sum(int(f) << q for q, f in enumerate(row)) | (1 << 31 if any(f not in (0, 1)
                                                                       for f in row) else 0)
             for row in orients]
    pi, pj = np.triu_indices(S, k=1)
    costs = np.full(N, 777.0, dtype=np.float32)
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
                        values = np.full(4 * P, np.nan, dtype=np.float32)
                        for q in range(4 * P):
                            c = int(cid[b, q >> 2])
                            if 0 <= c < idx4.shape[0] and 0 <= idx4[c, q & 3] < F.size:
                                values[q] = F[idx4[c, q & 3]]
                        for lane in range(32):
                            for r in range(r0 + lane, rh, 32):
                                if r < rl:
                                    continue
                                mk = masks[r]
                                acc = np.float32(0)
                                for p in range(P):
                                    e = 2 * ((mk >> pi[p]) & 1) + ((mk >> pj[p]) & 1)
                                    acc = np.float32(acc + values[4 * p + e])
                                score = np.nan if mk >> 31 else np.float32(acc + c0)
                                if k:
                                    lanes[warp][lane] = _merge(lanes[warp][lane],
                                                               (score, NEG, nb + r - lo))
                                else:
                                    costs[nb + r] = score
            if not k:
                continue
            if real_hi < hi:  # the padding past N: its first index alone
                lanes[0][0] = _merge(lanes[0][0], (NEG, NEG, max(lo, N) - lo))
            empty = (NEG, NEG, INT32_MAX)
            v1, v2, i1 = _butterfly([_butterfly(w, empty) for w in lanes], empty)
            parts[g, t] = (v1, v2, lo + i1)
    if not k:
        return costs
    out = []
    for g in range(k):
        x = (NEG, NEG, INT64_MAX)
        if tiles == 1:
            x = parts[g, 0]
        else:  # topk_merge: lanes strided over the tiles, then a butterfly
            lanes = [(NEG, NEG, INT64_MAX)] * 32
            for t in range(tiles):
                lanes[t % 32] = _merge(lanes[t % 32], parts[g, t])
            x = _butterfly(lanes, (NEG, NEG, INT64_MAX))
        out.append(x)
    return (np.array([o[0] for o in out], dtype=np.float32), np.array([o[2] for o in out]),
            np.array([o[1] for o in out], dtype=np.float32))


def _combo_inputs(S, Bo, seed, n_combo=None):
    """Integer table values, random combos, the first ``Bo`` orders' cid
    rows of S positions (repeated past the enumeration, as a mesh pads)."""
    rng = np.random.default_rng(seed)
    index = cost._combo_index(perms.order_batch(S).astype(np.int64))
    cid = index["cid"][np.minimum(np.arange(Bo), index["cid"].shape[0] - 1)]
    n = index["n_combo"] if n_combo is None else n_combo
    F = rng.integers(0, 4, 500).astype(np.float32)
    idx4 = rng.integers(0, F.size, (n, 4))
    return F, idx4, np.ascontiguousarray(cid, dtype=np.int32), np.array(perms.orient_batch(S))


def _plain(F, idx4, cid, orients, c0, k):
    args = [torch.from_numpy(F), torch.from_numpy(idx4), torch.from_numpy(cid),
            torch.from_numpy(orients), torch.tensor(c0, dtype=torch.float32)]
    if k:
        return tuple(t.numpy() for t in sk.combo_score_topk_plain(*args, k))
    return sk.combo_scores_plain(*args).numpy().reshape(-1)


@st.composite
def _combo_cases(draw):
    S = draw(st.integers(2, 8))
    R = 2 ** S
    Bo = draw(st.integers(1, max(1, 6000 // (R * (S * (S - 1) // 2 + 1)))))
    k = draw(st.sampled_from([0, 1, 2, 7, 11, 64]))
    tile = draw(st.sampled_from([1, 5, 32, 100, 360, sk.TOPK_TILE]))
    chunk = draw(st.sampled_from([MASK_CHUNK, 8, 33]))
    return S, Bo, k, tile, chunk, draw(st.integers(0, 2**16))


@settings(max_examples=60, deadline=None, database=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_combo_cases())
def test_combo_model_equals_plain_on_integers(case):
    """Groups cut inside orders (G not a multiple of R), groups of padding
    alone, blocks clipped at group edges, several blocks a group, the masks
    in several chunks; k = 0 writes every score."""
    S, Bo, k, tile, chunk, seed = case
    F, idx4, cid, orients = _combo_inputs(S, Bo, seed)
    got = combo_model(F, idx4, cid, orients, 3.0, k, tile, chunk)
    want = _plain(F, idx4, cid, orients, 3.0, k)
    for a, b in zip(got if k else [got], want if k else [want]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("S,k", [(6, 64), (6, 7), (6, 2), (5, 11)])
def test_combo_model_at_the_main_paths_shape(S, k):
    """Every order of S positions (S = 6: 360 x 64 = 23,040 candidates, k =
    64 groups of G = 360, which is no multiple of R = 64), TOPK_TILE
    candidates a block."""
    F, idx4, cid, orients = _combo_inputs(S, len(perms.order_batch(S)), S * k)
    got = combo_model(F, idx4, cid, orients, 3.0, k, sk.TOPK_TILE)
    for a, b in zip(got, _plain(F, idx4, cid, orients, 3.0, k)):
        np.testing.assert_array_equal(a, b)


def test_combo_model_nan_for_bad_combos_and_flags():
    """A cid outside [0, n_combo) or a flag other than 0 or 1 gives NaN for
    its candidates only."""
    F, idx4, cid, orients = _combo_inputs(4, 24, 1)
    cid = cid.copy()
    cid[3, 2] = idx4.shape[0]
    orients = orients.copy()
    orients[5, 1] = 2
    scores = combo_model(F, idx4, cid, orients, 3.0, 0, 64).reshape(24, 16)
    assert np.isnan(scores[3]).all() and np.isnan(scores[:, 5]).all()
    assert np.isfinite(np.delete(np.delete(scores, 3, 0), 5, 1)).all()
