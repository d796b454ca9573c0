"""Part 2's scoring kernels: pair profiles, combo top-k, block scores and
pair scores.

Counterparts of the device functions of ``hic_genome_assembler_tpu/ops/cost.py``,
which XLA fuses into kernels on the TPU:

* :func:`pair_profiles` — ``_skew_profile_chunk`` (``:82-151``) and
  ``_build_pair_profiles`` (``:158-188``): the orientation-resolved
  scaffold-pair diagonal profiles ``h [4*Sp*Sp, L]`` of a chromosome;
* :func:`combo_score_topk` and :func:`combo_scores` —
  ``_combo_score_topk_kernel`` / ``_combo_score_kernel`` (``:382-399``) with
  the group epilogue ``_group_argmax`` (``:251-270``);
* :func:`block_scores` and :func:`block_score_topk` —
  ``_block_score_kernel`` / ``_block_score_topk_kernel`` (``:203-248``);
* :func:`group_argmax` — the group epilogue alone, on scores in memory;
* :func:`combo_score_topk_partials`, :func:`block_score_topk_partials` and
  :func:`fold_group_triples` — the mesh paths' ``_group_argmax``: each
  data-axis block reduces the groups it holds to partial (max, argmax,
  second) triples, and one fold merges the blocks' triples;
* :func:`pair_scores` — ``_pair_score_kernel`` (``:402-417``);
* :func:`f64_rescores` — part 2's exact float64 re-scoring of a batch of
  candidates (``SubsetScorer.score_host``, ``:592-608``, which the JAX
  package runs on the host, one candidate at a time).

On a CUDA tensor each function launches its hand-written kernel in
``csrc/score_kernels.cu`` (or raises); on a CPU tensor it runs the plain
torch version beside it, which is also the oracle of the tests.  There is no
fallback from one to the other.  The argument checks run on both.

The kernels add their float32 terms in another order than the plain
versions: a sum of ``n`` non-negative terms then differs by at most
:func:`sum_bound`.  Given the scores, the group maxima, argmaxes (the lowest
index among ties) and second maxima are exact.  No kernel uses atomics, so
two launches on the same inputs give the same bits.  A kernel writes NaN
where its inputs break the layout (an id outside ``[0, Sp)``, an orientation
other than 0 or 1, sizes that overrun the table or the matrix).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as tnf

from hic_genome_assembler_tpu_torch.ops import oracle
from hic_genome_assembler_tpu_torch.utils import profiling

# Kernel launches made by the wrappers below (read by chip_smoke.py to show
# that the main path went through the kernels).
LAUNCHES = {
    "pair_profiles": 0, "combo_score_topk": 0, "block_score": 0, "pair_score": 0,
    "group_argmax": 0, "topk_fold": 0, "f64_rescore": 0,
}

# Candidates one block of the top-k kernels reduces (a group larger than
# this is split into tiles whose partial results a second pass merges).
TOPK_TILE = 4096
_COPIES = "part2/pageable_copies"
_SMEM_MAX = 227 * 1024     # shared memory a block may use on Hopper
# the profile kernel: (s, t) pairs of one wrapped diagonal a block, as many as
# PROFILE_SMEM bytes of diagonal sums hold (8 * L bytes a pair), 1 to
# PROFILE_MAX_PAIRS; its static shared memory stays under PROFILE_STATIC
PROFILE_SMEM = 48 * 1024
PROFILE_MAX_PAIRS = 8
PROFILE_STATIC = 2048
_MAX_GRID_Y = 65535
_PAIR_MAX_W = 6144         # one warp's slot tables (8 bytes a slot) in 48 KB
_BLOCK_MAX_S = 31          # a row's orientations as the bits of a uint32
# the block kernel: the halves split's largest S (its tables' shared memory),
# and its warps a block (the grid form gives each warp one order)
BLOCK_HALVES_MAX_S = 10
BLOCK_WARPS = 8


def sum_bound(n_terms, abs_sum):
    """How far two summation orders of ``n_terms`` float32 terms may give
    different results: ``2 * (n - 1) * 2**-24 * sum(|terms|)`` (each order
    is within ``(n - 1) * 2**-24`` of the exact sum, to first order)."""
    return 2.0 * np.maximum(np.asarray(n_terms, dtype=np.float64) - 1.0, 0.0) * 2.0**-24 * abs_sum


# ---------------------------------------------------------------------------
# Argument checks (both devices)
# ---------------------------------------------------------------------------


def _tensor(t, name: str, dtypes, dim: int, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, not {device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name} must be {' or '.join(map(str, dtypes))}, got {t.dtype}")
    if t.dim() != dim:
        raise ValueError(f"{name} must be {dim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


_FLOATS = (torch.float32, torch.float64)
_IDS = (torch.int32,)


def _check_table(F_flat: torch.Tensor, sizes: torch.Tensor, c0: torch.Tensor) -> int:
    """Checks the table ``F_flat`` [4*Sp*Sp*(C+1)], the padded sizes [Sp]
    and ``c0``; returns the table width C + 1.  Offsets and deltas are int32
    in the kernels and the flat index int64, so C + 1 must stay below
    2**31."""
    dev = F_flat.device
    _tensor(F_flat, "F_flat", _FLOATS, 1, dev)
    _tensor(sizes, "sizes", (torch.int64,), 1, dev)
    _tensor(c0, "c0", (F_flat.dtype,), 0, dev)
    rows = 4 * sizes.shape[0] ** 2
    if rows == 0 or F_flat.numel() % rows:
        raise ValueError(
            f"F_flat holds {F_flat.numel()} values, not a multiple of 4*Sp*Sp = {rows}"
        )
    Cp1 = F_flat.numel() // rows
    if not 1 <= Cp1 < 2**31:
        raise ValueError(f"table width C + 1 = {Cp1} is outside 1..2**31 - 1")
    return Cp1


def _topk_groups(n: int, k: int) -> int:
    if not 1 <= k <= _MAX_GRID_Y:
        raise ValueError(f"k = {k} groups is outside 1..{_MAX_GRID_Y}")
    if n < 1:
        raise ValueError("no candidates to select from")
    return -(-n // k)


def _on_cuda(values: torch.Tensor) -> bool:
    """True for a CUDA tensor of float32 values, False for a CPU tensor;
    raises for any other device and for float64 on CUDA."""
    if values.device.type == "cpu":
        return False
    if values.device.type != "cuda":
        raise ValueError(f"the scoring kernels run on cuda or cpu, not {values.device}")
    if values.dtype != torch.float32:
        raise ValueError(f"the scoring kernels take float32 on cuda, got {values.dtype}")
    return True


def _library():
    from hic_genome_assembler_tpu_torch.ops import _build

    return _build.library()


def _launch(name: str, dev: torch.device, fn, *args) -> None:
    """Call the C entry ``fn`` on ``dev``'s current stream, with ``dev`` as
    the current card (a ctypes launch goes to the current card), and count
    the launch under ``name``."""
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    LAUNCHES[name] += 1


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A plain version's index table on ``device``: a pageable copy from a
    card's host, counted in ``part2/pageable_copies``."""
    profiling.count_copy(_COPIES, device)
    return torch.from_numpy(a).to(device)


def _triu(S: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    pi, pj = np.triu_indices(S, k=1)
    return _upload(pi, device), _upload(pj, device)


def _orient_selector(orients: torch.Tensor, pi, pj, dtype) -> torch.Tensor:
    """The one-hot orientation selector [P*4, R]: row p*4 + e of column r
    is 1 where e = 2*orients[r, pi[p]] + orients[r, pj[p]]."""
    e = (orients[:, pi] * 2 + orients[:, pj]).long()                 # [R, P]
    hot = e.t()[:, None, :] == torch.arange(4, device=orients.device)[None, :, None]
    return hot.to(dtype).reshape(pi.shape[0] * 4, orients.shape[0])


# ---------------------------------------------------------------------------
# Pair profiles
# ---------------------------------------------------------------------------


def _skew_profile_chunk(
    m_pad: torch.Tensor,
    blk_idx: torch.Tensor,
    sizes_s: torch.Tensor,
    chunk_start: int,
    S: int,
    k: int,
) -> torch.Tensor:
    """Pair profiles for scaffold rows [chunk_start, chunk_start + k):
    h4 [k, S, 4, L].

    1. ``G[s, t, a, b] = M[offs_s + a, offs_t + b]``: a padded block view
       built with two index selects (``m_pad`` carries a zero guard
       row/col for the a >= c_s pad region).
    2. The four orientation profiles are (anti)diagonal sums of the G
       planes: e in {0,3} need ``Ddiff[v] = sum_{b-a+cmax-1=v}``, e in
       {1,2} need ``Dsum[u] = sum_{a+b=u}``.  Both come from one skew
       (pad each plane row by cmax, flat-reshape so row a lands shifted
       by a, reduce over a); Ddiff is the skew of the a-reversed plane.
    3. Per-(s, t) shifts/flips place each (e, m) entry from the stacked
       [Dsum, Ddiff] profiles (guard slot L = zero):

        e=0 (+,+): m = (b - a) + shift          -> Ddiff[m]
        e=1 (+,-): m = (ct-1 - (a+b)) + shift   -> Dsum[ct-1+shift-m]
        e=2 (-,+): m = (a+b) - cs + 1 + shift   -> Dsum[m+cs-1-shift]
        e=3 (-,-): m = (ct-cs) - (b-a) + shift  -> Ddiff[(ct-cs)+2*shift-m]
    """
    dev = m_pad.device
    c = blk_idx.shape[1]
    L = 2 * c - 1
    shift = c - 1
    rows = blk_idx[chunk_start : chunk_start + k]
    G = m_pad.index_select(0, rows.reshape(-1)).index_select(1, blk_idx.reshape(-1))
    G = G.reshape(k, c, S, c).permute(0, 2, 1, 3)          # [k, S, c, c]

    def antidiag(planes):
        # out[..., u] = sum_a planes[..., a, u - a]
        padded = tnf.pad(planes, (0, c))
        flat = padded.reshape(k, S, c * 2 * c)[..., : c * L]
        return flat.reshape(k, S, c, L).sum(dim=2)

    Dsum = antidiag(G)
    Ddiff = antidiag(G.flip(2))
    prof = tnf.pad(torch.stack([Dsum, Ddiff], dim=2), (0, 1))  # [k, S, 2, L+1]
    m = torch.arange(L, device=dev)
    cs = sizes_s[chunk_start : chunk_start + k][:, None, None]
    ct = sizes_s[None, :, None]                            # [1, S, 1]
    shape = (k, S, L)
    pos = torch.stack(
        [
            m.expand(shape),                                   # e=0 -> Ddiff
            (ct - 1 + shift - m).expand(shape),                # e=1 -> Dsum
            (m + cs - 1 - shift).expand(shape),                # e=2 -> Dsum
            ((ct - cs) + 2 * shift - m).expand(shape),         # e=3 -> Ddiff
        ],
        dim=2,
    )                                                      # [k, S, 4, L]
    pos = torch.where((pos >= 0) & (pos < L), pos, L)
    which = _upload(np.array([1, 0, 0, 1]), dev)[None, None, :, None]
    flat_prof = prof.reshape(k, S, 1, 2 * (L + 1)).expand(k, S, 4, 2 * (L + 1))
    h4 = torch.gather(flat_prof, 3, which * (L + 1) + pos)
    s_ids = chunk_start + torch.arange(k, device=dev)
    eye = s_ids[:, None] == torch.arange(S, device=dev)[None, :]
    return torch.where(eye[:, :, None, None], 0.0, h4)


def _build_pair_profiles(
    sub: torch.Tensor,
    sid: torch.Tensor,
    loc: torch.Tensor,
    sizes: torch.Tensor,
    Sp: int,
    L: int,
    cmax: int,
) -> torch.Tensor:
    """Pair profiles by one scatter-add per orientation (``index_add_``):
    h[row, m] accumulates every cross-scaffold entry at its
    orientation-specific offset, row = (s * Sp + t) * 4 + e.  Used when a
    chromosome's largest scaffold makes the skew chunk exceed its budget."""
    s, t = sid[:, None], sid[None, :]
    a, b = loc[:, None], loc[None, :]
    cs, ct = sizes[sid][:, None], sizes[sid][None, :]
    base = (s * Sp + t) * 4
    shift = cmax - 1
    vals = torch.where(s != t, sub, 0.0).reshape(-1)
    nrows = 4 * Sp * Sp
    h = torch.zeros(nrows * L, dtype=sub.dtype, device=sub.device)
    for e, mm in enumerate(
        (
            (b - a) + shift,                 # e=0: (+,+)
            (ct - 1 - (a + b)) + shift,      # e=1: (+,-)
            ((a + b) - cs + 1) + shift,      # e=2: (-,+)
            ((ct - cs) - (b - a)) + shift,   # e=3: (-,-)
        )
    ):
        idx = ((base + e) * L + mm.clamp(0, L - 1)).reshape(-1)
        h.index_add_(0, idx, vals)
    return h.reshape(nrows, L)


# the plain skew build's transient G budget per chunk: k * cmax * Sp * cmax
# floats <= 64M (256MB)
SKEW_CHUNK_ELEMS = 64 * 1024 * 1024


def pair_profiles_plain(
    sub: torch.Tensor, sizes: torch.Tensor, cmax: int, chunk_elems: int | None = None
) -> torch.Tensor:
    """Plain torch version of :func:`pair_profiles`: the skew build in
    chunks of scaffold rows whose transient ``G`` holds at most
    ``chunk_elems`` values (default :data:`SKEW_CHUNK_ELEMS`), or the
    scatter-add build where one row alone exceeds that (``chunk_elems = 1``
    always takes it)."""
    if chunk_elems is None:
        chunk_elems = SKEW_CHUNK_ELEMS
    dev = sub.device
    Sp, L, C = sizes.shape[0], 2 * cmax - 1, sub.shape[0]
    profiling.count_copy(_COPIES, sizes.device)
    sizes_h = sizes.cpu().numpy()
    offsets = np.concatenate([[0], np.cumsum(sizes_h)[:-1]])
    k = chunk_elems // max(cmax * Sp * cmax, 1)
    if k < 1:
        sid = _upload(np.repeat(np.arange(Sp), sizes_h), dev)
        loc = _upload(
            np.concatenate([np.arange(c) for c in sizes_h] + [np.zeros(0, np.int64)]), dev
        )
        return _build_pair_profiles(sub, sid, loc, sizes, Sp, L, cmax)
    k = min(k, Sp)
    m_pad = tnf.pad(sub, (0, 1, 0, 1))                     # zero guard row/col at C
    blk_idx = np.full((Sp, cmax), C, dtype=np.int64)
    for s, (o, c) in enumerate(zip(offsets, sizes_h)):
        blk_idx[s, :c] = np.arange(o, o + c)
    blk_d = _upload(blk_idx, dev)
    starts = list(range(0, Sp - Sp % k, k))
    chunks = [_skew_profile_chunk(m_pad, blk_d, sizes, s0, Sp, k) for s0 in starts]
    if Sp % k:
        chunks.append(_skew_profile_chunk(m_pad, blk_d, sizes, Sp - Sp % k, Sp, Sp % k))
    h4 = chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)
    return h4.reshape(Sp * Sp * 4, L)


def profile_pairs_per_block(cmax: int) -> int:
    """The (s, t) pairs one block of the profile kernel owns: as many as
    :data:`PROFILE_SMEM` bytes of their diagonal sums (2 * L floats a pair)
    hold, 1 to :data:`PROFILE_MAX_PAIRS`."""
    return max(1, min(PROFILE_MAX_PAIRS, PROFILE_SMEM // (8 * (2 * cmax - 1))))


def _check_profiles(sub, sizes, cmax: int) -> int:
    dev = sub.device
    _tensor(sub, "sub", _FLOATS, 2, dev)
    _tensor(sizes, "sizes", (torch.int64,), 1, dev)
    if sub.shape[0] != sub.shape[1] or not 1 <= sub.shape[0] < 2**31:
        raise ValueError(f"sub must be a square matrix, got {tuple(sub.shape)}")
    if not 1 <= cmax < 2**15 or sizes.shape[0] < 1:
        raise ValueError(f"cmax = {cmax} or Sp = {sizes.shape[0]} is out of range")
    L = 2 * cmax - 1
    if 8 * L > _SMEM_MAX - PROFILE_STATIC:
        raise ValueError(f"cmax = {cmax} is too wide for the profile kernel's shared memory")
    return L


def pair_profiles(sub: torch.Tensor, sizes: torch.Tensor, cmax: int) -> torch.Tensor:
    """Pair profiles ``h [4*Sp*Sp, L]`` (``L = 2*cmax - 1``) of the
    chromosome matrix ``sub [C, C]`` in the canonical layout, whose
    scaffold s holds ``sizes[s]`` bins (``sizes`` is int64 [Sp], zero for
    pad slots): row ``(s*Sp + t)*4 + e`` holds orientation e's diagonal
    sums of the ``c_s x c_t`` block, zero for s = t and pad slots."""
    L = _check_profiles(sub, sizes, cmax)
    if not _on_cuda(sub):
        return pair_profiles_plain(sub, sizes, cmax)
    Sp = sizes.shape[0]
    h = torch.empty((4 * Sp * Sp, L), dtype=torch.float32, device=sub.device)
    lib = _library()
    _launch("pair_profiles", sub.device, lib.pair_profiles,
            sub.data_ptr(), sub.shape[0], sizes.data_ptr(), Sp, cmax,
            profile_pairs_per_block(cmax), h.data_ptr())
    return h


# ---------------------------------------------------------------------------
# Group top-k epilogue
# ---------------------------------------------------------------------------


def _group_argmax(flat: torch.Tensor, k: int):
    """Per-group (max, argmax, second-max) over k contiguous groups.

    The global maximum is always returned (it is its own group's max),
    exact ties in other groups are returned, and within a group the
    lowest index wins.  The second-max vector is the escalation witness:
    every candidate dropped inside group g scores < second[g], so
    ``max(second)`` bounds every dropped candidate's fast score."""
    n = flat.shape[0]
    pad = (-n) % k
    if pad:
        flat = torch.cat([flat, flat.new_full((pad,), float("-inf"))])
    groups = flat.reshape(k, -1)
    local = torch.argmax(groups, dim=1)                  # first max on ties
    vals = groups.gather(1, local[:, None])[:, 0]
    idx = torch.arange(k, device=flat.device) * groups.shape[1] + local
    winner_mask = torch.arange(groups.shape[1], device=flat.device)[None, :] == local[:, None]
    second = torch.where(winner_mask, float("-inf"), groups).max(dim=1).values
    return vals, idx, second


def _topk_outputs(k: int, G: int, dev: torch.device, span: int | None = None, out=None):
    """The three outputs (``out`` where given) and the tile scratch of a
    group top-k launch whose groups of ``G`` candidates it holds ``span`` of
    (default all): ``ceil(min(G, span) / TOPK_TILE)`` tiles a group, as the
    kernels count them."""
    tiles = -(-min(G, G if span is None else span) // TOPK_TILE)
    if out is None:
        out = _empty_triple(k, dev)
    parts = torch.empty((k * tiles if tiles > 1 else 1, 2), dtype=torch.int64, device=dev)
    return (*out, parts)


def _empty_triple(k: int, dev: torch.device):
    """Uninitialised float32 ``(vals, idx, second)`` [k] on ``dev``."""
    return (torch.empty(k, dtype=torch.float32, device=dev),
            torch.empty(k, dtype=torch.int64, device=dev),
            torch.empty(k, dtype=torch.float32, device=dev))


def group_argmax(flat: torch.Tensor, k: int):
    """``(vals [k], idx [k] int64, second [k])`` of :func:`_group_argmax` over
    the 1-D scores ``flat`` (the group epilogue of the top-k kernels, on
    scores that are in memory; the mesh paths fold partial triples instead,
    :func:`fold_group_triples`)."""
    _tensor(flat, "flat", _FLOATS, 1, flat.device)
    G = _topk_groups(flat.shape[0], k)
    if not _on_cuda(flat):
        return _group_argmax(flat, k)
    vals, idx, second, parts = _topk_outputs(k, G, flat.device)
    lib = _library()
    _launch("group_argmax", flat.device, lib.group_topk, flat.data_ptr(), flat.shape[0], k,
            TOPK_TILE, parts.data_ptr(), vals.data_ptr(), idx.data_ptr(), second.data_ptr())
    return vals, idx, second


# ---------------------------------------------------------------------------
# The group top-k on a mesh: partial triples a block, one fold
# ---------------------------------------------------------------------------
#
# A batch of ``n_glob`` candidates in k groups of G = ceil(n_glob / k) (the
# last padded with -inf) is split over D data-axis blocks, block i holding
# candidates [n0, n0 + n) on its own device.  Each block reduces every group
# to the (max, argmax, second) triple of the candidates it holds (the empty
# triple (-inf, -inf, INT64_MAX) where it holds none; the block that ends the
# batch also holds the padding), and :func:`fold_group_triples` merges the D
# blocks' triples, stacked [D, k], into :func:`_group_argmax`'s result over
# the whole batch: the triple merge is exact, commutative and associative.

EMPTY_INDEX = torch.iinfo(torch.int64).max  # the argmax of the empty triple


def empty_triples(D: int, k: int, dtype, device):
    """Uninitialised ``(vals, idx, second)`` arrays [D, k] for D blocks'
    triples: row i is block i's ``out`` in the partials wrappers."""
    return (torch.empty((D, k), dtype=dtype, device=device),
            torch.empty((D, k), dtype=torch.int64, device=device),
            torch.empty((D, k), dtype=dtype, device=device))


def _partial_span(n: int, k: int, n0: int, n_glob: int) -> Tuple[int, int]:
    """Checks a block of ``n`` candidates at ``n0`` in a batch of
    ``n_glob`` in ``k`` groups; returns ``(G, span)``: the group size and
    the candidates the block's span holds (its own, and for the block that
    ends the batch the last group's padding too)."""
    G = _topk_groups(n_glob, k)
    if n < 1 or n0 < 0 or n0 + n > n_glob:
        raise ValueError(f"candidates [{n0}, {n0 + n}) lie outside the batch's {n_glob}")
    return G, (n if n0 + n < n_glob else k * G - n0)


def _group_partials(flat: torch.Tensor, k: int, n0: int, n_glob: int):
    """Plain torch partial triples ``(vals [k], idx [k], second [k])`` of the
    scores ``flat`` of candidates [n0, n0 + len) in a batch of ``n_glob`` in
    k groups: over each group's candidates in the block, as
    :func:`_group_argmax` gives them (NaN is the maximum, the lowest index
    wins a tie), and the empty triple for a group the block does not hold."""
    n = flat.shape[0]
    G, span = _partial_span(n, k, n0, n_glob)
    dev, neg = flat.device, float("-inf")
    vals, second = (flat.new_full((k,), neg) for _ in range(2))
    idx = torch.full((k,), EMPTY_INDEX, dtype=torch.int64, device=dev)
    g0, g1 = n0 // G, (n0 + span - 1) // G + 1        # the groups the block touches
    first = n0 - g0 * G
    x = flat.new_full(((g1 - g0) * G,), neg)
    x[first:first + n] = flat
    held = torch.zeros((g1 - g0) * G, dtype=torch.bool, device=dev)
    held[first:first + span] = True                   # its candidates and the padding
    x, held = x.reshape(-1, G), held.reshape(-1, G)
    top = torch.where(held, x, neg).amax(dim=1)       # NaN where a held score is NaN
    hit = held & ((x == top[:, None]) | (torch.isnan(x) & torch.isnan(top)[:, None]))
    local = torch.argmax(hit.to(torch.uint8), dim=1)  # the first hit
    winner = torch.arange(G, device=dev)[None, :] == local[:, None]
    vals[g0:g1] = x.gather(1, local[:, None])[:, 0]
    idx[g0:g1] = torch.arange(g0, g1, device=dev) * G + local
    second[g0:g1] = torch.where(held & ~winner, x, neg).amax(dim=1)
    return vals, idx, second


def fold_group_triples_plain(vals, idx, second):
    """Plain torch version of :func:`fold_group_triples`."""
    top = vals.amax(dim=0)                            # NaN where a block's max is NaN
    hit = (vals == top) | (torch.isnan(vals) & torch.isnan(top))
    win = torch.where(hit, idx, EMPTY_INDEX).amin(dim=0)
    # the winning block: the first of the hits with the lowest index (several
    # only where every triple is empty)
    w = torch.argmax((hit & (idx == win)).to(torch.uint8), dim=0)
    rows = torch.arange(vals.shape[0], device=vals.device)[:, None]
    folded_second = torch.where(rows == w, second, vals).amax(dim=0)
    return vals.gather(0, w[None, :])[0], win, folded_second


def _check_triples(vals, idx, second) -> Tuple[int, int]:
    """Checks D blocks' triples [D, k]; returns (D, k)."""
    dev = vals.device
    _tensor(vals, "vals", _FLOATS, 2, dev)
    _tensor(idx, "idx", (torch.int64,), 2, dev)
    _tensor(second, "second", (vals.dtype,), 2, dev)
    if idx.shape != vals.shape or second.shape != vals.shape or vals.numel() == 0:
        raise ValueError(f"triples of shapes {tuple(vals.shape)}, {tuple(idx.shape)} and "
                         f"{tuple(second.shape)} are not one [D, k]")
    D, k = vals.shape
    if k > 2**31 // D:
        raise ValueError(f"{D} x {k} triples is out of range")
    return D, k


def fold_group_triples(vals, idx, second):
    """The merge of D mesh blocks' partial triples, each [D, k] (row i block
    i's, as the partials wrappers write them): ``(vals [k], idx [k],
    second [k])``, :func:`_group_argmax` over the whole batch."""
    D, k = _check_triples(vals, idx, second)
    if not _on_cuda(vals):
        return fold_group_triples_plain(vals, idx, second)
    out = _empty_triple(k, vals.device)
    lib = _library()
    _launch("topk_fold", vals.device, lib.topk_fold, vals.data_ptr(), idx.data_ptr(),
            second.data_ptr(), D, k, *(t.data_ptr() for t in out))
    return out


def _partials_out(out, k: int, scores_like: torch.Tensor):
    """Checks the ``out`` triple [k] of a partials wrapper (``None``: none)."""
    if out is None:
        return None
    vals, idx, second = out
    dev, dtype = scores_like.device, scores_like.dtype
    _tensor(vals, "out vals", (dtype,), 1, dev)
    _tensor(idx, "out idx", (torch.int64,), 1, dev)
    _tensor(second, "out second", (dtype,), 1, dev)
    if not vals.shape == idx.shape == second.shape == (k,):
        raise ValueError(f"out must be three [{k}] tensors")
    return out


def _copied(got, out):
    """``got`` copied into ``out`` where given (the plain partials)."""
    if out is None:
        return got
    for dst, src in zip(out, got):
        dst.copy_(src)
    return out


# ---------------------------------------------------------------------------
# Combo-factorized brute-force scores
# ---------------------------------------------------------------------------


def _combo_score_kernel(F_flat, idx4, cid, E, c0):
    """V4 = F[idx4] [n_combo, 4], vals = V4[cid] [Bo, P, 4], and one
    matmul folds the 4 orientation variants against the per-position
    orientation selector E [P, 4, R]."""
    V4 = F_flat[idx4]
    vals = V4[cid]
    Bo, P, _ = vals.shape
    return vals.reshape(Bo, P * 4) @ E.reshape(P * 4, -1) + c0


def combo_scores_plain(F_flat, idx4, cid, orients, c0) -> torch.Tensor:
    """Plain torch version of :func:`combo_scores`: [Bo, R]."""
    pi, pj = _triu(orients.shape[1], F_flat.device)
    E = _orient_selector(orients, pi, pj, F_flat.dtype)
    return _combo_score_kernel(F_flat, idx4, cid, E, c0)


def combo_score_topk_plain(F_flat, idx4, cid, orients, c0, k: int):
    """Plain torch version of :func:`combo_score_topk`."""
    return _group_argmax(combo_scores_plain(F_flat, idx4, cid, orients, c0).reshape(-1), k)


def _check_combo(F_flat, idx4, cid, orients, c0) -> int:
    dev = F_flat.device
    _tensor(F_flat, "F_flat", _FLOATS, 1, dev)
    _tensor(c0, "c0", (F_flat.dtype,), 0, dev)
    _tensor(idx4, "idx4", (torch.int64,), 2, dev)
    _tensor(cid, "cid", _IDS, 2, dev)
    _tensor(orients, "orients", _IDS, 2, dev)
    S = orients.shape[1]
    if idx4.shape[1] != 4 or not 1 <= idx4.shape[0] < 2**31:
        raise ValueError(f"idx4 must be [n_combo, 4], got {tuple(idx4.shape)}")
    if not 2 <= S <= 31 or cid.shape[1] != S * (S - 1) // 2:
        raise ValueError(f"cid {tuple(cid.shape)} does not match S = {S} positions")
    n = cid.shape[0] * orients.shape[0]
    if not 1 <= n < 2**62:
        raise ValueError(f"{n} candidates is out of range")
    return n


def _combo_launch(F_flat, idx4, cid, orients, c0, k: int, costs=None, topk=None, n0: int = 0,
                  n_glob: int | None = None) -> None:
    """One ``combo_score_topk`` launch: the scores into ``costs`` (k = 0),
    or the top-k outputs ``(vals, idx, second, parts)`` of candidates
    [n0, n0 + Bo * R) of a batch of ``n_glob`` (default: this one)."""
    vals, idx, second, parts = (None,) * 4 if topk is None else topk
    ptrs = [None if t is None else t.data_ptr() for t in (parts, costs, vals, idx, second)]
    n = cid.shape[0] * orients.shape[0]
    lib = _library()
    _launch("combo_score_topk", F_flat.device, lib.combo_score_topk,
            F_flat.data_ptr(), F_flat.numel(), idx4.data_ptr(), idx4.shape[0], cid.data_ptr(),
            cid.shape[0], orients.data_ptr(), orients.shape[0], orients.shape[1],
            c0.data_ptr(), k, n0, n if n_glob is None else n_glob, TOPK_TILE, *ptrs)


def combo_scores(F_flat, idx4, cid, orients, c0) -> torch.Tensor:
    """Scores [Bo, R] of every (order b, orientation r) of an enumeration
    batch through the combo factorization: ``cost[b, r] = sum_p V4[cid[b,
    p], e(r, p)] + c0`` with ``V4 = F_flat[idx4]`` and ``e(r, p) =
    2*orients[r, pi] + orients[r, pj]`` (``(pi, pj)`` the p-th position
    pair i < j).  ``cid`` int32 [Bo, P], ``orients`` int32 [R, S], ``idx4``
    int64 [n_combo, 4], ``c0`` a 0-d tensor."""
    _check_combo(F_flat, idx4, cid, orients, c0)
    if not _on_cuda(F_flat):
        return combo_scores_plain(F_flat, idx4, cid, orients, c0)
    costs = torch.empty((cid.shape[0], orients.shape[0]), dtype=torch.float32,
                        device=F_flat.device)
    _combo_launch(F_flat, idx4, cid, orients, c0, 0, costs=costs)
    return costs


def combo_score_topk(F_flat, idx4, cid, orients, c0, k: int):
    """:func:`group_argmax` of :func:`combo_scores` in k groups, fused: the
    scores never reach device memory.  Returns ``(vals, idx, second)``."""
    n = _check_combo(F_flat, idx4, cid, orients, c0)
    G = _topk_groups(n, k)
    if not _on_cuda(F_flat):
        return combo_score_topk_plain(F_flat, idx4, cid, orients, c0, k)
    topk = _topk_outputs(k, G, F_flat.device)
    _combo_launch(F_flat, idx4, cid, orients, c0, k, topk=topk)
    return topk[:3]


def combo_score_topk_partials_plain(F_flat, idx4, cid, orients, c0, k: int, n0: int,
                                    n_glob: int):
    """Plain torch version of :func:`combo_score_topk_partials`."""
    scores = combo_scores_plain(F_flat, idx4, cid, orients, c0).reshape(-1)
    return _group_partials(scores, k, n0, n_glob)


def combo_score_topk_partials(F_flat, idx4, cid, orients, c0, k: int, n0: int, n_glob: int,
                              out=None):
    """One mesh block's part of :func:`combo_score_topk`: its candidates are
    [n0, n0 + Bo * R) of a batch of ``n_glob`` in ``k`` groups, and it
    returns every group's partial triple ``(vals [k], idx [k], second [k])``
    over them (global indices; see :func:`fold_group_triples`), written
    into ``out`` where given.  No score reaches device memory."""
    n = _check_combo(F_flat, idx4, cid, orients, c0)
    G, span = _partial_span(n, k, n0, n_glob)
    out = _partials_out(out, k, F_flat)
    if not _on_cuda(F_flat):
        return _copied(combo_score_topk_partials_plain(F_flat, idx4, cid, orients, c0, k, n0,
                                                       n_glob), out)
    topk = _topk_outputs(k, G, F_flat.device, span, out)
    _combo_launch(F_flat, idx4, cid, orients, c0, k, topk=topk, n0=n0, n_glob=n_glob)
    return topk[:3] if out is None else out


# ---------------------------------------------------------------------------
# Block (order x orientation grid) scores
# ---------------------------------------------------------------------------


def _block_indices(sizes, orders, pi, pj, Cp1: int) -> torch.Tensor:
    """The flat table indices [Bo, P*4] of each order's P*4 values: its
    pairs' four orientation cells at the pairs' offset differences."""
    Sp = sizes.shape[0]  # id-space stride of the F table (incl. pad slots)
    sz = sizes[orders]
    offs = torch.cumsum(sz, dim=1) - sz
    s_i, s_j = orders[:, pi], orders[:, pj]              # [Bo, P]
    delta = offs[:, pj] - offs[:, pi]                    # [Bo, P]
    pair_base = (s_i * Sp + s_j) * 4                     # [Bo, P]
    idx = (pair_base[:, :, None] + torch.arange(4, device=orders.device)) * Cp1 \
        + delta[:, :, None]                              # [Bo, P, 4]
    return idx.reshape(orders.shape[0], pi.shape[0] * 4)


def _block_score_kernel(F_flat, sizes, orders, e_onehot, pi, pj, c0, Cp1: int):
    """Scores all R orientation combos of each order: P*4 gathers per order
    and one matmul with the one-hot orientation selector [P*4, R]."""
    return F_flat[_block_indices(sizes, orders, pi, pj, Cp1)] @ e_onehot + c0


def block_scores_plain(F_flat, sizes, orders, orients, c0) -> torch.Tensor:
    """Plain torch version of :func:`block_scores`: [Bo, R]."""
    Cp1 = _check_table(F_flat, sizes, c0)
    pi, pj = _triu(orders.shape[1], F_flat.device)
    E = _orient_selector(orients, pi, pj, F_flat.dtype)
    return _block_score_kernel(F_flat, sizes, orders.long(), E, pi, pj, c0, Cp1)


def block_score_topk_plain(F_flat, sizes, orders, orients, c0, k: int):
    """Plain torch version of :func:`block_score_topk`."""
    return _group_argmax(block_scores_plain(F_flat, sizes, orders, orients, c0).reshape(-1), k)


def _check_block(F_flat, sizes, orders, orients, c0) -> Tuple[int, int]:
    """Checks the block wrappers' arguments; returns (C + 1, candidates)."""
    Cp1 = _check_table(F_flat, sizes, c0)
    dev = F_flat.device
    _tensor(orders, "orders", _IDS, 2, dev)
    _tensor(orients, "orients", _IDS, 2, dev)
    S, R = orders.shape[1], orients.shape[0]
    if orients.shape[1] != S or not 1 <= S <= _BLOCK_MAX_S or R < 1:
        raise ValueError(f"orders {tuple(orders.shape)} and orients {tuple(orients.shape)} need "
                         f"the same 1..{_BLOCK_MAX_S} positions")
    n = orders.shape[0] * R
    if not 1 <= orders.shape[0] < 2**31 or n >= 2**62:
        raise ValueError(f"{orders.shape[0]} orders x {R} orientations is out of range")
    return Cp1, n


def block_adds(S: int, R: int) -> Tuple[int, int]:
    """(adds an order, adds a candidate) of the block kernel's sums at S
    positions and R orientation rows: the halves tables' adds and ``b + 1``
    (``b = S - S // 2``) where :func:`block_halves` picks them, else 0 and
    the P + 1 direct adds."""
    if not block_halves(S, R):
        return 0, S * (S - 1) // 2 + 1
    return _halves_build(S), S - S // 2 + 1


def _halves_build(S: int) -> int:
    """The adds of one order's halves tables: TB (the pairs inside B) and
    the X_j (the pairs (i in A, j), and in X_a those inside A)."""
    a, b = S // 2, S - S // 2
    return (2**b * b * (b - 1) + 2 ** (a + 1) * a * (a - 1)) // 2 + b * 2 ** (a + 1) * a


def block_halves(S: int, R: int) -> bool:
    """Whether the block kernel sums through the halves tables (csrc note):
    for 2 <= S <= ``BLOCK_HALVES_MAX_S``, where the adds the R rows save,
    ``R * (P - b)``, exceed the tables' adds."""
    if not 2 <= S <= BLOCK_HALVES_MAX_S:
        return False
    return R * (S * (S - 1) // 2 - (S - S // 2)) > _halves_build(S)


def _block_launch(Cp1: int, F_flat, sizes, orders, orients, c0, k: int, tile: int, costs=None,
                  topk=None, n0: int = 0, n_glob: int | None = None) -> None:
    """One ``block_score`` launch on a table of width ``Cp1``: the scores
    into ``costs`` (k = 0), or the top-k outputs ``(vals, idx, second,
    parts)`` of candidates [n0, n0 + Bo * R) of a batch of ``n_glob``
    (default: this one)."""
    vals, idx, second, parts = (None,) * 4 if topk is None else topk
    ptrs = [None if t is None else t.data_ptr() for t in (parts, costs, vals, idx, second)]
    Bo, S = orders.shape
    R = orients.shape[0]
    lib = _library()
    _launch("block_score", F_flat.device, lib.block_score,
            F_flat.data_ptr(), Cp1, sizes.data_ptr(), sizes.shape[0], orders.data_ptr(), Bo, S,
            orients.data_ptr(), R, int(block_halves(S, R)), c0.data_ptr(), k, n0,
            Bo * R if n_glob is None else n_glob, tile, *ptrs)


def block_scores(F_flat, sizes, orders, orients, c0) -> torch.Tensor:
    """Scores [Bo, R] of every (order, orientation) pair: per order the
    offsets from the sizes prefix, ``P*4`` gathers of ``F_flat``, then for
    each orientation row the sum of its P selected values plus ``c0``.
    ``orders`` int32 [Bo, S] (ids may repeat), ``orients`` int32 [R, S]."""
    Cp1, _n = _check_block(F_flat, sizes, orders, orients, c0)
    if not _on_cuda(F_flat):
        return block_scores_plain(F_flat, sizes, orders, orients, c0)
    Bo, R = orders.shape[0], orients.shape[0]
    costs = torch.empty((Bo, R), dtype=torch.float32, device=F_flat.device)
    _block_launch(Cp1, F_flat, sizes, orders, orients, c0, 0, BLOCK_WARPS * R, costs=costs)
    return costs


def block_score_topk(F_flat, sizes, orders, orients, c0, k: int):
    """:func:`group_argmax` of :func:`block_scores` in k groups, fused: the
    scores never reach device memory.  Returns ``(vals, idx, second)``."""
    Cp1, n = _check_block(F_flat, sizes, orders, orients, c0)
    G = _topk_groups(n, k)
    if not _on_cuda(F_flat):
        return block_score_topk_plain(F_flat, sizes, orders, orients, c0, k)
    topk = _topk_outputs(k, G, F_flat.device)
    _block_launch(Cp1, F_flat, sizes, orders, orients, c0, k, TOPK_TILE, topk=topk)
    return topk[:3]


def block_score_topk_partials_plain(F_flat, sizes, orders, orients, c0, k: int, n0: int,
                                    n_glob: int):
    """Plain torch version of :func:`block_score_topk_partials`."""
    scores = block_scores_plain(F_flat, sizes, orders, orients, c0).reshape(-1)
    return _group_partials(scores, k, n0, n_glob)


def block_score_topk_partials(F_flat, sizes, orders, orients, c0, k: int, n0: int, n_glob: int,
                              out=None):
    """One mesh block's part of :func:`block_score_topk`, as
    :func:`combo_score_topk_partials` is of :func:`combo_score_topk`."""
    Cp1, n = _check_block(F_flat, sizes, orders, orients, c0)
    G, span = _partial_span(n, k, n0, n_glob)
    out = _partials_out(out, k, F_flat)
    if not _on_cuda(F_flat):
        return _copied(block_score_topk_partials_plain(F_flat, sizes, orders, orients, c0, k, n0,
                                                       n_glob), out)
    topk = _topk_outputs(k, G, F_flat.device, span, out)
    _block_launch(Cp1, F_flat, sizes, orders, orients, c0, k, TOPK_TILE, topk=topk, n0=n0,
                  n_glob=n_glob)
    return topk[:3] if out is None else out


# ---------------------------------------------------------------------------
# Per-candidate pair scores
# ---------------------------------------------------------------------------


def _pair_score_kernel(F_flat, sizes, orders, orients, pi, pj, c0, Cp1: int):
    """Per-candidate (order, orientation) scores: orders and orients are
    both [B, W].  Pad slots (id with size 0) contribute zero rows of F and
    zero size."""
    Sp = sizes.shape[0]
    sz = sizes[orders]
    offs = torch.cumsum(sz, dim=1) - sz
    s_i, s_j = orders[:, pi], orders[:, pj]              # [B, P]
    e = orients[:, pi] * 2 + orients[:, pj]              # [B, P]
    delta = offs[:, pj] - offs[:, pi]
    idx = ((s_i * Sp + s_j) * 4 + e) * Cp1 + delta
    return F_flat[idx].sum(dim=1) + c0


def pair_scores_plain(F_flat, sizes, cand, c0) -> torch.Tensor:
    """Plain torch version of :func:`pair_scores`: [B]."""
    Cp1 = _check_table(F_flat, sizes, c0)
    W = cand.shape[1] // 2
    pi, pj = _triu(W, F_flat.device)
    orders, orients = cand[:, :W].long(), cand[:, W:].long()
    return _pair_score_kernel(F_flat, sizes, orders, orients, pi, pj, c0, Cp1)


def _check_pairs(F_flat, sizes, cand, c0) -> int:
    Cp1 = _check_table(F_flat, sizes, c0)
    _tensor(cand, "cand", _IDS, 2, F_flat.device)
    if cand.shape[1] % 2 or not 1 <= cand.shape[1] // 2 <= _PAIR_MAX_W:
        raise ValueError(f"cand must be [B, 2*W] (orders then orients, 1 <= W <= "
                         f"{_PAIR_MAX_W}), got {tuple(cand.shape)}")
    if cand.shape[0] >= 2**31:
        raise ValueError(f"{cand.shape[0]} candidates is out of range")
    return Cp1


def pair_scores(F_flat, sizes, cand, c0) -> torch.Tensor:
    """Scores [B] of per-candidate (order, orientation) rows: ``cand`` is
    int32 [B, 2*W], each row's W ids then its W orientation flags; score =
    ``sum_{i<j} F_flat[((s_i*Sp + s_j)*4 + e_ij)*(C+1) + offs_j - offs_i] +
    c0``.  Pad ids (size 0) fill unused slots; their table rows are zero in
    every table built from pair profiles, and the kernel skips their pairs."""
    Cp1 = _check_pairs(F_flat, sizes, cand, c0)
    if not _on_cuda(F_flat):
        return pair_scores_plain(F_flat, sizes, cand, c0)
    B = cand.shape[0]
    out = torch.empty(B, dtype=torch.float32, device=F_flat.device)
    if B == 0:
        return out
    lib = _library()
    _launch("pair_score", F_flat.device, lib.pair_score,
            F_flat.data_ptr(), Cp1, sizes.data_ptr(), sizes.shape[0], cand.data_ptr(), B,
            cand.shape[1] // 2, c0.data_ptr(), out.data_ptr())
    return out


# ---------------------------------------------------------------------------
# Exact float64 re-scoring
# ---------------------------------------------------------------------------

_RESCORE = "part2/f64_rescore_"


def trace_chunk() -> int:
    """The chunk in which numpy's reduction, and so ``np.trace``, takes a
    strided diagonal: its buffer size.  Each chunk is summed pairwise and
    the chunks' sums are added in order."""
    chunk = int(np.getbufsize())
    if chunk < 8 or chunk % 8:
        raise ValueError(f"numpy's buffer of {chunk} elements is not a multiple of 8")
    return chunk


def f64_rescores_plain(M, bin_orders, total: float) -> torch.Tensor:
    """Plain version of :func:`f64_rescores`, on the host: each bin order's
    gather of ``M`` (``np.ix_``) scored by ``oracle.cost_function``."""
    m = M.numpy()
    return torch.tensor([oracle.cost_function(m[np.ix_(bo, bo)], total)
                         for bo in bin_orders.numpy()], dtype=torch.float64)


def f64_rescores(M, bin_orders, total: float) -> torch.Tensor:
    """Exact float64 costs [B] of candidates given as bin orders:
    ``bin_orders`` int32 [B, K], each row K distinct rows of the group's
    float64 matrix ``M`` [C, C], and each cost
    ``oracle.cost_function(M[np.ix_(bo, bo)], total)`` bit for bit.  On a
    CUDA tensor ``csrc/f64_rescore.cu`` reads ``M`` through each bin order,
    one launch for up to 65,535 candidates (or raises); on a CPU tensor the
    plain version.  Counts the candidates, their bins (``K`` each), their
    matrix elements (``K(K - 1)/2`` each) and the launches under
    ``part2/f64_rescore_*``, and under ``..._launch_elements`` the elements
    each launch reads at least: one candidate's ``K(K - 1)/2``, all distinct,
    since every candidate of a launch reads the same matrix."""
    dev = M.device
    _tensor(M, "M", (torch.float64,), 2, dev)
    _tensor(bin_orders, "bin_orders", _IDS, 2, dev)
    B, K = bin_orders.shape
    if M.shape[0] != M.shape[1] or K > M.shape[0]:
        raise ValueError(f"{K} bins a candidate over a matrix of shape {tuple(M.shape)}")
    profiling.count(_RESCORE + "candidates", B)
    profiling.count(_RESCORE + "bins", B * K)
    profiling.count(_RESCORE + "elements", B * K * (K - 1) // 2)
    if dev.type == "cpu":
        return f64_rescores_plain(M, bin_orders, total)
    if dev.type != "cuda":
        raise ValueError(f"the re-scoring runs on cuda or cpu, not {dev}")
    if B == 0 or K < 2:
        return torch.zeros(B, dtype=torch.float64, device=dev)
    out = torch.empty(B, dtype=torch.float64, device=dev)
    rows = min(B, _MAX_GRID_Y)
    traces = torch.empty((rows, K), dtype=torch.float64, device=dev)
    tickets = torch.zeros(rows, dtype=torch.int32, device=dev)
    lib = _library()
    for b0 in range(0, B, rows):
        nb = min(rows, B - b0)
        _launch("f64_rescore", dev, lib.f64_rescore, M.data_ptr(), M.stride(0),
                bin_orders[b0:].data_ptr(), nb, K, trace_chunk(), float(total),
                traces.data_ptr(), tickets.data_ptr(), out[b0:].data_ptr())
        profiling.count(_RESCORE + "launches")
        profiling.count(_RESCORE + "launch_elements", K * (K - 1) // 2)
    return out
