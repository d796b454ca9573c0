"""Scoring engine for the distance-weighted contact cost, in torch.

Counterpart of ``hic_genome_assembler_tpu/ops/cost.py``.  The cost of an
arrangement P of a chromosome's C bins is

    cost(P) = sum_{k<l} M[o_k, o_l] * w(l - k),
    w(d)    = H_d / total,   H_d = sum_{i=d}^{C-1} 1/i,

and ``ChromosomeScorer`` factors it by scaffold pairs: one device pass over
the C x C submatrix builds the pair profiles h[(s*Sp+t)*4+e, m]; per
scaffold subset the table F = h @ Wm gives every candidate's score in
O(S^2) gathers.  Device scores are float32 (TF32 off, see ``device.py``);
the winners are re-scored in float64 with the reference's exact
summation order, and ``_F32_MARGIN`` bounds which candidates must be
re-scored (``docs/PRECISION.md``).  A decision re-scores its candidates in
batches (``rescore_many``), and a batch's memo misses go to
``score_kernels.f64_rescores``: on the card one launch that reads the
chromosome's float64 matrix through each candidate's bin order, on the CPU
the host's gather and ``oracle.cost_function``, with the same bits.

The device functions are ``ops/score_kernels.py``: on a CUDA device the
pair profiles, the combo top-k, the block scores (and their top-k) and the
pair scores are hand-written kernels, on the CPU their plain torch
versions; the table ``F = h @ Wm`` is a ``torch.matmul``, as the JAX
package left it to XLA.
The host float64 bookkeeping and the decision rules are copied from the JAX
module, which imports jax; ``PrecisionStats`` is an object each run creates
and passes, not a process-wide global.

With a mesh (``parallel.mesh.Mesh``), candidate batches are split over its
data axis with the JAX package's padding rule, and the table and the small
index tensors are replicated to each data-axis device.  The top-k groups
are the JAX mesh path's, over the whole padded batch: each block reduces
the groups it holds to partial (max, argmax, second) triples, which alone
reach the scorer's device and are folded there once
(``score_kernels.fold_group_triples``).  The dense scores of
``score_batch`` and ``score_pairs`` are gathered on the scorer's device.
"""

from __future__ import annotations

import functools
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.ops import score_kernels as sk
from hic_genome_assembler_tpu_torch.ops.score_kernels import (  # noqa: F401
    group_argmax as _group_argmax,  # the JAX module's name (ops/cost.py:251); no caller here
)
from hic_genome_assembler_tpu_torch.parallel import mesh as pm
from hic_genome_assembler_tpu_torch.utils import profiling, transfer


def _round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def harmonic_weights(C: int, total: float) -> np.ndarray:
    """w[d] = (sum_{i=d}^{C-1} 1/i) / total for d in 1..C-1; w[0] = 0."""
    w = np.zeros(max(C, 1), dtype=np.float64)
    if C > 1 and total != 0.0:
        inv = 1.0 / np.arange(1, C, dtype=np.float64)
        w[1:] = np.cumsum(inv[::-1])[::-1] / total
    return w


def upper_triangle_total(matrix: np.ndarray) -> float:
    iu = np.triu_indices(matrix.shape[0], k=1)
    return float(matrix[iu].sum())


def bin_order_of_block(
    order: Sequence[int], orient: Sequence[int], sizes: Sequence[int]
) -> np.ndarray:
    """Scaffold-level (order, orient) -> canonical bin-index order.

    Canonical layout: scaffold k occupies bins [offset_k, offset_k +
    sizes[k]) in 5'->3' direction; orientation 1 ("-") reverses its bins.
    """
    sizes = np.asarray(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    chunks = []
    for s, e in zip(order, orient):
        bins = np.arange(offsets[s], offsets[s] + sizes[s])
        chunks.append(bins[::-1] if e else bins)
    return np.concatenate(chunks).astype(np.int32)


def bin_orders_of_rows(
    orders: np.ndarray, orients: np.ndarray, sizes: np.ndarray, offsets: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """``bin_order_of_block`` of every row of ``orders`` and ``orients``
    (int [B, W]; ids ``>= len(sizes)`` are padding) in one pass of array
    operations.  ``offsets``: each scaffold's first bin.  Returns the rows'
    bin orders one after another (int32 [sum K]) and each row's K (int64
    [B]).  The bin at place p of the result, inside entry e, is e's start
    bin plus its step (+1, or -1 for orientation 1) times p less e's first
    place."""
    S = len(sizes)
    real = orders < S
    ids = orders[real]                      # row by row, as each row's mask keeps them
    lens = sizes[ids]
    n = int(lens.sum())
    # int32 temporaries: half the pages of int64 ones, which cost more
    # than the arithmetic at a lump's thousands of bins a row
    dtype = np.int32 if n < 2**31 else np.int64
    reverse = orients[real] != 0
    step = np.where(reverse, -1, 1).astype(dtype)
    start = (offsets[ids] + np.where(reverse, lens - 1, 0)).astype(dtype)
    first = (np.cumsum(lens) - lens).astype(dtype)
    bins = np.repeat(start - step * first, lens) + np.repeat(step, lens) * np.arange(n, dtype=dtype)
    ks = np.where(real, sizes[np.minimum(orders, S - 1)], 0).sum(axis=1)
    return bins.astype(np.int32, copy=False), ks


def _torch_dtype(dtype) -> torch.dtype:
    return {np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64}[
        np.dtype(dtype)
    ]


# ---------------------------------------------------------------------------
# Pair profiles and the per-subset table
# ---------------------------------------------------------------------------


def _profiles_to_table(h: torch.Tensor, wpad: torch.Tensor, shift: int, C: int) -> torch.Tensor:
    """F[row, delta] = sum_m h[row, m] * w(delta + m - shift): one float32
    matmul, re-run per scaffold subset with that subset's weights."""
    L = h.shape[1]
    dev = h.device
    darg = torch.arange(C + 1, device=dev)[None, :] + (torch.arange(L, device=dev) - shift)[:, None]
    Wm = torch.where((darg >= 1) & (darg <= C - 1), wpad[darg.clamp(0, C)], 0.0)
    return h @ Wm


# ---------------------------------------------------------------------------
# Combo-factorized brute-force scoring
#
# For a fixed enumeration batch (all n!/2 orders over one value set), the
# F-table cell a candidate pair needs depends only on the "combo"
# (s_i, s_j, set-of-scaffolds-between).  There are only n^2 * 2^(n-2)
# combos (3584 at n=8), and the candidate->combo map ``cid`` is pure
# combinatorics, computed once per n and cached for the process.
# ---------------------------------------------------------------------------

_COMBO_CACHE: dict = {}
_TRIU_CACHE: dict = {}


def _triu_cache(c: int):
    hit = _TRIU_CACHE.get(c)
    if hit is None:
        hit = _TRIU_CACHE[c] = np.triu_indices(c, k=1)
    return hit


def _combo_index(orders: np.ndarray) -> dict:
    """Candidate->combo map for an enumeration batch whose rows all
    permute the same value set.  Cached by batch bytes.  Combo encoding
    over value RANKS: c = (ri*n + rj)*2^(n-2) + mask, where mask bit b set
    <=> the b-th remaining rank (ascending, excluding ri and rj) lies
    strictly between positions of s_i, s_j."""
    key = (orders.shape, orders.tobytes())
    hit = _COMBO_CACHE.get(key)
    if hit is not None:
        return hit
    Bo, S = orders.shape
    values = np.sort(np.unique(orders[0]))
    if len(values) != S:
        raise ValueError("combo path needs distinct per-row values")
    rank_of = np.full(int(values.max()) + 1, -1, dtype=np.int64)
    rank_of[values] = np.arange(S)
    r_ord = rank_of[orders]                                  # [Bo, S] ranks
    pi, pj = np.triu_indices(S, k=1)
    P = len(pi)
    nbits = max(S - 2, 0)
    # bit position of rank k among "others of (ri, rj)" = k - (k>ri) - (k>rj)
    ri = r_ord[:, pi]                                        # [Bo, P]
    rj = r_ord[:, pj]
    mask = np.zeros((Bo, P), dtype=np.int64)
    for q in range(1, S - 1):                                # between offsets
        between = np.zeros((Bo, P), dtype=bool)
        rq = np.zeros((Bo, P), dtype=np.int64)
        for p, (a, b) in enumerate(zip(pi, pj)):
            if not a + q < b:
                continue
            rq[:, p] = r_ord[:, a + q]
            between[:, p] = True
        bitpos = rq - (rq > ri) - (rq > rj)
        mask |= np.where(between, 1 << bitpos, 0)
    cid = ((ri * S + rj) << nbits) + mask                    # [Bo, P]
    n_combo = (S * S) << nbits
    c = np.arange(n_combo, dtype=np.int64)
    si_r = (c >> nbits) // S
    sj_r = (c >> nbits) % S
    bits = (c[:, None] >> np.arange(nbits)[None, :]) & 1     # [n_combo, nbits]
    # others_rank[ri, rj, b] = b-th ascending rank excluding ri, rj
    others = np.zeros((S, S, nbits), dtype=np.int64)
    for a in range(S):
        for b in range(S):
            rest = [k for k in range(S) if k != a and k != b]
            rest = (rest + [0] * nbits)[:nbits]
            others[a, b] = rest
    out = {
        "values": values,
        "cid": cid,
        "si_r": si_r,
        "sj_r": sj_r,
        "bits": bits,
        "others_r": others[si_r, sj_r],                      # [n_combo, nbits]
        "n_combo": n_combo,
        "valid": si_r != sj_r,
    }
    _COMBO_CACHE[key] = out
    return out


def _drain_rows(parts: Sequence[Tuple[int, int, torch.Tensor]], shape) -> np.ndarray:
    """The rows ``t[:n]`` of each ``(ofs, n, t)`` at ``out[ofs : ofs + n]``
    of a host float64 array of ``shape``.  The rows are read back into one
    host buffer (pinned for CUDA tensors) without waiting, and each card
    is waited for once at the end (``utils/transfer``), where a pageable
    ``.cpu()`` a tensor would wait for each."""
    pinned = any(t.device.type == "cuda" for _ofs, _n, t in parts)
    buf = torch.empty(shape, dtype=parts[0][2].dtype, pin_memory=pinned)
    transfer.finish_readback([transfer.start_readback(
        [t[:n] for _ofs, n, t in parts], into=[buf[ofs : ofs + n] for ofs, n, _t in parts]
    )])
    return buf.numpy().astype(np.float64)


class ChromosomeScorer:
    """Once-per-chromosome pair-profile factorization on ``device``.

    Builds the orientation-resolved scaffold-pair diagonal profiles
    h[(s*Sp+t)*4+e, m] over the C x C chromosome submatrix (canonical
    layout: scaffolds size-descending, bins ascending within each
    scaffold).  Every search stage scores scaffold-level candidates from
    the same h via a per-subset harmonic reweighting (``subset()``).

    ``device_sub``: optional float32 copy of ``sub_matrix`` already on the
    device (sliced from the genome matrix by the part-2 driver);
    ``sub_matrix`` is still required for the f64 host bookkeeping, and goes
    to the device as float64 at the first exact re-score
    (:meth:`exact_costs`), where it stays while the scorer lives.
    ``stats``: the run's ``PrecisionStats``.  ``mesh``: candidate batches
    are split over its data axis (see the module docstring); the table is
    built on the mesh's first device, which ``device`` is then taken as.
    """

    def __init__(
        self,
        sub_matrix: np.ndarray,
        sizes: Sequence[int],
        device: torch.device,
        dtype=np.float32,
        device_sub: Optional[torch.Tensor] = None,
        stats: Optional["PrecisionStats"] = None,
        mesh: Optional[pm.Mesh] = None,
    ):
        self._mesh = mesh
        self.device = mesh.first if mesh is not None else torch.device(device)
        self._dtype = np.dtype(dtype)
        self.stats = PrecisionStats() if stats is None else stats
        tdtype = _torch_dtype(self._dtype)
        sub = np.asarray(sub_matrix, dtype=np.float64)
        self.sizes = np.asarray(sizes, dtype=np.int64)
        self.S = len(self.sizes)
        self.C = int(self.sizes.sum())
        if sub.shape != (self.C, self.C):
            raise ValueError(f"submatrix {sub.shape} does not match {self.C} bins")
        self._sub = sub
        self._sub_f64: Optional[torch.Tensor] = None  # ``sub`` on the device, at first use

        # Shape buckets, as in the JAX package (its executables are keyed
        # on them); kept so that the table layout maps one to one.
        cmax = int(self.sizes.max())
        self.Sp = 9 if self.S + 1 <= 9 else _round_up(self.S + 1, 8)
        self.cmax = _round_up(cmax, 64)
        self.L = 2 * self.cmax - 1
        self.C_pad = _round_up(self.C, 256)     # table/delta width

        sid = np.repeat(np.arange(self.S), self.sizes)

        # Host-side f64 exact bookkeeping: per-scaffold internal diagonal
        # profiles (for c0), internal totals and pairwise cross totals.
        offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        self.intra_profile = np.zeros((self.S, max(cmax, 1)), dtype=np.float64)
        self.intra_total = np.zeros(self.S, dtype=np.float64)
        for s, (o, c) in enumerate(zip(offsets, self.sizes)):
            block = sub[o : o + c, o : o + c]
            if c > 1:
                rows, cols = _triu_cache(c)
                self.intra_profile[s, : max(c, 1)] = np.bincount(
                    cols - rows, weights=block[rows, cols], minlength=c
                )[:max(c, 1)]
            self.intra_total[s] = self.intra_profile[s].sum()
        G = np.zeros((self.C, self.S), dtype=np.float64)
        G[np.arange(self.C), sid] = 1.0
        self.cross_total = G.T @ (sub @ G)

        dev = self.device
        if device_sub is None:
            device_sub = transfer.to_device(sub, dev, self._dtype)
        device_sub = device_sub.to(dev, tdtype).contiguous()
        sizes_padded = np.zeros(self.Sp, dtype=np.int64)
        sizes_padded[: self.S] = self.sizes
        self._sizes_d = transfer.to_device(sizes_padded, dev)
        self._h = sk.pair_profiles(device_sub, self._sizes_d, self.cmax)

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """Each scaffold's first bin in the canonical layout."""
        return np.cumsum(self.sizes) - self.sizes

    @property
    def pad_id(self) -> int:
        """Scaffold id usable as padding in fixed-width candidate arrays;
        contributes zero size and zero cost."""
        return self.S

    @property
    def cand_width(self) -> int:
        """Bucketed candidate width for fixed-shape search batches."""
        return _round_up(max(self.S, 1), 8)

    def exact_costs(self, bin_orders: np.ndarray, total: float) -> np.ndarray:
        """Reference-exact float64 costs of candidates given as bin orders
        (int32 [B, K]) with a subset's ``total``: one batch of
        ``score_kernels.f64_rescores`` over the chromosome's float64 matrix,
        uploaded once through pinned memory at the first batch."""
        if self._sub_f64 is None:
            with profiling.timer("part2/f64_upload"):
                self._sub_f64 = transfer.to_device(self._sub, self.device)
        # every float64 re-score of part 2, from any stage
        with profiling.timer("part2/f64_rescore"):
            costs = sk.f64_rescores(
                self._sub_f64, transfer.to_device(bin_orders, self.device, np.int32), total
            )
            (host,) = transfer.to_host([costs])
        return host

    def subset(self, include: Sequence[int]) -> "SubsetScorer":
        """Scorer for candidates drawn from ``include`` (global ids)."""
        return SubsetScorer(self, list(include))

    def full(self) -> "SubsetScorer":
        return self.subset(range(self.S))


class SubsetScorer:
    """Scoring view over a scaffold subset: fixed ``total``, w profile,
    reweighted F table and intra-scaffold constant c0."""

    def __init__(self, parent: ChromosomeScorer, include: List[int]):
        self.parent = parent
        self.include = include
        self.device = parent.device
        self.stats = parent.stats
        self.sizes = parent.sizes
        self.S = parent.S
        self.C = parent.C_pad  # delta/table width (bucketed, >= real C)
        self.C_sub = int(parent.sizes[include].sum())
        inc = np.asarray(include)
        iu = np.triu_indices(len(inc), k=1)
        self.total = float(parent.intra_total[inc].sum()) + float(
            parent.cross_total[inc[iu[0]], inc[iu[1]]].sum()
        )
        self.degenerate = self.total == 0.0
        self.w = harmonic_weights(self.C_sub, self.total)
        if not self.degenerate:
            profile = parent.intra_profile[inc].sum(axis=0)
            wlen = min(len(profile), len(self.w))
            self.c0 = float(profile[:wlen] @ self.w[:wlen])
        else:
            self.c0 = 0.0
        self._host_memo: dict = {}
        wpad = np.zeros(self.C + 1, dtype=np.float64)
        wpad[1 : self.C_sub] = self.w[1 : self.C_sub]
        F = _profiles_to_table(
            parent._h,
            transfer.to_device(wpad, self.device, parent._dtype),
            parent.cmax - 1,
            self.C,
        )
        self._F_flat = F.reshape(-1)
        self._sizes_d = parent._sizes_d
        self._c0_d = transfer.to_device(np.array(self.c0, dtype=parent._dtype), self.device)
        self._mesh = parent._mesh
        self._F_r, self._sizes_r, self._c0_r = (
            self._rep(t) for t in (self._F_flat, self._sizes_d, self._c0_d)
        )

    def _put(self, a: np.ndarray, dtype=np.int64) -> torch.Tensor:
        return transfer.to_device(a, self.device, dtype)

    @property
    def _data_devices(self) -> List[torch.device]:
        return [self.device] if self._mesh is None else self._mesh.data_devices

    def _rep(self, t: torch.Tensor) -> List[torch.Tensor]:
        """``t`` on each data-axis device (``[t]`` without a mesh)."""
        return [t.to(dev) for dev in self._data_devices]

    def _blocks(self, batch: np.ndarray) -> List[torch.Tensor]:
        """An int32 candidate batch as one block per data-axis device,
        padded by repeating its last row (``put_batch_padded``)."""
        if self._mesh is None:
            return [self._put(batch, np.int32)]
        return pm.put_batch_padded(self._mesh, np.require(batch, np.int32, ["C", "W"]))[0]

    def _gather(self, outs: List[torch.Tensor]) -> torch.Tensor:
        return outs[0] if len(outs) == 1 else pm.gather(outs, self.device)

    def _map_blocks(self, score: Callable, batch: np.ndarray) -> torch.Tensor:
        """``score(i, block)`` on each data-axis position ``i`` over the
        batch's blocks, the results gathered on ``self.device``."""
        return self._gather([score(i, blk) for i, blk in enumerate(self._blocks(batch))])

    def _fold_blocks(self, partials: Callable, k: int):
        """The group top-k of a batch split over the data axis:
        ``partials(i, out)`` runs block i's partials wrapper on its device
        (writing into ``out`` where given), the blocks' [k] triples are
        stacked [D, k] on ``self.device`` (a block there writes its row in
        place; another block's 16 bytes a group are copied) and folded in
        one launch.  Returns ``(vals, idx, second)`` [k]."""
        stacked = sk.empty_triples(len(self._data_devices), k, self._F_flat.dtype, self.device)
        for i, dev in enumerate(self._data_devices):
            row = tuple(t[i] for t in stacked)
            if dev == self.device:
                partials(i, row)
            else:
                for dst, src in zip(row, partials(i, None)):
                    dst.copy_(src)
        return sk.fold_group_triples(*stacked)

    def _block_costs(self, chunk: np.ndarray, orients_r) -> torch.Tensor:
        """``block_scores`` over a chunk of orders: [rows, R], with the
        mesh's padding rows at the end."""
        return self._map_blocks(
            lambda i, blk: sk.block_scores(
                self._F_r[i], self._sizes_r[i], blk, orients_r[i], self._c0_r[i]
            ),
            chunk,
        )

    def score_batch(
        self, orders: np.ndarray, orients: np.ndarray, chunk_orders: int = 2048
    ) -> np.ndarray:
        """Costs for the full (order x orientation) grid: float[Bo * R] in
        candidate order (order-major, orientation-fastest)."""
        Bo, S = orders.shape
        R = orients.shape[0]
        if self.degenerate:
            return np.zeros(Bo * R, dtype=np.float64)
        orients_r = self._rep(self._put(orients, np.int32))
        handles = []
        for ofs in range(0, Bo, chunk_orders):
            chunk = orders[ofs : ofs + chunk_orders]
            handles.append((ofs, chunk.shape[0], self._block_costs(chunk, orients_r)))
        # all chunks launched; one drain reads them back (JAX: one device_get)
        return _drain_rows(handles, (Bo, R)).reshape(-1)

    def score_batch_topk(
        self,
        orders: np.ndarray,
        orients: np.ndarray,
        k: int = 64,
        chunk_orders: int = 20160,
    ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Top-k candidates without materializing all costs on the host:
        (global candidate indices, fast costs, floor), where ``floor``
        bounds the fast score of every candidate NOT returned.  Global
        index = order_idx * R + orient_idx (reference enumeration order)."""
        handles, finish = self.score_batch_topk_async(
            orders, orients, k=k, chunk_orders=chunk_orders
        )
        return finish(transfer.to_host(handles))

    def score_batch_topk_async(
        self,
        orders: np.ndarray,
        orients: np.ndarray,
        k: int = 64,
        chunk_orders: int = 20160,
    ):
        """Dispatch-only form of :meth:`score_batch_topk`: returns
        ``(handles, finish)``, where ``handles`` is a tuple of device
        tensors (launched, not read back) and ``finish(host_arrays)``
        turns their numpy copies into the result."""
        Bo, S = orders.shape
        R = orients.shape[0]
        if self.degenerate:
            m = min(k, Bo * R)
            return (), lambda host: (np.arange(m), np.zeros(m), -np.inf)
        if 2 <= S <= 8 and len(np.unique(orders[0])) == S:
            return self._score_topk_combo_async(orders, orients, k)
        orients_r = self._rep(self._put(orients, np.int32))
        handles: List[torch.Tensor] = []
        meta: List[Tuple[int, int, int]] = []  # (ofs, n_real, kk)
        for ofs in range(0, Bo, chunk_orders):
            chunk = orders[ofs : ofs + chunk_orders]
            n_real = chunk.shape[0]
            if n_real < chunk_orders and Bo > chunk_orders:
                # pad the ragged tail to the steady-state chunk (same
                # groups, hence the same selection, as the JAX package)
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], chunk_orders - n_real, axis=0)]
                )
            groups = min(k, chunk.shape[0] * R)
            if self._mesh is None:  # one kernel: the scores never leave it
                handles.extend(sk.block_score_topk(
                    self._F_r[0], self._sizes_r[0], self._put(chunk, np.int32), orients_r[0],
                    self._c0_r[0], groups,
                ))
            else:
                # groups over the mesh-padded batch, as in the JAX mesh path;
                # padding rows are dropped in finish
                blocks = self._blocks(chunk)
                n_glob = sum(blk.shape[0] for blk in blocks) * R
                handles.extend(self._fold_blocks(
                    lambda i, out: sk.block_score_topk_partials(
                        self._F_r[i], self._sizes_r[i], blocks[i], orients_r[i], self._c0_r[i],
                        groups, i * blocks[0].shape[0] * R, n_glob, out=out),
                    groups,
                ))
            meta.append((ofs, n_real, min(k, n_real * R)))

        def finish(host):
            all_idx: List[np.ndarray] = []
            all_vals: List[np.ndarray] = []
            floor = -np.inf  # upper bound on any candidate NOT returned
            for h, (ofs, n_real, kk) in zip(range(0, len(host), 3), meta):
                vals, idx, second = host[h], host[h + 1], host[h + 2]
                keep = idx < n_real * R  # drop padding rows
                all_idx.append(idx[keep][:kk] + ofs * R)
                all_vals.append(vals[keep][:kk])
                # dropped in-group candidates score < their group's second
                # max; pad-winner groups duplicate a real candidate whose
                # score may not be in the kept set — bound it by the val
                sec = second[np.isfinite(second)]
                if sec.size:
                    floor = max(floor, float(sec.max()))
                if (~keep).any():
                    floor = max(floor, float(vals[~keep].max()))
            idx = np.concatenate(all_idx)
            vals = np.concatenate(all_vals)
            if len(idx) > k:
                top = np.argsort(-vals, kind="stable")
                floor = max(floor, float(vals[top[k]]))
                idx, vals = idx[top[:k]], vals[top[:k]]
            return idx, vals, floor

        return tuple(handles), finish

    def _combo_f_indices(self, combo: dict) -> np.ndarray:
        """F_flat gather indices for every combo's 4 orientation cells:
        delta(c) = size(s_i) + sum(sizes of the between-set)."""
        sizes = self.parent.sizes
        Sp, C = self.parent.Sp, self.C
        values = combo["values"].astype(np.int64)
        gi = values[combo["si_r"]]
        gj = values[combo["sj_r"]]
        nbits = combo["bits"].shape[1]
        delta = sizes[gi].copy()
        if nbits:
            others_g = values[combo["others_r"]]
            delta += (combo["bits"] * sizes[others_g]).sum(axis=1)
        rows = (gi * Sp + gj) * 4
        idx4 = (rows[:, None] + np.arange(4)) * (C + 1) + delta[:, None]
        return np.where(combo["valid"][:, None], idx4, 0)

    def _score_topk_combo_async(self, orders: np.ndarray, orients: np.ndarray, k: int):
        """Brute-force top-k via the combo factorization; the candidate ->
        combo map and its device copy are reused across chromosomes.  The
        scores never leave the kernel: on a mesh each block's launch emits
        its groups' partial triples, folded once (``_fold_blocks``).
        Returns (handles, finish) — see score_batch_topk_async."""
        Bo, S = orders.shape
        R = orients.shape[0]
        combo = _combo_index(orders.astype(np.int64))
        dev_key = tuple(map(str, self._data_devices))
        ok = ("orients_dev", dev_key, orients.tobytes())
        if ok not in combo:
            combo[ok] = self._rep(self._put(orients, np.int32))
        ck = ("cid_dev", dev_key)
        if ck not in combo:
            combo[ck] = self._blocks(combo["cid"])
        orients_r, cid_blocks = combo[ok], combo[ck]
        idx4_r = self._rep(self._put(self._combo_f_indices(combo)))
        n_pad = sum(cid.shape[0] for cid in cid_blocks)
        kk = min(k, Bo * R)
        groups = min(k, n_pad * R)
        if len(cid_blocks) == 1:
            vals_d, idx_d, second_d = sk.combo_score_topk(
                self._F_r[0], idx4_r[0], cid_blocks[0], orients_r[0], self._c0_r[0], groups
            )
        else:
            vals_d, idx_d, second_d = self._fold_blocks(
                lambda i, out: sk.combo_score_topk_partials(
                    self._F_r[i], idx4_r[i], cid_blocks[i], orients_r[i], self._c0_r[i], groups,
                    i * cid_blocks[0].shape[0] * R, n_pad * R, out=out),
                groups,
            )

        def finish(host):
            vals, idx, second = host[0], host[1], host[2]
            floor = -np.inf
            sec = second[np.isfinite(second)]
            if sec.size:
                floor = max(floor, float(sec.max()))
            keep = idx < Bo * R  # drop mesh-padding rows
            if (~keep).any():  # pad rows duplicate the last real candidate
                floor = max(floor, float(vals[~keep].max()))
            idx, vals = idx[keep], vals[keep]
            if len(idx) > kk:
                top = np.argsort(-vals, kind="stable")
                floor = max(floor, float(vals[top[kk]]))
                idx, vals = idx[top[:kk]], vals[top[:kk]]
            return idx, vals, floor

        return (vals_d, idx_d, second_d), finish

    def score_pairs(self, orders: np.ndarray, orients: np.ndarray) -> np.ndarray:
        """Costs for per-candidate (order, orientation) pairs: ``orders``
        and ``orients`` are int[B, W] (global ids; ``pad_id`` fills unused
        slots)."""
        handles, finish = self.score_pairs_async(orders, orients)
        return finish(transfer.to_host(handles))

    def score_pairs_async(self, orders: np.ndarray, orients: np.ndarray):
        """Dispatch-only form of :meth:`score_pairs`."""
        B, W = orders.shape
        if self.degenerate:
            return (), lambda host: np.zeros(B, dtype=np.float64)
        # orders and orients go up as one int32 tensor [B, 2*W]
        out = self._map_blocks(
            lambda i, cand: sk.pair_scores(self._F_r[i], self._sizes_r[i], cand, self._c0_r[i]),
            np.concatenate([orders, orients], axis=1),
        )
        return (out,), lambda host: np.asarray(host[0], dtype=np.float64)[:B]

    def score_host_many(self, orders: Sequence, orients: Sequence) -> np.ndarray:
        """Reference-exact f64 costs [B] of candidates given as (order,
        orientation) rows of one width; pad ids are ignored.  Memoized by
        each candidate's canonical bin order, built for all rows at once
        (``bin_orders_of_rows``): the misses, each once, are re-scored in
        one batch (``ChromosomeScorer.exact_costs``)."""
        B = len(orders)
        if self.degenerate or B == 0:
            return np.zeros(B, dtype=np.float64)
        with profiling.timer("part2/f64_bin_orders"):
            bins, ks = bin_orders_of_rows(
                np.asarray(orders), np.asarray(orients), self.sizes, self.parent.offsets
            )
            profiling.count("part2/f64_bin_order_rows", B)
            keys = []
            misses: dict = {}
            end = 0
            for k in ks.tolist():
                bin_order = bins[end : end + k]
                end += k
                key = bin_order.tobytes()
                keys.append(key)
                if key not in self._host_memo:
                    misses.setdefault(key, bin_order)
            batch = np.stack(list(misses.values())) if misses else None
        if batch is not None:
            costs = self.parent.exact_costs(batch, self.total)
            self._host_memo.update(zip(misses, costs.tolist()))
        return np.array([self._host_memo[key] for key in keys], dtype=np.float64)

    def score_host(self, order: Sequence[int], orient: Sequence[int]) -> float:
        """Reference-exact f64 cost for one (order, orientation)."""
        return float(self.score_host_many([order], [orient])[0])


def BlockScorer(
    sub_matrix: np.ndarray,
    sizes: Sequence[int],
    device="cuda",
    dtype=np.float32,
    mesh: Optional[pm.Mesh] = None,
    device_sub: Optional[torch.Tensor] = None,
    stats: Optional["PrecisionStats"] = None,
) -> SubsetScorer:
    """Brute-force scorer over the full scaffold set of ``sub_matrix``:
    ``ChromosomeScorer(...).full()``, as the JAX package's ``BlockScorer``;
    on the card unless ``device`` names the CPU."""
    return ChromosomeScorer(
        sub_matrix, sizes, device, dtype=dtype, device_sub=device_sub, stats=stats, mesh=mesh
    ).full()


# ---------------------------------------------------------------------------
# Decision rule (host float64)
# ---------------------------------------------------------------------------


# A candidate whose f32 device score is more than this RELATIVE margin
# below the exact (f64) winner cannot be the f64 winner.  Every cost is a
# sum of non-negative terms, so the f32 error is bounded by the
# accumulation depth times 2^-24 (docs/PRECISION.md); the bound assumes
# true float32 multiplies, which is why TF32 stays off.
_F32_MARGIN = 1e-4


class PrecisionStats:
    """Monitor of the fast-vs-exact score gap for one run.

    Every decision that re-scores a candidate in f64 records the
    discrepancy against its f32 device score; an observation above
    ``_F32_MARGIN / 8`` counts as a violation and warns (the decision
    itself stays exact: the escalation loops anchor on f64 values)."""

    def __init__(self) -> None:
        self.n = 0
        self.max_rel = 0.0
        self.escalations = 0
        self.violations = 0

    def observe(self, fast: float, exact: float) -> None:
        if not np.isfinite(fast):
            return
        rel = abs(exact - fast) / max(abs(exact), 1.0)
        self.n += 1
        if rel > self.max_rel:
            self.max_rel = rel
        if rel > _F32_MARGIN / 8.0:
            self.violations += 1
            warnings.warn(
                "fast-precision score error %.3g exceeds the f32 margin "
                "budget %.3g (exact=%r fast=%r); decisions remain exact via "
                "escalation but the kernel precision model is off" %
                (rel, _F32_MARGIN / 8.0, exact, fast),
                RuntimeWarning,
                stacklevel=3,
            )

    def summary(self) -> str:
        return (
            f"precision: {self.n} rescored, max rel err {self.max_rel:.3g}, "
            f"{self.escalations} escalations, {self.violations} violations"
        )


def _prefilter_margin(vals: np.ndarray) -> np.ndarray:
    best = float(vals.max())
    return vals >= best - _F32_MARGIN * max(abs(best), 1.0)


RescoreMany = Callable[[np.ndarray], Sequence[float]]


def _rescore_into(
    exact: dict, indices: Sequence[int], rescore_many: RescoreMany, fast, stats: PrecisionStats
) -> None:
    """``exact[i]`` for each candidate index in ``indices``, re-scored in one
    batch, each observed against its fast score ``fast(i)`` in order."""
    indices = [int(i) for i in indices]
    for i, value in zip(indices, rescore_many(np.asarray(indices, dtype=np.int64))):
        exact[i] = float(value)
        stats.observe(fast(i), exact[i])


def _decide(
    costs: np.ndarray,
    rescore_many: RescoreMany,
    exact: dict,
    rel_tol: float,
    stats: PrecisionStats,
) -> Tuple[int, float]:
    """Given fast costs for ALL candidates and a (possibly pre-seeded) f64
    cache, grow the cache until no candidate whose fast score is within
    ``_F32_MARGIN`` of the exact winner is un-rescored, then apply the
    reference tie rule (earliest index among f64 ties wins).  Each
    escalation re-scores its new candidates in one batch."""
    best = max(exact.values())
    while True:
        band = _F32_MARGIN * max(abs(best), 1.0)
        cand = np.nonzero(costs >= best - band)[0]
        new = [int(i) for i in cand if int(i) not in exact]
        if not new:
            break
        stats.escalations += 1
        _rescore_into(exact, new, rescore_many, lambda i: float(costs[i]), stats)
        best = max(exact.values())
    tol = rel_tol * max(abs(best), 1.0)
    winners = sorted(i for i, c in exact.items() if c >= best - tol)
    return winners[0], exact[winners[0]]


def argmax_reference_ties_sparse(
    cand_indices: np.ndarray,
    rescore_many: RescoreMany,
    rel_tol: float = 1e-12,
    fast_vals: Optional[np.ndarray] = None,
    second_floor: Optional[float] = None,
    escalate: Optional[Callable[[], np.ndarray]] = None,
    *,
    stats: PrecisionStats,
) -> Tuple[int, float]:
    """Reference tie rule over a sparse candidate set (device top-k):
    f64-rescore the plausible candidates (``rescore_many(indices)``, one
    batch a step), earliest index among ties wins.
    ``fast_vals`` enables the f32-margin prefilter; ``second_floor`` (the
    kernel's bound on every candidate it did not return) plus ``escalate``
    (-> full fast-cost vector) re-run the decision densely when the floor
    is within the margin of the exact winner."""
    cand_indices = np.asarray(cand_indices)
    fv = None if fast_vals is None else np.asarray(fast_vals, dtype=np.float64)
    sel = cand_indices
    if fv is not None and len(cand_indices) > 1:
        sel = cand_indices[_prefilter_margin(fv)]
    fmap = {}
    if fv is not None:
        fmap = {int(i): float(v) for i, v in zip(cand_indices, fv)}
    exact: dict = {}
    _rescore_into(exact, sel, rescore_many, lambda i: fmap.get(i, np.nan), stats)
    best = max(exact.values())
    if fv is not None:
        while True:
            band = _F32_MARGIN * max(abs(best), 1.0)
            new = [
                int(i) for i, v in zip(cand_indices, fv)
                if v >= best - band and int(i) not in exact
            ]
            if not new:
                break
            stats.escalations += 1
            _rescore_into(exact, new, rescore_many, lambda i: fmap[i], stats)
            best = max(exact.values())
    band = _F32_MARGIN * max(abs(best), 1.0)
    if (
        second_floor is not None
        and escalate is not None
        and second_floor >= best - band
    ):
        # candidates dropped on the device could still contend: pull the
        # full fast-cost vector and decide densely (rare by design)
        stats.escalations += 1
        full = np.asarray(escalate(), dtype=np.float64)
        return _decide(full, rescore_many, exact, rel_tol, stats)
    tol = rel_tol * max(abs(best), 1.0)
    winners = sorted(i for i, c in exact.items() if c >= best - tol)
    return winners[0], exact[winners[0]]


def argmax_reference_ties(
    costs: np.ndarray,
    rescore_many: Optional[RescoreMany] = None,
    k: int = 64,
    rel_tol: float = 1e-12,
    *,
    stats: PrecisionStats,
) -> Tuple[int, float]:
    """Pick the winning candidate the way the reference does: the
    earliest index attaining the max.  With ``rescore_many(indices) ->
    f64 costs`` the prefiltered top-k are re-scored in one batch and the
    set grows until every candidate whose fast score is within
    ``_F32_MARGIN`` of the exact winner has been re-scored; candidates
    within ``rel_tol`` of the best count as ties."""
    n = costs.shape[0]
    if n == 0:
        raise ValueError("no candidates")
    if rescore_many is None or n <= 1:
        best = float(costs.max())
        ties = np.nonzero(costs >= best - rel_tol * max(abs(best), 1.0))[0]
        return int(ties[0]), best
    costs = np.asarray(costs, dtype=np.float64)
    k = min(k, n)
    top = np.argpartition(-costs, k - 1)[:k]
    top = top[_prefilter_margin(costs[top])]
    exact: dict = {}
    _rescore_into(exact, top, rescore_many, lambda i: float(costs[i]), stats)
    return _decide(costs, rescore_many, exact, rel_tol, stats)
