"""The plain reference: what a whole assembly must write, in NumPy and
SciPy, from the HiC-Pro files the benchmark hands to the assembler.

It imports no part of the assembler and takes nothing the assembler made,
except where a stage follows the assembler's own file bus (each use is
named below).  Stage by stage:

* part 1, ingest and clustering: the dense contact matrix, the distance
  ``(1 - m / rowsum) + 1``, UPGMA (SciPy's average linkage) and the
  dendrogram's leaf order (``count_sort='ascending'``);
* part 1, hypergeometric cut search on the rank matrix of the similarity
  ``rowsum * (1 - (d - 1))``, with every window count taken densely on the
  host and every test a SciPy hypergeometric survival function;
* part 1, the HMM branch's cut search (k-means++, EM and Viterbi of
  2-state Gaussian HMMs);
* part 1, the Louvain tail (where ``modularity`` > 0): the bins past the
  last cut split into communities by the Louvain method on the dense
  log-similarity graph, seeded rounds 0, 1, ..., the best modularity kept;
* part 1, bin groups (the leaf order split at the cuts) and the scaffold
  assignment by majority vote, groups named by descending size;
* part 2, the order of each chromosome group (the reference's own groups):
  a group of at most ``nScaffolds`` scaffolds must be a best arrangement of
  all its arrangements; a longer one must be a fixed point of the sliding
  window: no window of ``scanScaffolds`` scaffolds has an arrangement of
  higher cost.  Costs are float64, from scaffold-pair profiles;
* part 3 (the assembler's orders): with no scaffold shorter than a bin
  there is nothing to re-orient, so the final orders are part 2's;
* part 4 (the assembler's final orders): the assembled FASTA, byte for
  byte.

``dtype`` float32 computes the clustering in single precision: that is the
control, the reference put in the assembler's place one precision down.
"""

from __future__ import annotations

import itertools
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import scipy.cluster.hierarchy
import scipy.spatial.distance
import scipy.stats

_THREADS = min(os.cpu_count() or 1, 8)
_COMPLEMENT = bytes.maketrans(b"ATGCatgcNn", b"TACGtacgNn")


def _rowmap(fn, n: int, block: int = 512) -> List:
    """``fn(r0, r1)`` over row blocks, on threads (NumPy releases the GIL)."""
    with ThreadPoolExecutor(_THREADS) as pool:
        return list(pool.map(lambda r0: fn(r0, min(r0 + block, n)), range(0, n, block)))


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


class Inputs:
    """The HiC-Pro files: bins in bed order (bins with a ``nan`` bias
    dropped), the symmetric dense matrix over them, scaffold sizes, FASTA
    path."""

    def __init__(self, paths: Dict[str, str]):
        self.paths = paths
        with open(paths["bed"]) as bed, open(paths["bias"]) as bias:
            rows = [(b.rstrip("\n").split("\t"), s.rstrip("\n")) for b, s in zip(bed, bias)]
        rows = [(cols, s) for cols, s in rows if s != "nan"]
        self.ids = np.array([int(c[3]) for c, _ in rows], dtype=np.int64)
        self.lines = [f"{c[3]}\t{c[0]}\t{c[1]}\t{c[2]}\t{_float_text(s)}" for c, s in rows]
        self.labels = [f"{c[0]}_{c[3]}" for c, _ in rows]
        n = len(rows)
        lookup = np.full(int(self.ids.max()) + 1, -1, dtype=np.int64)
        lookup[self.ids] = np.arange(n)
        with open(paths["matrix"]) as fh:
            coo = np.fromstring(fh.read(), sep=" ").reshape(-1, 3)
        a, b = coo[:, 0].astype(np.int64), coo[:, 1].astype(np.int64)
        ok = (a < lookup.size) & (b < lookup.size)
        ia, ib = lookup[a[ok]], lookup[b[ok]]
        keep = (ia >= 0) & (ib >= 0)
        m = np.zeros((n, n))
        m[ia[keep], ib[keep]] = coo[ok, 2][keep]
        m[ib[keep], ia[keep]] = coo[ok, 2][keep]
        self.matrix = m
        self.index_of = {int(i): k for k, i in enumerate(self.ids)}
        self.sizes = {}
        with open(paths["sizes"]) as fh:
            for line in fh:
                name, size = line.rstrip("\n").split("\t")
                self.sizes[name] = int(size)


def _float_text(text: str) -> str:
    try:
        return str(float(text))
    except ValueError:
        return "0.0"


# ---------------------------------------------------------------------------
# Part 1
# ---------------------------------------------------------------------------


def cluster(inp: Inputs, dtype=np.float64) -> Tuple[List[int], np.ndarray, np.ndarray]:
    """UPGMA leaf order of the distance matrix: (leaves, the distance matrix
    in leaf order, row sums in leaf order).  Rows whose sum is 0 are
    dropped first (none in the benchmark's genomes)."""
    m = np.asarray(inp.matrix, dtype=dtype)
    rs = m.sum(axis=1, keepdims=True)
    if np.any(rs == 0):
        raise ValueError("zero rows in the contact matrix")
    d = (1 - m / rs) + 1
    del m
    linkage = scipy.cluster.hierarchy.average(
        scipy.spatial.distance.squareform(d, checks=False).astype(np.float64))
    leaves = scipy.cluster.hierarchy.dendrogram(
        linkage, no_plot=True, get_leaves=True, count_sort="ascending")["leaves"]
    order = np.asarray(leaves)
    return list(map(int, leaves)), d[np.ix_(order, order)], rs[order, 0]


def rank_desc(d: np.ndarray, rs: np.ndarray) -> np.ndarray:
    """Rank matrix of the similarity rowsum * (1 - (d - 1)): each row's
    column indices by descending similarity, as NumPy's default argsort
    reversed (its tie order included)."""
    n = d.shape[0]
    dtype = np.int16 if n < 32767 else np.int32
    out = np.empty((n, n), dtype=dtype)

    def block(r0, r1):
        sim = (1.0 - (d[r0:r1] - 1.0)) * rs[r0:r1, None]
        out[r0:r1] = np.argsort(sim, axis=1)[:, ::-1]

    _rowmap(block, n)
    return out


def significant(x, M, n, N, psig: float) -> np.ndarray:
    """``hypergeom.sf(x - 1, M, n, N) < psig`` elementwise; with one
    distribution each distinct count is decided once."""
    x = np.asarray(x, dtype=np.int64)
    if np.ndim(M) == np.ndim(n) == np.ndim(N) == 0:
        ux, inv = np.unique(x, return_inverse=True)
        return (scipy.stats.hypergeom.sf(ux - 1, M, n, N) < psig)[inv].reshape(x.shape)
    return scipy.stats.hypergeom.sf(x - 1, M, n, N) < psig


class Counts:
    """Window counts of the rank matrix, on the host."""

    def __init__(self, rank: np.ndarray):
        self.rank = rank
        self.n = rank.shape[0]
        self._fixed: Dict[Tuple[int, int], np.ndarray] = {}

    def growing(self, start: int) -> np.ndarray:
        """Per row r: entries j < r - start with start <= rank[r, j] <= r."""
        out = np.zeros(self.n, dtype=np.int64)

        def block(r0, r1):
            rows = np.arange(r0, r1)[:, None]
            width = max(r1 - 1 - start, 0)
            if width == 0:
                return
            w = self.rank[r0:r1, :width]
            cols = np.arange(width)[None, :]
            out[r0:r1] = ((cols < rows - start) & (w >= start) & (w <= rows)).sum(axis=1)

        _rowmap(block, self.n)
        return out

    def fixed(self, start: int, cut: int) -> np.ndarray:
        """Per row: entries among the first cut - start with start <= rank <= cut."""
        key = (start, cut)
        if key not in self._fixed:
            out = np.zeros(self.n, dtype=np.int64)
            width = max(cut - start, 0)

            def block(r0, r1):
                w = self.rank[r0:r1, :width]
                out[r0:r1] = ((w >= start) & (w <= cut)).sum(axis=1)

            if width:
                _rowmap(block, self.n)
            self._fixed[key] = out
        return self._fixed[key]


def _window_signals(sig: np.ndarray, window: int) -> np.ndarray:
    """Per step i < len - window: sum of the window from i minus the sum of
    the next window; 0 where the second window runs past the end."""
    n = len(sig)
    if window >= n:
        return np.zeros(0, dtype=np.int64)
    c = np.concatenate([[0], np.cumsum(sig)])
    i = np.arange(n - window)
    left = c[i + window] - c[i]
    right = c[np.minimum(i + 2 * window, n)] - c[i + window]
    return np.where(i + 2 * window > n, 0, left - right)


def _leftmost_cuts(counts: Counts, start: int, min_size: int, world: int) -> np.ndarray:
    """Candidate cuts after ``start`` (relative to it): rows significant
    for the growing window, smoothed by a window of ``min_size`` (shrunk
    while nothing is found)."""
    n, M, ws = counts.n, world, min_size
    row_counts = counts.growing(start)
    inds = np.zeros(0, dtype=np.int64)
    loops, done = 0, False
    while True:
        while True:
            rows = np.arange(start + 1, n)
            curr = rows - start
            flags = np.concatenate([[0], significant(row_counts[rows], M, curr, curr, 0.05)])
            loops += 1
            if flags.sum() / len(flags) >= 0.9:
                M = int(M - start)
            else:
                done = True
            if done or loops >= 5:
                break
        signals = _window_signals(flags.astype(np.int64), ws)
        inds = np.nonzero(signals == min_size)[0] + min_size
        if len(inds) > 0:
            break
        ws -= 1
        if ws == 0:
            break
    return inds


def hypergeom_cuts(counts: Counts, min_size: int, min_frac: float, psig: float) -> List[int]:
    """The cut list: a leftmost scan repeated from each cut, then the
    noise filter run to its fixed point."""
    n = counts.n
    if min_frac == 1:
        return []
    stop = int(n - (n * min_frac))
    ind, cuts = 0, []
    while True:
        inds = _leftmost_cuts(counts, ind, min_size, n - ind)
        if len(inds) == 0:
            break
        ind += int(inds[0])
        cuts.append(ind)
        if ind >= stop or (n - ind) <= min_size:
            break
    return _filter_cuts(counts, cuts, psig)


def _filter_cuts(counts: Counts, original: Sequence[int], psig: float) -> List[int]:
    """Merge cuts joined by significant contacts, keeping the rightmost,
    until a whole pass changes nothing."""
    if not original:
        return []
    n = counts.n
    far = int(n / 5)
    max_rounds = 10 * len(original)
    flags_memo: Dict[Tuple[int, int], np.ndarray] = {}

    def flags(start: int, c: int) -> np.ndarray:
        if (start, c) not in flags_memo:
            sig = significant(counts.fixed(start, c), n - start, c - start, c - start, psig)
            flags_memo[start, c] = np.where(np.arange(n) - start > far, 0, sig.astype(np.int64))
        return flags_memo[start, c]

    altered = list(original)
    previous: Optional[Dict[int, str]] = None
    kept: Dict[int, str] = {}
    for _ in range(1000):
        start, kept, rounds = 0, {}, 0
        while rounds < max_rounds:
            M = n - start
            found, select = False, None
            for i, c in enumerate(altered):
                local = c - start
                f = flags(start, c)
                right, right_i, prev = None, None, start
                for ai_i, ai in enumerate(altered):
                    ps = f[prev:ai]
                    if ai == prev:
                        continue
                    prev = ai
                    if len(ps) == 0:
                        break
                    x = int(ps.sum())
                    if float(scipy.stats.hypergeom.sf(x - 1, M, local, len(ps))) < psig:
                        right, right_i = ai, ai_i
                if right is not None:
                    start = right
                    kept[right] = ""
                    found, select = True, right_i
                    break
                kept[c] = ""
                select = i
            rounds += 1
            if not found:
                break
            altered = altered[select:]
        if previous == kept:
            break
        altered = sorted(kept)
        previous = kept
    return sorted(kept)


# ---------------------------------------------------------------------------
# Part 1, HMM branch: 2-state Gaussian HMMs (hmmlearn's GaussianHMM, diagonal
# covariances, k-means means) to find where the next chromosome starts
# ---------------------------------------------------------------------------

_MIN_COVAR = 1e-3
_LOG2PI = math.log(2.0 * math.pi)


def log_similarity(d: np.ndarray, rs: np.ndarray) -> np.ndarray:
    """log10(similarity + 1) where the similarity is not 0, else 0."""
    sim = (1.0 - (d - 1.0)) * rs[:, None]
    out = np.zeros_like(sim)
    nz = sim != 0.0
    with np.errstate(divide="ignore", invalid="ignore"):
        vals = np.log(sim + 1.0) / np.log(10.0)
    out[nz] = vals[nz]
    return out


def _kmeans_plusplus(X, x_sq, rs):
    n = X.shape[0]
    centers = np.empty((2, X.shape[1]))
    centers[0] = X[rs.choice(n, p=np.full(n, 1.0 / n))]
    closest = np.maximum(x_sq - 2 * X @ centers[0] + centers[0] @ centers[0], 0)
    draws = rs.uniform(size=2) * closest.sum()
    cand = np.minimum(np.searchsorted(np.cumsum(closest), draws), n - 1)
    d_cand = np.minimum(closest[None, :], np.maximum(
        x_sq[None, :] - 2 * X[cand] @ X.T + (X[cand] ** 2).sum(axis=1)[:, None], 0))
    centers[1] = X[cand[np.argmin(d_cand.sum(axis=1))]]
    return centers


def kmeans_centers(X: np.ndarray, seed: int, n_init: int) -> np.ndarray:
    """scikit-learn's KMeans(n_clusters=2, random_state=seed, n_init)
    centres: k-means++ seeding, Lloyd iterations to a repeat of the labels
    or a squared shift within mean(var) * 1e-4, the lowest inertia of the
    inits (a later init only if it is another clustering)."""
    X = np.array(X, dtype=np.float64)
    tol = float(np.mean(np.var(X, axis=0)) * 1e-4)
    mean = X.mean(axis=0)
    X -= mean
    x_sq = (X * X).sum(axis=1)
    rs = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        centers = _kmeans_plusplus(X, x_sq, rs)
        old = None
        strict = False
        for _ in range(300):
            labels = np.argmin((centers ** 2).sum(axis=1)[None, :] - 2 * X @ centers.T, axis=1)
            new = centers.copy()
            for j in range(2):
                if (labels == j).any():
                    new[j] = X[labels == j].mean(axis=0)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if old is not None and np.array_equal(labels, old):
                strict = True
                break
            if shift <= tol:
                break
            old = labels
        if not strict:
            labels = np.argmin((centers ** 2).sum(axis=1)[None, :] - 2 * X @ centers.T, axis=1)
        inertia = float(((X - centers[labels]) ** 2).sum())
        same = best is not None and (np.array_equal(labels, best[0])
                                     or np.array_equal(labels, 1 - best[0]))
        if best is None or (inertia < best[1] and not same):
            best = (labels, inertia, centers)
    return best[2] + mean


def _logsumexp2(a: float, b: float) -> float:
    if a == -math.inf and b == -math.inf:
        return -math.inf
    m = max(a, b)
    return m + math.log(math.exp(a - m) + math.exp(b - m))


def _log_densities(X, means, covars) -> np.ndarray:
    out = np.empty((X.shape[0], 2))
    for k in range(2):
        out[:, k] = -0.5 * (((X - means[k]) ** 2 / covars[k]).sum(axis=1)
                            + np.log(covars[k]).sum() + X.shape[1] * _LOG2PI)
    return out


def _forward_backward(lb: np.ndarray, ls: np.ndarray, lt: np.ndarray):
    """Log-space forward-backward of a 2-state HMM: (log-likelihood, state
    posteriors [T, 2], summed transition posteriors [2, 2])."""
    T = lb.shape[0]
    fa = np.empty((T, 2))
    fb = np.zeros((T, 2))
    fa[0] = ls + lb[0]
    lt00, lt01, lt10, lt11 = lt[0, 0], lt[0, 1], lt[1, 0], lt[1, 1]
    for t in range(1, T):
        a0, a1 = fa[t - 1]
        fa[t, 0] = _logsumexp2(a0 + lt00, a1 + lt10) + lb[t, 0]
        fa[t, 1] = _logsumexp2(a0 + lt01, a1 + lt11) + lb[t, 1]
    for t in range(T - 2, -1, -1):
        c0 = lb[t + 1, 0] + fb[t + 1, 0]
        c1 = lb[t + 1, 1] + fb[t + 1, 1]
        fb[t, 0] = _logsumexp2(lt00 + c0, lt01 + c1)
        fb[t, 1] = _logsumexp2(lt10 + c0, lt11 + c1)
    lp = _logsumexp2(fa[T - 1, 0], fa[T - 1, 1])
    gamma = np.exp(fa + fb - lp)
    xi = np.zeros((2, 2))
    if T > 1:
        nxt = lb[1:] + fb[1:]
        for i in range(2):
            for j in range(2):
                xi[i, j] = np.exp(fa[:-1, i] + lt[i, j] + nxt[:, j] - lp).sum()
    return lp, gamma, xi


def _viterbi(lb, ls, lt) -> np.ndarray:
    T = lb.shape[0]
    score = ls + lb[0]
    back = np.zeros((T, 2), dtype=np.int64)
    for t in range(1, T):
        cand = score[:, None] + lt           # [from, to]
        back[t] = np.argmax(cand, axis=0)
        score = cand[back[t], [0, 1]] + lb[t]
    path = np.empty(T, dtype=np.int64)
    path[-1] = int(np.argmax(score))
    for t in range(T - 1, 0, -1):
        path[t - 1] = back[t, path[t]]
    return path


def hmm_states(X: np.ndarray, seed: int = 0, n_init: int = 2, n_iter: int = 1000,
               tol: float = 1e-2) -> np.ndarray:
    """Viterbi states of X under a 2-state diagonal Gaussian HMM fitted by
    EM: k-means means, the data's variances (+1e-3), start (.5, .5) kept,
    transitions from [[.9, .1], [1e-4, .9999]] re-estimated, EM until the
    log-likelihood gains less than ``tol``."""
    X = np.asarray(X, dtype=np.float64)
    means = kmeans_centers(X, seed, n_init)
    c = X - X.mean(axis=0)
    var = (c * c).sum(axis=0) / (X.shape[0] - 1)
    covars = np.maximum(np.tile(var + _MIN_COVAR, (2, 1)), _MIN_COVAR)
    trans = np.array([[0.9, 0.1], [1e-4, 0.9999]])
    ls = np.log([0.5, 0.5])
    prev = -np.inf
    log = lambda a: np.log(np.where(a > 0, a, 1.0)) + np.where(a > 0, 0.0, -np.inf)  # noqa: E731
    for _ in range(n_iter):
        lp, gamma, xi = _forward_backward(_log_densities(X, means, covars), ls, log(trans))
        norm = np.maximum(gamma.sum(axis=0)[:, None], 1e-300)
        means = gamma.T @ X / norm
        covars = np.maximum(gamma.T @ (X * X) / norm - means ** 2 + _MIN_COVAR, _MIN_COVAR)
        row = xi.sum(axis=1, keepdims=True)
        trans = xi / np.where(row > 0, row, 1.0)
        if lp - prev < tol:
            break
        prev = lp
    return _viterbi(_log_densities(X, means, covars), ls, log(trans))


def _boundary(states: np.ndarray, last_cut: int, run: int) -> int:
    """Where the first run of ``run`` states other than the start state
    begins (the start state is the commoner in the first ``run``)."""
    first = states[:run]
    start = 0 if (first == 0).sum() >= (first == 1).sum() else 1
    for i in range(len(states) - run):
        if np.all(states[i : i + run] != start):
            return i + last_cut
    return 0


def _hmm_step(adj, cuts: List, min_size, rounds, look_ahead, n_init) -> List:
    n = len(adj)
    look = int((float(n - cuts[-1]) * look_ahead) + cuts[-1]) if look_ahead is not False else n
    prev, k, cut = look, 1, look
    while k <= rounds:
        if (n - cuts[-1]) / 2 < min_size:
            cuts.append("NA")
            return cuts
        X = adj[cuts[-1]:, cuts[-1]:prev]
        if X.shape[1] < min_size:
            cut = look
        else:
            cut = _boundary(hmm_states(X, 0, n_init), cuts[-1], min_size)
        if cut != prev:
            prev, k = cut, k + 1
            continue
        cuts.append(int(cut))
        return cuts
    cuts.append(int(cut))
    return cuts


def hmm_cuts(adj: np.ndarray, min_size: int, modularity: float, rounds: int, look_ahead,
             n_init: int, prev: Optional[List] = None) -> List[int]:
    """The HMM cut list before any Louvain tail: boundaries found one after
    another until past n * (1 - modularity); a search that ends at the
    matrix's end drops that cut and, while enough is left, starts again
    with one round fewer and the upstream's reset settings (minSize 5,
    modularity .05, lookAhead .5)."""
    n = float(len(adj))
    remainder = n - modularity * n
    if modularity == 1:
        return []
    cuts: List = prev if prev is not None else [0]
    while cuts[-1] <= remainder:
        cuts = _hmm_step(adj, cuts, min_size, rounds, look_ahead, n_init)
        if cuts[-1] == 0:
            break
        if cuts[-1] == "NA":
            cuts.pop(-1)
            break
    if cuts and cuts[0] == 0:
        cuts.pop(0)
    if cuts and cuts[-1] == len(adj):
        cuts.pop(-1)
        last = cuts[-1] if cuts else 0
        if (len(adj) - last) >= 5 * modularity:
            if rounds - 1 == 0:
                return cuts
            return hmm_cuts(adj, 5, 0.05, rounds - 1, 0.5, n_init, cuts if cuts else [0])
    return cuts


# ---------------------------------------------------------------------------
# Part 1, the Louvain tail: the bins past the last cut, split by the Louvain
# method (python-louvain's weights: a self-loop counts twice in its node's
# degree) in seeded rounds, the partition of highest modularity kept
# ---------------------------------------------------------------------------

_LOUVAIN_MIN_GAIN = 1e-7


def _louvain_level(a: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One level: each node in turn, in a fresh random order each pass,
    joins the community of largest gain (the lowest id among equals) while
    that beats staying by more than the least gain; until a pass moves no
    node.  Returns each node's community."""
    n = a.shape[0]
    k = a.sum(axis=1)
    two_m = float(a.sum())
    comm = np.arange(n)
    tot = k.copy()
    moved = True
    while moved:
        moved = False
        for v in rng.permutation(n):
            own = comm[v]
            w = np.bincount(comm, weights=a[v], minlength=n)
            w[own] -= a[v, v]
            tot[own] -= k[v]
            stay = w[own] - tot[own] * k[v] / two_m if two_m else 0.0
            gains = w - tot * k[v] / two_m if two_m else w
            gains[own] = stay
            best = int(np.argmax(gains))
            if gains[best] - stay > _LOUVAIN_MIN_GAIN:
                comm[v] = best
                moved = True
            tot[comm[v]] += k[v]
    return comm


def louvain_partition(adj: np.ndarray, seed: int) -> np.ndarray:
    """The Louvain method from ``default_rng(seed)``: levels of local moves,
    each level's communities merged into the next level's nodes, until a
    level merges none; communities numbered in order of first node."""
    rng = np.random.default_rng(seed)
    a = np.asarray(adj)
    level = a + np.diag(np.diag(a))
    mapping = np.arange(a.shape[0])
    while True:
        comm = _louvain_level(level, rng)
        labels, relabel = np.unique(comm, return_inverse=True)
        member = np.zeros((len(comm), len(labels)), dtype=level.dtype)
        member[np.arange(len(comm)), relabel] = 1.0
        merged = member.T @ level @ member
        mapping = relabel[mapping]
        if merged.shape[0] == level.shape[0]:
            break
        level = merged
    _, first, inverse = np.unique(mapping, return_index=True, return_inverse=True)
    renumber = np.empty(len(first), dtype=np.int64)
    renumber[np.argsort(first, kind="stable")] = np.arange(len(first))
    return renumber[inverse]


def modularity(labels: np.ndarray, adj: np.ndarray) -> float:
    """Newman modularity of ``labels`` on the weighted graph ``adj``."""
    a = np.asarray(adj)
    a = a + np.diag(np.diag(a))
    k = a.sum(axis=1)
    two_m = float(k.sum())
    if two_m == 0:
        return 0.0
    q = 0.0
    for c in np.unique(labels):
        mask = labels == c
        q += a[np.ix_(mask, mask)].sum() / two_m
        q -= (k[mask].sum() / two_m) ** 2
    return q


def louvain_tail(adj: np.ndarray, cuts: Sequence[int], rounds: int,
                 seed: int = 0) -> Tuple[List[int], List[int]]:
    """The tail past the last cut of ``adj`` (log-similarity, leaf order):
    the best of ``rounds`` Louvain partitions (seeds ``seed``, ``seed`` + 1,
    ...; the first of equal modularity), its communities placed largest
    first (equal sizes by first node), each bin's order within kept.
    Returns (positions in leaf order, the cut list extended by one cut a
    community, without a cut at 0 or at the end)."""
    cuts = sorted(cuts) if cuts else [0]
    start = cuts[-1]
    tail = np.asarray(adj)[start:, start:]
    best, best_q = None, -2.0
    for i in range(rounds):
        labels = louvain_partition(tail, seed + i)
        q = modularity(labels, tail)
        if q > best_q:
            best, best_q = labels, q
    sizes = np.bincount(best)
    order = list(range(start))
    for c in sorted(range(len(sizes)), key=lambda c: -sizes[c]):
        order.extend(int(start + i) for i in np.nonzero(best == c)[0])
        cuts.append(cuts[-1] + int(sizes[c]))
    if cuts[0] == 0:
        cuts.pop(0)
    if cuts and cuts[-1] == len(adj):
        cuts.pop(-1)
    return order, cuts


def bin_groups(inp: Inputs, order: Sequence[int], cuts: Sequence[int]) -> List[List[str]]:
    """Bin lines in leaf order, split at the cuts."""
    lines = [inp.lines[i] for i in order]
    bounds = [0, *cuts, len(lines)]
    return [lines[a:b] for a, b in zip(bounds, bounds[1:])]


def chromosome_groups(inp: Inputs, groups: List[List[str]]) -> List[str]:
    """Scaffolds assigned by majority (51% of their bins) to each bin
    group, groups named by descending total size: the lines of
    ``chromosomeGroupings.txt``."""
    bins_of: Dict[str, List[int]] = {}
    for g in groups:
        for line in g:
            bid, scaff = line.split("\t")[:2]
            bins_of.setdefault(scaff, []).append(int(bid))
    for v in bins_of.values():
        v.sort()
    final = []
    for g in groups:
        members: Dict[str, int] = {}
        for line in g:
            scaff = line.split("\t")[1]
            members[scaff] = members.get(scaff, 0) + 1
        chosen = [(b, s) for s, k in members.items()
                  if round(k / len(bins_of[s]) * 100.0, 2) >= 51.0 for b in bins_of[s]]
        if chosen:
            final.append(chosen)
    size = [sum(inp.sizes[s] for s in dict.fromkeys(s for _, s in g)) for g in final]
    ranked = [g for g, _ in sorted(zip(final, size), key=lambda p: p[1], reverse=True)]
    out = []
    for i, g in enumerate(ranked):
        out.append(f"### Chromosome group {i + 1} ###")
        out.extend(f"{b}\t{s}" for b, s in g)
    return out


# ---------------------------------------------------------------------------
# Part 2: the order of each chromosome group
# ---------------------------------------------------------------------------


def _swap_orders(n: int) -> List[Tuple[int, ...]]:
    """Permutations of range(n) in recursive-swap order, keeping the first
    of each (order, reversed order) pair."""
    elems, out = list(range(n)), []

    def rec(k):
        if k == n:
            out.append(tuple(elems))
            return
        for i in range(k, n):
            elems[k], elems[i] = elems[i], elems[k]
            rec(k + 1)
            elems[k], elems[i] = elems[i], elems[k]

    rec(0)
    seen, kept = set(), []
    for p in out:
        if p[::-1] not in seen:
            seen.add(p)
            kept.append(p)
    return kept


def _orientations(n: int) -> List[Tuple[int, ...]]:
    """All orientation vectors (1 = "-"): all "+" first, then for i = 0..n-1
    the distinct swap-order permutations of i "+" followed by n - i "-"."""
    out = [(0,) * n]
    seen = set(out)
    for i in range(n):
        base = [0] * i + [1] * (n - i)
        for p in _all_swaps(base):
            if p not in seen:
                seen.add(p)
                out.append(p)
    return out


def _all_swaps(elems: List[int]) -> List[Tuple[int, ...]]:
    elems, out = list(elems), []

    def rec(k):
        if k == len(elems):
            out.append(tuple(elems))
            return
        for i in range(k, len(elems)):
            elems[k], elems[i] = elems[i], elems[k]
            rec(k + 1)
            elems[k], elems[i] = elems[i], elems[k]

    rec(0)
    return out


class Chromosome:
    """One chromosome group's contacts, by scaffold: the search's
    scaffolds are sorted by size, largest first (ties in order of first
    appearance), each with its bins ascending.  The cost of an arrangement
    P of a set of scaffolds is sum_{k<l} M[P_k, P_l] * w(l - k) over their
    bins, w(d) = (sum_{i=d}^{C-1} 1/i) / total, C and total (the upper
    triangle's sum) taken over the set; it is computed from each scaffold
    pair's anti-diagonal profile, in ``dtype``."""

    def __init__(self, inp: Inputs, rows: Sequence[Tuple[int, str]], dtype=np.float64):
        bins: Dict[str, List[int]] = {}
        for bid, name in rows:
            bins.setdefault(name, []).append(bid)
        self.names = sorted(bins, key=lambda n: len(bins[n]), reverse=True)
        self.sizes = np.array([len(bins[n]) for n in self.names], dtype=np.int64)
        ids = [b for n in self.names for b in sorted(bins[n])]
        idx = np.array([inp.index_of[b] for b in ids])
        self.dtype = dtype
        self.m = np.asarray(inp.matrix[np.ix_(idx, idx)], dtype=dtype)
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)[:-1]])
        S, big = len(self.names), int(self.sizes.max())
        self.span = 2 * big - 1
        self.intra = np.zeros((S, big), dtype=dtype)
        self.intra_total = np.zeros(S, dtype=dtype)
        for s in range(S):
            blk = self.block(s, s)
            r, c = np.triu_indices(len(blk), k=1)
            self.intra[s, : len(blk)] = np.bincount(c - r, weights=blk[r, c], minlength=len(blk))
            self.intra_total[s] = self.intra[s].sum()
        self.cross_total = np.zeros((S, S), dtype=dtype)
        self.H = np.zeros((S, S, 4, self.span), dtype=dtype)
        for a in range(S):
            for b in range(S):
                if a == b:
                    continue
                self.cross_total[a, b] = self.block(a, b).sum()
                la, lb = self.sizes[a], self.sizes[b]
                d = (np.arange(la)[:, None] + np.arange(lb)[None, :]).ravel()
                for ea in (0, 1):
                    for eb in (0, 1):
                        x = self.m[np.ix_(self.bins_of(a, ea)[::-1], self.bins_of(b, eb))]
                        self.H[a, b, 2 * ea + eb, : la + lb - 1] = np.bincount(
                            d, weights=x.ravel(), minlength=la + lb - 1)

    def block(self, a: int, b: int) -> np.ndarray:
        oa, ob = self.offsets[a], self.offsets[b]
        return self.m[oa : oa + self.sizes[a], ob : ob + self.sizes[b]]

    def bins_of(self, s: int, minus: int) -> np.ndarray:
        b = np.arange(self.offsets[s], self.offsets[s] + self.sizes[s])
        return b[::-1] if minus else b

    def weights(self, include: Sequence[int]) -> Tuple[np.ndarray, float]:
        """The harmonic weights of a scaffold set, and its constant (the
        scaffolds' own contacts, which no arrangement changes)."""
        inc = np.asarray(include)
        C = int(self.sizes[inc].sum())
        iu = np.triu_indices(len(inc), k=1)
        total = self.intra_total[inc].sum() + self.cross_total[inc[iu[0]], inc[iu[1]]].sum()
        w = np.zeros(2 * C + self.span + 2, dtype=self.dtype)
        if C > 1 and total != 0:
            inv = (1.0 / np.arange(1, C, dtype=np.float64)).astype(self.dtype)
            w[1:C] = np.cumsum(inv[::-1])[::-1] / total
        const = (self.intra[inc] * w[None, : self.intra.shape[1]]).sum()
        return w, float(const)

    def pair_values(self, a, b, e, gap, w) -> np.ndarray:
        """Cost of scaffold a placed ``gap`` bins before scaffold b, for
        arrays of (a, b, orientation pair, gap)."""
        S, G = len(self.names), int(self.sizes.sum()) + 1
        keys = ((np.asarray(a) * S + b) * 4 + e) * G + gap
        uniq, inv = np.unique(keys, return_inverse=True)
        rest = uniq // G
        return self.distinct_values(rest // 4 // S, rest // 4 % S, rest % 4, uniq % G, w)[
            inv.reshape(-1)]

    def distinct_values(self, a, b, e, gap, w) -> np.ndarray:
        """``pair_values`` of each (a, b, orientation pair, gap), one row
        sum a key: the same bits whatever else the batch holds."""
        S = len(self.names)
        h = np.take(self.H.reshape(-1, self.span), (np.asarray(a) * S + b) * 4 + e, axis=0)
        h *= np.take(np.lib.stride_tricks.sliding_window_view(w[1:], self.span), gap, axis=0)
        return h.sum(axis=1)

    def costs(self, ids: np.ndarray, orients: np.ndarray, w, const) -> np.ndarray:
        """Costs of candidate arrangements [N, k] of scaffold ids with their
        orientations."""
        ln = self.sizes[ids]
        off = np.concatenate([np.zeros((len(ids), 1), np.int64), np.cumsum(ln, axis=1)[:, :-1]], 1)
        k = ids.shape[1]
        total = np.full(len(ids), const, dtype=np.float64)
        if k < 2:
            return total
        kk, ll = np.triu_indices(k, k=1)
        a, b = ids[:, kk].ravel(), ids[:, ll].ravel()
        e = (2 * orients[:, kk] + orients[:, ll]).ravel()
        gap = (off[:, ll] - off[:, kk] - ln[:, kk]).ravel()
        total += self.pair_values(a, b, e, gap, w).reshape(len(ids), -1).sum(axis=1)
        return total

    def cost(self, order: Sequence[Tuple[int, int]]) -> float:
        ids = np.array([[s for s, _ in order]])
        w, const = self.weights(ids[0])
        return float(self.costs(ids, np.array([[e for _, e in order]]), w, const)[0])


def _earliest_best(costs: np.ndarray) -> int:
    """The earliest candidate within 1e-12 (relative) of the best."""
    best = float(costs.max())
    return int(np.nonzero(costs >= best - 1e-12 * max(abs(best), 1.0))[0][0])


def _insertion_costs(ch: Chromosome, order: List[int], flags: List[int], new: int,
                     state: int, w: np.ndarray, const: float) -> np.ndarray:
    """``ch.costs`` of every insertion of scaffold ``new`` into ``order``:
    slot by slot, the orientation ``state`` first and then the other,
    ``state`` flipping from one slot to the next.  Each candidate's pair
    values are those of ``ch.costs``, gathered from the K^2 pairs of the
    order as it stands (straddling the slot or not) and the 2 K (K + 1)
    placements of ``new``, and summed in the same layout: the same bits."""
    K = len(order)
    if K == 0:
        return np.full(2, const, dtype=np.float64)
    ids, fl = np.asarray(order), np.asarray(flags)
    ln = ch.sizes[ids]
    off = np.concatenate([[0], np.cumsum(ln)])          # off[s]: bins before slot s
    ln_new = int(ch.sizes[new])
    # the order's own pairs (i < j), apart and with ``new`` between them
    i, j = np.triu_indices(K, k=1)
    gap = off[j] - off[i] - ln[i]
    e = 2 * fl[i] + fl[j]
    old = ch.distinct_values(np.tile(ids[i], 2), np.tile(ids[j], 2), np.tile(e, 2),
                             np.concatenate([gap, gap + ln_new]), w)
    # ``new`` at slot s with orientation o, beside order[k]: before it when k >= s
    o, slot, k = (x.ravel() for x in np.meshgrid([0, 1], np.arange(K + 1), np.arange(K),
                                                 indexing="ij"))
    before = k >= slot
    placed = ch.distinct_values(np.where(before, new, ids[k]), np.where(before, ids[k], new),
                                np.where(before, 2 * o + fl[k], 2 * fl[k] + o),
                                np.where(before, off[k] - off[slot], off[slot] - off[k] - ln[k]), w)
    table = np.concatenate([old, placed])
    # each candidate's pairs (p < q) of its K + 1 places, as ``ch.costs`` lays
    # them out: the order's own pairs in their order (shifted where they
    # straddle the slot), and ``new``'s K pairs where p or q is the slot
    n_old, slots = len(i), np.arange(K + 1, dtype=np.int32)[:, None]
    p, q = (x.astype(np.int32) for x in np.triu_indices(K + 1, k=1))
    placed_at = (p == slots) | (q == slots)
    own = np.arange(n_old, dtype=np.int32) + n_old * ((i < slots) & (j >= slots))
    mine = 2 * n_old + slots * K + np.arange(K, dtype=np.int32)
    idx = np.empty((K + 1, 2, len(p)), dtype=np.int32)
    first = idx[:, 0]
    first[~placed_at] = own.ravel()
    first[placed_at] = (mine + (state ^ slots % 2) * (K + 1) * K).ravel()
    # the other orientation of ``new``: its pairs one table of (K + 1) K away
    idx[:, 1] = first + placed_at * ((1 - 2 * (state ^ slots % 2)) * (K + 1) * K)
    total = np.full(2 * (K + 1), const, dtype=np.float64)
    total += table[idx.reshape(2 * (K + 1), -1)].sum(axis=1)
    return total


def _window_costs(ch: Chromosome, order: List[Tuple[int, int]], i: int, w_len: int,
                  perms: np.ndarray, orients: np.ndarray, w: np.ndarray) -> np.ndarray:
    """What each candidate arrangement of the window order[i:i+w_len]
    (kept orders x orientations, order-major) adds to the cost against the
    fixed rest; the same constant is left out of every candidate."""
    ids = [s for s, _ in order]
    lens = ch.sizes[ids[i : i + w_len]]
    L = int(lens.sum())
    before = int(ch.sizes[ids[:i]].sum())
    seq = np.concatenate([ch.bins_of(s, e) for s, e in order])
    inside = np.zeros(len(seq), bool)
    inside[before : before + L] = True
    out_bins, out_pos = seq[~inside], np.nonzero(~inside)[0]
    wd = w[np.abs(out_pos[:, None] - (before + np.arange(L))[None, :])]
    U = np.zeros((w_len, 2, L + 1))
    for k in range(w_len):
        span = L - lens[k] + 1
        for e in (0, 1):
            g = ch.m[np.ix_(ch.bins_of(ids[i + k], e), out_bins)] @ wd
            for j in range(lens[k]):
                U[k, e, :span] += g[j, j : j + span]
    P, R = len(perms), len(orients)
    loc = np.repeat(perms, R, axis=0)
    e = np.tile(orients, (P, 1))
    sid = np.asarray(ids[i : i + w_len])[loc]
    ln = lens[loc]
    off = np.concatenate([np.zeros((len(loc), 1), np.int64), np.cumsum(ln, axis=1)[:, :-1]], 1)
    total = U[loc, e, off].sum(axis=1)
    kk, ll = np.triu_indices(w_len, k=1)
    total += ch.pair_values(sid[:, kk].ravel(), sid[:, ll].ravel(),
                            (2 * e[:, kk] + e[:, ll]).ravel(),
                            (off[:, ll] - off[:, kk] - ln[:, kk]).ravel(), w
                            ).reshape(len(loc), -1).sum(axis=1)
    return total


def order_chromosome(ch: Chromosome, n_scaffolds: int, scan: int
                     ) -> Tuple[List[Tuple[str, str]], float, Optional[float]]:
    """The search: every arrangement of the largest ``n_scaffolds``
    scaffolds; then each other scaffold, largest first, inserted at its
    best slot and orientation (with none left, the last scaffold is taken
    out and put back); then, past ``n_scaffolds`` scaffolds, windows of
    ``scan`` scaffolds slid along the order, each rearranged whenever that
    gains, until a whole sweep gains nothing.  Ties go to the earliest
    candidate.  Returns the order, its cost after the insertions and, past
    ``n_scaffolds`` scaffolds, its cost after the windows."""
    S = len(ch.names)
    n_scaffolds = min(n_scaffolds, 8)
    scan = min(scan, n_scaffolds)
    head = list(range(min(n_scaffolds, S)))
    perms = np.array(_swap_orders(len(head)))
    orients = np.array(_orientations(len(head)))
    w, const = ch.weights(head)
    R = len(orients)
    ids = np.repeat(perms, R, axis=0)
    costs = ch.costs(ids, np.tile(orients, (len(perms), 1)), w, const)
    win = _earliest_best(costs)
    order = [int(x) for x in perms[win // R]]
    flags = [int(x) for x in orients[win % R]]
    remaining = list(range(len(head), S))
    best = 0.0
    while True:
        if remaining:
            new, state = remaining.pop(0), 0
        else:
            new, state = order.pop(-1), flags.pop(-1)
        w, const = ch.weights(order + [new])
        costs = _insertion_costs(ch, order, flags, new, state, w, const)
        win = _earliest_best(costs)
        best = float(costs[win])
        slot, o = (win // 2, state ^ (win // 2) % 2 ^ win % 2) if best > 0.0 else (0, 0)
        order.insert(slot, new)
        flags.insert(slot, o)
        if not remaining:
            break
    inserted, final = best, None
    if S > n_scaffolds:
        perms = np.array(_swap_orders(scan))
        orients = np.array(_orientations(scan))
        R = len(orients)
        w, const = ch.weights(range(S))
        while True:
            improved = False
            for i in range(S - scan + 1):
                arr = list(zip(order, flags))
                part = _window_costs(ch, arr, i, scan, perms, orients, w)
                current = float(part[_identity_index(flags[i : i + scan], orients)])
                win = _earliest_best(part + (best - current))
                gain = float(part[win]) - current
                if gain > 1e-12 * max(abs(best), 1.0):
                    p, r = perms[win // R], orients[win % R]
                    window = order[i : i + scan]
                    order[i : i + scan] = [window[k] for k in p]
                    flags[i : i + scan] = [int(x) for x in r]
                    best += gain
                    improved = True
            if not improved:
                break
        final = ch.cost(list(zip(order, flags)))
    return [(ch.names[s], "-" if e else "+") for s, e in zip(order, flags)], inserted, final


def _identity_index(flags: Sequence[int], orients: np.ndarray) -> int:
    """The candidate index of the window as it stands (the identity order
    is the first kept order)."""
    return int(np.nonzero(np.all(orients == np.asarray(flags)[None, :], axis=1))[0][0])


# ---------------------------------------------------------------------------
# File bus
# ---------------------------------------------------------------------------


def sections(lines: Sequence[str]) -> List[List[str]]:
    """Sectioned lines (``### ... ###`` headers) as each section's lines."""
    out: List[List[str]] = []
    for line in lines:
        if line.startswith("#"):
            out.append([])
        elif line and out:
            out[-1].append(line)
    return out


def read_sections(path: str) -> List[List[str]]:
    """A sectioned file as its sections' lines."""
    with open(path) as fh:
        return sections(fh.read().split("\n"))


def read_fasta(path: str) -> Dict[str, bytes]:
    with open(path, "rb") as fh:
        data = fh.read()
    out = {}
    for entry in data[1:].split(b"\n>"):
        head, _, body = entry.partition(b"\n")
        out[head.decode()] = body.replace(b"\n", b"")
    return out


def _wrap(seq: bytes, width: int = 50) -> bytes:
    return b"".join(seq[i : i + width] + b"\n" for i in range(0, len(seq), width))


def assembled_fasta(original: Dict[str, bytes], orders: List[List[Tuple[str, str]]]) -> bytes:
    """``>Chr_i`` per chromosome in order, ``-`` scaffolds reverse
    complemented, 100 N between scaffolds; then every other input entry."""
    out, written = [], set()
    for i, group in enumerate(orders, 1):
        parts = []
        for name, o in group:
            written.add(name)
            s = original[name]
            parts.append(s if o == "+" else s.translate(_COMPLEMENT)[::-1])
        out.append(b">Chr_%d\n" % i + _wrap((b"N" * 100).join(parts)))
    for name, s in original.items():
        if name not in written:
            out.append(b">" + name.encode() + b"\n" + _wrap(s))
    return b"".join(out)


def differing_lines(a: Sequence, b: Sequence) -> int:
    """Lines that differ position by position, plus the difference in count."""
    return int(sum(x != y for x, y in zip(a, b))) + abs(len(a) - len(b))


def sub_bin_scaffolds(inp: Inputs, resolution: int) -> int:
    """Scaffolds of one bin or less, the only ones part 3 re-orients."""
    return sum(math.ceil(s / resolution) == 1 for s in inp.sizes.values())
