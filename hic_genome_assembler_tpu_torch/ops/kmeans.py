"""Two-centre k-means and the diagonal covariance that seed the HMM's EM.

Counterpart of the initialisation in
``hic_genome_assembler_tpu/ops/gaussian_hmm.py::GaussianHMM2._init_params``,
which calls ``sklearn.cluster.KMeans(n_clusters=2, random_state=seed,
n_init=n_init)``.  The GPU machines have no scikit-learn, so this module
reproduces that call on the host in numpy float64: the same random draws
from one ``np.random.RandomState(seed)``, the same k-means++ seeding, the
same Lloyd iterations and the same choice among the inits, so that it
returns sklearn's centres in sklearn's row order.  The order matters: the
HMM's starting transmat is asymmetric, so swapped centres start the EM on
another trajectory.

What is reproduced (``sklearn/cluster/_kmeans.py``):

* ``fit``: ``X`` is centred on its column mean; every init draws from the
  one ``RandomState`` in turn; a later init replaces the best only if its
  inertia is lower and its labels are not the same clustering; the mean is
  added back to the centres;
* ``_kmeans_plusplus`` with ``n_local_trials = 2 + int(log 2) = 2``:
  the first centre from ``choice(n, p=w / w.sum())``, candidates from
  ``uniform(size=2) * potential`` placed by ``searchsorted`` over the
  cumulative sum of the squared distances ``|x|^2 - 2 x.c + |c|^2``;
* ``_kmeans_single_lloyd`` (at most 300 iterations): labels by the least
  ``|c|^2 - 2 x.c`` (the lower index wins a tie), centres as sums times the
  reciprocal weight, an empty cluster relocated to the farthest point;
  stop when the labels repeat (strict convergence) or when the squared
  centre shift is within ``mean(var(X)) * 1e-4``, relabelling once more
  in the second case.

:func:`kmeans2` returns the centres and :func:`diag_covars` of the data.
Of an array or a CPU tensor it runs that numpy code, which is also the
oracle of the card's; of a CUDA tensor it launches the f64 kernels of
``csrc/kmeans.cu`` on it (or raises: there is no fallback), the
covariances from the fit's own column statistics.  The card's fit keeps on
the host what does not depend on the data, every init's ``RandomState``
draws (:func:`plusplus_draws`, taken first), and what numpy must decide,
the candidates' ``searchsorted`` over the closest distances (read back once
an init) and the loop's stopping rule (read back once a Lloyd iteration,
through pinned memory); an empty cluster's relocation, rare, runs in plain
torch.  Only the order of the f64 sums differs from the numpy fit.  Both
count their Lloyd iterations (``part1/kmeans_lloyd_iterations``).
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.ops import _build, hmm_kernels
from hic_genome_assembler_tpu_torch.utils import profiling, transfer

MIN_COVAR = 1e-3
_MAX_ITER = 300
_TOL = 1e-4
# Lloyd iterations, on the host and on the card alike
ITERATIONS = "part1/kmeans_lloyd_iterations"


def _row_norms_sq(X: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", X, X)


def _sq_distances(C: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """``|c|^2 - 2 c.x + |x|^2`` clipped at 0: [len(C), len(X)]."""
    d = -2 * (C @ X.T)
    d += _row_norms_sq(C)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0)


def _candidates(closest: np.ndarray, w: np.ndarray, rand: np.ndarray) -> np.ndarray:
    """The k-means++ candidates' rows: ``rand`` (uniform draws) times the
    potential, placed by ``searchsorted`` over the cumulative sum of the
    closest squared distances ``closest`` [1, n]."""
    pot = closest @ w
    rand_vals = rand * pot
    cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
    np.clip(cand, None, closest.size - 1, out=cand)
    return cand


def _plusplus(X: np.ndarray, x_sq: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    n = X.shape[0]
    w = np.ones(n, dtype=X.dtype)
    n_local_trials = 2 + int(np.log(2))
    centers = np.empty((2, X.shape[1]), dtype=X.dtype)
    centers[0] = X[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[0:1], X, x_sq)
    cand = _candidates(closest, w, rs.uniform(size=n_local_trials))
    d_cand = np.minimum(closest, _sq_distances(X[cand], X, x_sq))
    pots = d_cand @ w.reshape(-1, 1)
    centers[1] = X[cand[np.argmin(pots)]]
    return centers


def _labels(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    d = _row_norms_sq(centers)[None, :] - 2.0 * (X @ centers.T)
    return np.argmin(d, axis=1).astype(np.int32)


def _update_centers(X, centers_old, labels):
    """One M step: sums per label, empty clusters relocated, then scaled
    by the reciprocal weight."""
    k = centers_old.shape[0]
    onehot = (labels[None, :] == np.arange(k)[:, None]).astype(X.dtype)
    sums = onehot @ X  # a product, not a gather: X may be [17K, 3.4K]
    weight = onehot.sum(axis=1)
    empty = np.nonzero(weight == 0)[0]
    if len(empty):
        dist = ((X - centers_old[labels]) ** 2).sum(axis=1)
        far = np.argpartition(dist, -len(empty))[: -len(empty) - 1 : -1]
        if dist.max() != 0:
            for new, idx in zip(empty, far):
                old = labels[idx]
                sums[old] -= X[idx]
                sums[new] = X[idx]
                weight[new] = 1.0
                weight[old] -= 1.0
    # in sklearn's order: an empty cluster copies the biggest one's row as
    # it stands at that point of the loop
    biggest = int(np.argmax(weight))
    for j in range(k):
        if weight[j] > 0:
            sums[j] *= 1.0 / weight[j]
        else:
            sums[j] = sums[biggest]
    return sums


def _lloyd(X: np.ndarray, centers: np.ndarray, tol: float):
    labels_old = np.full(X.shape[0], -1, dtype=np.int32)
    strict = False
    for _ in range(_MAX_ITER):
        profiling.count(ITERATIONS)
        labels = _labels(X, centers)
        new = _update_centers(X, centers, labels)
        shift = np.sqrt(((new - centers) ** 2).sum(axis=1))
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if (shift ** 2).sum() <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _labels(X, centers)
    inertia = float(((X - centers[labels]) ** 2).sum())
    return labels, inertia, centers


def _same_clustering(a: np.ndarray, b: np.ndarray) -> bool:
    mapping = {}
    for x, y in zip(a.tolist(), b.tolist()):
        if mapping.setdefault(x, y) != y:
            return False
    return True


def _kmeans2_host(X, seed: int, n_init: int) -> Tuple[np.ndarray, np.ndarray]:
    """:func:`kmeans2` in numpy: the centres and the chosen init's labels."""
    X = np.array(X, dtype=np.float64, order="C")
    if X.ndim != 2 or X.shape[0] < 2:
        raise ValueError(f"k-means of 2 centres needs at least 2 rows, got {X.shape}")
    tol = float(np.mean(np.var(X, axis=0)) * _TOL)
    mean = X.mean(axis=0)
    X -= mean
    x_sq = _row_norms_sq(X)
    rs = np.random.RandomState(seed)
    best = None
    for _ in range(n_init):
        labels, inertia, centers = _lloyd(X, _plusplus(X, x_sq, rs), tol)
        if best is None or (inertia < best[1] and not _same_clustering(labels, best[0])):
            best = (labels, inertia, centers)
    return best[2] + mean, best[0]


def kmeans2(X, seed: int, n_init: int):
    """The HMM's starting means and covariances of ``X`` [n, D]: sklearn's
    ``KMeans(n_clusters=2, random_state=seed,
    n_init=n_init).fit(X).cluster_centers_`` and :func:`diag_covars` of
    ``X``, float64 [2, D] each.  Numpy arrays for an array or a CPU tensor;
    tensors on the card for a CUDA tensor (the kernels of
    ``csrc/kmeans.cu``, the covariances from the fit's own column
    statistics; no fallback to the host)."""
    if isinstance(X, torch.Tensor):
        if X.device.type != "cpu":
            centers, _, covars = _kmeans2_card(X, seed, n_init)
            return centers, covars
        X = X.numpy()
    return _kmeans2_host(X, seed, n_init)[0], diag_covars(X)


def diag_covars(X):
    """``diag(np.cov(X.T)) + MIN_COVAR``, clamped at ``MIN_COVAR``, tiled
    for both states: float64 [2, D], of an array or a CPU tensor (only the
    diagonal is computed).  On the card :func:`kmeans2` computes it in the
    fit's column statistics."""
    if isinstance(X, torch.Tensor):
        if X.device.type != "cpu":
            raise ValueError(f"diag_covars runs on the host, not {X.device}: a card's "
                             "covariances come from kmeans2")
        X = X.numpy()
    X = np.asarray(X, dtype=np.float64)
    centred = X - X.mean(axis=0)
    var = np.einsum("ij,ij->j", centred, centred) * (1.0 / (X.shape[0] - 1))
    return np.maximum(np.tile(var + MIN_COVAR, (2, 1)), MIN_COVAR)


# --- on the card ----------------------------------------------------------

# rows of one block of a row kernel, at most: csrc/kmeans.cu's kMaxRows
_MAX_ROWS = 2048
_WARPS = 16  # csrc/kmeans.cu's kWarps: warps of a row kernel's block
_COUNTS = 6  # csrc/kmeans.cu's kCounts
_TILE_STATS = 5  # csrc/kmeans.cu's kTileStats
_LOCAL_TRIALS = 2 + int(np.log(2))  # _plusplus' candidates an init


def plusplus_draws(seed: int, n: int, n_init: int) -> List[Tuple[int, np.ndarray]]:
    """Every init's k-means++ draws from ``RandomState(seed)``, in the order
    :func:`_plusplus` makes them: the first centre's row (``choice(n,
    p=w / w.sum())``) and the candidates' ``uniform`` values.  None of them
    depends on the data, so the card's fit draws them first."""
    rs = np.random.RandomState(seed)
    w = np.ones(n, dtype=np.float64)
    return [(int(rs.choice(n, p=w / w.sum())), rs.uniform(size=_LOCAL_TRIALS))
            for _ in range(n_init)]


def block_rows(n: int, sms: int) -> int:
    """Rows of one block of the row kernels: about two blocks an SM, at
    least a row a warp, at most ``_MAX_ROWS`` (the labels a block keeps in
    shared memory)."""
    blocks = max(1, min(2 * sms, -(-n // _WARPS)))
    return min(-(-n // blocks), _MAX_ROWS)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(X: torch.Tensor, rows: int) -> None:
    if X.device.type != "cuda":
        raise ValueError(f"k-means runs on cuda or on the host, not {X.device}")
    if X.dtype != torch.float64 or X.dim() != 2 or not X.is_contiguous():
        raise ValueError("k-means on the card takes a contiguous float64 [n, d] tensor")
    if not rows <= X.shape[0] < 2**31 or not 1 <= X.shape[1] < 2**31:
        raise ValueError(f"k-means of 2 centres needs at least {rows} rows, got "
                         f"{tuple(X.shape)}")


def _launch(name: str, *args) -> None:
    """One kernel of ``csrc/kmeans.cu`` (pointers as ints, the stream last),
    counted in ``hmm_kernels.LAUNCHES``."""
    err = getattr(_build.library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    hmm_kernels.LAUNCHES[name] += 1


def _carve(flat: torch.Tensor, shapes) -> List[torch.Tensor]:
    """Consecutive views of ``flat`` shaped ``shapes``."""
    sizes = [math.prod(shape) for shape in shapes]
    return [part.view(shape) for part, shape in zip(flat.split(sizes), shapes)]


class CardFit:
    """One k-means fit of a CUDA tensor ``X`` [n, d]: its workspace on the
    card, and the steps of :func:`_kmeans2_card` as methods (the tests drive
    :meth:`lloyd` from chosen centres).  Every launch goes to the current
    stream of ``X``'s card, which must be the current card; the host waits
    only on its pinned readbacks.  ``C`` and ``cn`` hold two sets of
    centres and their squared norms, ``L`` two label vectors: a Lloyd step
    reads one and writes the other.  What the fit returns, the best
    centres and the covariances, has a buffer of its own, so that the
    scratch is freed with the fit."""

    def __init__(self, X: torch.Tensor):
        self.X = X
        self.n, self.d = n, d = X.shape
        self.rows = block_rows(n, _sm_count(X.device.index))
        self.nb = nb = -(-n // self.rows)
        self.stream = torch.cuda.current_stream(X.device)
        shapes = [(n, d), (d,), (d,), (n,), (n,), (nb, 2), (2, 2, d), (2, 2), (nb, 2, d), (nb,),
                  (-(-d // 32), _TILE_STATS), (5,), (1,)]
        (self.Xc, self.mean, self.var0, self.x_sq, self.closest, self.part_pots, self.C, self.cn,
         self.part_sums, self.part_inertia, self.tile_part, self.status,
         self.best_inertia) = _carve(torch.empty(sum(map(math.prod, shapes)),
                                                 dtype=torch.float64, device=X.device), shapes)
        self.best_centers, self.covars = torch.empty((4, d), dtype=torch.float64,
                                                     device=X.device).split(2)
        # zeros: the fold's ticket starts at 0 (and leaves it so)
        self.L, self.part_counts, self.best_labels, self.ticket = _carve(
            torch.zeros(2 * n + nb * _COUNTS + n + 1, dtype=torch.int32, device=X.device),
            [(2, n), (nb, _COUNTS), (n,), (1,)])
        pinned = torch.empty(n + 5, dtype=torch.float64, pin_memory=True)
        self.closest_h, self.status_h = pinned[:n], pinned[n:]
        # the kernels' arguments: pointers as ints
        self.ptr = {name: getattr(self, name).data_ptr() for name in (
            "X", "Xc", "mean", "var0", "x_sq", "closest", "part_pots", "part_sums",
            "part_inertia", "tile_part", "status", "best_inertia", "best_centers", "covars",
            "part_counts", "best_labels", "ticket")}
        self.C_ptr = [c.data_ptr() for c in self.C]
        self.cn_ptr = [c.data_ptr() for c in self.cn]
        self.L_ptr = [lab.data_ptr() for lab in self.L]

    def _read(self, t: torch.Tensor, into: torch.Tensor) -> np.ndarray:
        """``t`` copied into its pinned host view ``into``, once the stream
        has run to it."""
        into.copy_(t, non_blocking=True)
        self.stream.synchronize()
        return into.numpy()

    def prepare(self) -> None:
        """The column statistics (and :func:`diag_covars` into ``covars``),
        then the centred rows and their norms."""
        p, n, d = self.ptr, self.n, self.d
        stream = self.stream.cuda_stream
        _launch("kmeans_col_stats", p["X"], n, d, p["mean"], p["var0"], p["covars"], stream)
        _launch("kmeans_center", p["X"], p["mean"], n, d, self.rows, p["Xc"], p["x_sq"], stream)

    def seed(self, first: int, rand: np.ndarray) -> None:
        """:func:`_plusplus` from its draws: the two starting centres into
        ``C[0]``, their squared norms into ``cn[0]``."""
        p, n, d = self.ptr, self.n, self.d
        stream = self.stream.cuda_stream
        _launch("kmeans_seed_closest", p["Xc"], p["x_sq"], n, d, self.rows, first, p["closest"],
                stream)
        closest = self._read(self.closest, self.closest_h)[None, :]
        c0, c1 = (int(c) for c in _candidates(closest, np.ones(n), rand))
        _launch("kmeans_seed_pots", p["Xc"], p["x_sq"], p["closest"], n, d, self.rows, c0, c1,
                p["part_pots"], stream)
        _launch("kmeans_seed_pick", p["Xc"], p["x_sq"], p["part_pots"], self.nb, d, first, c0, c1,
                self.C_ptr[0], self.cn_ptr[0], stream)

    def _step(self, cur: int, labels_in: Optional[int], out: int, relabel: bool,
              best: Optional[int] = None) -> None:
        p = self.ptr
        _launch("kmeans_step", p["Xc"], self.n, self.d, self.rows, self.C_ptr[cur],
                self.cn_ptr[cur], None if labels_in is None else self.L_ptr[labels_in],
                self.L_ptr[out], int(relabel), best, p["part_sums"], p["part_inertia"],
                p["part_counts"], self.stream.cuda_stream)

    def lloyd(self, best: Optional[int] = None) -> Tuple[int, int]:
        """:func:`_lloyd` from ``C[0]``: its iterations, then the last pass
        (relabelled unless the labels repeated) with the inertia and, where
        the pointer ``best`` to the best init's labels is given, the pairs
        against them.  Returns the final centres' and labels' slots in
        ``C`` and ``L``."""
        p = self.ptr
        cur, out, labels_in, strict = 0, 0, None, False
        for _ in range(_MAX_ITER):
            profiling.count(ITERATIONS)
            self._step(cur, labels_in, out, relabel=True)
            _launch("kmeans_fold", p["part_sums"], p["part_counts"], self.nb, self.n, self.d,
                    self.C_ptr[cur], p["var0"], self.C_ptr[1 - cur], self.cn_ptr[1 - cur],
                    p["tile_part"], p["ticket"], p["status"], self.stream.cuda_stream)
            shift2, tol, w0, w1, changed = self._read(self.status, self.status_h).tolist()
            if w0 == 0 or w1 == 0:
                shift2 = self._relocate(cur, out, [w0, w1])
            cur = 1 - cur
            if changed == 0:
                strict = True
                break
            if shift2 <= tol:
                break
            labels_in, out = out, 1 - out
        self._step(cur, out, out, relabel=not strict, best=best)
        return cur, out

    def _relocate(self, old: int, out: int, weight: List[float]) -> float:
        """:func:`_update_centers` where a cluster is empty, in plain torch
        on the card (k-means++ starts from two distinct rows, so this is
        rare): the farthest row from its centre (the first of equals, where
        numpy's ``argpartition`` takes any) moves to the empty cluster.
        Rewrites ``C[1 - old]`` and ``cn[1 - old]``; returns the squared
        shift."""
        X, centers = self.Xc, self.C[old]
        labels = self.L[out].long()
        onehot = (labels[None, :] == torch.arange(2, device=X.device)[:, None]).to(X.dtype)
        sums = onehot @ X
        dist = ((X - centers[labels]) ** 2).sum(dim=1)
        far, top = transfer.to_host([torch.argmax(dist), dist.max()])
        far, top = int(far), float(top)
        if top != 0:
            for j in (j for j in range(2) if weight[j] == 0):
                # every row is in the other cluster
                sums[1 - j] -= X[far]
                sums[j] = X[far]
                weight[j] = 1.0
                weight[1 - j] -= 1.0
        biggest = int(np.argmax(weight))
        for j in range(2):
            if weight[j] > 0:
                sums[j] *= 1.0 / weight[j]
            else:
                sums[j] = sums[biggest]
        self.C[1 - old].copy_(sums)
        self.cn[1 - old].copy_(torch.einsum("ij,ij->i", sums, sums))
        shift = torch.sqrt(((sums - centers) ** 2).sum(dim=1))
        return float(transfer.to_host([(shift ** 2).sum()])[0])

    def choose(self, cur: int, out: int, first_init: bool) -> None:
        """kmeans2's rule on the last pass: this init's centres plus the
        mean, labels and inertia become the best, or not."""
        p = self.ptr
        _launch("kmeans_choose", p["part_inertia"], p["part_counts"], self.nb, self.n, self.d,
                int(first_init), self.C_ptr[cur], p["mean"], self.L_ptr[out], p["best_centers"],
                p["best_labels"], p["best_inertia"], self.stream.cuda_stream)


def _kmeans2_card(X: torch.Tensor, seed: int,
                  n_init: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`_kmeans2_host` on the card: the centres [2, d], the chosen
    init's labels [n] (int32) and :func:`diag_covars` [2, d], on ``X``'s
    card."""
    _check(X, rows=2)
    with torch.cuda.device(X.device):
        fit = CardFit(X)
        fit.prepare()
        for k, (first, rand) in enumerate(plusplus_draws(seed, fit.n, n_init)):
            fit.seed(first, rand)
            cur, out = fit.lloyd(best=None if k == 0 else fit.ptr["best_labels"])
            fit.choose(cur, out, first_init=k == 0)
        return fit.best_centers, fit.best_labels, fit.covars
