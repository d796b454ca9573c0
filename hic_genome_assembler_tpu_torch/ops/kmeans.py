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
"""

from __future__ import annotations

import numpy as np

MIN_COVAR = 1e-3
_MAX_ITER = 300
_TOL = 1e-4


def _row_norms_sq(X: np.ndarray) -> np.ndarray:
    return np.einsum("ij,ij->i", X, X)


def _sq_distances(C: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """``|c|^2 - 2 c.x + |x|^2`` clipped at 0: [len(C), len(X)]."""
    d = -2 * (C @ X.T)
    d += _row_norms_sq(C)[:, None]
    d += x_sq[None, :]
    return np.maximum(d, 0)


def _plusplus(X: np.ndarray, x_sq: np.ndarray, rs: np.random.RandomState) -> np.ndarray:
    n = X.shape[0]
    w = np.ones(n, dtype=X.dtype)
    n_local_trials = 2 + int(np.log(2))
    centers = np.empty((2, X.shape[1]), dtype=X.dtype)
    centers[0] = X[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[0:1], X, x_sq)
    pot = closest @ w
    rand_vals = rs.uniform(size=n_local_trials) * pot
    cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
    np.clip(cand, None, closest.size - 1, out=cand)
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


def kmeans2(X, seed: int, n_init: int) -> np.ndarray:
    """sklearn's ``KMeans(n_clusters=2, random_state=seed,
    n_init=n_init).fit(X).cluster_centers_``: float64 [2, D]."""
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
    return best[2] + mean


def diag_covars(X) -> np.ndarray:
    """``diag(np.cov(X.T)) + MIN_COVAR``, clamped at ``MIN_COVAR``, tiled
    for both states: float64 [2, D].  Only the diagonal is computed."""
    X = np.asarray(X, dtype=np.float64)
    centred = X - X.mean(axis=0)
    var = np.einsum("ij,ij->j", centred, centred) * (1.0 / (X.shape[0] - 1))
    return np.maximum(np.tile(var + MIN_COVAR, (2, 1)), MIN_COVAR)
