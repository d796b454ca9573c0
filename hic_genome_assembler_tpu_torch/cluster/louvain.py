"""Louvain modularity maximization over dense weighted graphs.

Replaces the reference's python-louvain dependency
(community.best_partition, scaffoldToChromosomes.py:239-349).  The
reference builds a COMPLETE networkx graph (self-loops included) over
the matrix tail and runs unseeded randomized Louvain rounds — making its
output nondeterministic run-to-run (SURVEY.md §4).  This implementation
is a conscious deviation: seeded randomized node orders, dense-matrix
arithmetic (no graph object), deterministic tie-breaking — same
objective, reproducible results.

Weight conventions match networkx/python-louvain for graphs with
self-loops: a self-loop of weight w contributes w to the edge total m
and 2w to its node's degree.  Internally the matrix is symmetrized with
a doubled diagonal (A~), giving k = A~.sum(1), 2m = k.sum(), and
Q = sum_{ij in same community} (A~_ij - k_i k_j / 2m) / 2m.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

_MIN_GAIN = 1e-7


def _prep(adj: np.ndarray) -> Tuple[np.ndarray, np.ndarray, float]:
    a = np.asarray(adj, dtype=np.float64)
    a_tilde = a + np.diag(np.diag(a))
    k = a_tilde.sum(axis=1)
    two_m = float(k.sum())
    return a_tilde, k, two_m


def modularity(partition: np.ndarray, adj: np.ndarray) -> float:
    """Newman modularity of a labeling over the dense weighted graph."""
    a_tilde, k, two_m = _prep(adj)
    if two_m == 0:
        return 0.0
    labels = np.unique(partition)
    q = 0.0
    for c in labels:
        mask = partition == c
        q += a_tilde[np.ix_(mask, mask)].sum() / two_m
        q -= (k[mask].sum() / two_m) ** 2
    return q


def _one_level_numpy(
    a_tilde: np.ndarray, k: np.ndarray, two_m: float, rng
) -> np.ndarray:
    """One Louvain level: local moves until no gain (numpy oracle form).

    Per visit the link-to-community weights are rebuilt with
    ``np.bincount`` and the gain vector evaluated with numpy ops; the
    production path (:func:`_one_level`) runs the native sweep kernel,
    which reproduces this op sequence bit-for-bit — a seeded battery
    asserts identical partitions (tests/test_hmm_louvain_oracle.py)."""
    n = a_tilde.shape[0]
    comm = np.arange(n)
    sigma_tot = k.copy()  # per-community degree sums
    improved = True
    while improved:
        improved = False
        for node in rng.permutation(n):
            c_old = comm[node]
            row = a_tilde[node]
            # weight from node to each community (self-loop excluded from
            # neighbor weights, as in python-louvain's neigh_communities)
            link = np.bincount(comm, weights=row, minlength=n)
            link[comm[node]] -= row[node]
            sigma_tot[c_old] -= k[node]
            base = link[c_old] - sigma_tot[c_old] * k[node] / two_m if two_m else 0.0
            gains = link - sigma_tot * k[node] / two_m if two_m else link
            gains[c_old] = base
            best = int(np.argmax(gains))  # lowest community id wins ties
            if gains[best] - base > _MIN_GAIN:
                comm[node] = best
                improved = True
            else:
                comm[node] = c_old
            sigma_tot[comm[node]] += k[node]
    return comm


def _one_level(a_tilde: np.ndarray, k: np.ndarray, two_m: float, rng) -> np.ndarray:
    """One Louvain level: local moves until no gain (production path).

    Dispatches each sweep to the native kernel
    (native/louvain_sweep.cpp): a fused scan+gain+argmax C loop that
    reproduces the numpy oracle's per-element IEEE op sequence exactly
    (scatter-add link accumulation in index order, multiply/divide/
    subtract gain form, first-max argmax), so partitions are
    bit-identical to :func:`_one_level_numpy` while removing the
    ~60 us/visit of numpy dispatch overhead and per-visit allocations —
    this is what bounds pure-modularity mode (min_frac==1,
    scaffoldToChromosomes.py:541-544 semantics) at 16K
    (BENCHMARKS.md round 4).

    Design note vs SURVEY §2b's "modularity gains as device matvecs":
    the sweep is inherently sequential — every accepted move changes
    the comm/sigma state the next visit reads — so a device port pays
    one dispatch round trip per VISIT (latency-bound at any scale),
    and a batched Link-matrix formulation (update two columns per
    accepted move) was measured 7x SLOWER at 8K than the scatter form:
    column axpy on a row-major matrix misses cache per element while
    bincount's scatter target (the few live communities) stays in L1.
    The conscious deviation, per SURVEY §7's document-either-way rule:
    gains stay host-side, in native code.
    """
    from hic_genome_assembler_tpu_torch.io import native

    n = a_tilde.shape[0]
    if not native.available():
        return _one_level_numpy(a_tilde, k, two_m, rng)
    comm = np.arange(n, dtype=np.int64)
    sigma_tot = np.ascontiguousarray(k, dtype=np.float64).copy()
    a_c = np.ascontiguousarray(a_tilde, dtype=np.float64)
    k_c = np.ascontiguousarray(k, dtype=np.float64)
    scratch = np.empty(n, dtype=np.float64)
    while native.louvain_sweep_f64(
        a_c, k_c, float(two_m), comm, sigma_tot,
        rng.permutation(n).astype(np.int64), scratch, _MIN_GAIN
    ):
        pass
    return comm


def _aggregate(a_tilde: np.ndarray, comm: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Collapse communities into supernodes; returns (new adj~, relabel)."""
    labels, relabel = np.unique(comm, return_inverse=True)
    m = len(labels)
    one_hot = np.zeros((len(comm), m))
    one_hot[np.arange(len(comm)), relabel] = 1.0
    collapsed = one_hot.T @ a_tilde @ one_hot
    return collapsed, relabel


def best_partition(adj: np.ndarray, seed: int = 0) -> Dict[int, int]:
    """Full multi-level Louvain; returns {node_index: community}."""
    rng = np.random.default_rng(seed)
    a = np.asarray(adj, dtype=np.float64)
    n = a.shape[0]
    mapping = np.arange(n)
    a_tilde, k, two_m = _prep(a)
    level_adj = a_tilde
    while True:
        comm = _one_level(level_adj, level_adj.sum(axis=1), float(level_adj.sum()), rng)
        collapsed, relabel = _aggregate(level_adj, comm)
        # relabel[i] = dense supernode id of current-level node i
        mapping = relabel[mapping]
        if collapsed.shape[0] == level_adj.shape[0]:
            break
        level_adj = collapsed
    # normalize community ids to dense 0..K-1 in first-seen node order,
    # matching python-louvain's renumbering
    seen: Dict[int, int] = {}
    out: Dict[int, int] = {}
    for node in range(n):
        c = int(mapping[node])
        if c not in seen:
            seen[c] = len(seen)
        out[node] = seen[c]
    return out


def modularity_rounds(
    adj: np.ndarray, louvain_rounds: int = 1, seed: int = 0
) -> Tuple[Dict[int, int], float]:
    """Best of N seeded rounds (modularity_rounds,
    scaffoldToChromosomes.py:239-261)."""
    best_score = -2.0
    best: Dict[int, int] = {}
    for i in range(louvain_rounds):
        part = best_partition(adj, seed=seed + i)
        labels = np.asarray([part[j] for j in range(adj.shape[0])])
        score = modularity(labels, adj)
        if score > best_score:
            prev = best_score
            best_score = score
            best = part
            print(
                "Previous best modularity score {}, Current best found {}, "
                "Louvain round {}".format(prev, score, i + 1)
            )
    return best, best_score
