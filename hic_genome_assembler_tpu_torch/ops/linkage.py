"""UPGMA's linkage on the card: ``scipy.cluster.hierarchy.average`` with
scipy's bits.

scipy builds the average linkage with its nearest-neighbour chain
(``_hierarchy.nn_chain``): grow a chain of clusters, each the nearest
active cluster to the one before (the earliest index among equal
distances, the chain's previous cluster kept on a tie with it), until the
last two are each other's nearest; merge them into the larger index,
whose distance to every other active cluster ``i`` becomes
``(n_x * d(x, i) + n_y * d(y, i)) / (n_x + n_y)``; and again, until one
cluster is left.  The merges are then sorted by distance (stable) and
relabelled with a union-find.  ``csrc/upgma.cu`` runs the chain and the
merges (:func:`average_linkage`); the sort and the relabelling, O(N log N),
stay on the host.  :func:`nn_chain_plain` is the same walk in numpy, the
model the tier-1 tests hold to scipy; scipy itself is the plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.utils import transfer

# Kernel launches made here (held by the card's tests to one a linkage).
LAUNCHES = {"upgma_linkage": 0}


def _label(Z: np.ndarray, n: int) -> np.ndarray:
    """scipy's ``_hierarchy.label``: each merge's two clusters renamed by
    their union-find roots (smaller first), and its size recomputed."""
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, dtype=np.int64)

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:
            parent[a], a = root, parent[a]
        return root

    for k in range(n - 1):
        x, y = find(int(Z[k, 0])), find(int(Z[k, 1]))
        Z[k, 0], Z[k, 1] = (x, y) if x < y else (y, x)
        parent[x] = parent[y] = n + k
        size[n + k] = size[x] + size[y]
        Z[k, 3] = size[n + k]
    return Z


def _finish(zx, zy, zd, zs, n: int) -> np.ndarray:
    """The chain's merges in the order made, as scipy returns them: sorted
    by distance (stable) and relabelled."""
    Z = np.column_stack([np.asarray(zx, np.float64), np.asarray(zy, np.float64),
                         np.asarray(zd, np.float64), np.asarray(zs, np.float64)])
    return _label(Z[np.argsort(Z[:, 2], kind="mergesort")], n)


def nn_chain_plain(distance: np.ndarray) -> np.ndarray:
    """The kernel's walk in numpy on the upper triangle of ``distance``
    [N, N]: distances held in a symmetric matrix whose diagonal and every
    merged-away cluster's column read +inf, so a row's minimum is the
    nearest active cluster.  Equal to ``scipy.cluster.hierarchy.average``
    of the condensed upper triangle for finite distances."""
    n = distance.shape[0]
    W = np.triu(np.asarray(distance, dtype=np.float64), 1)
    W = W + W.T
    np.fill_diagonal(W, np.inf)
    size = np.ones(n, dtype=np.int64)
    zx, zy, zd, zs = [], [], [], []
    chain: list = []
    for _ in range(n - 1):
        if not chain:
            chain = [int(np.flatnonzero(size)[0])]
        while True:
            x = chain[-1]
            y, cur = (chain[-2], W[x, chain[-2]]) if len(chain) > 1 else (-1, np.inf)
            i = int(np.argmin(W[x]))
            if W[x, i] < cur:
                y, cur = i, W[x, i]
            if len(chain) > 1 and y == chain[-2]:
                break
            chain.append(y)
        del chain[-2:]
        x, y = min(x, y), max(x, y)
        nx, ny = size[x], size[y]
        zx.append(x), zy.append(y), zd.append(cur), zs.append(nx + ny)
        size[x], size[y] = 0, nx + ny
        row = (nx * W[x] + ny * W[y]) / (nx + ny)
        row[y] = np.inf
        W[y], W[:, y] = row, row
        W[:, x] = np.inf
    return _finish(zx, zy, zd, zs, n)


def average_linkage(distance: np.ndarray, device: torch.device) -> np.ndarray:
    """``scipy.cluster.hierarchy.average(squareform(distance, checks=False))``
    with ``csrc/upgma.cu`` on the CUDA ``device``: the float64 matrix
    [N, N] goes up through pinned memory, the kernel makes it symmetric
    from its upper triangle and runs scipy's chain on it in place; the
    merges come back for the host's sort and relabelling.  Raises for a
    non-finite distance, as scipy does."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"the card's linkage runs on cuda, not {device}")
    n = int(distance.shape[0])
    if distance.shape != (n, n) or n < 2:
        raise ValueError(f"a distance matrix of shape {distance.shape}: needs N x N, N >= 2")
    W = transfer.to_device(np.ascontiguousarray(distance, dtype=np.float64), device)
    if not bool(torch.isfinite(W).all()):
        raise ValueError("the distance matrix must contain only finite values")
    size = torch.ones(n, dtype=torch.int32, device=device)
    chain = torch.empty(n, dtype=torch.int32, device=device)
    zx = torch.empty(n - 1, dtype=torch.int32, device=device)
    zy = torch.empty_like(zx)
    zs = torch.empty_like(zx)
    zd = torch.empty(n - 1, dtype=torch.float64, device=device)
    from hic_genome_assembler_tpu_torch.ops import _build

    lib = _build.library()
    with torch.cuda.device(device):
        err = lib.upgma_linkage(W.data_ptr(), n, size.data_ptr(), chain.data_ptr(),
                                zx.data_ptr(), zy.data_ptr(), zd.data_ptr(), zs.data_ptr(),
                                torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"upgma_linkage kernel launch failed: cudaError {err}")
    LAUNCHES["upgma_linkage"] += 1
    host = transfer.to_host([zx, zy, zd, zs])
    del W
    return _finish(*host, n)
