"""UPGMA clustering + dendrogram leaf order.

The distance transform feeding this lives in ops.oracle.to_distance
(host f64, the default "exact" parity mode) or ops.matrix.to_distance
(device, matrixMode=device); the linkage itself is O(N^2)
scalar-sequential with scipy-specific merge bookkeeping that the
grouping-parity target requires bit-identically (SURVEY.md §7 "hard
parts"): on the host the linkage runs through scipy's C implementation on
the precomputed distances — exactly the call the reference makes
(averageClusterNodes, scaffoldToChromosomes.py:187-208) — and on a CUDA
device through ``ops/linkage.py``, which follows scipy's nearest-neighbour
chain step for step with the same float64 operations.  The leaf order is
scipy's dendrogram's (``count_sort='ascending'``), walked by
:func:`leaf_order` without the dendrogram's plotting bookkeeping.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import scipy.cluster.hierarchy
import scipy.spatial.distance
import torch


def leaf_order(linkage: np.ndarray) -> List[int]:
    """The leaves of ``scipy.cluster.hierarchy.dendrogram(linkage,
    count_sort='ascending')``: from the root down, of a node's two
    children (columns 0 and 1 of its row) the one with fewer observations
    first, column 0 first on equal counts."""
    Z = np.asarray(linkage, dtype=np.float64)
    n = Z.shape[0] + 1
    leaves: List[int] = []
    stack = [2 * n - 2]
    while stack:
        node = stack.pop()
        if node < n:
            leaves.append(node)
            continue
        a, b = int(Z[node - n, 0]), int(Z[node - n, 1])
        na = Z[a - n, 3] if a >= n else 1.0
        nb = Z[b - n, 3] if b >= n else 1.0
        if na > nb:
            a, b = b, a
        stack.append(b)
        stack.append(a)
    return leaves


def average_cluster_leaf_order(
    distance_matrix: np.ndarray,
    labels: Sequence[str],
    device: Optional[torch.device] = None,
) -> Dict[str, list]:
    """UPGMA over the (possibly asymmetric) distance matrix's upper
    triangle; leaf order via count_sort='ascending'.  ``device`` (CUDA)
    runs the linkage on the card (``ops/linkage.average_linkage``), with
    scipy's bits; else scipy's ``average`` runs on the host.

    Returns {'ivl': [...], 'leaves': [...]} like scipy's dendrogram.
    """
    distance_matrix = np.asarray(distance_matrix, dtype=np.float64)
    if device is not None and torch.device(device).type == "cuda" and len(distance_matrix) > 1:
        from hic_genome_assembler_tpu_torch.ops import linkage as card_linkage

        linkage = card_linkage.average_linkage(distance_matrix, torch.device(device))
    else:
        condensed = scipy.spatial.distance.squareform(distance_matrix, checks=False)
        linkage = scipy.cluster.hierarchy.average(condensed)
    labels = list(labels)
    leaves = leaf_order(linkage)
    return {"ivl": [labels[i] for i in leaves], "leaves": leaves}
