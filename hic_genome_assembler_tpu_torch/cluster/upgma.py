"""UPGMA clustering + dendrogram leaf order.

The distance transform feeding this lives in ops.oracle.to_distance
(host f64, the default "exact" parity mode) or ops.matrix.to_distance
(device, matrixMode=device); the linkage itself is O(N^2)
scalar-sequential with scipy-specific merge bookkeeping that the
grouping-parity target requires bit-identically (SURVEY.md §7 "hard
parts"), so linkage and leaf ordering run through scipy's C
implementation on the precomputed distances — exactly the calls the
reference makes (averageClusterNodes, scaffoldToChromosomes.py:187-208).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import scipy.cluster.hierarchy
import scipy.spatial.distance


def average_cluster_leaf_order(
    distance_matrix: np.ndarray, labels: Sequence[str]
) -> Dict[str, list]:
    """UPGMA over the (possibly asymmetric) distance matrix's upper
    triangle; leaf order via count_sort='ascending'.

    Returns {'ivl': [...], 'leaves': [...]} like scipy's dendrogram.
    """
    condensed = scipy.spatial.distance.squareform(
        np.asarray(distance_matrix, dtype=np.float64), checks=False
    )
    linkage = scipy.cluster.hierarchy.average(condensed)
    dendro = scipy.cluster.hierarchy.dendrogram(
        linkage,
        labels=list(labels),
        leaf_rotation=90,
        no_plot=True,
        get_leaves=True,
        count_sort="ascending",
    )
    return {"ivl": dendro["ivl"], "leaves": dendro["leaves"]}
