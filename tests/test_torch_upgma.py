"""UPGMA's linkage and leaf order, and the exact mode's host rank matrix,
against scipy and numpy.

``ops/linkage.nn_chain_plain`` is the walk of ``csrc/upgma.cu`` in numpy
(distances in a symmetric matrix, +inf on the diagonal and in each
merged-away cluster's column): it must give scipy's ``average`` bit for
bit, ties included.  ``cluster/upgma.leaf_order`` must give scipy's
dendrogram leaves (``count_sort='ascending'``), and
``ops/matrix.rank_rows_desc_host`` numpy's argsort rows reversed.  The
kernel itself runs in ``test_torch_gpu.py``.
"""

import numpy as np
import pytest
import scipy.cluster.hierarchy as sch
import scipy.spatial.distance as ssd

from hic_genome_assembler_tpu_torch.cluster import upgma
from hic_genome_assembler_tpu_torch.ops import linkage, matrix, oracle


def _distances(n, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":  # few distinct values: equal distances everywhere
        return rng.integers(1, 5, (n, n)).astype(np.float64) / 4 + 1
    if kind == "transform":  # the pipeline's own distances, asymmetric
        counts = rng.poisson(3.0, (n, n)).astype(np.float64) + np.eye(n)
        return oracle.to_distance(counts)
    return rng.random((n, n)) + 1.0


@pytest.mark.parametrize("n", [2, 3, 5, 64, 301])
@pytest.mark.parametrize("kind", ["random", "ties", "transform"])
def test_nn_chain_model_equals_scipy_average(n, kind):
    d = _distances(n, n, kind)
    want = sch.average(ssd.squareform(d, checks=False))
    got = linkage.nn_chain_plain(d)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [2, 3, 17, 250])
@pytest.mark.parametrize("kind", ["random", "ties", "transform"])
def test_leaf_order_equals_scipy_dendrogram(n, kind):
    Z = sch.average(ssd.squareform(_distances(n, n + 1, kind), checks=False))
    want = sch.dendrogram(Z, no_plot=True, get_leaves=True, count_sort="ascending")["leaves"]
    assert upgma.leaf_order(Z) == want


def test_leaf_order_puts_the_smaller_child_first_and_keeps_column_order_on_ties():
    # leaves 0-3: (0, 1) -> 4, (2, 4) -> 5 of 3 observations, (3, 5) -> 6
    Z = np.array([[0, 1, 1.0, 2], [2, 4, 2.0, 3], [3, 5, 3.0, 4]], dtype=np.float64)
    assert upgma.leaf_order(Z) == [3, 2, 0, 1]
    Z[1] = [4, 2, 2.0, 3]  # the two-leaf cluster is listed first but is larger
    assert upgma.leaf_order(Z) == [3, 2, 0, 1]
    # (0, 1) -> 4 and (2, 3) -> 5, two observations each: column 0 first
    Z = np.array([[0, 1, 1.0, 2], [2, 3, 1.5, 2], [4, 5, 3.0, 4]], dtype=np.float64)
    want = sch.dendrogram(Z, no_plot=True, get_leaves=True, count_sort="ascending")["leaves"]
    assert upgma.leaf_order(Z) == want == [0, 1, 2, 3]


def test_host_leaf_order_equals_scipys_on_the_pipelines_distances():
    d = _distances(120, 7, "transform")
    labels = [f"chr_{i}" for i in range(120)]
    got = upgma.average_cluster_leaf_order(d, labels)
    Z = sch.average(ssd.squareform(d, checks=False))
    want = sch.dendrogram(Z, labels=labels, no_plot=True, get_leaves=True,
                          count_sort="ascending")
    assert got == {"ivl": want["ivl"], "leaves": want["leaves"]}


def test_label_renames_merges_as_scipy_does():
    # merges in the order made, by cluster index, as the chain reports them
    d = _distances(40, 3, "ties")
    Z = sch.average(ssd.squareform(d, checks=False))
    again = linkage._label(Z.copy(), 40)
    np.testing.assert_array_equal(again, Z)


def test_card_linkage_refuses_the_host():
    with pytest.raises(ValueError, match="runs on cuda"):
        linkage.average_linkage(np.ones((3, 3)), "cpu")


def _rank_input(n, seed):
    rng = np.random.default_rng(seed)
    m = rng.choice(np.array([0.0, 1.5, 2.25, 1e-7, 3.0]), (n, n))
    m[:, ::7] = 0.0
    m[min(3, n - 1)] = rng.random(n)
    return m


@pytest.mark.parametrize("n", [1, 9, 300])
def test_host_rank_rows_equal_numpy_argsort_reversed(n):
    m = _rank_input(n, n)
    got = matrix.rank_rows_desc_host(m)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, np.argsort(m, axis=1)[:, ::-1])
    np.testing.assert_array_equal(got, oracle.rank_matrix_desc(m))


@pytest.mark.parametrize("workers", [2, 5])
def test_host_rank_rows_from_threads_equal_the_serial_rows(monkeypatch, workers):
    monkeypatch.setattr(matrix, "_RANK_THREADED", 0)
    monkeypatch.setattr(matrix.os, "cpu_count", lambda: workers)
    m = _rank_input(211, workers)
    got = matrix.rank_rows_desc_host(m)
    np.testing.assert_array_equal(got, np.argsort(m, axis=1)[:, ::-1])


def test_host_rank_rows_are_int32_where_int16_cannot_hold_them(monkeypatch):
    monkeypatch.setattr(matrix, "INT16_LIMIT", 10)
    m = _rank_input(12, 1)
    got = matrix.rank_rows_desc_host(m)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, np.argsort(m, axis=1)[:, ::-1])
