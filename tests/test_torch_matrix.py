"""The port's matrix transforms, device-mode ranking and part 1's permute
guard against the JAX package on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hic_genome_assembler_tpu.ops import matrix as jax_matrix
from hic_genome_assembler_tpu_torch.cluster import breakpoints as bp
from hic_genome_assembler_tpu_torch.models import part1_cluster
from hic_genome_assembler_tpu_torch.ops import matrix


def _tied_f32(seed, n=97):
    """f32 rows full of ties: zeros, repeated values, +0.0 and -0.0."""
    rng = np.random.default_rng(seed)
    m = rng.choice(np.array([0.0, -0.0, 1.5, 2.25, 1e-7, 3.0], dtype=np.float32), (n, n))
    m[rng.random((n, n)) < 0.3] = 0.0
    m[:, ::7] = -0.0
    m[5] = 0.0
    m[9] = rng.random(n).astype(np.float32)
    return m


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_matrix_desc_equals_jax_on_ties(seed):
    m = _tied_f32(seed)
    assert (np.signbit(m) & (m == 0)).any() and (~np.signbit(m) & (m == 0)).any()
    got = matrix.rank_matrix_desc(torch.from_numpy(m))
    assert got.dtype == torch.int32
    want = np.asarray(jax_matrix.rank_matrix_desc(jnp.asarray(m)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.argsort(m, axis=1, kind="stable")[:, ::-1])


def test_transforms_equal_jax():
    rng = np.random.default_rng(4)
    counts = rng.poisson(2.0, (40, 40)).astype(np.float64)
    counts = counts + counts.T + np.eye(40)
    t = torch.from_numpy(counts)
    rs = counts.sum(axis=1)
    dist = matrix.to_distance(t)
    np.testing.assert_allclose(dist.numpy(), np.asarray(jax_matrix.to_distance(counts)),
                               rtol=1e-15, atol=0)
    sim = matrix.to_similarity(dist, torch.from_numpy(rs))
    np.testing.assert_allclose(
        sim.numpy(), np.asarray(jax_matrix.to_similarity(np.asarray(dist), rs)), rtol=1e-15,
        atol=1e-12,
    )
    for kw in (dict(), dict(plus_one=False), dict(reverse=True), dict(reverse=True, plus_one=False)):
        src = counts / 10.0 if kw.get("reverse") else counts
        np.testing.assert_allclose(
            matrix.log_transform(torch.from_numpy(src), log_base=10, **kw).numpy(),
            np.asarray(jax_matrix.log_transform(jnp.asarray(src), log_base=10, **kw)),
            rtol=1e-14, atol=0, err_msg=str(kw),
        )
    order = rng.permutation(40)
    np.testing.assert_array_equal(
        matrix.reorder(t, torch.from_numpy(order)).numpy(),
        np.asarray(jax_matrix.reorder(counts, order)),
    )


@pytest.mark.parametrize("host_n", [bp._HOST_N, 0])
def test_rank_counts_takes_a_tensor(monkeypatch, host_n):
    """A rank tensor is padded where it lies (above ``_HOST_N``) or read
    back (below), and counts as the numpy matrix does."""
    monkeypatch.setattr(bp, "_HOST_N", host_n)
    rng = np.random.default_rng(8)
    rank = np.argsort(rng.random((300, 300)), axis=1).astype(np.int32)
    from_tensor = bp.RankCounts(torch.from_numpy(rank), torch.device("cpu"))
    from_numpy = bp.RankCounts(rank, torch.device("cpu"))
    assert from_tensor.where == from_numpy.where == ("host" if host_n else "cpu")
    for s in (0, 7, 150):
        np.testing.assert_array_equal(from_tensor.growing(s), from_numpy.growing(s))
    for s, c in ((0, 5), (17, 240), (240, 17), (3, 299)):
        np.testing.assert_array_equal(from_tensor.fixed(s, c), from_numpy.fixed(s, c))


@pytest.mark.parametrize("bad", [1024, -1, 5000])
def test_permute_guard_raises_before_the_native_path(bad):
    """A 1024 x 1024 f64 matrix takes ``oracle.permute_symmetric``'s native
    path, which does not check bounds; the port's guard raises first."""
    n = 1024
    adj = np.arange(n * n, dtype=np.float64).reshape(n, n)
    order = np.arange(n)[::-1].copy()
    np.testing.assert_array_equal(part1_cluster.permute_checked(adj, order), adj[np.ix_(order, order)])
    order[17] = bad
    with pytest.raises(IndexError, match="outside"):
        part1_cluster.permute_checked(adj, order)
