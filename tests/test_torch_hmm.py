"""The port's HMM branch against the JAX package's, on the CPU in float64.

k-means against scikit-learn (the JAX package's initialiser), the plain
forward-backward and Viterbi loops against the JAX scans, the port's
``GaussianHMM2`` against the JAX class in both modes, and the HMM cut search
against the JAX one.  Inputs are made with numpy from fixed seeds.
"""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.cluster import KMeans

from hic_genome_assembler_tpu.cluster import hmm_cuts as jax_cuts
from hic_genome_assembler_tpu.ops import gaussian_hmm as jax_hmm
from hic_genome_assembler_tpu_torch.cluster import hmm_cuts
from hic_genome_assembler_tpu_torch.ops import gaussian_hmm, hmm_kernels, kmeans
from hic_genome_assembler_tpu_torch.utils import profiling, state
from hmm_signals import SIGNALS, hmm_adjacency, regime_data


@pytest.mark.parametrize("n_init", [2, 10])
@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_kmeans2_equals_sklearn(name, n_init):
    X = SIGNALS[name]
    want = KMeans(n_clusters=2, random_state=0, n_init=n_init).fit(X).cluster_centers_
    got = kmeans.kmeans2(X, 0, n_init)[0]
    # same rows in the same order; only summation order differs
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize("n_init", [2, 10])
@pytest.mark.parametrize("name", ["two_segment_0", "regime_3", "log_similarity_300x40"])
def test_plusplus_draws_are_the_draws_of_every_init(monkeypatch, name, n_init):
    """The card's fit draws every init's k-means++ draws first: the same
    first row and the same ``uniform`` values, in order, as the host's
    fit draws between its inits."""
    X = SIGNALS[name]
    schedule = kmeans.plusplus_draws(7, X.shape[0], n_init)
    made = []

    class Recording(np.random.RandomState):
        def choice(self, *args, **kwargs):
            made.append(("choice", super().choice(*args, **kwargs)))
            return made[-1][1]

        def uniform(self, *args, **kwargs):
            made.append(("uniform", super().uniform(*args, **kwargs)))
            return made[-1][1]

    monkeypatch.setattr(np.random, "RandomState", Recording)
    kmeans.kmeans2(X, 7, n_init)
    assert [kind for kind, _ in made] == ["choice", "uniform"] * n_init
    for (first, rand), (_, got_first), (_, got_rand) in zip(schedule, made[::2], made[1::2]):
        assert first == got_first
        np.testing.assert_array_equal(rand, got_rand)


def test_kmeans_of_a_host_tensor_is_the_numpy_kmeans():
    """A CPU tensor runs the numpy code: the same bits as the array, as
    arrays, and the same Lloyd iterations counted."""
    X = SIGNALS["log_similarity_300x40"]
    profiling.reset()
    want, want_covars = kmeans.kmeans2(X, 0, 2)
    iterations = profiling.counters()[kmeans.ITERATIONS]
    profiling.reset()
    got, got_covars = kmeans.kmeans2(torch.from_numpy(X.copy()), 0, 2)
    assert profiling.counters()[kmeans.ITERATIONS] == iterations >= 2
    profiling.reset()
    assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    assert isinstance(got_covars, np.ndarray) and np.array_equal(got_covars, want_covars)
    np.testing.assert_array_equal(want_covars, kmeans.diag_covars(X))
    covars = kmeans.diag_covars(torch.from_numpy(X))
    assert isinstance(covars, np.ndarray) and np.array_equal(covars, want_covars)


def test_kmeans_refuses_a_device_it_does_not_run_on():
    X = torch.empty((10, 3), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or on the host"):
        kmeans.kmeans2(X, 0, 2)
    with pytest.raises(ValueError, match="runs on the host"):
        kmeans.diag_covars(X)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("n", [2, 16, 17, 209, 3715, 17162, 2048 * 264, 2048 * 264 + 1])
def test_block_rows_cover_every_row(n, sms):
    """The row kernels' blocks: at most ``_MAX_ROWS`` rows, no block empty,
    and no more blocks than two an SM or than a row a warp needs, unless the
    row cap needs them."""
    rows = kmeans.block_rows(n, sms)
    blocks = -(-n // rows)
    assert 1 <= rows <= kmeans._MAX_ROWS and (blocks - 1) * rows < n <= blocks * rows
    assert blocks <= max(min(2 * sms, -(-n // kmeans._WARPS)), -(-n // kmeans._MAX_ROWS))


def test_diag_covars_equals_numpy_cov():
    X = SIGNALS["log_similarity_300x40"]
    want = np.maximum(np.tile(np.diag(np.cov(X.T) + 1e-3 * np.eye(X.shape[1])), (2, 1)), 1e-3)
    np.testing.assert_allclose(kmeans.diag_covars(X), want, rtol=1e-12, atol=0)


def _scan_case(name):
    rng = np.random.default_rng(SCAN_CASES.index(name))
    T = {"short": 2, "three": 3, "mid": 50, "long": 257, "neg_inf": 120, "ties": 64}[name]
    log_b = rng.normal(0.0, 3.0, (T, 2))
    log_trans = np.log(np.array([[0.9, 0.1], [1e-4, 0.9999]]))
    if name == "neg_inf":
        # a transmat entry the M step re-estimated to 0
        with np.errstate(divide="ignore"):
            log_trans = np.log(np.array([[1.0, 0.0], [0.3, 0.7]]))
    if name == "ties":
        log_b[:, 1] = log_b[:, 0]
        log_trans = np.log(np.full((2, 2), 0.5))
    return log_b, np.log(np.array([0.5, 0.5])), log_trans


SCAN_CASES = ["short", "three", "mid", "long", "neg_inf", "ties"]


@pytest.mark.parametrize("name", SCAN_CASES)
def test_forward_backward_plain_equals_jax(name):
    log_b, log_start, log_trans = _scan_case(name)
    want = jax_hmm._forward_backward(
        jnp.asarray(log_b), jnp.asarray(log_start), jnp.asarray(log_trans)
    )
    got = hmm_kernels.forward_backward(*map(torch.from_numpy, (log_b, log_start, log_trans)))
    for g, w in zip(got, want):
        g = g.numpy()
        assert not np.isnan(g).any()
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("name", SCAN_CASES)
def test_viterbi_plain_equals_jax(name):
    log_b, log_start, log_trans = _scan_case(name)
    want = np.asarray(
        jax_hmm._viterbi(jnp.asarray(log_b), jnp.asarray(log_start), jnp.asarray(log_trans))
    )
    got = hmm_kernels.viterbi(*map(torch.from_numpy, (log_b, log_start, log_trans)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if name == "ties":
        assert (got == 0).all()  # every tie goes to the lower state


@pytest.mark.parametrize("name", SCAN_CASES)
def test_kernel_bounds_hold_the_jax_scan_and_refuse_what_exceeds_them(name):
    """``forward_backward_errors``, which holds the card's chunked scans to
    the plain loops, accepts the JAX scan's result; it refuses a
    log-likelihood moved by twice its bound, a gamma moved by 2e-9, and a NaN."""
    log_b, log_start, log_trans = _scan_case(name)
    want = hmm_kernels.forward_backward(*map(torch.from_numpy, (log_b, log_start, log_trans)))
    jax_got = tuple(torch.from_numpy(np.array(w)) for w in jax_hmm._forward_backward(
        jnp.asarray(log_b), jnp.asarray(log_start), jnp.asarray(log_trans)))
    errors, ok = hmm_kernels.forward_backward_errors(jax_got, want)
    assert ok, errors
    lp, gamma, xi = want
    rtol = hmm_kernels.logprob_rtol(log_b.shape[0])
    for bad in ((lp * (1 + 2 * rtol), gamma, xi), (lp, gamma + 2e-9, xi),
                (lp, gamma, xi * float("nan"))):
        assert not hmm_kernels.forward_backward_errors(bad, want)[1]


def test_scans_of_one_frame():
    """T = 1, where the JAX scans reduce over nothing: no transition, so
    xi_sum is 0; gamma is the normalised first frame."""
    log_b = torch.tensor([[0.3, -1.2]], dtype=torch.float64)
    log_start = torch.log(torch.tensor([0.5, 0.5], dtype=torch.float64))
    log_trans = torch.log(torch.tensor([[0.9, 0.1], [0.2, 0.8]], dtype=torch.float64))
    lp, gamma, xi = hmm_kernels.forward_backward(log_b, log_start, log_trans)
    torch.testing.assert_close(lp, torch.logsumexp(log_start + log_b[0], 0), rtol=1e-15, atol=0)
    torch.testing.assert_close(gamma[0], torch.softmax(log_b[0], 0), rtol=1e-15, atol=1e-17)
    assert torch.equal(xi, torch.zeros(2, 2, dtype=torch.float64))
    assert hmm_kernels.viterbi(log_b, log_start, log_trans).tolist() == [0]


def test_wrappers_refuse_other_devices_and_types():
    """Off the CPU a wrapper launches its kernel or raises: never the plain loop."""
    meta = torch.zeros((5, 2), dtype=torch.float64, device="meta")
    start = torch.zeros(2, dtype=torch.float64, device="meta")
    trans = torch.zeros((2, 2), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        hmm_kernels.forward_backward(meta, start, trans)
    with pytest.raises(ValueError, match="cuda or cpu"):
        hmm_kernels.viterbi(meta, start, trans)
    with pytest.raises(ValueError, match="float64"):
        hmm_kernels.forward_backward(meta.float(), start, trans)
    with pytest.raises(ValueError, match="shape"):
        hmm_kernels.viterbi(meta, start, trans[0])


HMM_SIGNALS = ["two_segment_0", "fast_exact", "cache", "regime_0", "regime_3",
               "log_similarity_300x40"]


@pytest.mark.parametrize("mode", ["fast", "exact"])
@pytest.mark.parametrize("name", HMM_SIGNALS)
def test_gaussian_hmm_equals_jax(name, mode):
    X = SIGNALS[name]
    ref = jax_hmm.GaussianHMM2(seed=0, mode=mode).fit(X)
    want_path = ref.predict(X)
    model = gaussian_hmm.GaussianHMM2(seed=0, mode=mode, device="cpu")
    path = model.fit_predict(X)
    for attr in ("means_", "covars_", "transmat_"):
        np.testing.assert_allclose(
            getattr(model, attr), getattr(ref, attr), rtol=1e-8, atol=1e-12, err_msg=attr
        )
    np.testing.assert_array_equal(path, want_path)
    np.testing.assert_array_equal(model.predict(X), want_path)


def test_gaussian_hmm_from_numpy_predicts_the_jax_path():
    X = SIGNALS["regime_2"]
    ref = jax_hmm.GaussianHMM2(seed=0, mode="exact").fit(X)
    model = state.gaussian_hmm_from_numpy(
        np.asarray(ref.means_), np.asarray(ref.covars_), np.asarray(ref.transmat_),
        torch.device("cpu"), mode="exact",
    )
    other = regime_data(9, T=97)
    for obs in (X, other):
        np.testing.assert_array_equal(model.predict(obs), ref.predict(obs))
    with pytest.raises(ValueError):
        state.gaussian_hmm_from_numpy(ref.means_, ref.covars_[:, :0], ref.transmat_, "cpu")


def _block_matrix():
    """``tests/test_hmm.py::test_hmm_cut_strategy_on_blocks``' two-chromosome
    log-similarity blocks."""
    rng = np.random.default_rng(3)
    sizes = (35, 30)
    n = sum(sizes)
    labels = np.repeat(np.arange(2), sizes)
    same = labels[:, None] == labels[None, :]
    dist = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :])
    m = np.where(same, 2.0 - np.log10(1.0 + dist), 0.0) + rng.random((n, n)) * 0.01
    return np.triu(m) + np.triu(m, 1).T


@pytest.mark.parametrize(
    "case,mode",
    [("blocks", "fast"), ("blocks", "exact"), ("hmm_genome_306", "fast")],
)
def test_hmm_cut_search_equals_jax(case, mode):
    if case == "blocks":
        adj = _block_matrix()
        kw = dict(min_size=5, modularity=0.05, convergence_rounds=5, look_ahead=False)
    else:
        adj = hmm_adjacency(640)
        assert adj.shape == (306, 306)
        kw = dict(min_size=5, modularity=0.05, convergence_rounds=5, look_ahead=0.2,
                  louvain_rounds=2)
    with contextlib.redirect_stdout(io.StringIO()):
        want = jax_cuts.identify_chromosome_groups_hmm(adj, None, hmm_mode=mode, **kw)
        got = hmm_cuts.identify_chromosome_groups_hmm(adj, None, hmm_mode=mode, device="cpu", **kw)
    assert got == want
    assert len(got) > 0


def test_identify_boundary_copy_equals_jax():
    rng = np.random.default_rng(11)
    for _ in range(50):
        states = (rng.random(int(rng.integers(5, 60))) < rng.random()).astype(int)
        cuts = [0, int(rng.integers(0, 500))]
        for k in (1, 3, 5):
            assert hmm_cuts.identify_boundary(states, cuts, k) == \
                jax_cuts.identify_boundary(states, cuts, k)
