"""The HMM and k-means tests' signals, without jax: the CPU tests hold the
port to the JAX package on them (``test_torch_hmm.py``) and the card tests
hold the card to the host (``test_torch_gpu.py``, which runs without jax)."""

import numpy as np

from hic_genome_assembler_tpu_torch.ops import oracle
from hic_genome_assembler_tpu_torch.utils import e2e


def two_segment_obs(seed=0, t1=40, t2=40, d=6, sep=4.0):
    """``tests/test_hmm.py``'s two-regime signal."""
    rng = np.random.default_rng(seed)
    return np.vstack([rng.normal(0.0, 1.0, (t1, d)), rng.normal(sep, 1.0, (t2, d))])


def regime_data(seed, T=220, sep=4.0):
    """``tests/test_hmm_louvain_oracle.py::_regime_data``: a 1-D sequence of
    random-length regimes."""
    rng = np.random.default_rng(seed)
    states = np.zeros(T, dtype=int)
    pos = 0
    while pos < T:
        ln = int(rng.integers(15, 45))
        states[pos : pos + ln] = rng.integers(0, 2)
        pos += ln
    return (rng.normal(0.0, 1.0, T) + states * sep)[:, None]


def hmm_adjacency(n=640):
    """The HMM branch's input matrix (distance, similarity, log10(+1)) of
    ``e2e.make_hmm_genome(n)`` in planted order."""
    m = e2e.make_hmm_genome(n).matrix.astype(np.float64)
    adj = oracle.to_similarity(oracle.to_distance(m), m.sum(axis=1))
    return oracle.log_transform(adj, log_base=10, plus_one=True)


def _signals():
    rng5, rng6 = np.random.default_rng(5), np.random.default_rng(6)
    out = {
        "two_segment_0": two_segment_obs(0),
        "two_segment_1": two_segment_obs(1),
        "fast_exact": np.concatenate(
            [rng5.normal(0.0, 0.3, (40, 6)), rng5.normal(4.0, 0.3, (35, 6))]
        ),
        "cache": np.concatenate(
            [rng6.normal(0.0, 0.2, (30, 4)), rng6.normal(3.0, 0.2, (30, 4))]
        ),
    }
    for seed in range(5):
        out[f"regime_{seed}"] = regime_data(seed)
    out["log_similarity_300x40"] = hmm_adjacency()[:300, 6:46]
    return out


SIGNALS = _signals()
