"""2-state diagonal-covariance Gaussian HMM: EM fit and Viterbi decode.

Counterpart of ``hic_genome_assembler_tpu/ops/gaussian_hmm.py::GaussianHMM2``
(hmmlearn's ``GaussianHMM(n_components=2, covariance_type="diag",
n_iter=1000, init_params="cm", params="cmt")`` as the reference configures
it): k-means means, data-variance covariances, a uniform startprob that is
never re-estimated, the transmat re-estimated from
``[[.9, .1], [1e-4, .9999]]``, EM to a log-likelihood gain below ``tol``,
Viterbi decoding.

Everything is float64, on the host and on ``device`` alike.  A fit uploads
its data first; the k-means and the starting covariances work on that
upload (``ops.kmeans``: the CUDA kernels on a GPU, numpy on the CPU) and
stay on its device as the EM's starting parameters.  The per-frame
log-densities and the M step are matrix products (``torch.matmul``); the
forward-backward and Viterbi recursions go through ``ops.hmm_kernels`` (the
CUDA kernels on a GPU, their plain torch loops on the CPU).  The EM loop
runs on the host and reads the log-likelihood back once per iteration.
Fits and EM iterations are counted in ``profiling``, and the k-means,
upload, EM and decode seconds timed there (part 1's summary prints them).
Each pageable copy between the host and a card is counted there too
(``part1/pageable_copies``): the uploads of the data and of the start and
transition matrices, the log-likelihood read once an iteration, the fitted
parameters and the path (k-means reads back through pinned memory).

``mode`` keeps the JAX package's two semantic differences and nothing
else: k-means takes 2 inits in ``"fast"`` mode and 10 in ``"exact"`` mode,
and ``fit_predict`` decodes with the fit's own upload in fast mode and with
a separate ``predict`` in exact mode.  The JAX fast mode's power-of-two
padding only bounded XLA recompiles and is exact under its masks, so it is
not reproduced; nor is the fingerprint cache of its ``predict``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.ops import hmm_kernels, kmeans
from hic_genome_assembler_tpu_torch.utils import profiling

_MIN_COVAR = kmeans.MIN_COVAR
_COPIES = "part1/pageable_copies"
_LOG2PI = float(np.log(2.0 * np.pi))


def _log_gaussian_diag(X, X2, means, covars) -> torch.Tensor:
    """log N(x_t | mu_k, diag(sig_k)) for all t, k: the matmul form of
    ``gaussian_hmm._log_gaussian_diag``; ``X2`` is ``X ** 2``."""
    inv = 1.0 / covars
    quad = X2 @ inv.T - 2.0 * (X @ (means * inv).T) + torch.sum(means ** 2 * inv, dim=1)[None, :]
    logdet = torch.sum(torch.log(covars), dim=1)[None, :]
    return -0.5 * (quad + logdet + X.shape[1] * _LOG2PI)


def _m_step(X, X2, gamma, xi_sum):
    norm = torch.clamp_min(gamma.sum(dim=0)[:, None], 1e-300)
    means = (gamma.T @ X) / norm
    covars = (gamma.T @ X2) / norm - means ** 2 + _MIN_COVAR
    row = xi_sum.sum(dim=1, keepdim=True)
    trans = xi_sum / torch.where(row > 0, row, torch.ones_like(row))
    return means, torch.clamp_min(covars, _MIN_COVAR), trans


class GaussianHMM2:
    """The reference's HMM configuration on a torch ``device``."""

    def __init__(
        self,
        n_iter: int = 1000,
        tol: float = 1e-2,
        seed: int = 0,
        startprob: Tuple[float, float] = (0.5, 0.5),
        transmat=((0.9, 0.1), (1e-4, 0.9999)),
        mode: str = "fast",
        device="cpu",
    ):
        if mode not in ("fast", "exact"):
            raise ValueError(f"hmm mode must be 'fast' or 'exact', got {mode!r}")
        self.n_iter = n_iter
        self.tol = tol
        self.seed = seed
        self.startprob = np.asarray(startprob, dtype=np.float64)
        self.transmat_init = np.asarray(transmat, dtype=np.float64)
        self.mode = mode
        self.device = torch.device(device)
        self.means_: np.ndarray = None
        self.covars_: np.ndarray = None
        self.transmat_: np.ndarray = None

    def _init_params(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The k-means means and the data's covariances of the upload ``X``,
        on its device."""
        n_init = 10 if self.mode == "exact" else 2
        means, covars = kmeans.kmeans2(X, self.seed, n_init)
        return torch.as_tensor(means, device=X.device), torch.as_tensor(covars, device=X.device)

    def _tensor(self, a) -> torch.Tensor:
        profiling.count_copy(_COPIES, self.device)
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(self.device)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        profiling.count_copy(_COPIES, t.device)
        return t.cpu().numpy()

    def _log_start(self) -> torch.Tensor:
        return torch.log(self._tensor(self.startprob))

    def _em(self, X: torch.Tensor, X2: torch.Tensor, means: torch.Tensor,
            covars: torch.Tensor) -> None:
        trans = self._tensor(self.transmat_init)
        log_start = self._log_start()
        prev_lp = -np.inf
        for _ in range(self.n_iter):
            # lp comes from the parameters before the update, and the update
            # applies in the converging iteration too
            log_b = _log_gaussian_diag(X, X2, means, covars)
            lp, gamma, xi = hmm_kernels.forward_backward(log_b, log_start, torch.log(trans))
            means, covars, trans = _m_step(X, X2, gamma, xi)
            profiling.count("part1/hmm_em_iterations")
            profiling.count_copy(_COPIES, lp.device)
            lp = float(lp)
            if lp - prev_lp < self.tol:
                break
            prev_lp = lp
        profiling.count("part1/hmm_fits")
        self.means_ = self._host(means)
        self.covars_ = self._host(covars)
        self.transmat_ = self._host(trans)

    def _decode(self, X: torch.Tensor, X2: torch.Tensor) -> np.ndarray:
        with profiling.timer("part1/hmm_decode"):
            log_b = _log_gaussian_diag(X, X2, self._tensor(self.means_), self._tensor(self.covars_))
            log_trans = torch.log(self._tensor(self.transmat_))
            path = hmm_kernels.viterbi(log_b, self._log_start(), log_trans)
            return self._host(path).astype(np.int64)

    def _upload(self, X: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        with profiling.timer("part1/hmm_upload"):
            Xd = self._tensor(X)
            return Xd, Xd * Xd

    def _fit(self, X: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """EM on ``X``; returns its upload (``X``, ``X ** 2`` on device)."""
        data = self._upload(X)
        with profiling.timer("part1/hmm_kmeans"):
            means0, covars0 = self._init_params(data[0])
        # ends in a readback of the fitted parameters: device time included
        with profiling.timer("part1/hmm_em"):
            self._em(*data, means0, covars0)
        return data

    def fit(self, X) -> "GaussianHMM2":
        self._fit(np.asarray(X, dtype=np.float64))
        return self

    def predict(self, X) -> np.ndarray:
        """Viterbi path of ``X`` under the fitted parameters: int64 [T]."""
        return self._decode(*self._upload(np.asarray(X, dtype=np.float64)))

    def fit_predict(self, X) -> np.ndarray:
        """``fit(X)`` then the Viterbi path of ``X``; fast mode decodes the
        fit's own upload, exact mode calls :meth:`predict`."""
        X = np.asarray(X, dtype=np.float64)
        data = self._fit(X)
        return self.predict(X) if self.mode == "exact" else self._decode(*data)
