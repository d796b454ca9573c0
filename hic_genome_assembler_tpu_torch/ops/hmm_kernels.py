"""Forward-backward and Viterbi scans of the 2-state Gaussian HMM.

Counterpart of the ``lax.scan`` recursions of
``hic_genome_assembler_tpu/ops/gaussian_hmm.py``: ``_forward_backward``
(``:61-93``) and ``_viterbi`` (``:263-280``), which are also the unmasked
forms of ``fb`` and ``vstep``/``backtrack`` in ``_fit_predict_masked``.
All in float64, with the JAX package's ``_logsumexp`` rule: an all-``-inf``
pair gives ``-inf``, not NaN.

On a CUDA tensor ``forward_backward`` and ``viterbi`` launch the
hand-written kernels in ``csrc/hmm_scan.cu`` (or raise); on a CPU tensor
they run the plain torch loops beside them, which are also the oracle of
the tests.  There is no fallback from one to the other.

The kernels are chunked parallel scans: they associate the f64 sums
differently from the sequential loops, so they agree with them within
:func:`forward_backward_errors`' bounds, not bit for bit.  Viterbi paths
are identical.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from hic_genome_assembler_tpu_torch.utils import profiling

_COPIES = "part1/pageable_copies"  # the plain Viterbi's readbacks on a card

# Kernel launches made by the wrappers below and by the k-means on the card
# (``ops/kmeans.py``, ``csrc/kmeans.cu``), read by chip_smoke.py to show that
# the main path went through the kernels.
LAUNCHES = {"hmm_forward_backward": 0, "hmm_viterbi": 0, "kmeans_col_stats": 0,
            "kmeans_center": 0, "kmeans_seed_closest": 0, "kmeans_seed_pots": 0,
            "kmeans_seed_pick": 0, "kmeans_step": 0, "kmeans_fold": 0, "kmeans_choose": 0}

# How far the kernels may differ from the plain loops, whose sums they
# associate differently.  A chain of T rounded f64 steps is off by at most
# about T * 2**-52 of the magnitude it carries, and the log-likelihood
# carries |logprob|: it is held to (T + 8) * 2**-52 relative.  gamma is
# normalised per frame, so only the two states' difference at one frame
# reaches it: 1e-9 absolute.  Every log-xi term subtracts the log-likelihood,
# so the xi sums are held relatively to 1e-9 plus twice the log-likelihood's
# absolute bound.
GAMMA_ATOL = 1e-9
XI_RTOL = 1e-9


def logprob_rtol(T: int) -> float:
    """The log-likelihood's relative bound at ``T`` frames."""
    return (T + 8) * 2.0**-52


def forward_backward_errors(got, want) -> Tuple[Dict[str, float], bool]:
    """The differences of two ``(logprob, gamma, xi_sum)`` results (the
    log-likelihood's and the xi sums' relative, gamma's absolute, and the
    largest absolute one of all three) and whether they lie within the
    bounds above; a NaN never does."""
    lp, gamma, xi = (x.double().cpu() for x in got)
    wlp, wgamma, wxi = (x.double().cpu() for x in want)
    rtol = logprob_rtol(wgamma.shape[0])
    errors = {
        "logprob_rel": float((lp - wlp).abs() / wlp.abs().clamp_min(1e-300)),
        "gamma_abs": float((gamma - wgamma).abs().max()),
        "xi_rel": float(((xi - wxi).abs() / wxi.abs().clamp_min(1e-300)).max()),
        "max_abs": max(float((g - w).abs().max())
                       for g, w in zip((lp, gamma, xi), (wlp, wgamma, wxi))),
    }
    ok = (errors["logprob_rel"] <= rtol and errors["gamma_abs"] <= GAMMA_ATOL
          and errors["xi_rel"] <= XI_RTOL + 2 * rtol * float(wlp.abs()))
    return errors, ok


def _logsumexp(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``gaussian_hmm._logsumexp``: shift by the max, or by 0 where the max
    is not finite."""
    m = a.amax(dim=dim, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    return (m_safe + torch.log(torch.exp(a - m_safe).sum(dim=dim, keepdim=True))).squeeze(dim)


def forward_backward_plain(
    log_b: torch.Tensor, log_start: torch.Tensor, log_trans: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch version of :func:`forward_backward`, a loop over t."""
    T = log_b.shape[0]
    alphas = torch.empty_like(log_b)
    betas = torch.empty_like(log_b)
    alphas[0] = log_start + log_b[0]
    for t in range(1, T):
        alphas[t] = _logsumexp(alphas[t - 1][:, None] + log_trans, 0) + log_b[t]
    logprob = _logsumexp(alphas[-1], 0)
    betas[T - 1] = 0.0
    for t in range(T - 2, -1, -1):
        betas[t] = _logsumexp(log_trans + (log_b[t + 1] + betas[t + 1])[None, :], 1)
    gamma = alphas + betas - logprob
    gamma = torch.exp(gamma - _logsumexp(gamma, 1)[:, None])
    if T == 1:
        # no transition: the sum over an empty t is exp(-inf) = 0
        return logprob, gamma, torch.zeros_like(log_trans)
    log_xi = (
        alphas[:-1, :, None]
        + log_trans[None, :, :]
        + (log_b[1:] + betas[1:])[:, None, :]
        - logprob
    )
    return logprob, gamma, torch.exp(_logsumexp(log_xi, 0))


def viterbi_plain(
    log_b: torch.Tensor, log_start: torch.Tensor, log_trans: torch.Tensor
) -> torch.Tensor:
    """Plain torch version of :func:`viterbi`, a loop over t: int32 [T]."""
    T = log_b.shape[0]
    backptrs = torch.empty((max(T - 1, 0), 2), dtype=torch.int64, device=log_b.device)
    delta = log_start + log_b[0]
    for t in range(1, T):
        scores = delta[:, None] + log_trans
        backptrs[t - 1] = torch.argmax(scores, dim=0)  # the lowest index wins a tie
        delta = torch.amax(scores, dim=0) + log_b[t]
    profiling.count_copy(_COPIES, log_b.device)
    back = backptrs.tolist()
    profiling.count_copy(_COPIES, log_b.device)
    state = int(torch.argmax(delta))
    path = [state] * T
    for t in range(T - 2, -1, -1):
        state = back[t][state]
        path[t] = state
    profiling.count_copy(_COPIES, log_b.device)
    return torch.tensor(path, dtype=torch.int32, device=log_b.device)


def _check(log_b, log_start, log_trans) -> int:
    for name, x, shape in (
        ("log_b", log_b, None), ("log_start", log_start, (2,)), ("log_trans", log_trans, (2, 2))
    ):
        if x.device != log_b.device or x.dtype != torch.float64 or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous float64 on {log_b.device}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")
    if log_b.dim() != 2 or log_b.shape[1] != 2 or not 1 <= log_b.shape[0] < 2**31:
        raise ValueError(f"log_b must be [T, 2] with T >= 1, got {tuple(log_b.shape)}")
    if log_b.device.type != "cuda":
        raise ValueError(f"the HMM scans run on cuda or cpu, not {log_b.device}")
    return int(log_b.shape[0])


def forward_backward(
    log_b: torch.Tensor, log_start: torch.Tensor, log_trans: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(logprob, gamma [T, 2], xi_sum [2, 2])`` of per-frame
    log-densities ``log_b`` [T, 2]; ``logprob`` is a 0-d tensor on the
    input's device (counterpart of ``gaussian_hmm._forward_backward``)."""
    if log_b.device.type == "cpu":
        return forward_backward_plain(log_b, log_start, log_trans)
    T = _check(log_b, log_start, log_trans)
    from hic_genome_assembler_tpu_torch.ops import _build

    lib = _build.library()
    dev = log_b.device
    scratch = torch.empty((2, T, 2), dtype=torch.float64, device=dev)
    gamma = torch.empty((T, 2), dtype=torch.float64, device=dev)
    xi_sum = torch.empty((2, 2), dtype=torch.float64, device=dev)
    logprob = torch.empty((), dtype=torch.float64, device=dev)
    with torch.cuda.device(dev):  # a launch goes to the current card
        err = lib.hmm_forward_backward(
            log_b.data_ptr(), log_start.data_ptr(), log_trans.data_ptr(), T, scratch.data_ptr(),
            gamma.data_ptr(), xi_sum.data_ptr(), logprob.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hmm_forward_backward kernel launch failed: cudaError {err}")
    LAUNCHES["hmm_forward_backward"] += 1
    return logprob, gamma, xi_sum


def viterbi(log_b: torch.Tensor, log_start: torch.Tensor, log_trans: torch.Tensor) -> torch.Tensor:
    """Most probable state path of ``log_b`` [T, 2]: int32 [T] on the
    input's device (counterpart of ``gaussian_hmm._viterbi``)."""
    if log_b.device.type == "cpu":
        return viterbi_plain(log_b, log_start, log_trans)
    T = _check(log_b, log_start, log_trans)
    from hic_genome_assembler_tpu_torch.ops import _build

    lib = _build.library()
    dev = log_b.device
    scratch = torch.empty((max(T - 1, 1), 2), dtype=torch.uint8, device=dev)
    path = torch.empty(T, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):  # a launch goes to the current card
        err = lib.hmm_viterbi(
            log_b.data_ptr(), log_start.data_ptr(), log_trans.data_ptr(), T, scratch.data_ptr(),
            path.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"hmm_viterbi kernel launch failed: cudaError {err}")
    LAUNCHES["hmm_viterbi"] += 1
    return path
