"""Carry device state from the JAX package's objects into the port's.

The system has no weights; its device state is the padded rank matrix of
part 1's ``RankCounts``, the fitted parameters of part 1's HMMs and, per
chromosome in part 2, the pair-profile table ``h`` with its padded sizes
and the float64 host bookkeeping of ``ChromosomeScorer``.  Every function
takes numpy arrays (``np.asarray`` of the JAX arrays), so this module needs
no jax.  Where the JAX object was placed on a mesh, passing the port's
``parallel.mesh.Mesh`` places the port's object on it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from hic_genome_assembler_tpu_torch.cluster.breakpoints import RankCounts
from hic_genome_assembler_tpu_torch.ops import cost
from hic_genome_assembler_tpu_torch.ops.gaussian_hmm import GaussianHMM2
from hic_genome_assembler_tpu_torch.parallel.mesh import Mesh


def rank_counts_from_numpy(
    padded_rank: np.ndarray, n: int, device: torch.device, mesh: Optional[Mesh] = None
) -> RankCounts:
    """``RankCounts`` over the first ``n`` rows and columns of a rank
    matrix in any padded layout (entries past ``n`` are pad, -1, 0 or
    65535, and never count), re-padded to the port's layout on ``device``
    or, with ``mesh``, placed as the port's mesh blocks."""
    padded_rank = np.asarray(padded_rank)
    if padded_rank.ndim != 2 or min(padded_rank.shape) < n:
        raise ValueError(f"rank matrix {padded_rank.shape} holds fewer than {n} rows/cols")
    return RankCounts(np.array(padded_rank[:n, :n], dtype=np.int32), device, mesh=mesh)


def gaussian_hmm_from_numpy(
    means: np.ndarray,
    covars: np.ndarray,
    transmat: np.ndarray,
    device: torch.device,
    mode: str = "fast",
) -> GaussianHMM2:
    """A fitted port ``GaussianHMM2`` on ``device`` with a JAX model's
    ``means_`` [2, D], ``covars_`` [2, D] and ``transmat_`` [2, 2]
    (the startprob is the fixed uniform one of both classes)."""
    means = np.array(means, dtype=np.float64)
    covars = np.array(covars, dtype=np.float64)
    transmat = np.array(transmat, dtype=np.float64)
    if means.ndim != 2 or means.shape[0] != 2 or covars.shape != means.shape:
        raise ValueError(f"means {means.shape} and covars {covars.shape} must both be [2, D]")
    if transmat.shape != (2, 2):
        raise ValueError(f"transmat must be [2, 2], got {transmat.shape}")
    model = GaussianHMM2(mode=mode, device=device)
    model.means_, model.covars_, model.transmat_ = means, covars, transmat
    return model


_SCORER_ARRAYS = (
    "_h", "_sizes_d", "sizes", "_sub", "intra_profile", "intra_total", "cross_total",
)
_SCORER_SHAPES = ("Sp", "cmax", "L", "C_pad")


def chromosome_scorer_from_numpy(
    arrays: Dict[str, object],
    device: torch.device,
    stats: Optional[cost.PrecisionStats] = None,
    mesh: Optional[Mesh] = None,
) -> cost.ChromosomeScorer:
    """The port's ``ChromosomeScorer`` holding exactly the given state:
    ``_h`` [4*Sp*Sp, L] (its dtype is the scoring dtype), ``_sizes_d``
    [Sp], ``sizes``, ``_sub`` (f64 [C, C]), ``intra_profile``,
    ``intra_total``, ``cross_total`` and the layout ints ``Sp``, ``cmax``,
    ``L``, ``C_pad``.  No profile is rebuilt.  With ``mesh`` the scorer
    splits its candidate batches over the mesh's data axis and keeps its
    table on the mesh's first device."""
    missing = [k for k in _SCORER_ARRAYS + _SCORER_SHAPES if k not in arrays]
    if missing:
        raise ValueError(f"scorer state lacks {missing}")
    h = np.asarray(arrays["_h"])
    scorer = cost.ChromosomeScorer.__new__(cost.ChromosomeScorer)
    scorer._mesh = mesh
    scorer.device = mesh.first if mesh is not None else torch.device(device)
    scorer._dtype = h.dtype
    scorer.stats = cost.PrecisionStats() if stats is None else stats
    scorer.sizes = np.asarray(arrays["sizes"], dtype=np.int64)
    scorer.S = len(scorer.sizes)
    scorer.C = int(scorer.sizes.sum())
    scorer._sub = np.asarray(arrays["_sub"], dtype=np.float64)
    scorer._sub_f64 = None
    scorer.intra_profile = np.asarray(arrays["intra_profile"], dtype=np.float64)
    scorer.intra_total = np.asarray(arrays["intra_total"], dtype=np.float64)
    scorer.cross_total = np.asarray(arrays["cross_total"], dtype=np.float64)
    for key in _SCORER_SHAPES:
        setattr(scorer, key, int(arrays[key]))
    if h.shape != (4 * scorer.Sp * scorer.Sp, scorer.L):
        raise ValueError(f"_h {h.shape} does not match Sp={scorer.Sp}, L={scorer.L}")
    scorer._h = torch.from_numpy(np.array(h)).to(scorer.device)
    scorer._sizes_d = torch.from_numpy(
        np.asarray(arrays["_sizes_d"], dtype=np.int64)
    ).to(scorer.device)
    return scorer
