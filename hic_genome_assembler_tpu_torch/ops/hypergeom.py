"""Exact hypergeometric significance decisions at vector speed.

The part-1 breakpoint machinery never consumes hypergeometric p-values
as numbers — every use is the strict decision ``sf(x-1, M, n, N) < psig``
(the reference's ``hyper_geom`` at scaffoldToChromosomes.py:352-368 feeding
the comparisons at :455,462,634,668).  The reference (and round-2 of this
framework) evaluates the full survival function through scipy/Boost for
every row, which costs ~0.7 s per 16K-row sweep and made cut detection
the dominant part-1 stage (62.7 s of 106.6 s at 16K, BENCHMARKS.md r2).

This module computes the *decisions* exactly at ~20-40 ms per sweep:

* For Hypergeom(M, n, N) the pmf mass lives in a window of width O(sigma)
  around the mean mu = nN/M, and for the n == N == k case used by the
  row scans sigma <= sqrt(M)/4 (~32 at M = 16K).  We anchor log-pmf at
  the window start with float64 ``gammaln`` (the log-gamma route of
  SURVEY.md §7 step 4b), roll the exact pmf recurrence across the
  window, and read P(X >= x) off a suffix sum.
* Outside the window the geometric tail bounds (the pmf ratio is
  monotone away from the mode) prove the decision directly.
* Any row whose decision is not *provably* identical to scipy's —
  |sf - psig| inside the window's error bound, or an unbounded tail —
  is re-evaluated with ``scipy.stats.hypergeom.sf`` itself.  scipy is
  therefore the arbiter of every near-tie: decisions are equal to the
  reference's by construction, not by accuracy argument.

The fallback count is recorded in ``stats`` for observability; parity
tests assert flag equality against scipy across adversarial grids
(tests/test_hypergeom.py).
"""

from __future__ import annotations

import numpy as np
import scipy.special
import scipy.stats

# Window half-width in sigmas.  The mass beyond 5.5 sigma is ~1e-6 —
# far below any psig in use; the geometric tail bound verifies it per
# call, and rows whose decision it cannot certify fall back to scipy.
_HALF_SIGMAS = 5.5
# Extra absolute slack on the half-width (covers tiny-sigma cases).
_HALF_SLACK = 6
# Relative float64 error budget for a windowed suffix sum (cumprod +
# cumsum over <= ~2000 terms, each step ~eps): 1e-11 is ~1e4 x the true
# error, and anything within it of psig goes to scipy regardless.
_REL_ERR = 1e-11
# Row chunk cap: bound peak memory of the (rows x window) term tables
# (three float64 work buffers of this many elements, reused via _ws).
_CHUNK_ELEMS = 4 * 1024 * 1024

_ws: dict = {}


def _buffers(rows, width):
    """Three reusable float64 work buffers, viewed as (rows, width).

    Pooled by pow2-quantized width with chunk-capped rows, so at most a
    handful of allocations ever exist.  The sweeps re-request similar
    shapes thousands of times per part-1 run; fresh 10-50 MB
    allocations per call were the dominant cost (page-fault-bound, ~6x
    the arithmetic)."""
    wcap = 1 << max(width - 1, 1).bit_length()
    rcap = max(1, _CHUNK_ELEMS // wcap)
    if rows > rcap:
        raise ValueError(f"rows {rows} exceeds chunk cap {rcap} for width {width}")
    bufs = _ws.get(wcap)
    if bufs is None:
        bufs = tuple(np.empty((rcap, wcap), dtype=np.float64) for _ in range(3))
        _ws[wcap] = bufs
    return tuple(b[:rows, :width] for b in bufs)

stats = {"calls": 0, "rows": 0, "fallback_rows": 0}


def _scipy_ge(x, M, n, N, psig):
    """Reference decision: scipy sf(x-1) < psig (nan compares False)."""
    with np.errstate(invalid="ignore", divide="ignore"):
        pv = scipy.stats.hypergeom.sf(np.asarray(x, dtype=np.float64) - 1.0, M, n, N)
    return pv < psig


def _log_pmf(j, M, n, N):
    """float64 log pmf via gammaln (valid only inside the support)."""
    lg = scipy.special.gammaln
    return (
        lg(n + 1.0) - lg(j + 1.0) - lg(n - j + 1.0)
        + lg(M - n + 1.0) - lg(N - j + 1.0) - lg(M - n - N + j + 1.0)
        - (lg(M + 1.0) - lg(N + 1.0) - lg(M - N + 1.0))
    )


def ge_significant(x, M, n, N, psig):
    """Boolean flags ``scipy.stats.hypergeom.sf(x - 1, M, n, N) < psig``.

    ``x, M, n, N`` broadcast elementwise (integer-valued); ``psig`` is a
    scalar.  This is P(X >= x) < psig — the reference's ``hyper_geom``
    (scaffoldToChromosomes.py:352-368) under its strict comparison.
    Decision-identical to scipy for every element.
    """
    if np.ndim(M) == 0 and np.ndim(n) == 0 and np.ndim(N) == 0 and np.size(x) > 64:
        # constant-distribution call (the cut-noise filter's per-(start,
        # cut) row sweeps): decide each distinct count once
        xa = np.asarray(x, dtype=np.int64)
        ux, inv = np.unique(xa, return_inverse=True)
        if ux.size <= xa.size // 2:
            return ge_significant(ux, M, n, N, psig)[inv].reshape(xa.shape)
    x, M, n, N = np.broadcast_arrays(
        np.asarray(x, dtype=np.int64),
        np.asarray(M, dtype=np.int64),
        np.asarray(n, dtype=np.int64),
        np.asarray(N, dtype=np.int64),
    )
    shape = x.shape
    x = x.ravel()
    M = M.ravel()
    n = n.ravel()
    N = N.ravel()
    rows = x.size
    stats["calls"] += 1
    stats["rows"] += rows
    flags = np.zeros(rows, dtype=bool)
    psig = float(psig)

    # Invalid parameters: scipy yields nan, and nan < psig is False.
    invalid = (M <= 0) | (n < 0) | (N < 0) | (n > M) | (N > M)
    lo = np.maximum(0, n + N - M)
    hi = np.minimum(n, N)

    # Trivial decisions off the support edges (scipy: sf=1 / sf=0).
    below = ~invalid & (x <= lo)  # P(X >= x) = 1 exactly
    above = ~invalid & (x > hi)  # P(X >= x) = 0 exactly
    flags[below] = 1.0 < psig
    flags[above] = 0.0 < psig

    todo = ~(invalid | below | above)
    if not np.any(todo):
        return flags.reshape(shape)

    idx = np.nonzero(todo)[0]
    xt, Mt, nt, Nt = x[idx], M[idx], n[idx], N[idx]
    lot, hit = lo[idx], hi[idx]

    # Rigorous Chernoff-KL prefilter.  Hoeffding (1963, §6): tail bounds
    # for sampling WITHOUT replacement are dominated by the binomial
    # Chernoff-KL bound, so  P(X >= aN) <= exp(-N*KL(a||p)), a > p, and
    # P(X <= aN) <= exp(-N*KL(a||p)), a < p, with p = n/M.  Rows these
    # bounds decide skip the pmf window entirely (the strongly
    # significant in-chromosome rows and ~40% of noise rows).
    pf = nt / Mt.astype(np.float64)
    Nff = np.maximum(Nt, 1).astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        a1 = xt / Nff
        kl1 = np.where(a1 > 0, a1 * np.log(a1 / pf), 0.0) + np.where(
            a1 < 1, (1 - a1) * np.log((1 - a1) / (1 - pf)), 0.0
        )
        b1 = np.exp(-Nff * kl1)
        cert_sig = (a1 > pf) & (b1 * (1 + 1e-12) < psig)
        a0 = (xt - 1) / Nff
        kl0 = np.where(a0 > 0, a0 * np.log(a0 / pf), 0.0) + np.where(
            a0 < 1, (1 - a0) * np.log((1 - a0) / (1 - pf)), 0.0
        )
        b0 = np.exp(-Nff * kl0)
        cert_nsig = (a0 >= 0) & (a0 < pf) & (1.0 - b0 * (1 + 1e-12) >= psig)
    flags[idx[cert_sig]] = True
    undecided = ~(cert_sig | cert_nsig)
    idx = idx[undecided]
    if idx.size == 0:
        return flags.reshape(shape)
    xt, Mt, nt, Nt = xt[undecided], Mt[undecided], nt[undecided], Nt[undecided]
    lot, hit = lot[undecided], hit[undecided]

    Mf = Mt.astype(np.float64)
    mu = nt * Nt / Mf
    with np.errstate(invalid="ignore", divide="ignore"):
        var = nt * Nt * (Mt - nt) * (Mt - Nt) / (Mf * Mf * np.maximum(Mt - 1, 1))
    sigma = np.sqrt(np.maximum(var, 0.0))
    half = np.ceil(_HALF_SIGMAS * sigma).astype(np.int64) + _HALF_SLACK
    j0 = np.clip(np.floor(mu).astype(np.int64) - half, lot, hit)
    j1 = np.clip(np.floor(mu).astype(np.int64) + half, lot, hit)

    out_flags = np.zeros(idx.size, dtype=bool)
    sure = np.zeros(idx.size, dtype=bool)

    # Bucket rows by needed window width (powers of two, floor 16): the
    # width varies ~8..500 across rows and a single max-width table
    # wastes several-fold work on the small-sigma majority.
    widths = (j1 - j0 + 1).astype(np.int64)
    order = np.argsort(widths, kind="stable")
    bounds = [0]
    w_sorted = widths[order]
    cap = 16
    while bounds[-1] < idx.size:
        nxt = int(np.searchsorted(w_sorted, cap, side="right"))
        if nxt > bounds[-1]:
            bounds.append(nxt)
        cap *= 2
    for b in range(len(bounds) - 1):
        sel = order[bounds[b] : bounds[b + 1]]
        width = int(w_sorted[bounds[b + 1] - 1])
        chunk = max(1, _CHUNK_ELEMS // (1 << max(width - 1, 1).bit_length()))
        for s in range(0, sel.size, chunk):
            sub = sel[s : s + chunk]
            f, ok = _window_decide(
                xt[sub], Mt[sub], nt[sub], Nt[sub], lot[sub], hit[sub],
                j0[sub], j1[sub], width, psig,
            )
            out_flags[sub] = f
            sure[sub] = ok

    # Borderline / unbounded rows: scipy is the arbiter.
    if not np.all(sure):
        bi = ~sure
        stats["fallback_rows"] += int(bi.sum())
        out_flags[bi] = _scipy_ge(xt[bi], Mt[bi], nt[bi], Nt[bi], psig)

    flags[idx] = out_flags
    return flags.reshape(shape)


def _window_decide(x, M, n, N, lo, hi, j0, j1, width, psig):
    """Decide P(X >= x) < psig per row from an exact pmf window.

    Returns (flags, sure); rows with sure=False need the scipy fallback.
    """
    rows = x.size
    Mf = M.astype(np.float64)
    nf = n.astype(np.float64)
    Nf = N.astype(np.float64)
    j0f = j0.astype(np.float64)
    t = np.arange(width, dtype=np.float64)

    # pmf ratio r(j) = pmf(j+1)/pmf(j) for j = j0..j0+width-1, zeroed at
    # and beyond min(j1, hi) so the cumprod clamps truncated tails to 0.
    # Built in-place on pooled buffers: A=j, B=numerator, C=denominator.
    A, B, C = (buf[:rows] for buf in _buffers(max(rows, 1), width))
    np.add(j0f[:, None], t[None, :], out=A)  # A = j
    np.subtract(nf[:, None], A, out=B)  # B = n - j
    np.subtract(Nf[:, None], A, out=C)  # C = N - j
    B *= C
    np.add(A, 1.0, out=C)  # C = j + 1
    A += ((Mf - nf - Nf) + 1.0)[:, None]  # A = M-n-N+j+1
    C *= A
    B /= C
    num = B
    num *= t[None, :] < (np.minimum(j1, hi) - j0)[:, None]

    # num[t] becomes pmf(j0+1+t)/pmf(j0) via cumprod, then its cumsum
    # C[t] = P(j0+1 <= X <= j0+1+t)/pmf(j0), all contiguous in-place.
    base = np.exp(_log_pmf(j0f, Mf, nf, Nf))
    np.cumprod(num, axis=1, out=num)
    # pmf(j1)/base, read off BEFORE the cumsum: num[j1-j0-1] (1 if j1==j0)
    lp = (j1 - j0)[:, None]
    last_rel = np.take_along_axis(num, np.maximum(lp - 1, 0), axis=1)[:, 0]
    last_rel = np.where(j1 > j0, last_rel, 1.0)
    np.cumsum(num, axis=1, out=num)
    C = num

    total_rel = 1.0 + C[:, -1]  # (window mass) / base; zeros past j1 are inert
    # prefix_below(pos) = P(j0 <= X < j0+pos)/base
    pos = np.clip(x - j0, 0, width - 1)
    before = np.take_along_axis(C, np.maximum(pos[:, None] - 2, 0), axis=1)[:, 0]
    before = np.where(pos >= 2, before + 1.0, np.where(pos == 1, 1.0, 0.0))
    # suffix by subtraction: costs ~total*eps absolute error (_abs below)
    sf_win = (total_rel - before) * base
    total = total_rel * base
    _abs = total * (_REL_ERR + 2e-16 * width)

    # Geometric bound on the truncated upper tail: r(j) is decreasing in
    # j, so pmf(j1+1+s) <= pmf(j1) * r(j1)^(s+1) and the tail is bounded
    # by last * r / (1 - r) for any r < 1.
    truncated_hi = j1 < hi
    with np.errstate(invalid="ignore", divide="ignore"):
        r_end = ((n - j1) * (N - j1)).astype(np.float64) / (
            (j1 + 1.0) * (M - n - N + j1 + 1.0)
        )
    last = last_rel * base
    tail_ok = ~truncated_hi | (r_end < 0.9999)
    with np.errstate(invalid="ignore", divide="ignore"):
        tail_hi = np.where(truncated_hi, last * r_end / (1.0 - r_end), 0.0)
    tail_hi = np.where(tail_ok, tail_hi, np.inf)

    flags = np.zeros(rows, dtype=bool)
    sure = np.zeros(rows, dtype=bool)

    # x below the window: sf(x) >= window mass from j0.
    below = x < j0
    sure |= below & (total - _abs >= psig)  # flag stays 0 (certain)

    # x above the window: sf(x) <= bounded upper tail.
    abv = x > j1
    certain_sig = abv & (tail_hi < psig)
    flags |= certain_sig
    sure |= certain_sig

    # x inside the window: exact suffix sum +- (tail bound, float error).
    inside = ~below & ~abv
    err = sf_win * _REL_ERR + _abs + tail_hi
    sig = inside & (sf_win + err < psig)
    nsig = inside & (sf_win - sf_win * _REL_ERR - _abs >= psig)
    flags |= sig
    sure |= sig | nsig
    return flags, sure
