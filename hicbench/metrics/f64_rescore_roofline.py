"""The exact re-scoring kernel's share of its roofline over the window: the
least time of the candidates it re-scored over the kernel's device time in
the trace.  The least time is the larger of the bytes and the adds:

* bytes: the matrix elements each launch reads at least, 8 bytes each (the
  counter ``part2/f64_rescore_launch_elements``: one candidate's
  K(K - 1)/2 a launch, since a launch's candidates all read one matrix,
  and the elements of one candidate are distinct), and every candidate's K
  int32 bin-order entries (``part2/f64_rescore_bins``), at HBM's rate;
* adds: one float64 add for each element a candidate sums
  (``part2/f64_rescore_elements``, K(K - 1)/2 a candidate), at the card's
  add rate, half its f64 operations a second (an add issues at the rate of
  the fused multiply-add, which the data sheet counts as two).

Both are summed over the window's launches before the larger is taken, so
the least time can only be under the sum of each launch's, and the share
under its true value.  Nothing from a program without the counters or a
window that launched the kernel no time; the run fails when the trace holds
another number of its events than ``part2/f64_rescore_launches`` counted."""

import bounds

COUNTERS = ("part2/f64_rescore_launches", "part2/f64_rescore_launch_elements",
            "part2/f64_rescore_bins", "part2/f64_rescore_elements")
F64_ADDS_PER_S = bounds.FP64_OPS_PER_S / 2


def read(r):
    if r.trace is None or not r.jobs or any(c not in j.counters for j in r.jobs
                                            for c in COUNTERS):
        return None
    launches, read_elements, bins, summed = (sum(j.counters[c] for j in r.jobs)
                                             for c in COUNTERS)
    n, seconds = r.trace.kernel("f64_rescore_kernel")
    if n != launches:
        raise RuntimeError(f"trace holds {n} f64_rescore events for {launches} launches")
    if not launches:
        return None
    least_s = max((8 * read_elements + 4 * bins) / bounds.HBM_BYTES_PER_S,
                  summed / F64_ADDS_PER_S)
    return 100.0 * least_s / seconds
