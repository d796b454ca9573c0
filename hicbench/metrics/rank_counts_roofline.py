"""The rank-count kernel's share of its roofline over the window: the sum
of each launch's least time (``bounds.rank_bound``, from its recorded
parameters) over the kernel's device time in the trace.  Nothing when the
kernel did not run on the card; the run fails when the trace holds another
number of its events than launches were recorded."""

import bounds


def read(r):
    if r.trace is None or not r.rank_calls:
        return None
    n, seconds = r.trace.kernel("rank_counts_")
    if n != len(r.rank_calls):
        raise RuntimeError(f"trace holds {n} rank_counts events for {len(r.rank_calls)} launches")
    least_ms = sum(bounds.rank_bound(c["params"], c["shape"][0], c["shape"][1], c["elem_bytes"],
                                     *c["offsets"])[0] for c in r.rank_calls)
    return 100.0 * least_ms / (1e3 * seconds)
