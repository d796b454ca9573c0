"""The HMM forward-backward kernel's share of its roofline over the
window: the sum of each launch's least time (``bounds.hmm_bound_ms`` at its
recorded frame count) over the kernel's device time in the trace.  Nothing
when the kernel did not run on the card; the run fails when the trace holds
another number of its events than launches were recorded."""

import bounds


def read(r):
    if r.trace is None or not r.hmm_calls:
        return None
    n, seconds = r.trace.kernel("forward_backward_kernel")
    if n != len(r.hmm_calls):
        raise RuntimeError(f"trace holds {n} forward_backward events for {len(r.hmm_calls)} launches")
    least_ms = sum(bounds.hmm_bound_ms("hmm_forward_backward", T)[0] for T in r.hmm_calls)
    return 100.0 * least_ms / (1e3 * seconds)
