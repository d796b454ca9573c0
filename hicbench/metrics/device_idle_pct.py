"""Share of the window in which the device ran nothing: 1 - the union of
kernel, copy and memset intervals in the profiler's trace over the window."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)
