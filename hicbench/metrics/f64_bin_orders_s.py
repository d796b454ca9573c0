"""Seconds a job in the host side of part 2's float64 re-scores, from every
stage: the program's timer ``part2/f64_bin_orders`` around the bin orders of
each ``SubsetScorer.score_host_many`` call, their memo keys and lookups and
the misses' stacking (the re-scoring itself, ``part2/f64_rescore``, outside
it), which part 2 lists at 0 where it re-scores nothing; nothing where the
program lacks the timer."""


def read(r):
    values = [j.timers["part2/f64_bin_orders"] for j in r.jobs if "part2/f64_bin_orders" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
