"""Seconds a job in part 1's cut search: the program's timer of the
branch the configuration runs (``part1/cut_detection_hypergeom`` or
``part1/cut_detection_hmm``)."""

TIMERS = ("part1/cut_detection_hypergeom", "part1/cut_detection_hmm")


def read(r):
    values = [sum(j.timers[t] for t in TIMERS if t in j.timers) for j in r.jobs
              if any(t in j.timers for t in TIMERS)]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
