"""Seconds a job in part 2's float64 re-scores, from every stage (host):
the program's timer ``part2/f64_rescore`` around each memo miss of
``SubsetScorer.score_host``, which part 2 lists at 0 where it re-scores
nothing."""


def read(r):
    values = [j.timers["part2/f64_rescore"] for j in r.jobs if "part2/f64_rescore" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
