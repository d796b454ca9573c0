"""Seconds a job in part 1's log transform of the similarity matrix (host):
the program's timer ``part1/log_transform``, which part 1 lists at 0 where
it searches no cuts."""


def read(r):
    values = [j.timers["part1/log_transform"] for j in r.jobs if "part1/log_transform" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
