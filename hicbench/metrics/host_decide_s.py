"""Seconds a job in part 2's host decisions between device batches: the program's timer ``part2/host_decide``."""


def read(r):
    values = [j.timers["part2/host_decide"] for j in r.jobs if "part2/host_decide" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
