"""Seconds a job in UPGMA clustering (part 1): the program's timer ``part1/upgma``."""


def read(r):
    values = [j.timers["part1/upgma"] for j in r.jobs if "part1/upgma" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
