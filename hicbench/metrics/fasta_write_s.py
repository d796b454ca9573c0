"""Seconds a job in part 4's writer of the assembled FASTA (host): the
program's timer ``part4/write``."""


def read(r):
    values = [j.timers["part4/write"] for j in r.jobs if "part4/write" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
