"""Seconds a job in part 2's scheduler waiting for its readbacks: the program's timer ``part2/scheduler_readback_wait``."""


def read(r):
    values = [j.timers["part2/scheduler_readback_wait"] for j in r.jobs if "part2/scheduler_readback_wait" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
