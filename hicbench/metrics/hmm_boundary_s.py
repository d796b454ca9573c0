"""Seconds a job in the HMM cut search's boundary scans (part 1, host): the
program's timer ``part1/hmm_boundary``, which part 1 lists at 0 where it
fits no HMM."""


def read(r):
    values = [j.timers["part1/hmm_boundary"] for j in r.jobs if "part1/hmm_boundary" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
