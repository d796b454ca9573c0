"""Seconds a job in the HMM fits' k-means initialisation (part 1, host): the program's timer ``part1/hmm_kmeans``."""


def read(r):
    values = [j.timers["part1/hmm_kmeans"] for j in r.jobs if "part1/hmm_kmeans" in j.timers]
    return sum(values) / len(values) if len(values) == len(r.jobs) and values else None
