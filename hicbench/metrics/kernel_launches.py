"""The program's hand-written kernel launches a job: its three launch
tables (rank counts, scoring kernels, HMM scans), summed."""


def read(r):
    if not r.jobs:
        return None
    return sum(sum(j.launches.values()) for j in r.jobs) / len(r.jobs)
