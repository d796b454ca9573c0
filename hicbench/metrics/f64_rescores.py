"""Part 2's float64 re-scorings a job (cache misses of the sliding
window's re-scoring): the program's counter ``part2/f64_rescore_miss``."""


def read(r):
    if not r.jobs or any("part2/host_decide" not in j.timers for j in r.jobs):
        return None
    return sum(j.counters.get("part2/f64_rescore_miss", 0) for j in r.jobs) / len(r.jobs)
