"""Part 2's candidates re-scored in float64 a job, from every stage: the
program's counter ``part2/f64_rescore_candidates`` (each a memo miss of a
batch, on the card or on the host).  Nothing from a program without the
counter."""

NAME = "part2/f64_rescore_candidates"


def read(r):
    if not r.jobs or any(NAME not in j.counters for j in r.jobs):
        return None
    return sum(j.counters[NAME] for j in r.jobs) / len(r.jobs)
