"""Part 1's wall seconds a job: the CLI's clock around the part."""


def read(r):
    values = [j.part_seconds["part1"] for j in r.jobs if "part1" in j.part_seconds]
    return sum(values) / len(values) if values else None
