"""Part 2's wall seconds a job: the CLI's clock around the part."""


def read(r):
    values = [j.part_seconds["part2"] for j in r.jobs if "part2" in j.part_seconds]
    return sum(values) / len(values) if values else None
