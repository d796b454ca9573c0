"""Parts 3 and 4's wall seconds a job: the CLI's clock around each part."""


def read(r):
    values = [j.part_seconds["part3"] + j.part_seconds["part4"] for j in r.jobs
              if "part3" in j.part_seconds and "part4" in j.part_seconds]
    return sum(values) / len(values) if values else None
