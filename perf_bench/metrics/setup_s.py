"""Process start to the first timed call (host clock)."""


def read(record):
    return record["setup_s"]
