"""The first ``operate``: each stage's eager warm-up and CUDA-graph capture,
and one replay (host clock)."""


def read(record):
    return record["spans"]["first_operate_s"]
