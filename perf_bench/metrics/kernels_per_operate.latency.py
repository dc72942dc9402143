"""Device operations (kernels, copies, sets) of one replayed ``operate`` in
the padded trace."""


def read(record):
    t = record.get("trace")
    return None if not t or not t["ops"] else t["ops"] / t["calls"]
