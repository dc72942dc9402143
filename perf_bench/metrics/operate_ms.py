"""The window's wall time over its ``operate`` calls (host clock)."""


def read(record):
    w = record.get("window")
    return None if not w else w["seconds"] / w["calls"] * 1e3
