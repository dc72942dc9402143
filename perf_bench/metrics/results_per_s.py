"""Results completed in the window over the window's time (host clock); a
result is one pair's product or dot product, or one sample's inference."""


def read(record):
    w = record.get("window")
    return None if not w else w["calls"] * record["results_per_call"] / w["seconds"]
