"""``create_benchmark``: context, plans, public, relinearization and Galois
keys (host clock)."""


def read(record):
    return record["spans"]["context_keys_s"]
