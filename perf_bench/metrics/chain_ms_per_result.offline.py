"""Device time of a call's operations other than the NTT kernels (the
evaluator's elementwise chains, copies), over the call's results, in ms."""


def read(record):
    t = record.get("trace")
    if not t or not t["ops"]:
        return None
    return (t["op_s"] - t["ntt_s"]) / t["calls"] / record["results_per_call"] * 1e3
