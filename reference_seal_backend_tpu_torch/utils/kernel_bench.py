"""Timing of kernels on the card: seeded residue inputs and two ways to time
a call with CUDA events, used by ``chip_smoke.py``.

Run as a script it times the NTT kernels of whichever copy of this package
comes first on the import path, so that two versions of the kernels (two
commits, or a design variant in a copy of the tree) are read by one method,
one after the other on one card:

    PYTHONPATH=<tree> python3 reference_seal_backend_tpu_torch/utils/kernel_bench.py [log_n ...]

For each size (default 13, N = 8192) it holds both kernels against the
plain versions (tolerance 0) and prints one JSON line with their time at a
many-wave shape ``[64, 7, N]`` and a one-wave shape ``[1, 1, 6, N]``, as a
CUDA graph's replay (device time) and as a loop of launches the host makes
one by one.
Needs one CUDA card and ``nvcc``; fails without them."""

from __future__ import annotations

import json
import sys

import torch

from reference_seal_backend_tpu_torch.ops import modops


def random_residues(gen, primes, lead, lo, nl, n, bound_mult, device):
    """``[*lead, nl, n]`` uint32 residues below ``bound_mult * p`` for the
    limbs ``lo .. lo + nl`` of ``primes``, as a storage tensor."""
    cols = [
        torch.randint(0, bound_mult * p, (*lead, n), generator=gen,
                      dtype=torch.int64, device=device)
        for p in primes[lo : lo + nl]
    ]
    return modops.narrow(torch.stack(cols, dim=-2))


def _replay_ms(run, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def time_eager_ms(fn, inputs, reps):
    """Mean milliseconds per call over ``reps`` calls launched one by one from
    the host, by CUDA events; the calls walk over ``inputs`` so that no call
    finds its input in L2.  Where a call's device time is below the host's
    time to launch it (tens of microseconds through Python) this reads the
    host: it suits the plain versions, and is kept beside
    :func:`time_graph_ms` for the kernels."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()

    def run():
        for i in range(reps):
            fn(inputs[i % len(inputs)])

    return _replay_ms(run, reps)


def time_graph_ms(fn, inputs, reps):
    """Mean device milliseconds per call: ``reps`` calls, walking over
    ``inputs``, are captured into one CUDA graph, and a replay of the graph
    is timed by CUDA events.  The launches then run back to back on the card
    whatever the host needs to launch one."""
    for x in inputs:
        fn(x)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(inputs[i % len(inputs)])
    graph.replay()
    torch.cuda.synchronize()
    return _replay_ms(graph.replay, reps)


def main(argv) -> int:
    from reference_seal_backend_tpu_torch.nums import primegen
    from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
    from reference_seal_backend_tpu_torch.utils.device import card_name_and_power_limit

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(1234)
    for log_n in [int(a) for a in argv] or [13]:
        n = 1 << log_n
        plan = ntt_mod.make_plan(n, tuple(primegen.gen_ntt_primes(7, 30, 2 * n)), device)
        x = random_residues(gen, plan.primes, (3,), 0, 7, n, 1, device)
        if not (torch.equal(plan.fwd(x), plan.fwd_plain(x))
                and torch.equal(plan.inv(x), plan.inv_plain(x))):
            print(f"a kernel differs from its plain version at N={n}", file=sys.stderr)
            return 1
        row = {"package": ntt_mod.__file__, "card": card_name_and_power_limit(),
               "log_n": log_n}
        n_sets = max(2, -(-60_000_000 // (64 * 7 * n * 4)))
        many = list(random_residues(
            gen, plan.primes, (n_sets, 64), 0, 7, n, 1, device).unbind(0))
        one = list(random_residues(
            gen, plan.primes, (320, 1, 1), 0, 6, n, 1, device).unbind(0))
        for shape, inputs, reps in (("many_waves", many, 100), ("one_wave", one, 320)):
            row[shape] = {
                "shape": list(inputs[0].shape),
                "ntt_fwd_graph_ms": time_graph_ms(plan.fwd, inputs, reps),
                "ntt_inv_graph_ms": time_graph_ms(plan.inv, inputs, reps),
                "ntt_fwd_eager_ms": time_eager_ms(plan.fwd, inputs, reps),
                "ntt_inv_eager_ms": time_eager_ms(plan.inv, inputs, reps),
            }
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
