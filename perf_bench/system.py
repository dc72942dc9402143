"""The system under test: ``reference_seal_backend_tpu_torch``, driven as the
HEBench harness drives a backend.  The only module of the benchmark that
imports the program; from it the benchmark takes the engine's benchmark
object, its pipeline steps, and the transforms it asks of ``NttPlan``.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import List, Tuple

from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
from reference_seal_backend_tpu_torch.utils import staging


def descriptor_name(config: dict, category: str) -> str:
    variant = config.get("variant")
    workload = f"{config['workload']}_{variant}" if variant else config["workload"]
    return f"{config['scheme']}_{workload}_{category}"


class System:
    """One benchmark of the port's engine, built from a configuration, a
    traffic category and the samples per operand, its keys from
    ``key_seed``.  The engine's descriptor is found by name: scheme,
    workload, the configuration's ``variant`` where it has one (the matrix
    multiplies' ``cipherbatchaxis`` and ``row``), category.
    ``context_keys_s``: host seconds of ``create_benchmark`` (context, NTT
    plans, public, relinearization and Galois keys)."""

    def __init__(self, device: str, config: dict, category: str,
                 counts: List[int], key_seed: int):
        engine = Engine(device)
        desc = engine.find(descriptor_name(config, category))
        params = dict(config["params"], key_seed=key_seed)
        if category == "offline" and config.get("batch_param"):
            params[config["batch_param"]] = counts[-1]
        t0 = time.perf_counter()
        self.bench = engine.create_benchmark(desc, params)
        self.context_keys_s = time.perf_counter() - t0

    def load(self, inputs):
        """encode -> encrypt -> load of one input set, finished."""
        b = self.bench
        return b.block(b.load(b.encrypt(b.encode(inputs))))

    def operate(self, loaded):
        return self.bench.operate(loaded)

    def block(self, handle):
        """Wait until the device has finished what was queued."""
        return self.bench.block(handle)

    def answers(self, result) -> List:
        """store -> decrypt -> decode of one ``operate`` result."""
        b = self.bench
        return b.decode(b.decrypt(b.store(result)))

    def eager(self):
        """Within the block, ``operate`` runs its stages eagerly."""
        return staging.eager(self.bench)

    def release(self) -> None:
        self.bench.release_graphs()
        self.bench = None

    @contextlib.contextmanager
    def transforms(self):
        """Within the block, every transform asked of ``NttPlan.fwd`` /
        ``inv`` is noted in the yielded list as ``(name, polys, limbs, N)``:
        ``polys`` the polynomials (rows x limbs) of the ``[..., limbs, N]``
        input."""
        noted: List[Tuple[str, int, int, int]] = []
        fwd, inv = ntt_mod.NttPlan.fwd, ntt_mod.NttPlan.inv

        def note(name, x):
            noted.append((name, math.prod(x.shape[:-1]), x.shape[-2], x.shape[-1]))

        def fwd_noted(plan, x, *args, **kwargs):
            note("ntt_fwd", x)
            return fwd(plan, x, *args, **kwargs)

        def inv_noted(plan, x, *args, **kwargs):
            note("ntt_inv", x)
            return inv(plan, x, *args, **kwargs)

        ntt_mod.NttPlan.fwd, ntt_mod.NttPlan.inv = fwd_noted, inv_noted
        try:
            yield noted
        finally:
            ntt_mod.NttPlan.fwd, ntt_mod.NttPlan.inv = fwd, inv
