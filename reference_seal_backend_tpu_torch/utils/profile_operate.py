"""Where one ``operate`` of the PyTorch/CUDA port spends its time on the card.

    python3 -m reference_seal_backend_tpu_torch.utils.profile_operate [benchmark ...]

For each named benchmark (default: the CKKS dot product, Latency and Offline
8 x 8; Offline logistic regression runs at its default batch of 100) at its
registered parameters it builds the benchmark through the port's ``Engine``
on the GPU, warms up, and then reports, as one JSON line:

* ``operate_ms``: host clock around ``operate`` ending in a synchronise,
  mean of 5;
* ``device_busy_ms`` / ``idle_share``: sum of CUDA kernel time in one
  profiled ``operate`` (``torch.profiler``) against its wall time;
* ``kernel_launches`` and the ten kernels with the most device time;
* ``ntt_ms`` / ``ntt_launches``: the hand-written NTT kernels' share.

Needs one CUDA card; fails without one.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.descriptor import Category, Workload
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.models.logreg import DEFAULT_BATCH
from reference_seal_backend_tpu_torch.utils.device import card_name_and_power_limit

DEFAULT = ("ckks_dot_product_latency", "ckks_dot_product_offline")
SAMPLES = 8


def profile_one(engine: Engine, name: str) -> dict:
    desc = engine.find(name)
    b = SAMPLES if desc.category is Category.OFFLINE else 1
    batch = [b, b]
    params = None
    if desc.workload is Workload.LOGREG_POLY_D3:  # operands (W, b, X)
        b = DEFAULT_BATCH if desc.category is Category.OFFLINE else 1
        batch = [1, 1, b]
        params = {"batch_size": b}
    bench = engine.create_benchmark(desc, params)
    inputs, _ = runner.gen_inputs(
        desc, bench.params, np.random.default_rng(1234), b, b
    )
    loaded = bench.load(bench.encrypt(bench.encode(inputs)))
    for _ in range(2):
        bench.block(bench.operate(loaded))
    t0 = time.perf_counter()
    for _ in range(5):
        bench.block(bench.operate(loaded))
    operate_ms = (time.perf_counter() - t0) * 1e3 / 5

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        bench.block(bench.operate(loaded))
        profiled_ms = (time.perf_counter() - t0) * 1e3
    kernels = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", 0) or 0
        if dev_us > 0 and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append((ev.key, dev_us / 1e3, ev.count))
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    ntt = [k for k in kernels if "ntt_fwd_" in k[0] or "ntt_inv_" in k[0]]
    return {
        "benchmark": name,
        "batch": batch,
        "operate_ms": operate_ms,
        "profiled_operate_ms": profiled_ms,
        "device_busy_ms": busy,
        "idle_share": None if not kernels else 1.0 - busy / profiled_ms,
        "kernel_launches": sum(k[2] for k in kernels),
        "ntt_ms": sum(k[1] for k in ntt),
        "ntt_launches": sum(k[2] for k in ntt),
        "top_kernels": [
            {"name": k[0][:80], "ms": k[1], "count": k[2]} for k in kernels[:10]
        ],
    }


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    names = argv or DEFAULT
    engine = Engine("cuda")
    print(json.dumps({"card": card_name_and_power_limit(),
                      "torch": torch.__version__}))
    for name in names:
        print(json.dumps(profile_one(engine, name)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
