"""Fixtures of the benchmark's CPU tests: a root of tiny cells, whose files
are added under a temporary directory, never into the benchmark's own."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
HERE = REPO / "perf_bench"

#: the tiny sizes of the CPU runs: the cells' configurations at N = 2048,
#: 128-bit enforcement off (``sec_level`` 0), as the port's CPU tests run them
TINY_N = 2048


def _tiny_config(name: str, source: str) -> dict:
    config = json.loads((HERE / "configs" / f"{source}.json").read_text())
    config["name"] = name
    config["params"] = dict(config["params"], poly_modulus_degree=TINY_N, sec_level=0)
    return config


def make_root(root: Path) -> Path:
    """A root with BENCHMARK.json, two tiny configurations and a tiny
    Offline mix; the metrics and the Latency mix are the benchmark's own."""
    data = root / "pb_tiny"
    for d in ("configs", "traffic", "limits"):
        (data / d).mkdir(parents=True, exist_ok=True)
    configs = {"tiny_logreg": "ckks_logreg_n16384", "tiny_dot": "bfv_dot_n8192"}
    for name, source in configs.items():
        (data / "configs" / f"{name}.json").write_text(json.dumps(_tiny_config(name, source)))
    (data / "traffic" / "tiny_offline.json").write_text(json.dumps(
        {"category": "offline", "sample_size": 4, "input_sets": 2, "checked_calls": 3,
         "trace_calls": 2}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["paths"] = ["pb_tiny"]
    bench["configs"] = [{"name": n, "source": "tiny", "file": f"pb_tiny/configs/{n}.json",
                         "reduced": ["poly_modulus_degree"], "why": "CPU test"} for n in configs]
    bench["workloads"] = []
    for n in configs:
        for mix in ("latency", "tiny_offline"):
            bench["workloads"].append({"name": f"{n}.{mix}", "config": n, "traffic": mix,
                                       "chips": 1, "why": "CPU test"})
            limit = 0 if n == "tiny_dot" else 1e-6
            (data / "limits" / f"{n}.{mix}.json").write_text(json.dumps({"max_abs_gap": limit}))
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)


def clean_env() -> dict:
    """The environment of a run in a fresh interpreter: no JAX platform, and
    one thread for torch (the tests run beside each other)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    env.pop("JAX_PLATFORMS", None)
    return env


def run_cell(args, prelude: str = "", timeout: int = 600):
    """``perf_bench.run.main(args)`` in a fresh interpreter (the run refuses
    a process that holds JAX, which this test process does), after
    ``prelude``.  Returns ``(exit code, result line or None, stderr)``."""
    code = (f"import sys\nsys.path.insert(0, {str(REPO)!r})\n{prelude}\n"
            f"from perf_bench import run\nsys.exit(run.main({list(args)!r}))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO), env=clean_env())
    lines = proc.stdout.strip().splitlines()
    result = None
    if proc.returncode == 0 and lines:
        result = json.loads(lines[-1])
    return proc.returncode, result, proc.stderr
