"""A cell is added with files alone: a configuration, a traffic mix and a
limits file under a new root are found by name and run at a tiny size on
the CPU, and no file of the benchmark changes."""

from __future__ import annotations

import hashlib
import json

import pytest

from perf_bench.conftest import HERE, TINY_N, run_cell

#: a plain reference that a later PR would add with a matrix-multiply cell
MATMULT_REFERENCE = '''
import numpy as np


def answers(inputs, scheme, dtype=None):
    if dtype is None:
        dtype = np.float64 if scheme == "ckks" else np.int64
    m0, m1 = (np.asarray(x).astype(dtype) for x in inputs)
    return [m0 @ m1]
'''


def add_matmult_cell(root, variant):
    """A matrix-multiply variant added to a root with files and entries
    alone: its configuration, its reference and its limits."""
    data = root / "pb_tiny"
    name = f"tiny_matmult_{variant}"
    config = {"name": name, "scheme": "ckks", "workload": "matrix_multiply",
              "variant": variant, "reference": "matrix_multiply", "data_count": [1, 1],
              "params": {"rows_m0": 10, "cols_m0": 9, "cols_m1": 8,
                         "poly_modulus_degree": TINY_N, "mult_depth": 2, "sec_level": 0}}
    (data / "configs" / f"{name}.json").write_text(json.dumps(config))
    (data / "references").mkdir(exist_ok=True)
    (data / "references" / "matrix_multiply.py").write_text(MATMULT_REFERENCE)
    (data / "limits" / f"{name}.latency.json").write_text(json.dumps({"max_abs_gap": 1e-6}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": name, "source": "tiny", "file": f"pb_tiny/configs/{name}.json",
                             "reduced": ["poly_modulus_degree"], "why": "CPU test"})
    bench["workloads"].append({"name": f"{name}.latency", "config": name,
                               "traffic": "latency", "chips": 1, "why": "CPU test"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return f"{name}.latency"


def _digest():
    h = hashlib.sha256()
    for path in sorted(HERE.rglob("*")):
        if path.is_file() and "__pycache__" not in path.parts:
            h.update(str(path.relative_to(HERE)).encode() + path.read_bytes())
    return h.hexdigest()


def test_cell_from_files_runs_at_a_tiny_size(tiny_root):
    before = _digest()
    rc, result, err = run_cell(["--workload", "tiny_logreg.tiny_offline", "--seed", "2147483659",
                                "--seconds", "0.5", "--device", "cpu", "--root", str(tiny_root)])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"operate_ms", "results_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert result["checks"]["max_abs_gap"]["value"] <= 1e-6
    assert result["device"]["platform"] == "cpu"
    # the compared numbers are also the last lines of standard error
    assert err.strip().splitlines()[-2].startswith("check max_abs_gap ")
    assert _digest() == before


@pytest.mark.parametrize("variant", ["cipherbatchaxis", "row"])
def test_a_matrix_multiply_variant_is_added_from_files(tiny_root, variant):
    from perf_bench.cell import load
    from perf_bench.system import descriptor_name

    before = _digest()
    workload = add_matmult_cell(tiny_root, variant)
    # the variant's own descriptor, not the plain matrix multiply's
    config = load(tiny_root, workload).config
    assert descriptor_name(config, "latency") == f"ckks_matrix_multiply_{variant}_latency"
    rc, result, err = run_cell(["--workload", workload, "--seed", "2147483677",
                                "--seconds", "0.3", "--device", "cpu", "--root", str(tiny_root)])
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, result["checks"]
    assert result["checks"]["answers_missing"]["value"] == 0
    assert "operate_ms" in result["metrics"]
    assert _digest() == before
