"""Nothing the benchmark runs imports JAX or the JAX package, top-level
names compared whole (the port's name begins with the JAX package's); the
references import nothing of the port; and a run refuses to give a result
where such a module is loaded, or where the program is missing."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from perf_bench import run
from perf_bench.conftest import HERE, REPO, clean_env, run_cell

CHECK = f"""
import json, sys
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
from perf_bench import cell, control, run, system
for w in json.loads(Path({str(REPO / 'BENCHMARK.json')!r}).read_text())["workloads"]:
    c = cell.load(Path({str(REPO)!r}), w["name"])
    c.reference()
    for m in c.end_to_end + c.per_layer:
        c.reader(m["name"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CHECK], capture_output=True, text=True,
                         check=True, env=clean_env(), timeout=300).stdout
    top = set(json.loads(out.strip().splitlines()[-1]))
    assert "reference_seal_backend_tpu_torch" in top  # the system under test
    assert not top & set(run.FORBIDDEN), top & set(run.FORBIDDEN)


def test_names_are_compared_whole(monkeypatch):
    for k in [k for k in sys.modules if k.split(".")[0] in run.FORBIDDEN]:
        monkeypatch.delitem(sys.modules, k)
    monkeypatch.setitem(sys.modules, "reference_seal_backend_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "reference_seal_backend_tpu.engine", sys)
    assert run.forbidden_modules() == ["reference_seal_backend_tpu"]


def test_a_run_that_holds_jax_gives_no_result(tiny_root):
    rc, result, err = run_cell(
        ["--workload", "tiny_dot.latency", "--seed", "5", "--seconds", "0.2",
         "--device", "cpu", "--root", str(tiny_root)], prelude="import jax")
    assert rc != 0 and result is None
    assert "jax" in err.strip().splitlines()[-1]


def test_without_the_program_no_result(tmp_path):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "perf_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = clean_env()
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, "-m", "perf_bench.run", "--workload", "ckks_logreg_n16384.latency",
         "--seed", "5", "--seconds", "1", "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "the program is missing" in proc.stderr
