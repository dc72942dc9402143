"""Hygiene of the port: it imports neither JAX nor the JAX package, asks for
the card by default and raises where there is none, and builds nothing when
it is imported."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "reference_seal_backend_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
# the port's benchmark suite, beside the JAX package's bench.py
BENCH = PKG / "bench.py"
FORBIDDEN = ("jax", "jaxlib", "reference_seal_backend_tpu")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_no_jax_and_no_jax_package(path):
    assert BENCH in SOURCES
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path}: imports {mod}"
    text = path.read_text()
    assert "__import__(" not in text and "importlib" not in text


def _run(code):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run(
        [sys.executable, "-c", code], cwd=str(ROOT), env=env,
        capture_output=True, text=True, timeout=600,
    )


def test_fresh_process_stays_free_of_jax():
    """Import every module of the port and run one CPU eltwise benchmark in a
    fresh interpreter (this process has JAX loaded by the root conftest)."""
    code = """
import importlib, pkgutil, sys
import reference_seal_backend_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
assert "reference_seal_backend_tpu_torch.bench" in sys.modules
from reference_seal_backend_tpu_torch.engine.runner import run_all
res = run_all(["ckks_eltwise_add_latency"], device="cpu", verbose=False,
              params={"poly_modulus_degree": 2048, "sec_level": 0})
assert res[0].passed, res[0].error
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "reference_seal_backend_tpu")]
assert not bad, bad
from reference_seal_backend_tpu_torch.ops.cuda import behz, ntt
assert ntt._lib is None and not behz._libs
print("CLEAN")
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert "CLEAN" in proc.stdout


def test_cuda_without_a_card_raises():
    import torch

    from reference_seal_backend_tpu_torch.engine.registry import Engine
    from reference_seal_backend_tpu_torch.engine.runner import run_all
    from reference_seal_backend_tpu_torch.schemes.params import (
        make_bfv_context,
        make_ckks_context,
    )
    from reference_seal_backend_tpu_torch.utils.device import pick_device

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    for call in (
        lambda: pick_device(),
        lambda: pick_device("cuda"),
        lambda: make_ckks_context(1024, sec_level=0),
        lambda: make_bfv_context(1024, sec_level=0),
        lambda: Engine(),
        lambda: run_all(["ckks_eltwise_add_latency"], verbose=False),
    ):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
    with pytest.raises(ValueError):
        pick_device("xla")
    assert pick_device("cpu").type == "cpu"


def test_cuda_wrapper_neither_builds_on_import_nor_takes_cpu_tensors():
    import torch

    from reference_seal_backend_tpu_torch.ops import ntt as tntt
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

    assert ntt_cuda._lib is None  # importing built and loaded nothing
    assert ntt_cuda.SOURCE.exists()
    plan = tntt.make_plan(64, (12289,), "cpu")
    x = torch.zeros((1, 64), dtype=torch.int32)
    before = dict(ntt_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ntt_cuda.ntt_fwd(x, plan.roots, plan.roots_shoup, plan.p, 0, True, True)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        ntt_cuda.ntt_inv(x, plan.iroots, plan.iroots_shoup, plan.p,
                         plan.n_inv, plan.n_inv_shoup, 0, True)
    assert ntt_cuda.launches == before  # a refused call counts no launch
    assert (plan.fwd(x) == 0).all()     # the CPU tensor took the plain version
    assert ntt_cuda.launches == before
    # the fused BEHZ kernel's wrapper alike
    from reference_seal_backend_tpu_torch.evaluator import behz
    from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
    from reference_seal_backend_tpu_torch.schemes.params import make_bfv_context

    assert not behz_cuda._libs and behz_cuda.SOURCE.exists()
    tb = behz.tables_for(make_bfv_context(1024, sec_level=0, device="cpu"))
    assert not behz_cuda._libs  # tables on the CPU build nothing
    before = dict(behz_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        behz_cuda.floor_sk(torch.zeros((3, 10, 1024), dtype=torch.int32), tb)
    assert behz_cuda.launches == before


def test_chip_smoke_fails_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=str(ROOT),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_plugin_shim_embeds_the_port_not_the_jax_package():
    """The port's plugin library imports the port's capi and exports the
    one ABI: it includes ``native/include/rsb_tpu_backend.h`` unchanged."""
    shim = (PKG / "csrc" / "capi_shim.cpp").read_text()
    assert '"reference_seal_backend_tpu_torch.engine.capi"' in shim
    assert "reference_seal_backend_tpu.engine.capi" not in shim
    assert '#include "rsb_tpu_backend.h"' in shim
    from reference_seal_backend_tpu_torch.engine import native

    assert native.HEADER_DIR == ROOT / "native" / "include"
    assert native.HARNESS_SOURCE == ROOT / "native" / "src" / "native_harness.cpp"
    # importing builds nothing (asked in a fresh process: an earlier test in
    # this one may have built the library)
    proc = subprocess.run(
        [sys.executable, "-c",
         "from reference_seal_backend_tpu_torch.engine import native; "
         "assert native._built is None"],
        cwd=str(ROOT), capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
