"""The port's plugin library (``librsb_torch_backend.so``, built from
``reference_seal_backend_tpu_torch/csrc/capi_shim.cpp`` by
``reference_seal_backend_tpu_torch/engine/native.py``) driven by the
unchanged harness source ``native/src/native_harness.cpp``, on the CPU
(``RSB_TORCH_DEVICE=cpu``): the counterpart of ``tests/test_native.py``,
which drives the JAX package's library with the same harness.

The pipeline runs in the harness binary as a subprocess (the realistic
embedding, and an embedding fault cannot take pytest down with it); the
registry surface also in process, through ``ctypes.CDLL``.  Skips only where
there is no C++ compiler or no shared libpython to embed."""

import ctypes
import json
import os
import shutil
import subprocess
import sysconfig

import pytest
import torch

from reference_seal_backend_tpu.engine import capi as jcapi
from reference_seal_backend_tpu_torch.engine import capi as tcapi
from reference_seal_backend_tpu_torch.engine import native


@pytest.fixture(scope="module")
def built():
    if shutil.which("g++") is None:
        pytest.skip("no C++ compiler (g++)")
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        pytest.skip("this interpreter has no shared libpython to embed")
    return native.build()


def _harness(built, *args, device="cpu", timeout=600):
    env = native.embedded_env(device)
    if device is None:
        del env[tcapi.DEVICE_ENV]
    # one PyTorch thread: the suite runs several workers on one machine
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [str(built.harness), *args], env=env, capture_output=True, text=True,
        timeout=timeout,
    )


def test_harness_end_to_end(built):
    """The seven steps through the C ABI: seeded inputs, truth computed by
    the harness, the 'Failed: 0' contract."""
    r = _harness(built, "--poly", "2048", "--n", "64")
    assert "[ Info    ] Total: 3" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "[ Info    ] Failed: 0" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert r.returncode == 0


def test_harness_full_registry(built):
    """Every one of the 20 registered descriptors crosses the C ABI: BFV
    compared exactly, the three matrix-multiply packings, logistic
    regression; the harness's own sizes (Offline 2 x 3 samples, matrices
    4x3 by 3x5, logistic-regression batch 1 and 4)."""
    r = _harness(built, "--all", "--poly", "2048")
    assert "[ Info    ] Total: 20" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert "[ Info    ] Failed: 0" in r.stdout, (r.stdout, r.stderr[-2000:])
    assert r.stdout.count("[ OK     ]") == 20
    assert r.returncode == 0


def test_harness_error_surface(built):
    r = _harness(built, "--poly", "2048", "no_such_benchmark", timeout=300)
    assert r.returncode == 1
    assert "Failed: 1" in r.stdout
    assert "no_such_benchmark" in r.stderr


def test_no_device_means_the_card(built):
    """Without ``RSB_TORCH_DEVICE`` the engine asks for the card; where
    there is none, ``rsbtpu_engine_create`` fails with a message and the
    harness stops: nothing runs on the CPU by itself."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    r = _harness(built, "--poly", "2048", device=None, timeout=300)
    assert r.returncode == 2, (r.stdout, r.stderr[-2000:])
    assert "engine_create" in r.stderr and "cuda" in r.stderr
    assert "[ OK" not in r.stdout


def test_registry_in_process(built, monkeypatch):
    """The library loaded into this interpreter with ``ctypes.CDLL``: its
    embedded interpreter is this one (the port's capi module is shared), and
    names and descriptor JSON equal the JAX capi's."""
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")
    lib = native.load_library()
    assert lib.rsbtpu_initialize() == 0
    eng = lib.rsbtpu_engine_create()
    assert eng > 0, native.take_string(lib, lib.rsbtpu_last_error())
    assert tcapi._engines[eng].device == torch.device("cpu")
    assert lib.rsbtpu_benchmark_count(eng) == 20
    jeid = jcapi.engine_create()
    for i in range(20):
        buf = ctypes.create_string_buffer(128)
        n = lib.rsbtpu_benchmark_name(eng, i, buf, 128)
        assert n > 0 and buf.value.decode() == jcapi.engine_benchmark_name(jeid, i)
        buf = ctypes.create_string_buffer(4096)
        assert lib.rsbtpu_benchmark_descriptor(eng, i, buf, 4096) > 0
        assert buf.value.decode() == jcapi.engine_benchmark_descriptor(jeid, i)
    d = json.loads(buf.value.decode())
    assert d["security"] == "128 bits" and d["cat_params"]["data_count"]
    # a short buffer takes a NUL-terminated prefix; the full length comes back
    small = ctypes.create_string_buffer(8)
    assert lib.rsbtpu_benchmark_name(eng, 0, small, 8) > 7
    assert len(small.value) == 7
    # the error surface through the ABI
    assert lib.rsbtpu_benchmark_create(eng, b"no_such_benchmark", b"") < 0
    assert "no_such_benchmark" in native.take_string(lib, lib.rsbtpu_last_error())
    # createEngine(p_buffer, size): the bytes are recorded, not interpreted
    with_data = lib.rsbtpu_engine_create_with_data(b"\x01\x02", 2)
    assert with_data > 0, native.take_string(lib, lib.rsbtpu_last_error())
    assert tcapi._engines[with_data].init_data == b"\x01\x02"
    lib.rsbtpu_engine_destroy(with_data)
    lib.rsbtpu_engine_destroy(eng)
    jcapi.engine_destroy(jeid)


def test_api_version_check(built):
    """Major and minor exact, revision at least the one required (the
    reference's createEngine rule); the outputs of ``native.build`` are named
    as the ABI's users expect, and a second build reuses them."""
    lib = native.load_library()
    assert lib.rsbtpu_api_version_check(1, 0, 0) == 0
    assert lib.rsbtpu_api_version_check(1, 0, 1) == 0
    assert lib.rsbtpu_api_version_check(2, 0, 0) < 0   # major mismatch
    assert lib.rsbtpu_api_version_check(1, 1, 0) < 0   # minor mismatch
    assert lib.rsbtpu_api_version_check(1, 0, 99) < 0  # needs a newer revision
    assert built.library.name == "librsb_torch_backend.so"
    assert built.harness.name == "rsb_torch_harness"
    assert built.library.parent.parent == native.BUILD_DIR
    again = native.build()
    assert again.library == built.library and again.seconds == 0.0
    assert os.access(built.harness, os.X_OK)


def test_smoke_reads_the_harness_sizes():
    """``chip_smoke.py`` feeds the library, in process, what the harness
    feeds it; the sizes are read from ``native/src/native_harness.cpp``, so
    a change there shows here and not first on the card."""
    import importlib.util
    from pathlib import Path

    from reference_seal_backend_tpu_torch.engine.registry import Engine

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sizes = smoke.harness_sizes()
    assert sizes == {"sec_level": (8192, 128), "offline_samples": (2, 3),
                     "matrices": (4, 3, 5), "logreg": (16, 4)}
    case = lambda name, poly: smoke.harness_case(name, poly, 100, sizes)
    assert case("bfv_dot_product_offline", 8192) == (
        {"poly_modulus_degree": 8192, "n": 100, "sec_level": 128}, 2, 3)
    assert case("ckks_matrix_multiply_row_latency", 8192) == (
        {"poly_modulus_degree": 8192, "rows_m0": 4, "cols_m0": 3,
         "cols_m1": 5, "sec_level": 128}, 1, 1)
    assert case("ckks_logistic_regression_poly_d3_offline", 16384) == (
        {"poly_modulus_degree": 16384, "n": 16, "batch_size": 4,
         "sec_level": 128}, 1, 1)
    assert case("ckks_eltwise_add_latency", 2048)[0]["sec_level"] == 0
    # the two harness calls cover every registered descriptor once
    runs = [n for _, _, names in smoke.HARNESS_RUNS for n in names]
    assert sorted(runs) == sorted(Engine("cpu").names())
