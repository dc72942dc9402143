"""The slice as a whole: the port's harness runner vs the JAX package's on
the six CKKS eltwise and dot-product descriptors (eltwise at N=2048 because
n=1000 needs >= 1000 slots, dot product at N=1024), ``sec_level=0``, seed
1234, sample size 2, ``device="cpu"``; the registry (all 20 descriptors), the
runner's reports over the eleven CKKS descriptors and the configuration tier
over all 20 (logistic regression and matrix multiply are held against the JAX
package in test_torch_logreg.py and test_torch_matmult.py, the nine BFV
descriptors in the test_torch_bfv_*.py files).  ``operate``'s result ciphertext must be equal bit for bit
(tolerance 0); decoded outputs equal to ``atol=1e-9, rtol=0`` (same numpy
code over identical integers) and within the runner's 5e-5 of the truth."""

import csv
import os

import numpy as np
import pytest

from reference_seal_backend_tpu.engine import runner as jrunner
from reference_seal_backend_tpu.engine.registry import Engine as JEngine
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine

from torch_port_util import pipeline_both

SIX = (
    "ckks_eltwise_add_latency",
    "ckks_eltwise_mult_latency",
    "ckks_dot_product_latency",
    "ckks_eltwise_add_offline",
    "ckks_eltwise_mult_offline",
    "ckks_dot_product_offline",
)
ELEVEN = SIX + (
    "ckks_logistic_regression_poly_d3_latency",
    "ckks_logistic_regression_poly_d3_offline",
    "ckks_matrix_multiply_latency",
    "ckks_matrix_multiply_cipherbatchaxis_latency",
    "ckks_matrix_multiply_row_latency",
)
SEED = 1234
SAMPLES = 2


def _params(name):
    p = {"poly_modulus_degree": 2048 if "eltwise" in name else 1024,
         "sec_level": 0}
    if "matrix_multiply" in name:
        p.update(rows_m0=3, cols_m0=4, cols_m1=2)
    return p


def test_engine_registers_exactly_the_ported_six():
    """Since the BFV slice: all 20 descriptors of the reference, the nine
    BFV ones at N=8192 with a BFV context of the registered parameters."""
    eng = TEngine("cpu")
    jeng = JEngine()
    assert len(eng.names()) == 20
    assert eng.names() == jeng.names()
    assert set(ELEVEN) <= set(eng.names())
    for name in eng.names():  # same registered parameters as the reference
        assert eng.find(name).default_params == jeng.find(name).default_params
        assert eng.find(name).default_params["poly_modulus_degree"] == (
            16384 if "logistic" in name else 8192
        )
        assert eng.find(name).other == jeng.find(name).other
        assert eng.find(name).data_type == jeng.find(name).data_type
    bfv = [n for n in eng.names() if n.startswith("bfv_")]
    assert len(bfv) == 9
    b = eng.create_benchmark(eng.find("bfv_eltwise_add_latency"))
    assert b.ctx.scheme == "bfv" and b.describe()["security"] == "128 bits"
    assert (b.ctx.n, b.ctx.L, b.ctx.digit_group) == (8192, 4, 2)


@pytest.mark.parametrize("name", SIX)
def test_pipeline_bit_exact(name, monkeypatch):
    b = SAMPLES if name.endswith("offline") else 1
    tout, jout, want, _, _ = pipeline_both(name, _params(name), b, monkeypatch)
    assert len(tout) == len(jout) == len(want) == b * b
    for g, j, w in zip(tout, jout, want):
        np.testing.assert_allclose(g, j, atol=1e-9, rtol=0)
        np.testing.assert_allclose(g, np.asarray(w).reshape(-1), atol=5e-5, rtol=0)


def test_run_all_failed_zero_and_same_reports(tmp_path, capsys):
    per = {name: {"params": _params(name)} for name in ELEVEN}
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    results = trunner.run_all(
        ELEVEN, seed=SEED, sample_size=SAMPLES, report_dir=tdir,
        per_benchmark=per, min_test_time_ms=0, device="cpu",
    )
    out = capsys.readouterr().out
    assert "[ Info    ] Total: 11" in out and "[ Info    ] Failed: 0" in out
    assert out.count("[ OK     ]") == 11
    assert all(r.passed and r.iterations >= 1 for r in results)
    assert all(r.ntt_launches_per_operate == 0 for r in results)  # CPU: plain
    jrunner.run_all(
        ["ckks_eltwise_add_latency"], seed=SEED, report_dir=jdir,
        params=_params("ckks_eltwise_add_latency"), verbose=False,
    )
    for fname in ("report.csv", "summary.csv", "descriptions.csv"):
        with open(os.path.join(tdir, fname)) as f:
            trows = list(csv.reader(f))
        with open(os.path.join(jdir, fname)) as f:
            jrows = list(csv.reader(f))
        assert trows[0] == jrows[0], fname  # same header
    with open(os.path.join(tdir, "summary.csv")) as f:
        assert list(csv.reader(f))[1] == ["11", "0"]


def test_cli_on_cpu(tmp_path, capsys):
    rc = trunner.main([
        "--device", "cpu", "--benchmarks", "ckks_eltwise_add_latency",
        "ckks_dot_product_latency", "--poly_modulus_degree", "2048",
        "--sec_level", "0", "--report_root_path", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "[ Info    ] Failed: 0" in out


def test_cli_on_cpu_logreg_and_matmult(tmp_path, capsys):
    rc = trunner.main([
        "--device", "cpu", "--benchmarks",
        "ckks_logistic_regression_poly_d3_latency",
        "ckks_matrix_multiply_row_latency", "--poly_modulus_degree", "1024",
        "--sec_level", "0", "--report_root_path", str(tmp_path),
        "--min_test_time_ms", "0",
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "[ Info    ] Failed: 0" in out and "Total: 2" in out


def test_logreg_offline_batch_is_flexible():
    """Offline logistic regression without a pinned ``batch_size`` runs at
    the sample size; a pinned one wins."""
    name = "ckks_logistic_regression_poly_d3_offline"
    eng = TEngine("cpu")
    p = _params(name)
    seen = []
    create = eng.create_benchmark
    eng.create_benchmark = lambda d, params=None: seen.append(create(d, params)) or seen[-1]
    res = trunner.run_benchmark(eng, eng.find(name), SEED, p, sample_size=3,
                                min_test_time_ms=0)
    assert res.passed, res.error
    assert seen[-1].batch == 3
    res = trunner.run_benchmark(eng, eng.find(name), SEED, dict(p, batch_size=2),
                                sample_size=3, min_test_time_ms=0)
    assert res.passed, res.error
    assert seen[-1].batch == 2


def test_cli_rejects_unknown_and_unported_names():
    with pytest.raises(SystemExit):
        trunner.run_all(["bfv_eltwise_sub_latency"], device="cpu")
    with pytest.raises(SystemExit):
        trunner.run_all(["ckks_logistic_regression_latency"], device="cpu")


def test_failure_is_reported_not_raised():
    """A benchmark that cannot be built (n exceeds the slots) is a FAILED
    line, as in the reference's harness contract."""
    res = trunner.run_all(
        ["ckks_eltwise_add_latency"], params={"poly_modulus_degree": 1024,
        "sec_level": 0}, verbose=False, device="cpu",
    )
    assert len(res) == 1 and not res[0].passed and "ValueError" in res[0].error


def test_config_tier_roundtrip(tmp_path):
    pytest.importorskip("yaml")
    path = str(tmp_path / "cfg.yaml")
    trunner.dump_config(path)
    names, per, seed, min_ms = trunner.load_config(path)
    assert tuple(names) == tuple(TEngine("cpu").names()) and len(names) == 20
    assert per["ckks_logistic_regression_poly_d3_offline"]["params"][
        "poly_modulus_degree"] == 16384
    assert per["ckks_matrix_multiply_row_latency"]["params"]["cols_m0"] == 9
    assert seed == 1234 and min_ms is None
    assert per["ckks_dot_product_offline"]["params"]["n"] == 100
    assert per["ckks_dot_product_offline"]["sample_size"] == (
        trunner.FULL_DEFAULT_SAMPLE_SIZE
    )


def test_handle_checks():
    from reference_seal_backend_tpu_torch.models.base import Handle, InvalidHandleError

    eng = TEngine("cpu")
    b = eng.create_benchmark(
        eng.find("ckks_eltwise_add_latency"), _params("ckks_eltwise_add_latency")
    )
    with pytest.raises(InvalidHandleError):
        b.encrypt("not a handle")
    with pytest.raises(InvalidHandleError):
        b.operate(Handle(tag="dot_ct", payload=(1, 2)))
    with pytest.raises(InvalidHandleError):
        b.operate(Handle(tag="eltwise_ct", payload=(1,)))
