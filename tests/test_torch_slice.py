"""The slice as a whole: the port's harness runner vs the JAX package's on
the six CKKS descriptors (eltwise at N=2048 because n=1000 needs >= 1000
slots, dot product at N=1024), ``sec_level=0``, seed 1234, sample size 2,
``device="cpu"``.  ``operate``'s result ciphertext must be equal bit for bit
(tolerance 0); decoded outputs equal to ``atol=1e-9, rtol=0`` (same numpy
code over identical integers) and within the runner's 5e-5 of the truth."""

import csv
import os

import numpy as np
import pytest

from reference_seal_backend_tpu.engine import runner as jrunner
from reference_seal_backend_tpu.engine.registry import Engine as JEngine
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.engine.descriptor import Category
from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine
from reference_seal_backend_tpu_torch.ops import modops as tmod

SIX = (
    "ckks_eltwise_add_latency",
    "ckks_eltwise_mult_latency",
    "ckks_dot_product_latency",
    "ckks_eltwise_add_offline",
    "ckks_eltwise_mult_offline",
    "ckks_dot_product_offline",
)
SEED = 1234
SAMPLES = 2


def _params(name):
    n = 1024 if "dot_product" in name else 2048
    return {"poly_modulus_degree": n, "sec_level": 0}


def test_engine_registers_exactly_the_ported_six():
    eng = TEngine("cpu")
    assert sorted(eng.names()) == sorted(SIX)
    jeng = JEngine()
    for name in SIX:  # same registered parameters as the reference
        assert eng.find(name).default_params == jeng.find(name).default_params
        assert eng.find(name).default_params["poly_modulus_degree"] == 8192
    with pytest.raises(NotImplementedError):
        eng.create_benchmark(jeng.find("bfv_dot_product_latency"))
    with pytest.raises(NotImplementedError):
        eng.create_benchmark(jeng.find("ckks_matrix_multiply_row_latency"))


@pytest.mark.parametrize("name", SIX)
def test_pipeline_bit_exact(name):
    jeng, teng = JEngine(), TEngine("cpu")
    jdesc, tdesc = jeng.find(name), teng.find(name)
    jb = jeng.create_benchmark(jdesc, _params(name))
    tb = teng.create_benchmark(tdesc, _params(name))
    b = SAMPLES if tdesc.category is Category.OFFLINE else 1
    jin, jtruth = jrunner._gen_inputs(jdesc, jb.params, np.random.default_rng(SEED), b, b)
    tin, ttruth = trunner._gen_inputs(tdesc, tb.params, np.random.default_rng(SEED), b, b)
    for x, y in zip(jin, tin):
        np.testing.assert_array_equal(x, y)

    jct = jb.load(jb.encrypt(jb.encode(jin)))
    tct = tb.load(tb.encrypt(tb.encode(tin)))
    for x, y in zip(jct.payload, tct.payload):  # same keys, same randomness
        np.testing.assert_array_equal(tmod.to_numpy(y.data), np.asarray(x.data))

    jres = jb.block(jb.operate(jct))
    tres = tb.block(tb.operate(tct))
    np.testing.assert_array_equal(
        tmod.to_numpy(tres.payload.data), np.asarray(jres.payload.data)
    )
    assert tres.payload.level == jres.payload.level
    assert tres.payload.scale == jres.payload.scale
    assert tres.meta == jres.meta and tres.tag == jres.tag

    jout = jb.decode(jb.decrypt(jb.store(jres)))
    tout = tb.decode(tb.decrypt(tb.store(tres)))
    want = ttruth()
    assert len(tout) == len(jout) == len(want) == b * b
    for g, j, w in zip(tout, jout, want):
        np.testing.assert_allclose(g, j, atol=1e-9, rtol=0)
        np.testing.assert_allclose(g, np.asarray(w).reshape(-1), atol=5e-5, rtol=0)
    assert tb.describe() == jb.describe()


def test_run_all_failed_zero_and_same_reports(tmp_path, capsys):
    per = {name: {"params": _params(name)} for name in SIX}
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    results = trunner.run_all(
        SIX, seed=SEED, sample_size=SAMPLES, report_dir=tdir,
        per_benchmark=per, min_test_time_ms=0, device="cpu",
    )
    out = capsys.readouterr().out
    assert "[ Info    ] Total: 6" in out and "[ Info    ] Failed: 0" in out
    assert out.count("[ OK     ]") == 6
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
        assert list(csv.reader(f))[1] == ["6", "0"]


def test_cli_on_cpu(tmp_path, capsys):
    rc = trunner.main([
        "--device", "cpu", "--benchmarks", "ckks_eltwise_add_latency",
        "ckks_dot_product_latency", "--poly_modulus_degree", "2048",
        "--sec_level", "0", "--report_root_path", str(tmp_path),
    ])
    out = capsys.readouterr().out
    assert rc == 0 and "[ Info    ] Failed: 0" in out


def test_cli_rejects_unknown_and_unported_names():
    with pytest.raises(SystemExit):
        trunner.run_all(["bfv_eltwise_add_latency"], device="cpu")


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
    assert tuple(sorted(names)) == tuple(sorted(SIX))
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
