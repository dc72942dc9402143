"""The port's benchmark suite (``reference_seal_backend_tpu_torch/bench.py``)
against the JAX package's ``bench.py``: its metric keys and headline, its
record-promotion rule, its four own ops bit-exact against the JAX Evaluator
(N = 1024, ``sec_level=0``, a batch of 2, the steps themselves run end to
end on the CPU), the median of chunk rates, and its refusal of ``cuda``
without a card.  Cold wall time of the file alone: ``CHANGES.md``."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu.schemes.params import make_ckks_context as jmake
from reference_seal_backend_tpu_torch import bench as tbench
from reference_seal_backend_tpu_torch.ops import modops as tmod

from torch_port_util import assert_same_ct, check_ntt_views, ct_to_port


def _jax_bench():
    import bench

    return bench


def test_metric_keys_and_headline_equal_bench_py():
    jb = _jax_bench()
    assert tbench.CURRENT_METRIC_KEYS == jb.CURRENT_METRIC_KEYS
    assert len(tbench.CURRENT_METRIC_KEYS) == 10
    assert tbench.HEADLINE == jb.RESULT["metric"] == "ckks_ctct_mults_per_sec_n16384"
    for name in ("N", "BATCH", "BATCH_KS", "EPS", "SEAL_SINGLE_CORE_MULTS_PER_SEC"):
        assert getattr(tbench, name) == getattr(jb, name), name
    run = tbench.Run("cpu")
    assert run.record["unit"] == jb.RESULT["unit"]
    assert set(jb.RESULT) - {"cold_factor", "budget_s"} <= set(run.record)
    assert run.record["device"]["platform"] == "cpu"


def _completeness_cases(keys):
    """(new, old, may overwrite) of ``test_bench_guard.py::TestMoreComplete``."""
    k = keys
    full3 = {"value": 1.0, "extras": {k[0]: 1, k[1]: 2, k[2]: 3}}
    partial = {"value": 2.0, "extras": {k[0]: 9}}
    old2 = {"value": 1.0, "extras": {k[0]: 1, k[1]: 2}}
    new3 = {"value": 2.0, "extras": {k[0]: 5, k[1]: 6, k[2]: 7}}
    retired = {"value": 1.0, "extras": {k[0]: 1, "retired_metric_v0": 2}}
    new1 = {"value": 2.0, "extras": {k[0]: 5}}
    return [
        ({"value": None, "extras": {}}, {}, False),   # no headline
        ({"value": 1.0, "extras": {}}, {}, True),     # first record
        ({"value": 1.0, "extras": {}}, {"bad": 1}, True),
        (partial, full3, False),                      # partial vs full
        (full3, partial, True),
        (new3, old2, True),                           # superset
        (new3, new3, True),
        (new1, retired, True),                        # retired keys
        (new1, old2, False),
    ]


@pytest.mark.parametrize("case", ["completeness", "force_promote_env"])
def test_more_complete_as_bench_py(case, monkeypatch):
    jb = _jax_bench()
    keys = sorted(tbench.CURRENT_METRIC_KEYS)
    if case == "completeness":
        cases = _completeness_cases(keys)
    else:
        # bench.py's environment override promotes a partial record; the
        # port has no override and reads none of bench.py's
        full = {"value": 1.0, "extras": {keys[0]: 1, keys[1]: 2}}
        partial = {"value": 2.0, "extras": {}}
        assert not tbench._more_complete(partial, full)
        assert not jb._more_complete(partial, full)
        monkeypatch.setenv("RSB_TPU_BENCH_FORCE_PROMOTE", "1")
        assert jb._more_complete(partial, full)
        assert not tbench._more_complete(partial, full)
        cases = [({"value": None}, full, False)]
    for new, old, want in cases:
        assert tbench._more_complete(new, old) is want, (new, old)
        assert jb._more_complete(new, old) is want, (new, old)


def test_record_file_keeps_the_fuller_record(tmp_path):
    """As ``bench.py``'s ``_emit``: a partial run leaves the fuller record
    on disk and writes its own to ``.latest``; a fuller one replaces it."""
    k = sorted(tbench.CURRENT_METRIC_KEYS)
    path = tmp_path / "bench_torch.json"
    full = {"metric": "m", "value": 100.0, "extras": {k[0]: 1, k[1]: 2}}
    path.write_text(json.dumps(full))
    lines = []
    run = tbench.Run("cpu", record_path=str(path), emit=lines.append)
    run.record.update({"value": 50.0, "extras": {k[0]: 9}, "skipped": [k[1]]})
    run.emit()
    assert json.loads(path.read_text()) == full
    latest = tmp_path / "bench_torch.latest.json"
    assert json.loads(latest.read_text())["value"] == 50.0
    assert json.loads(lines[-1]) == json.loads(latest.read_text())
    run.record["extras"].update({k[1]: 3, k[2]: 4})
    run.emit()
    assert json.loads(path.read_text())["extras"] == {k[0]: 9, k[1]: 3, k[2]: 4}


def test_suite_ops_bit_exact_against_jax(monkeypatch):
    """The headline and the three key-switch steps run end to end on the
    CPU (gates, the staged result equal to the eager one); the port's state
    equals the JAX package's under the same seed; each step's op on
    ciphertexts carried across equals the JAX Evaluator's, jitted."""
    n, batch = 1024, 2
    seen = check_ntt_views(monkeypatch)
    lines = []
    run = tbench.Run("cpu", window_s=0.02, emit=lines.append)
    st = tbench.headline(run, n=n, sec_level=0, batch=batch, batch_ks=batch)
    tbench.ks_rotate_sum(run, st)
    tbench.ks_rotate(run, st)
    tbench.ks_mult_relin_rescale(run, st)
    run.emit()
    record = json.loads(lines[-1])
    assert record["value"] > 0 and len(record["extras"]) == 3
    assert all(s["equal_to_eager"] for s in record["steps"].values())
    assert seen

    jc = jmake(poly_modulus_degree=n, mult_depth=2, sec_level=0)
    jk = jkeys.keygen(jc, seed=tbench.SEED, need_relin=True,
                      galois_elts=tuple(pow(5, s, 2 * n) for s in range(1, 8)))
    enc = jckks.CkksEncoder(jc)
    er = jckks.CkksEncryptor(jc, jk, seed=tbench.SEED)
    rng = np.random.default_rng(tbench.SEED)
    va, vb = rng.uniform(-1, 1, jc.slots), rng.uniform(-1, 1, jc.slots)
    np.testing.assert_array_equal(st.va, va)
    ja, jb = er.encrypt_pt(enc.encode(va)), er.encrypt_pt(enc.encode(vb))
    np.testing.assert_array_equal(tmod.to_numpy(st.ca.data), np.asarray(ja.data))
    ja, jb = (replace(c, data=jnp.broadcast_to(c.data, (batch,) + c.data.shape))
              for c in (ja, jb))
    jev = JEvaluator(jc, jk)
    ta, tb = ct_to_port(ja), ct_to_port(jb)
    cases = {  # bench.py's jitted lambdas, and the port's ops
        "ctct_mult": (lambda x, y: jev.multiply(x, y), tbench.ctct_mult, 2),
        "mult_relin_rescale": (
            lambda x, y: jev.rescale_to_next(jev.relinearize(jev.multiply(x, y))),
            tbench.mult_relin_rescale, 2),
        "rotate": (lambda x: jev.rotate(x, 1), tbench.rotate_1, 1),
        "rotate_sum8": (lambda x: jev.rotate_sum(x, list(range(8))),
                        tbench.rotate_sum8, 1),
    }
    for name, (jfn, op, arity) in cases.items():
        want = jax.jit(jfn)(*(ja, jb)[:arity])
        assert_same_ct(op(st.ev, *(ta, tb)[:arity]), want)


def test_median_of_chunks_not_the_best():
    got = tbench.chunk_rates(10, [100.0, 50.0, 400.0, 80.0, 125.0], batch=8)
    rates = [800.0, 1600.0, 200.0, 1000.0, 640.0]
    assert got["chunk_rates"] == pytest.approx(rates)
    assert got["rate"] == pytest.approx(800.0)  # the median, not 1600
    assert tbench.chunk_rates(1, [20.0, 10.0])["rate"] == pytest.approx(75.0)


def test_cli_cuda_without_a_card_raises(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    record = tmp_path / "r.json"
    for argv in ([], ["--device", "cuda", "--record", str(record)]):
        with pytest.raises(RuntimeError, match="cuda"):
            tbench.main(argv)
    assert not record.exists() and not list(tmp_path.iterdir())
