"""``sp_shard`` through the port's entry points at N = 2048: a registered
benchmark run slot-parallel over an 8-device (CPU) mesh, all seven steps,
decodes equal to the JAX package's UNSHARDED benchmark on the same seed
(CKKS dot product, logistic regression Offline, BFV element-wise multiply
and dot product); a dp×sp mesh against the JAX single-device evaluator; the
runner's ``--sp_shard``; and a mesh size that cannot shard raising.
Tolerance 0: decodes ``assert_array_equal``.  JAX-side calls are the JAX
package's own jitted pipeline.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import csv
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reference_seal_backend_tpu.engine.registry import Engine as JEngine
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

from torch_port_util import assert_same_ct, contexts, jax_keyset_to_numpy

N = 2048
BASE = {"poly_modulus_degree": N, "sec_level": 0}


def _pipeline(bench, inputs):
    h = bench.load(bench.encrypt(bench.encode(inputs)))
    return bench.decode(bench.decrypt(bench.store(bench.block(bench.operate(h)))))


def _sp_equals_jax_unsharded(name, params, inputs, k=8):
    jeng, teng = JEngine(), TEngine("cpu")
    want = _pipeline(jeng.create_benchmark(jeng.find(name), dict(params)), inputs)
    bench = teng.create_benchmark(teng.find(name), dict(params, sp_shard=k))
    assert isinstance(bench.ev, sp_eval.SpEvaluator)
    assert bench.ev.mesh.shape == {"sp": k}
    got = _pipeline(bench, inputs)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    return got


def test_ckks_dot_product_latency():
    rng = np.random.default_rng(1234)
    va, vb = rng.uniform(-1, 1, (1, 100)), rng.uniform(-1, 1, (1, 100))
    (got,) = _sp_equals_jax_unsharded(
        "ckks_dot_product_latency", dict(BASE, n=100), [va, vb])
    assert abs(got[0] - va[0] @ vb[0]) < 5e-4


def test_logreg_offline():
    """dots -> collapse -> bias -> Horner (depth 6): multiply_plain and
    add_plain with flat plaintexts, mod_switch_to, collapse's merge."""
    rng = np.random.default_rng(7)
    w, b, x = rng.uniform(-1, 1, 16), float(rng.uniform(-1, 1)), rng.uniform(-1, 1, (4, 16))
    (got,) = _sp_equals_jax_unsharded(
        "ckks_logistic_regression_poly_d3_offline",
        dict(BASE, n=16, batch_size=4), [w, b, x])
    z = x @ w + b
    assert np.max(np.abs(got - (0.5 + 0.15012 * z - 0.0015930078125 * z**3))) < 5e-4


def test_bfv_eltwise_mult_latency():
    rng = np.random.default_rng(1234)
    ia, ib = rng.integers(-50, 50, (1, 64)), rng.integers(-50, 50, (1, 64))
    (got,) = _sp_equals_jax_unsharded(
        "bfv_eltwise_mult_latency", dict(BASE, n=64), [ia, ib])
    np.testing.assert_array_equal(got, (ia * ib)[0])


def test_bfv_dot_product_latency():
    rng = np.random.default_rng(1234)
    ia, ib = rng.integers(-30, 30, (1, 100)), rng.integers(-30, 30, (1, 100))
    (got,) = _sp_equals_jax_unsharded(
        "bfv_dot_product_latency", dict(BASE, n=100), [ia, ib])
    assert got[0] == ia[0] @ ib[0]


def test_dp_by_sp_mesh():
    """(dp=2, sp=4): an Offline batch of 4 on dp, every coefficient axis on
    sp; multiply -> relinearize -> rescale equal to the JAX single-device
    evaluator."""
    jc, tc = contexts(N)
    jk = jkeys.keygen(jc, seed=5, need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk))
    enc, er = jckks.CkksEncoder(jc), jckks.CkksEncryptor(jc, jk, seed=5)
    rng = np.random.default_rng(2)
    cts = [er.encrypt_pt(enc.encode(rng.uniform(-1, 1, jc.slots))) for _ in range(8)]
    ja = replace(cts[0], data=jnp.stack([c.data for c in cts[:4]]))
    jb = replace(cts[0], data=jnp.stack([c.data for c in cts[4:]]))
    mesh = tmesh.make_mesh(8, ("dp", "sp"), shape=(2, 4), devices=mesh_devices("cpu", 8))
    spe = sp_eval.SpEvaluator(tc, tk, mesh, batch_axes=("dp",))
    jev = JEvaluator(jc, jk)
    want = jax.jit(lambda a, b: jev.rescale_to_next(jev.relinearize(jev.multiply(a, b))))(ja, jb)
    sa, sb = (spe.shard(convert.ciphertext_from_numpy(np.asarray(c.data), c.level, c.scale))
              for c in (ja, jb))
    assert sa.data.spec == ("dp", None, None, None, "sp")
    assert sa.data.blocks[1, 3].shape == (2, 2, tc.L, 128, N // 128 // 4)
    got = spe.rescale_to_next(spe.relinearize(spe.multiply(sa, sb)))
    assert_same_ct(spe.unshard(got), want)


def test_runner_sp_shard(tmp_path):
    """``--sp_shard 8`` flows through the CLI's params: the benchmark passes
    its cleartext check and its description says sp_shard 8."""
    rc = trunner.main([
        "--device", "cpu", "--benchmarks", "ckks_eltwise_mult_latency",
        "--poly_modulus_degree", str(N), "--sec_level", "0", "--sp_shard", "8",
        "--min_test_time_ms", "0", "--report_root_path", str(tmp_path),
    ])
    assert rc == 0
    with open(tmp_path / "descriptions.csv") as f:
        (row,) = csv.DictReader(f)
    assert row["sp_shard"] == "8"
    eng = TEngine("cpu")
    res = trunner.run_benchmark(eng, eng.find("ckks_eltwise_mult_latency"), seed=1234,
                                params=dict(BASE, n=64, sp_shard=8), min_test_time_ms=0)
    assert res.passed, res.error
    assert res.description["sp_shard"] == "8"


def test_sp_shard_is_honoured_or_raises():
    """``sp_shard: 4`` builds an SpEvaluator over 4 devices and says so;
    a mesh size that does not divide n1 = 16 raises, and nothing runs flat
    in its place; without it the evaluator is the single-device one."""
    eng = TEngine("cpu")
    desc = eng.find("ckks_eltwise_add_latency")
    bench = eng.create_benchmark(desc, dict(BASE, sp_shard=4))
    assert isinstance(bench.ev, sp_eval.SpEvaluator)
    assert bench.describe()["sp_shard"] == "4"
    assert bench.ev.mesh.devices.shape == (4,)
    flat = eng.create_benchmark(desc, dict(BASE))
    assert "sp_shard" not in flat.describe()
    assert not isinstance(flat.ev, sp_eval.SpEvaluator)
    for k in (3, 32):
        with pytest.raises(ValueError, match="must divide"):
            eng.create_benchmark(desc, dict(BASE, sp_shard=k))
    with pytest.raises(ValueError, match="four-step"):
        eng.create_benchmark(desc, dict(BASE, poly_modulus_degree=128, sp_shard=2))
