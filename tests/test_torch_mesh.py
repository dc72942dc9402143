"""The port's meshes (``parallel/mesh.py``, ``utils/device.py:mesh_devices``)
and its placement of a ciphertext batch over a (dp, limb) mesh, against the
JAX package: the process-grouped device order, mesh shapes, the devices an
sp mesh gets (raising rather than co-locating shards silently, and
starting at the card a caller names), the plain ``Evaluator`` on dp- and
limb-sharded data (bit for bit the JAX single-device results, the BFV BEHZ
multiply of limb-sharded data too), ``shard_map`` of a limb block raising,
and ``sp_shard`` through the C ABI's params JSON.  Tolerance 0.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import json
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.parallel import mesh as jmesh
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.engine import capi as tcapi
from reference_seal_backend_tpu_torch.engine import runner as trunner
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.utils import device as tdevice

from torch_port_util import assert_same_ct, bfv_contexts, contexts, jax_keyset_to_numpy

N = 2048


def test_process_grouped_order_matches_the_reference():
    """The cases of tests/test_parallel.py, on both packages."""
    for procs, group in (([0] * 8, 4), ([0, 0, 1, 1, 2, 2, 3, 3] * 2, 4)):
        order = tmesh.process_grouped_order(procs, group)
        np.testing.assert_array_equal(order, jmesh.process_grouped_order(procs, group))
        grouped = np.asarray(procs)[order].reshape(-1, group)
        assert (grouped == grouped[:, :1]).all()
    for procs, group in (([0, 0, 1, 1], 4), ([0] * 6, 4), ([0, 0, 0, 1], 2)):
        with pytest.raises(ValueError):
            tmesh.process_grouped_order(procs, group)
    with pytest.raises(ValueError, match="DCN"):
        tmesh.process_grouped_order([0, 0, 1, 1], 4)


def test_mesh_shapes_and_cpu_devices():
    cpu = torch.device("cpu")
    assert tdevice.mesh_devices("cpu", 8) == [cpu] * 8
    devs = tdevice.mesh_devices("cpu", 8)
    assert tmesh.make_mesh(8, devices=devs).shape == {"dp": 4, "limb": 2}
    assert tmesh.make_mesh(8, ("sp",), shape=(8,), devices=devs).shape == {"sp": 8}
    assert tmesh.make_mesh(3, ("dp", "limb"), devices=devs).shape == {"dp": 3, "limb": 1}
    m = tmesh.make_process_mesh(4, devices=devs)
    assert m.shape == {"dp": 2, "sp": 4} and m.axis_names == ("dp", "sp")
    # four hosts of four devices, listed host-interleaved: sp groups host-local
    procs = [0, 0, 1, 1, 2, 2, 3, 3] * 2
    m = tmesh.make_process_mesh(4, devices=list(range(16)), process_indices=procs)
    hosts = np.asarray(procs)[m.devices.astype(int)]
    assert (hosts == hosts[:, :1]).all() and m.shape == {"dp": 4, "sp": 4}
    assert tmesh.ct_pspec(1, ("dp",), "limb") == ("dp", None, "limb", None)
    assert tmesh.pt_pspec(2, ("dp",)) == ("dp", None, None, None)


def test_mesh_devices_on_cuda_raises_unless_virtual(monkeypatch):
    """``cuda`` without a card raises; on a (simulated) one-card machine an
    sp mesh of 4 raises naming 4 and the 1 visible card, unless
    RSB_TORCH_VIRTUAL_DEVICES allows 4 virtual devices."""
    monkeypatch.delenv(tdevice.VIRTUAL_DEVICES_ENV, raising=False)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            tdevice.mesh_devices("cuda", 4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    card = torch.device("cuda", 0)
    assert tdevice.mesh_devices("cuda", 1) == [card]
    with pytest.raises(ValueError, match=r"4 devices needs 4 visible cards, 1 visible"):
        tdevice.mesh_devices("cuda", 4)
    monkeypatch.setenv(tdevice.VIRTUAL_DEVICES_ENV, "2")
    with pytest.raises(ValueError, match="RSB_TORCH_VIRTUAL_DEVICES=4"):
        tdevice.mesh_devices("cuda", 4)
    monkeypatch.setenv(tdevice.VIRTUAL_DEVICES_ENV, "4")
    assert tdevice.mesh_devices("cuda", 4) == [card] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tdevice.mesh_devices("cuda", 4) == [torch.device("cuda", i) for i in range(4)]


def test_mesh_devices_start_at_the_named_card(monkeypatch):
    """A mesh for ``cuda:1`` starts at card 1: ``cuda:1, cuda:2`` of four
    visible cards, never ``cuda:0``; four shards from card 1 do not fit in
    four cards and raise, or sit on card 1 when virtual devices are asked
    for."""
    monkeypatch.delenv(tdevice.VIRTUAL_DEVICES_ENV, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    card = lambda i: torch.device("cuda", i)
    assert tdevice.mesh_devices("cuda:1", 1) == [card(1)]
    assert tdevice.mesh_devices("cuda:1", 2) == [card(1), card(2)]
    assert tdevice.mesh_devices("cuda:3", 1) == [card(3)]
    with pytest.raises(ValueError, match=r"counting from cuda:1"):
        tdevice.mesh_devices("cuda:1", 4)
    monkeypatch.setenv(tdevice.VIRTUAL_DEVICES_ENV, "4")
    assert tdevice.mesh_devices("cuda:1", 4) == [card(1)] * 4


@pytest.fixture(scope="module")
def batch():
    """A batch of 8 CKKS ciphertexts on both sides, and both evaluators."""
    jc, tc = contexts(N)
    elts = [pow(5, 2, 2 * N)]
    jk = jkeys.keygen(jc, seed=5, galois_elts=elts, need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk))
    enc, er = jckks.CkksEncoder(jc), jckks.CkksEncryptor(jc, jk, seed=5)
    rng = np.random.default_rng(7)
    cts = [er.encrypt_pt(enc.encode(rng.uniform(-1, 1, jc.slots))) for _ in range(8)]
    jct = replace(cts[0], data=jnp.stack([c.data for c in cts]))
    tct = convert.ciphertext_from_numpy(np.asarray(jct.data), jct.level, jct.scale)
    return tc, tk, JEvaluator(jc, jk), jct, tct


def _gathered(ct):
    return replace(ct, data=ct.data.gather())


def test_dp_and_limb_sharded_evaluator_ops(batch):
    """The plain Evaluator on placed data, as under GSPMD: a multiply over a
    (dp=4, limb=2) mesh through the ShardedTensor local map, and a rotation
    (a key switch) over a dp=8 mesh with replicated keys, each block's
    ciphertexts rotated on their own (``shard_map``)."""
    tc, tk, jev, jct, tct = batch
    assert tc.L % 2 == 0
    devs = tdevice.mesh_devices("cpu", 8)
    m = tmesh.make_mesh(8, devices=devs)
    sh = tmesh.shard_ct(tct, m, n_batch_axes=1, batch_axes=("dp",), limb_axis="limb")
    assert sh.data.spec == ("dp", None, "limb", None)
    assert sh.data.blocks[3, 1].shape == (2, 2, tc.L // 2, N)
    got = TEvaluator(tc, tk).multiply(sh, sh)
    assert got.data.spec == ("dp", None, "limb", None)
    assert_same_ct(_gathered(got), jax.jit(lambda a: jev.multiply(a, a))(jct))

    m = tmesh.make_mesh(8, ("dp",), devices=devs)
    sh = tmesh.shard_ct(tct, m, n_batch_axes=1)
    ev = TEvaluator(tc, tmesh.replicate(tk, m))
    got = tmesh.shard_map(lambda c: ev.rotate(c, 2), sh)
    assert got.data.spec == ("dp", None, None, None)
    assert_same_ct(_gathered(got), jax.jit(lambda a: jev.rotate(a, 2))(jct))


def test_limb_sharded_key_switch_raises(batch):
    """The BFV BEHZ multiply of limb-sharded ciphertexts equals the JAX
    package's (``parallel/limb.py:bfv_multiply``: its q -> Bsk sums met in
    two all-reduces, nothing gathered); a key switch run per block through
    ``shard_map`` raises, naming the sharded dim, and gathers nothing on
    the way (a limb block is not a batch of whole polynomials).  The CKKS
    key switch and rescale over limb-sharded data: tests/test_torch_limb_*.py."""
    from reference_seal_backend_tpu.schemes.core import Ciphertext as JCiphertext
    from reference_seal_backend_tpu_torch.parallel import sp_eval
    from reference_seal_backend_tpu_torch.schemes.core import Ciphertext

    tc, tk, _, _, tct = batch
    m = tmesh.make_mesh(8, devices=tdevice.mesh_devices("cpu", 8))
    jbc, bc = bfv_contexts(N)
    rng = np.random.default_rng(11)
    data = np.stack([rng.integers(0, p, (4, 2, N)) for p in bc.data_primes],
                    axis=-2).astype(np.uint32)
    bct = Ciphertext(data=torch.from_numpy(data.astype(np.int64)).to(torch.int32),
                     level=bc.L, scale=1.0, is_ntt=True)
    bsh = tmesh.shard_ct(bct, m, n_batch_axes=1, batch_axes=("dp",), limb_axis="limb")
    out = {}
    stats = sp_eval.collective_stats(
        lambda: out.setdefault("ct", TEvaluator(bc, None).multiply(bsh, bsh)))
    assert {k: v for k, v in stats.items() if v} == {"all-reduce": 2}
    got = out["ct"]
    assert got.data.spec == ("dp", None, "limb", None)
    jev = JEvaluator(jbc, None)
    want = jax.jit(lambda a: jev.multiply(a, a))(
        JCiphertext(data=jnp.asarray(data), level=jbc.L, scale=1.0, is_ntt=True))
    assert_same_ct(_gathered(got), want)
    sh = tmesh.shard_ct(tct, m, n_batch_axes=1, batch_axes=(None,), limb_axis="limb")
    ev = TEvaluator(tc, tk)
    prod = ev.multiply(sh, sh)

    def per_block():
        with pytest.raises(NotImplementedError, match="sharded dim"):
            tmesh.shard_map(ev.relinearize, prod)

    assert not any(sp_eval.collective_stats(per_block).values())


def test_capi_params_json_sp_shard(monkeypatch):
    """``{"sp_shard": 4}`` in the C ABI's params JSON runs the benchmark
    sharded (its description says so) and decodes to the same bytes as the
    unsharded run."""
    monkeypatch.setenv(tcapi.DEVICE_ENV, "cpu")
    eid = tcapi.engine_create()
    assert eid > 0, tcapi.last_error()
    engine = tcapi._engines[eid]
    name = "ckks_dot_product_latency"
    params = {"poly_modulus_degree": N, "sec_level": 0, "n": 100}
    desc = engine.find(name)
    inputs, _ = trunner.gen_inputs(
        desc, dict(desc.default_params, **params), np.random.default_rng(3), 1, 1)
    inputs_json = json.dumps([x.tolist() for x in inputs])
    decoded = {}
    for k in (0, 4):
        bid = tcapi.benchmark_create(eid, name, json.dumps(dict(params, sp_shard=k)))
        assert bid > 0, tcapi.last_error()
        assert tcapi._benchmarks[bid].describe().get("sp_shard") == (str(k) if k else None)
        h = tcapi.benchmark_encode(bid, inputs_json)
        for step in ("encrypt", "load", "operate", "store", "decrypt"):
            h = getattr(tcapi, f"benchmark_{step}")(bid, h)
            assert h > 0, (step, tcapi.last_error())
        decoded[k] = tcapi.benchmark_decode(bid, h)
        assert decoded[k], tcapi.last_error()
        tcapi.benchmark_destroy(bid)
    assert decoded[4] == decoded[0]
    bad = tcapi.benchmark_create(eid, name, json.dumps(dict(params, sp_shard=3)))
    assert bad < 0 and "must divide" in tcapi.last_error()
    tcapi.engine_destroy(eid)
