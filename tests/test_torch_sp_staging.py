"""Staging over sharded data (``utils/staging.py``), the port's counterpart of
``jax.jit`` over a mesh, on the CPU at N <= 2048: the cache key and the
rebuild over ``ShardedTensor``, ``SpCiphertext`` and placed ``Ciphertext``
leaves, which meshes stage, an sp benchmark's stages at the JAX package's
``jit_with_keys`` sites, and a placed limb chain and an sp chain through
``staging`` equal, bit for bit, to the JAX package's ``jax.jit`` of the same
chain on virtual CPU devices.  On the CPU a staged call is its function; the
captures and replays themselves run on the card only
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).

At most seven test items, so that xdist's ``--dist loadfile`` hands the
file out after the suite's long pole.  Cold wall time alone: CHANGES.md."""

import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.parallel import mesh as jmesh
from reference_seal_backend_tpu.parallel import sp_eval as jsp
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.engine import runner
from reference_seal_backend_tpu_torch.engine.registry import Engine
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval as tsp
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.utils import staging
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

from torch_port_util import assert_same_ct, contexts, ct_to_port, jax_keyset_to_numpy

N = 2048
CPU = torch.device("cpu")
SMALL = {"poly_modulus_degree": 1024, "sec_level": 0}


def _mesh(shape, axes=("dp", "limb")):
    n = int(np.prod(shape))
    return tmesh.make_mesh(n, axes, shape=shape, devices=mesh_devices("cpu", n))


def _key(*args):
    return staging.signature(args)[0]


def test_signature_and_rebuild_over_sharded_leaves():
    """Spec, mesh, block shape, level and aliasing each give a new key;
    equal arguments one key; the leaves are the blocks in mesh order, a
    block that is one object in several blocks one leaf; the rebuild gives
    a ``ShardedTensor`` on the same mesh and spec, aliasing kept.  Each
    container refuses working-format (int64) data, sharded or not, and
    takes storage (schemes/core.py)."""
    m = _mesh((2, 2))
    x = torch.arange(2 * 2 * 6 * 16, dtype=torch.int32).reshape(2, 2, 6, 16)
    ct = tmesh.shard_ct(Ciphertext(x, level=6, scale=2.0 ** 40), m, n_batch_axes=1,
                        limb_axis="limb")
    key, leaves = staging.signature((ct,))
    assert leaves == list(ct.data.blocks.flat)
    assert all(a is b for a, b in zip(leaves, ct.data.blocks.flat))
    twin = tmesh.shard_ct(Ciphertext(x.clone(), level=6, scale=2.0 ** 40), m,
                          n_batch_axes=1, limb_axis="limb")
    assert _key(twin) == key
    sp = tsp.SpCiphertext(tmesh.ShardedTensor.distribute(
        x.reshape(2, 2, 6, 4, 4), _mesh((2,), ("sp",)), (None,) * 4 + ("sp",)), 6, 2.0)
    changed = [
        tmesh.shard_ct(replace(ct, data=x), m, n_batch_axes=1),           # spec
        tmesh.shard_ct(replace(ct, data=x), _mesh((2, 1)), n_batch_axes=1,
                       limb_axis="limb"),                                  # mesh shape
        tmesh.shard_ct(replace(ct, data=x), _mesh((2, 2), ("dp", "sp")),
                       n_batch_axes=1, batch_axes=("dp",)),                # mesh axes
        tmesh.shard_ct(replace(ct, data=x[..., :8]), m, n_batch_axes=1,
                       limb_axis="limb"),                                  # block shape
        replace(ct, level=5),
        sp, replace(sp, level=5), replace(sp, scale=4.0),
    ]
    keys = {_key(c) for c in changed}
    assert len(keys) == len(changed) and key not in keys
    # aliasing: one placed ciphertext twice, or two equal ones
    (alias_key, alias_leaves), (twin_key, twin_leaves) = (
        staging.signature((ct, ct)), staging.signature((ct, twin)))
    assert alias_key != twin_key and len(alias_leaves) == 4 and len(twin_leaves) == 8
    # a replicated block: one object in every block of a group
    blocks = tmesh.all_gather_dim(ct.data.blocks, m, "limb", dim=-2)
    rep = tmesh.ShardedTensor(blocks, m, ("dp", None, None, None))
    rep_key, rep_leaves = staging.signature((rep,))
    assert len(rep_leaves) == 2 and rep_leaves[0] is blocks[0, 0] is blocks[0, 1]
    apart = rep.map_blocks(lambda b, c: b.clone())
    assert _key(apart) != rep_key  # the same blocks' shapes, aliased otherwise
    # the format rule: storage taken above, the working format refused
    to_wide = lambda t: t.map_blocks(lambda b, c: b.to(torch.int64))
    for build in (lambda: Ciphertext(x.to(torch.int64), level=6),
                  lambda: Plaintext(x[0].to(torch.int64), level=6),
                  lambda: replace(ct, data=to_wide(ct.data)),
                  lambda: replace(sp, data=to_wide(sp.data))):
        with pytest.raises(TypeError, match="residue storage"):
            build()
    # the rebuild
    new = [t.clone() + 1 for t in rep_leaves]
    (out,) = staging._rebuild((rep,), iter(new))
    assert out.mesh is m and out.spec == rep.spec and out.blocks.shape == (2, 2)
    assert out.blocks[1, 0] is out.blocks[1, 1] is new[1]
    (got,) = staging._rebuild((ct,), iter([b + 1 for b in leaves]))
    assert (got.level, got.scale, got.data.spec) == (6, 2.0 ** 40, ct.data.spec)
    assert torch.equal(got.data.gather(), x + 1)
    (back,) = staging._rebuild((sp,), iter(staging.signature((sp,))[1]))
    assert isinstance(back, tsp.SpCiphertext) and (back.level, back.scale) == (6, 2.0)


def test_which_meshes_stage():
    """A mesh stages where all its blocks lie on one device (checked on
    ``torch.device`` objects: no card needed); a mesh of several devices
    is eager by ``staging.stage``'s branch, a plain function."""
    cuda = [torch.device("cuda", i) for i in range(2)]
    cases = {
        (CPU,) * 4: True, (cuda[0],) * 4: True, (cuda[1],): True,
        tuple(cuda): False, (cuda[0], CPU): False, (cuda[0], cuda[0], CPU, CPU): False,
    }
    lock = threading.Lock()
    for devices, staged in cases.items():
        mesh = tmesh.Mesh(tmesh._device_array(devices, (len(devices),)), ("sp",))
        assert staging.one_device(mesh) is staged, devices
        stage = staging.stage(lambda x: x, "s", lock, mesh)
        assert isinstance(stage, staging.StagedCall) is staged, devices
        assert stage(5) == 5
    assert isinstance(staging.stage(lambda x: x, "s", lock), staging.StagedCall)


@pytest.mark.parametrize("name,params,samples,stages", [
    ("ckks_dot_product_latency", dict(SMALL, n=8), (1, 1), ["_operate_impl"]),
    ("bfv_eltwise_mult_latency", dict(SMALL, n=8), (1, 1), ["_operate_impl"]),
    # a batch of 5 in chunks of 3: the dots stage runs twice, on one shape
    ("ckks_logistic_regression_poly_d3_offline",
     dict(SMALL, batch_size=5, dots_chunk=3), (1, 5),
     ["_dots_impl", "_dots_impl", "_collapse_impl", "_sigmoid_impl"]),
])
def test_sp_benchmark_operates_through_its_stages(monkeypatch, name, params, samples,
                                                  stages):
    """Under ``sp_shard`` on a one-device mesh (here 2 copies of the CPU),
    ``operate`` goes through ``StagedCall``s at the JAX package's
    ``jit_with_keys`` sites, as the flat benchmark does; the notes say the
    stages are staged; the result is right."""
    called = []
    plain_call = staging.StagedCall.__call__

    def spy(self, *args):
        called.append(self.name.split(".")[-1])
        return plain_call(self, *args)

    monkeypatch.setattr(staging.StagedCall, "__call__", spy)
    engine = Engine("cpu")
    desc = engine.find(name)
    bench = engine.create_benchmark(desc, dict(params, sp_shard=2))
    assert isinstance(bench.ev, tsp.SpEvaluator) and staging.one_device(bench.ev.mesh)
    assert [s.name for s in bench._stages] == [
        f"{name}.{s}" for s in dict.fromkeys(stages)]
    inputs, truth = runner.gen_inputs(desc, bench.params, np.random.default_rng(3),
                                      *samples)
    loaded = bench.load(bench.encrypt(bench.encode(inputs)))
    result = bench.operate(loaded)
    assert called == stages
    assert isinstance(result.payload, tsp.SpCiphertext)
    notes = bench.run_notes(loaded)
    assert notes["stages"] == "staged" and notes["graph_captures"] == 0
    out = bench.decode(bench.decrypt(bench.store(result)))
    want = truth()
    for got, exp in zip(out, want):
        if "bfv" in name:
            np.testing.assert_array_equal(np.asarray(got).reshape(-1),
                                          np.asarray(exp).reshape(-1))
        else:
            np.testing.assert_allclose(np.asarray(got).reshape(-1),
                                       np.asarray(exp).reshape(-1), atol=5e-5, rtol=0)


@pytest.fixture(scope="module")
def keyed():
    """A JAX context, keys for ``accumulate(…, 8)`` and two ciphertext
    batches of 2, and the port's counterparts on the CPU."""
    jc, tc = contexts(N)
    steps = jcomp.rotations_for_accumulate(8, N // 2)
    jk = jkeys.keygen(jc, seed=5, galois_elts=[pow(5, s, 2 * N) for s in steps],
                      need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    enc, er = jckks.CkksEncoder(jc), jckks.CkksEncryptor(jc, jk, seed=5)
    rng = np.random.default_rng(11)
    cts = [er.encrypt_pt(enc.encode(rng.uniform(-1, 1, jc.slots))) for _ in range(4)]
    ja = replace(cts[0], data=jnp.stack([c.data for c in cts[:2]]))
    jb = replace(cts[0], data=jnp.stack([c.data for c in cts[2:]]))
    return jc, jk, tc, tk, ja, jb


def test_placed_limb_chain_through_staging_equals_jax_jit(keyed):
    """(dp=2, limb=2): multiply -> relinearize -> rescale -> ``accumulate``
    through ``staging`` equals the JAX package's ``jax.jit`` of the same
    chain over the same placement on four virtual CPU devices, bit for bit;
    the result stays placed as its operands."""
    jc, jk, tc, tk, ja, jb = keyed
    jm = jmesh.make_mesh(4, ("dp", "limb"))
    assert dict(jm.shape) == {"dp": 2, "limb": 2}
    jev = JEvaluator(jc, jk)
    jplace = lambda c: jmesh.shard_ct(c, jm, n_batch_axes=1, limb_axis="limb")
    want = jax.jit(lambda a, b: jcomp.accumulate(
        jev, jev.rescale_to_next(jev.relinearize(jev.multiply(a, b))), 8))(
            jplace(ja), jplace(jb))
    m = _mesh((2, 2))
    tev = TEvaluator(tc, tk)
    chain = staging.stage(lambda a, b: tcomp.accumulate(
        tev, tev.rescale_to_next(tev.relinearize(tev.multiply(a, b))), 8),
        "limb_chain", threading.Lock(), m)
    assert isinstance(chain, staging.StagedCall)
    tplace = lambda c: tmesh.shard_ct(ct_to_port(c), m, n_batch_axes=1, limb_axis="limb")
    got = chain(tplace(ja), tplace(jb))
    assert got.data.mesh is m and got.data.spec[0] == "dp"
    assert_same_ct(replace(got, data=got.data.gather()), want)


def test_sp_chain_through_staging_equals_jax_jit(keyed):
    """sp = 2: multiply -> relinearize -> rescale on the ``SpEvaluator``
    through ``staging`` equals the JAX package's ``jax.jit`` of its
    ``SpEvaluator``'s same chain on two virtual CPU devices, bit for bit."""
    jc, jk, tc, tk, ja, jb = keyed
    jspe = jsp.SpEvaluator(jc, jk, jmesh.make_mesh(2, ("sp",)))
    want = jspe.unshard(jax.jit(
        lambda a, b: jspe.rescale_to_next(jspe.relinearize(jspe.multiply(a, b))))(
            jspe.shard(ja), jspe.shard(jb)))
    m = _mesh((2,), ("sp",))
    tspe = tsp.SpEvaluator(tc, tk, m)
    chain = staging.stage(
        lambda a, b: tspe.rescale_to_next(tspe.relinearize(tspe.multiply(a, b))),
        "sp_chain", threading.Lock(), m)
    assert isinstance(chain, staging.StagedCall)
    got = chain(tspe.shard(ct_to_port(ja)), tspe.shard(ct_to_port(jb)))
    assert isinstance(got, tsp.SpCiphertext) and got.data.spec[-1] == "sp"
    assert_same_ct(tspe.unshard(got), want)
