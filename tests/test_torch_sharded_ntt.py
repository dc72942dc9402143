"""The port's four-step NTT and its sharded form against the JAX package.

The four-step plain transform (``sharded_ntt.fwd`` / ``inv`` on a
one-device mesh: ``ops/ntt.py``'s phases and one local transpose) against
the JAX ``NttPlan.fwd`` / ``inv`` (its four-step ``_fwd_mat`` /
``_inv_mat``) and the port's flat ``fwd_plain`` / ``inv_plain``, lazy inputs and ``epilogue=False`` included, on a CKKS
context's plan and on the BEHZ tensor-product plan over q ∪ Bsk.  Then the
sharded ``fwd`` / ``inv`` over meshes of 1, 2, 4 and 8 (CPU) devices, a
dp×sp mesh, the round trip and a dyadic product in the sharded domain.
Tolerance 0 on every residue.  JAX-side calls are jitted.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import jax
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator import behz as jbehz
from reference_seal_backend_tpu.ops import modops as jmod
from reference_seal_backend_tpu_torch.evaluator import behz as tbehz
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sharded_ntt
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

from torch_port_util import bfv_contexts, contexts


def _residues(rng, primes, lead, n, bound=1):
    """uint32 residues ``[*lead, len(primes), n]`` below ``bound * p``."""
    p = np.array(primes, dtype=np.uint64)[:, None]
    x = rng.integers(0, 2**62, (*lead, len(primes), n), dtype=np.uint64)
    return (x % (p * np.uint64(bound))).astype(np.uint32)


def _sp_mesh(k):
    return tmesh.make_mesh(k, ("sp",), shape=(k,), devices=mesh_devices("cpu", k))


@pytest.mark.parametrize("n", [2048, 8192])
def test_four_step_plain_equals_flat_and_jax(n):
    """Data plan (CKKS, 3 + 1 primes) and BEHZ ``mult_plan`` (BFV, q ∪ Bsk):
    canonical and lazy [0, 2p) inputs, both epilogues, a limb offset."""
    jc, tc = contexts(n)
    jb, tb = bfv_contexts(n)
    pairs = [(jc.plan, tc.plan), (jbehz.tables_for(jb).mult_plan,
                                  tbehz.tables_for(tb).mult_plan)]
    rng = np.random.default_rng(n)
    for jp, tp in pairs:
        # a plan of its own, not make_plan's cached one: its four-step
        # tables must be built on first use only
        tp = tntt._make_plan.__wrapped__(tp.n, tp.primes, tp.device)
        assert (tp.n1, tp.n2, tp.s1) == (jp.n1, jp.n2, jp.s1)
        assert not tp._four_step_cache
        nl, lo = len(tp.primes) - 1, 1
        mesh = _sp_mesh(1)
        for bound in (1, 2):
            x = _residues(rng, tp.primes[lo : lo + nl], (2,), n, bound)
            xt = tmod.from_numpy(x)
            for epi in (True, False):
                got = sharded_ntt.fwd(
                    tp, sharded_ntt.shard_matrix_view(tp, xt, mesh), mesh,
                    lo=lo, epilogue=epi).gather().transpose(-1, -2).reshape(xt.shape)
                assert torch.equal(got, tp.fwd_plain(xt, lo, epi))
                want = jax.jit(lambda v, e=epi: jp.fwd(v, lo, e))(x)
                np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want))
            got = sharded_ntt.inv(
                tp, tmesh.ShardedTensor.distribute(_sp_layout(xt, tp), mesh, (None,) * 3 + ("sp",)),
                mesh, lo=lo).gather().reshape(xt.shape)
            assert torch.equal(got, tp.inv_plain(xt, lo))
            np.testing.assert_array_equal(
                tmod.to_numpy(got), np.asarray(jax.jit(lambda v: jp.inv(v, lo))(x)))
        assert set(tp._four_step_cache) == {torch.device("cpu")}


def _sp_layout(xt, plan):
    """Flat NTT-order data ``[..., N]`` -> transposed layout ``[..., n2, n1]``."""
    return xt.reshape(*xt.shape[:-1], plan.n1, plan.n2).transpose(-1, -2)


def test_sharded_fwd_inv_every_mesh_size():
    """k ∈ {1, 2, 4, 8}: the sharded forward of lazy inputs (both
    epilogues) equals the JAX four-step result in the transposed layout,
    the inverse (of canonical and of lazy input) the JAX inverse, and the
    round trip gives the input back; one all-to-all a transform (none on
    one device), with the bytes of one shard's block."""
    n = 2048
    jc, tc = contexts(n)
    plan, jplan = tc.plan, jc.plan
    x = _residues(np.random.default_rng(11), plan.primes, (3,), n, 2)
    xt = tmod.from_numpy(x)
    lead = (3, len(plan.primes))
    want = {e: np.asarray(jax.jit(lambda v, e=e: jplan.fwd(v, 0, e))(x))
            for e in (True, False)}
    want_inv = np.asarray(jax.jit(jplan.inv)(x))
    for k in (1, 2, 4, 8):
        mesh = _sp_mesh(k)
        xm = sharded_ntt.shard_matrix_view(plan, xt, mesh)
        for epi in (True, False):
            tmesh.counts = stats = {**dict.fromkeys(tmesh.COLLECTIVES, 0), "a2a_bytes": 0}
            try:
                f = sharded_ntt.fwd(plan, xm, mesh, epilogue=epi)
            finally:
                tmesh.counts = None
            assert stats["all-to-all"] == (k > 1)
            assert stats["a2a_bytes"] == (k > 1) * 4 * x.size // k
            want_t = np.swapaxes(want[epi].reshape(*lead, plan.n1, plan.n2), -1, -2)
            np.testing.assert_array_equal(tmod.to_numpy(f.gather()), want_t)
        back = sharded_ntt.inv(plan, sharded_ntt.fwd(plan, xm, mesh), mesh)
        back = back.gather().reshape(*lead, n)
        assert torch.equal(back, plan.inv_plain(plan.fwd_plain(xt)))
        lazy_t = tmesh.ShardedTensor.distribute(
            _sp_layout(xt, plan), mesh, (None, None, None, "sp"))
        got = sharded_ntt.inv(plan, lazy_t, mesh).gather().reshape(*lead, n)
        np.testing.assert_array_equal(tmod.to_numpy(got), want_inv)


def test_sharded_fwd_on_a_dp_by_sp_mesh():
    """A (dp=2, sp=4) mesh: the batch on dp, the columns on sp; the
    all-to-all stays inside each dp row, and the result equals the flat
    transform."""
    n = 2048
    _, tc = contexts(n)
    plan = tc.plan
    x = tmod.from_numpy(_residues(np.random.default_rng(3), plan.primes, (4,), n))
    mesh = tmesh.make_process_mesh(4, devices=mesh_devices("cpu", 8))
    assert mesh.shape == {"dp": 2, "sp": 4}
    mat = x.reshape(4, len(plan.primes), plan.n1, plan.n2)
    xm = tmesh.ShardedTensor.distribute(mat, mesh, ("dp", None, None, "sp"))
    with pytest.raises(ValueError, match="placed as"):
        sharded_ntt.fwd(plan, xm, mesh)  # batch_axes must name dp
    f = sharded_ntt.fwd(plan, xm, mesh, batch_axes=("dp",))
    assert f.spec == ("dp", None, None, "sp")
    assert f.blocks[1, 2].shape == (2, len(plan.primes), plan.n2, plan.n1 // 4)
    np.testing.assert_array_equal(
        tmod.to_numpy(f.gather()),
        tmod.to_numpy(_sp_layout(plan.fwd_plain(x), plan)))
    back = sharded_ntt.inv(plan, f, mesh, batch_axes=("dp",))
    assert torch.equal(back.gather().reshape(x.shape), x)


def test_dyadic_multiply_in_sharded_domain():
    """Pointwise ops compose with the transposed sharded layout: fwd,
    Montgomery product block by block, inv — equal to the JAX
    single-device four-step computation."""
    n = 2048
    jc, tc = contexts(n)
    plan, jplan = tc.plan, jc.plan
    rng = np.random.default_rng(5)
    a, b = (_residues(rng, plan.primes[:1], (1,), n) for _ in range(2))
    mesh = _sp_mesh(8)
    fa, fb = (sharded_ntt.fwd(plan, sharded_ntt.shard_matrix_view(
        plan, tmod.from_numpy(v), mesh), mesh) for v in (a, b))
    p, pni = plan.p[:1, :, None], plan.p_neg_inv[:1, :, None]
    prod = tmod.mont_mul(fa, fb, p, pni)
    assert isinstance(prod, tmesh.ShardedTensor) and prod.spec == fa.spec
    got = sharded_ntt.inv(plan, prod, mesh).gather().reshape(1, 1, n)

    @jax.jit
    def want(u, v):
        fu, fv = jplan.fwd(u, 0), jplan.fwd(v, 0)
        return jplan.inv(jmod.mont_mul(fu, fv, jplan.p[:1], jplan.p_neg_inv[:1]), 0)

    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want(a, b)))
