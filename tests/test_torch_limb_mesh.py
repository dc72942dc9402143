"""The limb path's pieces: the collectives of ``parallel/mesh.py`` it adds
(all-gather of one dim, modular all-reduce, the rebalancing
collective-permute) against plain concatenations and sums, the per-block
transforms of ``parallel/limb.py`` against the flat plan, the
logistic-regression shape of the chip smoke's ``limb_path`` (b) at a small
N (14 limbs over two blocks, 7 / 7 -> 7 / 5 -> 6 / 6, G = 2 groups
straddling) against the flat evaluator, levels the limb axis does not
divide (13 of 14; 5, 3 and 1 of 6) against the JAX package's results, and
what still raises (the sp layout).  Tolerance 0."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu.schemes.core import Ciphertext as JCiphertext
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.parallel import limb
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.schemes import ckks as tckks
from reference_seal_backend_tpu_torch.schemes import keys as tkeys
from reference_seal_backend_tpu_torch.schemes.params import context_on, make_ckks_context
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

from torch_port_util import (
    assert_same_ct,
    check_ntt_views,
    contexts,
    ct_to_port,
    jax_keyset_to_numpy,
)

CPU = torch.device("cpu")


def _mesh(dp, lb):
    return tmesh.make_mesh(dp * lb, devices=mesh_devices("cpu", dp * lb), shape=(dp, lb))


def _residues(primes, lead, n, seed, mult=1):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, mult * p, (*lead, n)) for p in primes], axis=-2)
    return torch.from_numpy(x.astype(np.uint32).view(np.int32))


def _counted(fn):
    out = {}
    stats = sp_eval.collective_stats(lambda: out.setdefault("r", fn()))
    return out["r"], {k: v for k, v in stats.items() if v}


def test_collectives_against_plain_sums():
    """On a (dp=2, limb=4) mesh: the all-gather of blocks of unequal
    height, the modular all-reduce (lazy and canonical) and the rebalance
    give what a plain concatenation and sum give, each counted once; over
    a limb axis of one device nothing is counted."""
    m = _mesh(2, 4)
    primes = (1032193, 1038337, 1056769)
    p = modops.from_numpy(np.array(primes, dtype=np.uint32)[:, None], CPU)
    rng = np.random.default_rng(3)
    blocks = np.empty((2, 4), dtype=object)
    for c in np.ndindex(2, 4):
        blocks[c] = torch.from_numpy(rng.integers(0, 9, (2, c[1] % 3, 4)).astype(np.int32))
    uneven = blocks.copy()
    got, stats = _counted(lambda: tmesh.all_gather_dim(blocks, m, "limb", -2))
    assert stats == {"all-gather": 1}
    for c in np.ndindex(2, 4):
        assert torch.equal(got[c], torch.cat(list(blocks[c[0]]), dim=-2))
    total = torch.cat([got[0, 0], got[0, 0][..., :1, :]], dim=-2)  # 4 rows
    for c in np.ndindex(2, 4):  # 4 / 0 / 0 / 0 -> 1 / 1 / 1 / 1
        blocks[c] = total[..., :0, :] if c[1] else total
    even, stats = _counted(lambda: tmesh.rebalance(blocks, m, "limb", -2))
    assert stats == {"collective-permute": 1}
    for c in np.ndindex(2, 4):
        assert torch.equal(even[c], total[..., c[1] : c[1] + 1, :])
    _, stats = _counted(lambda: tmesh.rebalance(even, m, "limb", -2))
    assert stats == {}  # nothing moves
    with pytest.raises(NotImplementedError, match="3 limbs do not split into 4 equal blocks"):
        tmesh.rebalance(uneven, m, "limb", -2)  # 0 + 1 + 2 + 0 rows
    for lazy, mult in ((True, 2), (False, 1)):
        parts = np.empty((2, 4), dtype=object)
        for c in np.ndindex(2, 4):
            parts[c] = _residues(primes, (2,), 16, seed=10 * c[0] + c[1], mult=mult)
        got, stats = _counted(lambda: tmesh.all_reduce_mod(parts, m, "limb", p, lazy))
        assert stats == {"all-reduce": 1}
        pw = torch.tensor(primes, dtype=torch.int64)[:, None]
        for c in np.ndindex(2, 4):
            want = sum(modops.wide(parts[c[0], q]) for q in range(4)) % pw
            v = modops.wide(got[c])
            assert torch.equal(v % pw, want)
            assert int((v - (2 if lazy else 1) * pw).max()) < 0
    one = _mesh(8, 1)
    blocks1 = np.empty((8, 1), dtype=object)
    for c in np.ndindex(8, 1):
        blocks1[c] = torch.zeros(1, 2, 4, dtype=torch.int32)
    _, stats = _counted(lambda: tmesh.all_gather_dim(blocks1, one, "limb", -2))
    assert stats == {}


@pytest.mark.parametrize("epilogue", [True, False])
def test_per_block_transforms_at_each_blocks_limbs(epilogue):
    """``limb.fwd`` / ``limb.inv`` run the plan once per block at the
    block's first limb (noted in ``call_log`` with it) and give the flat
    transform's integers; a split coefficient axis raises."""
    ctx = make_ckks_context(1024, mult_depth=2, sec_level=0, device="cpu")
    plan = ctx.plan
    x = _residues(plan.primes[:6], (4,), 1024, seed=1)
    m = _mesh(2, 2)
    placed = tmesh.ShardedTensor.distribute(x, m, ("dp", "limb", None))
    tntt.call_log = {}
    try:
        got_f = limb.fwd(plan, placed, epilogue=epilogue).gather()
        got_i = limb.inv(plan, placed).gather()
        log = tntt.call_log
    finally:
        tntt.call_log = None
    assert torch.equal(got_f, plan.fwd(x, epilogue=epilogue))
    assert torch.equal(got_i, plan.inv(x))
    assert {(k[1], k[5]) for k in log} == {
        ("ntt_fwd", 0), ("ntt_fwd", 3), ("ntt_inv", 0), ("ntt_inv", 3)}
    sp = tmesh.ShardedTensor.distribute(x, m, ("dp", None, "limb"))
    with pytest.raises(NotImplementedError, match="coefficient axis is split"):
        limb.fwd(plan, sp)
    assert context_on(ctx, "cpu") is ctx and limb.plan_on(plan, CPU) is plan


@pytest.fixture(scope="module")
def logreg_shape():
    """A depth-6, scale-50, G=2 context at N=1024 (14 data limbs, 2 special
    primes: the registered logistic-regression chain's layout), its keys
    for rotations 1..7 and two ciphertexts."""
    ctx = make_ckks_context(1024, mult_depth=6, scale_bits=50, sec_level=0,
                            digit_group=2, device="cpu")
    assert (ctx.L, ctx.n_special, ctx.digit_group, ctx.rescale_group) == (14, 2, 2, 2)
    ks = tkeys.keygen(ctx, seed=3, galois_elts=[pow(5, s, 2 * 1024) for s in range(1, 8)],
                      need_relin=True)
    enc, er = tckks.CkksEncoder(ctx), tckks.CkksEncryptor(ctx, ks, seed=3)
    rng = np.random.default_rng(4)
    a, b = (er.encrypt_pt(enc.encode(rng.uniform(-1, 1, ctx.slots))) for _ in range(2))
    return ctx, ks, a, b


@pytest.mark.parametrize("dp", [1, 2])
def test_logreg_shape_chain_equals_flat(logreg_shape, dp, monkeypatch):
    """multiply -> relinearize -> rescale -> 8-step rotate_sum over 14
    limbs on limb = 2 (blocks 7 / 7, a digit group straddling, rescale to
    7 / 5 then 6 / 6), dp = 1 and 2 (a batch of 2): the flat evaluator's
    integers, collectives exact, the transforms the card's views."""
    ctx, ks, a, b = logreg_shape
    ev = Evaluator(ctx, ks)

    def chain(x, y):
        return ev.rotate_sum(ev.rescale_to_next(ev.relinearize(ev.multiply(x, y))),
                             list(range(8)))

    if dp == 2:
        a, b = (replace(c, data=torch.stack([c.data, c.data.flip(-1)])) for c in (a, b))
    want = chain(a, b)
    m = _mesh(dp, 2)
    place = lambda c: tmesh.shard_ct(c, m, n_batch_axes=dp - 1, limb_axis="limb")
    sa, sb = place(a), place(b)
    assert sa.data.blocks.flat[0].shape[-2] == 7
    check_ntt_views(monkeypatch)
    got, stats = _counted(lambda: chain(sa, sb))
    assert stats == {"all-reduce": 2, "all-gather": 2, "collective-permute": 1}
    assert got.data.blocks.flat[0].shape[-2] == 6
    assert torch.equal(got.data.gather(), want.data)
    assert (got.level, got.scale) == (want.level, want.scale)


def test_dp_only_placement_and_refusals(logreg_shape):
    """A dp-placed batch (no limb axis) key-switches block by block with no
    collective; a level the limb axis does not divide (14 limbs on limb =
    2 switched to 13) is replicated over the limb axis by one all-gather
    and then multiplies and relinearizes block by block, equal to the JAX
    package's result; the evaluator on the sp layout raises."""
    ctx, ks, a, _ = logreg_shape
    ev = Evaluator(ctx, ks)
    batch = replace(a, data=torch.stack([a.data, a.data.flip(-1)]))
    placed = tmesh.shard_ct(batch, _mesh(2, 1), n_batch_axes=1)
    assert placed.data.spec == ("dp", None, None, None)
    got, stats = _counted(lambda: ev.rotate(placed, 3))
    assert stats == {} and torch.equal(got.data.gather(), ev.rotate(batch, 3).data)
    jc = jparams.make_ckks_context(1024, mult_depth=6, scale_bits=50, sec_level=0,
                                   digit_group=2)
    jk = jkeys.keygen(jc, seed=3, galois_elts=[pow(5, s, 2 * 1024) for s in range(1, 8)],
                      need_relin=True)
    np.testing.assert_array_equal(modops.to_numpy(ks.relin.b), np.asarray(jk.relin.b))
    on2 = tmesh.shard_ct(a, _mesh(1, 2), limb_axis="limb")
    got, stats = _counted(lambda: _odd_level_chain(ev, on2, 13))
    assert stats == {"all-gather": 1}
    assert got.data.spec == (None, None, None)
    assert_same_ct(replace(got, data=got.data.gather()),
                   jax.jit(lambda c: _odd_level_chain(JEvaluator(jc, jk), c, 13))(_to_jax(a)))
    sp = replace(a, data=tmesh.ShardedTensor.distribute(
        a.data, _mesh(1, 2), (None, None, "limb")))
    with pytest.raises(NotImplementedError, match="coefficient axis is split"):
        ev.relinearize(ev.multiply(sp, sp))


def _odd_level_chain(ev, ct, level):
    """mod_switch_to -> multiply -> relinearize, then a rescale (to the
    next odd level) where the chain has a level to rescale to."""
    m = ev.mod_switch_to(ct, level)
    r = ev.relinearize(ev.multiply(m, m))
    return ev.rescale_to_next(r) if level >= 5 else r


def _to_jax(ct):
    return JCiphertext(data=jnp.asarray(modops.to_numpy(ct.data)), level=ct.level,
                       scale=ct.scale, is_ntt=True)


@pytest.fixture(scope="module")
def depth2():
    """The JAX package's depth-2 CKKS context at N = 2048 (L = 6, rescale
    groups of 2), its relinearization key, one ciphertext; the port's
    context and the same key and ciphertext."""
    jc, tc = contexts(2048)
    assert tc.L == 6
    jk = jkeys.keygen(jc, seed=5, need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk))
    rng = np.random.default_rng(8)
    jct = jckks.CkksEncryptor(jc, jk, seed=5).encrypt_pt(
        jckks.CkksEncoder(jc).encode(rng.uniform(-1, 1, jc.slots)))
    return jc, jk, tc, tk, jct


@pytest.mark.parametrize("level", [5, 3, 1])
def test_odd_levels_replicate_over_limb(depth2, level, monkeypatch):
    """A ciphertext of 6 limbs on limb = 2 switched to an odd level: one
    all-gather replicates it over the limb axis (what GSPMD returns), and
    multiply -> relinearize (-> rescale to the next odd level) then runs
    block by block with no other collective, equal to the JAX package's
    unsharded result."""
    jc, jk, tc, tk, jct = depth2
    ev = Evaluator(tc, tk)
    placed = tmesh.shard_ct(ct_to_port(jct), _mesh(1, 2), limb_axis="limb")
    check_ntt_views(monkeypatch)
    got, stats = _counted(lambda: _odd_level_chain(ev, placed, level))
    assert stats == {"all-gather": 1}
    assert got.data.spec == (None, None, None)
    want = jax.jit(lambda c: _odd_level_chain(JEvaluator(jc, jk), c, level))(jct)
    assert_same_ct(replace(got, data=got.data.gather()), want)
