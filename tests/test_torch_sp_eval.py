"""The port's slot-parallel evaluator (``parallel/sp_eval.py``) at N = 2048
over an 8-device (CPU) ``sp`` mesh, against the JAX package's single-device
``Evaluator`` on the same keys and ciphertexts: the layout round trip,
multiply, multiply -> relinearize -> rotate -> rescale, the plaintext ops,
the dot product's accumulate (hoisted ``rotate_sum``), a G = 2 context and
the BFV BEHZ multiply — and the collectives each pipeline makes.
Tolerance 0 on every residue; scales and levels equal.  (The JAX package's
own sp path is held to the same single-device results by
``tests/test_sp_eval.py``.)  JAX-side calls are jitted.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import jax
import numpy as np
import pytest

from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import bfv as jbfv
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
from reference_seal_backend_tpu_torch.utils.device import mesh_devices

from torch_port_util import (
    assert_same_ct,
    bfv_contexts,
    contexts,
    ct_to_port,
    jax_keyset_to_numpy,
    pt_to_port,
)

N = 2048
K = 8
STEP = 3
DOT = 100


def _mesh():
    return tmesh.make_mesh(K, ("sp",), shape=(K,), devices=mesh_devices("cpu", K))


def _sides(jc, tc, steps, seed, scheme=jckks):
    """JAX evaluator, port SpEvaluator, and two ciphertexts on both sides
    (JAX-made, carried across as numpy)."""
    jk = jkeys.keygen(jc, seed=seed, need_relin=True,
                      galois_elts=[pow(5, s, 2 * N) for s in steps])
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    rng = np.random.default_rng(seed)
    if scheme is jckks:
        enc, er = jckks.CkksEncoder(jc), jckks.CkksEncryptor(jc, jk, seed=seed)
        vals = [rng.uniform(-1, 1, jc.slots) for _ in range(2)]
    else:
        enc, er = jbfv.BfvBatchEncoder(jc), jbfv.BfvEncryptor(jc, jk, seed=seed)
        vals = [rng.integers(-100, 100, jc.slots) for _ in range(2)]
    ja, jb = (er.encrypt_pt(enc.encode(v)) for v in vals)
    spe = sp_eval.SpEvaluator(tc, tk, _mesh())
    return JEvaluator(jc, jk), spe, (ja, jb), (ct_to_port(ja), ct_to_port(jb)), tk, vals


@pytest.fixture(scope="module")
def ckks():
    jc, tc = contexts(N)
    steps = [STEP] + jcomp.rotations_for_accumulate(DOT, jc.slots)
    jev, spe, (ja, jb), (ta, tb), _, _ = _sides(jc, tc, steps, 11)
    return jc, tc, jev, spe, ja, jb, ta, tb


def _both(jev, spe, ja, jb, ta, tb, fn):
    """``fn(ev, a, b)`` jitted on the JAX side, sharded on the port's; the
    port's result gathered back to the flat layout."""
    want = jax.jit(lambda a, b: fn(jev, a, b))(ja, jb)
    got = fn(spe, spe.shard(ta), spe.shard(tb))
    return spe.unshard(got), want


def test_layout_roundtrip(ckks):
    jc, tc, jev, spe, ja, jb, ta, tb = ckks
    sp = spe.shard(ta)
    assert tuple(sp.data.shape) == (2, tc.L, 128, N // 128)
    assert sp.data.spec == (None, None, None, "sp")
    assert sp.data.blocks.flat[0].shape[-1] == N // 128 // K
    back = spe.unshard(sp)
    assert back.data.equal(ta.data) and back.level == ta.level


def test_multiply_and_relinearize_with_collectives(ckks):
    jc, tc, jev, spe, ja, jb, ta, tb = ckks
    assert_same_ct(*_both(jev, spe, ja, jb, ta, tb, lambda ev, a, b: ev.multiply(a, b)))
    relin = lambda ev, a, b: ev.relinearize(ev.multiply(a, b))
    assert_same_ct(*_both(jev, spe, ja, jb, ta, tb, relin))
    stats = sp_eval.collective_stats(relin, spe, spe.shard(ta), spe.shard(tb))
    assert stats["all-to-all"] >= 3  # digit-lift inv + 2 fwd + mod-down
    assert stats["a2a_bytes"] > 0


def test_mult_relin_rotate_rescale(ckks):
    jc, tc, jev, spe, ja, jb, ta, tb = ckks
    got, want = _both(jev, spe, ja, jb, ta, tb, lambda ev, a, b: ev.rescale_to_next(
        ev.rotate(ev.relinearize(ev.multiply(a, b)), STEP)))
    assert_same_ct(got, want)
    assert got.level == tc.L - tc.rescale_group


def test_plain_ops(ckks):
    """multiply_plain / add_plain on a sharded and on a flat plaintext (the
    composite ops hand flat ones), sub, negate, mod_switch_to."""
    jc, tc, jev, spe, ja, jb, ta, tb = ckks
    jpt = jckks.CkksEncoder(jc).encode(np.random.default_rng(9).uniform(-1, 1, jc.slots))
    tpt = pt_to_port(jpt)
    for pt in (spe.shard_pt(tpt), tpt):
        for op in ("multiply_plain", "add_plain"):
            want = jax.jit(getattr(jev, op))(ja, jpt)
            assert_same_ct(spe.unshard(getattr(spe, op)(spe.shard(ta), pt)), want)
    for fn in (lambda ev, a, b: ev.sub(a, b), lambda ev, a, b: ev.negate(a),
               lambda ev, a, b: ev.mod_switch_to(a, 2)):
        assert_same_ct(*_both(jev, spe, ja, jb, ta, tb, fn))


def test_dot_product_accumulate(ckks):
    """The dot product's operate: multiply -> relinearize -> rescale ->
    accumulate over 100 slots (two hoisted rotate_sum passes, baby and
    giant steps)."""
    jc, tc, jev, spe, ja, jb, ta, tb = ckks

    def dot(ev, a, b, comp):
        return comp.accumulate(
            ev, ev.rescale_to_next(ev.relinearize(ev.multiply(a, b))), DOT)

    want = jax.jit(lambda a, b: dot(jev, a, b, jcomp))(ja, jb)
    sa, sb = spe.shard(ta), spe.shard(tb)
    assert_same_ct(spe.unshard(dot(spe, sa, sb, tcomp)), want)
    stats = sp_eval.collective_stats(dot, spe, sa, sb, tcomp)
    assert stats["all-to-all"] >= 10
    assert stats["a2a_bytes"] > 0
    # per rotate_sum pass: digits and c0 into p5 order, the key-switch sum
    # and the rolled c0 sum back
    assert stats["all-gather"] == 8
    assert stats["collective-permute"] > 0


def test_grouped_digits_rotate_sum():
    """A G = 2 context (two special primes): grouped lift, the fast base
    conversion mod-down and the hoisted rotate_sum."""
    jc, tc = contexts(N, digit_group=2)
    assert (tc.digit_group, tc.n_special) == (2, 2)
    jev, spe, (ja, jb), (ta, tb), _, _ = _sides(jc, tc, (1, 2), 17)
    got, want = _both(jev, spe, ja, jb, ta, tb, lambda ev, a, b: ev.rotate_sum(
        ev.rescale_to_next(ev.relinearize(ev.multiply(a, b))), [0, 1, 2]))
    assert_same_ct(got, want)


def test_bfv_behz_multiply():
    """The sharded BEHZ multiply (four sweeps over the data plan and the
    q ∪ Bsk plan) then relinearize: equal residues, an exact decrypt, and
    one all-to-all per sweep."""
    jc, tc = bfv_contexts(N)
    jev, spe, (ja, jb), (ta, tb), tk, (ia, ib) = _sides(jc, tc, (), 29, jbfv)
    relin = lambda ev, a, b: ev.relinearize(ev.multiply(a, b))
    assert_same_ct(*_both(jev, spe, ja, jb, ta, tb, lambda ev, a, b: ev.multiply(a, b)))
    got, want = _both(jev, spe, ja, jb, ta, tb, relin)
    assert_same_ct(got, want)
    np.testing.assert_array_equal(tbfv.BfvDecryptor(tc, tk).decrypt(got), ia * ib)
    stats = sp_eval.collective_stats(relin, spe, spe.shard(ta), spe.shard(tb))
    assert stats["all-to-all"] >= 7
    assert stats["a2a_bytes"] > 0
