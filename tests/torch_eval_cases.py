"""Shared cases of test_torch_eval.py (G=1/ns=1) and
test_torch_eval_grouped.py (forced G=2/ns=2): every CKKS ``Evaluator`` op and
``composite.accumulate`` of the port vs the JAX package's default path, with
the SAME keys and ciphertexts (made by the JAX package, carried across as
numpy by ``convert.py``).  Tolerance 0: ciphertext residues must be equal
bit for bit.  Two files, so that two test workers share the JAX compiles."""

import jax
import numpy as np
import pytest

from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.evaluator import eval as teval
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.schemes import ckks as tckks

from torch_port_util import (
    assert_same_ct,
    contexts,
    ct_to_port,
    jax_keyset_to_numpy,
    pt_to_port,
)

N = 1024
STEPS = sorted(set(jcomp.rotations_for_accumulate(8, N // 2))
               | set(jcomp.rotations_for_accumulate(40, N // 2)))


class Side:
    """One package's view of the shared state."""

    def __init__(self, ev, a, b, pt, dec):
        self.ev, self.a, self.b, self.pt, self.dec = ev, a, b, pt, dec


def build_sides(digit_group):
    """(JAX side, port side, cleartext vectors) for one digit grouping."""
    jc, tc = contexts(N, digit_group=digit_group)
    assert tc.digit_group == (digit_group or 1)
    assert tc.n_special == (digit_group or 1)
    elts = [pow(5, s, 2 * N) for s in STEPS] + [2 * N - 1]
    jk = jkeys.keygen(jc, seed=11, galois_elts=elts, need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    rng = np.random.default_rng(7)
    enc = jckks.CkksEncoder(jc)
    er = jckks.CkksEncryptor(jc, jk, seed=11)
    va, vb, vp = (rng.uniform(-1, 1, jc.slots) for _ in range(3))
    ja, jb, jpt = er.encrypt_pt(enc.encode(va)), er.encrypt_pt(enc.encode(vb)), enc.encode(vp)
    j = Side(JEvaluator(jc, jk), ja, jb, jpt, jckks.CkksDecryptor(jc, jk))
    t = Side(TEvaluator(tc, tk), ct_to_port(ja), ct_to_port(jb), pt_to_port(jpt),
             tckks.CkksDecryptor(tc, tk))
    return j, t, (va, vb, vp)


def run_jax(j, fn):
    """Run ``fn(side)`` on the JAX side as ONE jitted graph over the shared
    ciphertexts (eagerly, the thousands of small dispatches each compile)."""
    f = jax.jit(lambda a, b, pt: fn(Side(j.ev, a, b, pt, j.dec)))
    return f(j.a, j.b, j.pt)


def _mrr(s):
    return s.ev.rescale_to_next(s.ev.relinearize(s.ev.multiply(s.a, s.b)))


OPS = {
    "add": lambda s: s.ev.add(s.a, s.b),
    "sub": lambda s: s.ev.sub(s.a, s.b),
    "negate": lambda s: s.ev.negate(s.a),
    "add_plain": lambda s: s.ev.add_plain(s.a, s.pt),
    "sub_plain": lambda s: s.ev.sub_plain(s.a, s.pt),
    "multiply_plain": lambda s: s.ev.multiply_plain(s.a, s.pt),
    "multiply": lambda s: s.ev.multiply(s.a, s.b),
    "square": lambda s: s.ev.square(s.a),
    "add_size3_size2": lambda s: s.ev.add(s.ev.multiply(s.a, s.b), s.ev.multiply_plain(s.a, s.pt)),
    "sub_size2_size3": lambda s: s.ev.sub(s.ev.multiply_plain(s.a, s.pt), s.ev.multiply(s.a, s.b)),
    "sub_size3_size2": lambda s: s.ev.sub(s.ev.multiply(s.a, s.b), s.ev.multiply_plain(s.a, s.pt)),
    "relinearize": lambda s: s.ev.relinearize(s.ev.multiply(s.a, s.b)),
    "rescale_to_next": lambda s: s.ev.rescale_to_next(s.ev.multiply_plain(s.a, s.pt)),
    "mult_relin_rescale": _mrr,
    "mod_switch_to_next": lambda s: s.ev.mod_switch_to_next(s.a),
    "mod_switch_to_odd_level": lambda s: s.ev.mod_switch_to(s.a, 5),
    "match_level": lambda s: s.ev.match_level(s.a, s.ev.mod_switch_to(s.b, 4))[0],
    "rotate_1": lambda s: s.ev.rotate(s.a, 1),
    "rotate_neg": lambda s: s.ev.rotate(s.a, 3 - N // 2),
    "rotate_0": lambda s: s.ev.rotate(s.a, 0),
    "rotate_after_rescale": lambda s: s.ev.rotate(_mrr(s), 1),
    "conjugate": lambda s: s.ev.conjugate(s.a),
    "rotate_sum_with_identity": lambda s: s.ev.rotate_sum(s.a, [0, 1, 2, 0]),
    "rotate_sum_identity_only": lambda s: s.ev.rotate_sum(s.a, [0, 0]),
}
# an odd live-limb count exercises the partial top digit group: a branch of
# the grouped decomposition only
GROUPED_OPS = {
    "rotate_sum_odd_level": lambda s: s.ev.rotate_sum(s.ev.mod_switch_to(s.a, 5), [1, 3]),
}


@pytest.mark.parametrize("count", [8, 40], ids=["hoisted8", "bsgs40"])
def test_accumulate_bit_exact(sides, count):
    j, t, (va, vb, _) = sides
    assert tcomp.rotations_for_accumulate(count, N // 2) == (
        jcomp.rotations_for_accumulate(count, N // 2)
    )
    want = run_jax(j, lambda s: jcomp.accumulate(s.ev, _mrr(s), count))
    got = tcomp.accumulate(t.ev, _mrr(t), count)
    assert_same_ct(got, want)
    dec = np.real(t.dec.decrypt(got))
    np.testing.assert_allclose(dec, np.real(j.dec.decrypt(want)), atol=1e-9, rtol=0)
    # slot 0 holds the sum over the slots the rotations cover: ``count``
    # for the hoisted form, baby*giant >= count for baby-step/giant-step
    steps = tcomp.rotations_for_accumulate(count, N // 2)
    covered = count if count <= 32 else len(set(
        b + g for b in [0] + [s for s in steps if s < tcomp._bsgs_split(count)[0]]
        for g in [0] + [s for s in steps if s >= tcomp._bsgs_split(count)[0]]
    ))
    assert abs(dec[0] - np.sum((va * vb)[:covered])) < 5e-5 * covered


def test_accumulate_tree_rotations_match():
    for count in (1, 2, 32, 33, 1024, 1025, 5000):
        assert tcomp.rotations_for_accumulate(count, 4096) == (
            jcomp.rotations_for_accumulate(count, 4096)
        )


def test_key_switch_and_digits_bit_exact(sides):
    """The key-switch internals themselves, including the [0, 4p) digits."""
    j, t, _ = sides
    from reference_seal_backend_tpu_torch.ops import modops as tmod

    jd = run_jax(j, lambda s: s.ev._hoisted_digits(s.a.data[..., 1, :, :], s.a.level))
    td = t.ev._hoisted_digits(t.a.data[..., 1, :, :], t.a.level)
    np.testing.assert_array_equal(tmod.to_numpy(td), np.asarray(jd))
    jkb, jka = run_jax(
        j, lambda s: s.ev.key_switch(s.a.data[..., 1, :, :], s.ev.keys.relin, s.a.level)
    )
    tkb, tka = t.ev.key_switch(t.a.data[..., 1, :, :], t.ev.keys.relin, t.a.level)
    np.testing.assert_array_equal(tmod.to_numpy(tkb), np.asarray(jkb))
    np.testing.assert_array_equal(tmod.to_numpy(tka), np.asarray(jka))


def test_hoisted_key_fallback_matches_keygen_variant(sides):
    """Evaluator._hoisted_key_p5 without keys.galois_p5 rebuilds the same
    key the keygen precomputed."""
    from dataclasses import replace

    _, t, _ = sides
    g = pow(5, 1, 2 * N)
    bare = TEvaluator(t.ev.ctx, replace(t.ev.keys, galois_p5={}))
    want = t.ev.keys.galois_p5[g]
    got = bare._hoisted_key_p5(g)
    for f in ("b", "a", "bs", "as_"):
        assert (getattr(got, f) == getattr(want, f)).all()


def test_decrypt_after_ops_is_right(sides):
    j, t, (va, vb, vp) = sides
    got = np.real(t.dec.decrypt(_mrr(t)))
    np.testing.assert_allclose(got, va * vb, atol=5e-5, rtol=0)
    rot = np.real(t.dec.decrypt(t.ev.rotate(t.a, 1)))
    np.testing.assert_allclose(rot, np.roll(va, -1), atol=5e-5, rtol=0)


def test_errors(sides):
    _, t, _ = sides
    ev = t.ev
    with pytest.raises(ValueError):
        ev.add(t.a, ev.mod_switch_to(t.b, 4))          # level mismatch
    with pytest.raises(ValueError):
        ev.rotate(t.a, 100)                             # no such Galois key
    with pytest.raises(ValueError):
        ev.rotate(ev.multiply(t.a, t.b), 1)             # size 3
    with pytest.raises(ValueError):
        ev.mod_switch_to(t.a, t.a.level + 1)
    with pytest.raises(ValueError):
        TEvaluator(ev.ctx).relinearize(ev.multiply(t.a, t.b))  # no keys
    with pytest.raises(NotImplementedError):
        ev.multiply(ev.multiply(t.a, t.b), t.b)         # size-3 input


def test_lazy_ok_is_plan_lazy(sides):
    _, t, _ = sides
    assert teval._lazy_ok(t.ev.ctx) is t.ev.ctx.plan.lazy is True
