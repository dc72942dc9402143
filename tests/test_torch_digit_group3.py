"""Digit groups of 3 over three special primes: the port vs the JAX package.

The chain that logistic regression takes at N = 32768 (depth 6, 14 data
primes) resolves to G = 3 with three special primes; here the same grouped
decomposition is forced at N = 1024, ``sec_level=0`` (``digit_group=3``), as
``tests/test_digit_group.py`` does for the JAX package alone:

* CKKS: the 6 data limbs split 3 + 3, after a rescale 3 + 1, at level 5
  3 + 2 (partial top groups), with the single-shot mod-down over three
  special primes; keys and ciphertexts made by the JAX package and carried
  across by ``convert.py`` (``torch_eval_cases.build_sides(3)``);
* BFV: 4 data limbs give 2 digits with a zero-padded top group, through the
  BEHZ multiply, relinearize and rotate;
* the port's N = 32768 depth-6 context against the JAX package's (host
  only: no keygen at that size here).

Tolerance 0 on every residue; JAX-side calls jitted; every tensor the port
hands to a transform passes the CUDA wrapper's view rules.  Cold wall time
of the file alone: ``CHANGES.md``."""

import jax
import numpy as np
import pytest

import torch_eval_cases as cases
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import bfv as jbfv
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
from reference_seal_backend_tpu_torch.schemes import params as tparams

from torch_port_util import (
    assert_same_ct,
    bfv_contexts,
    check_ntt_views,
    ct_to_port,
    jax_keyset_to_numpy,
)

N = 1024
OPS = {**cases.OPS, **cases.GROUPED_OPS}
CKKS_CASES = ("mult_relin_rescale", "rotate_1", "rotate_after_rescale",
              "conjugate", "rotate_sum_odd_level")
# the logistic-regression chain at N = 32768 (bench_suite.json ``describe``)
CHAIN_32768 = "30|30|25|25|25|25|26|26|25|26|26|25|26|26"


@pytest.fixture(scope="module")
def sides():
    return cases.build_sides(3)


@pytest.mark.parametrize("op", CKKS_CASES)
def test_ckks_op_bit_exact_at_g3(sides, op, monkeypatch):
    j, t, _ = sides
    assert t.ev.ctx.dig_count(t.ev.ctx.L) == 2
    seen = check_ntt_views(monkeypatch)
    assert_same_ct(OPS[op](t), cases.run_jax(j, OPS[op]))
    assert seen  # the key switch reached the transforms


def test_bfv_multiply_relinearize_rotate_bit_exact_at_g3(monkeypatch):
    jc, tc = bfv_contexts(N, digit_group=3)
    assert (tc.digit_group, tc.n_special, tc.L, tc.dig_count(tc.L)) == (3, 3, 4, 2)
    jk = jkeys.keygen(jc, seed=19, galois_elts=[pow(5, 1, 2 * N)], need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    enc = jbfv.BfvBatchEncoder(jc)
    er = jbfv.BfvEncryptor(jc, jk, seed=19)
    rng = np.random.default_rng(23)
    ia = rng.integers(-50, 50, jc.slots)
    ib = rng.integers(-50, 50, jc.slots)
    ja, jb = er.encrypt_pt(enc.encode(ia)), er.encrypt_pt(enc.encode(ib))

    def chain(ev, a, b):
        return ev.rotate(ev.relinearize(ev.multiply(a, b)), 1)

    jev = JEvaluator(jc, jk)
    want = jax.jit(lambda a, b: chain(jev, a, b))(ja, jb)
    check_ntt_views(monkeypatch)
    got = chain(TEvaluator(tc, tk), ct_to_port(ja), ct_to_port(jb))
    assert_same_ct(got, want)
    half = tc.slots // 2
    prod = ia * ib
    rolled = np.concatenate([np.roll(prod[:half], -1), np.roll(prod[half:], -1)])
    np.testing.assert_array_equal(tbfv.BfvDecryptor(tc, tk).decrypt(got), rolled)


def test_n32768_depth6_context_equals_the_jax_package():
    kw = dict(poly_modulus_degree=32768, mult_depth=6, scale_bits=50)
    jc = jparams.make_ckks_context(**kw)
    tc = tparams.make_ckks_context(device="cpu", **kw)
    for ctx in (jc, tc):
        assert (ctx.digit_group, ctx.n_special, ctx.L) == (3, 3, 14)
        assert ctx.secure_128
        assert ctx.dig_count(ctx.L) == 5
    assert tuple(tc.data_primes) == tuple(jc.data_primes)
    assert tuple(tc.special_primes) == tuple(jc.special_primes)
    assert "|".join(str(q.bit_length()) for q in tc.data_primes) == CHAIN_32768
    assert sum(p.bit_length() for p in tc.special_primes) == 90
    assert tc.total_coeff_bits == jc.total_coeff_bits <= tc.max_secure_bits
    assert tc.plan.lazy
