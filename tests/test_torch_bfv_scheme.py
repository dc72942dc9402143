"""BFV scheme layer of the port vs the JAX package's: the context (at
N=1024, ``sec_level=0``, and at the registered N=8192, 128-bit), the BEHZ
tables, keygen, the batch encoder, encryption and decryption, the noise
budget, and the Delta scaling of ``add_plain`` / ``sub_plain``.  Tolerance 0
on every residue; decoded integers equal to the JAX package's and to the
cleartext.  JAX-side device work is jitted (or the JAX package's own jitted
encrypt / decrypt).

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reference_seal_backend_tpu.evaluator import behz as jbehz
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import bfv as jbfv
from reference_seal_backend_tpu.schemes import core as jcore
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu_torch.evaluator import behz as tbehz
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
from reference_seal_backend_tpu_torch.schemes import keys as tkeys
from reference_seal_backend_tpu_torch.schemes import params as tparams

from torch_port_util import (
    assert_same_ct,
    bfv_contexts,
    ct_to_port,
    pt_to_port,
    wide_to_numpy,
)

N = 1024
SEED = 11


def _eq(t, j):
    np.testing.assert_array_equal(tmod.to_numpy(t), np.asarray(j))


def _eq_const(t, j):
    """A context constant: held in the working format (ops/modops.py),
    equal to the JAX package's once narrowed."""
    assert t.dtype == tmod.WIDE
    _eq(tmod.narrow(t), j)


def _centered(v, t):
    r = np.asarray(v) % t
    return np.where(r > t // 2, r - t, r)


@pytest.fixture(scope="module")
def env():
    jc, tc = bfv_contexts(N)
    elts = [pow(5, s, 2 * N) for s in (1, 2)] + [2 * N - 1]
    jk = jkeys.keygen(jc, seed=SEED, galois_elts=elts)
    tk = tkeys.keygen(tc, seed=SEED, galois_elts=elts)
    return jc, tc, jk, tk


CONTEXT_FIELDS = (
    "primes", "data_primes", "special_primes", "L", "n_special",
    "digit_group", "total_coeff_bits", "max_secure_bits", "secure_128",
    "sp_row", "slots", "t", "q", "delta", "aux_primes", "m_sk", "bsk_primes",
)


@pytest.mark.parametrize("registered", [False, True], ids=["n1024", "n8192"])
def test_context_equal(registered):
    if registered:  # make_bfv_context()'s defaults: the registered set
        jc = jparams.make_bfv_context()
        tc = tparams.make_bfv_context(device="cpu")
    else:
        jc, tc = bfv_contexts(N)
    for f in CONTEXT_FIELDS:
        assert getattr(tc, f) == getattr(jc, f), f
    for f in ("p", "p_neg_inv", "mu", "delta_plain", "delta_shoup"):
        _eq_const(getattr(tc, f), getattr(jc, f))
    assert tc.bsk_plan.primes == jc.bsk_plan.primes
    assert tc.plan.lazy and tc.bsk_plan.lazy
    if registered:
        assert tc.data_primes == (1073479681, 1073430529, 1073299457, 1073233921)
        assert tc.special_primes == (1073692673, 1073643521)
        assert (tc.t, tc.digit_group, len(tc.bsk_primes)) == (1032193, 2, 6)
        assert (tc.total_coeff_bits, tc.max_secure_bits) == (180, 218)
        assert tc.secure_128


def test_behz_tables_equal(env):
    jc, tc, _, _ = env
    jt, tt = jbehz.tables_for(jc), tbehz.tables_for(tc)
    names = [k for k in vars(jt) if k != "ctx" and k != "mult_plan"]
    assert sorted(names) == sorted(k for k in vars(tt) if k not in ("ctx", "mult_plan"))
    for name in names:
        j, t = getattr(jt, name), getattr(tt, name)
        js = j if isinstance(j, tuple) else (j,)
        ts = t if isinstance(t, tuple) else (t,)
        assert len(js) == len(ts), name
        for a, b in zip(ts, js):
            if isinstance(a, int):
                assert a == int(b), name
            else:
                assert a.dtype == tmod.WIDE, name
                np.testing.assert_array_equal(
                    wide_to_numpy(a), np.asarray(b), err_msg=name)
    assert tt.mult_plan.primes == jt.mult_plan.primes
    np.testing.assert_array_equal(  # q u Bsk: the two plans' tables stacked
        tmod.to_numpy(tt.mult_plan.roots),
        np.concatenate([tmod.to_numpy(tc.plan.roots)[: tc.L],
                        tmod.to_numpy(tc.bsk_plan.roots)]))


def test_keygen_equal(env):
    _, _, jk, tk = env
    _eq(tk.secret_ntt, jk.secret_ntt)
    _eq(tk.public.b, jk.public.b)
    _eq(tk.public.a, jk.public.a)
    for f in ("b", "a", "bs", "as_"):
        _eq(getattr(tk.relin, f), getattr(jk.relin, f))
    assert sorted(tk.galois) == sorted(jk.galois)
    assert sorted(tk.galois_p5) == sorted(jk.galois_p5)
    for g in jk.galois:
        _eq(tk.galois[g].b, jk.galois[g].b)


def test_encoder_roundtrip_and_plaintexts_equal(env):
    jc, tc, _, _ = env
    je, te = jbfv.BfvBatchEncoder(jc), tbfv.BfvBatchEncoder(tc)
    np.testing.assert_array_equal(te.store0, je.store0)
    np.testing.assert_array_equal(te.store1, je.store1)
    assert te.psi_t == je.psi_t
    v = np.random.default_rng(3).integers(-600000, 600000, N)
    jp, tp = je.encode(v), te.encode(v)
    _eq(tp.data, jp.data)
    assert (tp.level, tp.scale) == (jp.level, jp.scale)
    m = tc.plan.inv(tp.data)  # limb 0 holds m mod q0, m < t
    coeff = tmod.host_from_mont(tmod.to_numpy(m)[0], tc.primes[0])
    np.testing.assert_array_equal(te.decode_poly(coeff), _centered(v, tc.t))
    np.testing.assert_array_equal(te.decode_poly(coeff), je.decode_poly(coeff))


def test_encrypt_decrypt_equal(env):
    jc, tc, jk, tk = env
    je, te = jbfv.BfvBatchEncoder(jc), tbfv.BfvBatchEncoder(tc)
    vals = np.random.default_rng(5).integers(-1000, 1000, (3, N))
    jpt, tpt = je.encode(vals[0]), te.encode(vals[0])
    stack = lambda enc: np.stack([np.asarray(enc.encode(v).data) for v in vals])
    jbatch = jcore.Plaintext(data=jnp.asarray(stack(je)), level=jc.L, scale=1.0)
    tbatch = pt_to_port(jbatch)
    jenc = jbfv.BfvEncryptor(jc, jk, seed=SEED)
    tenc = tbfv.BfvEncryptor(tc, tk, seed=SEED)
    jct, tct = jenc.encrypt_pt(jbatch), tenc.encrypt_pt(tbatch)
    assert_same_ct(tct, jct)
    assert_same_ct(tenc.encrypt_pt(tpt), jenc.encrypt_pt(jpt))  # stream goes on
    jdec, tdec = jbfv.BfvDecryptor(jc, jk), tbfv.BfvDecryptor(tc, tk)
    got = tdec.decrypt(tct)
    np.testing.assert_array_equal(got, jdec.decrypt(jct))
    np.testing.assert_array_equal(got, vals)
    np.testing.assert_array_equal(tdec.decrypt_poly(tct), jdec.decrypt_poly(jct))
    budget = tdec.noise_budget_bits(tct)
    assert budget == jdec.noise_budget_bits(jct) and budget > 20


def test_add_sub_plain_scale_by_delta(env):
    jc, tc, jk, tk = env
    rng = np.random.default_rng(7)
    va, vb = rng.integers(-1000, 1000, (2, N))
    jct = jbfv.BfvEncryptor(jc, jk, seed=SEED).encrypt_pt(
        jbfv.BfvBatchEncoder(jc).encode(va))
    jpt = jbfv.BfvBatchEncoder(jc).encode(vb)
    tct, tpt = ct_to_port(jct), pt_to_port(jpt)
    jev, tev = JEvaluator(jc, jk), TEvaluator(tc, tk)
    tdec = tbfv.BfvDecryptor(tc, tk)
    for op, want in (("add_plain", va + vb), ("sub_plain", va - vb)):
        jout = jax.jit(getattr(jev, op))(jct, jpt)
        tout = getattr(tev, op)(tct, tpt)
        assert_same_ct(tout, jout)
        np.testing.assert_array_equal(tdec.decrypt(tout), _centered(want, tc.t))
    # the unscaled plaintext would decrypt to va, not va + vb: Delta is applied
    p = tc.p[: tc.L]
    raw = tmod.mod_add(tct.data[0], tpt.data, p)
    assert not np.array_equal(tmod.to_numpy(tmod.narrow(raw)),
                              tmod.to_numpy(tev.add_plain(tct, tpt).data[0]))
