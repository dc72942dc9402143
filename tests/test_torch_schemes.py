"""Port schemes (context tables, keygen, encode, encrypt, decrypt) vs the
JAX package's at N=1024, ``sec_level=0``, for G=1 and a forced
``digit_group=2``.  Tolerance 0 on every uint32 result; decoded floats
``atol=1e-9, rtol=0`` (same numpy code over identical integers)."""

import numpy as np
import pytest

from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.schemes import ckks as tckks
from reference_seal_backend_tpu_torch.schemes import core as tcore
from reference_seal_backend_tpu_torch.schemes import keys as tkeys
from reference_seal_backend_tpu_torch.schemes import params as tparams

from torch_port_util import assert_same_ct, contexts, jax_keyset_to_numpy

N = 1024
GROUPS = [None, 2]  # auto (G=1 at sec_level 0) and forced G=2


def _eq(t, j):
    np.testing.assert_array_equal(tmod.to_numpy(t), np.asarray(j))


def _eq_const(t, j):
    """A context constant: held in the working format (ops/modops.py),
    equal to the JAX package's once narrowed."""
    assert t.dtype == tmod.WIDE
    _eq(tmod.narrow(t), j)


@pytest.fixture(scope="module", params=GROUPS, ids=["G1", "G2"])
def pair(request):
    jc, tc = contexts(N, digit_group=request.param)
    elts = (pow(5, 1, 2 * N), pow(5, 3, 2 * N), 2 * N - 1)
    jk = jkeys.keygen(jc, seed=77, galois_elts=elts, need_relin=True)
    tk = tkeys.keygen(tc, seed=77, galois_elts=elts, need_relin=True)
    return jc, tc, jk, tk


def test_chain_and_scalars(pair):
    jc, tc, _, _ = pair
    for f in ("primes", "data_primes", "special_primes", "L", "n_special",
              "digit_group", "total_coeff_bits", "max_secure_bits",
              "secure_128", "sp_row", "scale", "rescale_group", "min_level",
              "slots"):
        assert getattr(tc, f) == getattr(jc, f), f
    assert tc.plan.lazy == jc.plan.lazy


@pytest.mark.parametrize("field", [
    "p", "p_neg_inv", "mu", "r2", "r1", "div_inv", "div_inv_shoup",
    "div_inv_mont", "div_inv_mont_shoup", "div_mod", "div_half",
])
def test_context_tables(pair, field):
    jc, tc, _, _ = pair
    _eq_const(getattr(tc, field), getattr(jc, field))


def test_digit_moddown_p5_tables(pair):
    jc, tc, _, _ = pair
    for level in range(tc.min_level, tc.L + 1):
        for t, j in zip(tc.digit_tables(level), jc.digit_tables(level)):
            _eq_const(t, j)
        for t, j in zip(tc.moddown_tables(level), jc.moddown_tables(level)):
            _eq_const(t, j)
        assert tc.dig_count(level) == jc.dig_count(level)
    tP, tPd, tQd = tc.p5_order()
    jP, jPd, jQd = jc.p5_order()
    np.testing.assert_array_equal(tP, jP)
    np.testing.assert_array_equal(tPd.numpy(), np.asarray(jPd))
    np.testing.assert_array_equal(tQd.numpy(), np.asarray(jQd))


def test_security_enforcement():
    with pytest.raises(tparams.InsecureParametersError):
        tparams.make_ckks_context(N, 2, sec_level=128, device="cpu")
    with pytest.raises(ValueError):
        tparams.make_ckks_context(N, 2, sec_level=64, device="cpu")
    assert tparams.max_coeff_bits_128(8192) == 218


def test_keygen_field_by_field(pair):
    _, _, jk, tk = pair
    want = jax_keyset_to_numpy(jk)
    got = convert.keyset_to_numpy(tk)
    np.testing.assert_array_equal(got["secret_ntt"], want["secret_ntt"])
    for f in ("b", "a"):
        np.testing.assert_array_equal(got["public"][f], want["public"][f])
    for f in ("b", "a", "bs", "as_"):
        np.testing.assert_array_equal(got["relin"][f], want["relin"][f])
    for name in ("galois", "galois_p5"):
        assert sorted(got[name]) == sorted(want[name])
        for g in want[name]:
            for f in ("b", "a", "bs", "as_"):
                np.testing.assert_array_equal(
                    got[name][g][f], want[name][g][f], err_msg=f"{name}[{g}].{f}"
                )
    assert 2 * N - 1 in got["galois"] and 2 * N - 1 not in got["galois_p5"]


def test_keygen_without_switch_keys(pair):
    jc, tc, _, _ = pair
    jk = jkeys.keygen(jc, seed=5, need_relin=False)
    tk = tkeys.keygen(tc, seed=5, need_relin=False)
    _eq(tk.secret_ntt, jk.secret_ntt)
    _eq(tk.public.b, jk.public.b)
    assert tk.relin is None and not tk.galois and not tk.galois_p5


def test_keyset_roundtrip_through_convert(pair):
    _, _, jk, tk = pair
    back = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    for f in ("b", "a", "bs", "as_"):
        assert (getattr(back.relin, f) == getattr(tk.relin, f)).all()
    assert sorted(back.galois) == sorted(tk.galois)


def test_encode_equal(pair):
    jc, tc, _, _ = pair
    v = np.random.default_rng(3).uniform(-1, 1, jc.slots)
    jp = jckks.CkksEncoder(jc).encode(v)
    tp = tckks.CkksEncoder(tc).encode(v)
    _eq(tp.data, jp.data)
    assert (tp.level, tp.scale) == (jp.level, jp.scale)
    short = tckks.CkksEncoder(tc).encode(v[:10], scale=2.0**30)
    _eq(short.data, jckks.CkksEncoder(jc).encode(v[:10], scale=2.0**30).data)


@pytest.mark.parametrize("lead", [(), (3,)], ids=["single", "batch3"])
def test_encrypt_and_decrypt_equal(pair, lead):
    jc, tc, jk, tk = pair
    rng = np.random.default_rng(9)
    vals = rng.uniform(-1, 1, lead + (jc.slots,))
    jenc, tenc = jckks.CkksEncoder(jc), tckks.CkksEncoder(tc)
    if lead:
        import jax.numpy as jnp
        import torch
        from dataclasses import replace

        jpts = [jenc.encode(v) for v in vals]
        tpts = [tenc.encode(v) for v in vals]
        jpt = replace(jpts[0], data=jnp.stack([p.data for p in jpts]))
        tpt = replace(tpts[0], data=torch.stack([p.data for p in tpts]))
    else:
        jpt, tpt = jenc.encode(vals), tenc.encode(vals)
    jct = jckks.CkksEncryptor(jc, jk, seed=21).encrypt_pt(jpt)
    tct = tckks.CkksEncryptor(tc, tk, seed=21).encrypt_pt(tpt)
    assert_same_ct(tct, jct)
    jd, td = jckks.CkksDecryptor(jc, jk), tckks.CkksDecryptor(tc, tk)
    _eq(td._device_coeffs(tct), jd._device_coeffs(jct))
    got, want = td.decrypt(tct), jd.decrypt(jct)
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0)
    np.testing.assert_allclose(np.real(got), vals, atol=5e-5, rtol=0)


def test_encrypt_zero_and_empty_batch(pair):
    jc, tc, jk, tk = pair
    jz = jckks.CkksEncryptor(jc, jk, seed=4).encrypt_zero(jc.L, jc.scale)
    tz = tckks.CkksEncryptor(tc, tk, seed=4).encrypt_zero(tc.L, tc.scale)
    assert_same_ct(tz, jz)
    import torch

    empty = tcore.Plaintext(
        data=torch.zeros((0, tc.L, N), dtype=tmod.STORE), level=tc.L, scale=1.0
    )
    with pytest.raises(ValueError):
        tckks.CkksEncryptor(tc, tk, seed=4).encrypt_pt(empty)


def test_host_rns_helpers():
    from reference_seal_backend_tpu.schemes import core as jcore

    primes = (1073692673, 67104769, 67127297)
    rng = np.random.default_rng(0)
    c = rng.integers(-(2**40), 2**40, 64)
    r = tcore.int_poly_to_rns(c, primes)
    np.testing.assert_array_equal(r, jcore.int_poly_to_rns(c, primes))
    m = tcore.rns_to_mont(r, primes)
    np.testing.assert_array_equal(m, jcore.rns_to_mont(r, primes))
    np.testing.assert_array_equal(tcore.mont_to_rns(m, primes), r)
    got = tcore.crt_compose_centered(r, primes)
    assert (got == jcore.crt_compose_centered(r, primes)).all()
    assert (got == c.astype(object)).all()


@pytest.mark.slow
def test_registered_n8192_context_and_keys_equal():
    """The registered parameter set of the six descriptors (N=8192, depth 2,
    128-bit security enforced): chain, tables and a relin-only keygen."""
    from reference_seal_backend_tpu.schemes.params import make_ckks_context as jmk

    jc = jmk(8192, mult_depth=2, sec_level=128)
    tc = tparams.make_ckks_context(8192, mult_depth=2, sec_level=128, device="cpu")
    assert tc.primes == jc.primes and len(tc.primes) == 7
    assert (tc.digit_group, tc.n_special, tc.plan.lazy) == (1, 1, True)
    for f in ("p", "mu", "div_inv", "div_inv_mont_shoup", "div_mod", "div_half"):
        _eq_const(getattr(tc, f), getattr(jc, f))
    jk = jkeys.keygen(jc, seed=1234, need_relin=True)
    tk = tkeys.keygen(tc, seed=1234, need_relin=True)
    _eq(tk.secret_ntt, jk.secret_ntt)
    for f in ("b", "a", "bs", "as_"):
        _eq(getattr(tk.relin, f), getattr(jk.relin, f))
