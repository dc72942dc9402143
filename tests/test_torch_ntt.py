"""Port NTT (plan tables, plain version, dispatch) vs the JAX package's
``NttPlan``, its Pallas kernel in interpret mode and the host oracle; same
numpy inputs, tolerance 0 on every uint32 result."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from reference_seal_backend_tpu.nums import polyref, primegen
from reference_seal_backend_tpu.ops import ntt as jntt
from reference_seal_backend_tpu.ops.pallas import ntt_kernel
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.ops import ntt as tntt


def _plans(n, n_limbs=3, bits=29):
    primes = tuple(primegen.gen_ntt_primes(n_limbs, bits, 2 * n))
    return jntt.make_plan(n, primes), tntt.make_plan(n, primes, "cpu")


def _col(rng, hi, shape):
    return rng.integers(0, hi, shape, dtype=np.uint64).astype(np.uint32)


def _data(plan, lead, seed, mult=1, lo=0, nl=None):
    """[*lead, nl, N] residues below mult*p per limb."""
    nl = len(plan.primes) - lo if nl is None else nl
    rng = np.random.default_rng(seed)
    return np.stack(
        [_col(rng, mult * p, (*lead, plan.n)) for p in plan.primes[lo : lo + nl]],
        axis=-2,
    )


def _t(x):
    return tmod.from_numpy(x)


@pytest.mark.parametrize("n", [64, 256])
def test_plan_tables(n):
    jp, tp = _plans(n)
    assert tp.primes == jp.primes and tp.psis == jp.psis
    assert tp.lazy == jp.lazy is True
    roots, roots_s = tmod.to_numpy(tp.roots), tmod.to_numpy(tp.roots_shoup)
    iroots, iroots_s = tmod.to_numpy(tp.iroots), tmod.to_numpy(tp.iroots_shoup)
    for s in range(n.bit_length() - 1):
        m = 1 << s
        for (w, ws), (tw, tws) in (
            (jp.fwd_tw[s], (roots, roots_s)), (jp.inv_tw[s], (iroots, iroots_s))
        ):
            np.testing.assert_array_equal(tw[:, m : 2 * m], np.asarray(w)[..., 0])
            np.testing.assert_array_equal(tws[:, m : 2 * m], np.asarray(ws)[..., 0])
    for mine, ref in (
        (tp.n_inv, jp.n_inv[0]), (tp.n_inv_shoup, jp.n_inv[1]),
        (tp.p, jp.p), (tp.p_neg_inv, jp.p_neg_inv),
    ):
        np.testing.assert_array_equal(tmod.to_numpy(mine), np.asarray(ref))


@pytest.mark.parametrize("n", [64, 256, 2048])
@pytest.mark.parametrize("inverse", [False, True])
def test_transform_matches_reference(n, inverse):
    """N=64 takes the reference's flat loop, 256 and 2048 its four-step
    layout: the port's flat stage loop must give the same integers."""
    jp, tp = _plans(n)
    x = _data(tp, (2,), seed=n)
    if inverse:
        want = jax.jit(lambda a: jp.inv(a))(jnp.asarray(x))
        got = tp.inv(_t(x))
    else:
        want = jax.jit(lambda a: jp.fwd(a))(jnp.asarray(x))
        got = tp.fwd(_t(x))
    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want))


@pytest.mark.parametrize("n", [64, 256])
def test_limb_offset(n):
    """lo > 0 with a single row (the special-modulus row)."""
    jp, tp = _plans(n)
    x = _data(tp, (3,), seed=7, lo=2, nl=1)
    want = jax.jit(lambda a: jp.fwd(a, lo=2))(jnp.asarray(x))
    np.testing.assert_array_equal(
        tmod.to_numpy(tp.fwd(_t(x), lo=2)), np.asarray(want)
    )
    wanti = jax.jit(lambda a: jp.inv(a, lo=2))(jnp.asarray(x))
    np.testing.assert_array_equal(
        tmod.to_numpy(tp.inv(_t(x), lo=2)), np.asarray(wanti)
    )


@pytest.mark.parametrize("n", [64, 1024])
@pytest.mark.parametrize("mult", [1, 2])
def test_no_epilogue_and_lazy_inputs(n, mult):
    """epilogue=False returns the same [0, 4p) representatives; inputs in
    [0, 2p) are accepted by forward and inverse."""
    jp, tp = _plans(n)
    x = _data(tp, (2,), seed=3, mult=mult)
    want = jax.jit(lambda a: jp.fwd(a, epilogue=False))(jnp.asarray(x))
    got = tmod.to_numpy(tp.fwd(_t(x), epilogue=False))
    np.testing.assert_array_equal(got, np.asarray(want))
    p = np.array(tp.primes, dtype=np.uint64)[:, None]
    assert (got < 4 * p).all()
    want_e = jax.jit(lambda a: jp.fwd(a))(jnp.asarray(x))
    np.testing.assert_array_equal(tmod.to_numpy(tp.fwd(_t(x))), np.asarray(want_e))
    want_i = jax.jit(lambda a: jp.inv(a))(jnp.asarray(x))
    np.testing.assert_array_equal(tmod.to_numpy(tp.inv(_t(x))), np.asarray(want_i))


@pytest.mark.parametrize("n", [64, 256])
def test_non_lazy_plan(n):
    """A 31-bit prime turns the lazy butterflies off on both sides."""
    jp, tp = _plans(n, n_limbs=2, bits=31)
    assert not tp.lazy and not jp.lazy
    x = _data(tp, (2,), seed=11)
    f = jax.jit(lambda a: jp.fwd(a))(jnp.asarray(x))
    got = tp.fwd(_t(x))
    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(f))
    np.testing.assert_array_equal(tmod.to_numpy(tp.inv(got)), x)
    np.testing.assert_array_equal(
        tmod.to_numpy(tp.inv(_t(x))),
        np.asarray(jax.jit(lambda a: jp.inv(a))(jnp.asarray(x))),
    )


@pytest.mark.parametrize("inverse", [False, True])
def test_matches_pallas_kernel_interpret(inverse):
    """The TPU kernel the CUDA kernel replaces, run in interpret mode on the
    CPU as the JAX package's own tests run it, against the port's plain
    version (which the CUDA kernel is held against on the card)."""
    jp, tp = _plans(256)
    x = _data(tp, (2,), seed=42)
    with pltpu.force_tpu_interpret_mode():
        want = ntt_kernel.transform(jp, jnp.asarray(x), lo=0, inverse=inverse)
    got = tp.inv(_t(x)) if inverse else tp.fwd(_t(x))
    np.testing.assert_array_equal(tmod.to_numpy(got), np.asarray(want))


def test_matches_host_oracle():
    _, tp = _plans(64)
    x = _data(tp, (), seed=5)
    got = tmod.to_numpy(tp.fwd(_t(x)))
    for i, (p, psi) in enumerate(zip(tp.primes, tp.psis)):
        np.testing.assert_array_equal(
            got[i], polyref.host_ntt(x[i].astype(np.int64), psi, p).astype(np.uint32)
        )


@pytest.mark.parametrize("n", [64, 256, 2048])
def test_roundtrip(n):
    _, tp = _plans(n)
    x = _data(tp, (2, 2), seed=9)
    np.testing.assert_array_equal(tmod.to_numpy(tp.inv(tp.fwd(_t(x)))), x)


@pytest.mark.parametrize("g", [3, 5, 25, 2 * 256 - 1, 5 + 2 * 256])
def test_galois_perm(g):
    jp, tp = _plans(256)
    want = np.asarray(jp.galois_perm(g))
    np.testing.assert_array_equal(tp.galois_perm_np(g), want)
    np.testing.assert_array_equal(tp.galois_perm(g).numpy(), want)
    x = _data(tp, (2,), seed=1)
    np.testing.assert_array_equal(
        tmod.to_numpy(tp.apply_galois_eval(_t(x), g)),
        np.asarray(jp.apply_galois_eval(jnp.asarray(x), g)),
    )


def test_galois_is_coefficient_automorphism():
    """NTT(x(X^g)) == permuted NTT(x), against the host oracle."""
    _, tp = _plans(64, n_limbs=1)
    p = tp.primes[0]
    x = _data(tp, (), seed=2)
    auto = polyref.coeff_automorphism_ref(x[0].astype(np.int64), 5, p)
    want = tp.fwd(_t(auto.astype(np.uint32)[None]))
    got = tp.apply_galois_eval(tp.fwd(_t(x)), 5)
    np.testing.assert_array_equal(tmod.to_numpy(got), tmod.to_numpy(want))


def test_rejects_bad_n():
    with pytest.raises(ValueError):
        tntt.make_plan(48, (97,), "cpu")
