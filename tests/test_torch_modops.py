"""Port modops vs the JAX package's, same numpy inputs, tolerance 0: every
function, random uint32 vectors plus the edge values 0, p-1, 2p-1, 4p-1 and
2**32-1, for a 30-bit and a 31-bit NTT prime.  Both implementations wrap like
uint32 everywhere, so the comparison holds for any input, in or out of a
function's range contract."""

import numpy as np
import pytest
import jax.numpy as jnp

from reference_seal_backend_tpu.nums import primegen
from reference_seal_backend_tpu.ops import modops as jmod
from reference_seal_backend_tpu_torch.ops import modops as tmod

PRIMES = {
    30: primegen.gen_ntt_primes(1, 30, 4096)[0],
    31: primegen.gen_ntt_primes(1, 31, 4096)[0],
}
M32 = 2**32 - 1


def _vectors(p, seed):
    rng = np.random.default_rng(seed)
    edges = np.array(
        [0, 1, p - 1, p, min(2 * p - 1, M32), min(2 * p, M32),
         min(4 * p - 1, M32), 2**31 - 1, 2**31, M32],
        dtype=np.uint64,
    )
    a = np.concatenate([edges, np.repeat(edges, len(edges)),
                        rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    b = np.concatenate([edges, np.tile(edges, len(edges)),
                        rng.integers(0, 2**32, 4096, dtype=np.uint64)])
    return a.astype(np.uint32), b.astype(np.uint32)


def _consts(p):
    c = jmod.mont_consts(p)
    rng = np.random.default_rng(p)
    w = rng.integers(0, p, 1, dtype=np.uint64)[0]
    return c, np.uint32(w), np.uint32((int(w) << 32) // p)


# name -> (jax call, port call), each taking (a, b, consts, w, ws) arrays
def _cases():
    return {
        "umulhi32": lambda M, a, b, c, w, ws: M.umulhi32(a, b),
        "mont_mul": lambda M, a, b, c, w, ws: M.mont_mul(a, b, c["p"], c["p_neg_inv"]),
        "shoup_mul": lambda M, a, b, c, w, ws: M.shoup_mul(a, w, ws, c["p"]),
        "shoup_mul_lazy": lambda M, a, b, c, w, ws: M.shoup_mul_lazy(a, w, ws, c["p"]),
        "reduce_2p": lambda M, a, b, c, w, ws: M.reduce_2p(a, c["p2"]),
        "reduce_4p_full": lambda M, a, b, c, w, ws: M.reduce_4p_full(a, c["p"]),
        "mod_add": lambda M, a, b, c, w, ws: M.mod_add(a, b, c["p"]),
        "mod_sub": lambda M, a, b, c, w, ws: M.mod_sub(a, b, c["p"]),
        "mod_neg": lambda M, a, b, c, w, ws: M.mod_neg(a, c["p"]),
        "barrett_reduce_u32": lambda M, a, b, c, w, ws: M.barrett_reduce_u32(a, c["p"], c["mu"]),
        "barrett_reduce_u32_lazy": lambda M, a, b, c, w, ws: M.barrett_reduce_u32_lazy(a, c["p"], c["mu"]),
        "to_mont": lambda M, a, b, c, w, ws: M.to_mont(a, c["p"], c["p_neg_inv"], c["r2"]),
        "from_mont": lambda M, a, b, c, w, ws: M.from_mont(a, c["p"], c["p_neg_inv"]),
    }


@pytest.mark.parametrize("bits", [30, 31])
@pytest.mark.parametrize("name", sorted(_cases()))
def test_matches_reference(name, bits):
    p = PRIMES[bits]
    fn = _cases()[name]
    a, b = _vectors(p, seed=bits)
    c, w, ws = _consts(p)
    c = dict(c, p2=np.uint32((2 * p) & M32))
    jc = {k: jnp.asarray(v) for k, v in c.items()}
    tc = {k: tmod.from_numpy(np.asarray(v)) for k, v in c.items()}
    want = np.asarray(
        fn(jmod, jnp.asarray(a), jnp.asarray(b), jc, jnp.asarray(w), jnp.asarray(ws))
    )
    got = tmod.to_numpy(
        fn(tmod, tmod.from_numpy(a), tmod.from_numpy(b), tc,
           tmod.from_numpy(np.asarray(w)), tmod.from_numpy(np.asarray(ws)))
    )
    np.testing.assert_array_equal(got, want)  # integers: tolerance 0


def test_umulhi32_top_edge():
    """0xFFFFFFFF x 0xFFFFFFFF does not fit int64: the wrap of the int64
    product must still give the exact high word."""
    x = tmod.from_numpy(np.array([M32], dtype=np.uint32))
    assert int(tmod.to_numpy(tmod.umulhi32(x, x))[0]) == (M32 * M32) >> 32


@pytest.mark.parametrize("bits", [30, 31])
def test_arithmetic_against_bignum(bits):
    """The port's products against Python integers (independent oracle)."""
    p = PRIMES[bits]
    rng = np.random.default_rng(5)
    a = rng.integers(0, p, 512, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, p, 512, dtype=np.uint64).astype(np.uint32)
    c = tmod.mont_consts(p)
    tc = {k: tmod.from_numpy(np.asarray(v)) for k, v in c.items()}
    got = tmod.to_numpy(
        tmod.mont_mul(tmod.from_numpy(a), tmod.from_numpy(b), tc["p"], tc["p_neg_inv"])
    )
    rinv = pow(1 << 32, -1, p)
    want = [int(x) * int(y) * rinv % p for x, y in zip(a, b)]
    np.testing.assert_array_equal(got, np.array(want, dtype=np.uint32))


@pytest.mark.parametrize("bits", [30, 31])
def test_host_helpers_and_consts(bits):
    p = PRIMES[bits]
    assert tmod.mont_consts(p) == jmod.mont_consts(p)
    x = np.random.default_rng(1).integers(0, p, 256, dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(tmod.host_to_mont(x, p), jmod.host_to_mont(x, p))
    np.testing.assert_array_equal(tmod.host_from_mont(x, p), jmod.host_from_mont(x, p))
    np.testing.assert_array_equal(tmod.host_from_mont(tmod.host_to_mont(x, p), p), x)
    with pytest.raises(ValueError):
        tmod.mont_consts(2**31 + 11)


def test_storage_roundtrip_and_add_raw():
    x = np.array([0, 1, 2**31 - 1, 2**31, M32], dtype=np.uint32)
    t = tmod.from_numpy(x)
    assert t.dtype == tmod.STORE
    np.testing.assert_array_equal(tmod.to_numpy(t), x)
    np.testing.assert_array_equal(tmod.to_numpy(tmod.narrow(tmod.wide(t))), x)
    np.testing.assert_array_equal(
        tmod.to_numpy(tmod.add_raw(t, t)), (x + x).astype(np.uint32)
    )
    np.testing.assert_array_equal(
        tmod.to_numpy(tmod.ugt(t, tmod.from_numpy(np.array([2**31 - 1], dtype=np.uint32)))),
        (x > 2**31 - 1).astype(np.uint32),
    )
