"""The BEHZ multiply of the port vs the JAX package's at N=1024,
``sec_level=0``: each conversion stage on random in-range inputs, the tensor
product, ``bfv_multiply`` under broadcast leading axes ``[3,1] x [1,4]`` and
the cipher-batch-axis cell's ``[2,3,1] x [1,3,2]``, multiply then
relinearize, and the rotations BFV shares with CKKS.  Tolerance
0 on every residue, every intermediate included; decrypted products equal to
the JAX package's and to the cleartext.  Every JAX-side call is jitted; every
tensor the port hands to a transform passes the CUDA wrapper's view rules.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator import behz as jbehz
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import bfv as jbfv
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch.evaluator import behz as tbehz
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
from reference_seal_backend_tpu_torch.schemes import keys as tkeys

from torch_port_util import (
    assert_same_ct,
    bfv_contexts,
    check_ntt_views,
    ct_to_port,
    wide_to_numpy,
)

N = 1024
SEED = 21


@pytest.fixture(scope="module")
def env():
    jc, tc = bfv_contexts(N)
    elts = [pow(5, s, 2 * N) for s in (1, 3)] + [2 * N - 1]
    jk = jkeys.keygen(jc, seed=SEED, galois_elts=elts)
    tk = tkeys.keygen(tc, seed=SEED, galois_elts=elts)
    return jc, tc, jk, tk, jbehz.tables_for(jc), tbehz.tables_for(tc)


def _residues(rng, primes, lead, bound=1):
    """uint32 residues ``[*lead, len(primes), N]`` below ``bound * p``."""
    p = np.array(primes, dtype=np.uint64)[:, None]
    x = rng.integers(0, 2**62, (*lead, len(primes), N), dtype=np.uint64)
    return (x % (p * np.uint64(bound))).astype(np.uint32)


def _same(wide, want):
    np.testing.assert_array_equal(wide_to_numpy(wide), np.asarray(want))


def _wide(x):
    return torch.from_numpy(x.astype(np.int64))


def test_conversions_q_to_bsk_equal(env):
    jc, tc, _, _, jt, tt = env
    x = _residues(np.random.default_rng(1), jc.data_primes, (3, 2))
    _same(tbehz._conv_to_bsk_mtilde(tt, _wide(x)),
          jax.jit(functools.partial(jbehz._conv_to_bsk_mtilde, jt))(x))
    _same(tbehz._fbc_q_to_bsk(tt, _wide(x), tt.t_qhinv),
          jax.jit(lambda v: jbehz._fbc_q_to_bsk(jt, v, jt.t_qhinv))(x))


def test_lazy_trees_and_sk_to_q_equal(env):
    """The exact conversion back to q, whose sums are lazy trees (the
    tree itself: tests/test_torch_modops.py::test_sum_tree_matches_reference)."""
    jc, tc, _, _, jt, tt = env
    rng = np.random.default_rng(2)
    y = _residues(rng, jc.bsk_primes, (3, 2))
    _same(tbehz._sk_to_q(tt, _wide(y)),
          jax.jit(functools.partial(jbehz._sk_to_q, jt))(y))


def test_tensor_product_equal(env):
    jc, tc, _, _, jt, tt = env
    rng = np.random.default_rng(3)
    primes = jc.data_primes + jc.bsk_primes
    x, y = (_residues(rng, primes, (4, 2)) for _ in range(2))
    _same(tbehz._tensor(_wide(x), _wide(y), tt.all_p, tt.all_pni),
          jax.jit(lambda a, b: jbehz._tensor(a, b, jt.all_p, jt.all_pni))(x, y))


def _encrypt_both(env, lead, seed):
    jc, tc, jk, tk, _, _ = env
    vals = np.random.default_rng(seed).integers(-30, 30, (*lead, N))
    enc = jbfv.BfvBatchEncoder(jc)
    pts = np.stack([np.asarray(enc.encode(v).data) for v in vals.reshape(-1, N)])
    pt = jbfv.core.Plaintext(
        data=jnp.asarray(pts.reshape(*lead, jc.L, N)), level=jc.L, scale=1.0)
    jct = jbfv.BfvEncryptor(jc, jk, seed=seed).encrypt_pt(pt)
    return vals, jct, ct_to_port(jct)


@pytest.mark.parametrize("lead_a, lead_b", [((3, 1), (1, 4)), ((2, 3, 1), (1, 3, 2))],
                         ids=["2-axis", "cba-3-axis"])
def test_bfv_multiply_broadcast_equal(env, monkeypatch, lead_a, lead_b):
    jc, tc, jk, tk, _, _ = env
    va, ja, ta = _encrypt_both(env, lead_a, 4)
    vb, jb, tb = _encrypt_both(env, lead_b, 5)
    jout = jax.jit(functools.partial(jbehz.bfv_multiply, jc))(ja, jb)
    seen = check_ntt_views(monkeypatch)
    tout = TEvaluator(tc, tk).multiply(ta, tb)
    # the four sweeps: both operands' iNTT and q u Bsk fwd on the distinct
    # ciphertexts (each operand's own, a's then b's), then q u Bsk inv and
    # output fwd on the broadcast products
    lead = tuple(np.broadcast_shapes(lead_a, lead_b))
    distinct = int(np.prod(lead_a) + np.prod(lead_b))
    assert seen == [(distinct, 2, 4, N), (distinct, 2, 10, N), (*lead, 3, 10, N),
                    (*lead, 3, 4, N)]
    assert_same_ct(tout, jout)
    assert tuple(tout.data.shape) == (*lead, 3, jc.L, N)
    got = tbfv.BfvDecryptor(tc, tk).decrypt(tout)
    np.testing.assert_array_equal(got, jbfv.BfvDecryptor(jc, jk).decrypt(jout))
    np.testing.assert_array_equal(got, va * vb)


def test_multiply_relinearize_equal(env, monkeypatch):
    jc, tc, jk, tk, _, _ = env
    va, ja, ta = _encrypt_both(env, (2,), 6)
    vb, jb, tb = _encrypt_both(env, (2,), 7)
    jev, tev = JEvaluator(jc, jk), TEvaluator(tc, tk)
    jout = jax.jit(lambda a, b: jev.relinearize(jev.multiply(a, b)))(ja, jb)
    check_ntt_views(monkeypatch)
    tout = tev.relinearize(tev.multiply(ta, tb))
    assert_same_ct(tout, jout)
    np.testing.assert_array_equal(
        tbfv.BfvDecryptor(tc, tk).decrypt(tout), va * vb)


def test_rotations_equal(env, monkeypatch):
    """rotate_rows, rotate_columns (conjugate) and the hoisted rotate_sum
    run unchanged on a BFV context, without a rescale."""
    jc, tc, jk, tk, _, _ = env
    v, jct, tct = _encrypt_both(env, (2,), 8)
    jev, tev = JEvaluator(jc, jk), TEvaluator(tc, tk)
    ops = {
        "rotate": lambda ev, c: ev.rotate(c, 3),
        "conjugate": lambda ev, c: ev.conjugate(c),
        "rotate_sum": lambda ev, c: ev.rotate_sum(c, [0, 1, 3]),
    }
    check_ntt_views(monkeypatch)
    dec = tbfv.BfvDecryptor(tc, tk)
    half = N // 2
    rows = v.reshape(2, 2, half)
    want = {
        "rotate": np.roll(rows, -3, axis=-1),
        "conjugate": rows[:, ::-1],
        "rotate_sum": sum(np.roll(rows, -s, axis=-1) for s in (0, 1, 3)),
    }
    for name, op in ops.items():
        jout = jax.jit(functools.partial(op, jev))(jct)
        tout = op(tev, tct)
        assert_same_ct(tout, jout)
        np.testing.assert_array_equal(
            dec.decrypt(tout), want[name].reshape(2, N), err_msg=name)
