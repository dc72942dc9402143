"""The BFV BEHZ multiply of ciphertexts placed on a mesh, and what follows it
(relinearize, rotate, ``rotate_sum``, ``accumulate(…, 8)``), through the
port's plain ``Evaluator`` (``parallel/limb.py:bfv_multiply``) vs the JAX
package's *unsharded* results on the same keys and ciphertexts, at N=2048,
``sec_level=0``: a batch of 4 pairs placed (dp=4, limb=2) at L = 4, G = 1
(two limbs a block), dp only (whole polynomials a block: the flat multiply
per block), and limb = 2 at L = 6, G = 2 (three limbs a block, so the
digit group of limbs 2 and 3 straddles the blocks).  Tolerance 0.  Every
case also holds the JAX package's own sharded result (GSPMD) equal to its
unsharded one: the port computes what the JAX package returns.  Lazy: the
registered path; non-lazy: the key switches' canonical branches
(``_lazy_ok`` forced off), their all-reduces' modular adds with them (the
BEHZ steps and their sums are lazy either way, as flat).  Collectives of every op
exact; every transform to the CUDA wrapper's view rules, K1 and K2 seen at
the top block's first limb.  The row windows of ``evaluator/behz.py``
against the JAX package's whole conversions, and the decrypted products
against the cleartext mod t.

Cold wall time of the file alone (empty JAX cache): see CHANGES.md."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator import behz as jbehz
from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.parallel import mesh as jmesh
from reference_seal_backend_tpu.schemes import bfv as jbfv
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator import behz as tbehz
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.evaluator import eval as teval
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.schemes import bfv as tbfv
from reference_seal_backend_tpu_torch.schemes import params as tparams
from reference_seal_backend_tpu_torch.utils import device as tdevice

from torch_port_util import (
    assert_same_ct,
    check_ntt_views,
    ct_to_port,
    jax_keyset_to_numpy,
    wide_to_numpy,
)

N = 2048
BATCH = 4
STEPS = sorted({2} | set(jcomp.rotations_for_accumulate(8, N // 2)))  # 1 .. 7
CONTEXTS = {"L4_G1": dict(n_data_primes=4), "L6_G2": dict(n_data_primes=6, digit_group=2)}
# (context, (dp, limb) of the port's mesh, batch axes, limb axis); the JAX
# package places the same batch on its 8-device (dp=4, limb=2) mesh
CASES = {
    "L4_G1_dp4_limb2": ("L4_G1", (4, 2), ("dp",), "limb"),
    "L4_G1_dp_only": ("L4_G1", (4, 2), ("dp",), None),
    "L6_G2_limb2": ("L6_G2", (1, 2), (None,), "limb"),
}


def _chain(ev, comp, a, b):
    m = ev.multiply(a, b)
    r = ev.relinearize(m)
    return m, r, comp.accumulate(ev, r, 8)


# the ops, on (x, y) or on the JAX package's relinearized product r
OPS = {
    "multiply": lambda ev, comp, x, y, r: ev.multiply(x, y),
    "relinearize": lambda ev, comp, x, y, r: ev.relinearize(ev.multiply(x, y)),
    "rotate": lambda ev, comp, x, y, r: ev.rotate(r, 2),
    "rotate_sum": lambda ev, comp, x, y, r: ev.rotate_sum(r, [0, 1, 2, 3]),
    "accumulate_chain": lambda ev, comp, x, y, r: _chain(ev, comp, x, y)[2],
}
# collectives of one op over a limb axis of 2, from the code: the multiply's
# two all-reduces (the input's q -> Bsk sums with the m_tilde sum as a row,
# the floor's q -> Bsk sum), one per key switch (rotate_sum and accumulate's
# one hoisted rotation: one); no all-gather, no permute.  None on dp only.
COLLECTIVES = {
    "multiply": {"all-reduce": 2},
    "relinearize": {"all-reduce": 3},
    "rotate": {"all-reduce": 1},
    "rotate_sum": {"all-reduce": 1},
    "accumulate_chain": {"all-reduce": 4},
}

_built = {}


def build(name):
    """One context's JAX keys, batch, unsharded results (jitted) and the
    port's evaluator and inputs; cached per context."""
    if name in _built:
        return _built[name]
    kw = dict(poly_modulus_degree=N, sec_level=0, **CONTEXTS[name])
    jc, tc = jparams.make_bfv_context(**kw), tparams.make_bfv_context(device="cpu", **kw)
    assert (tc.L, tc.plan.lazy) == (CONTEXTS[name]["n_data_primes"], True)
    jk = jkeys.keygen(jc, seed=5, galois_elts=[pow(5, s, 2 * N) for s in STEPS],
                      need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    rng = np.random.default_rng(7)
    vals = rng.integers(0, jc.t, (2, BATCH, N))
    enc = jbfv.BfvBatchEncoder(jc)

    def encrypt(v, seed):
        pts = np.stack([np.asarray(enc.encode(row).data) for row in v])
        pt = jbfv.core.Plaintext(data=jnp.asarray(pts), level=jc.L, scale=1.0)
        return jbfv.BfvEncryptor(jc, jk, seed=seed).encrypt_pt(pt)

    jx, jy = encrypt(vals[0], 1), encrypt(vals[1], 2)
    jev = JEvaluator(jc, jk)
    chain = jax.jit(functools.partial(_chain, jev, jcomp))
    want_chain = chain(jx, jy)
    want_rot = jax.jit(lambda r: tuple(OPS[k](jev, jcomp, None, None, r)
                                       for k in ("rotate", "rotate_sum")))(want_chain[1])
    want = dict(zip(("multiply", "relinearize", "accumulate_chain"), want_chain))
    want.update(zip(("rotate", "rotate_sum"), want_rot))
    _built[name] = dict(jc=jc, tc=tc, jk=jk, tk=tk, vals=vals, jx=jx, jy=jy,
                        chain=chain, want=want)
    return _built[name]


def _jax_sharded_equal(b, batch_axes, limb_axis):
    """The JAX package's GSPMD chain on the batch placed as the case
    places it equals its unsharded chain, integer for integer."""
    m = jmesh.make_mesh(8, ("dp", "limb"))
    place = lambda c: jmesh.shard_ct(c, m, n_batch_axes=1, batch_axes=batch_axes,
                                     limb_axis=limb_axis)
    got = b["chain"](place(b["jx"]), place(b["jy"]))
    for g, name in zip(got, ("multiply", "relinearize", "accumulate_chain")):
        np.testing.assert_array_equal(np.asarray(g.data), np.asarray(b["want"][name].data))


@pytest.mark.parametrize("lazy", [True, False], ids=["lazy", "nonlazy"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_placed_bfv_ops_equal_jax(case, lazy, monkeypatch):
    ctx_name, (dp, lb), batch_axes, limb_axis = CASES[case]
    b = build(ctx_name)
    if lazy:  # once a case: the JAX package's own sharded result
        _jax_sharded_equal(b, batch_axes, limb_axis)
    else:
        monkeypatch.setattr(teval, "_lazy_ok", lambda ctx: False)
    mesh = tmesh.make_mesh(dp * lb, devices=tdevice.mesh_devices("cpu", dp * lb),
                           shape=(dp, lb))
    ev = TEvaluator(b["tc"], b["tk"])
    assert ev._lazy() is lazy
    place = lambda c: tmesh.shard_ct(c, mesh, n_batch_axes=1, batch_axes=batch_axes,
                                     limb_axis=limb_axis)
    x, y, r = (place(ct_to_port(b[k] if k != "r" else b["want"]["relinearize"]))
               for k in ("jx", "jy", "r"))
    spec = (batch_axes[0], None, limb_axis, None)
    assert x.data.spec == spec
    rows = b["tc"].L // lb
    check_ntt_views(monkeypatch)
    for name, op in OPS.items():
        out = {}
        tntt.call_log = {}
        try:
            stats = sp_eval.collective_stats(
                lambda: out.setdefault("ct", op(ev, tcomp, x, y, r)))
            log = tntt.call_log
        finally:
            tntt.call_log = None
        got = out["ct"]
        assert got.data.spec == spec, name
        assert_same_ct(replace(got, data=got.data.gather()), b["want"][name])
        expected = dict.fromkeys(tmesh.COLLECTIVES, 0)
        expected.update(COLLECTIVES[name] if limb_axis else {}, a2a_bytes=0)
        assert stats == expected, (name, stats)
        # K1 and K2 at each block's first limb (whole polynomials: 0)
        for kernel in ("ntt_fwd", "ntt_inv"):
            assert {0, rows if limb_axis else 0} <= {
                k[5] for k in log if k[1] == kernel}, (name, kernel)


@pytest.mark.parametrize("case", ["L4_G1_dp4_limb2", "L6_G2_limb2"])
def test_placed_products_decrypt_to_cleartext(case):
    """The placed multiply, and the multiply -> relinearize, decrypt to the
    slot-wise products mod t, as the JAX package's results do."""
    ctx_name, (dp, lb), batch_axes, limb_axis = CASES[case]
    b = build(ctx_name)
    tc = b["tc"]
    mesh = tmesh.make_mesh(dp * lb, devices=tdevice.mesh_devices("cpu", dp * lb),
                           shape=(dp, lb))
    x, y = (tmesh.shard_ct(ct_to_port(b[k]), mesh, n_batch_axes=1,
                           batch_axes=batch_axes, limb_axis=limb_axis)
            for k in ("jx", "jy"))
    ev = TEvaluator(tc, b["tk"])
    dec, jdec = tbfv.BfvDecryptor(tc, b["tk"]), jbfv.BfvDecryptor(b["jc"], b["jk"])
    want = b["vals"][0] * b["vals"][1] % tc.t
    prod = ev.multiply(x, y)
    for ct, name in ((prod, "multiply"), (ev.relinearize(prod), "relinearize")):
        got = dec.decrypt(replace(ct, data=ct.data.gather()))
        np.testing.assert_array_equal(np.asarray(got) % tc.t, want, err_msg=name)
        np.testing.assert_array_equal(got, jdec.decrypt(b["want"][name]), err_msg=name)


def test_row_windows_sum_to_the_whole_conversions():
    """``evaluator/behz.py``'s row windows at L = 6 (windows from limbs 0,
    2, 3 and 4): the partial q -> Bsk sums of disjoint windows, added mod
    each Bsk prime (the m_tilde sum mod 2**16), finish to the JAX
    package's whole conversions; ``_sk_to_q`` of a window gives those rows
    of the whole one.  Tolerance 0."""
    b = build("L6_G2")
    jt, tt = jbehz.tables_for(b["jc"]), tbehz.tables_for(b["tc"])
    rng = np.random.default_rng(9)
    q = np.array(b["jc"].data_primes, dtype=np.uint64)[:, None]
    x = (rng.integers(0, 2**62, (2, 6, N), dtype=np.uint64) % q).astype(np.uint32)
    want_conv = jax.jit(functools.partial(jbehz._conv_to_bsk_mtilde, jt))(x)
    want_fbc = jax.jit(lambda v: jbehz._fbc_q_to_bsk(jt, v, jt.t_qhinv))(x)
    kb = len(b["tc"].bsk_primes)
    p = tbehz.conv_moduli(tt)
    xw = torch.from_numpy(x.astype(np.int64))
    for cuts in ((0, 3, 6), (0, 2, 4, 6), (0, 4, 6)):
        conv = fbc = 0
        for lo, hi in zip(cuts, cuts[1:]):
            xs, xt = tbehz._conv_partial(tt, xw[..., lo:hi, :], lo)
            conv = (conv + torch.cat([xs, xt[..., None, :]], dim=-2)) % p
            fbc = (fbc + tbehz._fbc_partial(tt, xw[..., lo:hi, :], tt.t_qhinv, lo)) % tt.bsk_p
        np.testing.assert_array_equal(
            wide_to_numpy(tbehz._conv_finish(tt, conv[..., :kb, :], conv[..., kb, :])),
            np.asarray(want_conv), err_msg=str(cuts))
        np.testing.assert_array_equal(wide_to_numpy(tbehz._canon(fbc, tt.bsk_p)),
                                      np.asarray(want_fbc), err_msg=str(cuts))
    bsk = np.array(b["jc"].bsk_primes, dtype=np.uint64)[:, None]
    y = (rng.integers(0, 2**62, (2, kb, N), dtype=np.uint64) % bsk).astype(np.uint32)
    want_sk = np.asarray(jax.jit(functools.partial(jbehz._sk_to_q, jt))(y))
    yw = torch.from_numpy(y.astype(np.int64))
    for lo, rows in ((0, 3), (3, 3), (2, 2), (4, 2), (5, 1)):
        np.testing.assert_array_equal(
            wide_to_numpy(tbehz._sk_to_q(tt, yw, lo, rows)),
            want_sk[..., lo : lo + rows, :], err_msg=str((lo, rows)))
