"""``composite.collapse``, ``collapse_rotation_steps`` and
``evaluate_polynomial`` of the port vs the JAX package's, at N=1024, depth 4,
``sec_level=0``, at G=1 and at a forced ``digit_group=2`` (two special primes,
the layout of the registered logistic-regression context).  Keys and
ciphertexts are made by the JAX package and carried across as numpy by
``convert.py``.  Ciphertext residues: tolerance 0.  Decoded slots: ``atol=1e-9``
against the JAX package's, 5e-5 against the cleartext truth.  Every tensor the
port hands to a transform also passes the CUDA wrapper's view rules.

Cold wall time alone (empty JAX cache, this CPU): see CHANGES.md."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.schemes import ckks as tckks

from torch_port_util import (
    assert_same_ct,
    check_ntt_views,
    contexts,
    ct_to_port,
    jax_keyset_to_numpy,
)

N = 1024
COUNTS = (4, 5)  # 5 takes the odd-survivor branch of the doubling merge
SIGMOID_D3 = (0.5, 0.15012, 0.0, -0.0015930078125)
POLYS = {"degree3": SIGMOID_D3, "degree1": (1.5, -0.25), "constant": (0.75,)}


@pytest.fixture(scope="module", params=[1, 2], ids=["G1", "G2"])
def sides(request):
    G = request.param
    jc, tc = contexts(N, digit_group=G, mult_depth=4)
    assert tc.digit_group == tc.n_special == G
    steps = jcomp.collapse_rotation_steps(max(COUNTS))
    elts = [pow(5, s % (N // 2), 2 * N) for s in steps]
    jk = jkeys.keygen(jc, seed=21, galois_elts=elts, need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk), device="cpu")
    rng = np.random.default_rng(9)
    enc = jckks.CkksEncoder(jc)
    er = jckks.CkksEncryptor(jc, jk, seed=21)
    vals = rng.uniform(-1, 1, max(COUNTS))
    cts = []
    for v in vals:  # one ciphertext per value, the value in slot 0
        vec = np.zeros(jc.slots)
        vec[0] = v
        cts.append(er.encrypt_pt(enc.encode(vec)))
    batched = replace(cts[0], data=jnp.stack([c.data for c in cts]))
    x = rng.uniform(-4, 4, jc.slots)
    jx = er.encrypt_pt(enc.encode(x))
    return {
        "jev": JEvaluator(jc, jk), "tev": TEvaluator(tc, tk),
        "jdec": jckks.CkksDecryptor(jc, jk), "tdec": tckks.CkksDecryptor(tc, tk),
        "vals": vals, "jbatched": batched, "tbatched": ct_to_port(batched),
        "x": x, "jx": jx, "tx": ct_to_port(jx),
    }


def _decoded(s, got, want):
    dec = np.real(s["tdec"].decrypt(got))
    np.testing.assert_allclose(
        dec, np.real(s["jdec"].decrypt(want)), atol=1e-9, rtol=0
    )
    return dec


@pytest.mark.parametrize("count", COUNTS)
def test_collapse_bit_exact(sides, count, monkeypatch):
    s = sides
    take = lambda ct: replace(ct, data=ct.data[:count])
    want = jax.jit(lambda ct: jcomp.collapse(s["jev"], ct, count))(take(s["jbatched"]))
    seen = check_ntt_views(monkeypatch)
    got = tcomp.collapse(s["tev"], take(s["tbatched"]), count)
    assert seen
    assert_same_ct(got, want)
    dec = _decoded(s, got, want)
    np.testing.assert_allclose(dec[:count], s["vals"][:count], atol=5e-5, rtol=0)


def test_collapse_refuses_a_short_batch(sides):
    with pytest.raises(ValueError):
        tcomp.collapse(sides["tev"], sides["tbatched"], max(COUNTS) + 1)
    with pytest.raises(ValueError):
        tcomp.collapse(sides["tev"], sides["tx"], 1)  # no batch axis


@pytest.mark.parametrize("count", [1, 2, 5, 100])
def test_collapse_rotation_steps(count):
    assert tcomp.collapse_rotation_steps(count) == jcomp.collapse_rotation_steps(count)


@pytest.mark.parametrize("poly", sorted(POLYS))
def test_evaluate_polynomial_bit_exact(sides, poly, monkeypatch):
    s, coeffs = sides, POLYS[poly]
    want = jax.jit(lambda ct: jcomp.evaluate_polynomial(s["jev"], ct, coeffs))(s["jx"])
    seen = check_ntt_views(monkeypatch)
    got = tcomp.evaluate_polynomial(s["tev"], s["tx"], coeffs)
    assert seen  # (the constant's only transform is its encode)
    assert_same_ct(got, want)
    dec = _decoded(s, got, want)
    truth = sum(c * s["x"] ** i for i, c in enumerate(coeffs))
    np.testing.assert_allclose(dec, truth, atol=5e-5, rtol=0)


def test_constants_are_encoded_once(sides, monkeypatch):
    """A second call finds every plaintext constant in the evaluator's cache:
    no host FFT encode, and the same ciphertext."""
    s = sides
    first = tcomp.evaluate_polynomial(s["tev"], s["tx"], SIGMOID_D3)
    calls = []
    encode = tckks.CkksEncoder.encode
    monkeypatch.setattr(
        tckks.CkksEncoder, "encode",
        lambda self, *a, **k: calls.append(1) or encode(self, *a, **k),
    )
    again = tcomp.evaluate_polynomial(s["tev"], s["tx"], SIGMOID_D3)
    tcomp.collapse(s["tev"], replace(s["tbatched"], data=s["tbatched"].data[:4]), 4)
    assert not calls
    assert torch.equal(first.data, again.data)
    with pytest.raises(ValueError):
        tcomp.evaluate_polynomial(s["tev"], s["tx"], ())
