"""Shared helpers of the ``test_torch_*`` files: build the same context in
the JAX package and in the PyTorch port, and carry state across as numpy."""

import numpy as np

from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.schemes import params as tparams


def contexts(n, digit_group=None, mult_depth=2):
    """(JAX context, port context on the CPU) for one small parameter set."""
    kw = dict(
        poly_modulus_degree=n, mult_depth=mult_depth, sec_level=0,
        digit_group=digit_group,
    )
    return jparams.make_ckks_context(**kw), tparams.make_ckks_context(
        device="cpu", **kw
    )


def _sk_np(k):
    return {f: np.asarray(getattr(k, f)) for f in ("b", "a", "bs", "as_")}


def jax_keyset_to_numpy(ks) -> dict:
    return {
        "secret_ntt": np.asarray(ks.secret_ntt),
        "public": {"b": np.asarray(ks.public.b), "a": np.asarray(ks.public.a)},
        "relin": None if ks.relin is None else _sk_np(ks.relin),
        "galois": {g: _sk_np(k) for g, k in ks.galois.items()},
        "galois_p5": {g: _sk_np(k) for g, k in ks.galois_p5.items()},
    }


def ct_to_port(ct):
    """JAX Ciphertext -> port Ciphertext (CPU) with the same residues."""
    return convert.ciphertext_from_numpy(np.asarray(ct.data), ct.level, ct.scale)


def pt_to_port(pt):
    return convert.plaintext_from_numpy(np.asarray(pt.data), pt.level, pt.scale)


def assert_same_ct(got, want):
    """Port ciphertext equals JAX ciphertext: residues bit for bit
    (tolerance 0), level exactly, scale to float round-off."""
    np.testing.assert_array_equal(tmod.to_numpy(got.data), np.asarray(want.data))
    assert got.level == want.level
    assert got.scale == want.scale
