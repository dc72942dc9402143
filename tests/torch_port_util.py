"""Shared helpers of the ``test_torch_*`` files: build the same context in
the JAX package and in the PyTorch port, and carry state across as numpy."""

import numpy as np
import torch

from reference_seal_backend_tpu.schemes import params as jparams
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.ops import modops as tmod
from reference_seal_backend_tpu_torch.schemes import params as tparams

# The suite runs several worker processes on one machine.  At the tests'
# sizes PyTorch's CPU kernels gain nothing from intra-op threads, and a
# thread pool per worker oversubscribes the cores so badly that a file takes
# ten times as long as alone.  Every test_torch_* file imports this module.
torch.set_num_threads(1)


def contexts(n, digit_group=None, mult_depth=2):
    """(JAX context, port context on the CPU) for one small parameter set."""
    kw = dict(
        poly_modulus_degree=n, mult_depth=mult_depth, sec_level=0,
        digit_group=digit_group,
    )
    return jparams.make_ckks_context(**kw), tparams.make_ckks_context(
        device="cpu", **kw
    )


def bfv_contexts(n, digit_group=None):
    """(JAX BFV context, port BFV context on the CPU) at ``sec_level=0``."""
    kw = dict(poly_modulus_degree=n, sec_level=0, digit_group=digit_group)
    return jparams.make_bfv_context(**kw), tparams.make_bfv_context(
        device="cpu", **kw
    )


def wide_to_numpy(x) -> np.ndarray:
    """Port working-format tensor (int64 holding uint32 values) -> uint32."""
    return x.cpu().numpy().astype(np.uint32)


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
    return convert.ciphertext_from_numpy(
        np.asarray(ct.data), ct.level, ct.scale, device="cpu")


def pt_to_port(pt):
    return convert.plaintext_from_numpy(
        np.asarray(pt.data), pt.level, pt.scale, device="cpu")


def assert_same_ct(got, want):
    """Port ciphertext equals JAX ciphertext: residues bit for bit
    (tolerance 0), level exactly, scale to float round-off."""
    np.testing.assert_array_equal(tmod.to_numpy(got.data), np.asarray(want.data))
    assert got.level == want.level
    assert got.scale == want.scale


def check_ntt_views(monkeypatch):
    """Hold every tensor that reaches ``NttPlan.fwd`` / ``NttPlan.inv`` to the
    rules of the CUDA wrapper (``ops/cuda/ntt.py``): a contiguous tensor or a
    limb slice of one, rows at multiples of 16 bytes.  On the CPU the plain
    version takes any strides, so without this a view that only the card
    refuses would pass every test here.  Pure stride arithmetic; raises where
    the card would.  Returns the list of shapes seen."""
    from reference_seal_backend_tpu_torch.ops import ntt as tntt
    from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda

    seen = []

    def held(x, n):
        _, row_stride = ntt_cuda._row_layout(x, n)
        if x.storage_offset() % 4 or row_stride % 4:
            raise ValueError(f"rows not at multiples of 16 bytes: {x.stride()}")
        seen.append(tuple(x.shape))

    fwd, inv = tntt.NttPlan.fwd, tntt.NttPlan.inv

    def fwd_held(self, x, lo=0, epilogue=True):
        held(x, self.n)
        return fwd(self, x, lo, epilogue)

    def inv_held(self, x, lo=0):
        held(x, self.n)
        return inv(self, x, lo)

    monkeypatch.setattr(tntt.NttPlan, "fwd", fwd_held)
    monkeypatch.setattr(tntt.NttPlan, "inv", inv_held)
    return seen


def pipeline_both(name, params, batch, monkeypatch, seed=1234):
    """Run one descriptor through the JAX package's and the port's benchmark
    (the port on the CPU) on the same seeded inputs and hold them equal at
    every step: inputs, ciphertexts and ``operate``'s result (tolerance 0),
    the port's transforms to the CUDA wrapper's view rules.  ``batch`` is
    the sample count per operand.  Returns ``(port outputs, JAX outputs,
    truth, port benchmark, shapes the port's operate handed to a transform)``."""
    from reference_seal_backend_tpu.engine import runner as jrunner
    from reference_seal_backend_tpu.engine.registry import Engine as JEngine
    from reference_seal_backend_tpu_torch.engine import runner as trunner
    from reference_seal_backend_tpu_torch.engine.registry import Engine as TEngine

    jeng, teng = JEngine(), TEngine("cpu")
    jb = jeng.create_benchmark(jeng.find(name), params)
    tb = teng.create_benchmark(teng.find(name), params)
    assert type(tb).__name__ == type(jb).__name__
    assert tb.rotation_steps() == jb.rotation_steps()
    assert tb._galois_elements() == jb._galois_elements()
    assert tb.describe() == jb.describe()
    jin, _ = jrunner._gen_inputs(
        jb.descriptor, jb.params, np.random.default_rng(seed), batch, batch)
    tin, truth = trunner.gen_inputs(
        tb.descriptor, tb.params, np.random.default_rng(seed), batch, batch)
    for x, y in zip(jin, tin):
        np.testing.assert_array_equal(x, y)

    jct = jb.load(jb.encrypt(jb.encode(jin)))
    tct = tb.load(tb.encrypt(tb.encode(tin)))
    assert tct.tag == jct.tag and tct.meta == jct.meta
    for j, t in zip(jct.payload, tct.payload):  # same keys, same randomness
        assert_same_ct(t, j)

    jres = jb.block(jb.operate(jct))
    seen = check_ntt_views(monkeypatch)
    tres = tb.block(tb.operate(tct))
    seen = list(seen)  # operate's views only, not decrypt's
    assert_same_ct(tres.payload, jres.payload)
    assert tres.tag == jres.tag and tres.meta == jres.meta

    jout = jb.decode(jb.decrypt(jb.store(jres)))
    tout = tb.decode(tb.decrypt(tb.store(tres)))
    return tout, jout, truth(), tb, seen
