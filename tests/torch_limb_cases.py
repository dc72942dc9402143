"""Shared cases of test_torch_limb_g1.py (G=1, one special prime) and
test_torch_limb_g2.py (G=2, two special primes; three limbs a block, so the
digit group of limbs 2 and 3 straddles the two blocks): a CKKS ciphertext
batch placed over a (dp=4, limb=2) mesh (``batch_axes=("dp",)``) and over
a limb=2 mesh (``batch_axes=(None,)``), run through the port's plain
``Evaluator`` — relinearize, rotate, ``rotate_sum``, rescale,
``mod_switch_to`` and the ``accumulate(…, 8)`` chain of
tests/test_parallel.py:95-125 — against the JAX package's *unsharded*
result on the same keys and ciphertexts (its own test_parallel.py holds
that equal to its sharded one).  Tolerance 0.  Lazy: the registered path
(every prime below 2**30); non-lazy: the evaluator's canonical branches
(``_lazy_ok`` forced off; residues are the same either way), the
all-reduce's modular adds with them.  The collectives of every op are
counted and held to exact numbers; every transform to the CUDA wrapper's
view rules, K1 and K2 seen at a block's first limb."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np

from reference_seal_backend_tpu.evaluator import composite as jcomp
from reference_seal_backend_tpu.evaluator.eval import Evaluator as JEvaluator
from reference_seal_backend_tpu.schemes import ckks as jckks
from reference_seal_backend_tpu.schemes import keys as jkeys
from reference_seal_backend_tpu_torch import convert
from reference_seal_backend_tpu_torch.evaluator import composite as tcomp
from reference_seal_backend_tpu_torch.evaluator import eval as teval
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator as TEvaluator
from reference_seal_backend_tpu_torch.ops import ntt as tntt
from reference_seal_backend_tpu_torch.parallel import mesh as tmesh
from reference_seal_backend_tpu_torch.parallel import sp_eval
from reference_seal_backend_tpu_torch.utils import device as tdevice

from torch_port_util import assert_same_ct, check_ntt_views, contexts, jax_keyset_to_numpy

N = 2048
BATCH = 4
STEPS = sorted({2} | set(jcomp.rotations_for_accumulate(8, N // 2)))  # 1 .. 7

# the ops, written once for both packages; each takes the previous op's
# JAX result where it needs a size-2 or a rescaled input
OPS = {
    "relinearize": lambda ev, a: ev.relinearize(ev.multiply(a, a)),
    "rotate": lambda ev, a: ev.rotate(a, 2),
    "rotate_sum": lambda ev, a: ev.rotate_sum(a, [0, 1, 2, 3]),
    "rescale_to_next": lambda ev, a: ev.rescale_to_next(a),
    "mod_switch_to": lambda ev, a: ev.mod_switch_to(a, 4),
    "accumulate_chain": lambda ev, a: jcomp_or_tcomp(ev).accumulate(
        ev, ev.rescale_to_next(ev.relinearize(ev.multiply(a, a))), 8),
}
# the input of each op: the fresh batch, or the relinearized product
INPUT = {"rescale_to_next": "relinearize"}

# collectives of one op over a limb axis of 2, from the code: one modular
# all-reduce per key switch (rotate_sum: one for all its steps); a rescale
# group of 2 drops limbs 5 and 4, both in the top block (3/3 -> 3/1): an
# all-gather of each dropped row, one collective-permute to 2/2; a mod
# switch 6 -> 4 the same permute
COLLECTIVES = {
    "relinearize": {"all-reduce": 1},
    "rotate": {"all-reduce": 1},
    "rotate_sum": {"all-reduce": 1},
    "rescale_to_next": {"all-gather": 2, "collective-permute": 1},
    "mod_switch_to": {"collective-permute": 1},
    "accumulate_chain": {"all-reduce": 2, "all-gather": 2, "collective-permute": 1},
}
MESHES = {"dp4_limb2": (8, ("dp",)), "limb2": (2, (None,))}


def jcomp_or_tcomp(ev):
    return tcomp if isinstance(ev, TEvaluator) else jcomp


def build(digit_group):
    """The JAX results of every op (unsharded, jitted) and the port's
    evaluator, keys and inputs."""
    jc, tc = contexts(N, digit_group=digit_group)
    assert (tc.L, tc.digit_group, tc.plan.lazy) == (6, digit_group or 1, True)
    jk = jkeys.keygen(jc, seed=5, galois_elts=[pow(5, s, 2 * N) for s in STEPS],
                      need_relin=True)
    tk = convert.keyset_from_numpy(jax_keyset_to_numpy(jk))
    enc, er = jckks.CkksEncoder(jc), jckks.CkksEncryptor(jc, jk, seed=5)
    rng = np.random.default_rng(7)
    cts = [er.encrypt_pt(enc.encode(rng.uniform(-1, 1, jc.slots))) for _ in range(BATCH)]
    jct = replace(cts[0], data=jnp.stack([c.data for c in cts]))
    jev = JEvaluator(jc, jk)
    inputs = {"fresh": jct}
    want = {}
    for name in OPS:  # dict order: relinearize before rescale_to_next
        src = inputs[INPUT.get(name, "fresh")]
        want[name] = jax.jit(lambda a, f=OPS[name]: f(jev, a))(src)
        inputs[name] = want[name]
    return tc, tk, inputs, want


def to_port(jct):
    return convert.ciphertext_from_numpy(np.asarray(jct.data), jct.level, jct.scale)


def run(built, mesh_kind, lazy, monkeypatch):
    """Every op on the placed batch, held to the JAX result, its
    collectives and its transforms."""
    tc, tk, inputs, want = built
    if not lazy:
        monkeypatch.setattr(teval, "_lazy_ok", lambda ctx: False)
    n_dev, batch_axes = MESHES[mesh_kind]
    mesh = tmesh.make_mesh(n_dev, devices=tdevice.mesh_devices("cpu", n_dev))
    assert mesh.shape["limb"] == 2
    ev = TEvaluator(tc, tk)
    assert ev._lazy() is lazy
    check_ntt_views(monkeypatch)
    for name, op in OPS.items():
        src = to_port(inputs[INPUT.get(name, "fresh")])
        placed = tmesh.shard_ct(src, mesh, n_batch_axes=1, batch_axes=batch_axes,
                                limb_axis="limb")
        assert placed.data.spec == (batch_axes[0], None, "limb", None)
        out = {}
        tntt.call_log = {}
        try:
            stats = sp_eval.collective_stats(lambda: out.setdefault("ct", op(ev, placed)))
            log, tntt.call_log = tntt.call_log, None
        finally:
            tntt.call_log = None
        got = out["ct"]
        assert got.data.spec == placed.data.spec, name
        assert_same_ct(replace(got, data=got.data.gather()), want[name])
        expected = dict.fromkeys(tmesh.COLLECTIVES, 0)
        expected.update(COLLECTIVES[name], a2a_bytes=0)
        assert stats == expected, (name, stats)
        if name in ("relinearize", "rotate", "rotate_sum", "accumulate_chain"):
            # each block's transforms at its own first limb: limbs 3.. of 6
            for kernel in ("ntt_fwd", "ntt_inv"):
                assert any(k[1] == kernel and k[5] == 3 for k in log), (name, kernel)
