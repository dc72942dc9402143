"""Limb-sharded ciphertexts: key switching, rotations, rescale, mod switch
and the BFV multiply with the limb axis of the data split over a mesh.

Counterpart of the JAX package's plain ``Evaluator`` running under GSPMD on
data placed by ``parallel/mesh.py:shard_ct(..., limb_axis="limb")``.  There
the partitioner inserts collectives where an op reads across limb blocks;
here ``evaluator/eval.py`` hands such ops on placed data
(``ShardedTensor``) to the functions below, which run the flat evaluator's
own steps once per block, on the block's limb window, and move data
between blocks only through the counted collectives of ``parallel/mesh.py``.

Layout.  Data ``[..., l, N]`` is split on its limb dim over the mesh axis
the spec names there (or whole, when none does: a dp-only placement is the
case of one block per group), in equal consecutive blocks: block ``i`` of
``k`` holds limbs ``[i*l/k, (i+1)*l/k)`` of the live stack, and every
per-limb constant is cut to the same window (``mesh._local_part``).  The
coefficient axis must be whole in every block: a transform over a dim that
is not raises.  Each block's transforms are K1 / K2 on the card at the
block's first limb (:func:`fwd`, :func:`inv`, and the flat evaluator's own
calls with a row window), noted in ``ops/ntt.py:call_log`` as every call is.

Key switching (``key_switch``, and ``rotate_sum``'s shared one).  Each
block transforms its own rows of ``d`` to coefficients (K2), lifts them
onto every target limb (its share of the digits; a digit group of G limbs
that straddles two blocks is lifted in part by each, the parts summing to
the group's digit), forward-transforms the lift (K1) and takes the inner
product with its digits of the switch key, summed over them: a partial
accumulator ``[..., l + ns, N]``.  One modular all-reduce sums the
partials; each block then runs the mod-down for its own rows (the special
rows' inverse transform in every block, its rows' forward one at its
offset).  The all-reduce gives a representative of the flat sum, not
always the same one in the lazy range ``[0, 2p)``; every consumer of the
accumulator (the mod-down's inverse transform and Shoup products) reduces
fully, so the result equals the flat path's bit for bit.  ``rotate_sum``
sums over its rotations before its one mod-down, so it pays one all-reduce,
not one a step.

Rescale and mod switch.  The dropped limb's row is inverse-transformed in
the block that holds it (K2 at the limb), handed to the group in one
all-gather, and every block scales its own rows (K1 at its offset).  After
the last drop of a rescale group, and after a mod switch, the blocks are
settled (:func:`_settle`): where the new level splits into equal blocks,
one collective-permute evens them out (``mesh.rebalance``); where it does
not, one all-gather hands every block of the group the whole stack, and
the result is replicated over the limb axis (``spec[-2]`` None, the batch
axes kept), as GSPMD returns it.  Later ops then run on whole polynomials
block by block, as on a dp-only placement, with no collective over the
limb axis.  Uneven blocks are not kept: the ``ShardedTensor`` local map,
its constant cutting (``mesh._local_part``) and ``gather`` all assume
equal consecutive blocks, and an odd level would make every later op pay
for the unevenness; replicating costs one all-gather of at most the
level's rows, once.

The BFV BEHZ multiply (:func:`bfv_multiply`).  Each block runs
``evaluator/behz.py``'s steps on its q window: its rows to coefficients
(K2 at its first limb), its share of the q -> Bsk conversion, and, after
one all-reduce has summed the shares, all of Bsk, which every block then
holds (as every block holds the special rows after a key switch's
all-reduce).  The tensor product runs over the window and Bsk on one
plan of those primes (one K1 and one K2 launch, ``behz.window``); the
floor's q -> Bsk conversion is summed by a second all-reduce; the exact
Shenoy-Kumaresan conversion back to q reads only Bsk, so each block
produces its own q rows and returns them to NTT form (K1 at its first
limb).  Two all-reduces, no all-gather: no block ever holds another
block's q rows.  A block of whole polynomials (a dp-only placement, or
data replicated over the limb axis) runs the flat multiply.

The switch keys and the context's tables are whole on every device of the
mesh: a block on another device than the context's runs an evaluator of
the same parameters there (:func:`on_device`: the keys copied once per
device, not per use; the BEHZ tables are those of the context there).
The flat evaluator's ops that run block by block through the local map
(add, the CKKS multiply, the plaintext ops) need nothing here.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.evaluator import behz
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.parallel.mesh import ShardedTensor
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext
from reference_seal_backend_tpu_torch.schemes.params import context_on


def layout(x: ShardedTensor) -> Tuple[Optional[str], int]:
    """``(limb axis, rows per block)`` of data ``[..., l, N]`` on a mesh;
    raises ``NotImplementedError`` where the coefficient axis is split."""
    if x.spec[-1] is not None:
        raise NotImplementedError(
            f"a limb-wise op over data placed as {x.spec}: the coefficient "
            f"axis is split (the sp layout: parallel/sp_eval.py)")
    axis = x.spec[-2]
    return axis, x.shape[-2] // (x.mesh.shape[axis] if axis else 1)


def _first_limb(x: ShardedTensor, axis: Optional[str], rows: int, c) -> int:
    return mesh_mod._axis_index(x.mesh, axis, c) * rows


def plan_on(plan: "ntt_mod.NttPlan", dev: torch.device) -> "ntt_mod.NttPlan":
    """``plan``'s transform with its tables on ``dev`` (cached)."""
    return plan if dev == plan.device else ntt_mod.make_plan(plan.n, plan.primes, dev)


def fwd(plan, x: ShardedTensor, lo: int = 0, epilogue: bool = True) -> ShardedTensor:
    """Forward NTT of limb-sharded ``x`` holding limbs ``[lo, lo + l)``:
    ``plan.fwd`` once per block at the block's first limb (K1 on the
    card)."""
    axis, rows = layout(x)
    return x.map_blocks(lambda b, c: plan_on(plan, b.device).fwd(
        b, lo=lo + _first_limb(x, axis, rows, c), epilogue=epilogue))


def inv(plan, x: ShardedTensor, lo: int = 0) -> ShardedTensor:
    """Inverse NTT of limb-sharded ``x``, per block (K2 on the card)."""
    axis, rows = layout(x)
    return x.map_blocks(lambda b, c: plan_on(plan, b.device).inv(
        b, lo=lo + _first_limb(x, axis, rows, c)))


def on_device(ev, dev: torch.device):
    """``ev``'s counterpart on ``dev``: ``ev`` where its context lives,
    else an evaluator of the same parameters with the keys copied there
    (once per device)."""
    if dev == ev.ctx.device:
        return ev
    if dev not in ev.device_evs:
        ev.device_evs[dev] = type(ev)(
            context_on(ev.ctx, dev), mesh_mod.to_device(ev.keys, dev))
    return ev.device_evs[dev]


def _key_on(ev, evc, key):
    """The switch key ``key`` of ``ev.keys`` as ``evc`` holds it."""
    if evc is ev:
        return key
    if key is ev.keys.relin:
        return evc.keys.relin
    for g, k in ev.keys.galois.items():
        if k is key:
            return evc.keys.galois[g]
    return mesh_mod.to_device(key, evc.ctx.device)


def _new_blocks(x: ShardedTensor) -> np.ndarray:
    return np.empty(x.mesh.devices.shape, dtype=object)


def _sum_partials(ev, parts: np.ndarray, x: ShardedTensor, axis, l: int):
    """The one all-reduce of key switching: the blocks' partial
    accumulators over live ∪ special rows, summed mod each row's prime."""
    p_t, _, _ = ev._switch_targets(l)
    return mesh_mod.all_reduce_mod(parts, x.mesh, axis, p_t, ev._lazy())


def key_switch(ev, d: ShardedTensor, key, level: int):
    """``Evaluator.key_switch`` of limb-sharded ``d`` ``[..., l, N]``:
    (kb, ka), placed as ``d``.  One all-reduce."""
    axis, rows = layout(d)
    coeff = inv(ev.ctx.plan, d)
    parts = _new_blocks(d)
    for c in mesh_mod._coords(d.mesh):
        blk = coeff.blocks[c]
        evc, lo = on_device(ev, blk.device), _first_limb(d, axis, rows, c)
        dig = evc._lift_digits(blk, level, lo)
        acc_b, acc_a = evc._switch_inner(
            dig, _key_on(ev, evc, key), level, evc._digit_range(lo, rows))
        parts[c] = torch.stack([acc_b, acc_a], dim=-3)
    full = _sum_partials(ev, parts, d, axis, level)
    kb, ka = _new_blocks(d), _new_blocks(d)
    for c in mesh_mod._coords(d.mesh):
        evc, lo = on_device(ev, full[c].device), _first_limb(d, axis, rows, c)
        kb[c] = evc._mod_down_special(full[c][..., 0, :, :], level, lo, rows)
        ka[c] = evc._mod_down_special(full[c][..., 1, :, :], level, lo, rows)
    return ShardedTensor(kb, d.mesh, d.spec), ShardedTensor(ka, d.mesh, d.spec)


def rotate_sum(ev, data: ShardedTensor, level: int, nonzero: Sequence[int],
               n_id: int) -> ShardedTensor:
    """``Evaluator.rotate_sum`` of limb-sharded ciphertext data
    ``[..., 2, l, N]`` over the non-zero steps ``nonzero`` and ``n_id``
    identity steps: each block's share of the hoisted digits, one
    all-reduce of the summed accumulators, each block's mod-down."""
    axis, rows = layout(data)
    coeff = inv(ev.ctx.plan, data[..., 1, :, :])
    parts, c0s = _new_blocks(data), _new_blocks(data)
    for c in mesh_mod._coords(data.mesh):
        blk = data.blocks[c]
        evc, lo = on_device(ev, blk.device), _first_limb(data, axis, rows, c)
        dig = evc._lift_digits(coeff.blocks[c], level, lo)
        parts[c], c0s[c] = evc._rotate_sum_partial(
            blk[..., 0, :, :], dig, level, nonzero, lo)
    full = _sum_partials(ev, parts, data, axis, level)
    out = _new_blocks(data)
    for c in mesh_mod._coords(data.mesh):
        blk = data.blocks[c]
        evc, lo = on_device(ev, blk.device), _first_limb(data, axis, rows, c)
        out[c] = evc._rotate_sum_finish(full[c], c0s[c], blk, level, n_id, lo)
    return ShardedTensor(out, data.mesh, data.spec)


def rescale(ev, data: ShardedTensor, level: int, group: int) -> ShardedTensor:
    """Divide-and-round limb-sharded data ``[..., l, N]`` by its top
    ``group`` limbs (``Evaluator.rescale_to_next``): per dropped limb one
    all-gather of its coefficient row, then one collective-permute that
    evens the blocks out."""
    axis, rows = layout(data)
    mesh = data.mesh
    coords = mesh_mod._coords(mesh)
    blocks = data.blocks.copy()
    first = {c: _first_limb(data, axis, rows, c) for c in coords}
    for drop in range(level - 1, level - 1 - group, -1):
        pieces = _new_blocks(data)
        for c in coords:
            blk, lo = blocks[c], first[c]
            if lo <= drop < lo + blk.shape[-2]:
                pieces[c] = on_device(ev, blk.device)._dropped_row(
                    blk[..., drop - lo : drop - lo + 1, :], drop)
            else:
                pieces[c] = blk[..., :0, :]
        v = mesh_mod.all_gather_dim(pieces, mesh, axis, dim=-2)
        for c in coords:
            blk, lo = blocks[c], first[c]
            keep = blk[..., : max(0, min(blk.shape[-2], drop - lo)), :]
            blocks[c] = on_device(ev, blk.device)._scale_by_dropped(
                keep, v[c], drop, lo) if keep.shape[-2] else keep
    return _settle(blocks, data, axis)


def drop_to(data: ShardedTensor, level: int) -> ShardedTensor:
    """The first ``level`` limbs of limb-sharded ``data`` ``[..., l, N]``,
    settled (:func:`_settle`)."""
    axis, rows = layout(data)
    blocks = _new_blocks(data)
    for c in mesh_mod._coords(data.mesh):
        lo = _first_limb(data, axis, rows, c)
        blocks[c] = data.blocks[c][..., : max(0, min(rows, level - lo)), :]
    return _settle(blocks, data, axis)


def _settle(blocks: np.ndarray, x: ShardedTensor, axis) -> ShardedTensor:
    """Blocks of ``x``'s layout that lost rows from the top, as a
    ``ShardedTensor``: evened out over ``axis`` where their total splits
    into equal blocks (one collective-permute where rows move), else
    replicated over it (one all-gather; the limb dim unsharded)."""
    mesh = x.mesh
    total = sum(blocks[c].shape[-2] for c in mesh_mod._groups(mesh, axis)[0])
    if total % (mesh.shape[axis] if axis else 1) == 0:
        return ShardedTensor(mesh_mod.rebalance(blocks, mesh, axis, dim=-2), mesh, x.spec)
    return ShardedTensor(mesh_mod.all_gather_dim(blocks, mesh, axis, dim=-2), mesh,
                         x.spec[:-2] + (None, x.spec[-1]))


def bfv_multiply(ev, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """``Evaluator.multiply`` of BFV ciphertexts placed alike on a mesh
    (``behz.bfv_multiply`` per limb block): the 3-component result, placed
    as the operands.  Two all-reduces over the limb axis (the input's and
    the floor's q -> Bsk sums, the m_tilde sum stacked into the first as a
    row of modulus 2**16); none where the blocks hold whole polynomials."""
    x, y = a.data, b.data
    if not (isinstance(x, ShardedTensor) and isinstance(y, ShardedTensor)
            and x.mesh is y.mesh and x.spec == y.spec):
        raise NotImplementedError(
            "the BFV multiply of ciphertexts placed differently (or one not "
            "placed): place both alike with mesh.shard_ct")
    torch.broadcast_shapes(x.shape, y.shape)  # each block broadcasts its own
    axis, rows = layout(x)
    mesh, coords = x.mesh, mesh_mod._coords(x.mesh)
    k = ev.ctx.L
    out = _new_blocks(x)
    if rows == k:  # whole polynomials in every block
        for c in coords:
            evc = on_device(ev, x.blocks[c].device)
            out[c] = behz.bfv_multiply(
                evc.ctx, replace(a, data=x.blocks[c]), replace(b, data=y.blocks[c])).data
        return Ciphertext(ShardedTensor(out, mesh, x.spec), level=k, scale=1.0, is_ntt=True)

    def tables(c):
        evc = on_device(ev, x.blocks[c].device)
        return evc.ctx, behz.tables_for(evc.ctx), _first_limb(x, axis, rows, c)

    # the operands' q rows to coefficients, their share of q -> Bsk
    ab_q, parts = _new_blocks(x), _new_blocks(x)
    for c in coords:
        ctx, tb, lo = tables(c)
        ab_q[c] = behz.to_coeff(ctx, tb, behz.operands(x.blocks[c], y.blocks[c]), lo)
        xs, xt = behz._conv_partial(tb, ab_q[c], lo)
        parts[c] = modops.narrow(torch.cat([xs, xt[..., None, :]], dim=-2))
    tb0 = behz.tables_for(ev.ctx)
    kb = len(ev.ctx.bsk_primes)
    # lazy sums, as the flat multiply's trees (every BEHZ prime < 2**30)
    conv = mesh_mod.all_reduce_mod(parts, mesh, axis, behz.conv_moduli(tb0), True)
    # all of Bsk in every block: the tensor product over the window and Bsk
    prod_bsk = _new_blocks(x)
    for c in coords:
        ctx, tb, lo = tables(c)
        s = modops.wide(conv[c])
        ab_bsk = behz._conv_finish(tb, s[..., :kb, :], s[..., kb, :])
        prod = modops.wide(behz.tensor_product(tb, ab_q[c], ab_bsk, lo))
        prod_q, prod_bsk[c] = prod[..., :rows, :], prod[..., rows:, :]
        parts[c] = modops.narrow(behz._fbc_partial(tb, prod_q, tb.t_qhinv, lo))
    fbc = mesh_mod.all_reduce_mod(parts, mesh, axis, tb0.bsk_p, True)
    # the floor in Bsk, then each block's own q rows back to NTT form
    for c in coords:
        ctx, tb, lo = tables(c)
        y_bsk = behz.floor_bsk(tb, prod_bsk[c], behz._canon(modops.wide(fbc[c]), tb.bsk_p))
        out[c] = behz.to_ntt(ctx, tb, behz._sk_to_q(tb, y_bsk, lo, rows), lo)
    return Ciphertext(ShardedTensor(out, mesh, x.spec), level=k, scale=1.0, is_ntt=True)
