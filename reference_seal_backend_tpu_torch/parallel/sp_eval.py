"""Slot-parallel (sp) execution path: evaluator ops with the coefficient
axis sharded across the mesh.

Counterpart of ``reference_seal_backend_tpu/parallel/sp_eval.py``: the
distributed four-step NTT (``parallel/sharded_ntt.py``) threaded through the
evaluator's hot paths — dyadic multiply, the BEHZ multiply, key switching
(digit lift, inner product, mod-down), rotations and rescale — so a whole
workload runs with every polynomial's coefficient axis sharded over the
``sp`` axis of a mesh.

Layout.  An :class:`SpCiphertext` holds NTT-domain data in the transposed
matrix layout ``[..., size, L, n2, n1]``, the last axis (``n1 = N/128``)
sharded over ``sp``: a ``ShardedTensor`` (``parallel/mesh.py``), which the
workloads' ``operate`` code indexes, stacks and reshapes unchanged.  That is
the layout ``sharded_ntt.fwd`` produces and ``inv`` consumes, so the
transforms between evaluator ops pay one all-to-all each and nothing else.
Pointwise ops run block by block.  The ops that read across shards are
explicit and counted: the Galois permutation and ``rotate_sum``'s two
gathers into and out of the power-of-5 orbit order
(``mesh.gather_index``: an all-gather, a local ``index_select``, a split),
and its per-rotation roll within an orbit (``mesh.roll_segments``: a
collective-permute).  Conversion to and from the flat ``[..., size, L, N]``
layout is a reshape and a transpose (:func:`to_sp_layout`,
:func:`from_sp_layout`).

Every op gives the single-device ``Evaluator``'s integers bit for bit: the
arithmetic is the reference's, op for op and in the same order, and the
sharded transform runs the flat loop's butterflies stage for stage.  As
there, each chain computes in the working format of ``ops/modops.py`` and
narrows where it stores (an ``SpCiphertext``); the sharded transforms take
either format.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.evaluator import behz
from reference_seal_backend_tpu_torch.evaluator.eval import Evaluator
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.parallel import mesh as mesh_mod
from reference_seal_backend_tpu_torch.parallel import sharded_ntt
from reference_seal_backend_tpu_torch.parallel.mesh import Mesh, ShardedTensor
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.schemes.keys import KeySet, SwitchKey
from reference_seal_backend_tpu_torch.schemes.params import Context


@dataclass(frozen=True)
class SpCiphertext:
    """Ciphertext in sp layout: ``data[..., size, L, n2, n1]``, NTT-domain
    Montgomery, the last axis sharded over the sp mesh axis."""

    data: ShardedTensor
    level: int = 0
    scale: float = 1.0

    def __post_init__(self):
        modops.check_store(self.data)

    @property
    def size(self) -> int:
        return self.data.shape[-4]


def to_sp_layout(x: torch.Tensor, n1: int, n2: int) -> torch.Tensor:
    """flat ``[..., N]`` -> transposed matrix layout ``[..., n2, n1]``."""
    return x.reshape(*x.shape[:-1], n1, n2).transpose(-1, -2)


def from_sp_layout(t: torch.Tensor) -> torch.Tensor:
    """transposed layout ``[..., n2, n1]`` -> flat ``[..., N]``."""
    n2, n1 = t.shape[-2], t.shape[-1]
    return t.transpose(-1, -2).reshape(*t.shape[:-2], n1 * n2)


def _c3(arr: torch.Tensor) -> torch.Tensor:
    """``[L, 1]`` per-limb constants -> ``[L, 1, 1]`` for the two trailing
    (n2, n1) space axes of the sp layout."""
    return arr[..., None]


def _tables_on(tb: "behz.BehzTables", dev: torch.device) -> "behz.BehzTables":
    """A copy of the BEHZ tables with every tensor on ``dev``."""
    t = copy.copy(tb)
    for name, v in vars(tb).items():
        if isinstance(v, torch.Tensor):
            setattr(t, name, v.to(dev))
        elif isinstance(v, tuple) and all(isinstance(e, torch.Tensor) for e in v):
            setattr(t, name, tuple(e.to(dev) for e in v))
    return t


def _space_flat(fn):
    """``fn`` on a block with its two trailing space axes flattened to one
    (the flat evaluator's ``[..., N]`` form: the BEHZ steps are pointwise in
    space), the result's last axis put back into the block's two."""
    def block(b, c):
        out = fn(modops.wide(b).flatten(-2), b.device)
        return modops.narrow(out).reshape(*out.shape[:-1], *b.shape[-2:])
    return block


class SpEvaluator:
    """Evaluator ops over sp-sharded ciphertexts.

    Covers the ops the workloads' ``operate`` graphs call: add, sub,
    negate, the plaintext ops, multiply (CKKS Karatsuba, BFV BEHZ),
    relinearize, rotate / conjugate, hoisted ``rotate_sum`` and rescale —
    each the arithmetic of ``evaluator/eval.py`` with every NTT sweep a
    sharded transform.  An op it lacks raises ``AttributeError``, as the
    reference's does: nothing falls back to the flat path.
    """

    def __init__(
        self, ctx: Context, keys: Optional[KeySet], mesh: Mesh,
        axis: str = "sp", batch_axes: Tuple[str, ...] = (),
    ):
        """``batch_axes`` names mesh axes carrying the ciphertexts' leading
        batch dims: a dp×sp mesh shards an Offline batch on ``dp`` while
        every polynomial's coefficient axis shards on ``sp``."""
        self.ctx = ctx
        self.keys = keys
        self.mesh = mesh
        self.axis = axis
        self.batch_axes = tuple(batch_axes)
        self.n1 = ctx.plan.n1
        self.n2 = ctx.plan.n2
        if not self.n2:
            raise ValueError("sp sharding needs the four-step layout (N >= 256)")
        k = mesh.shape[axis]
        if self.n1 % k or self.n2 % k:
            raise ValueError(
                f"the sp mesh axis ({k} devices) must divide n1 = {self.n1} "
                f"and n2 = {self.n2}")
        self._key_cache: Dict = {}
        self._perm_cache: Dict = {}
        self._behz_cache: Dict[torch.device, "behz.BehzTables"] = {}
        # what the composite ops keep per evaluator (evaluator/eval.py)
        self.plain_cache: dict = {}
        self._flat = Evaluator(ctx, keys)  # hoisted-key relayout; the lazy rule

    # -- placement ---------------------------------------------------------

    def shard(self, ct: Ciphertext) -> SpCiphertext:
        """Flat ciphertext -> sp layout, placed on the mesh (the ``load``
        step of the sharded pipeline)."""
        t = to_sp_layout(ct.data, self.n1, self.n2)
        nb = len(self.batch_axes)
        spec = (*self.batch_axes, *([None] * (t.dim() - 1 - nb)), self.axis)
        return SpCiphertext(
            data=ShardedTensor.distribute(t, self.mesh, spec),
            level=ct.level, scale=ct.scale,
        )

    def unshard(self, ct: SpCiphertext) -> Ciphertext:
        return Ciphertext(
            data=from_sp_layout(ct.data.gather()),
            level=ct.level, scale=ct.scale, is_ntt=True,
        )

    def shard_pt(self, pt: Plaintext) -> Plaintext:
        """Plaintext ``[..., L, N]`` -> sp layout ``[..., L, n2, n1]`` on the
        mesh."""
        t = to_sp_layout(pt.data, self.n1, self.n2)
        spec = (None,) * (t.dim() - 1) + (self.axis,)
        return replace(pt, data=ShardedTensor.distribute(t, self.mesh, spec))

    # -- dyadic ops ----------------------------------------------------------

    def add(self, a: SpCiphertext, b: SpCiphertext) -> SpCiphertext:
        p = _c3(self.ctx.p[: a.level])
        return replace(a, data=modops.narrow(modops.mod_add(a.data, b.data, p)))

    def _pt_sp(self, pt: Plaintext):
        """Plaintext data in sp layout: the flat single-device form
        ``[..., l, N]`` relayouted (a view; each block reads its columns),
        or an already-sharded one.  Flat acceptance lets the composite ops
        (collapse's mask, Horner's coefficients) use this evaluator
        unchanged."""
        d = pt.data
        if not isinstance(d, ShardedTensor) and d.shape[-1] == self.n1 * self.n2:
            return to_sp_layout(d, self.n1, self.n2)
        return d

    def add_plain(self, a: SpCiphertext, pt: Plaintext) -> SpCiphertext:
        """``evaluator/eval.py`` add_plain in sp layout (a BFV plaintext
        times Δ, as in the single-device path)."""
        if pt.level != a.level:
            raise ValueError("plaintext level mismatch")
        p = _c3(self.ctx.p[: a.level])
        pt_data = self._pt_sp(pt)
        if self.ctx.scheme == "bfv":
            pt_data = modops.shoup_mul(
                pt_data,
                _c3(self.ctx.delta_plain[: a.level]),
                _c3(self.ctx.delta_shoup[: a.level]),
                p,
            )
        c0 = modops.narrow(modops.mod_add(a.data[..., 0, :, :, :], pt_data, p))
        data = torch.cat([c0[..., None, :, :, :], a.data[..., 1:, :, :, :]], dim=-4)
        return replace(a, data=data)

    def multiply_plain(self, a: SpCiphertext, pt: Plaintext) -> SpCiphertext:
        if pt.level != a.level:
            raise ValueError("plaintext level mismatch")
        l = a.level
        p = _c3(self.ctx.p[:l])
        pni = _c3(self.ctx.p_neg_inv[:l])
        data = modops.narrow(modops.mont_mul(a.data, self._pt_sp(pt), p, pni))
        return replace(a, data=data, scale=a.scale * pt.scale)

    def sub(self, a: SpCiphertext, b: SpCiphertext) -> SpCiphertext:
        p = _c3(self.ctx.p[: a.level])
        return replace(a, data=modops.narrow(modops.mod_sub(a.data, b.data, p)))

    def negate(self, a: SpCiphertext) -> SpCiphertext:
        p = _c3(self.ctx.p[: a.level])
        return replace(a, data=modops.narrow(modops.mod_neg(a.data, p)))

    # -- level / scale -----------------------------------------------------

    def mod_switch_to(self, a: SpCiphertext, level: int) -> SpCiphertext:
        if level > a.level:
            raise ValueError("cannot mod-switch up")
        if level < 1:
            raise ValueError("cannot drop below one live prime")
        return replace(a, data=a.data[..., :level, :, :], level=level)

    def mod_switch_plain_to(self, pt: Plaintext, level: int) -> Plaintext:
        if level > pt.level:
            raise ValueError("cannot mod-switch plaintext up")
        if not isinstance(pt.data, ShardedTensor) and pt.data.shape[-1] == self.n1 * self.n2:
            return replace(pt, data=pt.data[..., :level, :], level=level)
        return replace(pt, data=pt.data[..., :level, :, :], level=level)

    def multiply(self, a: SpCiphertext, b: SpCiphertext) -> SpCiphertext:
        """Karatsuba ct-ct multiply, op for op ``Evaluator.multiply``; BFV
        takes the sharded BEHZ pipeline (:meth:`_bfv_multiply`)."""
        if self.ctx.scheme == "bfv":
            return self._bfv_multiply(a, b)
        l = a.level
        p = _c3(self.ctx.p[:l])
        pni = _c3(self.ctx.p_neg_inv[:l])
        ad, bd = modops.wide(a.data), modops.wide(b.data)
        a0, a1 = ad[..., 0, :, :, :], ad[..., 1, :, :, :]
        b0, b1 = bd[..., 0, :, :, :], bd[..., 1, :, :, :]
        c0 = modops.mont_mul(a0, b0, p, pni)
        c2 = modops.mont_mul(a1, b1, p, pni)
        z = modops.mont_mul(
            modops.mod_add(a0, a1, p), modops.mod_add(b0, b1, p), p, pni
        )
        cross = modops.mod_sub(modops.mod_sub(z, c0, p), c2, p)
        data = modops.narrow(torch.stack([c0, cross, c2], dim=-4))
        return replace(a, data=data, scale=a.scale * b.scale)

    def _behz_on(self, dev: torch.device) -> "behz.BehzTables":
        tb = behz.tables_for(self.ctx)
        if dev == tb.q_p.device:
            return tb
        if dev not in self._behz_cache:
            self._behz_cache[dev] = _tables_on(tb, dev)
        return self._behz_cache[dev]

    def _bfv_multiply(self, a: SpCiphertext, b: SpCiphertext) -> SpCiphertext:
        """BEHZ BFV ct-ct multiply with every NTT sweep sharded — op for op
        ``evaluator/behz.py:bfv_multiply``: the operands' inverse
        transforms stacked, the tensor product's forward and inverse over
        the stacked q ∪ Bsk plan (``tables.mult_plan``), the output's
        forward: four sweeps, one all-to-all each.  Between them every step
        is pointwise in space, so each block runs the flat module's own
        steps on its columns (:func:`_space_flat`)."""
        ctx, mesh, ax, ba = self.ctx, self.mesh, self.axis, self.batch_axes
        tb = behz.tables_for(ctx)
        k = ctx.L
        if a.size != 2 or b.size != 2:
            raise NotImplementedError("bfv multiply expects size-2 inputs")
        shape = torch.broadcast_shapes(a.data.shape, b.data.shape)
        nlead = len(shape) - 4  # leading batch dims (dp×sp composes)
        ab = torch.stack([a.data.expand(shape), b.data.expand(shape)], dim=nlead)
        ab_mat = sharded_ntt.inv(ctx.plan, ab, mesh, ax, lo=0, batch_axes=ba)

        def to_q_bsk(x, dev):  # [.., 2ab, 2, k, S] -> [.., 2ab, 2, k+kb, S]
            t = self._behz_on(dev)
            ab_q = modops.mont_mul(x, 1, t.q_p, t.q_pni)
            x_all = torch.cat([ab_q, behz._conv_to_bsk_mtilde(t, ab_q)], dim=-2)
            # operand a enters Montgomery form (xR); b stays normal
            return torch.cat([
                modops.shoup_mul(x_all.narrow(nlead, 0, 1), *t.all_r1, t.all_p),
                x_all.narrow(nlead, 1, 1),
            ], dim=nlead)

        ntt_all = sharded_ntt.fwd(
            tb.mult_plan, ab_mat.map_blocks(_space_flat(to_q_bsk)), mesh, ax,
            lo=0, batch_axes=ba,
        )  # [..., 2ab, 2, k+kb, n2, n1]

        def tensor(y, dev):
            t = self._behz_on(dev)
            return behz._tensor(y.select(nlead, 0), y.select(nlead, 1),
                                t.all_p, t.all_pni)

        prod_t = ntt_all.map_blocks(
            _space_flat(tensor), ntt_all.spec[:nlead] + ntt_all.spec[nlead + 1 :])
        prod = sharded_ntt.inv(
            tb.mult_plan, prod_t, mesh, ax, lo=0, batch_axes=ba
        )  # [..., 3, k+kb, n1, n2] normal coefficients

        def scale_down(x, dev):  # ×t, floor-divide by q, Bsk -> q, enter Mont
            t = self._behz_on(dev)
            prod_q, prod_bsk = x[..., :k, :], x[..., k:, :]
            y_bsk = behz.floor_bsk(t, prod_bsk, behz._fbc_q_to_bsk(t, prod_q, t.t_qhinv))
            return modops.shoup_mul(behz._sk_to_q(t, y_bsk), *t.q_r1, t.q_p)

        out_ntt = sharded_ntt.fwd(
            ctx.plan, prod.map_blocks(_space_flat(scale_down)), mesh, ax,
            lo=0, batch_axes=ba,
        )
        return SpCiphertext(data=out_ntt, level=k, scale=1.0)

    # -- key switching ---------------------------------------------------------

    def _targets3(self, l: int):
        ctx = self.ctx
        cat = lambda arr: torch.cat([arr[:l], arr[ctx.sp_row :]], dim=0)
        return _c3(cat(ctx.p)), _c3(cat(ctx.mu))

    def _digits(self, d: ShardedTensor, l: int) -> ShardedTensor:
        """Key-switch digit decomposition, cross-limb lift and per-target
        forward NTT, every transform sharded, grouped digits included (op
        for op ``Evaluator._hoisted_digits``).  ``d`` ``[..., l, n2, n1]``
        NTT Montgomery -> ``[..., n_dig, l+ns, n2, n1]`` normal form."""
        ctx, mesh, ax, ba = self.ctx, self.mesh, self.axis, self.batch_axes
        plan = ctx.plan
        G = ctx.digit_group
        lazy = self._flat._lazy()
        d_mat = sharded_ntt.inv(plan, d, mesh, ax, lo=0, batch_axes=ba)
        p_t, mu_t = self._targets3(l)
        if G == 1:
            d_norm = modops.from_mont(d_mat, _c3(ctx.p[:l]), _c3(ctx.p_neg_inv[:l]))
            # lazy: the lift stays in [0, 2p) (the Harvey NTT takes it; the
            # inner products are exact for any uint32 representative)
            barrett = (
                modops.barrett_reduce_u32_lazy if lazy else modops.barrett_reduce_u32
            )
            lifted = barrett(d_norm[..., :, None, :, :], p_t, mu_t)
        else:
            ihat, W, Ws = ctx.digit_tables(l)
            v = modops.mont_mul(
                d_mat, _c3(ihat), _c3(ctx.p[:l]), _c3(ctx.p_neg_inv[:l])
            )  # [..., l, n1, n2] normal: d_k·(Q_g/q_k)^-1
            if lazy:
                contrib = modops.shoup_mul_lazy(
                    modops.barrett_reduce_u32_lazy(v[..., :, None, :, :], p_t, mu_t),
                    _c3(W), _c3(Ws), p_t,
                )  # [..., l, l+ns, n1, n2] in [0, 2p)
            else:
                contrib = modops.shoup_mul(
                    modops.barrett_reduce_u32(v[..., :, None, :, :], p_t, mu_t),
                    _c3(W), _c3(Ws), p_t,
                )
            nd = ctx.dig_count(l)
            pad = nd * G - l
            if pad:
                contrib = torch.cat(
                    [contrib, torch.zeros_like(contrib[..., :pad, :, :, :])], dim=-4)
            grp = contrib.reshape(*contrib.shape[:-4], nd, G, *contrib.shape[-3:])
            lifted = grp[..., 0, :, :, :]
            p2_t = modops.add_raw(p_t, p_t)
            for gi in range(1, G):
                if lazy:
                    lifted = modops.reduce_2p(
                        modops.add_raw(lifted, grp[..., gi, :, :, :]), p2_t)
                else:
                    lifted = modops.mod_add(lifted, grp[..., gi, :, :, :], p_t)
        # lazy: no canonical epilogue, the inner product's Shoup multiply is
        # exact for digits in [0, 4p)
        data_part = sharded_ntt.fwd(
            plan, lifted[..., :l, :, :], mesh, ax, lo=0, batch_axes=ba,
            epilogue=not lazy,
        )
        sp_part = sharded_ntt.fwd(
            plan, lifted[..., l:, :, :], mesh, ax, lo=ctx.sp_row,
            batch_axes=ba, epilogue=not lazy,
        )
        return torch.cat([data_part, sp_part], dim=-3)

    def _mod_down(self, x: ShardedTensor, l: int) -> ShardedTensor:
        """``[..., l+ns, n2, n1]`` NTT Mont -> ``[..., l, n2, n1]`` Montgomery
        form of round(x / P), op for op ``Evaluator._mod_down_special`` (the
        exact centred peel at ns = 1, the single fast base conversion at
        ns > 1), transforms sharded.  ``x`` may be lazy in ``[0, 2p)``."""
        ctx, mesh, ax, ba = self.ctx, self.mesh, self.axis, self.batch_axes
        epi = not self._flat._lazy()
        sp = ctx.sp_row
        ns = ctx.n_special
        plan = ctx.plan
        p = _c3(ctx.p[:l])
        if ns == 1:
            v_mat = sharded_ntt.inv(plan, x[..., l:, :, :], mesh, ax, lo=sp, batch_axes=ba)
            v = modops.from_mont(
                v_mat, _c3(ctx.p[sp : sp + 1]), _c3(ctx.p_neg_inv[sp : sp + 1])
            )  # [..., 1, n1, n2] in [0, P)
            flag = modops.ugt(v, ctx.div_half[sp])
            w = modops.mod_sub(
                modops.barrett_reduce_u32(v, p, _c3(ctx.mu[:l])),
                flag * ctx.div_mod[sp, :l][:, None, None],
                p,
            )
            # w_ntt only feeds the fully reducing Shoup product below
            w_ntt = sharded_ntt.fwd(plan, w, mesh, ax, lo=0, batch_axes=ba, epilogue=epi)
            sel = lambda t: t[sp, :l][:, None, None]
            return modops.mod_sub(
                modops.shoup_mul(x[..., :l, :, :], sel(ctx.div_inv), sel(ctx.div_inv_shoup), p),
                modops.shoup_mul(w_ntt, sel(ctx.div_inv_mont), sel(ctx.div_inv_mont_shoup), p),
                p,
            )
        ihat, W, Ws, invP, invPs, invPm, invPms = ctx.moddown_tables(l)
        v_mat = sharded_ntt.inv(plan, x[..., l:, :, :], mesh, ax, lo=sp, batch_axes=ba)
        y = modops.mont_mul(
            v_mat, _c3(ihat), _c3(ctx.p[sp:]), _c3(ctx.p_neg_inv[sp:])
        )  # [..., ns, n1, n2] normal: v_s·(P/p_s)^-1
        contrib = modops.shoup_mul(
            modops.barrett_reduce_u32(y[..., :, None, :, :], p, _c3(ctx.mu[:l])),
            _c3(W), _c3(Ws), p,
        )  # [..., ns, l, n1, n2]
        u = contrib[..., 0, :, :, :]
        for si in range(1, ns):
            u = modops.mod_add(u, contrib[..., si, :, :, :], p)
        u_ntt = sharded_ntt.fwd(plan, u, mesh, ax, lo=0, batch_axes=ba, epilogue=epi)
        return modops.mod_sub(
            modops.shoup_mul(x[..., :l, :, :], _c3(invP), _c3(invPs), p),
            modops.shoup_mul(u_ntt, _c3(invPm), _c3(invPms), p),
            p,
        )

    def _key_t(self, key: SwitchKey, l: int):
        """Switch-key slices in sp layout, made once on the host: the
        live-digit, live ∪ special-row selection of ``Evaluator._cat_key``,
        relayouted to ``[n_dig, l+ns, n2, n1]`` and placed on the mesh
        (:meth:`_place`)."""
        ck = (id(key), l)
        if ck not in self._key_cache:
            ctx = self.ctx
            sp, nd, ns = ctx.sp_row, ctx.dig_count(l), ctx.n_special

            def prep(arr):
                a = modops.to_numpy(arr)
                a = np.concatenate([a[:nd, :l], a[:nd, sp:]], axis=1)
                a = a.reshape(nd, l + ns, self.n1, self.n2).swapaxes(-1, -2)
                return modops.from_numpy(np.ascontiguousarray(a), ctx.device)

            self._key_cache[ck] = tuple(
                self._place(prep(t)) for t in (key.b, key.a, key.bs, key.as_))
        return self._key_cache[ck]

    def _place(self, t: torch.Tensor) -> ShardedTensor:
        """A key operand ``[..., cols]`` split on its last dim over the sp
        axis (replicated over the batch axes): each device's part moves
        there once, when the key is first used, not with every op."""
        return ShardedTensor.distribute(
            t, self.mesh, (None,) * (t.dim() - 1) + (self.axis,))

    def key_switch(
        self, d: ShardedTensor, key: SwitchKey, level: int
    ) -> Tuple[ShardedTensor, ShardedTensor]:
        """Switch sp-layout component ``d`` ``[..., l, n2, n1]`` to the base
        key; returns (kb, ka), each ``[..., l, n2, n1]`` NTT Montgomery."""
        l = level
        p_t, _ = self._targets3(l)
        dig = modops.wide(self._digits(d, l))  # [..., n_dig, l+ns, n2, n1]
        kb, ka, kbs, kas = self._key_t(key, l)
        if self._flat._lazy():
            # lazy Shoup terms in [0, 2p) (exact for the [0, 4p) digits), a
            # lazy sum, the mod-down consumes [0, 2p) directly
            sum_, mul = modops.mod_sum_lazy, modops.shoup_mul_lazy
        else:
            sum_, mul = modops.mod_sum, modops.shoup_mul
        acc_b = sum_(mul(dig, kb, kbs, p_t), p_t, axis=-4)
        acc_a = sum_(mul(dig, ka, kas, p_t), p_t, axis=-4)
        return self._mod_down(acc_b, l), self._mod_down(acc_a, l)

    def relinearize(self, a: SpCiphertext) -> SpCiphertext:
        if a.size == 2:
            return a
        if self.keys is None or self.keys.relin is None:
            raise ValueError("no relinearization key")
        l = a.level
        p = _c3(self.ctx.p[:l])
        kb, ka = self.key_switch(a.data[..., 2, :, :, :], self.keys.relin, l)
        c0 = modops.mod_add(a.data[..., 0, :, :, :], kb, p)
        c1 = modops.mod_add(a.data[..., 1, :, :, :], ka, p)
        return replace(a, data=modops.narrow(torch.stack([c0, c1], dim=-4)))

    # -- Galois / rotations ----------------------------------------------------

    def _galois_perm_t(self, g: int) -> torch.Tensor:
        """The NTT-storage Galois permutation recomposed for the sp layout's
        flattened ``(n2, n1)`` order: T ∘ perm ∘ T⁻¹, T the transpose's
        index map."""
        if g not in self._perm_cache:
            n1, n2 = self.n1, self.n2
            perm = self.ctx.plan.galois_perm_np(g)
            k = np.arange(n1 * n2)
            src_flat = perm[(k % n1) * n2 + k // n1]  # sp index -> flat source
            perm_t = (src_flat % n2) * n1 + src_flat // n2
            self._perm_cache[g] = torch.from_numpy(perm_t).to(self.ctx.device)
        return self._perm_cache[g]

    def apply_galois(self, a: SpCiphertext, g: int) -> SpCiphertext:
        if self.keys is None or (g % (2 * self.ctx.n)) not in self.keys.galois:
            raise ValueError(f"missing Galois key for element {g}")
        if a.size != 2:
            raise ValueError("relinearize before rotating")
        g = g % (2 * self.ctx.n)
        l = a.level
        p = _c3(self.ctx.p[:l])
        permuted = mesh_mod.gather_index(
            a.data, self._galois_perm_t(g), 2, (self.n2, self.n1))
        kb, ka = self.key_switch(permuted[..., 1, :, :, :], self.keys.galois[g], l)
        c0 = modops.mod_add(permuted[..., 0, :, :, :], kb, p)
        return replace(a, data=modops.narrow(torch.stack([c0, ka], dim=-4)))

    def rotate(self, a: SpCiphertext, steps: int) -> SpCiphertext:
        n = self.ctx.n
        steps = steps % (n // 2)
        if steps == 0:
            return a
        return self.apply_galois(a, pow(5, steps, 2 * n))

    def conjugate(self, a: SpCiphertext) -> SpCiphertext:
        return self.apply_galois(a, 2 * self.ctx.n - 1)

    # -- hoisted rotations -----------------------------------------------------

    def _p5_sp(self):
        """Power-of-5 orbit-order gathers for the sp layout (cached):
        ``(P_sp, Q_sp)`` with ``x_p5 = flat_sp(x)[P_sp]`` in p5 order and
        ``flat_sp(x) = x_p5[Q_sp]`` back — the single-device p5 roll
        (``Context.p5_order``) composed with the sp layout's transpose, so
        a sharded ``rotate_sum`` pays two gathers in all, each rotation's
        φ_g then a roll within an orbit."""
        if "p5sp" not in self._perm_cache:
            n1, n2 = self.n1, self.n2
            P_np = self.ctx.p5_order()[0]
            Q_np = np.empty_like(P_np)
            Q_np[P_np] = np.arange(P_np.size)
            k = np.arange(n1 * n2)
            put = lambda a: torch.from_numpy(a).to(self.ctx.device)
            self._perm_cache["p5sp"] = (
                put((P_np % n2) * n1 + P_np // n2),
                put(Q_np[(k % n1) * n2 + k // n1]),
            )
        return self._perm_cache["p5sp"]

    def _hoist_key_p5(self, g: int, l: int):
        """Hoisted ``rotate_sum`` key stacks for element ``g`` in flat p5
        order (``Evaluator._hoisted_key_p5``: ``keys.galois_p5``, or the
        one-time gather for a KeySet without it), live-selected to
        ``[2 (b, a), n_dig, l+ns, N]`` and placed on the mesh."""
        ck = ("p5", g, l)
        if ck not in self._key_cache:
            hk = self._flat._hoisted_key_p5(g)
            cat = lambda arr: self._flat._cat_key(arr, l)
            self._key_cache[ck] = (
                self._place(torch.stack([cat(hk.b), cat(hk.a)])),
                self._place(torch.stack([cat(hk.bs), cat(hk.as_)])),
            )
        return self._key_cache[ck]

    def _roll_p5(self, x: ShardedTensor, s: int) -> ShardedTensor:
        """φ_{5^s} on p5-ordered data: ``Evaluator._roll_p5`` (a shift by
        ``s`` within each orbit of N/2) on the sharded flat axis."""
        return mesh_mod.roll_segments(x, x.shape[-1] // 2, s)

    def rotate_sum(self, a: SpCiphertext, steps: Sequence[int]) -> SpCiphertext:
        """Σ_s rotate(a, s) with ONE hoisted digit decomposition and ONE
        mod-down shared by all rotations — op for op
        ``Evaluator.rotate_sum``, every transform sharded.  The shared
        digits and c0 are gathered into p5 order once, each rotation's φ_g
        is a roll, one gather takes the sum back (:meth:`_p5_sp`)."""
        ctx = self.ctx
        if a.size != 2:
            raise ValueError("relinearize before rotating")
        n = ctx.n
        slots = n // 2
        norm = [s % slots for s in steps]
        nonzero = [s for s in norm if s != 0]
        n_id = len(norm) - len(nonzero)
        l = a.level
        p3 = _c3(ctx.p[:l])
        if not nonzero:
            out = a.data
            for _ in range(n_id - 1):
                out = modops.mod_add(out, a.data, p3)
            return replace(a, data=modops.narrow(out))
        # flat targets: p5-ordered tensors carry a single flat slot axis
        p_t = torch.cat([ctx.p[:l], ctx.p[ctx.sp_row :]], dim=0)  # [l+ns, 1]
        lazy = self._flat._lazy()
        p2_t = modops.add_raw(p_t, p_t)
        P_sp, Q_sp = self._p5_sp()
        to_p5 = lambda x: mesh_mod.gather_index(x, P_sp, 2, (n,))
        from_p5 = lambda x: mesh_mod.gather_index(x, Q_sp, 1, (self.n2, self.n1))
        dig = modops.wide(to_p5(self._digits(a.data[..., 1, :, :, :], l)))  # [.., n_dig, l+ns, N]
        c0_p5 = to_p5(a.data[..., 0, :, :, :])
        acc = None       # [..., 2 (b, a), l+ns, N] before the mod-down, p5 order
        c0_parts = []    # rolled c0 components, [..., l, N] p5 order
        for s in nonzero:
            g = pow(5, s, 2 * n)
            if self.keys is None or g not in self.keys.galois:
                raise ValueError(f"missing Galois key for element {g}")
            pair_w, pair_s = self._hoist_key_p5(g, l)
            if lazy:
                terms = modops.shoup_mul_lazy(dig[..., None, :, :, :], pair_w, pair_s, p_t)
                acc_g = self._roll_p5(modops.mod_sum_lazy(terms, p_t, axis=-3), s)
                acc = acc_g if acc is None else modops.reduce_2p(
                    modops.add_raw(acc, acc_g), p2_t)
            else:
                terms = modops.shoup_mul(dig[..., None, :, :, :], pair_w, pair_s, p_t)
                acc_g = self._roll_p5(modops.mod_sum(terms, p_t, axis=-3), s)
                acc = acc_g if acc is None else modops.mod_add(acc, acc_g, p_t)
            c0_parts.append(self._roll_p5(c0_p5, s))
        kba = self._mod_down(from_p5(acc), l)  # [..., 2, l, n2, n1]
        c0_rot = from_p5(modops.mod_sum(torch.stack(c0_parts), ctx.p[:l], axis=0))
        c0 = modops.mod_add(c0_rot, kba[..., 0, :, :, :], p3)
        c1 = kba[..., 1, :, :, :]
        for _ in range(n_id):
            c0 = modops.mod_add(c0, a.data[..., 0, :, :, :], p3)
            c1 = modops.mod_add(c1, a.data[..., 1, :, :, :], p3)
        return replace(a, data=modops.narrow(torch.stack([c0, c1], dim=-4)))

    # -- rescale -----------------------------------------------------------------

    def rescale_to_next(self, a: SpCiphertext) -> SpCiphertext:
        """Composite rescale (``Evaluator.rescale_to_next``) with the
        dropped prime's inverse transform and the re-transform sharded."""
        ctx, mesh, ax, ba = self.ctx, self.mesh, self.axis, self.batch_axes
        group = getattr(ctx, "rescale_group", 1)
        l = a.level
        if l - group < getattr(ctx, "min_level", 1):
            raise ValueError("no prime group left to rescale")
        data = a.data
        scale = a.scale
        for _ in range(group):
            drop = l - 1
            v_mat = sharded_ntt.inv(
                ctx.plan, data[..., drop:l, :, :], mesh, ax, lo=drop, batch_axes=ba)
            v = modops.from_mont(
                v_mat, _c3(ctx.p[drop : drop + 1]), _c3(ctx.p_neg_inv[drop : drop + 1]))
            flag = modops.ugt(v, ctx.div_half[drop])
            p = _c3(ctx.p[:drop])
            w = modops.mod_sub(
                modops.barrett_reduce_u32(v, p, _c3(ctx.mu[:drop])),
                flag * ctx.div_mod[drop, :drop][:, None, None],
                p,
            )
            # w_ntt only feeds the fully reducing Shoup product below
            w_ntt = sharded_ntt.fwd(
                ctx.plan, w, mesh, ax, lo=0, batch_axes=ba, epilogue=not self._flat._lazy())
            sel = lambda t: t[drop, :drop][:, None, None]
            data = modops.mod_sub(
                modops.shoup_mul(data[..., :drop, :, :], sel(ctx.div_inv), sel(ctx.div_inv_shoup), p),
                modops.shoup_mul(w_ntt, sel(ctx.div_inv_mont), sel(ctx.div_inv_mont_shoup), p),
                p,
            )
            l -= 1
            scale /= ctx.data_primes[l]
        return replace(a, data=modops.narrow(data), level=l, scale=scale)


# -- observability -------------------------------------------------------------

def collective_stats(fn, *args) -> Dict[str, int]:
    """Run ``fn(*args)`` once with the collectives counted: the reference
    counts the collective ops of the compiled HLO; the port counts the
    calls of its collective helpers (``parallel/mesh.py``).  Same keys:
    ``all-to-all``, ``all-gather``, ``collective-permute``, ``all-reduce``
    and ``a2a_bytes`` (the bytes one device's all-to-all returns, per
    transform, as the HLO result shape gives them).  A staged call
    (``utils/staging.py``) runs no Python in a replay: each of its graphs
    keeps the collectives its capture counted, and every call credits
    them here once, since the graph holds exactly those copies."""
    if mesh_mod.counts is not None:
        raise RuntimeError("collective_stats does not nest")
    mesh_mod.counts = mesh_mod.zero_counts()
    try:
        fn(*args)
    finally:
        stats, mesh_mod.counts = mesh_mod.counts, None
    return stats
