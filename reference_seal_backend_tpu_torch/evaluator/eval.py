"""Homomorphic evaluator for CKKS, in plain PyTorch over the NTT plan.

Counterpart of ``reference_seal_backend_tpu/evaluator/eval.py``: add / sub /
negate / multiply / multiply_plain / add_plain / relinearize /
rescale_to_next / mod_switch_to / rotate / conjugate / rotate_sum as plain
functions on Ciphertext dataclasses.  All functions accept arbitrary
leading batch axes.  Every result equals the reference's default path bit
for bit.

Key switching (relinearize, rotations) implements RNS-decomposition hybrid
switching over the special modulus P = prod(special_primes), with optional
**digit grouping** (schemes/params.py Context docstring):

    digits   d_i = [d]_{Q_i}, Q_i = product of group i's live primes
             (iNTT; for G=1 just de-Montgomery, for G>1 *(Q_i/q_k)^-1)
    lift     D_{i,j} = fast-base-conversion of d_i onto q_j,
             j in live u specials                          (Barrett)
    NTT      per-target-modulus forward transforms
    inner    (sum_i D_{i,j}*ksk_b[i,j],  sum_i D_{i,j}*ksk_a[i,j])
    moddown  divide-and-round by P back to the live limbs

The NTTs go through ``ctx.plan`` (the CUDA kernel on the card); everything
between them is tensor arithmetic from ops/modops.py.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Optional, Sequence, Tuple

import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.schemes.keys import KeySet, SwitchKey
from reference_seal_backend_tpu_torch.schemes.params import Context

_SCALE_RTOL = 1e-9


def _lazy_ok(ctx: Context) -> bool:
    """May intermediates ride the Harvey lazy range [0, 2p)?  Requires
    every prime < 2**30 (plan.lazy).  Both the CUDA NTT kernel and its
    plain version accept [0, 2p) inputs and honour ``epilogue=False``, so
    nothing else gates it.  Residue VALUES are identical either way —
    laziness only drops corrections between range-tolerant ops."""
    return ctx.plan.lazy


def _check_binop(a: Ciphertext, b: Ciphertext, check_scale: bool = True):
    if a.level != b.level:
        raise ValueError(
            f"level mismatch {a.level} != {b.level}; use mod_switch_to"
        )
    if check_scale and abs(a.scale - b.scale) > _SCALE_RTOL * abs(a.scale):
        raise ValueError(f"scale mismatch {a.scale} vs {b.scale}")


class Evaluator:
    def __init__(self, ctx: Context, keys: Optional[KeySet] = None):
        self.ctx = ctx
        self.keys = keys
        # Galois keys with the inverse automorphism pre-applied, for
        # hoisted rotations (rotate_sum); built lazily per element when
        # not already precomputed in keys.galois_p5.
        self._hoist_cache: dict = {}

    # -- linear ops ---------------------------------------------------------

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _check_binop(a, b)
        p = self.ctx.p[: a.level]
        if a.size == b.size:
            data = modops.mod_add(a.data, b.data, p)
        else:
            big, small = (a, b) if a.size > b.size else (b, a)
            head = modops.mod_add(
                big.data[..., : small.size, :, :], small.data, p
            )
            data = torch.cat(
                [head, big.data[..., small.size :, :, :]], dim=-3
            )
        return replace(a, data=data)

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        _check_binop(a, b)
        p = self.ctx.p[: a.level]
        if a.size == b.size:
            return replace(a, data=modops.mod_sub(a.data, b.data, p))
        # Mismatched sizes (e.g. size-3 pre-relin minus size-2): subtract
        # the common head componentwise; a's surplus tail passes through,
        # b's surplus tail is negated (a - b on the missing components).
        k = min(a.size, b.size)
        head = modops.mod_sub(
            a.data[..., :k, :, :], b.data[..., :k, :, :], p
        )
        if a.size > b.size:
            tail = a.data[..., k:, :, :]
        else:
            tail = modops.mod_neg(b.data[..., k:, :, :], p)
        return replace(a, data=torch.cat([head, tail], dim=-3))

    def negate(self, a: Ciphertext) -> Ciphertext:
        return replace(a, data=modops.mod_neg(a.data, self.ctx.p[: a.level]))

    def add_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.level != a.level:
            raise ValueError("plaintext level mismatch")
        if abs(a.scale - pt.scale) > _SCALE_RTOL * abs(a.scale):
            raise ValueError(f"scale mismatch {a.scale} vs {pt.scale}")
        p = self.ctx.p[: a.level]
        c0 = modops.mod_add(a.data[..., 0, :, :], pt.data, p)
        data = torch.cat(
            [c0[..., None, :, :], a.data[..., 1:, :, :]], dim=-3
        )
        return replace(a, data=data)

    def sub_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        p = self.ctx.p[: a.level]
        c0 = modops.mod_sub(a.data[..., 0, :, :], pt.data, p)
        data = torch.cat(
            [c0[..., None, :, :], a.data[..., 1:, :, :]], dim=-3
        )
        return replace(a, data=data)

    # -- multiplicative ops (CKKS NTT-dyadic) -------------------------------

    def multiply_plain(self, a: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.level != a.level:
            raise ValueError("plaintext level mismatch")
        l = a.level
        p, pni = self.ctx.consts(0, l)
        data = modops.mont_mul(a.data, pt.data, p, pni)
        return replace(a, data=data, scale=a.scale * pt.scale)

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """ct-ct multiply WITHOUT relinearization (3-component result),
        the bare multiply of the eltwise workload."""
        _check_binop(a, b, check_scale=False)
        if a.size != 2 or b.size != 2:
            raise NotImplementedError("multiply expects size-2 inputs")
        if self.ctx.scheme != "ckks":
            raise NotImplementedError(
                "BFV ct-ct multiply (BEHZ) is not ported yet: ROADMAP.md "
                "Queue 1, the BFV slice (evaluator/behz.py)"
            )
        l = a.level
        p, pni = self.ctx.consts(0, l)
        a0, a1 = a.data[..., 0, :, :], a.data[..., 1, :, :]
        b0, b1 = b.data[..., 0, :, :], b.data[..., 1, :, :]
        # Karatsuba: 3 Montgomery products instead of 4 — the cross term is
        # (a0+a1)(b0+b1) - c0 - c2.
        c0 = modops.mont_mul(a0, b0, p, pni)
        c2 = modops.mont_mul(a1, b1, p, pni)
        if _lazy_ok(self.ctx):
            # Raw Karatsuba sums: a0+a1 < 2p < 2**31, and mont_mul is
            # exact with [0, p) output for inputs < 2p whenever 4p < 2**32
            # (t = floor((ab + mp)/2**32) < p·(4p/2**32) + p < 2p).  Drops
            # both modular-add corrections from the headline multiply.
            z = modops.mont_mul(
                modops.add_raw(a0, a1), modops.add_raw(b0, b1), p, pni
            )
        else:
            z = modops.mont_mul(
                modops.mod_add(a0, a1, p), modops.mod_add(b0, b1, p), p, pni
            )
        cross = modops.mod_sub(modops.mod_sub(z, c0, p), c2, p)
        data = torch.stack([c0, cross, c2], dim=-3)
        return replace(a, data=data, scale=a.scale * b.scale)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply(a, a)

    # -- key switching core -------------------------------------------------

    def _switch_targets(self, l: int):
        ctx = self.ctx
        sp = ctx.sp_row
        cat = lambda arr: torch.cat([arr[:l], arr[sp:]], dim=0)
        return cat(ctx.p), cat(ctx.p_neg_inv), cat(ctx.mu)

    def _cat_key(self, arr: torch.Tensor, l: int) -> torch.Tensor:
        """Select the live slice of a switch-key polynomial array:
        digits covering live limbs × (live targets ∪ all special rows).
        [n_dig_total, nf, N] -> [n_dig_live, l + n_special, N]."""
        ctx = self.ctx
        nd = ctx.dig_count(l)
        return torch.cat([arr[:nd, :l], arr[:nd, ctx.sp_row :]], dim=1)

    def key_switch(
        self, d: torch.Tensor, key: SwitchKey, level: int
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Switch NTT-domain component ``d`` [..., l, N] to the base key.

        Returns (kb, ka), each [..., l, N] NTT Montgomery — the additive
        correction encrypting d·s_src under s.
        """
        l = level
        p_t, _, _ = self._switch_targets(l)
        dig = self._hoisted_digits(d, l)
        # 4) inner product with the switch key (Shoup constants: the keys
        #    are per-context constants, normal·Mont lands in Montgomery
        #    form) and accumulate over source digits.  Lazy path: terms in
        #    [0, 2p) (shoup_mul_lazy is exact for the [0, 4p) digits), sum
        #    stays lazy, and the mod-down below consumes [0, 2p) directly
        #    (its iNTT is Harvey-tolerant, its Shoup multiplies exact).
        if _lazy_ok(self.ctx):
            tb = modops.shoup_mul_lazy(
                dig, self._cat_key(key.b, l), self._cat_key(key.bs, l), p_t
            )
            ta = modops.shoup_mul_lazy(
                dig, self._cat_key(key.a, l), self._cat_key(key.as_, l), p_t
            )
            acc_b = _mod_sum_lazy(tb, p_t, axis=-3)
            acc_a = _mod_sum_lazy(ta, p_t, axis=-3)
        else:
            tb = modops.shoup_mul(
                dig, self._cat_key(key.b, l), self._cat_key(key.bs, l), p_t
            )
            ta = modops.shoup_mul(
                dig, self._cat_key(key.a, l), self._cat_key(key.as_, l), p_t
            )
            acc_b = _mod_sum(tb, p_t, axis=-3)
            acc_a = _mod_sum(ta, p_t, axis=-3)
        # 5) divide-and-round by the special modulus.
        kb = self._mod_down_special(acc_b, l)
        ka = self._mod_down_special(acc_a, l)
        return kb, ka

    def _hoisted_digits(self, d: torch.Tensor, level: int) -> torch.Tensor:
        """Steps 1-3 of key switching for ``d`` [..., l, N] NTT Montgomery:
        digit decomposition, cross-limb lift, per-target forward NTT.
        Returns [..., n_dig, l+ns, N] normal-form digits over
        live ∪ specials.  The expensive part (the O(n_dig·(l+ns)) lift
        NTTs) — shared across all rotations of one ciphertext by
        :meth:`rotate_sum` (hoisting)."""
        ctx = self.ctx
        l = level
        G = ctx.digit_group
        lazy = _lazy_ok(ctx)
        # 1) digits: coefficient-domain residues per live limb.
        d_coeff = ctx.plan.inv(d, lo=0)
        p_t, _, mu_t = self._switch_targets(l)
        if G == 1:
            d_norm = modops.from_mont(d_coeff, ctx.p[:l], ctx.p_neg_inv[:l])
            # 2) lift each source digit onto all targets (live ∪ special).
            # Lazy path: the lift stays in [0, 2p) — the Harvey NTT below
            # accepts it, and the digits' consumers (shoup_mul inner
            # products) are exact for any uint32 representative.
            barrett = (
                modops.barrett_reduce_u32_lazy
                if lazy
                else modops.barrett_reduce_u32
            )
            lifted = barrett(
                d_norm[..., :, None, :], p_t, mu_t
            )  # [..., l_src, l+ns, N]
        else:
            # Grouped fast base conversion (params.Context.digit_tables):
            # v_k = d_k·(Q_g/q_k)^{-1} mod q_k  (one mont_mul, replacing
            # from_mont), then
            # D̃_g[j] = Σ_{k∈g} [v_k mod p_j]·(Q_g/q_k mod p_j).
            ihat, W, Ws = ctx.digit_tables(l)
            v = modops.mont_mul(
                d_coeff, ihat, ctx.p[:l], ctx.p_neg_inv[:l]
            )  # [..., l, N] normal form
            if lazy:
                contrib = modops.shoup_mul_lazy(
                    modops.barrett_reduce_u32_lazy(
                        v[..., :, None, :], p_t, mu_t
                    ),
                    W,
                    Ws,
                    p_t,
                )  # [..., l, l+ns, N] in [0, 2p)
            else:
                contrib = modops.shoup_mul(
                    modops.barrett_reduce_u32(v[..., :, None, :], p_t, mu_t),
                    W,
                    Ws,
                    p_t,
                )  # [..., l, l+ns, N]
            nd = ctx.dig_count(l)
            pad = nd * G - l
            if pad:
                contrib = torch.cat(
                    [contrib, torch.zeros_like(contrib[..., :pad, :, :])],
                    dim=-3,
                )
            grp = contrib.reshape(
                *contrib.shape[:-3], nd, G, *contrib.shape[-2:]
            )
            lifted = grp[..., 0, :, :]
            p2_t = modops.add_raw(p_t, p_t)
            for gi in range(1, G):
                if lazy:
                    lifted = modops.reduce_2p(
                        modops.add_raw(lifted, grp[..., gi, :, :]), p2_t
                    )
                else:
                    lifted = modops.mod_add(lifted, grp[..., gi, :, :], p_t)
            # [..., n_dig, l+ns, N]
        # 3) forward NTT per target modulus (normal form stays normal).
        # Lazy path: skip the canonical epilogue — the inner product's
        # shoup_mul is exact for digits in [0, 4p).
        data_part = ctx.plan.fwd(lifted[..., :l, :], lo=0, epilogue=not lazy)
        sp_part = ctx.plan.fwd(
            lifted[..., l:, :], lo=ctx.sp_row, epilogue=not lazy
        )
        return torch.cat([data_part, sp_part], dim=-2)

    def _mod_down_special(self, x: torch.Tensor, l: int) -> torch.Tensor:
        """[..., l+ns, N] (live + special rows, NTT Mont) -> [..., l, N]
        Montgomery form of round(x / P).

        ``x`` may arrive LAZY in [0, 2p) (key_switch / rotate_sum inner
        products): the special-row iNTT is Harvey-tolerant and every live
        row passes through an exact any-uint32 shoup_mul, so the result
        is bit-identical to canonical input.

        n_special == 1: the exact centered divide-and-round (bit-identical
        to the pre-grouping path).  n_special > 1: single-shot fast base
        conversion (params.Context.moddown_tables) — ONE batched iNTT over
        the special rows and ONE l-row forward NTT, instead of sequential
        per-prime peels; costs < ns units of uncentered rounding
        noise (analysis in moddown_tables)."""
        ctx = self.ctx
        ns = ctx.n_special
        if ns == 1:
            return self._peel_special(x, l, 0)
        ihat, W, Ws, invP, invPs, invPm, invPms = ctx.moddown_tables(l)
        sp = ctx.sp_row
        v_mont = ctx.plan.inv(x[..., l:, :], lo=sp)  # [..., ns, N]
        y = modops.mont_mul(
            v_mont, ihat, ctx.p[sp:], ctx.p_neg_inv[sp:]
        )  # [..., ns, N] normal: y_s = v_s·(P/p_s)^{-1} mod p_s
        p_l, mu_l = ctx.p[:l], ctx.mu[:l]
        contrib = modops.shoup_mul(
            modops.barrett_reduce_u32(y[..., :, None, :], p_l, mu_l),
            W,
            Ws,
            p_l,
        )  # [..., ns, l, N]
        u = contrib[..., 0, :, :]
        for s in range(1, ns):
            u = modops.mod_add(u, contrib[..., s, :, :], p_l)
        # u_ntt only feeds the fully-reducing shoup_mul below (exact for
        # any uint32), so the lazy NTT's canonical epilogue is skippable.
        u_ntt = ctx.plan.fwd(u, lo=0, epilogue=not _lazy_ok(ctx))
        return modops.mod_sub(
            modops.shoup_mul(x[..., :l, :], invP, invPs, p_l),
            modops.shoup_mul(u_ntt, invPm, invPms, p_l),
            p_l,
        )

    def _peel_special(self, x: torch.Tensor, l: int, j: int) -> torch.Tensor:
        """Divide-and-round ``x`` [..., l+j+1, N] (rows = live 0..l-1 then
        specials 0..j) by special prime j -> [..., l+j, N]."""
        ctx = self.ctx
        dr = ctx.L + j  # context row of the divisor prime
        k = l + j       # its row index within x
        v_mont = ctx.plan.inv(x[..., k : k + 1, :], lo=dr)
        v = modops.from_mont(
            v_mont, ctx.p[dr : dr + 1], ctx.p_neg_inv[dr : dr + 1]
        )  # [..., 1, N] in [0, p_dr)
        flag = modops.ugt(v, ctx.div_half[dr])

        def lift(rows):
            # centered lift of v onto target rows, normal form
            return modops.mod_sub(
                modops.barrett_reduce_u32(v, ctx.p[rows], ctx.mu[rows]),
                flag * ctx.div_mod[dr, rows][:, None],
                ctx.p[rows],
            )

        def combine(xpart, w_ntt, rows):
            p = ctx.p[rows]
            sel = lambda t: t[dr, rows][:, None]
            return modops.mod_sub(
                # x is Montgomery form: multiply by plain p_dr^{-1}
                modops.shoup_mul(
                    xpart, sel(ctx.div_inv), sel(ctx.div_inv_shoup), p
                ),
                # w is normal form: p_dr^{-1}·R lands it in Montgomery
                modops.shoup_mul(
                    w_ntt,
                    sel(ctx.div_inv_mont),
                    sel(ctx.div_inv_mont_shoup),
                    p,
                ),
                p,
            )

        live = slice(0, l)
        # w_ntt only feeds combine's fully-reducing shoup_mul (exact for
        # any uint32) — skip the lazy NTT's canonical epilogue.
        epi = not _lazy_ok(ctx)
        out = combine(
            x[..., :l, :], ctx.plan.fwd(lift(live), lo=0, epilogue=epi), live
        )
        if j == 0:
            return out
        sps = slice(ctx.L, dr)  # remaining special rows 0..j-1
        out_sp = combine(
            x[..., l:k, :], ctx.plan.fwd(lift(sps), lo=ctx.L, epilogue=epi),
            sps,
        )
        return torch.cat([out, out_sp], dim=-2)

    def relinearize(self, a: Ciphertext) -> Ciphertext:
        if a.size == 2:
            return a
        if a.size != 3:
            raise NotImplementedError("relinearize expects size <= 3")
        if self.keys is None or self.keys.relin is None:
            raise ValueError("no relinearization key")
        l = a.level
        p = self.ctx.p[:l]
        kb, ka = self.key_switch(a.data[..., 2, :, :], self.keys.relin, l)
        c0 = modops.mod_add(a.data[..., 0, :, :], kb, p)
        c1 = modops.mod_add(a.data[..., 1, :, :], ka, p)
        return replace(a, data=torch.stack([c0, c1], dim=-3))

    # -- level / scale management ------------------------------------------

    def _drop_one_scaled(self, data: torch.Tensor, l: int) -> torch.Tensor:
        """Divide-and-round NTT-domain data [..., l, N] by prime l-1."""
        ctx = self.ctx
        drop = l - 1
        v_mont = ctx.plan.inv(data[..., drop:l, :], lo=drop)
        v = modops.from_mont(
            v_mont, ctx.p[drop : drop + 1], ctx.p_neg_inv[drop : drop + 1]
        )
        flag = modops.ugt(v, ctx.div_half[drop])
        w = modops.mod_sub(
            modops.barrett_reduce_u32(v, ctx.p[:drop], ctx.mu[:drop]),
            flag * ctx.div_mod[drop, :drop][:, None],
            ctx.p[:drop],
        )
        # w_ntt only feeds the fully-reducing shoup_mul below (exact for
        # any uint32) — skip the lazy NTT's canonical epilogue.
        w_ntt = ctx.plan.fwd(w, lo=0, epilogue=not _lazy_ok(ctx))
        p = ctx.p[:drop]
        sel = lambda t: t[drop, :drop][:, None]
        return modops.mod_sub(
            modops.shoup_mul(
                data[..., :drop, :],
                sel(ctx.div_inv),
                sel(ctx.div_inv_shoup),
                p,
            ),
            modops.shoup_mul(
                w_ntt,
                sel(ctx.div_inv_mont),
                sel(ctx.div_inv_mont_shoup),
                p,
            ),
            p,
        )

    def rescale_to_next(self, a: Ciphertext) -> Ciphertext:
        """CKKS rescale: divide-and-round by the last live prime *group*
        (composite rescaling — rescale_group primes ≈ one SEAL scale
        prime)."""
        ctx = self.ctx
        group = getattr(ctx, "rescale_group", 1)
        l = a.level
        if l - group < getattr(ctx, "min_level", 1):
            raise ValueError("no prime group left to rescale")
        data = a.data
        scale = a.scale
        for _ in range(group):
            data = self._drop_one_scaled(data, l)
            l -= 1
            scale /= ctx.data_primes[l]
        return replace(a, data=data, level=l, scale=scale)

    def mod_switch_to_next(self, a: Ciphertext) -> Ciphertext:
        """CKKS modulus-chain drop (one rescale group) without scaling
        (matchLevel's underlying op)."""
        group = getattr(self.ctx, "rescale_group", 1)
        l = a.level - group
        if l < 1:
            raise ValueError("cannot drop below one live prime")
        return replace(a, data=a.data[..., :l, :], level=l)

    def mod_switch_to(self, a: Ciphertext, level: int) -> Ciphertext:
        """Drop live primes down to ``level`` (a prime count)."""
        if level > a.level:
            raise ValueError("cannot mod-switch up")
        if level < 1:
            raise ValueError("cannot drop below one live prime")
        return replace(a, data=a.data[..., :level, :], level=level)

    def mod_switch_plain_to(self, pt: Plaintext, level: int) -> Plaintext:
        if level > pt.level:
            raise ValueError("cannot mod-switch plaintext up")
        return replace(pt, data=pt.data[..., :level, :], level=level)

    def match_level(
        self, a: Ciphertext, b: Ciphertext
    ) -> Tuple[Ciphertext, Ciphertext]:
        """Align two ciphertexts on the lower of their two levels
        (reference SEALContextWrapper::matchLevel)."""
        tgt = min(a.level, b.level)
        return self.mod_switch_to(a, tgt), self.mod_switch_to(b, tgt)

    # -- Galois / rotations -------------------------------------------------

    def apply_galois(self, a: Ciphertext, g: int) -> Ciphertext:
        if self.keys is None or (g % (2 * self.ctx.n)) not in self.keys.galois:
            raise ValueError(f"missing Galois key for element {g}")
        if a.size != 2:
            raise ValueError("relinearize before rotating")
        g = g % (2 * self.ctx.n)
        l = a.level
        p = self.ctx.p[:l]
        permuted = self.ctx.plan.apply_galois_eval(a.data, g)
        kb, ka = self.key_switch(
            permuted[..., 1, :, :], self.keys.galois[g], l
        )
        c0 = modops.mod_add(permuted[..., 0, :, :], kb, p)
        return replace(a, data=torch.stack([c0, ka], dim=-3))

    def rotate(self, a: Ciphertext, steps: int) -> Ciphertext:
        """Rotate slot vector left by ``steps`` (CKKS rotate_vector /
        BFV rotate_rows semantics; negative = right)."""
        n = self.ctx.n
        slots = n // 2
        steps = steps % slots
        if steps == 0:
            return a
        return self.apply_galois(a, pow(5, steps, 2 * n))

    def conjugate(self, a: Ciphertext) -> Ciphertext:
        """CKKS slot conjugation / BFV rotate_columns (element 2N-1)."""
        return self.apply_galois(a, 2 * self.ctx.n - 1)

    # -- hoisted rotations ---------------------------------------------------

    def _hoisted_key(self, g: int) -> SwitchKey:
        """Galois switch key for element ``g`` with the inverse automorphism
        φ_{g^{-1}} pre-applied along the slot axis (host-side, one-time):

            K_g[i] = φ_{g^{-1}}(ksk_g[i])   so that
            φ_g(Σ_i D_i·K_g[i]) = Σ_i φ_g(D_i)·ksk_g[i]

        i.e. the hoisted rotation's inner product runs against the *shared*
        digit tensor, and the (cheap, [l+1, N]-sized) automorphism gather
        moves onto the accumulated result instead of the wide digits."""
        if g not in self._hoist_cache:
            key = self.keys.galois[g]
            g_inv = pow(g, -1, 2 * self.ctx.n)
            perm = self.ctx.plan.galois_perm(g_inv)
            take = lambda arr: torch.index_select(arr, -1, perm)
            self._hoist_cache[g] = SwitchKey(
                b=take(key.b), a=take(key.a),
                bs=take(key.bs), as_=take(key.as_),
            )
        return self._hoist_cache[g]

    def _p5_tables(self):
        """Power-of-5 orbit-order permutation (params.Context.p5_order):
        rotate_sum gathers into p5 order ONCE, rolls per rotation (two
        slices + concat, no gather), and gathers back once — instead of
        one N-point gather per rotation."""
        return self.ctx.p5_order()

    def _hoisted_key_p5(self, g: int) -> SwitchKey:
        """Hoisted rotate_sum key for element ``g``: φ_{g^{-1}}
        pre-applied, slot axis in p5 order.  Prefers the keygen-time
        precomputed ``keys.galois_p5``; falls back to a one-time gather
        for KeySets that carry none."""
        kp5 = getattr(self.keys, "galois_p5", None)
        if kp5 and g in kp5:
            return kp5[g]
        ck = ("p5", g)
        if ck not in self._hoist_cache:
            base = self._hoisted_key(g)
            _, P_dev, _ = self._p5_tables()
            take = lambda arr: torch.index_select(arr, -1, P_dev)
            self._hoist_cache[ck] = SwitchKey(
                b=take(base.b), a=take(base.a),
                bs=take(base.bs), as_=take(base.as_),
            )
        return self._hoist_cache[ck]

    @staticmethod
    def _roll_p5(x: torch.Tensor, s: int) -> torch.Tensor:
        """φ_{5^s} on a p5-ordered array: shift by s within each orbit."""
        half = x.shape[-1] // 2
        v = x.reshape(*x.shape[:-1], 2, half)
        v = torch.roll(v, -s, dims=-1)
        return v.reshape(*x.shape)

    def rotate_sum(self, a: Ciphertext, steps: Sequence[int]) -> Ciphertext:
        """Σ_s rotate(a, s) over ``steps`` with ONE hoisted digit
        decomposition and ONE mod-down shared across all rotations
        (Halevi-Shoup hoisting).  Validity: the permuted digits
        φ_g(lift(d_i)) stay congruent to φ_g(d) mod q_i and bounded, which
        is all the gadget identity needs — representatives only affect the
        rounding noise, where one shared mod-down rounds *once* instead of
        once per rotation.

        Replaces a rotate-then-add accumulation loop at 1/len(steps) of
        the dominant digit-lift NTT cost.  Step 0 is
        the identity (no key needed); each other step needs its Galois
        key.  Same level/scale as the input.
        """
        ctx = self.ctx
        if a.size != 2:
            raise ValueError("relinearize before rotating")
        n = ctx.n
        slots = n // 2
        norm = [s % slots for s in steps]
        nonzero = [s for s in norm if s != 0]
        n_id = len(norm) - len(nonzero)
        l = a.level
        p = ctx.p[:l]
        if not nonzero:
            out = a.data
            for _ in range(n_id - 1):
                out = modops.mod_add(out, a.data, p)
            return replace(a, data=out)
        p_t, _, _ = self._switch_targets(l)
        lazy = _lazy_ok(ctx)
        p2_t = modops.add_raw(p_t, p_t)
        _, P_dev, Q_dev = self._p5_tables()
        # ONE gather into p5 order for the shared digits and c0; every
        # per-rotation φ_g is then a roll (see _p5_tables).
        dig = torch.index_select(
            self._hoisted_digits(a.data[..., 1, :, :], l), -1, P_dev
        )
        c0_p5 = torch.index_select(a.data[..., 0, :, :], -1, P_dev)
        cat2 = lambda k: self._cat_key(k, l)
        acc = None           # [..., 2(b,a), l+ns, N] pre-mod-down, p5 order
        c0_parts = []        # rolled c0 components, [..., l, N] p5 order
        for s in nonzero:
            g = pow(5, s, 2 * n)
            if self.keys is None or g not in self.keys.galois:
                raise ValueError(f"missing Galois key for element {g}")
            hk = self._hoisted_key_p5(g)
            pair_w = torch.stack([cat2(hk.b), cat2(hk.a)])  # [2, nd, l+ns, N]
            pair_s = torch.stack([cat2(hk.bs), cat2(hk.as_)])
            if lazy:
                # Inner product rides [0, 2p): lazy Shoup terms, lazy
                # tree, lazy cross-rotation accumulate — the mod-down
                # consumes [0, 2p) directly (key_switch's analysis).
                terms = modops.shoup_mul_lazy(
                    dig[..., None, :, :, :], pair_w, pair_s, p_t
                )  # [..., 2, nd, l+ns, N]
                acc_g = _mod_sum_lazy(terms, p_t, axis=-3)
                acc_g = self._roll_p5(acc_g, s)           # apply φ_g
                acc = (
                    acc_g
                    if acc is None
                    else modops.reduce_2p(modops.add_raw(acc, acc_g), p2_t)
                )
            else:
                terms = modops.shoup_mul(
                    dig[..., None, :, :, :], pair_w, pair_s, p_t
                )  # [..., 2, nd, l+ns, N]
                acc_g = _mod_sum(terms, p_t, axis=-3)     # [..., 2, l+ns, N]
                acc_g = self._roll_p5(acc_g, s)           # apply φ_g
                acc = (
                    acc_g
                    if acc is None
                    else modops.mod_add(acc, acc_g, p_t)
                )
            c0_parts.append(self._roll_p5(c0_p5, s))
        acc = torch.index_select(acc, -1, Q_dev)          # back to storage
        kba = self._mod_down_special(acc, l)                # [..., 2, l, N]
        c0_rot = torch.index_select(
            _mod_sum(torch.stack(c0_parts), p, axis=0), -1, Q_dev
        )
        c0 = modops.mod_add(c0_rot, kba[..., 0, :, :], p)
        c1 = kba[..., 1, :, :]
        for _ in range(n_id):
            c0 = modops.mod_add(c0, a.data[..., 0, :, :], p)
            c1 = modops.mod_add(c1, a.data[..., 1, :, :], p)
        return replace(a, data=torch.stack([c0, c1], dim=-3))


def _mod_sum(x: torch.Tensor, p: torch.Tensor, axis: int) -> torch.Tensor:
    """Modular reduction-tree sum along ``axis`` (pairwise, log depth)."""
    n = x.shape[axis]
    idx = lambda s: tuple(
        s if d == axis % x.ndim else slice(None) for d in range(x.ndim)
    )
    while n > 1:
        half = n // 2
        a = x[idx(slice(0, half))]
        b = x[idx(slice(half, 2 * half))]
        rest = x[idx(slice(2 * half, n))]
        x = torch.cat([modops.mod_add(a, b, p), rest], dim=axis)
        n = half + (n - 2 * half)
    return torch.squeeze(x, dim=axis)


def _mod_sum_lazy(x: torch.Tensor, p: torch.Tensor, axis: int) -> torch.Tensor:
    """Reduction-tree sum of LAZY terms in [0, 2p) along ``axis``; the
    result stays in [0, 2p).  Each tree level is a raw add (< 4p, fits
    uint32 for p < 2**30) plus one conditional 2p-subtract — one op
    cheaper per pair than the canonical :func:`_mod_sum`, and the terms
    themselves come from shoup_mul_lazy (4 ops cheaper each)."""
    p2 = modops.add_raw(p, p)
    n = x.shape[axis]
    idx = lambda s: tuple(
        s if d == axis % x.ndim else slice(None) for d in range(x.ndim)
    )
    while n > 1:
        half = n // 2
        a = x[idx(slice(0, half))]
        b = x[idx(slice(half, 2 * half))]
        rest = x[idx(slice(2 * half, n))]
        x = torch.cat(
            [modops.reduce_2p(modops.add_raw(a, b), p2), rest], dim=axis
        )
        n = half + (n - 2 * half)
    return torch.squeeze(x, dim=axis)


def rotation_galois_elt(n: int, steps: int) -> int:
    return pow(5, steps % (n // 2), 2 * n)
