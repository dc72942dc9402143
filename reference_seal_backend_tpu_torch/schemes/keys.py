"""Key generation: secret, public, relinearization and Galois keys.

Counterpart of ``reference_seal_backend_tpu/schemes/keys.py`` with **hybrid
key switching over a (possibly multi-prime) special modulus
P = prod(special_primes)**.  For a source secret ``s_src`` (s^2 for relin,
sigma_g(s) for Galois) the switch key is, per digit i (a group of
``digit_group`` consecutive data limbs) over the full basis ``q u P``::

    ksk_i = ( -(a_i*s + e_i) + P*delta_i*s_src ,  a_i )

where delta_i is 1 on every limb of digit i's group and 0 elsewhere.

Key polynomials are stored in Montgomery form together with Shoup
companions (``floor(w * 2**32 / p)``): the key-switch inner product against
*normal-form* lifted digits is then one Shoup multiply per term.

Sampling is host side from a seeded **ChaCha20 CSPRNG**
(schemes/csprng.py), in the reference's draw order, so the same ``seed``
yields the reference's KeySet bit for bit: secret and encryption randomness
are uniform-ternary, errors are rounded Gaussians (sigma 3.2, +-6 sigma
clamp), and the public ``a`` polynomials are sampled uniform per limb in
NTT domain.  The arithmetic runs as plain tensor code on the context's
device (the NTTs through ``ctx.plan``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.schemes import core
from reference_seal_backend_tpu_torch.schemes.csprng import ChaChaRng
from reference_seal_backend_tpu_torch.schemes.params import Context

SIGMA = 3.2


@dataclass(frozen=True)
class PublicKey:
    b: torch.Tensor  # [L_data, N] NTT Montgomery
    a: torch.Tensor


@dataclass(frozen=True)
class SwitchKey:
    """Per-digit switch key over the full basis.

    b, a: ``[n_dig, n_full, N]`` where n_dig = ceil(L_data / digit_group)
    and n_full = L_data + n_special (special primes last), stored in
    **Montgomery form**, with Shoup companions bs, as_.
    """

    b: torch.Tensor
    a: torch.Tensor
    bs: torch.Tensor
    as_: torch.Tensor


@dataclass(frozen=True)
class KeySet:
    """``galois_p5`` holds, per rotation element g = 5^s, the hoisted
    variant of its switch key: the inverse automorphism phi_{g^-1}
    pre-applied and the slot axis re-ordered into the power-of-5 orbit
    order (params.Context.p5_order) — what Evaluator.rotate_sum's
    shared-digit inner products consume."""

    secret_ntt: torch.Tensor  # [L_data + ns, N] NTT Montgomery, full basis
    public: PublicKey
    relin: Optional[SwitchKey]
    galois: Dict[int, SwitchKey]  # by Galois element g
    galois_p5: Dict[int, SwitchKey]  # hoisted rotate_sum keys, by element


def sample_ternary(rng, n: int) -> np.ndarray:
    """Uniform ternary secret in {-1, 0, 1}."""
    return rng.integers(-1, 2, size=n).astype(np.int64)


def sample_error(rng, n: int) -> np.ndarray:
    """Rounded Gaussian error, sigma 3.2, clamped to +-6 sigma."""
    e = np.rint(rng.normal(0.0, SIGMA, size=n)).astype(np.int64)
    return np.clip(e, -19, 19)


def _res(coeffs: np.ndarray, primes) -> np.ndarray:
    return core.rns_to_mont(core.int_poly_to_rns(coeffs, primes), primes)


def batched_enc_randomness(rng, ctx: Context, primes, lead):
    """Encryption randomness (u, e0, e1) for a ``lead``-shaped batch,
    RNS-lifted to Montgomery and stacked to ``lead + (len(primes), N)``,
    on the context's device.

    Draw order matches per-sample encryption exactly (u, e0, e1 per
    sample, batch order), so batched and looped encryption are
    bit-identical under one seed."""
    B = int(np.prod(lead)) if lead else 1
    if B == 0:
        raise ValueError("cannot draw encryption randomness for an empty batch")
    trips = [
        tuple(
            _res(draw(rng, ctx.n), primes)
            for draw in (sample_ternary, sample_error, sample_error)
        )
        for _ in range(B)
    ]

    def stacked(j):
        a = np.stack([t[j] for t in trips])
        return modops.from_numpy(
            a.reshape(tuple(lead) + a.shape[1:]), ctx.device
        )

    return stacked(0), stacked(1), stacked(2)


def to_ntt_mont(ctx: Context, coeffs: np.ndarray, rows: slice) -> torch.Tensor:
    """Signed int coefficients -> device NTT Montgomery rows of the stack."""
    primes = ctx.primes[rows]
    lo = rows.start or 0
    return ctx.plan.fwd(modops.from_numpy(_res(coeffs, primes), ctx.device), lo=lo)


def _shoup_floor(w: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``floor(w * 2**32 / p)`` for w in [0, p), p < 2**31: one exact
    int64 division (``w << 32`` stays below 2**63)."""
    return modops.narrow((modops.wide(w) << 32) // modops.wide(p))


def keygen(
    ctx: Context,
    seed: int = 0,
    galois_elts: Sequence[int] = (),
    need_relin: bool = True,
) -> KeySet:
    rng = ChaChaRng(seed, stream=0xC0FFEE)
    L = ctx.L
    nf = L + ctx.n_special
    n_dig = ctx.dig_count(L)
    two_n = 2 * ctx.n
    dev = ctx.device
    elts = []
    for g in galois_elts:
        g = g % two_n
        if g not in elts:
            elts.append(g)
    n_sk = (1 if need_relin else 0) + len(elts)

    # host-side sampling in the reference's draw order
    s_res = _res(sample_ternary(rng, ctx.n), ctx.primes)
    a_pk_np = np.stack(
        [
            rng.integers(0, p, size=ctx.n, dtype=np.uint32)
            for p in ctx.primes[:L]
        ]
    )
    e_pk_res = _res(sample_error(rng, ctx.n), ctx.primes[:L])
    if n_sk:
        a_sk_np = np.stack(
            [
                np.stack(
                    [
                        rng.integers(0, p, size=ctx.n, dtype=np.uint32)
                        for p in ctx.primes
                    ]
                )
                for _ in range(n_sk * n_dig)
            ]
        ).reshape(n_sk, n_dig, nf, ctx.n)
        e_sk_res = np.stack(
            [
                _res(sample_error(rng, ctx.n), ctx.primes)
                for _ in range(n_sk * n_dig)
            ]
        ).reshape(n_sk, n_dig, nf, ctx.n)

    # device math
    p_full, pni_full = ctx.p, ctx.p_neg_inv
    p_d, pni_d = p_full[:L], pni_full[:L]
    s_ntt = ctx.plan.fwd(modops.from_numpy(s_res, dev), lo=0)  # [nf, N]
    a_pk = modops.from_numpy(a_pk_np, dev)
    e_pk = ctx.plan.fwd(modops.from_numpy(e_pk_res, dev), lo=0)
    b_pk = modops.mod_neg(
        modops.mod_add(
            modops.mont_mul(a_pk, s_ntt[:L], p_d, pni_d), e_pk, p_d
        ),
        p_d,
    )
    public = PublicKey(b=b_pk, a=a_pk)
    if n_sk == 0:
        return KeySet(s_ntt, public, None, {}, {})

    # switch-key sources: s^2 for relin, sigma_g(s) per Galois element
    srcs = []
    if need_relin:
        srcs.append(modops.mont_mul(s_ntt, s_ntt, p_full, pni_full))
    for g in elts:
        srcs.append(ctx.plan.apply_galois_eval(s_ntt, g))
    src = torch.stack(srcs)  # [n_sk, nf, N]
    a_sk = modops.from_numpy(a_sk_np, dev)
    e_sk = ctx.plan.fwd(modops.from_numpy(e_sk_res, dev), lo=0)
    b = modops.mod_neg(
        modops.mod_add(
            modops.mont_mul(a_sk, s_ntt, p_full, pni_full), e_sk, p_full
        ),
        p_full,
    )  # [n_sk, n_dig, nf, N]
    # digit i additionally encrypts P*s_src on each row q_j of its limb
    # group (j // digit_group == i)
    P = 1
    for sp in ctx.special_primes:
        P *= sp
    p_mod_mont = modops.from_numpy(
        np.array(
            [[(P % q) * (1 << 32) % q] for q in ctx.data_primes],
            dtype=np.uint32,
        ),
        dev,
    )
    terms = modops.mont_mul(src[:, :L], p_mod_mont, p_d, pni_d)  # [n_sk, L, N]
    row = torch.arange(L, device=dev)
    dig = row // ctx.digit_group
    b[:, dig, row] = modops.mod_add(b[:, dig, row], terms, p_d)
    bs = _shoup_floor(b, p_full)
    as_ = _shoup_floor(a_sk, p_full)

    off = 1 if need_relin else 0
    relin = None
    if need_relin:
        relin = SwitchKey(b=b[0], a=a_sk[0], bs=bs[0], as_=as_[0])
    galois: Dict[int, SwitchKey] = {}
    galois_p5: Dict[int, SwitchKey] = {}
    P_np = ctx.p5_order()[0] if elts else None
    for j, g in enumerate(elts):
        k = off + j
        galois[g] = SwitchKey(b=b[k], a=a_sk[k], bs=bs[k], as_=as_[k])
        if g == two_n - 1:
            continue  # conjugation is not in the rotation group <5>
        # hoisted rotate_sum variant: phi_{g^-1} then the p5 re-order,
        # composed into one slot gather per key
        g_inv = pow(g, -1, two_n)
        idx = torch.from_numpy(ctx.plan.galois_perm_np(g_inv)[P_np]).to(dev)
        take = lambda t: torch.index_select(t, -1, idx)
        galois_p5[g] = SwitchKey(
            b=take(b[k]), a=take(a_sk[k]), bs=take(bs[k]), as_=take(as_[k])
        )
    return KeySet(
        secret_ntt=s_ntt,
        public=public,
        relin=relin,
        galois=galois,
        galois_p5=galois_p5,
    )
