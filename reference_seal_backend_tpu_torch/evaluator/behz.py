"""BEHZ RNS BFV ct-ct multiplication (Bajard-Eynard-Hasan-Zucca 2016).

Counterpart of ``reference_seal_backend_tpu/evaluator/behz.py``, giving the
same integers at every stage.  An integer-only RNS multiply with the t/q
scaling BFV requires, with no bignum arithmetic on the device — every step
is a uint32 Montgomery/Shoup product or an NTT over two prime bases:

  1. fast base conversion of the inputs q -> Bsk u {m_tilde}, the inputs
     pre-multiplied by m_tilde
  2. small Montgomery reduction mod m_tilde = 2**16 (cancels the
     conversion's q-overflows; mod-2^16 arithmetic is a bit mask)
  3. tensor product in both bases via NTT dyadic multiplies
  4. scale by t and floor-divide by q in Bsk (fast_floor)
  5. exact Shenoy-Kumaresan conversion Bsk -> q using m_sk

Base sizes: q has k ~30-bit primes; B has k+1 (so B >> q, the headroom the
S-K conversion needs with same-width primes); Bsk = B u {m_sk}.  The base
extensions run on *normal-form* residues; every constant is a Shoup pair
``(w, floor(w * 2**32 / p))``, so each step is one Shoup product, exact for
any uint32 left operand (cross-base digits are used unreduced).
Ciphertexts enter and leave in the at-rest NTT Montgomery form.

The whole multiply is four NTT sweeps, each one call of the plan: the two
operands' inverse transforms stacked on a leading axis, the forward and
inverse transforms of the tensor product over q u Bsk on one limb axis
(``BehzTables.mult_plan``), and the output's forward transform.  Between
them each step is a chain in the working format of ``ops/modops.py`` (its
format rule), and the tables are held in that format on the device.
Leading axes of the operands broadcast, and only in the tensor product's
three Karatsuba products: every step before them is pointwise per
polynomial and runs on each operand's distinct ciphertexts
(:func:`operands`), so a product of P ciphertexts broadcast from Pa and
Pb converts Pa + Pb of them, not 2P.  On
the card, the flat multiply runs steps 4 and 5 and the output's entry into
Montgomery form as one uint32 kernel (``csrc/behz.cu``), whose oracle these
functions are; the limb path and the CPU run the functions.

Row windows.  Every step that reads q limbs takes the first q row ``lo``
of the rows it is given (``r`` of them; all ``k`` in the flat multiply),
so that a block of a limb-sharded ciphertext (``parallel/limb.py``) runs
these same functions on its own rows.  The two conversions that sum over
every q limb are split: a partial part over the window
(:func:`_conv_partial`, :func:`_fbc_partial`), whose sums the limb blocks
add in an all-reduce, and a finishing part after it (:func:`_conv_finish`,
:func:`_canon`) that reduces fully, so that any representative of a sum
gives the same integers.  The flat multiply is the window ``(0, k)``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
from reference_seal_backend_tpu_torch.ops.cuda import behz as behz_cuda
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext
from reference_seal_backend_tpu_torch.schemes.params import BfvContext
from reference_seal_backend_tpu_torch.utils import counters

_MASK16 = 0xFFFF
_MTILDE = 1 << 16
_HALF_MTILDE = 1 << 15


class BehzTables:
    """Host-precomputed constant tables for one BFV context, in the working
    format (``ops/modops.py``) on the context's device.  Names and shapes are
    the reference's: ``[k, 1]`` columns, ``[rows, cols, 1]`` tables, Shoup
    pairs as ``(w, w_shoup)`` tuples, scalars as Python ints."""

    def __init__(self, ctx: BfvContext):
        self.ctx = ctx
        dev = ctx.device
        put = lambda a: torch.from_numpy(
            np.asarray(a, dtype=np.uint32).astype(np.int64)
        ).to(dev)

        def pair(vals, primes):
            """Shoup pair columns [(w_i, floor(w_i*2^32/p_i))] as [k, 1]."""
            w = [v % p for v, p in zip(vals, primes)]
            return (
                put([[x] for x in w]),
                put([[(x << 32) // p] for x, p in zip(w, primes)]),
            )

        def pair2(rows, col_primes):
            """Shoup pairs of a [rows, cols, 1] table; modulus per column."""
            w = [[v % p for v, p in zip(r, col_primes)] for r in rows]
            s = [[(x << 32) // p for x, p in zip(r, col_primes)] for r in w]
            return put(w)[..., None], put(s)[..., None]

        k = ctx.L
        q_primes = ctx.data_primes
        aux = ctx.aux_primes  # k+1 primes, base B
        bsk = ctx.bsk_primes  # aux + (m_sk,)
        # The lazy-range steps below (raw Karatsuba sums into mont_mul,
        # [0, 2p) conversion trees) assume every prime < 2**30.
        if any(p >= 1 << 30 for p in q_primes + bsk):
            raise ValueError("BEHZ tables require all primes < 2**30")
        q, t, m_sk = ctx.q, ctx.t, ctx.m_sk
        B = 1
        for b in aux:
            B *= b

        qh = [q // qi for qi in q_primes]
        qh_inv = [pow(qh[i] % q_primes[i], -1, q_primes[i]) for i in range(k)]

        # step 1: y_i = x_i * (m_tilde * qhat_i^-1) mod q_i
        self.mtilde_qhinv = pair((_MTILDE * v for v in qh_inv), q_primes)
        # step 4: the xt scaling of prod_q folded into the floor-divide
        # conversion's qhat_i^-1 pre-multiply (one constant, one sweep)
        self.t_qhinv = pair((t * v for v in qh_inv), q_primes)
        # qhat_i mod p_j for p_j in Bsk: [k, kb, 1] Shoup pairs
        self.qh_mod_bsk = pair2([[qh[i] for _ in bsk] for i in range(k)], bsk)
        self.qh_mod_mtilde = put([[qh[i] % _MTILDE] for i in range(k)])
        self.neg_qinv_mtilde = (-pow(q % _MTILDE, -1, _MTILDE)) % _MTILDE
        # step 2 constants per Bsk prime
        self.mtilde_inv_bsk = pair((pow(_MTILDE, -1, pj) for pj in bsk), bsk)
        self.q_mtilde_inv_bsk = pair(
            (q * pow(_MTILDE, -1, pj) % pj for pj in bsk), bsk
        )
        self.q_mod_bsk = put([[q % pj] for pj in bsk])
        # step 4: xt then floor-divide by q in Bsk
        self.t_mod_bsk = pair((t for _ in bsk), bsk)
        self.qinv_bsk = pair((pow(q % pj, -1, pj) for pj in bsk), bsk)
        # step 5 (Shenoy-Kumaresan, base B -> q via m_sk)
        ka = len(aux)
        Bh = [B // bi for bi in aux]
        self.Bh_inv = pair(
            (pow(Bh[i] % aux[i], -1, aux[i]) for i in range(ka)), aux
        )
        self.Bh_mod_msk = pair((Bh[i] for i in range(ka)), (m_sk,) * ka)
        self.Bh_mod_q = pair2(
            [[Bh[i] for _ in q_primes] for i in range(ka)], q_primes
        )
        binv = pow(B % m_sk, -1, m_sk)
        self.Binv_msk = (binv, (binv << 32) // m_sk)
        self.B_mod_q = pair((B for _ in q_primes), q_primes)
        self.msk_B_mod_q = put(
            [[(m_sk % qj) * (B % qj) % qj] for qj in q_primes]
        )
        self.half_msk = m_sk // 2

        w = modops.wide
        self.q_p = ctx.p[:k]
        self.q_pni = ctx.p_neg_inv[:k]
        self.q_mu = ctx.mu[:k]
        # R mod p pairs: enter Montgomery form with one Shoup product
        self.q_r1 = pair(((1 << 32) for _ in q_primes), q_primes)
        self.bsk_p = w(ctx.bsk_plan.p)
        self.bsk_pni = w(ctx.bsk_plan.p_neg_inv)
        self.bsk_r1 = pair(((1 << 32) for _ in bsk), bsk)
        # The tensor base q u Bsk: one NTT plan over the stacked limb axis,
        # so each transform of the tensor product is one sweep.  Per-limb
        # twiddles and constants equal those of the separate plans.
        self.mult_plan = ntt_mod.make_plan(ctx.n, q_primes + bsk, dev)
        self.all_p = torch.cat([self.q_p, self.bsk_p], dim=0)
        self.all_pni = torch.cat([self.q_pni, self.bsk_pni], dim=0)
        self.all_r1 = (
            torch.cat([self.q_r1[0], self.bsk_r1[0]], dim=0),
            torch.cat([self.q_r1[1], self.bsk_r1[1]], dim=0),
        )
        # On the card, the fused kernel of this k (ops/cuda/behz.py), built
        # and its constants packed now, outside any graph capture; a k that
        # it does not take is refused here.
        if dev.type == "cuda":
            behz_cuda.prepare(self)


@functools.lru_cache(maxsize=None)
def tables_for(ctx: BfvContext) -> BehzTables:
    return BehzTables(ctx)


@functools.lru_cache(maxsize=None)
def window(tb: BehzTables, lo: int, rows: int):
    """The tensor base of the q rows ``[lo, lo + rows)`` and all of Bsk:
    ``(plan, p, pni, r1)``, its NTT plan over the stacked limb axis (so
    each transform of the tensor product is one launch, as the flat
    multiply's), its moduli, Montgomery constants and R-mod-p Shoup pair
    as ``[rows + kb, 1]`` columns.  ``(0, k)`` is the flat multiply's
    ``mult_plan`` / ``all_*``; another window gets a plan of its own
    primes (cached per window, as ``make_plan`` caches every plan)."""
    k = tb.ctx.L
    if (lo, rows) == (0, k):
        return tb.mult_plan, tb.all_p, tb.all_pni, tb.all_r1
    win = slice(lo, lo + rows)
    cat = lambda q, b: torch.cat([q[win], b], dim=0)
    return (
        ntt_mod.make_plan(tb.ctx.n, tb.ctx.data_primes[win] + tb.ctx.bsk_primes,
                          tb.ctx.device),
        cat(tb.q_p, tb.bsk_p),
        cat(tb.q_pni, tb.bsk_pni),
        (cat(tb.q_r1[0], tb.bsk_r1[0]), cat(tb.q_r1[1], tb.bsk_r1[1])),
    )


@functools.lru_cache(maxsize=None)
def conv_moduli(tb: BehzTables) -> torch.Tensor:
    """``[kb + 1, 1]``: the Bsk primes and m_tilde = 2**16, the moduli of
    :func:`_conv_partial`'s two sums stacked as rows (an all-reduce of
    them mod these is exact: see there)."""
    return torch.cat([tb.bsk_p, torch.full_like(tb.bsk_p[:1], _MTILDE)], dim=0)


# -- the steps (working format) ---------------------------------------------

def _canon(x, p):
    """[0, 2p) -> [0, p): one conditional subtract."""
    return x - (x >= p) * p


def _conv_partial(tb: BehzTables, x_q: torch.Tensor, lo: int = 0):
    """Step 1's sums over the q rows ``[lo, lo + r)`` of ``x_q``
    ``[..., r, N]`` (normal coefficients): ``(xs, xt)``, the Bsk sum
    ``[..., kb, N]`` in the lazy range [0, 2p) and the m_tilde sum
    ``[..., N]`` masked to 16 bits.  Sums over disjoint windows add up to
    the whole one's: ``xs`` modulo each Bsk prime (any representative:
    its one consumer reduces fully), ``xt`` modulo 2**16 (only its low 16
    bits are read, so a masked partial is a residue mod 2**16 and adds as
    one; it is never reduced mod a prime)."""
    win = slice(lo, lo + x_q.shape[-2])
    w, ws = tb.mtilde_qhinv
    y = modops.shoup_mul(x_q, w[win], ws[win], tb.q_p[win])
    # x*_j = sum_i y_i * (qhat_i mod p_j), p_j in Bsk — lazy terms and
    # tree; xs stays in [0, 2p): its only consumer is a Shoup product
    hw, hws = tb.qh_mod_bsk
    terms = modops.shoup_mul_lazy(
        y[..., :, None, :], hw[win], hws[win], tb.bsk_p
    )  # [..., r, kb, N]
    xs = modops.mod_sum_lazy(terms, tb.bsk_p, axis=-3)
    # x*_mtilde = sum_i y_i * (qhat_i mod 2^16): only the low 16 bits count
    xt = ((y & _MASK16) * tb.qh_mod_mtilde[win]).sum(dim=-2) & _MASK16
    return xs, xt


def _conv_finish(tb: BehzTables, xs: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Step 2 on the whole sums of :func:`_conv_partial`: the m_tilde
    Montgomery reduction, ``[..., kb, N]`` canonical.  Reads ``xt`` mod
    2**16 only and ``xs`` through Shoup products only, so any
    representative of either sum gives the same integers."""
    r = (xt * tb.neg_qinv_mtilde) & _MASK16  # = -alpha (mod m_tilde)
    flag = (r > _HALF_MTILDE)[..., None, :]
    r = r[..., None, :]
    out = modops.mod_add(
        modops.shoup_mul(xs, *tb.mtilde_inv_bsk, tb.bsk_p),
        modops.shoup_mul(r, *tb.q_mtilde_inv_bsk, tb.bsk_p),
        tb.bsk_p,
    )
    return modops.mod_sub(out, flag * tb.q_mod_bsk, tb.bsk_p)


def _conv_to_bsk_mtilde(tb: BehzTables, x_q: torch.Tensor) -> torch.Tensor:
    """x (normal coeff, [..., k, N] over q) -> x in Bsk, exactly (the
    m_tilde Montgomery reduction cancels the conversion overflow)."""
    return _conv_finish(tb, *_conv_partial(tb, x_q))


def _fbc_partial(tb: BehzTables, x_q: torch.Tensor, pair, lo: int = 0) -> torch.Tensor:
    """The plain fast base conversion's sum over the q rows ``[lo, lo +
    r)`` of ``x_q`` ``[..., r, N]``: ``[..., kb, N]`` in [0, 2p).  ``pair``
    is the Shoup constant of the qhat^-1 pre-multiply (``[k, 1]``, cut to
    the window here)."""
    win = slice(lo, lo + x_q.shape[-2])
    y = modops.shoup_mul(x_q, pair[0][win], pair[1][win], tb.q_p[win])
    hw, hws = tb.qh_mod_bsk
    terms = modops.shoup_mul_lazy(
        y[..., :, None, :], hw[win], hws[win], tb.bsk_p
    )
    return modops.mod_sum_lazy(terms, tb.bsk_p, axis=-3)


def _fbc_q_to_bsk(tb: BehzTables, x_q: torch.Tensor, pair) -> torch.Tensor:
    """Plain fast base conversion q -> Bsk (may carry +alpha*q, alpha < k,
    absorbed as noise by the surrounding floor).  ``pair`` is the Shoup
    constant of the qhat^-1 pre-multiply (``tb.t_qhinv``: the xt scaling
    rides it)."""
    # canonical: the caller subtracts it
    return _canon(_fbc_partial(tb, x_q, pair), tb.bsk_p)


def _sk_to_q(tb: BehzTables, y_bsk: torch.Tensor, lo: int = 0,
             rows: int = None) -> torch.Tensor:
    """Exact Shenoy-Kumaresan conversion of (possibly centered-negative)
    y [..., kb, N] over Bsk = B u {m_sk} into the q rows ``[lo, lo +
    rows)`` (default all k): [..., rows, N].  Reads all of Bsk, which
    every limb block holds, so a window needs no other block's rows."""
    win = slice(lo, lo + (tb.ctx.L if rows is None else rows))
    q_p = tb.q_p[win]
    ka = len(tb.ctx.aux_primes)
    y_B = y_bsk[..., :ka, :]
    y_msk = y_bsk[..., ka:, :]
    msk_p = tb.bsk_p[ka:]
    yp = modops.shoup_mul(y_B, *tb.Bh_inv, tb.bsk_p[:ka])
    # alpha = (sum_i y'_i * Bhat_i - y) / B recovered mod m_sk, centered
    terms_msk = modops.shoup_mul(yp, *tb.Bh_mod_msk, msk_p)
    conv_msk = modops.mod_sum(terms_msk[..., :, None, :], msk_p, axis=-3)
    alpha = modops.shoup_mul(
        modops.mod_sub(conv_msk, y_msk, msk_p), *tb.Binv_msk, msk_p
    )  # [..., 1, N] in [0, m_sk)
    flag = alpha > tb.half_msk
    bw, bws = tb.Bh_mod_q
    terms_q = modops.shoup_mul_lazy(
        yp[..., :, None, :], bw[:, win], bws[:, win], q_p
    )  # [..., ka, rows, N]
    s = _canon(modops.mod_sum_lazy(terms_q, q_p, axis=-3), q_p)
    alpha_term = modops.shoup_mul(
        modops.barrett_reduce_u32(alpha, q_p, tb.q_mu[win]),
        tb.B_mod_q[0][win],
        tb.B_mod_q[1][win],
        q_p,
    )
    out = modops.mod_sub(s, alpha_term, q_p)
    return modops.mod_add(out, flag * tb.msk_B_mod_q[win], q_p)


def _tensor(x, y, p, pni):
    """(x0,x1) (x) (y0,y1) dyadic; x Montgomery, y normal -> products
    normal.  Karatsuba: 3 Montgomery products instead of 4; the raw sums
    (< 2p) keep mont_mul exact since every prime is < 2**30.  Leading axes
    of x and y broadcast in the products; the sums run on each alone."""
    x0, x1 = x[..., 0, :, :], x[..., 1, :, :]
    y0, y1 = y[..., 0, :, :], y[..., 1, :, :]
    c0 = modops.mont_mul(x0, y0, p, pni)
    c2 = modops.mont_mul(x1, y1, p, pni)
    z = modops.mont_mul(x0 + x1, y0 + y1, p, pni)
    c1 = modops.mod_sub(modops.mod_sub(z, c0, p), c2, p)
    return torch.stack([c0, c1, c2], dim=-3)


def operands(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The two operands' distinct ciphertexts, each operand's own leading
    axes flattened, a's then b's on one leading axis: ``[Pa + Pb, 2, rows,
    N]``.  Nothing broadcasts here: the operands meet only in the tensor
    product's Karatsuba products (:func:`tensor_product`), so every step
    before them runs once per distinct polynomial."""
    flat = lambda x: x.reshape(-1, *x.shape[-3:])
    return torch.cat([flat(a), flat(b)], dim=0)


def to_coeff(ctx: BfvContext, tb: BehzTables, ab: torch.Tensor, lo: int = 0):
    """The operands' q rows ``[lo, lo + r)`` (NTT Montgomery) -> normal
    coefficients, working format: one inverse transform at ``lo``,
    ``from_mont``."""
    win = slice(lo, lo + ab.shape[-2])
    return modops.mont_mul(ctx.plan.inv(ab, lo=lo), 1, tb.q_p[win], tb.q_pni[win])


def tensor_product(tb: BehzTables, ab_q: torch.Tensor, ab_bsk: torch.Tensor,
                   leads, lo: int = 0) -> torch.Tensor:
    """Step 3 of the multiply on the q rows ``[lo, lo + r)`` and all of
    Bsk, as its inverse sweep leaves it: ``[..., 3, r + kb, N]`` storage
    over the operands' broadcast leading shape, normal coefficients, the
    window's q rows then Bsk.  ``ab_q`` and ``ab_bsk`` are in the layout
    of :func:`operands`, ``leads`` the two operands' own leading shapes.
    One forward sweep over the distinct operands and one inverse sweep
    over the products, both over the window's tensor base
    (:func:`window`); the operands broadcast only in :func:`_tensor`."""
    w = modops.wide
    plan, p, pni, r1 = window(tb, lo, ab_q.shape[-2])
    pa = math.prod(leads[0])
    x_all = torch.cat([ab_q, ab_bsk], dim=-2)  # [Pa + Pb, 2, r + kb, N]
    # Operand a enters Montgomery form (xR) so that the dyadic Montgomery
    # products land in normal form; operand b stays normal.
    x_all = torch.cat([modops.shoup_mul(x_all[:pa], *r1, p), x_all[pa:]], dim=0)
    ntt_all = w(plan.fwd(modops.narrow(x_all), lo=0))
    x, y = (part.reshape(*lead, *part.shape[1:])
            for part, lead in zip((ntt_all[:pa], ntt_all[pa:]), leads))
    return plan.inv(modops.narrow(_tensor(x, y, p, pni)), lo=0)


def floor_bsk(tb: BehzTables, prod_bsk: torch.Tensor, fbc: torch.Tensor):
    """Step 4: scale by t and floor-divide by q in Bsk, given the
    canonical fast base conversion ``fbc`` of the q-side product (times t)."""
    tc_bsk = modops.shoup_mul(prod_bsk, *tb.t_mod_bsk, tb.bsk_p)
    return modops.shoup_mul(
        modops.mod_sub(tc_bsk, fbc, tb.bsk_p), *tb.qinv_bsk, tb.bsk_p
    )


def to_ntt(ctx: BfvContext, tb: BehzTables, out_q: torch.Tensor, lo: int = 0):
    """The output's q rows ``[lo, lo + r)`` back to the at-rest NTT
    Montgomery form: the Montgomery entry and one forward transform."""
    win = slice(lo, lo + out_q.shape[-2])
    return ctx.plan.fwd(modops.narrow(modops.shoup_mul(
        out_q, tb.q_r1[0][win], tb.q_r1[1][win], tb.q_p[win])), lo=lo)


def floor_sk_plain(tb: BehzTables, prod: torch.Tensor) -> torch.Tensor:
    """The steps that ``csrc/behz.cu`` fuses, as the flat multiply runs them
    off the card: the tensor product ``[..., k + kb, N]`` (storage, as
    :func:`tensor_product` returns it) floored by q in Bsk, converted back
    to q and entered into Montgomery form, ``[..., k, N]`` storage, the
    output's forward sweep's input.  The kernel's oracle."""
    k, w = tb.ctx.L, modops.wide(prod)
    y = floor_bsk(tb, w[..., k:, :], _fbc_q_to_bsk(tb, w[..., :k, :], tb.t_qhinv))
    return modops.narrow(modops.shoup_mul(_sk_to_q(tb, y), *tb.q_r1, tb.q_p))


def bfv_multiply(ctx: BfvContext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
    """BFV ct-ct multiply (no relinearization): 3-component result.
    Leading batch axes of ``a`` and ``b`` broadcast.  The steps of a limb
    block (``parallel/limb.py:bfv_multiply``) at the window ``(0, k)``.
    On the card the steps from the tensor product's inverse sweep to the
    output's forward sweep are one kernel (``ops/cuda/behz.py``), equal bit
    for bit to the plain steps that run on the CPU."""
    tb = tables_for(ctx)
    if a.size != 2 or b.size != 2:
        raise NotImplementedError("bfv multiply expects size-2 inputs")
    # each step counted at its shape (utils/counters.py): P products over
    # k q limbs and kb Bsk primes; D distinct operand polynomials (as
    # stored, before they broadcast) and 3P product polynomials
    shape = torch.broadcast_shapes(a.data.shape, b.data.shape)
    P, k, n = math.prod(shape[:-3]), shape[-2], shape[-1]
    leads = (a.data.shape[:-3], b.data.shape[:-3])
    D = 2 * (math.prod(leads[0]) + math.prod(leads[1]))
    kb = len(ctx.bsk_primes)
    wide, store = modops.WIDE.itemsize, a.data.element_size()
    with counters.step("bfv_multiply", P, k, k, n, store):
        ab = operands(a.data, b.data)  # [Pa + Pb, 2, k, N]
        # the polynomials the operand side runs on, read from the tensor
        counters.note("behz.operand_polys", math.prod(ab.shape[:-2]), k, k, n, wide)
        # NTT Montgomery -> normal coefficients
        with counters.step("behz.to_coeff", D, k, k, n, wide):
            ab_q = to_coeff(ctx, tb, ab)
        with counters.step("behz.conv_q_bsk_mtilde", D, k, kb, n, wide):
            ab_bsk = _conv_to_bsk_mtilde(tb, ab_q)  # [Pa + Pb, 2, kb, N]
        with counters.step("behz.tensor_product", P, k + kb, k + kb, n, wide, D):
            prod = tensor_product(tb, ab_q, ab_bsk, leads)  # [..., 3, k + kb, N] storage
        if prod.is_cuda:
            # the floor, the conversion back to q and the Montgomery entry in
            # one kernel; its steps counted as the plain path counts them
            counters.note("behz.floor_q_bsk", 3 * P, k, kb, n, wide)
            counters.note("behz.sk_bsk_q", 3 * P, kb, k, n, wide)
            with counters.step("behz.fused_floor_sk", 3 * P, k + kb, k, n, store):
                out_q = behz_cuda.floor_sk(prod, tb)
            with counters.step("behz.to_ntt", 3 * P, k, k, n, store):
                out_ntt = ctx.plan.fwd(out_q)
        else:
            prod = modops.wide(prod)
            prod_q, prod_bsk = prod[..., :k, :], prod[..., k:, :]
            # scale by t, floor-divide by q (in Bsk), convert exactly back to q
            with counters.step("behz.floor_q_bsk", 3 * P, k, kb, n, wide):
                y_bsk = floor_bsk(tb, prod_bsk, _fbc_q_to_bsk(tb, prod_q, tb.t_qhinv))
            with counters.step("behz.sk_bsk_q", 3 * P, kb, k, n, wide):
                out_q = _sk_to_q(tb, y_bsk)
            with counters.step("behz.to_ntt", 3 * P, k, k, n, store):
                out_ntt = to_ntt(ctx, tb, out_q)
    return Ciphertext(data=out_ntt, level=ctx.L, scale=1.0, is_ntt=True)
