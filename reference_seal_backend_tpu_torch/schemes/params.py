"""Encryption parameters and contexts for the CKKS and BFV schemes.

Counterpart of ``reference_seal_backend_tpu/schemes/params.py``:

* RNS primes are all < 2**31 and NTT-friendly (p = 1 mod 2N) so residues
  fit the uint32 Montgomery core (ops/modops.py).  The chain is
  ``[q0, q1, scale primes..., special]`` out of ~30-bit primes.
* CKKS keeps **two** bottom primes at the minimum level: together they give
  ~60 bits of decode headroom.  Each rescale drops one prime group;
  ``depth`` rescales are supported.
* The last primes in the stack are the key-switch **special modulus**
  (hybrid key switching); ciphertext data never lives there.

A context owns the NTT plan over the full prime stack and every cross-limb
constant the evaluator needs (Barrett mu, divisor inverses in one- and
two-Montgomery form, centered-lift corrections), all precomputed host-side
once and stored as tensors on the context's ``device``, shaped ``[L, 1]`` /
``[L, L]`` for broadcast against limb-major data.  Only the evaluator's
chains read them, so they are held in the working format of
``ops/modops.py`` (its format rule); the NTT plan keeps its own tables in
the kernel's storage format.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple
from dataclasses import dataclass

import numpy as np
import torch

from reference_seal_backend_tpu_torch.nums import primegen
from reference_seal_backend_tpu_torch.ops import ntt as ntt_mod
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.utils.device import pick_device

# HE-standard (homomorphicencryption.org Security Standard v1.1, Table 1,
# ternary secret, classical 128-bit) maximum total coeff-modulus bits per
# polynomial degree — the same table SEAL enforces through
# ``CoeffModulus::MaxBitCount(n, sec_level_type::tc128)``.  The reference
# constructs every context with that enforcement on
# (reference-seal-backend src/engine/seal_context.cpp:89-90, 118-119:
# ``std::make_shared<seal::SEALContext>(parameters, true, sec_level)``)
# and SEAL refuses parameter sets whose modulus exceeds the bound.
HE_STD_128_CLASSICAL: Dict[int, int] = {
    1024: 27,
    2048: 54,
    4096: 109,
    8192: 218,
    16384: 438,
    32768: 881,
}


def max_coeff_bits_128(n: int) -> int:
    """Max total coeff-modulus bits for 128-bit classical security at
    degree ``n`` (0 when the degree is below the standard's table — no
    parameter set at that degree is considered secure)."""
    return HE_STD_128_CLASSICAL.get(n, 0 if n < 32768 else HE_STD_128_CLASSICAL[32768])


class InsecureParametersError(ValueError):
    """Parameter set violates the requested HE-standard security level
    (the analogue of SEAL's invalid-parameters failure under tc128)."""


@dataclass(frozen=True)
class CkksParams:
    """User-facing CKKS parameters (analogue of the workload params the
    reference registers per benchmark, SURVEY.md §2.2 table).

    ``scale_bits`` is the *total* scale; each rescale level is backed by
    ``rescale_group`` primes of ~scale_bits/rescale_group bits whose product
    approximates 2**scale_bits (composite rescaling).  With all primes
    < 2**31 (uint32 arithmetic), a group of 2 reproduces the precision
    of SEAL's 40-52-bit scale primes.
    """

    poly_modulus_degree: int = 8192
    mult_depth: int = 2
    scale_bits: int = 52
    rescale_group: int = 2
    # extra bottom primes beyond the rescale chain: 2 gives ~62-bit decode
    # headroom like SEAL's 60-bit q0.
    bottom_primes: int = 2
    # HE-standard security enforcement: 128 refuses parameter sets above
    # the classical-128-bit modulus bound (like SEALContext under tc128,
    # reference-seal-backend src/engine/seal_context.cpp:89-90); 0 disables the
    # check for small test configs (SEAL's sec_level_type::none).
    sec_level: int = 128
    # Key-switch digit grouping (Context docstring): None = auto — use
    # G=2 with a 2-prime special modulus whenever the HE-standard budget
    # admits the extra prime (and the chain has >= 4 data limbs),
    # else G=1.  Explicit G is honored as given (G special primes).
    digit_group: Optional[int] = None


@dataclass(frozen=True)
class BfvParams:
    poly_modulus_degree: int = 8192
    mult_depth: int = 2
    plain_modulus_bits: int = 20
    # data primes sized for noise budget; ~30-bit each.
    n_data_primes: int = 4
    sec_level: int = 128  # see CkksParams.sec_level
    digit_group: Optional[int] = None  # see CkksParams.digit_group


def _stack_consts(primes, key) -> np.ndarray:
    return np.array(
        [[modops.mont_consts(p)[key]] for p in primes], dtype=np.uint32
    )


class Context:
    """Shared RNS machinery for one (scheme, parameter set) instance.

    ``primes = data_primes + special_primes``; ciphertext level ``l`` means
    the first ``l`` data primes are live.  All constant tables are indexed
    [divisor d, target j] where applicable.

    **Digit-grouped hybrid key switching** (``digit_group`` = G): the
    key-switch digit decomposition groups G consecutive data limbs per
    digit (digit i covers limbs [iG, (i+1)G)), with the special modulus
    P = Π special_primes sized to G primes so the noise ratio ‖digit‖/P
    stays ~1.  This is the decomposition-count trade SEAL exposes in its
    key-switching keys (the reference leans on it everywhere,
    reference-seal-backend src/engine/seal_context.cpp:46-70 keygen +
    evaluator key-switch calls): G=2 halves the digit count and with it
    the dominant O(l·(l+ns)) lift-NTT and inner-product cost per switch,
    at the price of one extra 30-bit prime in the RLWE modulus (counted
    against the HE-standard bound below).
    """

    def __init__(self, scheme: str, n: int, data_primes: Tuple[int, ...],
                 special_primes, sec_level: int = 128,
                 digit_group: int = 1, device=None):
        self.scheme = scheme
        self.device = pick_device(device)
        self.n = n
        self.data_primes = tuple(data_primes)
        if isinstance(special_primes, int):
            special_primes = (special_primes,)
        self.special_primes = tuple(special_primes)
        self.special_prime = self.special_primes[0]
        self.n_special = len(self.special_primes)
        self.primes = self.data_primes + self.special_primes
        self.L = len(self.data_primes)
        self.digit_group = int(digit_group)
        if self.digit_group < 1:
            raise ValueError("digit_group must be >= 1")
        self._digit_tables: Dict[int, tuple] = {}
        # HE-standard security accounting over the FULL modulus q ∪ {P}:
        # key-switching keys are RLWE samples mod q·P, so the special
        # modulus counts exactly as SEAL counts its key prime.  (BFV's
        # BEHZ auxiliary base is a transient computation base, never a
        # ciphertext modulus, and does not count.)
        self.total_coeff_bits = sum(p.bit_length() for p in self.primes)
        self.max_secure_bits = max_coeff_bits_128(n)
        self.secure_128 = self.total_coeff_bits <= self.max_secure_bits
        self.sec_level = sec_level
        if sec_level == 128 and not self.secure_128:
            raise InsecureParametersError(
                f"total coeff modulus {self.total_coeff_bits} bits exceeds "
                f"the HE-standard 128-bit classical bound "
                f"{self.max_secure_bits} for N={n}; pass sec_level=0 to "
                f"build an insecure test context"
            )
        elif sec_level not in (0, 128):
            raise ValueError("sec_level must be 128 (enforced) or 0 (off)")
        self.plan = ntt_mod.make_plan(n, self.primes, self.device)
        self.sp_row = self.L  # row index of the special modulus

        P = self.primes
        nf = len(P)
        put = self._put
        # Per-limb Montgomery/Barrett constants, [nf, 1].
        self.p = put(_stack_consts(P, "p"))
        self.p_neg_inv = put(_stack_consts(P, "p_neg_inv"))
        self.mu = put(_stack_consts(P, "mu"))
        self.r2 = put(_stack_consts(P, "r2"))
        self.r1 = put(_stack_consts(P, "r1"))

        # Cross-limb divisor tables for divide-and-round (rescale, key-switch
        # mod-down, BFV mod-switch), as Shoup pairs (modops.shoup_mul):
        #   div_mod[d, j]      = P_d mod q_j   (for centered-lift fixup)
        #   div_half[d]        = P_d // 2      (centering threshold)
        #   div_inv[d, j]      = P_d^{-1} mod q_j            (plain — for
        #                        multiplying Montgomery-form data)
        #   div_inv_mont[d, j] = (P_d^{-1} mod q_j)·R mod q_j (for lifting
        #                        normal-form w into Montgomery form)
        # with *_shoup the floor(w·2^32/p) companions.
        R = 1 << 32
        inv0 = np.zeros((nf, nf), dtype=np.uint32)
        inv1 = np.zeros((nf, nf), dtype=np.uint32)
        inv0_s = np.zeros((nf, nf), dtype=np.uint32)
        inv1_s = np.zeros((nf, nf), dtype=np.uint32)
        dmod = np.zeros((nf, nf), dtype=np.uint32)
        for d, pd in enumerate(P):
            for j, pj in enumerate(P):
                if d == j:
                    continue
                iv = pow(pd, -1, pj)
                inv0[d, j] = iv
                inv1[d, j] = iv * R % pj
                inv0_s[d, j] = (iv << 32) // pj
                inv1_s[d, j] = ((iv * R % pj) << 32) // pj
                dmod[d, j] = pd % pj
        self.div_inv = put(inv0)
        self.div_inv_shoup = put(inv0_s)
        self.div_inv_mont = put(inv1)
        self.div_inv_mont_shoup = put(inv1_s)
        self.div_mod = put(dmod)
        self.div_half = put(
            np.array([p // 2 for p in P], dtype=np.uint32)
        )

    # -- helpers ------------------------------------------------------------

    def _put(self, arr: np.ndarray) -> torch.Tensor:
        """numpy uint32 table -> working-format constant on the device."""
        return modops.wide(modops.from_numpy(arr, self.device))

    def consts(self, lo: int, nl: int):
        """(p, p_neg_inv) slices for limbs [lo, lo+nl), shape [nl, 1]."""
        return (
            self.p[lo : lo + nl],
            self.p_neg_inv[lo : lo + nl],
        )

    def q_at_level(self, level: int) -> int:
        q = 1
        for p in self.data_primes[:level]:
            q *= p
        return q

    # -- digit grouping (hybrid key-switch decomposition) --------------------

    def dig_count(self, level: int) -> int:
        """Number of live key-switch digits at ``level`` live limbs."""
        return -(-level // self.digit_group)

    def digit_tables(self, level: int):
        """Host-precomputed lift constants for grouped digit decomposition
        at ``level`` live limbs (cached; only used when digit_group > 1).

        Returns (ihat, W, Ws):
          ihat[k, 1]    = (Q_g/q_k)^{-1} mod q_k  (plain constant; one
                          mont_mul takes Montgomery-form d_k to the normal
                          form of d_k·ihat_k — replacing the from_mont of
                          the ungrouped path at the same cost)
          W[k, t, 1]    = (Q_g/q_k) mod p_t  over targets t ∈ live ∪ special
          Ws[k, t, 1]   = Shoup companion floor(W·2^32 / p_t)

        where g = k // digit_group and Q_g = Π of group g's LIVE primes.
        The grouped digit lifted to target t is then
        Σ_{k ∈ group g} shoup_mul(barrett(d_k·ihat_k, p_t), W[k,t]) —
        the fast-base-conversion representative D̃_g ≡ d mod Q_g with
        D̃_g < G·Q_g, whose extra multiples of Q_g only add bounded
        rounding noise through the mod-down (standard hybrid/RNS gadget
        analysis).
        """
        if level not in self._digit_tables:
            G = self.digit_group
            l = level
            targets = list(range(l)) + list(
                range(self.L, self.L + self.n_special)
            )
            ihat = np.ones((l, 1), dtype=np.uint32)
            W = np.zeros((l, len(targets), 1), dtype=np.uint32)
            Ws = np.zeros((l, len(targets), 1), dtype=np.uint32)
            for k in range(l):
                g0 = (k // G) * G
                members = range(g0, min(g0 + G, l))
                qk = self.primes[k]
                Qk = 1  # Q_g / q_k over live members
                for m in members:
                    if m != k:
                        Qk *= self.primes[m]
                ihat[k, 0] = pow(Qk % qk, -1, qk)
                for ti, tr in enumerate(targets):
                    pt = self.primes[tr]
                    w = Qk % pt
                    W[k, ti, 0] = w
                    Ws[k, ti, 0] = (w << 32) // pt
            put = self._put
            self._digit_tables[level] = (put(ihat), put(W), put(Ws))
        return self._digit_tables[level]

    def p5_order(self):
        """Power-of-5 evaluation-order permutation for the rotation group
        ⟨5⟩ ⊂ Z_2N^*: ordering the N evaluation points as the two
        ⟨5⟩-orbits (± classes), φ_{5^s} becomes a cyclic shift by s within
        each orbit (evaluator/eval.py rotate_sum exploits this).

        Returns (P_np, P_dev, Q_dev) with x_p5 = x[..., P], x = x_p5[..., Q].
        Built by orbit traversal of plan.galois_perm(5) so it is consistent
        with the NTT storage order by construction.
        """
        key = "p5"
        if key not in self._digit_tables:
            n = self.n
            half = n // 2
            perm5 = self.plan.galois_perm_np(5)
            P = np.empty(n, dtype=np.int64)
            P[0] = 0
            for j in range(1, half):
                P[j] = perm5[P[j - 1]]
            seen = np.zeros(n, dtype=bool)
            seen[P[:half]] = True
            P[half] = int(np.argmin(seen))  # first index of the - orbit
            for j in range(1, half):
                P[half + j] = perm5[P[half + j - 1]]
            Q = np.empty(n, dtype=np.int64)
            Q[P] = np.arange(n)
            self._digit_tables[key] = (
                P,
                torch.from_numpy(P).to(self.device),
                torch.from_numpy(Q).to(self.device),
            )
        return self._digit_tables[key]

    def moddown_tables(self, level: int):
        """Host-precomputed constants for the single-shot fast-base-
        conversion mod-down by the multi-prime P (used when n_special > 1;
        evaluator/eval.py _mod_down_special):

          ihat[s, 1]     = (P/p_s)^{-1} mod p_s  (plain; one mont_mul takes
                           the Montgomery special residue to y_s normal)
          W[s, j, 1]     = (P/p_s) mod q_j  over live targets j < level
          invP[j, 1]     = P^{-1} mod q_j          (for Montgomery x)
          invPm[j, 1]    = (P^{-1} mod q_j)·R      (for normal-form u)

        each with its Shoup companion.  The FBC representative
        u = Σ_s y_s·(P/p_s) ≡ x (mod P) lies in [0, ns·P); skipping the
        exact centering costs < ns units of additive rounding noise in
        round(x/P) — negligible against the key-switch noise itself —
        and saves a full (l+1)-row NTT sweep per peeled prime.
        """
        key = ("md", level)
        if key not in self._digit_tables:
            l = level
            ns = self.n_special
            P = 1
            for sp in self.special_primes:
                P *= sp
            ihat = np.ones((ns, 1), dtype=np.uint32)
            W = np.zeros((ns, l, 1), dtype=np.uint32)
            Ws = np.zeros((ns, l, 1), dtype=np.uint32)
            invP = np.zeros((l, 1), dtype=np.uint32)
            invPs = np.zeros((l, 1), dtype=np.uint32)
            invPm = np.zeros((l, 1), dtype=np.uint32)
            invPms = np.zeros((l, 1), dtype=np.uint32)
            R = 1 << 32
            for s in range(ns):
                ps = self.special_primes[s]
                Ps = P // ps
                ihat[s, 0] = pow(Ps % ps, -1, ps)
                for j in range(l):
                    qj = self.primes[j]
                    w = Ps % qj
                    W[s, j, 0] = w
                    Ws[s, j, 0] = (w << 32) // qj
            for j in range(l):
                qj = self.primes[j]
                iv = pow(P % qj, -1, qj)
                invP[j, 0] = iv
                invPs[j, 0] = (iv << 32) // qj
                ivm = iv * R % qj
                invPm[j, 0] = ivm
                invPms[j, 0] = (ivm << 32) // qj
            self._digit_tables[key] = tuple(
                self._put(t)
                for t in (ihat, W, Ws, invP, invPs, invPm, invPms)
            )
        return self._digit_tables[key]


def _resolve_digit_group(requested, sec_level: int, n: int, gen):
    """Resolve the key-switch digit grouping for a scheme context.

    ``gen(ns) -> (data_primes, special_primes)`` generates the chain with
    ``ns`` special primes.  ``requested`` None = auto: climb a G ladder
    (1 -> 2 -> 3 -> 4), upgrading only when the NTT-row model

        R(G) = ceil(l/G)·(l+G) + 2l + G

    (digit-lift forward rows + digit iNTT + mod-down sweeps) improves by
    > 20% over the incumbent.  The ladder and its margin are the
    reference's, kept unchanged so both packages build identical chains
    (l=6 -> G=2, l=14 -> G=3); they have not been re-tuned for a GPU.
    Upgrades are gated on feasibility, checked on the EXACT generated
    chains:

      * the chain with G special primes fits the HE-standard 128-bit
        bound (sec-128 contexts only upgrade when secure);
      * ceil(l/G) >= 2 — a single digit is no decomposition (noise ∝ Q/P
        blows up);
      * every digit group's product <= P = Π specials (the standard
        hybrid key-switch noise condition).

    Auto mode only upgrades production (sec-128) contexts: tiny
    sec_level=0 test chains keep the ungrouped layout unless a test opts
    in explicitly.  An explicit ``requested`` G is honored as given with
    G special primes (Context's security check still applies and may
    refuse it).
    """
    if requested is not None:
        G = int(requested)
        data, specials = gen(max(G, 1))
        return G, data, specials
    best = (1,) + gen(1)
    if sec_level != 128:
        return best
    cap = max_coeff_bits_128(n)
    R = lambda l, G: -(-l // G) * (l + G) + 2 * l + G
    for G in (2, 3, 4):
        data, specials = gen(G)
        l = len(data)
        if -(-l // G) < 2:
            continue
        if sum(p.bit_length() for p in data + specials) > cap:
            continue
        P = 1
        for p in specials:
            P *= p
        if any(_prod(data[g0 : g0 + G]) > P for g0 in range(0, l, G)):
            continue
        if R(len(best[1]), best[0]) > 1.2 * R(l, G):
            best = (G, data, specials)
    return best


def _prod(ps):
    q = 1
    for p in ps:
        q *= p
    return q


class CkksContext(Context):
    def __init__(self, params: CkksParams, device=None):
        n = params.poly_modulus_degree
        two_n = 2 * n
        g = params.rescale_group
        if params.scale_bits // g > 30:
            raise ValueError("per-prime scale bits must be <= 30")

        # Special/bottom primes large (near 2^30) for headroom; scale primes
        # nearest 2^(scale_bits/g), alternating above/below so each group's
        # product stays close to 2^scale_bits.  The 30-bit cap (not 31)
        # keeps every plan on the Harvey lazy-reduction NTT path
        # (ops/ntt.py: butterfly values in [0,4p) need 4p < 2^32).
        def gen(ns: int):
            big = primegen.gen_ntt_primes(
                params.bottom_primes + ns, 30, two_n
            )
            specials = tuple(big[:ns])
            bottom = tuple(big[ns:])
            scale_primes = tuple(
                primegen.gen_primes_near(
                    params.mult_depth * g, params.scale_bits // g, two_n,
                    avoid=tuple(big),
                )
            )
            # Chain order: bottom primes first (never dropped), then scale
            # primes (dropped in groups of g, last-first, by rescale).
            return bottom + scale_primes, specials

        G, data, specials = _resolve_digit_group(
            params.digit_group, params.sec_level, n, gen
        )
        super().__init__(
            "ckks", n, data, specials, params.sec_level, G, device
        )
        self.params = params
        self.scale = float(2 ** params.scale_bits)
        self.rescale_group = g
        self.min_level = params.bottom_primes
        self.slots = n // 2

    @property
    def max_level(self) -> int:
        return self.L


class BfvContext(Context):
    def __init__(self, params: BfvParams, device=None):
        n = params.poly_modulus_degree
        two_n = 2 * n
        t = primegen.gen_primes_near(
            1, params.plain_modulus_bits, two_n
        )[0]

        # 30-bit cap: see CkksContext (Harvey lazy-reduction NTT path).
        def gen(ns: int):
            big = primegen.gen_ntt_primes(
                ns + params.n_data_primes, 30, two_n, avoid=(t,)
            )
            return tuple(big[ns:]), tuple(big[:ns])

        G, data, specials = _resolve_digit_group(
            params.digit_group, params.sec_level, n, gen
        )
        super().__init__(
            "bfv", n, data, specials, params.sec_level, G, device
        )
        self.params = params
        self.t = t
        q = self.q_at_level(self.L)
        self.q = q
        self.delta = q // t  # floor(q/t), the plaintext scaling factor
        # Delta mod q_j as a Shoup pair, [L, 1] — scales encoded m.
        self.delta_plain = self._put(
            np.array([[self.delta % p] for p in data], dtype=np.uint32)
        )
        self.delta_shoup = self._put(
            np.array(
                [[((self.delta % p) << 32) // p] for p in data],
                dtype=np.uint32,
            )
        )
        self.slots = n
        # Auxiliary BEHZ bases for ct-ct multiply: B = k+1 30-bit primes
        # (one more than q so B >> q gives Shenoy-Kumaresan headroom with
        # same-width primes), plus m_sk; all NTT-friendly, distinct from
        # q u {special}.
        aux = primegen.gen_ntt_primes(
            self.L + 2, 30, two_n, avoid=self.primes + (t,)
        )
        self.aux_primes = tuple(aux[: self.L + 1])  # base B
        self.m_sk = aux[self.L + 1]
        self.bsk_primes = self.aux_primes + (self.m_sk,)
        self.bsk_plan = ntt_mod.make_plan(n, self.bsk_primes, self.device)


@functools.lru_cache(maxsize=None)
def _make_ckks_context(params: CkksParams, device: torch.device) -> CkksContext:
    return CkksContext(params, device)


def make_ckks_context(
    poly_modulus_degree: int = 8192,
    mult_depth: int = 2,
    scale_bits: int = 52,
    rescale_group: int = 2,
    bottom_primes: int = 2,
    sec_level: int = 128,
    digit_group: Optional[int] = None,
    device=None,
) -> CkksContext:
    """Build (and cache per parameter set and device) a CKKS context.
    ``device`` defaults to the card; pass ``"cpu"`` to run on the CPU."""
    return _make_ckks_context(
        CkksParams(
            poly_modulus_degree,
            mult_depth,
            scale_bits,
            rescale_group,
            bottom_primes,
            sec_level,
            digit_group,
        ),
        pick_device(device),
    )


@functools.lru_cache(maxsize=None)
def _make_bfv_context(params: BfvParams, device: torch.device) -> BfvContext:
    return BfvContext(params, device)


def make_bfv_context(
    poly_modulus_degree: int = 8192,
    mult_depth: int = 2,
    plain_modulus_bits: int = 20,
    n_data_primes: int = 4,
    sec_level: int = 128,
    digit_group: Optional[int] = None,
    device=None,
) -> BfvContext:
    """Build (and cache per parameter set and device) a BFV context.
    ``device`` defaults to the card; pass ``"cpu"`` to run on the CPU."""
    return _make_bfv_context(
        BfvParams(
            poly_modulus_degree,
            mult_depth,
            plain_modulus_bits,
            n_data_primes,
            sec_level,
            digit_group,
        ),
        pick_device(device),
    )


def context_on(ctx: Context, device) -> Context:
    """The context of ``ctx``'s parameters with its tables on ``device``
    (the same primes, so the same integers; cached as the factories
    cache).  ``ctx`` itself when it lives there."""
    dev = pick_device(device)
    if dev == ctx.device:
        return ctx
    make = {CkksContext: _make_ckks_context, BfvContext: _make_bfv_context}
    return make[type(ctx)](ctx.params, dev)
