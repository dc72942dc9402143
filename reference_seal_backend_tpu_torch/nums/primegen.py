"""NTT-friendly prime generation and roots of unity (host side, exact).

The reference backend delegates parameter construction to SEAL
(``seal::CoeffModulus::Create``, used from reference-seal-backend
src/engine/seal_context.cpp:79-90,107-119).  We generate our own RNS primes,
constrained for the uint32 arithmetic core: every prime ``p`` satisfies

* ``p < 2**31`` so a Montgomery product with ``R = 2**32`` fits uint32
  intermediates (see ops/modops.py),
* ``p ≡ 1 (mod 2N)`` so a primitive 2N-th root of unity exists (negacyclic
  NTT over Z_p),
* optionally ``p ≡ 1 (mod m)`` for extra congruences (BFV plain modulus
  batching needs ``t ≡ 1 (mod 2N)`` as well).

All arithmetic here is host-side Python bignum — it runs once per context.
"""

from __future__ import annotations

from typing import List

# Deterministic Miller-Rabin bases valid for all n < 3.3e24 (covers 64-bit).
_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    for p in _MR_BASES:
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x == 1 or x == n - 1:
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def gen_ntt_primes(
    n_primes: int,
    bits: int,
    two_n: int,
    avoid: tuple[int, ...] = (),
    below: bool = True,
) -> List[int]:
    """Return ``n_primes`` distinct primes p ≡ 1 (mod two_n), p < 2**31.

    Primes are searched downward from ``2**bits`` when ``below`` else upward,
    stepping by ``two_n`` to preserve the congruence.
    """
    if bits > 31:
        raise ValueError("limb primes must fit below 2**31")
    avoid_set = set(avoid)
    out: List[int] = []
    step = -two_n if below else two_n
    # Largest candidate ≡ 1 (mod two_n) at/below 2**bits.
    cand = (2**bits // two_n) * two_n + 1
    if cand > 2**bits:
        cand -= two_n
    while len(out) < n_primes:
        if cand < two_n or cand >= 2**31:
            raise RuntimeError("prime search ran out of range")
        if cand not in avoid_set and is_prime(cand):
            out.append(cand)
            avoid_set.add(cand)
        cand += step
    return out


def gen_primes_near(
    n_primes: int,
    bits: int,
    two_n: int,
    avoid: tuple[int, ...] = (),
) -> List[int]:
    """``n_primes`` primes p ≡ 1 (mod two_n) closest to 2**bits (p < 2**31).

    Alternates above/below the target so products of consecutive primes stay
    close to powers of the target — keeps CKKS scale drift minimal without
    ever forcing scales (the reference instead forces scales and eats the
    error, e.g. reference-seal-backend src/engine/seal_context.cpp:449).
    """
    target = 2**bits
    avoid_set = set(avoid)
    out: List[int] = []
    k = 0
    base = (target // two_n) * two_n + 1
    while len(out) < n_primes:
        k += 1
        for cand in (base + k * two_n, base - k * two_n):
            if (
                len(out) < n_primes
                and two_n < cand < 2**31
                and cand not in avoid_set
                and is_prime(cand)
            ):
                out.append(cand)
                avoid_set.add(cand)
        if k > 2**20:
            raise RuntimeError("prime search exhausted")
    return out


def primitive_root(p: int) -> int:
    """Smallest generator of Z_p^* (p prime)."""
    fac = _factor(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // q, p) != 1 for q in fac):
            return g
    raise RuntimeError("no primitive root found")


def root_of_unity(order: int, p: int) -> int:
    """A primitive ``order``-th root of unity mod p (requires order | p-1)."""
    if (p - 1) % order != 0:
        raise ValueError(f"{order} does not divide p-1 for p={p}")
    g = primitive_root(p)
    w = pow(g, (p - 1) // order, p)
    assert pow(w, order, p) == 1 and pow(w, order // 2, p) == p - 1
    return w


def min_root_of_unity(order: int, p: int) -> int:
    """The *smallest* primitive order-th root (deterministic across runs)."""
    w = root_of_unity(order, p)
    best = None
    cur = w
    for k in range(1, order):
        if _gcd(k, order) == 1:
            if best is None or cur < best:
                best = cur
        cur = cur * w % p
    assert best is not None
    return best


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _factor(n: int) -> List[int]:
    fac = []
    d = 2
    while d * d <= n:
        if n % d == 0:
            fac.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        fac.append(n)
    return fac
