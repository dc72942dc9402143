"""Host-side exact reference implementations (oracles for kernel tests).

Everything here is slow-but-obviously-correct numpy/bignum math used to
validate the device kernels: negacyclic convolution, naive NTT evaluation,
and automorphisms.  int64 is safe for products of residues < 2**31.
"""

from __future__ import annotations

import numpy as np


def negacyclic_convolve(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    """Exact negacyclic product of two coefficient vectors mod p (O(N^2))."""
    n = a.shape[-1]
    a = a.astype(object)
    b = b.astype(object)
    out = np.zeros(n, dtype=object)
    for i in range(n):
        bi = b[i]
        if bi == 0:
            continue
        # X^i * a(X) mod (X^N + 1)
        out[i:] += a[: n - i] * bi
        out[:i] -= a[n - i:] * bi
    return (out % p).astype(np.uint32)


def naive_eval_ntt(x: np.ndarray, psi: int, p: int) -> np.ndarray:
    """Evaluations E[k] = x(psi^(2k+1)) for k = 0..N-1 (O(N^2) bignum)."""
    n = x.shape[-1]
    out = np.empty(n, dtype=np.uint32)
    for k in range(n):
        root = pow(psi, 2 * k + 1, p)
        acc = 0
        cur = 1
        for j in range(n):
            acc = (acc + int(x[j]) * cur) % p
            cur = cur * root % p
        out[k] = acc
    return out


def coeff_automorphism_ref(x: np.ndarray, g: int, p: int) -> np.ndarray:
    """y(X) = x(X^g) mod (X^N + 1), coefficient domain, exact."""
    n = x.shape[-1]
    y = np.zeros(n, dtype=np.int64)
    for i in range(n):
        j = (i * g) % (2 * n)
        if j < n:
            y[j] = (y[j] + int(x[i])) % p
        else:
            y[j - n] = (y[j - n] - int(x[i])) % p
    return y.astype(np.uint32)


def host_ntt(x: np.ndarray, psi: int, p: int) -> np.ndarray:
    """Fast host negacyclic NTT, same butterfly schedule as the device kernel
    (CT/DIT, natural input -> bit-reversed-evaluation output), int64 numpy.
    Leading batch axes broadcast (one call transforms a whole batch).
    """
    n = x.shape[-1]
    lead = x.shape[:-1]
    x = x.astype(np.int64).copy()
    roots = _root_table(psi, p, n)
    m, t = 1, n // 2
    while m < n:
        xv = x.reshape(lead + (m, 2, t))
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        w = roots[m : 2 * m].reshape(m, 1).astype(np.int64)
        tv = v * w % p
        x = np.concatenate(
            [(u + tv) % p, (u - tv) % p], axis=-1
        ).reshape(lead + (n,))
        m, t = m * 2, t // 2
    return x.astype(np.uint32)


def host_intt(x: np.ndarray, psi: int, p: int) -> np.ndarray:
    """Inverse of :func:`host_ntt` (GS/DIF, bit-reversed input -> natural)."""
    n = x.shape[-1]
    lead = x.shape[:-1]
    x = x.astype(np.int64).copy()
    roots = _root_table(psi, p, n)
    inv_roots = np.array([pow(int(r), -1, p) for r in roots], dtype=np.int64)
    m = n // 2
    t = 1
    while m >= 1:
        xv = x.reshape(lead + (m, 2, t))
        u = xv[..., 0, :]
        v = xv[..., 1, :]
        w = inv_roots[m : 2 * m].reshape(m, 1)
        x = np.concatenate(
            [(u + v) % p, (u - v) * w % p], axis=-1
        ).reshape(lead + (n,))
        m, t = m // 2, t * 2
    n_inv = pow(n, -1, p)
    return (x * n_inv % p).astype(np.uint32)


def _bitrev(i: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (i & 1)
        i >>= 1
    return out


def _root_table(psi: int, p: int, n: int) -> np.ndarray:
    """roots[i] = psi^bitrev(i) over log2(n) bits (the CT twiddle table)."""
    bits = n.bit_length() - 1
    return np.array(
        [pow(psi, _bitrev(i, bits), p) for i in range(n)], dtype=np.uint32
    )
