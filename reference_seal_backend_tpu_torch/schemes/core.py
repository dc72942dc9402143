"""Core HE data containers and host<->device RNS conversion.

Counterpart of ``reference_seal_backend_tpu/schemes/core.py``: the same
containers as frozen dataclasses over int32-stored uint32 tensors
(ops/modops.py), and the same numpy RNS/CRT host helpers.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import numpy as np
import torch


@dataclass(frozen=True)
class Ciphertext:
    """RLWE ciphertext: ``data[size, level, N]`` residues.

    ``size`` is the number of polynomial components (2 fresh, 3 after an
    unrelinearized multiply).  CKKS ciphertexts are stored NTT-domain
    Montgomery form at rest (is_ntt=True).  Leading batch axes may precede
    ``size``.
    """

    data: torch.Tensor
    level: int = 0
    scale: float = 1.0
    is_ntt: bool = True

    @property
    def size(self) -> int:
        return self.data.shape[-3]

    def to(self, device) -> "Ciphertext":
        return replace(self, data=self.data.to(device))


@dataclass(frozen=True)
class Plaintext:
    """Encoded plaintext: ``data[level, N]`` residues (same domain
    conventions as Ciphertext for the owning scheme)."""

    data: torch.Tensor
    level: int = 0
    scale: float = 1.0
    is_ntt: bool = True

    def to(self, device) -> "Plaintext":
        return replace(self, data=self.data.to(device))


def int_poly_to_rns(coeffs: np.ndarray, primes: Tuple[int, ...]) -> np.ndarray:
    """Signed integer coefficients -> uint32 residue rows [L, N] (host)."""
    if coeffs.dtype == object:
        out = np.stack(
            [(coeffs % p).astype(np.uint64).astype(np.uint32) for p in primes]
        )
    else:
        c = coeffs.astype(np.int64)
        out = np.stack(
            [(c % np.int64(p)).astype(np.uint32) for p in primes]
        )
    return out


def rns_to_mont(res: np.ndarray, primes: Tuple[int, ...]) -> np.ndarray:
    """uint32 residues [L, N] -> Montgomery form (host)."""
    return np.stack(
        [
            ((res[i].astype(np.uint64) << 32) % np.uint64(p)).astype(
                np.uint32
            )
            for i, p in enumerate(primes)
        ]
    )


def mont_to_rns(res: np.ndarray, primes: Tuple[int, ...]) -> np.ndarray:
    """Montgomery-form residues ``[..., L, N]`` -> standard residues; the
    limb axis is second-to-last, leading batch axes broadcast."""
    out = []
    for i, p in enumerate(primes):
        rinv = pow(1 << 32, -1, p)
        out.append(
            (
                res[..., i, :].astype(np.uint64)
                * np.uint64(rinv)
                % np.uint64(p)
            ).astype(np.uint32)
        )
    return np.stack(out, axis=-2)


def crt_compose_centered(res: np.ndarray, primes: Tuple[int, ...]) -> np.ndarray:
    """CRT-compose residue rows ``[..., L, N]`` into centered bigints
    (object array, shape ``[..., N]``).

    Host-side exact reconstruction used by decrypt/decode; q = prod(primes).
    Leading batch axes broadcast.
    """
    q = 1
    for p in primes:
        q *= p
    acc = np.zeros(res.shape[:-2] + res.shape[-1:], dtype=object)
    for i, p in enumerate(primes):
        qi = q // p
        ei = qi * pow(qi % p, -1, p)  # CRT idempotent
        acc += res[..., i, :].astype(object) * ei
    acc %= q
    return np.where(acc > q // 2, acc - q, acc)
