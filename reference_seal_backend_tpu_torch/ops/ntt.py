"""Negacyclic NTT/iNTT over RNS limbs: plan tables, dispatch and the plain
PyTorch version.

Counterpart of ``reference_seal_backend_tpu/ops/ntt.py``.  Layout: residue
polynomials are int32-stored uint32 ``[..., L, N]`` (ops/modops.py),
limb-major; the transform is Montgomery/normal-form agnostic.  Twiddle
multiplies use Shoup's precomputed-constant trick with ``(w, w_shoup)``
tables built host side per (prime, N).

Forward: Cooley-Tukey, natural coefficient order in, bit-reversed
evaluation order out (``out[bitrev(k)] = x(psi^(2k+1))``).  Inverse:
Gentleman-Sande, exactly undoing the forward stages, with the final
``N^-1`` scale folded into one Shoup multiply.  Galois automorphisms are
index permutations in this order (:meth:`NttPlan.galois_perm`).

The reference's four-step ``[n1, 128]`` layout and its lane-expanded
twiddle planes are layout devices of its target; they change no integer.
Here the tables are the compact ``[L, N]`` bit-reversed root tables, the
plain version is the flat stage loop, and on a CUDA tensor the transform
is the hand-written kernel of ``ops/cuda/ntt.py`` — the only way the NTT
runs on the card.  The plain version runs for CPU tensors, and wherever a
caller names it (:meth:`NttPlan.fwd_plain`) to hold the kernel against it.

Range contract (Harvey lazy reduction, on when every prime is below
``2**30``): forward inputs may lie in ``[0, 2p)``; ``epilogue=False``
returns the exact ``[0, 4p)`` representatives; the inverse accepts
``[0, 2p)`` and always returns canonical values.  Kernel and plain
version give the same integers in every case.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from reference_seal_backend_tpu_torch.nums import primegen
from reference_seal_backend_tpu_torch.nums.polyref import _bitrev
from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.ops.cuda import ntt as ntt_cuda


@dataclass(frozen=True)
class NttPlan:
    """Precomputed NTT schedule for a fixed (N, primes) limb stack on one
    device.  Stage ``s`` of the forward transform uses ``roots[:, m:2m]``
    with ``m = 1 << s``; the inverse uses ``iroots`` likewise."""

    n: int
    primes: Tuple[int, ...]
    psis: Tuple[int, ...]
    device: torch.device
    p: torch.Tensor             # [L, 1]
    p_neg_inv: torch.Tensor     # [L, 1]
    roots: torch.Tensor         # [L, N] psi^bitrev(i)
    roots_shoup: torch.Tensor   # [L, N]
    iroots: torch.Tensor        # [L, N] inverses of roots
    iroots_shoup: torch.Tensor  # [L, N]
    n_inv: torch.Tensor         # [L, 1] plain N^-1
    n_inv_shoup: torch.Tensor   # [L, 1]
    # Harvey lazy reduction: valid only when every prime is below 2**30.
    lazy: bool = False
    _galois_cache: Dict[int, torch.Tensor] = field(
        default_factory=dict, hash=False, compare=False
    )

    # -- transforms ---------------------------------------------------------

    def fwd(self, x: torch.Tensor, lo: int = 0, epilogue: bool = True):
        """Forward negacyclic NTT of ``[..., l, N]`` residues holding limbs
        ``[lo, lo + l)`` of the plan's stack."""
        if x.is_cuda:
            return ntt_cuda.ntt_fwd(
                x.contiguous(), self.roots, self.roots_shoup, self.p,
                lo, self.lazy, epilogue,
            )
        return self.fwd_plain(x, lo, epilogue)

    def inv(self, x: torch.Tensor, lo: int = 0):
        """Inverse negacyclic NTT (exact inverse of :meth:`fwd`)."""
        if x.is_cuda:
            return ntt_cuda.ntt_inv(
                x.contiguous(), self.iroots, self.iroots_shoup, self.p,
                self.n_inv, self.n_inv_shoup, lo, self.lazy,
            )
        return self.inv_plain(x, lo)

    # -- the plain PyTorch version (flat stage loop) --------------------------

    def _stage_tables(self, w, ws, lo, nl, m):
        return (
            modops.wide(w[lo : lo + nl, m : 2 * m, None]),
            modops.wide(ws[lo : lo + nl, m : 2 * m, None]),
        )

    def fwd_plain(self, x: torch.Tensor, lo: int = 0, epilogue: bool = True):
        n = self.n
        lead = x.shape[:-1]
        nl = x.shape[-2]
        pl = modops.wide(self.p[lo : lo + nl])       # [nl, 1]
        p = pl[:, :, None]
        p2 = p + p
        xw = modops.wide(x)
        m, t = 1, n // 2
        for s in range(n.bit_length() - 1):
            xv = xw.reshape(*lead, m, 2, t)
            u = xv[..., 0, :]
            v = xv[..., 1, :]
            w, ws = self._stage_tables(self.roots, self.roots_shoup, lo, nl, m)
            if self.lazy:
                ur = u if s == 0 else modops.w_reduce_2p(u, p2)
                tt = modops.w_shoup_mul_lazy(v, w, ws, p)
                a, b = ur + tt, ur - tt + p2
            else:
                tt = modops.w_shoup_mul(v, w, ws, p)
                a, b = modops.w_mod_add(u, tt, p), modops.w_mod_sub(u, tt, p)
            xw = torch.stack([a, b], dim=-2).reshape(*lead, n)
            m, t = m * 2, t // 2
        if self.lazy and epilogue:
            xw = modops.w_reduce_4p_full(xw, pl)
        return modops.narrow(xw)

    def inv_plain(self, x: torch.Tensor, lo: int = 0):
        n = self.n
        lead = x.shape[:-1]
        nl = x.shape[-2]
        pl = modops.wide(self.p[lo : lo + nl])
        p = pl[:, :, None]
        p2 = p + p
        xw = modops.wide(x)
        m, t = n // 2, 1
        for s in range(n.bit_length() - 2, -1, -1):
            xv = xw.reshape(*lead, m, 2, t)
            u = xv[..., 0, :]
            v = xv[..., 1, :]
            w, ws = self._stage_tables(self.iroots, self.iroots_shoup, lo, nl, m)
            if self.lazy:
                a = modops.w_reduce_2p(u + v, p2)
                b = modops.w_shoup_mul_lazy(u - v + p2, w, ws, p)
            else:
                a = modops.w_mod_add(u, v, p)
                b = modops.w_shoup_mul(modops.w_mod_sub(u, v, p), w, ws, p)
            xw = torch.stack([a, b], dim=-2).reshape(*lead, n)
            m, t = m // 2, t * 2
        # fully-reducing shoup_mul (exact for any uint32 input) restores
        # canonical form, so the lazy path needs no extra epilogue here.
        return modops.narrow(
            modops.w_shoup_mul(
                xw,
                modops.wide(self.n_inv[lo : lo + nl]),
                modops.wide(self.n_inv_shoup[lo : lo + nl]),
                pl,
            )
        )

    # -- Galois automorphisms ----------------------------------------------

    def galois_perm_np(self, g: int) -> np.ndarray:
        """Permutation P with ``NTT(x(X^g))[i] = NTT(x)[P[i]]`` (host)."""
        n = self.n
        bits = n.bit_length() - 1
        k = np.arange(n, dtype=np.int64)
        k_src = ((g % (2 * n)) * (2 * k + 1) % (2 * n) - 1) // 2
        rev = np.array([_bitrev(i, bits) for i in range(n)], dtype=np.int64)
        perm = np.zeros(n, dtype=np.int64)
        perm[rev] = rev[k_src]
        return perm

    def galois_perm(self, g: int) -> torch.Tensor:
        """The same permutation as an index tensor on the plan's device."""
        g = g % (2 * self.n)
        if g not in self._galois_cache:
            self._galois_cache[g] = torch.from_numpy(
                self.galois_perm_np(g)
            ).to(self.device)
        return self._galois_cache[g]

    def apply_galois_eval(self, x: torch.Tensor, g: int) -> torch.Tensor:
        """Automorphism ``X -> X^g`` on NTT-domain data ``[..., N]``."""
        return torch.index_select(x, -1, self.galois_perm(g))


def _shoup_np(w: np.ndarray, primes) -> np.ndarray:
    """``floor(w * 2**32 / p)`` elementwise; ``w`` indexed ``[L, ...]``."""
    p = np.array(primes, dtype=np.uint64).reshape((-1,) + (1,) * (w.ndim - 1))
    return ((w.astype(np.uint64) << 32) // p).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _make_plan(n: int, primes: Tuple[int, ...], device: torch.device) -> NttPlan:
    bits = n.bit_length() - 1
    if 1 << bits != n:
        raise ValueError("N must be a power of two")
    psis = tuple(primegen.min_root_of_unity(2 * n, p) for p in primes)
    rev = [_bitrev(i, bits) for i in range(n)]
    roots = np.zeros((len(primes), n), dtype=np.uint32)
    iroots = np.zeros((len(primes), n), dtype=np.uint32)
    for li, (p, psi) in enumerate(zip(primes, psis)):
        # powers of psi in natural order, then gathered bit-reversed
        pw = np.empty(n, dtype=np.uint64)
        acc = 1
        for i in range(n):
            pw[i] = acc
            acc = acc * psi % p
        psi_inv = pow(psi, -1, p)
        ipw = np.empty(n, dtype=np.uint64)
        acc = 1
        for i in range(n):
            ipw[i] = acc
            acc = acc * psi_inv % p
        roots[li] = pw[rev].astype(np.uint32)
        iroots[li] = ipw[rev].astype(np.uint32)
    n_inv = np.array([[pow(n, -1, p)] for p in primes], dtype=np.uint32)
    consts = [modops.mont_consts(p) for p in primes]
    put = lambda a: modops.from_numpy(a, device)
    return NttPlan(
        n=n,
        primes=primes,
        psis=psis,
        device=device,
        p=put(np.array([[c["p"]] for c in consts], dtype=np.uint32)),
        p_neg_inv=put(
            np.array([[c["p_neg_inv"]] for c in consts], dtype=np.uint32)
        ),
        roots=put(roots),
        roots_shoup=put(_shoup_np(roots, primes)),
        iroots=put(iroots),
        iroots_shoup=put(_shoup_np(iroots, primes)),
        n_inv=put(n_inv),
        n_inv_shoup=put(_shoup_np(n_inv, primes)),
        lazy=all(p < 2**30 for p in primes),
    )


def make_plan(n: int, primes: Tuple[int, ...], device="cpu") -> NttPlan:
    """Build (and cache) the NTT plan for modulus stack ``primes`` at size
    ``n`` with its tables on ``device``."""
    return _make_plan(n, tuple(primes), torch.device(device))
