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

The kernel does not walk the stages one by one: it groups them into
passes of up to :data:`MAX_RADIX_LOG` stages that one thread runs on
``2**k`` elements held in registers (:func:`pass_split`,
:func:`task_base`, :func:`smem_index` — the index maps ``csrc/ntt.cu``
uses, written once here).  :meth:`NttPlan.fwd_blocked_plain` and
:meth:`NttPlan.inv_blocked_plain` run the transform pass by pass with
exactly those element sets in plain PyTorch, so the CPU tests hold the
kernel's structure against the flat loop.  Regrouping changes no
butterfly's inputs: all four give the same integers.

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

# -- pass structure of the CUDA kernels (csrc/ntt.cu cites these) -----------

#: most butterfly stages one pass runs on registers (2**4 = 16 elements)
MAX_RADIX_LOG = 4
#: log2 N of the sizes the kernels are specialised for at compile time; any
#: other power of two takes the kernels' generic stage loop
KERNEL_LOG_NS = ntt_cuda.KERNEL_LOG_NS


def pass_split(log_n: int):
    """The passes of a transform of ``2**log_n`` points as ``(s0, k)``
    pairs: pass ``i`` runs stages ``s0 .. s0 + k - 1``.  As few passes as
    :data:`MAX_RADIX_LOG` allows, of near-equal width, the wider ones first
    (13 stages -> 4 + 3 + 3 + 3)."""
    n_passes = max(1, -(-log_n // MAX_RADIX_LOG))
    out, s0 = [], 0
    for i in range(n_passes):
        k = log_n // n_passes + (1 if i < log_n % n_passes else 0)
        out.append((s0, k))
        s0 += k
    return tuple(out)


def task_base(log_n: int, s0: int, k: int, q):
    """Index of element 0 of task ``q`` in the pass ``(s0, k)``; ``q`` may
    be a numpy array.  A task is the ``2**k`` elements one thread holds:
    ``task_base | e << b`` for ``e < 2**k``, ``b = log_n - s0 - k`` — the
    indices that differ only in the bit field the pass's stages pair up.

    Tasks are dealt to threads in order, so the 32 tasks of a warp are
    consecutive ``q``.  Where ``b >= 5`` or ``b == 0`` the map is the
    natural one (low ``b`` bits of ``q`` below the field, the rest above).
    Where ``0 < b < 5`` the warp's lane bits go to index bits ``[0, b)``
    and ``[5 + b, 10)``: with :func:`smem_index` those are the bits that
    spread a warp over all 32 banks."""
    b = log_n - s0 - k
    if 0 < b < 5 and log_n >= 10:
        lane, rest = q & 31, q >> 5
        return (
            (lane & ((1 << b) - 1))
            | ((lane >> b) << (5 + b))
            | ((rest & ((1 << (5 - k)) - 1)) << (b + k))
            | ((rest >> (5 - k)) << 10)
        )
    return ((q >> b) << (b + k)) | (q & ((1 << b) - 1))


def smem_index(i):
    """Where element ``i`` of the polynomial sits in the block's shared
    memory: one word of padding after every 32."""
    return i + (i >> 5)


@functools.lru_cache(maxsize=None)
def _pass_tables(log_n: int, s0: int, k: int):
    """``elem[q, e]``: the element indices of task ``q``; ``tw[q, c]``: the
    root-table index of the task's twiddle ``c`` in heap order (stage
    ``s0 + r`` uses columns ``2**r .. 2**(r+1) - 1``; column 0 is unused)."""
    b = log_n - s0 - k
    base = task_base(log_n, s0, k, np.arange(1 << (log_n - k), dtype=np.int64))
    elem = base[:, None] | (np.arange(1 << k, dtype=np.int64) << b)[None, :]
    first = (1 << s0) + (base >> (b + k))  # the task's stage-s0 twiddle
    tw = np.zeros_like(elem)
    for r in range(k):
        for j in range(1 << r):
            tw[:, (1 << r) + j] = (first << r) + j
    return torch.from_numpy(elem), torch.from_numpy(tw)


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
        ``[lo, lo + l)`` of the plan's stack.  A limb-slice view
        ``y[..., a:b, :]`` of a contiguous tensor goes to the kernel as it
        is (``ops/cuda/ntt.py`` says which views it takes); the result is a
        new contiguous tensor."""
        if x.is_cuda:
            return ntt_cuda.ntt_fwd(
                x, self.roots, self.roots_shoup, self.p,
                lo, self.lazy, epilogue,
            )
        return self.fwd_plain(x, lo, epilogue)

    def inv(self, x: torch.Tensor, lo: int = 0):
        """Inverse negacyclic NTT (exact inverse of :meth:`fwd`)."""
        if x.is_cuda:
            return ntt_cuda.ntt_inv(
                x, self.iroots, self.iroots_shoup, self.p,
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

    # -- the plain version, pass by pass as the CUDA kernels run it ----------

    def _pass_operands(self, xw, w, ws, lo, nl, s0, k):
        """One pass's view of the data: ``a [..., nl, Q, 2**k]`` (task ``q``'s
        elements), its twiddles ``[nl, Q, 2**k]`` and the scatter index."""
        elem, tw = _pass_tables(self.n.bit_length() - 1, s0, k)
        elem, tw = elem.to(xw.device), tw.to(xw.device)
        return (
            xw[..., elem],
            modops.wide(w[lo : lo + nl][:, tw]),
            modops.wide(ws[lo : lo + nl][:, tw]),
            elem,
        )

    def fwd_blocked_plain(self, x: torch.Tensor, lo: int = 0, epilogue: bool = True):
        """:meth:`fwd_plain`'s integers, computed in the kernel's passes."""
        nl = x.shape[-2]
        pl = modops.wide(self.p[lo : lo + nl])       # [nl, 1]
        p = pl[:, :, None, None]
        p2 = p + p
        xw = modops.wide(x)
        for s0, k in pass_split(self.n.bit_length() - 1):
            a, w, ws, elem = self._pass_operands(
                xw, self.roots, self.roots_shoup, lo, nl, s0, k
            )
            for r in range(k):
                av = a.reshape(*a.shape[:-1], 1 << r, 2, 1 << (k - 1 - r))
                u, v = av[..., 0, :], av[..., 1, :]
                wr = w[..., (1 << r) : (2 << r), None]
                wsr = ws[..., (1 << r) : (2 << r), None]
                if self.lazy:
                    ur = u if s0 + r == 0 else modops.w_reduce_2p(u, p2)
                    tt = modops.w_shoup_mul_lazy(v, wr, wsr, p)
                    hi, lo_ = ur + tt, ur - tt + p2
                else:
                    tt = modops.w_shoup_mul(v, wr, wsr, p)
                    hi, lo_ = modops.w_mod_add(u, tt, p), modops.w_mod_sub(u, tt, p)
                a = torch.stack([hi, lo_], dim=-2).reshape(a.shape)
            xw = torch.empty_like(xw)
            xw[..., elem] = a
        if self.lazy and epilogue:
            xw = modops.w_reduce_4p_full(xw, pl)
        return modops.narrow(xw)

    def inv_blocked_plain(self, x: torch.Tensor, lo: int = 0):
        """:meth:`inv_plain`'s integers, computed in the kernel's passes
        (the forward passes in reverse, each with its stages in reverse)."""
        nl = x.shape[-2]
        pl = modops.wide(self.p[lo : lo + nl])
        p = pl[:, :, None, None]
        p2 = p + p
        xw = modops.wide(x)
        for s0, k in reversed(pass_split(self.n.bit_length() - 1)):
            a, w, ws, elem = self._pass_operands(
                xw, self.iroots, self.iroots_shoup, lo, nl, s0, k
            )
            for r in range(k - 1, -1, -1):
                av = a.reshape(*a.shape[:-1], 1 << r, 2, 1 << (k - 1 - r))
                u, v = av[..., 0, :], av[..., 1, :]
                wr = w[..., (1 << r) : (2 << r), None]
                wsr = ws[..., (1 << r) : (2 << r), None]
                if self.lazy:
                    hi = modops.w_reduce_2p(u + v, p2)
                    lo_ = modops.w_shoup_mul_lazy(u - v + p2, wr, wsr, p)
                else:
                    hi = modops.w_mod_add(u, v, p)
                    lo_ = modops.w_shoup_mul(modops.w_mod_sub(u, v, p), wr, wsr, p)
                a = torch.stack([hi, lo_], dim=-2).reshape(a.shape)
            xw = torch.empty_like(xw)
            xw[..., elem] = a
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
