"""Wrappers of the hand-written CUDA NTT kernels (``csrc/ntt.cu``).

``ntt_fwd`` and ``ntt_inv`` replace the two branches of the JAX package's
TPU kernel (``ops/pallas/ntt_kernel.py:_ntt_kernel``).  The source is built
with ``nvcc`` for ``sm_90a`` at first use (``ops/cuda/nvcc.py``), into
``<package>/_build/`` (git-ignored), and loaded with ``ctypes``: one shared
library that holds the kernels specialised for the transform sizes of
:data:`KERNEL_LOG_NS` and the generic kernels that take any other power of
two.  Nothing is built or loaded when the module is imported.

The input may be a limb slice of a larger tensor (:func:`_row_layout` says
which views go in as they are); the output is a new contiguous tensor.

There is no fallback: a tensor that is not on a CUDA device, a view the
kernel does not take, a build that fails or a launch that is refused
raises.  The plain PyTorch versions live in ``ops/ntt.py`` and are chosen
there, for CPU tensors only.

``launches`` counts kernel launches per entry point; a wrapper adds one
exactly where it launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from reference_seal_backend_tpu_torch.ops.cuda import nvcc
from reference_seal_backend_tpu_torch.ops.modops import STORE

SOURCE = nvcc.CSRC / "ntt.cu"

#: log2 N of the sizes the kernels are specialised for (N = 2048 .. 32768);
#: the switch in ``csrc/ntt.cu:transform`` names the same
KERNEL_LOG_NS = (11, 12, 13, 14, 15)

#: kernel launches since the last :func:`reset_launches`, by entry point
launches: Dict[str, int] = {"ntt_fwd": 0, "ntt_inv": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def build() -> float:
    """Build (if not built from this source yet) and load the kernel
    library.  Returns the seconds spent compiling, 0.0 when it was
    loaded from an earlier build of the same source."""
    global _lib
    if _lib is not None:
        return 0.0
    lib, seconds = nvcc.load(SOURCE, "ntt")
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rsb_ntt_fwd.argtypes = [vp, vp, vp, vp, vp, ll, ci, ci, ll, ci, ci, ci, vp]
    lib.rsb_ntt_fwd.restype = ci
    lib.rsb_ntt_inv.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ll, ci, ci, vp]
    lib.rsb_ntt_inv.restype = ci
    lib.rsb_cuda_error_string.argtypes = [ci]
    lib.rsb_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return seconds


def _row_layout(x: torch.Tensor, n: int) -> Tuple[int, int]:
    """``(rows, row stride in words)`` of ``x [..., nl, n]`` as the kernels
    address it: words dense, limbs ``n`` words apart, and the leading
    dimensions collapsing to one row index with one stride.  That holds for a
    contiguous tensor and for a limb slice ``y[..., a:b, :]`` of one; any
    other view raises."""
    nl = x.shape[-2]
    if x.stride(-1) != 1 or (nl > 1 and x.stride(-2) != n):
        raise ValueError(
            "the CUDA NTT kernel takes dense polynomials with limbs N words "
            f"apart, got strides {x.stride()} for shape {tuple(x.shape)}"
        )
    rows, row_stride = 1, nl * n
    for size, stride in zip(reversed(x.shape[:-2]), reversed(x.stride()[:-2])):
        if size == 1:
            continue
        if rows == 1:
            row_stride = stride
        elif stride != row_stride * rows:
            raise ValueError(
                "the CUDA NTT kernel takes a contiguous tensor or a limb slice "
                f"of one, got strides {x.stride()} for shape {tuple(x.shape)}"
            )
        rows *= size
    if row_stride < 0:
        raise ValueError("negative row stride")
    return rows, row_stride


def _check(x: torch.Tensor, tables, n_limbs: int, n: int, lo: int) -> Tuple[int, int]:
    """Raise on what the kernels do not take; else ``x``'s row layout."""
    if not x.is_cuda:
        raise ValueError("the CUDA NTT kernel takes CUDA tensors only")
    if x.dtype != STORE:
        raise TypeError(f"expected {STORE} residue storage, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n:
        raise ValueError(f"expected [..., nl, {n}], got {tuple(x.shape)}")
    nl = x.shape[-2]
    if lo < 0 or nl < 1 or lo + nl > n_limbs:
        raise ValueError(f"limbs [{lo}, {lo + nl}) outside the plan's {n_limbs}")
    for t in tables:
        if t.device != x.device or t.dtype != STORE or not t.is_contiguous():
            raise ValueError("plan tables must be contiguous int32 on x's device")
    rows, row_stride = _row_layout(x, n)
    specialised = n.bit_length() - 1 in KERNEL_LOG_NS
    if specialised and (x.data_ptr() % 16 or row_stride % 4):
        raise ValueError("the CUDA NTT kernel reads 16 bytes at a time: x must "
                         "start, and its rows lie, at multiples of 16 bytes")
    return rows, row_stride


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _lib.rsb_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def ntt_fwd(x, roots, roots_shoup, primes, lo: int, lazy: bool, epilogue: bool):
    """Forward negacyclic NTT of ``x [..., nl, N]`` (limbs ``lo..lo+nl`` of
    the ``[L, N]`` tables) on the card.  Returns a new contiguous tensor."""
    n_limbs, n = roots.shape
    rows, row_stride = _check(x, (roots, roots_shoup, primes), n_limbs, n, lo)
    build()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib.rsb_ntt_fwd(
            x.data_ptr(), out.data_ptr(), roots.data_ptr(),
            roots_shoup.data_ptr(), primes.data_ptr(),
            rows, x.shape[-2], n, row_stride, lo, int(lazy), int(epilogue),
            stream,
        )
    _raise_on(code, "ntt_fwd")
    launches["ntt_fwd"] += 1
    return out


def ntt_inv(x, iroots, iroots_shoup, primes, n_inv, n_inv_shoup, lo: int, lazy: bool):
    """Inverse negacyclic NTT, the exact inverse of :func:`ntt_fwd`;
    output canonical.  Returns a new contiguous tensor."""
    n_limbs, n = iroots.shape
    rows, row_stride = _check(
        x, (iroots, iroots_shoup, primes, n_inv, n_inv_shoup), n_limbs, n, lo
    )
    build()
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib.rsb_ntt_inv(
            x.data_ptr(), out.data_ptr(), iroots.data_ptr(),
            iroots_shoup.data_ptr(), primes.data_ptr(), n_inv.data_ptr(),
            n_inv_shoup.data_ptr(), rows, x.shape[-2], n, row_stride, lo,
            int(lazy), stream,
        )
    _raise_on(code, "ntt_inv")
    launches["ntt_inv"] += 1
    return out
