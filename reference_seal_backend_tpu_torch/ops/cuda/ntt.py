"""Wrappers of the hand-written CUDA NTT kernels (``csrc/ntt.cu``).

``ntt_fwd`` and ``ntt_inv`` replace the two branches of the JAX package's
TPU kernel (``ops/pallas/ntt_kernel.py:_ntt_kernel``).  The shared library
is built with ``nvcc`` for ``sm_90a`` at first use, from the source in this
package into ``<package>/_build/`` (git-ignored), and loaded with ``ctypes``.
Nothing is built or loaded when the module is imported.

There is no fallback: a tensor that is not on a CUDA device, a build that
fails or a launch that is refused raises.  The plain PyTorch versions live
in ``ops/ntt.py`` and are chosen there, for CPU tensors only.

``launches`` counts kernel launches per entry point; a wrapper adds one
exactly where it launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from reference_seal_backend_tpu_torch.ops.modops import STORE

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "ntt.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

#: kernel launches since the last :func:`reset_launches`, by entry point
launches: Dict[str, int] = {"ntt_fwd": 0, "ntt_inv": 0}

_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA NTT "
        "kernel cannot be built"
    )


def build() -> float:
    """Build (if not built from this source yet) and load the kernel
    library.  Returns the seconds spent compiling, 0.0 when it was
    loaded from an earlier build of the same source."""
    global _lib
    if _lib is not None:
        return 0.0
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"libntt-{digest}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".libntt-{digest}.{os.getpid()}.so"
        cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    vp, ci, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rsb_ntt_fwd.argtypes = [vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, ci, vp]
    lib.rsb_ntt_fwd.restype = ci
    lib.rsb_ntt_inv.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci, vp]
    lib.rsb_ntt_inv.restype = ci
    lib.rsb_cuda_error_string.argtypes = [ci]
    lib.rsb_cuda_error_string.restype = ctypes.c_char_p
    _lib = lib
    return seconds


def _check(x: torch.Tensor, tables, n_limbs: int, n: int, lo: int) -> None:
    if not x.is_cuda:
        raise ValueError("the CUDA NTT kernel takes CUDA tensors only")
    if x.dtype != STORE:
        raise TypeError(f"expected {STORE} residue storage, got {x.dtype}")
    if x.dim() < 2 or x.shape[-1] != n:
        raise ValueError(f"expected [..., nl, {n}], got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("the CUDA NTT kernel takes contiguous tensors only")
    nl = x.shape[-2]
    if lo < 0 or nl < 1 or lo + nl > n_limbs:
        raise ValueError(f"limbs [{lo}, {lo + nl}) outside the plan's {n_limbs}")
    for t in tables:
        if t.device != x.device or t.dtype != STORE or not t.is_contiguous():
            raise ValueError("plan tables must be contiguous int32 on x's device")


def _raise_on(code: int, name: str) -> None:
    if code != 0:
        msg = _lib.rsb_cuda_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")


def ntt_fwd(x, roots, roots_shoup, primes, lo: int, lazy: bool, epilogue: bool):
    """Forward negacyclic NTT of ``x [..., nl, N]`` (limbs ``lo..lo+nl`` of
    the ``[L, N]`` tables) on the card.  Returns a new tensor."""
    n_limbs, n = roots.shape
    _check(x, (roots, roots_shoup, primes), n_limbs, n, lo)
    build()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    nl = x.shape[-2]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib.rsb_ntt_fwd(
            x.data_ptr(), out.data_ptr(), roots.data_ptr(),
            roots_shoup.data_ptr(), primes.data_ptr(),
            x.numel() // (nl * n), nl, n, lo, int(lazy), int(epilogue), stream,
        )
    _raise_on(code, "ntt_fwd")
    launches["ntt_fwd"] += 1
    return out


def ntt_inv(x, iroots, iroots_shoup, primes, n_inv, n_inv_shoup, lo: int, lazy: bool):
    """Inverse negacyclic NTT, the exact inverse of :func:`ntt_fwd`;
    output canonical.  Returns a new tensor."""
    n_limbs, n = iroots.shape
    _check(x, (iroots, iroots_shoup, primes, n_inv, n_inv_shoup), n_limbs, n, lo)
    build()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    nl = x.shape[-2]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        code = _lib.rsb_ntt_inv(
            x.data_ptr(), out.data_ptr(), iroots.data_ptr(),
            iroots_shoup.data_ptr(), primes.data_ptr(), n_inv.data_ptr(),
            n_inv_shoup.data_ptr(), x.numel() // (nl * n), nl, n, lo,
            int(lazy), stream,
        )
    _raise_on(code, "ntt_inv")
    launches["ntt_inv"] += 1
    return out
