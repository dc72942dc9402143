"""Build a CUDA source of ``csrc/`` into a shared library and load it.

One library a source, built with ``nvcc`` for ``sm_90a`` into
``<package>/_build/`` (git-ignored) under a name that holds the digest of
the source and the flags, so that a build is reused until either changes,
and loaded with ``ctypes``.  Nothing here runs when a module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Sequence, Tuple

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
    # the specialised kernels of a source are optimised side by side, on
    # every core
    "-split-compile=0",
)


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA "
        "kernels cannot be built"
    )


def load(source: Path, stem: str,
         extra: Sequence[str] = ()) -> Tuple[ctypes.CDLL, float]:
    """The library ``lib<stem>-<digest>.so`` of ``source``, built first if
    no earlier build of the same source and flags is there, and loaded.
    ``extra``: flags beyond :data:`NVCC_FLAGS` (a ``-D`` that picks what
    the source instantiates).  Returns it and the seconds spent compiling
    (0.0 for a reused build)."""
    flags = (*NVCC_FLAGS, *extra)
    digest = hashlib.sha256(
        source.read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    so = BUILD_DIR / f"lib{stem}-{digest}.so"
    seconds = 0.0
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".lib{stem}-{digest}.{os.getpid()}.so"
        cmd = [find_nvcc(), *flags, "-o", str(tmp), str(source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, so)
    return ctypes.CDLL(str(so)), seconds
