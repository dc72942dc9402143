"""Build of the port's plugin library and of the harness that drives it.

``librsb_torch_backend.so`` is ``csrc/capi_shim.cpp``: the C ABI of
``native/include/rsb_tpu_backend.h`` (included unchanged) over an embedded
CPython that imports :mod:`reference_seal_backend_tpu_torch.engine.capi`.
``rsb_torch_harness`` is ``native/src/native_harness.cpp``, unchanged, linked
against that library: the one harness source drives the JAX package's
library and the port's, so both export the same ABI.

Both are built at first use by the host C++ compiler (``g++``, which
``nvcc`` needs as well), from the sources in the repository only, into
``<package>/_build/capi-<digest>/`` (git-ignored).  The digest covers the
three sources and every flag, the Python include and library paths among
them; a build goes into a directory of its own process and is moved into
place with ``os.replace``, so processes that build at once do not meet.
Include directory, ``LIBDIR``, ``LDLIBRARY`` and the rpath come from
``sysconfig`` of the interpreter that runs the build; where it has no shared
libpython (``Py_ENABLE_SHARED`` 0) there is nothing to embed and the build
raises.

Run the harness on the CPU (``RSB_TORCH_DEVICE=cpu``) or on the card::

    python -m reference_seal_backend_tpu_torch.engine.native \\
        --device cpu -- --poly 2048 --n 64
    python -m reference_seal_backend_tpu_torch.engine.native -- --poly 8192
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import sysconfig
import time
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional

from reference_seal_backend_tpu_torch.engine.capi import DEVICE_ENV

_PKG = Path(__file__).resolve().parents[1]
REPO = _PKG.parent
SHIM_SOURCE = _PKG / "csrc" / "capi_shim.cpp"
HEADER_DIR = REPO / "native" / "include"
HARNESS_SOURCE = REPO / "native" / "src" / "native_harness.cpp"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "librsb_torch_backend.so"
HARNESS_NAME = "rsb_torch_harness"
CXX_FLAGS = ("-std=c++17", "-O2", "-Wall", "-Wextra")


class Built(NamedTuple):
    library: Path
    harness: Path
    seconds: float  # spent compiling; 0.0 when an earlier build was reused


_built: Optional[Built] = None


def _compiler() -> str:
    found = shutil.which("g++")
    if not found:
        raise RuntimeError("g++ not found on PATH: the plugin library cannot "
                           "be built")
    return found


def _libpython() -> Path:
    """The shared libpython of the running interpreter."""
    if not sysconfig.get_config_var("Py_ENABLE_SHARED"):
        raise RuntimeError(
            f"{sys.executable} was built without a shared libpython "
            "(Py_ENABLE_SHARED is 0): there is no libpython to embed"
        )
    lib = Path(sysconfig.get_config_var("LIBDIR")) / sysconfig.get_config_var(
        "LDLIBRARY")
    if not lib.exists():
        raise RuntimeError(f"shared libpython {lib} not found")
    return lib


def _commands(out: Path) -> List[List[str]]:
    """The two compiler calls that build into ``out``: library, harness."""
    cxx, libpython = _compiler(), _libpython()
    include = sysconfig.get_config_var("INCLUDEPY")
    library = [
        cxx, *CXX_FLAGS, "-fPIC", "-shared", f"-I{HEADER_DIR}", f"-I{include}",
        "-o", str(out / LIB_NAME), str(SHIM_SOURCE), str(libpython),
        f"-Wl,-rpath,{libpython.parent}", f"-Wl,-soname,{LIB_NAME}",
    ]
    harness = [
        cxx, *CXX_FLAGS, f"-I{HEADER_DIR}", "-o", str(out / HARNESS_NAME),
        str(HARNESS_SOURCE), f"-L{out}", "-lrsb_torch_backend",
        "-Wl,-rpath,$ORIGIN",
    ]
    return [library, harness]


def build() -> Built:
    """Build (if not built from these sources and flags yet) the plugin
    library and the harness; return their paths."""
    global _built
    if _built is not None:
        return Built(_built.library, _built.harness, 0.0)
    digest = hashlib.sha256()
    for src in (SHIM_SOURCE, HEADER_DIR / "rsb_tpu_backend.h", HARNESS_SOURCE):
        digest.update(src.read_bytes())
    for cmd in _commands(Path("out")):  # the flags, whatever the directory
        digest.update("\0".join(cmd).encode())
    final = BUILD_DIR / f"capi-{digest.hexdigest()[:16]}"
    seconds = 0.0
    if not final.exists():
        tmp = BUILD_DIR / f".{final.name}.{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir(parents=True)
        t0 = time.perf_counter()
        for cmd in _commands(tmp):
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                shutil.rmtree(tmp, ignore_errors=True)
                raise RuntimeError(
                    f"{' '.join(cmd)}\nfailed ({proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
        seconds = time.perf_counter() - t0
        try:
            os.replace(tmp, final)
        except OSError:  # another process put the same build in place first
            if not final.exists():
                raise
            shutil.rmtree(tmp, ignore_errors=True)
    _built = Built(final / LIB_NAME, final / HARNESS_NAME, seconds)
    return _built


_I64, _INT, _STR, _PTR = ctypes.c_int64, ctypes.c_int, ctypes.c_char_p, ctypes.c_void_p
_STEP = (_I64, [_I64, _I64])
#: ``(restype, argtypes)`` of every function of ``rsb_tpu_backend.h``; the
#: strings the library allocates come back as pointers, for ``rsbtpu_free``
SIGNATURES = {
    "rsbtpu_initialize": (_INT, []),
    "rsbtpu_finalize": (None, []),
    "rsbtpu_api_version_check": (_INT, [_INT, _INT, _INT]),
    "rsbtpu_engine_create": (_I64, []),
    "rsbtpu_engine_create_with_data": (_I64, [_STR, ctypes.c_uint64]),
    "rsbtpu_engine_destroy": (None, [_I64]),
    "rsbtpu_benchmark_count": (_I64, [_I64]),
    "rsbtpu_benchmark_name": (_I64, [_I64, _I64, _STR, _I64]),
    "rsbtpu_benchmark_descriptor": (_I64, [_I64, _I64, _STR, _I64]),
    "rsbtpu_benchmark_create": (_I64, [_I64, _STR, _STR]),
    "rsbtpu_benchmark_destroy": (None, [_I64]),
    "rsbtpu_encode": (_I64, [_I64, _STR]),
    "rsbtpu_encrypt": _STEP,
    "rsbtpu_load": _STEP,
    "rsbtpu_operate": _STEP,
    "rsbtpu_store": _STEP,
    "rsbtpu_decrypt": _STEP,
    "rsbtpu_decode": (_PTR, [_I64, _I64]),
    "rsbtpu_handle_destroy": (None, [_I64]),
    "rsbtpu_free": (None, [_PTR]),
    "rsbtpu_last_error": (_PTR, []),
}


def load_library() -> ctypes.CDLL:
    """The plugin library (built if need be) loaded into this process with
    ``ctypes.CDLL`` (which releases the GIL around each call; the library
    takes it itself) and every function's signature declared.  Its embedded
    interpreter is this one: the library imports the port's capi into
    ``sys.modules``."""
    lib = ctypes.CDLL(str(build().library))
    for name, (restype, argtypes) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = restype, argtypes
    return lib


def take_string(lib: ctypes.CDLL, ptr: Optional[int]) -> Optional[str]:
    """Read a string the library allocated and free it; None for NULL."""
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode()
    finally:
        lib.rsbtpu_free(ptr)


def embedded_env(device: str) -> Dict[str, str]:
    """Environment of a process that embeds the interpreter through the
    library: this process's, with ``PYTHONPATH`` holding the repository root
    and the running interpreter's ``sys.path`` (an embedded interpreter finds
    no module of a virtual environment by itself), and ``RSB_TORCH_DEVICE``
    the engine's device."""
    env = dict(os.environ)
    paths = [str(REPO), *(p for p in sys.path if p)]
    env["PYTHONPATH"] = os.pathsep.join(dict.fromkeys(paths))
    env[DEVICE_ENV] = device
    return env


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Build the port's plugin library and run the harness "
                    "against it; arguments after -- go to the harness "
                    "(--poly N --n n --seed s --all, or benchmark names)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("harness_args", nargs=argparse.REMAINDER)
    ns = ap.parse_args(argv)
    args = ns.harness_args[1:] if ns.harness_args[:1] == ["--"] else ns.harness_args
    built = build()
    print(f"library {built.library}\nharness {built.harness}", flush=True)
    return subprocess.call([str(built.harness), *args],
                           env=embedded_env(ns.device))


if __name__ == "__main__":
    raise SystemExit(main())
