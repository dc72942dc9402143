"""State carried across from the JAX package, as numpy arrays.

The functions here take what ``np.asarray`` gives on the JAX side (uint32
residue arrays and plain Python scalars) and build the port's containers,
and back.  They import nothing of the JAX package: the caller does the
``np.asarray``.  The tests use them to feed both evaluators the same keys
and ciphertexts.  Like every entry point of the port they put what they
build on the card unless the caller asks for the CPU (``device="cpu"``;
``utils/device.py:pick_device``).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from reference_seal_backend_tpu_torch.ops import modops
from reference_seal_backend_tpu_torch.schemes.core import Ciphertext, Plaintext
from reference_seal_backend_tpu_torch.schemes.keys import (
    KeySet,
    PublicKey,
    SwitchKey,
)
from reference_seal_backend_tpu_torch.utils.device import pick_device

_SK_FIELDS = ("b", "a", "bs", "as_")


def switch_key_from_numpy(d: Dict[str, np.ndarray], device=None) -> SwitchKey:
    """``{"b", "a", "bs", "as_"}`` uint32 arrays -> SwitchKey."""
    device = pick_device(device)
    return SwitchKey(**{k: modops.from_numpy(d[k], device) for k in _SK_FIELDS})


def switch_key_to_numpy(k: SwitchKey) -> Dict[str, np.ndarray]:
    return {f: modops.to_numpy(getattr(k, f)) for f in _SK_FIELDS}


def keyset_from_numpy(d: dict, device=None) -> KeySet:
    """Build a KeySet from ``{"secret_ntt": arr, "public": {"b", "a"},
    "relin": switch-key dict or None, "galois": {g: switch-key dict},
    "galois_p5": {g: switch-key dict}}``."""
    device = pick_device(device)
    sk = lambda x: switch_key_from_numpy(x, device)
    relin: Optional[dict] = d.get("relin")
    return KeySet(
        secret_ntt=modops.from_numpy(d["secret_ntt"], device),
        public=PublicKey(
            b=modops.from_numpy(d["public"]["b"], device),
            a=modops.from_numpy(d["public"]["a"], device),
        ),
        relin=None if relin is None else sk(relin),
        galois={int(g): sk(v) for g, v in d.get("galois", {}).items()},
        galois_p5={int(g): sk(v) for g, v in d.get("galois_p5", {}).items()},
    )


def keyset_to_numpy(ks: KeySet) -> dict:
    return {
        "secret_ntt": modops.to_numpy(ks.secret_ntt),
        "public": {
            "b": modops.to_numpy(ks.public.b),
            "a": modops.to_numpy(ks.public.a),
        },
        "relin": None if ks.relin is None else switch_key_to_numpy(ks.relin),
        "galois": {g: switch_key_to_numpy(k) for g, k in ks.galois.items()},
        "galois_p5": {
            g: switch_key_to_numpy(k) for g, k in ks.galois_p5.items()
        },
    }


def ciphertext_from_numpy(
    data: np.ndarray, level: int, scale: float, device=None
) -> Ciphertext:
    return Ciphertext(
        data=modops.from_numpy(data, pick_device(device)), level=int(level),
        scale=float(scale), is_ntt=True,
    )


def plaintext_from_numpy(
    data: np.ndarray, level: int, scale: float, device=None
) -> Plaintext:
    return Plaintext(
        data=modops.from_numpy(data, pick_device(device)), level=int(level),
        scale=float(scale), is_ntt=True,
    )


def to_numpy(x) -> np.ndarray:
    """Residue data of a Ciphertext/Plaintext (or a bare storage tensor)
    as a numpy uint32 array."""
    return modops.to_numpy(getattr(x, "data", x))
