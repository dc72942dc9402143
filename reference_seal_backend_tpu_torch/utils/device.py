"""Device choice for the port's entry points, and the card's identity.

Entry points run on the card unless the caller asks for the CPU.  Asking
for ``cuda`` where there is none raises: nothing carries on on the CPU by
itself.
"""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def pick_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """Resolve ``device`` (default ``cuda``) to a concrete ``torch.device``
    with an index, so equal devices compare and hash equal."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def card_name_and_power_limit() -> str:
    """First line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
