"""Device choice for the port's entry points, and the card's identity.

Entry points run on the card unless the caller asks for the CPU.  Asking
for ``cuda`` where there is none raises: nothing carries on on the CPU by
itself.  Likewise an sp mesh (:func:`mesh_devices`) of more shards than
visible cards raises unless the process asks for virtual devices.
"""

from __future__ import annotations

import os
import subprocess
from typing import List, Union

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


#: ``RSB_TORCH_VIRTUAL_DEVICES=K`` lets an sp mesh of up to K shards share
#: one card: the port's counterpart of XLA's
#: ``--xla_force_host_platform_device_count``.
VIRTUAL_DEVICES_ENV = "RSB_TORCH_VIRTUAL_DEVICES"


def mesh_devices(device, n: int) -> List[torch.device]:
    """The ``n`` devices an sp mesh is built on.  On the CPU, ``n`` copies
    of ``cpu`` (torch has one CPU device; the copies stand for the JAX
    tests' virtual host devices).  On CUDA, ``n`` consecutive cards from the
    one ``device`` names (``cuda:i .. i+n-1``) where they are visible; else
    ``n`` copies of that card, but only when :data:`VIRTUAL_DEVICES_ENV`
    allows ``n`` virtual devices.  Otherwise raises, naming ``n`` and the
    visible count."""
    dev = pick_device(device)
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, not {n}")
    if dev.type == "cpu":
        return [dev] * n
    visible = torch.cuda.device_count()
    if dev.index + n <= visible:
        return [torch.device("cuda", dev.index + i) for i in range(n)]
    virtual = int(os.environ.get(VIRTUAL_DEVICES_ENV, "0") or 0)
    if n <= virtual:
        return [dev] * n
    raise ValueError(
        f"an sp mesh of {n} devices needs {n} visible cards, {visible} "
        f"visible (counting from {dev}); set {VIRTUAL_DEVICES_ENV}={n} to "
        f"place the {n} shards on {dev}"
    )


def card_name_and_power_limit() -> str:
    """First line of ``nvidia-smi --query-gpu=name,power.limit
    --format=csv,noheader`` (e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0].strip()
