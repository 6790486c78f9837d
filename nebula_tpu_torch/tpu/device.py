"""Device selection for the port — the counterpart of
``nebula_tpu/tpu/jax_setup.py``.

``resolve_device(None)`` means ``cuda:0`` and insists on a Hopper card
(compute capability 9.x): the kernels in ``csrc/`` are built for
``sm_90a`` only.  The CPU is used only when the caller names it, as
the tests do; there is no silent fallback from the card to the CPU.
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda:0`` (a 9.x card, else RuntimeError); ``"cpu"``
    -> the CPU; a CUDA device is checked the same way as ``None``.
    Anything else raises ValueError."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}: the port runs on a "
                         f"CUDA card, or on the CPU when asked")
    if not torch.cuda.is_available():
        raise RuntimeError(f"{dev} requested but no CUDA device is "
                           f"present (pass device='cpu' to run the "
                           f"plain PyTorch versions)")
    index = 0 if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"{dev} requested but only "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    major, minor = torch.cuda.get_device_capability(index)
    if major != 9:
        raise RuntimeError(
            f"{torch.cuda.get_device_name(index)} has compute capability "
            f"{major}.{minor}; the kernels are built for sm_90a (Hopper)")
    return torch.device("cuda", index)


def smi_name_and_power_limit() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (first card), or None when nvidia-smi is absent.  Every time the
    port records is written beside this line."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    out = subprocess.run(
        [exe, "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    lines = [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]
    return lines[0] if lines else None
