"""The port's device rule: entry points run on the card unless asked not to."""

from __future__ import annotations

import subprocess

import torch


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (the card may be set below its maximum power, and then runs slower)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device=None) -> torch.device:
    """``None`` means CUDA. Without a card that raises instead of silently
    running on the CPU; pass ``device="cpu"`` to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU (its kernels then take their plain PyTorch "
                "versions)")
        return torch.device("cuda")
    return torch.device(device)
