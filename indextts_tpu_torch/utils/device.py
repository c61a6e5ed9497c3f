"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card. A CUDA device without a card raises: entry
    points never carry on quietly on the CPU; pass `device="cpu"` for that."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return dev


def card_info(device) -> dict:
    """What a measurement ran on: {"name", "power_limit_w"}. For a CUDA
    device, torch's name for it and the power limit in W that `nvidia-smi
    --query-gpu=name,power.limit` gives for a card of that name (None
    without nvidia-smi or such a line); for the CPU, {"name": "cpu",
    "power_limit_w": None}."""
    import subprocess

    dev = torch.device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit_w": None}
    name = torch.cuda.get_device_name(dev)
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.TimeoutExpired):
        out = ""
    limit = None
    for line in out.splitlines():
        card, _, power = line.rpartition(",")
        if card.strip() == name:
            try:
                limit = float(power.split()[0])
            except (ValueError, IndexError):
                pass
            break
    return {"name": name, "power_limit_w": limit}
