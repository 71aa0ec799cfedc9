"""The card's identity, for the records the tools, the demos and
``chip_smoke.py`` print beside their numbers."""
from __future__ import annotations

import subprocess

import torch


def smi_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card, e.g.
    "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def card_name(dev: torch.device) -> str:
    """The card's name, or "cpu"."""
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def device_name(dev: torch.device) -> str:
    """The card's name x1 with its ``nvidia-smi`` power limit, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    limit = smi_line().rsplit(", ", 1)[-1]
    return f"{card_name(dev)} x1, {limit}"
