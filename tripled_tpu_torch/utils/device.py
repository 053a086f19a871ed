"""The device an entry point runs on, and the card a measurement ran on."""

from __future__ import annotations

import subprocess

import torch


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without a visible card
    raises, so that a run asked for the card never goes on on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} asked for, but no CUDA device is visible")
    return device


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
