"""The card a measurement ran on."""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` of the
    first card, e.g. "NVIDIA H100 80GB HBM3, 700.00 W"."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
