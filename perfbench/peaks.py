"""The chip's published peaks (NVIDIA H100 SXM data sheet, dense, at its
700 W limit) and the card's own name and power limit, read beside them."""

from __future__ import annotations

import subprocess

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them, or an
    empty dict where it cannot."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    if out.returncode != 0 or not out.stdout.strip():
        return {}
    name, limit = [s.strip() for s in out.stdout.splitlines()[0].split(",")]
    return {"name": name, "power_limit": limit}
