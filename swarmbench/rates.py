"""The card's published peaks (the yardstick; frozen).

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
power limit of 700 W: HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the
tensor cores, 495 TFLOP/s in TF32, 989 TFLOP/s in bfloat16. A card set
below 700 W runs slower under load; :func:`power_limit` reads its limit so
a run records it beside every share of a peak.
"""
from __future__ import annotations

import subprocess

H100 = {"hbm_bytes_per_s": 3.35e12, "float32": 67e12, "tf32": 495e12,
        "bfloat16": 989e12}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    only the H100 SXM part (HBM3) is on record."""
    if "H100" in kind and "PCIe" not in kind and "NVL" not in kind:
        return H100
    raise RuntimeError(f"no published peaks on record for {kind!r}")


def power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it, or
    "not read"."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return "not read"
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else "not read"
