"""The card's name and power limit as ``nvidia-smi`` reports them.

Read by a child process that stays off JAX, so it can run before a JAX
process takes the card. A card set below its maximum power limit runs
slower under load, so every number measured on it is reported beside this
line.
"""

from __future__ import annotations

import subprocess
from typing import List, Tuple

NVIDIA_SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def query_name_power(timeout: float = 30.0) -> List[str]:
    """One ``"<name>, <limit> W"`` line per card, as nvidia-smi prints
    them. Raises RuntimeError when nvidia-smi is absent or fails."""
    try:
        out = subprocess.run(
            NVIDIA_SMI_QUERY, capture_output=True, text=True, timeout=timeout,
            check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"nvidia-smi failed: {e}") from e
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no GPU")
    return lines


def parse_name_power(line: str) -> Tuple[str, float]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` → ``("NVIDIA H100 80GB HBM3",
    700.0)``. Raises ValueError on any other shape."""
    name, sep, limit = line.rpartition(",")
    limit = limit.strip()
    if not sep or not name.strip() or not limit.endswith("W"):
        raise ValueError(f"unexpected nvidia-smi line: {line!r}")
    return name.strip(), float(limit[:-1].strip())
