"""The card: the refusal to run without one, its name, count and power
limit, and the table of published peaks the rooflines and the MFU are
shares of."""

from __future__ import annotations

import subprocess
from typing import Optional

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks(kind: str) -> Optional[dict]:
    for key, table in PEAKS.items():
        if key in kind:
            return table
    return None


def require(chips: int) -> None:
    """Exit non-zero, before any result, without ``chips`` CUDA cards."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is false: the benchmark runs "
                         "only on a CUDA card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell needs {chips} cards, "
                         f"torch.cuda.device_count() is {torch.cuda.device_count()}")


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def describe(chips: int, peak_bytes: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "memory_peak_bytes": int(peak_bytes), "power_limit": power_limit()}
