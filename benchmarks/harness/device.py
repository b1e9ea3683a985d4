"""The card a run measures, and the modules a run must not load."""

from __future__ import annotations

import subprocess
import sys
from typing import List

# compared by the whole top-level module name: `sags_tpu_torch` is the port
FORBIDDEN = ("jax", "jaxlib", "flax", "sags_tpu")


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX
    package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def require_cards(n: int) -> None:
    """Raise unless `n` CUDA cards are there: a run never falls back to the
    CPU."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card: the benchmark measures the port on one")
    if torch.cuda.device_count() < n:
        raise RuntimeError(f"the cell needs {n} CUDA cards, "
                           f"{torch.cuda.device_count()} are there")


def power_limit_w() -> float:
    """The card's power limit in watts, read by `nvidia-smi` (None when it
    cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def record(count: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(max(torch.cuda.max_memory_allocated(i)
                                         for i in range(count))),
            "power_limit_w": power_limit_w()}
