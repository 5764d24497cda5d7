"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller names the CPU.  A
missing GPU is an error, never a silent move to the CPU: the port's CPU
path exists for tests and small studies, and a caller must ask for it.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """"cuda" by default; raises when a CUDA device is asked for (or
    defaulted to) and none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "stvo_pl_tpu_torch: no CUDA device is available; pass "
            "device='cpu' to run the CPU path explicitly")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
