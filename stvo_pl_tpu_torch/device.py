"""Device selection for the port's entry points.

Every entry point runs on the GPU unless the caller names the CPU.  A
missing GPU is an error, never a silent move to the CPU: the port's CPU
path exists for tests and small studies, and a caller must ask for it.
"""

from __future__ import annotations

import contextlib
import functools

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


CACHES: list = []           # every per-device constant cache
_owners: list[dict] = []    # programs being captured: id -> constant


def device_cache(fn):
    """A cache of the constants that `fn` builds on a device (its last
    argument): `fn` runs once per argument tuple, and its value is shared
    by every caller, who must not write to it.  A CUDA graph
    (parallel/compiled.py) reads its constants by address but holds no
    reference to them, so every value returned while a program is warmed
    up or captured (inside `owning`) is also held by that program: a
    cleared cache frees nothing a graph reads.  The caches are unbounded;
    `CACHES` lists them."""
    cached = functools.cache(fn)

    @functools.wraps(fn)
    def get(*args):
        value = cached(*args)
        for owned in _owners:
            owned[id(value)] = value
        return value

    get.cache_clear = cached.cache_clear
    get.cache_info = cached.cache_info
    CACHES.append(get)
    return get


@contextlib.contextmanager
def owning(owned: dict):
    """Inside the block every value of a `device_cache` is put in
    `owned` (by id)."""
    _owners.append(owned)
    try:
        yield owned
    finally:
        _owners.pop()


@device_cache
def const(values, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """`torch.tensor(values, dtype=dtype, device=device)` for a number or a
    nested tuple of numbers, uploaded once.  A step captured as a CUDA
    graph may copy nothing from the host, so its constants are built by
    the warm-up call before the capture."""
    return torch.tensor(values, dtype=dtype, device=device)
