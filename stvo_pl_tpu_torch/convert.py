"""Carry VO state between the JAX package and the port.

`state_from_numpy` takes a JAX `VOState` whose leaves were turned into
numpy arrays (for example `jax.tree_util.tree_map(np.asarray, state)`),
batched or not, or any object with the same field names (attributes or
mapping keys), and returns the port's `VOState` on `device`.
`state_to_numpy` goes back to a `VOState` of numpy arrays.  Descriptor
words travel as the reference's uint32 in numpy and as int32 with the same
bits in the port; every other leaf keeps its dtype, so the round trip is
bit-exact.  `index_from_numpy` / `index_to_numpy` do the same for the
`DescriptorIndex` of ops/binary_matcher.py.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from stvo_pl_tpu_torch.device import resolve_device
from stvo_pl_tpu_torch.models.features import LineSet, PointSet
from stvo_pl_tpu_torch.models.frontend import VOState
from stvo_pl_tpu_torch.ops.binary_matcher import DescriptorIndex

_NESTED = {"prev_points": PointSet, "prev_lines": LineSet}


def _get(obj, name):
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def _to_numpy(t: torch.Tensor, name: str) -> np.ndarray:
    a = t.detach().cpu().numpy()
    return a.view(np.uint32) if name == "desc" else a


def state_from_numpy(tree, device=None) -> VOState:
    """JAX VOState of numpy leaves -> the port's VOState on `device`."""
    dev = resolve_device(device)
    fields = {}
    for name in VOState._fields:
        sub = _get(tree, name)
        if name in _NESTED:
            cls = _NESTED[name]
            fields[name] = cls(**{f: _to_torch(_get(sub, f), dev)
                                  for f in cls._fields})
        else:
            fields[name] = _to_torch(sub, dev)
    return VOState(**fields)


def state_to_numpy(state: VOState) -> VOState:
    """The port's VOState -> the same structure with numpy leaves
    (descriptors as uint32)."""
    fields = {}
    for name in VOState._fields:
        sub = getattr(state, name)
        if name in _NESTED:
            fields[name] = type(sub)(**{f: _to_numpy(getattr(sub, f), f)
                                        for f in sub._fields})
        else:
            fields[name] = _to_numpy(sub, name)
    return VOState(**fields)


def index_from_numpy(tree, device=None) -> DescriptorIndex:
    """JAX DescriptorIndex of numpy leaves -> the port's, on `device`."""
    dev = resolve_device(device)
    return DescriptorIndex(**{f: _to_torch(_get(tree, f), dev)
                              for f in DescriptorIndex._fields})


def index_to_numpy(index: DescriptorIndex) -> DescriptorIndex:
    """The port's DescriptorIndex with numpy leaves (descriptors as
    uint32)."""
    return DescriptorIndex(**{f: _to_numpy(getattr(index, f), f)
                              for f in DescriptorIndex._fields})
