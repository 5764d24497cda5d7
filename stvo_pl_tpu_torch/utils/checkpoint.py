"""Checkpoint / resume of VO state (port of stvo_pl_tpu/utils/checkpoint.py;
absent in the reference, whose closest capability is the dataset offset
restart, src/dataset.cpp:133-140).

A checkpoint is a directory: `state.pt`, a `torch.save` of the state's
tensors as one flat {dotted.field.path: CPU tensor} dict, and `meta.json`
with {"frame_idx", "extra"}.  The state is any tree of NamedTuples,
tuples, lists and dicts of tensors (None leaves stay None): a `VOState`,
batched or not, with its nested `PointSet` / `LineSet`.  Loading reads
the file with `weights_only=True`, so no class is unpickled, and rebuilds
the template's structure: each tensor takes the template leaf's dtype and
device, and a missing key, an extra key or another shape raises.
"""

from __future__ import annotations

import json
import os

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


def _children(node):
    """(key, child) pairs of an inner node, or None for a leaf."""
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(str(i), c) for i, c in enumerate(node)]
    if isinstance(node, dict):
        return [(str(k), c) for k, c in node.items()]
    return None


def _rebuild(node, children):
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*children)
    if isinstance(node, (tuple, list)):
        return type(node)(children)
    return dict(zip(node.keys(), children))


def flatten(tree, prefix: str = "") -> dict[str, torch.Tensor]:
    """{dotted path: tensor} of every tensor leaf of `tree`."""
    kids = _children(tree)
    if kids is None:
        if tree is None:
            return {}
        if not isinstance(tree, torch.Tensor):
            raise TypeError(f"checkpoint leaf {prefix or '<root>'} is a "
                            f"{type(tree).__name__}, not a tensor")
        return {prefix: tree}
    out = {}
    for key, child in kids:
        out.update(flatten(child, f"{prefix}.{key}" if prefix else key))
    return out


def _fill(template, flat: dict, prefix: str):
    kids = _children(template)
    if kids is None:
        if template is None:
            return None
        if prefix not in flat:
            raise KeyError(f"checkpoint has no {prefix!r}")
        t = flat.pop(prefix)
        if t.shape != template.shape:
            raise ValueError(f"checkpoint {prefix!r} has shape "
                             f"{tuple(t.shape)}, the template "
                             f"{tuple(template.shape)}")
        return t.to(dtype=template.dtype, device=template.device)
    return _rebuild(template, [
        _fill(c, flat, f"{prefix}.{k}" if prefix else k) for k, c in kids])


def save_state(path: str, state, frame_idx: int,
               extra: dict | None = None) -> None:
    """Write a checkpoint directory: the state's tensors, copied to the
    CPU, and a JSON sidecar with the frame index and `extra`."""
    os.makedirs(path, exist_ok=True)
    flat = {k: v.detach().cpu() for k, v in flatten(state).items()}
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}")
    torch.save(flat, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump({"frame_idx": int(frame_idx), "extra": extra or {}}, f)


def load_state(path: str, template):
    """Restore (state, frame_idx, extra).  `template` (for example
    `frontend.init_state(cfg, device=...)`) fixes the structure, dtypes
    and devices."""
    flat = torch.load(os.path.join(path, STATE_FILE), weights_only=True,
                      map_location="cpu")
    state = _fill(template, flat, "")
    if flat:
        raise ValueError(f"checkpoint keys not in the template: "
                         f"{sorted(flat)}")
    with open(os.path.join(path, META_FILE)) as f:
        meta = json.load(f)
    return state, meta["frame_idx"], meta.get("extra", {})
