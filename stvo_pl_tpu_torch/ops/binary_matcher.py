"""Binary-descriptor matcher: match / knn_match / radius_match over 256-bit
descriptors, plus a multi-image descriptor index (port of
stvo_pl_tpu/ops/binary_matcher.py; reference
3rdparty/line_descriptor/src/binary_descriptor_matcher.cpp `match` :127,
`knnMatch` :258, `radiusMatch` :428 over the dataset accumulated by `add` /
`train`).

The reference library hashes (multi-index hashing) to dodge O(Q * N)
Hamming comparisons on a CPU.  On the card the full distance matrix is the
fast path: every Q * N distance exactly (ops/hamming.py: the bf16 product,
or with `use_mxu=False` the XOR + popcount kernel), then top-k and
threshold reductions in place of bucket probing.

All shapes are static: queries and datasets are fixed-capacity with
validity masks, `k` / `max_results` are plain ints, and unmatched slots
return idx = -1 and dist = 257 (one past the largest possible distance).
Descriptors are [N, 8] int32 words.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from stvo_pl_tpu_torch.device import resolve_device
from stvo_pl_tpu_torch.ops import hamming
from stvo_pl_tpu_torch.ops.lsd import top_k
from stvo_pl_tpu_torch.parallel.compiled import Compiled, compile_fn

INVALID_DIST = 257   # > the largest Hamming distance of 256-bit strings


class DescriptorIndex(NamedTuple):
    """Accumulated descriptor dataset (the reference's `add` + `train`
    state)."""
    desc: torch.Tensor       # [N, 8] int32 packed 256-bit descriptors
    image_id: torch.Tensor   # [N] int32 source-image index per descriptor
    local_id: torch.Tensor   # [N] int32 row within its source image
    valid: torch.Tensor      # [N] bool


def build_index(descs: Sequence[torch.Tensor],
                valids: Sequence[torch.Tensor] | None = None,
                capacity: int | None = None) -> DescriptorIndex:
    """Concatenate per-image descriptor sets into one queryable index on
    the descriptors' device.  "Training" is concatenation: the dense
    distance matrix needs no acceleration structure."""
    n_total = sum(d.shape[0] for d in descs)
    cap = capacity or n_total
    if cap < n_total:
        raise ValueError(f"capacity {cap} < total descriptors {n_total}")
    dev = descs[0].device if len(descs) > 0 else resolve_device()
    desc = torch.zeros((cap, hamming.DESC_WORDS), dtype=torch.int32,
                       device=dev)
    image_id = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    local_id = torch.full((cap,), -1, dtype=torch.int32, device=dev)
    valid = torch.zeros((cap,), dtype=torch.bool, device=dev)
    off = 0
    for i, d in enumerate(descs):
        n = d.shape[0]
        if d.shape[1:] != (hamming.DESC_WORDS,) or d.dtype != torch.int32:
            raise ValueError(f"descriptor set {i}: want [n, 8] int32, got "
                             f"{tuple(d.shape)} {d.dtype}")
        desc[off:off + n] = d.to(dev)
        image_id[off:off + n] = i
        local_id[off:off + n] = torch.arange(n, dtype=torch.int32, device=dev)
        valid[off:off + n] = (True if valids is None
                              else valids[i].to(dev, torch.bool))
        off += n
    return DescriptorIndex(desc, image_id, local_id, valid)


def _masked_dist(query, q_valid, index: DescriptorIndex, use_mxu=True):
    dist = hamming.hamming_matrix(query, index.desc, use_mxu)
    cand = index.valid[None, :]
    if q_valid is not None:
        cand = cand & q_valid.to(torch.bool)[:, None]
    return torch.where(cand, dist, INVALID_DIST)


class KnnMatches(NamedTuple):
    idx: torch.Tensor       # [Q, k] int64 into the index, -1 = no match
    dist: torch.Tensor      # [Q, k] int32 Hamming distance (257 = invalid)
    image_id: torch.Tensor  # [Q, k] int32 source image of each match
    local_id: torch.Tensor  # [Q, k] int32 row within the source image


def knn_match(query: torch.Tensor, index: DescriptorIndex, k: int,
              q_valid: torch.Tensor | None = None,
              use_mxu: bool = True) -> KnnMatches:
    """k nearest descriptors per query [Q, 8] (reference `knnMatch`), exact
    distances, closest first, the lower index first among equal
    distances."""
    if not 1 <= k <= index.desc.shape[0]:
        raise ValueError(f"k={k} outside 1..{index.desc.shape[0]}")
    dist = _masked_dist(query, q_valid, index, use_mxu)
    neg, pos = top_k(-dist, k)
    d = -neg
    ok = d < INVALID_DIST
    return KnnMatches(
        idx=torch.where(ok, pos, -1), dist=d,
        image_id=torch.where(ok, index.image_id[pos], -1),
        local_id=torch.where(ok, index.local_id[pos], -1))


def match(query: torch.Tensor, index: DescriptorIndex,
          q_valid: torch.Tensor | None = None,
          use_mxu: bool = True) -> KnnMatches:
    """Best match per query (reference `match`)."""
    return knn_match(query, index, 1, q_valid, use_mxu)


def radius_match(query: torch.Tensor, index: DescriptorIndex,
                 max_distance: int, max_results: int,
                 q_valid: torch.Tensor | None = None,
                 use_mxu: bool = True) -> KnnMatches:
    """All matches within a Hamming radius (reference `radiusMatch`), as a
    fixed-capacity closest-first list of `max_results` per query; slots
    beyond the in-radius count are idx = -1."""
    res = knn_match(query, index, max_results, q_valid, use_mxu)
    ok = res.dist <= max_distance
    return KnnMatches(
        idx=torch.where(ok, res.idx, -1),
        dist=torch.where(ok, res.dist, INVALID_DIST),
        image_id=torch.where(ok, res.image_id, -1),
        local_id=torch.where(ok, res.local_id, -1))


# the matchers as captured programs (parallel/compiled.py), the
# counterparts of the JAX package's jitted `knn_match`, `match` and
# `radius_match`: `prog(query, index[, q_valid])` equals the eager call
# bit for bit, one graph per query and index shape

def compile_knn_match(k: int, use_mxu: bool = True,
                      device=None) -> Compiled:
    """`knn_match` with `k` and `use_mxu` fixed."""
    return compile_fn(knn_match, ("query", "index", "q_valid"), device,
                      k=k, use_mxu=use_mxu)


def compile_match(use_mxu: bool = True, device=None) -> Compiled:
    """`match` with `use_mxu` fixed."""
    return compile_fn(match, ("query", "index", "q_valid"), device,
                      use_mxu=use_mxu)


def compile_radius_match(max_distance: int, max_results: int,
                         use_mxu: bool = True, device=None) -> Compiled:
    """`radius_match` with `max_distance`, `max_results` and `use_mxu`
    fixed."""
    return compile_fn(radius_match, ("query", "index", "q_valid"), device,
                      max_distance=max_distance, max_results=max_results,
                      use_mxu=use_mxu)
