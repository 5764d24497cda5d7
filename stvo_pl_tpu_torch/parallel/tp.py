"""Feature-sharded matching: brute-force descriptor matching with the
distance matrix's columns split over the mesh's model axis (port of
stvo_pl_tpu/parallel/tp.py).

Each model-axis rank computes the [N, M/P] block of its own train
columns, its local best, second best and per-column best row; one
`all_gather_into_tensor` over the model sub-group merges the partials
into the global nearest-neighbour-ratio + mutual decision, identical bit
for bit to the dense `ops/matching.nnr_mutual_match` on the full matrix
(global column order is shard-major and the first shard wins a tie, so
ties break toward the first column as `argmin` does).

Reference semantics being distributed: `match` / `matchNNR`
(/root/reference/src/matching.cpp:41-91): best < nnr * second, and
matches_21[best] == row for the mutual check.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from stvo_pl_tpu_torch.ops import hamming
from stvo_pl_tpu_torch.ops.matching import BIG, MatchResult
from stvo_pl_tpu_torch.parallel.mesh import MODEL_AXIS, axis


def _merge_shards(d: torch.Tensor, p: int, n_shards: int, group,
                  nnr: float, mutual: bool) -> MatchResult:
    """Merge per-shard partials into the global NNR + mutual decision.

    d: [..., N, m] local masked distance block (BIG where not a candidate)
    of shard p.  Every rank of `group` returns the same MatchResult over
    the global columns."""
    N, m = d.shape[-2:]
    big = torch.full((), BIG, dtype=d.dtype, device=d.device)
    bi = torch.argmin(d, dim=-1)                       # local column
    b = torch.amin(d, dim=-1)
    cols = torch.arange(m, device=d.device)
    s = torch.amin(torch.where(cols == bi[..., None], big, d), dim=-1)
    gi = bi + p * m                                    # global column
    # per-column best row (for the mutual check); a column without a
    # candidate gives a row that is never consulted
    colbest = torch.argmin(d, dim=-2)                  # [..., m]

    part = torch.cat([b.to(torch.int64), gi, s.to(torch.int64), colbest],
                     dim=-1)                           # [..., 3N + m]
    allp = torch.empty(n_shards * part.numel(), dtype=part.dtype,
                       device=part.device)
    dist.all_gather_into_tensor(allp, part.reshape(-1), group=group)
    allp = allp.reshape((n_shards,) + part.shape)
    B = allp[..., :N]                                  # [P, ..., N]
    GI = allp[..., N:2 * N]
    S = allp[..., 2 * N:3 * N]
    CB = allp[..., 3 * N:].movedim(0, -2).flatten(-2)  # [..., P * m]

    pstar = torch.argmin(B, dim=0, keepdim=True)       # first shard wins
    best = torch.gather(B, 0, pstar)[0]
    idx = torch.gather(GI, 0, pstar)[0]
    # global second best: the other shards' minima and the own second
    shard = torch.arange(n_shards, device=d.device).reshape(
        (n_shards,) + (1,) * (B.ndim - 1))
    others = torch.where(shard == pstar, BIG, B)
    second = torch.minimum(torch.amin(others, dim=0),
                           torch.gather(S, 0, pstar)[0])

    ok = (best < BIG) & (best.to(torch.float32)
                         < second.to(torch.float32) * nnr)
    if mutual:
        rows = torch.arange(N, device=d.device)
        ok = ok & (torch.gather(CB, -1, idx) == rows)
    return MatchResult(idx=torch.where(ok, idx, torch.full_like(idx, -1)),
                       valid=ok)


def tp_match_inner(desc1: torch.Tensor, desc2: torch.Tensor,
                   cand: torch.Tensor, nnr: float, group, n_shards: int,
                   mutual: bool = True, wta_k: int = 2,
                   use_mxu: bool = True) -> MatchResult:
    """Column-sharded matching inside a sharded step: desc1 [..., N, 8],
    desc2 [..., M, 8] and cand [..., N, M] are the same on every rank of
    the model-axis `group` (the front end computes features identically
    on each); each rank computes the distance block of its own M/n_shards
    train columns and one all-gather merges.  Bit-identical to
    `nnr_mutual_match(distance_matrix(desc1, desc2, wta_k), cand, nnr)`."""
    M = desc2.shape[-2]
    if M % n_shards != 0:
        raise ValueError(f"train set {M} not divisible by {n_shards} shards")
    m = M // n_shards
    p = dist.get_rank(group)
    d2s = desc2[..., p * m:(p + 1) * m, :]
    cs = cand[..., p * m:(p + 1) * m]
    blk = hamming.distance_matrix(desc1, d2s, use_mxu, wta_k=wta_k)
    d = torch.where(cs, blk, torch.full((), BIG, dtype=blk.dtype,
                                        device=blk.device))
    return _merge_shards(d, p, n_shards, group, nnr, mutual)


def tp_match(desc1: torch.Tensor, valid1: torch.Tensor,
             desc2_shard: torch.Tensor, valid2_shard: torch.Tensor,
             nnr: float, mesh, mutual: bool = True,
             axis_name: str = MODEL_AXIS) -> MatchResult:
    """Sharded brute-force kNN + NNR + mutual matching, the stand-alone
    form.  desc1 [N, 8] int32 and valid1 [N] are the same on every rank;
    desc2_shard [M/P, 8] and valid2_shard [M/P] are this rank's shard of
    the train set along the mesh's `axis_name` (shard p holds rows
    p*M/P .. (p+1)*M/P - 1).  Every rank returns the MatchResult of
    `nnr_mutual_match(hamming_matrix(desc1, desc2), valid1 x valid2, nnr)`
    over the global columns; the distances are XOR + popcount (the B5
    kernel on CUDA tensors)."""
    group, n, p = axis(mesh, axis_name)
    blk = hamming.hamming_matrix(desc1, desc2_shard, use_mxu=False)
    cand = valid1[:, None] & valid2_shard[None, :]
    d = torch.where(cand, blk, torch.full((), BIG, dtype=blk.dtype,
                                          device=blk.device))
    return _merge_shards(d, p, n, group, nnr, mutual)
