"""Small-matrix linear algebra for the 6-DoF normal equations, batched
over leading dims of [..., 6, 6].

Port of stvo_pl_tpu/ops/linalg.py.  The algorithms are the reference's,
written out in elementwise tensor operations instead of `torch.linalg`, so
that the success flags follow the same rules and no call waits on the host
(the `torch.linalg` factorizations check their info codes on the host):

  * `solve6` / `inv6`: Cholesky of H + 1e-10 max|diag H| I; a pivot that
    is not finite or not above the smallest normal float marks the
    factorization failed (LAPACK potrf fails on pivots <= 0, and the
    reference runs with denormals flushed to zero, so a denormal jitter
    on an all-zero H fails there too);
  * `eigvalsh6`: cyclic Jacobi with the parallel (round-robin) ordering,
    a fixed number of sweeps, carried in float64 (in float32 its rotations
    accumulate ~3x the rounding error of LAPACK's syevd);
  * `logdet6`: LU with partial pivoting (first maximal pivot, as getrf).
"""

from __future__ import annotations

import functools

import torch

_N = 6
JACOBI_SWEEPS = 8


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(_N, dtype=like.dtype, device=like.device)


def _cholesky6(H: torch.Tensor):
    """(L, ok): lower Cholesky factor of H plus a small relative jitter;
    L is the identity where the factorization failed."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    scale = torch.clamp(torch.amax(torch.abs(diag), dim=-1), min=1e-30)
    A = H + (1e-10 * scale)[..., None, None] * _eye(H)
    L = [[None] * _N for _ in range(_N)]
    ok = torch.ones(H.shape[:-2], dtype=torch.bool, device=H.device)
    for j in range(_N):
        s = A[..., j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        ok = ok & (s > torch.finfo(s.dtype).tiny)
        ljj = torch.sqrt(s)
        L[j][j] = ljj
        for i in range(j + 1, _N):
            v = A[..., i, j]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v / ljj
    zero = torch.zeros_like(A[..., 0, 0])
    L = torch.stack([torch.stack([L[i][j] if j <= i else zero
                                  for j in range(_N)], dim=-1)
                     for i in range(_N)], dim=-2)
    ok = ok & torch.all(torch.isfinite(L.reshape(L.shape[:-2] + (-1,))),
                        dim=-1)
    L = torch.where(ok[..., None, None], L, _eye(H).expand_as(L))
    return L, ok


def _forward(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve L Y = B for lower-triangular L; B [..., 6, m]."""
    ys = []
    for i in range(_N):
        v = B[..., i, :]
        for k in range(i):
            v = v - L[..., i, k, None] * ys[k]
        ys.append(v / L[..., i, i, None])
    return torch.stack(ys, dim=-2)


def _backward_t(L: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Solve L^T X = Y for lower-triangular L; Y [..., 6, m]."""
    xs = [None] * _N
    for i in range(_N - 1, -1, -1):
        v = Y[..., i, :]
        for k in range(i + 1, _N):
            v = v - L[..., k, i, None] * xs[k]
        xs[i] = v / L[..., i, i, None]
    return torch.stack(xs, dim=-2)


def solve6(H: torch.Tensor, g: torch.Tensor):
    """Solve H x = g for 6x6 SPD H.  Returns (x, ok); ok mirrors the
    reference's QR success + log|det| >= 0 gate, and x is 0 where not
    ok."""
    L, ok_chol = _cholesky6(H)
    x = _backward_t(L, _forward(L, g[..., None]))[..., 0]
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    logdet = 2.0 * torch.sum(torch.log(torch.clamp(diag, min=1e-300)),
                             dim=-1)
    ok = (ok_chol & torch.isfinite(logdet) & (logdet >= 0.0)
          & torch.all(torch.isfinite(x), dim=-1))
    x = torch.where(ok[..., None], x, torch.zeros_like(x))
    return x, ok


def inv6(H: torch.Tensor) -> torch.Tensor:
    """H^{-1} through the Cholesky factor; zeros where it failed."""
    L, ok = _cholesky6(H)
    I = _eye(H).expand_as(H)
    Hinv = _backward_t(L, _forward(L, I))
    return torch.where(ok[..., None, None], Hinv, torch.zeros_like(Hinv))


def _round_robin_pairs() -> list[tuple[list[int], list[int]]]:
    """5 rounds of 3 disjoint (p, q) pairs covering all 15 pairs of 6."""
    players = list(range(_N))
    rounds = []
    for _ in range(_N - 1):
        pairs = [(players[i], players[_N - 1 - i]) for i in range(_N // 2)]
        pairs = [(min(p, q), max(p, q)) for p, q in pairs]
        rounds.append(([p for p, _ in pairs], [q for _, q in pairs]))
        players = [players[0], players[-1]] + players[1:-1]
    return rounds


_ROUNDS = _round_robin_pairs()


@functools.lru_cache(maxsize=8)
def _round_index(device: torch.device):
    return [(torch.tensor(ps, device=device), torch.tensor(qs, device=device))
            for ps, qs in _ROUNDS]


def eigvalsh6(M: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of a symmetric 6x6 (batched) by cyclic Jacobi.

    Each round applies three disjoint plane rotations at once,
    A <- J^T A J, with the symmetric Schur rotation that zeroes A[p, q]."""
    A = M.to(torch.float64)
    lead = M.shape[:-2]
    I = _eye(A).expand(lead + (_N, _N))
    for _ in range(JACOBI_SWEEPS):
        for p, q in _round_index(M.device):
            app = A[..., p, p]
            aqq = A[..., q, q]
            apq = A[..., p, q]
            nz = apq != 0
            tau = (aqq - app) / (2.0 * torch.where(nz, apq,
                                                   torch.ones_like(apq)))
            sgn = torch.where(tau >= 0, 1.0, -1.0).to(A.dtype)
            t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
            t = torch.where(nz, t, torch.zeros_like(t))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            J = I.clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            JT = J.transpose(-1, -2)
            A = torch.sum(JT[..., :, :, None] * A[..., None, :, :], dim=-2)
            A = torch.sum(A[..., :, :, None] * J[..., None, :, :], dim=-2)
    ev = torch.diagonal(A, dim1=-2, dim2=-1)
    return torch.sort(ev, dim=-1).values.to(M.dtype)


def logdet6(M: torch.Tensor) -> torch.Tensor:
    """log(det(M)) by LU with partial pivoting; -inf where det <= 0."""
    A = M
    lead = M.shape[:-2]
    sign = torch.ones(lead, dtype=M.dtype, device=M.device)
    logabs = torch.zeros(lead, dtype=M.dtype, device=M.device)
    rows = torch.arange(_N, device=M.device)
    for j in range(_N):
        piv = j + torch.argmax(torch.abs(A[..., j:, j]), dim=-1)
        perm = rows.expand(lead + (_N,)).clone()
        perm = perm.scatter(-1, piv[..., None], j)
        perm[..., j] = piv
        A = torch.gather(A, -2, perm[..., None].expand(lead + (_N, _N)))
        sign = torch.where(piv != j, -sign, sign)
        pivot = A[..., j, j]
        sign = sign * torch.sign(pivot)
        logabs = logabs + torch.log(torch.abs(pivot))
        safe = torch.where(pivot == 0, torch.ones_like(pivot), pivot)
        factor = A[..., j + 1:, j] / safe[..., None]
        lower = A[..., j + 1:, :] - factor[..., None] * A[..., j:j + 1, :]
        A = torch.cat([A[..., :j + 1, :], lower], dim=-2)
    return torch.where(sign > 0, logabs,
                       torch.full_like(logabs, float("-inf")))
