"""The plain reference of the online cell's back end: windowed bundle
adjustment over keyframes, in plain PyTorch, float64 unless asked
otherwise.

Written anew from the semantics that the program's back end documents
(`WindowedBA` in `stvo_pl_tpu_torch/models/backend.py`, the window refiner
in `parallel/window.py`, the solver in `parallel/ba.py`); it imports
nothing of the program.  What it does:

- keyframes: frame 0 of a sequence, every frame the front end flags, and
  a frame `kf_every` frames after the last keyframe; each keyframe keeps
  its pose (the chain's correction applied) and the front end's point and
  line sets of that frame; a window closes at `window` keyframes;
- landmark tracks: every pair of a window's keyframes is matched by
  Hamming distance (nearest-neighbour ratio, mutual best); a track is a
  connected component of the match graph, rooted at its lowest (keyframe,
  slot) member, seen in two keyframes or more, placed at the root's stereo
  back-projection; where two members share a keyframe the later slot is
  the observation; observations farther than `reproj_gate` px from that
  placement, or in front of 0.1 m, are dropped.  Line tracks likewise on
  the line descriptors, between lines whose directions agree within
  `line_sim_th`, with the endpoint-to-line distance as the gate;
- solve: `n_iters` Gauss-Newton steps from the keyframes' poses, Cauchy
  weights on the residuals (a point's stereo reprojection, a line
  endpoint's distance to the observed line times the segments' overlap),
  the landmarks' 3x3 blocks damped by a thousandth of their mean diagonal
  and eliminated (Schur complement), the pose system damped by `damping`,
  pose 0 held.  The joint point-and-line solution stands where its point
  cost (at the initial landmarks) is within `chi2_tol` of the points-only
  solution's and no pose differs from it by more than `max_disagree_t` m
  or `max_disagree_r` deg; otherwise the points-only solution;
- trust gate and chain: a window whose solution moves a keyframe more than
  `max_correction` m or `max_rot_correction` deg from its input is
  skipped (poses kept, the ring restarts at its last keyframe); otherwise
  the refined last keyframe anchors the next window, and its correction
  applies to every later pose.

`BackEnd.observe` takes what the program's `WindowedBA.observe` takes and
returns what it returns.  The harness replays a run's frames through it
after the window (`replay`), window by window from the program's own
chain: where the program refined a window, its refined last keyframe, not
the reference's, anchors the next window, so that each window is judged
from the inputs the program had.  The chain itself is the reference's
arithmetic (correction = refined last pose times the inverse of its raw
pose), and the first window of a sequence starts from the raw poses.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

BIG = 2 ** 30


class Settings(NamedTuple):
    window: int
    kf_every: int
    n_iters: int
    damping: float
    reproj_gate: float
    chi2_tol: float
    max_disagree_t: float
    max_disagree_r: float
    max_correction: float
    max_rot_correction: float
    ratio_p: float
    ratio_l: float
    mutual: bool
    line_sim_th: float
    has_lines: bool

    @classmethod
    def of(cls, vo: dict, ba: dict) -> "Settings":
        """From a configuration's `vo` table and a traffic's `ba` table
        (256-bit descriptors compared bit by bit: `orb_wta_k` 2)."""
        if vo["orb_wta_k"] != 2:
            raise ValueError("the reference compares WTA_K = 2 descriptors")
        return cls(window=ba["window"], kf_every=ba["kf_every"],
                   n_iters=ba["n_iters"], damping=ba["damping"],
                   reproj_gate=ba["reproj_gate"], chi2_tol=ba["chi2_tol"],
                   max_disagree_t=ba["max_disagree_t"],
                   max_disagree_r=ba["max_disagree_r"],
                   max_correction=ba["max_correction"],
                   max_rot_correction=ba["max_rot_correction"],
                   ratio_p=vo["min_ratio_12_p"], ratio_l=vo["min_ratio_12_l"],
                   mutual=vo["best_lr_matches"],
                   line_sim_th=vo["line_sim_th"], has_lines=vo["has_lines"])


class Window(NamedTuple):
    """A closed window: its frames, whether it was refined, and the
    refined poses [K, 4, 4] camera-to-world (None where skipped)."""
    idxs: tuple
    refined: bool
    T: np.ndarray | None


# --- geometry -------------------------------------------------------------

def skew(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def expmap(xi):
    """[..., 6] twist (translation, rotation) -> [..., 4, 4]."""
    t, w = xi[..., :3], xi[..., 3:]
    t2 = (w * w).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    A = torch.where(small, 1 - t2 / 6, torch.sin(th) / th)
    B = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(th)) / t2s)
    C = torch.where(small, 1 / 6 - t2 / 120, (th - torch.sin(th)) / (t2s * th))
    W = skew(w)
    W2 = mm(W, W)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[..., None, None] * W + B[..., None, None] * W2
    V = eye + B[..., None, None] * W + C[..., None, None] * W2
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = R
    T[..., :3, 3] = mm(V, t[..., None])[..., 0]
    T[..., 3, 3] = 1
    return T


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    out = torch.zeros_like(T)
    out[..., :3, :3] = Rt
    out[..., :3, 3] = -mm(Rt, T[..., :3, 3:4])[..., 0]
    out[..., 3, 3] = 1
    return out


def back_project(cam, uv, disp):
    bd = cam.b / disp
    return torch.stack([bd * (uv[..., 0] - cam.cx), bd * (uv[..., 1] - cam.cy),
                        bd * cam.fx], -1)


def _safe(z):
    return torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)


def _to_camera(poses_cw, X):
    """poses_cw [K, 4, 4], X [N, ..., 3] -> [N, K, ..., 3]."""
    R, t = poses_cw[:, :3, :3], poses_cw[:, :3, 3]
    extra = X.dim() - 2
    Xe = X.unsqueeze(1)                                  # [N, 1, ..., 3]
    Re = R.reshape(R.shape[:1] + (1,) * extra + (3, 3))
    te = t.reshape(t.shape[:1] + (1,) * extra + (3,))
    return mm(Re, Xe[..., None])[..., 0] + te


def _cauchy(x):
    return 1.0 / (1.0 + x * x)


# --- products: every matrix product and contraction goes through these,
# so that the control can read their operands in TF32 -----------------------

_operand = None          # applied to each product's operands, or None


def tf32(x):
    """float32 -> the nearest value with TF32's 10 mantissa bits (ties away
    from zero), as tensor cores read a TF32 operand."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


@contextlib.contextmanager
def products_in(round_operand):
    """Within: every product reads its operands through `round_operand`
    (`tf32`: products in TF32 with float32 sums)."""
    global _operand
    old, _operand = _operand, round_operand
    try:
        yield
    finally:
        _operand = old


def mm(a, b):
    if _operand is not None:
        a, b = _operand(a), _operand(b)
    return a @ b


def ein(eq, *ops):
    if _operand is not None:
        ops = [_operand(o) for o in ops]
    return torch.einsum(eq, *ops)


# --- tracks ---------------------------------------------------------------

def hamming(a, b):
    """[N, 8] and [M, 8] int32 descriptors -> [N, M] int64 bit distances."""
    sh = torch.arange(32, device=a.device)

    def bits(d):
        x = (d.to(torch.int64)[..., None] >> sh) & 1
        return x.reshape(d.shape[0], 256).to(torch.float32)

    A, B = bits(a), bits(b)
    return (A @ (1 - B).T + (1 - A) @ B.T).round().to(torch.int64)


def match(dist, cand, ratio: float, mutual: bool):
    """Nearest-neighbour ratio and mutual best; (idx [N], ok [N]).  The
    ratio test compares in float32, as the configuration states it."""
    d = torch.where(cand, dist, torch.full_like(dist, BIG))
    bi = torch.argmin(d, 1)
    best = d.gather(1, bi[:, None])[:, 0]
    d2 = d.clone()
    d2[torch.arange(d.shape[0], device=d.device), bi] = BIG
    second = d2.min(1).values
    ok = (best < BIG) & (best.to(torch.float32)
                         < second.to(torch.float32) * ratio)
    if mutual:
        ok &= torch.argmin(d, 0)[bi] == torch.arange(d.shape[0],
                                                      device=d.device)
    return bi, ok


def components(n: int, edges: list, valid):
    """Component labels (the lowest flat index of each component) of the
    graph on n nodes; BIG for invalid nodes."""
    lab = torch.arange(n, device=valid.device)
    if edges:
        u = torch.cat([e[0] for e in edges])
        v = torch.cat([e[1] for e in edges])
        while True:
            m = torch.minimum(lab[u], lab[v])
            new = lab.scatter_reduce(0, u, m, "amin")
            new = new.scatter_reduce(0, v, m, "amin")
            new = new[new]
            if torch.equal(new, lab):
                break
            lab = new
    return torch.where(valid, lab, torch.full_like(lab, BIG))


def _tracks(desc, valid, ratio, mutual, cand_fn=None):
    """Labels [K*N] of the match graph over a window's [K, N] features."""
    K, N = valid.shape
    edges = []
    for a in range(K):
        for b in range(a + 1, K):
            cand = valid[a][:, None] & valid[b][None, :]
            if cand_fn is not None:
                cand = cand & cand_fn(a, b)
            j, ok = match(hamming(desc[a], desc[b]), cand, ratio, mutual)
            i = torch.nonzero(ok)[:, 0]
            edges.append((a * N + i, b * N + j[i]))
    return components(K * N, edges, valid.reshape(-1))


def _table(labels, valid, obs_node, K):
    """The track table: row = a member's root, column = its keyframe, the
    highest flat index winning a shared cell.  (obs [KN, K, C], written
    [KN, K])."""
    n = labels.shape[0]
    N = n // K
    k_of = torch.arange(n, device=labels.device) // N
    keep = valid & (labels < n)
    cell = torch.where(keep, labels * K + k_of, torch.full_like(labels, n * K))
    win = torch.full((n * K + 1,), -1, dtype=torch.int64, device=labels.device)
    win = win.scatter_reduce(0, cell, torch.arange(n, device=labels.device),
                             "amax")[:-1]
    written = win >= 0
    obs = torch.where(written[:, None], obs_node[win.clamp(min=0)],
                      torch.zeros_like(obs_node[:1]))
    return obs.reshape(n, K, -1), written.reshape(n, K), k_of


class Problem(NamedTuple):
    X: torch.Tensor        # [N, 3] world points
    obs: torch.Tensor      # [N, K, 3] (u, v, u_right)
    mask: torch.Tensor     # [N, K]
    sigma2: torch.Tensor   # [N]
    Xl: torch.Tensor | None = None      # [L, 2, 3] world endpoints
    obs_l: torch.Tensor | None = None   # [L, K, 7] line, start, end
    mask_l: torch.Tensor | None = None  # [L, K]
    sigma2_l: torch.Tensor | None = None


def build(Tfw, pts: dict, lines: dict | None, cam, s: Settings) -> Problem:
    """The window's point (and line) tracks.  Tfw [K, 4, 4]; pts / lines:
    the keyframes' feature sets as dicts of [K, n, ...] tensors."""
    K, N = pts["valid"].shape
    valid = pts["valid"].reshape(-1)
    lab = _tracks(pts["desc"], pts["valid"], s.ratio_p, s.mutual)
    uv = pts["uv"].reshape(-1, 2)
    disp = pts["disp"].reshape(-1)
    obs, mask, k_of = _table(lab, valid, torch.stack(
        [uv[:, 0], uv[:, 1], uv[:, 0] - disp], -1), K)
    P = back_project(cam, uv, torch.where(disp > 1e-3, disp,
                                          torch.ones_like(disp)))
    Xn = mm(Tfw[k_of, :3, :3], P[..., None])[..., 0] + Tfw[k_of, :3, 3]
    idx = torch.arange(K * N, device=lab.device)
    live = (lab == idx) & valid & (mask.sum(-1) >= 2)
    X = torch.where(live[:, None], Xn, torch.zeros_like(Xn))
    Pc = _to_camera(inverse(Tfw), X)                       # [KN, K, 3]
    z = _safe(Pc[..., 2])
    u = cam.cx + cam.fx * Pc[..., 0] / z
    v = cam.cy + cam.fy * Pc[..., 1] / z
    err = torch.maximum((u - obs[..., 0]).abs(), (v - obs[..., 1]).abs())
    mask = mask & live[:, None] & (err < s.reproj_gate) & (Pc[..., 2] > 0.1)
    sig = pts["sigma2"].reshape(-1)
    prob = Problem(X=X, obs=obs, mask=mask,
                   sigma2=torch.where(live, sig, torch.ones_like(sig)))
    if lines is None:
        return prob
    L = lines["valid"].shape[1]
    lvalid = lines["valid"].reshape(-1)
    d = lines["epl"] - lines["spl"]
    dirs = d / d.norm(dim=-1, keepdim=True).clamp(min=1e-6)
    lab = _tracks(lines["desc"], lines["valid"], s.ratio_l, s.mutual,
                  lambda a, b: mm(dirs[a], dirs[b].T).abs() > s.line_sim_th)
    node = torch.cat([lines["le"].reshape(-1, 3), lines["spl"].reshape(-1, 2),
                      lines["epl"].reshape(-1, 2)], -1)
    obs_l, mask_l, k_of = _table(lab, lvalid, node, K)
    Ps = back_project(cam, lines["spl"].reshape(-1, 2),
                      lines["sdisp"].reshape(-1).clamp(min=1e-3))
    Pe = back_project(cam, lines["epl"].reshape(-1, 2),
                      lines["edisp"].reshape(-1).clamp(min=1e-3))
    R, t = Tfw[k_of, :3, :3], Tfw[k_of, :3, 3]
    Xl = torch.stack([mm(R, Ps[..., None])[..., 0] + t,
                      mm(R, Pe[..., None])[..., 0] + t], 1)
    idx = torch.arange(K * L, device=lab.device)
    live = (lab == idx) & lvalid & (mask_l.sum(-1) >= 2)
    Xl = torch.where(live[:, None, None], Xl, torch.zeros_like(Xl))
    Pc = _to_camera(inverse(Tfw), Xl)                     # [KL, K, 2, 3]
    z = _safe(Pc[..., 2])
    u = cam.cx + cam.fx * Pc[..., 0] / z
    v = cam.cy + cam.fy * Pc[..., 1] / z
    le = obs_l[..., :3]
    derr = (le[..., 0:1] * u + le[..., 1:2] * v + le[..., 2:3]).abs()
    mask_l = (mask_l & live[:, None] & (derr < s.reproj_gate).all(-1)
              & (Pc[..., 2] > 0.1).all(-1))
    sig = lines["sigma2"].reshape(-1)
    return prob._replace(Xl=Xl, obs_l=obs_l, mask_l=mask_l,
                         sigma2_l=torch.where(live, sig, torch.ones_like(sig)))


# --- solve ----------------------------------------------------------------

def _point_terms(poses_cw, p: Problem, cam):
    """Residuals r [N, K, 3], pose Jacobian A [N, K, 3, 6], landmark
    Jacobian B [N, K, 3, 3], weights w [N, K] (zero where unobserved)."""
    Pc = _to_camera(poses_cw, p.X)
    x, y, z = Pc[..., 0], Pc[..., 1], _safe(Pc[..., 2])
    r = torch.stack([cam.cx + cam.fx * x / z, cam.cy + cam.fy * y / z,
                     cam.cx + cam.fx * (x - cam.b) / z], -1) - p.obs
    o = torch.zeros_like(z)
    Jp = torch.stack([
        torch.stack([cam.fx / z, o, -cam.fx * x / z ** 2], -1),
        torch.stack([o, cam.fy / z, -cam.fy * y / z ** 2], -1),
        torch.stack([cam.fx / z, o, -cam.fx * (x - cam.b) / z ** 2], -1)], -2)
    A = torch.cat([Jp, -mm(Jp, skew(Pc))], -1)
    B = mm(Jp, poses_cw[:, :3, :3])
    rn = r.norm(dim=-1)
    w = torch.where(p.mask, _cauchy(rn * p.sigma2.sqrt()[:, None]),
                    torch.zeros_like(rn))
    return r, A, B, w, rn


def _overlap(sp, ep, ps, pe):
    l = ep - sp
    den = (l * l).sum(-1).clamp(min=1e-12)
    a = ((ps - sp) * l).sum(-1) / den
    b = ((pe - sp) * l).sum(-1) / den
    return (torch.maximum(a, b).clamp(max=1.0)
            - torch.minimum(a, b).clamp(min=0.0)).clamp(0.0, 1.0)


def _line_terms(poses_cw, p: Problem, cam):
    """Per endpoint (M = 2 L landmarks, one row each): r [M, K, 1], A
    [M, K, 1, 6], B [M, K, 1, 3], w [M, K]."""
    Pc = _to_camera(poses_cw, p.Xl)                       # [L, K, 2, 3]
    x, y, zr = Pc[..., 0], Pc[..., 1], Pc[..., 2]
    z = _safe(zr)
    u, v = cam.cx + cam.fx * x / z, cam.cy + cam.fy * y / z
    a, b, c = (p.obs_l[..., i:i + 1] for i in range(3))
    r = a * u + b * v + c                                 # [L, K, 2]
    g = torch.stack([a * cam.fx / z, b * cam.fy / z,
                     -(a * cam.fx * x + b * cam.fy * y) / z ** 2], -1)
    A = torch.cat([g, -mm(g[..., None, :], skew(Pc))[..., 0, :]], -1)
    B = mm(g[..., None, :], poses_cw[None, :, None, :3, :3])[..., 0, :]
    rn = r.norm(dim=-1)
    ov = _overlap(p.obs_l[..., 3:5], p.obs_l[..., 5:7],
                  torch.stack([u[..., 0], v[..., 0]], -1),
                  torch.stack([u[..., 1], v[..., 1]], -1))
    w = torch.where(p.mask_l & (zr > 0.1).all(-1),
                    _cauchy(rn * p.sigma2_l.sqrt()[:, None]) * ov,
                    torch.zeros_like(rn))
    L, K = rn.shape
    return (r.transpose(1, 2).reshape(2 * L, K, 1),
            A.transpose(1, 2).reshape(2 * L, K, 1, 6),
            B.transpose(1, 2).reshape(2 * L, K, 1, 3),
            w[:, None, :].expand(L, 2, K).reshape(2 * L, K))


def _eliminate(r, A, B, w):
    """The landmarks' contribution to the reduced pose system: (S [K, 6,
    K, 6], b [K, 6], back-substitution terms)."""
    K = A.shape[1]
    Aw, Bw = A * w[..., None, None], B * w[..., None, None]
    Hpp = ein("mkai,mkaj->kij", Aw, A)
    Hll = ein("mkai,mkaj->mij", Bw, B)
    U = ein("mkai,mkaj->mkij", Aw, B)
    bp = -ein("mkai,mka->ki", Aw, r)
    bl = -ein("mkai,mka->mi", Bw, r)
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    lam = 1e-3 * Hll.diagonal(dim1=-2, dim2=-1).sum(-1) / 3 + 1e-6
    Hinv = torch.linalg.inv(Hll + lam[:, None, None] * eye)
    UH = ein("mkij,mjl->mkil", U, Hinv)
    S = -ein("mkil,mnjl->kinj", UH, U)
    k = torch.arange(K, device=A.device)
    S[k, :, k, :] += Hpp
    b = bp - ein("mkij,mj->ki", UH, bl)
    return S, b, (Hinv, U, bl)


def _substitute(terms, dxi, X, seen):
    Hinv, U, bl = terms
    dX = ein("mij,mj->mi", Hinv, bl - ein("mkij,ki->mj",
                                                              U, dxi))
    return X + torch.where(seen[:, None], dX, torch.zeros_like(dX))


def solve(poses_cw, p: Problem, cam, n_iters: int, damping: float):
    """n_iters damped Gauss-Newton steps; returns (poses_cw, problem with
    the refined landmarks)."""
    K = poses_cw.shape[0]
    n = 6 * K
    eye = torch.eye(n, dtype=poses_cw.dtype, device=poses_cw.device)
    pin = torch.arange(n, device=eye.device) < 6
    for _ in range(n_iters):
        r, A, B, w, _ = _point_terms(poses_cw, p, cam)
        S, b, tp = _eliminate(r, A, B, w)
        tl = None
        if p.Xl is not None:
            S_l, b_l, tl = _eliminate(*_line_terms(poses_cw, p, cam))
            S, b = S + S_l, b + b_l
        S = S.reshape(n, n) + damping * eye
        S = torch.where(pin[:, None] | pin[None, :], eye, S)
        b = torch.where(pin, torch.zeros_like(b.reshape(-1)), b.reshape(-1))
        dxi = torch.linalg.solve(S, b).reshape(K, 6)
        dxi = torch.cat([torch.zeros_like(dxi[:1]), dxi[1:]])
        X = _substitute(tp, dxi, p.X, p.mask.any(1))
        Xl = p.Xl
        if tl is not None:
            L = p.Xl.shape[0]
            seen = p.mask_l[:, None, :].expand(L, 2, K).reshape(2 * L, K)
            Xl = _substitute(tl, dxi, p.Xl.reshape(2 * L, 3),
                             seen.any(1)).reshape(L, 2, 3)
        poses_cw = mm(expmap(dxi), poses_cw)
        p = p._replace(X=X, Xl=Xl)
    return poses_cw, p


def point_cost(poses_cw, p: Problem, cam):
    _, _, _, w, rn = _point_terms(poses_cw, p, cam)
    return (w * rn * rn).sum()


def _angle_deg(R):
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    return torch.rad2deg(torch.arccos(((tr - 1) / 2).clamp(-1, 1)))


def refine(Tfw, pts, lines, cam, s: Settings):
    """The window's refined poses [K, 4, 4] camera-to-world (see the
    module's docstring)."""
    p = build(Tfw, pts, lines, cam, s)
    cw0 = inverse(Tfw)
    pp = p._replace(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    cw_p, _ = solve(cw0, pp, cam, s.n_iters, s.damping)
    if p.Xl is None:
        return inverse(cw_p)
    cw_j, _ = solve(cw0, p, cam, s.n_iters, s.damping)
    D = mm(cw_j, inverse(cw_p))
    joint = (point_cost(cw_j, pp, cam)
             <= s.chi2_tol * point_cost(cw_p, pp, cam)
             and D[:, :3, 3].norm(dim=-1).max() <= s.max_disagree_t
             and _angle_deg(D[:, :3, :3]).max() <= s.max_disagree_r)
    return inverse(cw_j if joint else cw_p)


# --- the back end ---------------------------------------------------------

def _stack(sets: list) -> dict | None:
    if sets[0] is None:
        return None
    return {f: torch.stack([getattr(x, f) for x in sets])
            for f in sets[0]._fields}


class BackEnd:
    """The keyframe ring, the trust gate and the chain, on the host in
    float64; the refinement in `dtype` on `device`.  `observe` takes and
    returns what the program's `WindowedBA.observe` does; `windows` lists
    every window it closed.  `anchors` ({frame indices: refined poses}),
    where given, chains from those poses instead of its own."""

    def __init__(self, cam, settings: Settings, dtype=torch.float64,
                 device="cpu", anchors: dict | None = None):
        self.cam, self.s = cam, settings
        self.dtype, self.device = dtype, torch.device(device)
        self.anchors = anchors or {}
        self.ring: list = []
        self.C = np.eye(4)
        self.since_kf = 0
        self.windows: list[Window] = []
        self.refine_times: list = []

    def _dev(self, x):
        x = x.to(self.device)
        return x.to(self.dtype) if x.is_floating_point() else x

    def observe(self, frame: int, Tfw, is_kf: bool, points, lines=None):
        take = (frame == 0 or bool(is_kf)
                or self.since_kf + 1 >= self.s.kf_every)
        self.since_kf = 0 if take else self.since_kf + 1
        if not take:
            return None
        raw = np.asarray(Tfw, dtype=np.float64)
        self.ring.append((frame, self.C @ raw, raw, points, lines))
        if len(self.ring) < self.s.window:
            return None
        t0 = time.perf_counter()
        idxs = tuple(e[0] for e in self.ring)
        T_in = np.stack([e[1] for e in self.ring])
        pts = _stack([e[3] for e in self.ring])
        lns = _stack([e[4] for e in self.ring]) if self.s.has_lines else None
        cast = (lambda d: None if d is None
                else {k: self._dev(v) for k, v in d.items()})
        T_new = refine(self._dev(torch.from_numpy(T_in)), cast(pts),
                       cast(lns), self.cam, self.s).double().cpu().numpy()
        self.refine_times.append(time.perf_counter() - t0)
        inc = T_new @ np.linalg.inv(T_in)
        inc_t = float(np.linalg.norm(inc[:, :3, 3], axis=-1).max())
        inc_r = float(_angle_deg(torch.from_numpy(inc[:, :3, :3])).max())
        if inc_t > self.s.max_correction or inc_r > self.s.max_rot_correction:
            self.windows.append(Window(idxs, False, None))
            self.ring = [self.ring[-1]]
            return None
        self.windows.append(Window(idxs, True, T_new))
        anchor = np.asarray(self.anchors.get(idxs, T_new), np.float64)
        last, _, last_raw, lp, ll = self.ring[-1]
        self.C = anchor[-1] @ np.linalg.inv(last_raw)
        self.ring = [(last, anchor[-1], last_raw, lp, ll)]
        return list(idxs), T_new


def replay(frames: list, cam, settings: Settings, device,
           program: dict | None = None) -> dict:
    """The reference's windows of a run, {pass: [Window]}.  frames: (pass,
    frame, Tfw [4, 4], keyframe flag, points, lines) in the order the
    program saw them; each pass through a back end of its own, fed as the
    program's CLI feeds its back end (the flag counts from frame 1 on).
    program: {pass: [(frame indices, refined poses)]}, the windows the
    program refined, whose poses anchor the chain."""
    ends: dict = {}
    for key, f, T, kf, pts, lns in frames:
        if key not in ends:
            anchors = {tuple(i): P for i, P in (program or {}).get(key, [])}
            ends[key] = BackEnd(cam, settings, device=device, anchors=anchors)
        ends[key].observe(f, T, f > 0 and kf, pts, lns)
    return {k: b.windows for k, b in ends.items()}
