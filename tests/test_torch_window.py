"""The port's keyframe-window refinement (stvo_pl_tpu_torch/parallel/
window.py) against the JAX package's on the same windows.

Windows: two fabricated 3-keyframe windows of points and lines (as
tests/test_window.py builds one), one of them with two members of one
track in the same keyframe; and a 5-keyframe window of the port's VO on
the 240x180 point + line sequence, carried to the JAX package as numpy.

Tolerances: labels, masks and `used_lines` are integers and booleans and
must be equal; observations are copies of the inputs (equal up to 1e-6
px); landmark inits are float32 back-projections (rtol 1e-5); refined
poses 1e-4 m / 1e-4 on the rotation entries (the BA's float32 floor at
this window, see tests/test_torch_ba.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import features as jfeat
from stvo_pl_tpu.ops import hamming as jham
from stvo_pl_tpu.parallel import window as jwin
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import hamming as tham
from stvo_pl_tpu_torch.parallel import window as twin

from test_torch_helpers import CAM_ARGS, JCAM, SMALL, port_vo_frames

torch.set_num_threads(1)

TCAM = tcam.StereoCamera(**CAM_ARGS)
JCFG = JCfg(**SMALL)
TCFG = TCfg(**SMALL)
K_FAB, NP_FAB, NL_FAB = 3, 8, 8
FLIP20 = np.uint32((1 << 20) - 1)      # 20 flipped bits in word 0


def _proj(T_cw, X):
    Pc = T_cw[:3, :3] @ X + T_cw[:3, 3]
    f, cx, cy = CAM_ARGS["fx"], CAM_ARGS["cx"], CAM_ARGS["cy"]
    return np.array([f * Pc[0] / Pc[2] + cx, f * Pc[1] / Pc[2] + cy]), Pc[2]


def _back(uv, disp):
    bd = CAM_ARGS["b"] / disp
    return np.array([bd * (uv[0] - CAM_ARGS["cx"]),
                     bd * (uv[1] - CAM_ARGS["cy"]), bd * CAM_ARGS["fx"]])


def fabricate(rng, duplicate: bool):
    """(Tfw, points, lines) of numpy with descriptors as uint32.

    Points 0-3 are seen in every keyframe, point 4 from keyframe 1 on,
    point 5 only in keyframe 2; lines likewise.  With `duplicate`, the
    track of point (and line) 6 has two members in keyframe 0: slot 6
    carries descriptor D and slot 7 descriptor D' = D with 20 bits
    flipped, 1 px apart; keyframe 1 sees D, keyframe 2 sees D'.  Mutual
    matching joins kf0/6 - kf1 (D = D), kf0/7 - kf2 (D' = D') and
    kf1 - kf2 (distance 20), so both kf0 slots fall into one component."""
    X = np.array([[-2.0, -1.0, 8.0], [2.0, 1.0, 10.0], [0.5, -0.5, 12.0],
                  [-1.0, 0.8, 9.0], [1.5, -1.2, 11.0], [0.0, 0.0, 14.0],
                  [-0.5, 1.1, 10.5]])
    A = X[:6] + np.array([0.3, -0.2, 0.5])
    B = A + np.array([0.6, 2.0, 0.4])          # near-vertical segments
    Ad, Bd = np.array([1.2, -0.4, 9.5]), np.array([1.7, 1.6, 9.9])
    dp = rng.integers(0, 2 ** 32, (7, 8), dtype=np.uint32)
    dl = rng.integers(0, 2 ** 32, (7, 8), dtype=np.uint32)
    Tfw = np.stack([np.eye(4, dtype=np.float32) for _ in range(K_FAB)])
    for k in range(K_FAB):
        Tfw[k][0, 3] = 0.4 * k
    vis = {0: [0, 1, 2, 3], 1: [0, 1, 2, 3, 4], 2: [0, 1, 2, 3, 4, 5]}
    b_fx = CAM_ARGS["b"] * CAM_ARGS["fx"]
    pts, lns = [], []
    for k in range(K_FAB):
        Tcw = np.linalg.inv(Tfw[k].astype(np.float64))
        entries = [(slot, X[j], dp[j], 0.0) for slot, j in enumerate(vis[k])]
        lentries = [(slot, A[j], B[j], dl[j], 0.0)
                    for slot, j in enumerate(vis[k])]
        if duplicate:
            d2p, d2l = dp[6].copy(), dl[6].copy()
            d2p[0] ^= FLIP20
            d2l[0] ^= FLIP20
            first = {0: [(6, dp[6], 0.0), (7, d2p, 1.0)], 1: [(6, dp[6], 0.0)],
                     2: [(6, d2p, 0.0)]}[k]
            lfirst = {0: [(6, dl[6], 0.0), (7, d2l, 1.0)],
                      1: [(6, dl[6], 0.0)], 2: [(6, d2l, 0.0)]}[k]
            entries += [(s, X[6], d, off) for s, d, off in first]
            lentries += [(s, Ad, Bd, d, off) for s, d, off in lfirst]
        p = dict(uv=np.zeros((NP_FAB, 2)), disp=np.zeros(NP_FAB),
                 P=np.zeros((NP_FAB, 3)),
                 desc=np.zeros((NP_FAB, 8), np.uint32),
                 level=np.zeros(NP_FAB, np.int32), sigma2=np.ones(NP_FAB),
                 valid=np.zeros(NP_FAB, bool))
        for slot, Xw, d, off in entries:
            uv, z = _proj(Tcw, Xw)
            uv = uv + off
            p["uv"][slot], p["disp"][slot] = uv, b_fx / z
            p["P"][slot] = _back(uv, b_fx / z)
            p["desc"][slot], p["valid"][slot] = d, True
        ln = dict(spl=np.zeros((NL_FAB, 2)), epl=np.zeros((NL_FAB, 2)),
                  sdisp=np.zeros(NL_FAB), edisp=np.zeros(NL_FAB),
                  sP=np.zeros((NL_FAB, 3)), eP=np.zeros((NL_FAB, 3)),
                  le=np.zeros((NL_FAB, 3)), angle=np.zeros(NL_FAB),
                  desc=np.zeros((NL_FAB, 8), np.uint32),
                  level=np.zeros(NL_FAB, np.int32), sigma2=np.ones(NL_FAB),
                  valid=np.zeros(NL_FAB, bool))
        for slot, Aw, Bw, d, off in lentries:
            (s, zs), (e, ze) = _proj(Tcw, Aw), _proj(Tcw, Bw)
            s, e = s + off, e + off
            le = np.cross([*s, 1.0], [*e, 1.0])
            ln["spl"][slot], ln["epl"][slot] = s, e
            ln["sdisp"][slot], ln["edisp"][slot] = b_fx / zs, b_fx / ze
            ln["sP"][slot] = _back(s, b_fx / zs)
            ln["eP"][slot] = _back(e, b_fx / ze)
            ln["le"][slot] = le / np.linalg.norm(le[:2])
            ln["angle"][slot] = np.arctan2(e[1] - s[1], e[0] - s[0])
            ln["desc"][slot], ln["valid"][slot] = d, True
        f32 = lambda dct: {k2: v.astype(np.float32) if v.dtype == np.float64
                           else v for k2, v in dct.items()}
        pts.append(f32(p))
        lns.append(f32(ln))
    stack = lambda lst: {f: np.stack([x[f] for x in lst]) for f in lst[0]}
    return Tfw, stack(pts), stack(lns)


def window_from_frames(frames):
    """(Tfw, points, lines) per keyframe (numpy) -> stacked numpy
    dicts."""
    stack = lambda sets: {f: np.stack([getattr(s, f) for s in sets])
                          for f in sets[0]._fields}
    return (np.stack([f[0] for f in frames]), stack([f[2] for f in frames]),
            stack([f[3] for f in frames]))


def both_windows(Tfw, pts, lns, lines=True):
    jw = jwin.KeyframeWindow(
        Tfw=jnp.asarray(Tfw),
        points=jfeat.PointSet(**{k: jnp.asarray(v) for k, v in pts.items()}),
        lines=jfeat.LineSet(**{k: jnp.asarray(v) for k, v in lns.items()})
        if lines else None)
    tw = convert.window_from_numpy(
        dict(Tfw=Tfw, points=pts, lines=lns if lines else None),
        device="cpu")
    return jw, tw


def _assert_problems_match(tp, jp):
    for f in tp._fields:
        t, j = getattr(tp, f), getattr(jp, f)
        assert (t is None) == (j is None), f
        if t is None:
            continue
        t, j = t.numpy(), np.asarray(j)
        if t.dtype == bool:
            np.testing.assert_array_equal(t, j, err_msg=f)
        elif f.startswith("obs"):
            np.testing.assert_allclose(t, j, rtol=0, atol=1e-6, err_msg=f)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6,
                                       err_msg=f)


@pytest.fixture(scope="module")
def vo_window():
    """5 keyframes (every frame) of the port's VO, points + lines, on the
    scene of seed 7 (1-6 stereo lines per frame; seed 0 has none in its
    first frames)."""
    frames, poses = port_vo_frames(5, SMALL, seed=7)
    return window_from_frames(frames), poses


@pytest.mark.parametrize("duplicate", [False, True], ids=["plain", "dup"])
def test_fabricated_tracks_against_jax(duplicate):
    rng = np.random.default_rng(3)
    jw, tw = both_windows(*fabricate(rng, duplicate))
    jp = jwin.build_problem_tracks(jw, JCAM, JCFG)
    tp = twin.build_problem_tracks(tw, TCAM, TCFG)
    _assert_problems_match(tp, jp)
    live = tp.mask.any(dim=1)
    live_l = tp.mask_l.any(dim=1)
    # points 0-4 (and 6) become tracks, the keyframe-2-only point does not
    assert int(live.sum()) == 5 + duplicate
    assert int(live_l.sum()) == 5 + duplicate


def test_duplicate_member_takes_the_highest_index():
    """Keyframe 0's slots 6 and 7 are members of one track (root: flat
    index 6).  The JAX package's scatter lets the later member (slot 7,
    offset by 1 px) write the track's keyframe-0 observation; the port
    picks the same member, for points and for lines."""
    rng = np.random.default_rng(3)
    Tfw, pts, lns = fabricate(rng, duplicate=True)
    jw, tw = both_windows(Tfw, pts, lns)
    jp = jwin.build_problem_tracks(jw, JCAM, JCFG)
    tp = twin.build_problem_tracks(tw, TCAM, TCFG)
    slot7 = pts["uv"][0, 7]
    disp7 = pts["disp"][0, 7]
    want = [slot7[0], slot7[1], slot7[0] - disp7]
    np.testing.assert_allclose(np.asarray(jp.obs)[6, 0], want, atol=1e-6)
    np.testing.assert_allclose(tp.obs[6, 0].numpy(), want, atol=1e-6)
    assert bool(tp.mask[6, 0]) and bool(np.asarray(jp.mask)[6, 0])
    want_l = np.concatenate([lns["le"][0, 7], lns["spl"][0, 7],
                             lns["epl"][0, 7]])
    np.testing.assert_allclose(np.asarray(jp.obs_l)[6, 0], want_l, atol=1e-6)
    np.testing.assert_allclose(tp.obs_l[6, 0].numpy(), want_l, atol=1e-6)
    # both slots resolve to the root 6
    labels = twin._track_labels(
        lambda a, b: tham.distance_matrix(tw.points.desc[a],
                                          tw.points.desc[b]),
        tw.points.valid, K_FAB, NP_FAB, TCFG.min_ratio_12_p, TCFG)
    assert int(labels[6]) == int(labels[7]) == 6


@pytest.mark.parametrize("kind", ["points", "lines"])
def test_track_labels_equal_jax(vo_window, kind):
    """The union-find labels of the VO window, integer-equal."""
    (Tfw, pts, lns), _ = vo_window
    jw, tw = both_windows(Tfw, pts, lns)
    K = Tfw.shape[0]
    if kind == "points":
        jset, tset, ratio = jw.points, tw.points, JCFG.min_ratio_12_p
        jd = lambda a, b: jham.distance_matrix(jset.desc[a], jset.desc[b])
        td = lambda a, b: tham.distance_matrix(tset.desc[a], tset.desc[b])
    else:
        jset, tset, ratio = jw.lines, tw.lines, JCFG.min_ratio_12_l
        jd = lambda a, b: jham.hamming_matrix(jset.desc[a], jset.desc[b])
        td = lambda a, b: tham.hamming_matrix(tset.desc[a], tset.desc[b])
    N = tset.valid.shape[1]
    jl = np.asarray(jwin._track_labels(jd, jset.valid, K, N, ratio, JCFG))
    tl = twin._track_labels(td, tset.valid, K, N, ratio, TCFG).numpy()
    np.testing.assert_array_equal(tl, jl)
    # some multi-keyframe tracks exist
    roots, counts = np.unique(tl[tl < K * N], return_counts=True)
    assert (counts >= 2).sum() >= (10 if kind == "points" else 1)


@pytest.mark.parametrize("builder", ["tracks", "anchor"])
def test_vo_window_problem_against_jax(vo_window, builder):
    """The multi-anchor track problem and the anchor-only one
    (`--ba-anchor-only`)."""
    (Tfw, pts, lns), _ = vo_window
    jw, tw = both_windows(Tfw, pts, lns)
    name = "build_problem_tracks" if builder == "tracks" else "build_problem"
    jp = getattr(jwin, name)(jw, JCAM, JCFG)
    tp = getattr(twin, name)(tw, TCAM, TCFG)
    _assert_problems_match(tp, jp)
    assert int(tp.mask.any(dim=1).sum()) >= 20


def _assert_poses_close(t, j):
    t, j = t.numpy(), np.asarray(j)
    np.testing.assert_allclose(t[:, :3, 3], j[:, :3, 3], rtol=0, atol=1e-4)
    np.testing.assert_allclose(t[:, :3, :3], j[:, :3, :3], rtol=0, atol=1e-4)


@pytest.mark.parametrize("lines", [False, True], ids=["points", "lines"])
def test_refine_window_against_jax(vo_window, lines):
    (Tfw, pts, lns), _ = vo_window
    jw, tw = both_windows(Tfw, pts, lns, lines=lines)
    tT, tX, tc = twin.refine_window(tw, TCAM, TCFG, n_iters=6)
    jT, jX, jc = jwin.refine_window(jw, JCAM, JCFG, n_iters=6)
    _assert_poses_close(tT, jT)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-3)


def _corrupt(lns, bias_px):
    """Shift every keyframe's observed infinite lines by an alternating
    per-keyframe bias (tests/test_window.py:_corrupt_lines)."""
    out = dict(lns)
    sign = np.array([1.0 if k % 2 == 0 else -1.0
                     for k in range(lns["le"].shape[0])], np.float32)
    le = lns["le"].copy()
    le[..., 2] += sign[:, None] * bias_px
    out["le"] = le
    return out


def _disagreement(tw):
    """(chi2_joint / chi2_points, max translation [m], max rotation [deg])
    between the port's joint and points-only solutions of one window: the
    three statistics of the line-trust gate."""
    from stvo_pl_tpu_torch.ops import se3
    from stvo_pl_tpu_torch.parallel import ba
    prob = twin.build_problem_tracks(tw, TCAM, TCFG)
    prob_p = prob._replace(Xl=None, obs_l=None, mask_l=None, sigma2_l=None)
    P0 = se3.inverse_se3(tw.Tfw)
    Pp = ba.ba_solve(P0, prob_p, TCAM, n_iters=8)[0]
    Pj = ba.ba_solve(P0, prob, TCAM, n_iters=8)[0]
    D = se3.mm(Pj, se3.inverse_se3(Pp))
    tr = D[:, 0, 0] + D[:, 1, 1] + D[:, 2, 2]
    rot = torch.rad2deg(torch.arccos(torch.clamp((tr - 1) / 2, -1, 1)))
    chi = float(ba.point_chi2(Pj, prob_p, TCAM)[0]
                / ba.point_chi2(Pp, prob_p, TCAM)[0])
    return chi, float(D[:, :3, 3].norm(dim=-1).max()), float(rot.max())


@pytest.mark.parametrize("case", ["clean", "corrupted"])
def test_refine_window_auto_against_jax(vo_window, case):
    """used_lines equal and the refined poses within tolerance.  The
    clean window keeps its lines; the corrupted one (lines biased by 7.5 px,
    under the 8 px endpoint gate, and points thinned to the first 10 slots
    of each keyframe) must be refused with a margin of its own: its
    disagreement is at least 2x the 0.25 m / 1 deg gates or its
    chi-square ratio 1.5x the 1.10 tolerance, and the clean window's stays
    under half of each gate."""
    (Tfw, pts, lns), _ = vo_window
    if case == "corrupted":
        lns = _corrupt(lns, 7.5)
        pts = dict(pts, valid=pts["valid"] & (np.arange(
            pts["valid"].shape[1]) < 10)[None])
    jw, tw = both_windows(Tfw, pts, lns)
    chi, dis_t, dis_r = _disagreement(tw)
    if case == "clean":
        assert chi <= 1.05 and dis_t <= 0.125 and dis_r <= 0.5, \
            (chi, dis_t, dis_r)
    else:
        assert chi >= 1.65 or dis_t >= 0.5 or dis_r >= 2.0, \
            (chi, dis_t, dis_r)
    tT, _, _, t_used = twin.refine_window_auto(tw, TCAM, TCFG, n_iters=8)
    jT, _, _, j_used = jwin.refine_window_auto(jw, JCAM, JCFG, n_iters=8)
    assert bool(t_used) == bool(j_used) == (case == "clean")
    _assert_poses_close(tT, jT)


def test_convert_window_and_problem_round_trip():
    """convert carries a window and a problem across bit for bit
    (descriptors as uint32 in numpy, int32 in the port)."""
    rng = np.random.default_rng(3)
    Tfw, pts, lns = fabricate(rng, duplicate=True)
    tw = convert.window_from_numpy(dict(Tfw=Tfw, points=pts, lines=lns),
                                   device="cpu")
    assert tw.points.desc.dtype == torch.int32
    back = convert.window_to_numpy(tw)
    np.testing.assert_array_equal(back.Tfw, Tfw)
    for f, v in pts.items():
        np.testing.assert_array_equal(getattr(back.points, f), v, err_msg=f)
    for f, v in lns.items():
        np.testing.assert_array_equal(getattr(back.lines, f), v, err_msg=f)
    prob = twin.build_problem_tracks(tw, TCAM, TCFG)
    again = convert.problem_from_numpy(convert.problem_to_numpy(prob),
                                       device="cpu")
    for f in prob._fields:
        assert torch.equal(getattr(again, f), getattr(prob, f)), f
    pts_only = convert.problem_to_numpy(prob._replace(
        Xl=None, obs_l=None, mask_l=None, sigma2_l=None))
    assert convert.problem_from_numpy(pts_only, device="cpu").Xl is None
