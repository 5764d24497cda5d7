"""The compiled counterparts of the JAX package's remaining `jax.jit`
entry points: the one-lane RGB-D step, `ba_solve`, the binary matcher
(`knn_match`, `match`, `radius_match`), both line detectors and the
front-end operators (`select_keypoints`, `orient_and_describe`,
`compute_lbd`, `compute_lbd_atlas`, `build_pyramid`), each a
`parallel/compiled.Compiled` program built by its `compile_<name>`
factory beside the eager function.

On the CPU a program has no graph: it runs its body eagerly, so here each
must be `torch.equal` to its eager function on two different inputs
through the same program, and its body must run no operation that copies
from the host or waits for the device (`HostAudit`,
tests/test_torch_helpers.py), which is what a capture on the card needs.
Against the JAX package, at the tolerances of the port's own tests: the
compiled one-lane RGB-D step from each JAX state (tests/test_torch_rgbd.py:
3e-4 m, 5e-5 in rotation, counts within 1), `orient_and_describe` with
the JAX package on its Pallas patch gather (bits equal, angles to 1e-6,
tests/test_torch_orb.py), `detect_line_segments` with both candidate
generators (valid masks equal, endpoints to 1e-3 px,
tests/test_torch_lsd.py and tests/test_torch_lsd_dense.py) and the
popcount `knn_match` (integers equal, tests/test_torch_binary_matcher.py).
A detector program called with two `min_length` values gives eager's
answer for each: the threshold is the program's argument, not a number
frozen into it.

The `gpu` case captures each program on the card and holds two replays
`torch.equal` to eager (EDLines, whose moments are atomic float sums, by
chip_smoke.py's set rule); it skips without a CUDA device and imports no
JAX, so on a machine with a card it runs as
`pytest --noconftest -m gpu tests/test_torch_compiled_ops.py`.
"""

import numpy as np
import pytest
import torch

from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frontend
from stvo_pl_tpu_torch.ops import binary_matcher as tbm
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import edline, fast, image, lbd, lsd, orb, se3
from stvo_pl_tpu_torch.parallel import ba
from stvo_pl_tpu_torch.utils import synthetic

from test_torch_compiled import _equal, _leaves, _shared

torch.set_num_threads(1)

# the 240x180 camera of tests/test_e2e_vo.py
CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
TCAM = tcam.StereoCamera(**CAM_ARGS)
RGBD_CFG = TCfg(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=32,
                lsd_n_dirs=8, min_features=8, rgbd_max_depth=60.0)
MIN_LEN = 0.025 * 180          # cfg.min_line_length * min(width, height)


def _ba_problem(seed: int, dev, K: int = 4, N: int = 120, NL: int = 16):
    """A seeded window problem (points and lines seen from K poses, as
    tests/test_torch_ba.py builds it, without JAX): (poses_cw, BAProblem)
    with the poses perturbed."""
    rng = np.random.default_rng(seed)
    Tcw = np.stack([np.eye(4) for _ in range(K)])
    Tcw[:, :3, 3] = -np.stack([0.05 * np.arange(K), np.zeros(K),
                               0.4 * np.arange(K)], -1)
    fx, cx, cy, b = CAM_ARGS["fx"], CAM_ARGS["cx"], CAM_ARGS["cy"], 0.3

    def project(P, k):
        Pc = P @ Tcw[k, :3, :3].T + Tcw[k, :3, 3]
        return Pc, cx + fx * Pc[..., 0] / Pc[..., 2], \
            cy + fx * Pc[..., 1] / Pc[..., 2]

    X = np.stack([rng.uniform(-4, 4, N), rng.uniform(-2, 2, N),
                  rng.uniform(6, 20, N)], -1)
    obs = np.zeros((N, K, 3))
    for k in range(K):
        Pc, u, v = project(X, k)
        obs[:, k] = np.stack([u, v, cx + fx * (Pc[:, 0] - b) / Pc[:, 2]],
                             -1) + rng.normal(0, 0.3, (N, 3))
    mask = rng.uniform(size=(N, K)) < 0.7
    A = np.stack([rng.uniform(-4, 4, NL), rng.uniform(-2, 2, NL),
                  rng.uniform(7, 18, NL)], -1)
    d = rng.normal(size=(NL, 3))
    Xl = np.stack([A, A + 2.5 * d / np.linalg.norm(d, axis=-1,
                                                   keepdims=True)], 1)
    obs_l = np.zeros((NL, K, 7))
    for k in range(K):
        _, u, v = project(Xl, k)
        s = np.stack([u[:, 0], v[:, 0]], -1) + rng.normal(0, 0.3, (NL, 2))
        e = np.stack([u[:, 1], v[:, 1]], -1) + rng.normal(0, 0.3, (NL, 2))
        le = np.cross(np.concatenate([s, np.ones((NL, 1))], -1),
                      np.concatenate([e, np.ones((NL, 1))], -1))
        le /= np.linalg.norm(le[:, :2], axis=-1, keepdims=True)
        obs_l[:, k] = np.concatenate([le, s, e], -1)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    prob = ba.BAProblem(
        X=t(X + rng.normal(0, 0.05, X.shape)), obs=t(obs),
        mask=t(mask, torch.bool),
        sigma2=t(rng.choice([1.0, 1.44, 2.07], N)),
        Xl=t(Xl + rng.normal(0, 0.05, Xl.shape)), obs_l=t(obs_l),
        mask_l=t(rng.uniform(size=(NL, K)) < 0.8, torch.bool),
        sigma2_l=t(np.ones(NL)))
    xi = np.concatenate([rng.normal(0, 0.03, (K, 3)),
                         rng.normal(0, 0.005, (K, 3))], -1)
    xi[0] = 0.0
    poses = se3.mm(se3.expmap_se3(t(xi)), t(Tcw))
    return poses, prob


def _inputs(dev) -> dict:
    """Two inputs of every entry point on `dev`, made by the port alone (no
    JAX): two frames of one scene of the port's renderer with depth, the
    seeded BA problems and descriptor sets."""
    gen = torch.Generator(device=dev).manual_seed(0)
    scene = synthetic.make_scene(gen, n_points=260, n_lines=24,
                                 extent=(14.0, 8.0, 40.0), z_near=3.0)
    poses = synthetic.smooth_trajectory(2, speed=0.25, device=dev)
    L, R = synthetic.render_sequence(scene, poses, TCAM)
    D = synthetic.render_depth(scene, poses, TCAM)
    pairs = [torch.stack([L[i], R[i]]) for i in range(2)]     # [2, H, W]
    mins = [torch.tensor(MIN_LEN, device=dev),
            torch.tensor(3.0 * MIN_LEN, device=dev)]
    rng = np.random.default_rng(3)

    def desc(n):
        return torch.as_tensor(rng.integers(-2 ** 31, 2 ** 31, (n, 8)),
                               dtype=torch.int32, device=dev)
    index = tbm.build_index([desc(n) for n in (40, 25, 60)],
                            [torch.arange(n, device=dev) < m
                             for n, m in ((40, 40), (25, 20), (60, 60))])
    queries = [(desc(30), torch.arange(30, device=dev) % 7 != 3)
               for _ in range(2)]
    queries[0][0][3] = index.desc[7]              # a match at distance 0
    state = frontend.init_state(RGBD_CFG, device=dev)
    feats = []
    for img in pairs:
        score = fast.fast_score(img, 20.0)
        blur = image.gaussian_blur(img, 2.0, radius=3)
        uv = fast.select_keypoints(score, 200)[0]
        segs = lsd.detect_line_segments(img, MIN_LEN, capacity=48, n_dirs=8)
        gx, gy = image.sobel(img)
        feats.append((score, blur, uv, segs, gx, gy))
    return dict(L=L, D=D, pairs=pairs, mins=mins, index=index,
                queries=queries, state=state, feats=feats,
                problems=[_ba_problem(s, dev) for s in (0, 1)])


def _cases(x: dict, dev) -> dict:
    """name -> (program, eager function, [args of call 1, of call 2])."""
    s1, _ = frontend.vo_step_rgbd(x["state"], x["L"][0], x["D"][0], TCAM,
                                  RGBD_CFG)
    lbd_args = [(gx, gy, segs.sp, segs.ep)
                for _, _, _, segs, gx, gy in x["feats"]]

    def atlas_args(gx, gy, sp, ep):
        K = sp.shape[1]
        z = torch.zeros((2, K), dtype=torch.int32, device=dev)
        return (torch.stack([gx, gy], -1), sp, ep, z, z + 1,
                z + TCAM.width - 2, z + TCAM.height - 3)
    det = dict(capacity=48, n_dirs=8)
    q = x["queries"]
    return {
        "vo_step_rgbd": (
            frontend.compile_vo_step_rgbd(TCAM, RGBD_CFG, device=dev),
            lambda *a: frontend.vo_step_rgbd(*a, TCAM, RGBD_CFG),
            [(x["state"], x["L"][0], x["D"][0]), (s1, x["L"][1], x["D"][1])]),
        "ba_solve": (
            ba.compile_ba_solve(TCAM, n_iters=3, device=dev),
            lambda p, prob: ba.ba_solve(p, prob, TCAM, n_iters=3),
            x["problems"]),
        "knn_match": (
            tbm.compile_knn_match(3, use_mxu=False, device=dev),
            lambda *a: tbm.knn_match(a[0], a[1], 3, a[2], use_mxu=False),
            [(q[0][0], x["index"], q[0][1]), (q[1][0], x["index"], q[1][1])]),
        "match": (
            tbm.compile_match(device=dev),
            lambda *a: tbm.match(*a),
            [(q[0][0], x["index"]), (q[1][0], x["index"])]),
        "radius_match": (
            tbm.compile_radius_match(118, 4, device=dev),
            lambda *a: tbm.radius_match(a[0], a[1], 118, 4, a[2]),
            [(q[0][0], x["index"], q[0][1]), (q[1][0], x["index"], q[1][1])]),
        "detect_line_segments": (
            lsd.compile_detect_line_segments(device=dev, with_field=True,
                                             **det),
            lambda img, m: lsd.detect_line_segments(img, m, with_field=True,
                                                    **det),
            list(zip(x["pairs"], x["mins"]))),
        "detect_line_segments_per_direction": (
            lsd.compile_detect_line_segments(device=dev, per_direction=True,
                                             **det),
            lambda img, m: lsd.detect_line_segments(img, m,
                                                    per_direction=True, **det),
            list(zip(x["pairs"], x["mins"]))),
        "detect_edlines": (
            edline.compile_detect_edlines(device=dev, capacity=48),
            lambda img, m: edline.detect_edlines(img, m, capacity=48),
            list(zip(x["pairs"], x["mins"]))),
        "select_keypoints": (
            fast.compile_select_keypoints(200, device=dev),
            lambda *a: fast.select_keypoints(a[0], 200, offset_src=a[1]),
            [(f[0], f[0]) for f in x["feats"]]),
        "orient_and_describe": (
            orb.compile_orient_and_describe(device=dev),
            orb.orient_and_describe,
            [(img, f[1], f[2]) for img, f in zip(x["pairs"], x["feats"])]),
        "compute_lbd": (
            lbd.compile_compute_lbd(device=dev), lbd.compute_lbd, lbd_args),
        "compute_lbd_atlas": (
            lbd.compile_compute_lbd_atlas(device=dev), lbd.compute_lbd_atlas,
            [atlas_args(*a) for a in lbd_args]),
        "build_pyramid": (
            image.compile_build_pyramid(4, 1.2, device=dev),
            lambda img: tuple(image.build_pyramid(img, 4, 1.2)),
            [(p,) for p in x["pairs"]]),
    }


CASES = ["vo_step_rgbd", "ba_solve", "knn_match", "match", "radius_match",
         "detect_line_segments", "detect_line_segments_per_direction",
         "detect_edlines", "select_keypoints", "orient_and_describe",
         "compute_lbd", "compute_lbd_atlas", "build_pyramid"]


@pytest.fixture(scope="module")
def cpu_inputs():
    return _inputs(torch.device("cpu"))


@pytest.fixture(scope="module")
def cpu_cases(cpu_inputs):
    return _cases(cpu_inputs, torch.device("cpu"))


@pytest.mark.parametrize("name", CASES)
def test_program_equals_eager_and_never_touches_the_host(cpu_cases, name):
    """The CPU route of each program `torch.equal` to its eager function on
    two different inputs through one program (one static key); the
    returned tensors are the caller's (a later call leaves them as they
    were); and a second run of the body makes no host copy, host read or
    upload, as a capture on the card needs."""
    from test_torch_helpers import HostAudit
    prog, eager, calls = cpu_cases[name]
    outs = []
    for i, args in enumerate(calls):
        out = prog(*args)
        assert _equal(out, eager(*args)), (name, i)
        outs.append((out, [t.clone() for t in _leaves(out)]))
    assert not _equal(outs[0][0], outs[1][0]), "the two inputs must differ"
    assert len(prog.programs) == 1
    for out, copy in outs:
        assert all(torch.equal(a, b) for a, b in zip(_leaves(out), copy))
    audit, uploads = HostAudit(), []
    real = torch.from_numpy
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch, "from_numpy",
                   lambda *a: uploads.append(a) or real(*a))
        with audit:
            prog.fn(*calls[1])
    assert not audit.found, audit.found
    assert not uploads


def test_factory_arguments():
    """A factory's static names are checked when the program is built, and
    a program takes no more arguments than the eager function's traced
    ones."""
    with pytest.raises(TypeError):
        lsd.compile_detect_line_segments(device="cpu", min_length=3.0)
    with pytest.raises(TypeError):
        lsd.compile_detect_line_segments(device="cpu", capacty=10)
    prog = fast.compile_select_keypoints(8, device="cpu")
    x = torch.zeros((1, 40, 40))
    with pytest.raises(TypeError, match="at most 2"):
        prog(x, x, x)
    with pytest.raises(TypeError):           # a number is not an argument
        lsd.compile_detect_line_segments(device="cpu")(x, 4.5)


@pytest.mark.parametrize("detector", ["lsd", "edlines"])
def test_min_length_is_an_argument(cpu_inputs, detector):
    """One detector program (capacity 300, so that no short segment is
    cut by the capacity alone) called with two `min_length` values on the
    same images gives eager's answer for each: the threshold reaches the
    body, it is not frozen into the program.  The low threshold keeps
    segments that the high one must drop, and every segment kept under
    the high one is at least that long."""
    if detector == "lsd":
        prog = lsd.compile_detect_line_segments(device="cpu", n_dirs=8)
        eager = lambda img, m: lsd.detect_line_segments(img, m, n_dirs=8)
    else:
        prog = edline.compile_detect_edlines(device="cpu")
        eager = edline.detect_edlines
    img = cpu_inputs["pairs"][0]
    lo, hi = MIN_LEN, 4.0 * MIN_LEN
    segs = {}
    for m in (lo, hi, lo):
        out = prog(img, torch.tensor(m))
        assert _equal(out, eager(img, torch.tensor(m)))
        assert _equal(out, eager(img, m))         # a number, eagerly
        segs[m] = out
    assert len(prog.programs) == 1
    short = segs[lo].valid & (segs[lo].length < hi)
    assert int(short.sum()) > 0
    assert int(segs[hi].valid.sum()) > 0
    assert bool((segs[hi].length[segs[hi].valid] >= hi).all())


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_compiled_rgbd_step_against_jax():
    """The one-lane compiled RGB-D step over 8 frames of the scene and
    depth maps of tests/test_torch_rgbd.py, each started from the JAX
    step's incoming state (JAX on its kernel branches), against JAX
    `vo_step_rgbd`: 3e-4 m and 5e-5 in rotation, match and inlier counts
    within 1, the other discrete outputs equal (test_torch_rgbd.py's
    tolerances; its points-only configuration, since these depth maps
    carry depth at point landmarks only)."""
    import jax
    import jax.numpy as jnp
    from stvo_pl_tpu.config import VOConfig as JCfg
    from stvo_pl_tpu.models import frontend as jfront
    from stvo_pl_tpu.utils import synthetic as jsyn
    from stvo_pl_tpu_torch import convert
    from test_torch_helpers import jax_kernel_branch
    from test_torch_rgbd import CFG_ARGS, JCAM, TCAM as RCAM, _render_rgbd
    n = 8
    scene = jsyn.make_scene(jax.random.PRNGKey(5), n_points=260, n_lines=20,
                            extent=(6.0, 4.0, 12.0), z_near=1.5)
    poses = jsyn.smooth_trajectory(n, speed=0.1)
    frames = [_render_rgbd(scene, poses[i]) for i in range(n)]
    args = dict(CFG_ARGS, has_lines=False)
    jcfg, tcfg = JCfg(**args), TCfg(**args)
    with jax_kernel_branch():
        state = jfront.init_state(jcfg)
        states, tels = [], []
        for img, depth in frames:
            states.append(jax.tree_util.tree_map(np.asarray, state))
            state, t = jfront.vo_step_rgbd(state, jnp.asarray(img),
                                           jnp.asarray(depth), JCAM, jcfg)
            tels.append(jax.tree_util.tree_map(np.asarray, t))
    step = frontend.compile_vo_step_rgbd(RCAM, tcfg, device="cpu")
    for i, (img, depth) in enumerate(frames):
        _, tel = step(convert.state_from_numpy(states[i], "cpu"),
                      torch.tensor(img), torch.tensor(depth))
        np.testing.assert_allclose(tel.Tfw.numpy()[:3, 3], tels[i].Tfw[:3, 3],
                                   atol=3e-4, err_msg=f"frame {i}")
        np.testing.assert_allclose(tel.Tfw.numpy()[:3, :3],
                                   tels[i].Tfw[:3, :3], atol=5e-5)
        for f in ("good", "opt_iters", "fast_th", "is_kf"):
            assert getattr(tel, f).item() == getattr(tels[i], f).item(), (i, f)
        for f in ("n_points", "n_inliers_pt"):
            assert abs(getattr(tel, f).item()
                       - getattr(tels[i], f).item()) <= 1, (i, f)
    assert sum(int(t.n_inliers_pt) for t in tels) > 100
    assert len(step.programs) == 1


def test_compiled_orient_and_describe_against_jax_kernel(rng):
    """B2's program against the JAX package's `orient_and_describe` on its
    Pallas patch gather (interpret mode): descriptor bits equal, cos / sin
    to 1e-6 (tests/test_torch_orb.py), with corners outside the image."""
    import jax.numpy as jnp
    from stvo_pl_tpu.ops import image as jimg
    from stvo_pl_tpu.ops import orb as jorb
    from test_torch_helpers import jax_kernel_branch
    H, W, K = 90, 120, 40
    img = (rng.random((H, W)) * 255).astype(np.float32)
    blur = np.asarray(jimg.gaussian_blur(jnp.asarray(img), 2.0, 3))
    uv = rng.uniform([-5, -5], [W + 5, H + 5], (K, 2)).astype(np.float32)
    prog = orb.compile_orient_and_describe(device="cpu")
    desc, c, s = prog(*(torch.from_numpy(a) for a in (img, blur, uv)))
    with jax_kernel_branch(lsd=False, orb=True):
        jdesc, jc, js = jorb.orient_and_describe(
            jnp.asarray(img), jnp.asarray(blur), jnp.asarray(uv))
        jdesc, jc, js = (np.asarray(a) for a in (jdesc, jc, js))
    np.testing.assert_array_equal(desc.numpy().view(np.uint32), jdesc)
    np.testing.assert_allclose(c.numpy(), jc, atol=1e-6)
    np.testing.assert_allclose(s.numpy(), js, atol=1e-6)


@pytest.mark.parametrize("per_direction", [False, True],
                         ids=["all_direction", "per_direction"])
def test_compiled_line_detector_against_jax(per_direction):
    """The line detector's program (B3 all-direction, B4 per-direction)
    on a rendered 240x180 stereo pair against the JAX package's
    `detect_line_segments`: on its kernel branch for the all-direction
    generator, on its CPU per-direction generator (which the port's
    `per_direction=True` follows) for the other; valid masks equal,
    endpoints, lengths and responses to 1e-3 px, angles to 1e-4
    (tests/test_torch_lsd.py, tests/test_torch_lsd_dense.py)."""
    import jax
    import jax.numpy as jnp
    from stvo_pl_tpu.ops import lsd as jlsd
    from test_torch_helpers import jax_kernel_branch, rendered_sequence
    L, R, _ = rendered_sequence(1)
    frame = np.stack([L[0], R[0]])
    kw = dict(capacity=48, n_dirs=12 if per_direction else 8, log_eps=0.0)
    prog = lsd.compile_detect_line_segments(
        device="cpu", per_direction=per_direction, **kw)
    segs = prog(torch.from_numpy(frame), torch.tensor(MIN_LEN))
    with jax_kernel_branch(lsd=not per_direction):
        refs = [jax.tree_util.tree_map(np.asarray, jlsd.detect_line_segments(
            jnp.asarray(f), jnp.float32(MIN_LEN), **kw)) for f in frame]
    for i, ref in enumerate(refs):
        assert ref.valid.sum() > 10
        np.testing.assert_array_equal(segs.valid[i].numpy(), ref.valid)
        v = ref.valid
        for f in ("sp", "ep", "length", "resp"):
            np.testing.assert_allclose(getattr(segs, f)[i].numpy()[v],
                                       getattr(ref, f)[v], atol=1e-3)
        np.testing.assert_allclose(segs.angle[i].numpy()[v], ref.angle[v],
                                   atol=1e-4)


def test_compiled_knn_match_popcount_against_jax():
    """B5's program: `knn_match` with `use_mxu=False` (the plain version of
    the popcount kernel on the CPU) against the JAX package's, every
    output equal (tests/test_torch_binary_matcher.py)."""
    import jax.numpy as jnp
    from stvo_pl_tpu.ops import binary_matcher as jbm
    rng = np.random.default_rng(7)

    def desc(n):
        return rng.integers(0, 2 ** 32, (n, 8),
                            dtype=np.uint64).astype(np.uint32)
    imgs = [desc(n) for n in (40, 25, 60)]
    valids = [np.ones(40, bool), np.arange(25) < 20, np.ones(60, bool)]
    q = desc(30)
    q[3], q[11] = imgs[0][7], imgs[2][42]
    q_valid = np.arange(30) % 5 != 2
    t = lambda a: torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                   else a)
    t_idx = tbm.build_index([t(d) for d in imgs], [t(v) for v in valids])
    j_idx = jbm.build_index([jnp.asarray(d) for d in imgs],
                            [jnp.asarray(v) for v in valids])
    prog = tbm.compile_knn_match(4, use_mxu=False, device="cpu")
    got = prog(t(q), t_idx, t(q_valid))
    want = jbm.knn_match(jnp.asarray(q), j_idx, 4, jnp.asarray(q_valid),
                         use_mxu=False)
    for f in got._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    assert (got.dist[:, 0] < 257).any() and (got.dist == 257).any()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _segments(segs, i: int) -> np.ndarray:
    seg = torch.cat([segs.sp[i], segs.ep[i]], dim=-1)
    return seg[segs.valid[i]].cpu().numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_program_replays_equal_eager_on_the_card(name):
    """Each program captured on the card: two replays on two inputs
    `torch.equal` to the eager function (EDLines: per image the counts
    within 1 and >= 90% of the segments shared within 0.5 px, since its
    moments are atomic float sums); a replay runs no kernel wrapper."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a graph is captured on the card")
    from stvo_pl_tpu_torch.ops import hamming, lsd_kernel, patches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    prog, eager, calls = _cases(_inputs(dev), dev)[name]
    wrappers = (patches.extract_patches, lsd_kernel.run_pack_multi,
                lsd_kernel.run_pack, hamming.hamming_matrix_popc)
    prog(*calls[0])                           # warm-up and capture
    p, = prog.programs.values()
    assert p.graph is not None
    for i, args in enumerate(calls):
        before = [w.launches for w in wrappers]
        out = prog(*args)
        torch.cuda.synchronize()
        assert [w.launches for w in wrappers] == before, (name, i)
        want = eager(*args)
        if name == "detect_edlines":
            for k in range(2):
                a, b = _segments(out, k), _segments(want, k)
                assert abs(len(a) - len(b)) <= 1 and _shared(a, b) >= 0.9
        else:
            assert _equal(out, want), (name, i)
    assert p.replays == 3
