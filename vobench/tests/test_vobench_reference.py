"""The yardstick on the CPU: the renderer and the lane schedule per seed,
the trajectory arithmetic, the comparison, the roofline's shapes against
the program's own, and what the benchmark may import."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from vobench import registry, run
from vobench.reference import compare, render
from vobench.reference.trajectory import ate_rmse, umeyama_alignment
from vobench.traffic.fleet import Schedule

CAM = render.Camera(fx=60.0, fy=60.0, cx=40.0, cy=24.0, b=0.5, width=80,
                    height=48)
SCENE = dict(n_points=80, n_lines=6, extent=[40.0, 15.0, 90.0], z_near=5.0)


def _pool(seed, lanes=2, frames=3):
    return render.render_pool(seed, lanes, CAM, SCENE, frames, 0.8, "cpu")


def test_renderer_is_deterministic_per_seed():
    big = 2 ** 31 + 12345
    a, b = _pool(big), _pool(big)
    for x, y in zip(a, b):
        assert np.array_equal(np.asarray(x), np.asarray(y))
    other = _pool(big + 1)
    assert not torch.equal(a[0], other[0])
    left, right, truth = a
    assert left.shape == (6, 48, 80) and right.shape == (6, 48, 80)
    assert not torch.equal(left[:3], left[3:])          # a scene per lane
    assert float(left.min()) >= 0.0 and float(left.max()) <= 255.0
    assert truth.shape == (3, 4, 4)
    step = np.linalg.norm(np.diff(truth[:, :3, 3], axis=0), axis=-1)
    assert np.allclose(step, 0.8, atol=1e-3)
    assert len({render.lane_seed(big, i) for i in range(64)}) == 64


@pytest.mark.parametrize("lanes", [1, 8, 64])
def test_lane_schedule(lanes):
    s = Schedule.make(lanes, 60)
    assert list(s.offsets) == [60 * i // lanes for i in range(lanes)]
    assert np.array_equal(Schedule.make(lanes, 60).offsets, s.offsets)
    resets = [len(s.resets(k)) for k in range(1, 121)]
    assert sum(resets) == 2 * lanes             # each lane once a sequence
    assert max(resets) == -(-lanes // 60)       # spread over the steps
    for k in range(0, 200, 7):
        f, start, no = s.frames(k), s.pass_start(k), s.pass_no(k)
        assert np.all(f == (s.offsets + k) % 60)
        assert np.all(start <= f)
        assert np.all(start[no == 0] == s.offsets[no == 0])
        assert np.all(start[no > 0] == 0)
    assert len(s.resets(0)) == 0


def test_ate_on_a_hand_made_case():
    rng = np.random.default_rng(3)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    c, s = np.cos(0.3), np.sin(0.3)
    M = np.eye(4)
    M[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    M[:3, 3] = [1.0, -2.0, 0.5]
    est = M[None] @ gt                     # a rigid motion of the truth
    assert ate_rmse(est, gt) < 1e-9
    assert ate_rmse(est, gt, align=False) > 1.0
    _, R, t = umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
    assert np.allclose(R, M[:3, :3].T) and np.allclose(R @ M[:3, 3] + t, 0)
    off = gt.copy()
    off[:, 0, 3] += np.where(np.arange(20) % 2, 0.1, -0.1)
    assert abs(ate_rmse(off, gt, align=False) - 0.1) < 1e-12


def _frames(truth, n=60, kf_every=5, alter=None):
    fr = compare.Frames()
    for f in range(n):
        T = np.linalg.inv(truth[0]) @ truth[f]
        if alter is not None and f == alter:
            T = T.copy()
            T[0, 3] += 2.0
        fr.add([0], [0], [0], [f], T[None], [f > 0 and f % kf_every == 0],
               [True], [30])
    return fr


def test_judge_reads_truth_as_perfect_and_catches_faults():
    truth = render.smooth_trajectory(60, speed=0.8)
    good = compare.judge(_frames(truth), truth, True, 5.0)
    assert good["ate_m"] < 1e-9 and good["rpe_m"] < 1e-9
    assert good["line_miss"] == 0.0
    assert abs(good["kf_gap_m"] - 4 * 0.8) < 0.01
    bad = compare.judge(_frames(truth, alter=30), truth, True, 5.0)
    assert bad["rpe_m"] > 1.9 and bad["ate_m"] > 0.1
    late = compare.judge(_frames(truth, kf_every=100), truth, True, 5.0)
    assert late["kf_gap_m"] > 45.0
    ok, checks = compare.verdict(bad, {"rpe_m": 0.5, "ate_m": 0.5})
    assert not ok and checks["rpe_m"]["value"] == bad["rpe_m"]
    ok, checks = compare.verdict({}, {"ate_m": 0.5})
    assert not ok and checks["ate_m"]["value"] is None
    assert good["ate_p90_m"] < 1e-9


def test_judge_ba_holds_the_windows_to_the_reference():
    from vobench.reference.window_ba import Window
    T = np.tile(np.eye(4), (4, 1, 1))
    T[:, 0, 3] = [0.0, 2.4, 4.8, 7.2]
    moved = T.copy()
    moved[1:, 1, 3] += 0.01
    ref = {0: [Window((0, 3, 6, 9), True, T),
               Window((9, 12, 15, 18), False, None),
               Window((18, 21, 24, 27), True, T),
               Window((27, 30, 33, 36), True, T)]}
    windows = [[0, 3, 6, 9], [18, 21, 24, 27], [27, 30, 33, 36]]
    same = compare.judge_ba({0: [(i, T) for i in windows]}, ref)
    assert same["ba_gap_med_m"] == same["ba_gap_m"] == 0.0
    assert same["ba_windows"] == same["ba_windows_ref"] == 3
    one = compare.judge_ba({0: [(windows[0], moved)] + [
        (i, T) for i in windows[1:]]}, ref)
    assert one["ba_gap_med_m"] == 0.0 and abs(one["ba_gap_m"] - 0.01) < 1e-12
    every = compare.judge_ba({0: [(i, moved) for i in windows]}, ref)
    assert abs(every["ba_gap_med_m"] - 0.01) < 1e-12
    assert compare.judge_ba({0: []}, ref)["ba_gap_med_m"] == float("inf")
    extra = {0: [(i, T) for i in windows] + [([9, 12, 15, 18], T)]}
    assert compare.judge_ba(extra, ref)["ba_gap_med_m"] == float("inf")
    assert np.isnan(compare.judge_ba({}, {0: []})["ba_gap_med_m"])
    ok, checks = compare.verdict(compare.judge_ba({0: []}, ref),
                                 {"ba_gap_med_m": 1e-3})
    assert not ok and checks["ba_gap_med_m"]["value"] is None


def test_roofline_shapes_are_the_programs():
    from stvo_pl_tpu_torch.models import frame
    from stvo_pl_tpu_torch.ops import image
    roof = {m.ID: m for m in registry.roofline_modules()}
    for name in ("kitti_pl", "kitti_points"):
        cfg = registry.config(name)
        vo, cam = cfg["vo"], cfg["camera"]
        budgets = frame._per_level_budgets(run_vo(cfg))
        assert roof["B2"].budgets(vo) == budgets
        mats = image._pyramid_matrices(cam["height"], cam["width"],
                                       vo["orb_nlevels"],
                                       vo["orb_scale_factor"], 0.6)
        shapes = [(cam["height"], cam["width"])] + [
            (My.shape[1], Mx.shape[1]) for My, Mx in mats]
        assert roof["B1"].level_shapes(vo, cam) == shapes
        assert len(roof["B1"].calls(vo, cam, 8)) == vo["orb_nlevels"]
        assert len(roof["B3"].calls(vo, cam, 8)) == int(vo["has_lines"])
        assert roof["B4"].calls(vo, cam, 8) == []
        assert roof["B5"].calls(vo, cam, 8) == []
    img = torch.zeros((1, 370, 1226))
    octs = frame._octave_images(img, 3)
    _, canvas = frame._octave_layout([tuple(i.shape[-2:]) for i in octs])
    vo = registry.config("kitti_pl")["vo"]
    assert roof["B3"].canvas_shape(vo, registry.config("kitti_pl")[
        "camera"]) == canvas


def run_vo(cfg):
    from vobench.system import vo_config
    return vo_config(cfg)


def test_import_guard_compares_whole_top_level_names():
    found = run.forbidden_modules(
        ["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
         "stvo_pl_tpu", "stvo_pl_tpu.ops.fast", "stvo_pl_tpu_torch",
         "stvo_pl_tpu_torch.models.frame", "jaxtyping", "numpy"])
    assert found == ["flax.linen", "jax", "jax.numpy", "jaxlib.xla_client",
                     "stvo_pl_tpu", "stvo_pl_tpu.ops.fast"]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_what_the_benchmark_imports():
    files = [p for p in registry.HERE.rglob("*.py")
             if "tests" not in p.parts]
    for p in files:
        assert not _imports(p) & set(run.FORBIDDEN), p
    for p in (registry.HERE / "reference").glob("*.py"):
        assert "stvo_pl_tpu_torch" not in _imports(p), p
