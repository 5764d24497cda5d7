"""The port's rectification of a distorted rig (ops/camera.py) against the
benchmark's plain float64 reference (vobench/reference/rectify.py), with
no JAX: the maps of seeded random calibrations near EuRoC's (radtan and
equidistant, 96 x 64) within 1e-3 px, through the dataset loader's own
entry (`calib_from_yaml`); the tap remap (`rectify_taps` /
`remap_taps`) equal to `rectify_remap` bit for bit; the one-lane step
built with the rectification equal bit for bit to the remap followed by
the step built without it, 8 frames on the 240 x 180 camera; the
dataset's raw and rectified iteration; and the reference's raw frames
(`raw_from_rectified`) brought back by the port's rectification.

Tolerances.  Maps: the port builds them in float64 and stores float32
(4e-6 px apart here); in bfloat16 they would be 0.25 px apart at 96 px.
Round trip: a raw frame is the rectified one sampled bilinearly and
rounded to whole grey levels, then sampled bilinearly back, so a smooth
test image (amplitude 60, periods 29 and 23 px) comes back within a mean
of 1.0 and a largest error of 4.0 grey levels inside the valid region
(measured 0.57 and 2.7); maps from k1 off by 2% miss both (1.9, 15)."""

import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models import frontend
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils.dataset import (ImageSequence, calib_from_yaml,
                                             load_gray)
from vobench.reference import rectify as ref
from vobench.reference import render
from vobench.system_online import cam0

torch.set_num_threads(1)

# the EuRoC MAV rig (configs/dataset_params/euroc_params.yaml)
EUROC = dict(
    Kl=[458.654, 457.296, 367.215, 248.375],
    Kr=[457.587, 456.134, 379.999, 255.238],
    Dl=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
    Dr=[-0.28368365, 0.07451284, -0.00010473, -3.55590700e-05],
    R=[9.99997256e-01, 2.31206719e-03, 3.76008102e-04,
       -2.31713572e-03, 9.99898049e-01, 1.40898358e-02,
       -3.43393121e-04, -1.40906685e-02, 9.99900663e-01],
    t=[-0.11007381, 0.00039912, -0.0008537])
MAP_TOL = 1e-3              # px
ROUND_TRIP_MEAN, ROUND_TRIP_MAX = 1.0, 4.0      # grey levels
# the point + line configuration of the port's small VO tests
SMALL = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
             lsd_n_dirs=8, min_features=8, fast_feat_th=20)


def scaled(width: int, height: int, model: str = "radtan",
           k1_scale: float = 1.0) -> dict:
    """The EuRoC rig's `raw` table for images of width x height."""
    sx, sy = width / 752, height / 480
    raw = dict(EUROC, model=model)
    for k in ("Kl", "Kr"):
        f, g, cx, cy = raw[k]
        raw[k] = [f * sx, g * sy, cx * sx, cy * sy]
    for k in ("Dl", "Dr"):
        raw[k] = [raw[k][0] * k1_scale] + list(raw[k][1:])
    return raw


def near_euroc(seed: int, model: str, width=96, height=64) -> dict:
    """A seeded random calibration near EuRoC's, at width x height."""
    g = np.random.default_rng(seed)
    raw = scaled(width, height, model)
    for k in ("Kl", "Kr"):
        f, fy, cx, cy = raw[k]
        raw[k] = [f * (1 + 0.02 * g.standard_normal()),
                  fy * (1 + 0.02 * g.standard_normal()),
                  cx + g.normal(0, 1), cy + g.normal(0, 1)]
    for k in ("Dl", "Dr"):
        if model == "radtan":
            raw[k] = [v * (1 + 0.1 * g.standard_normal()) for v in raw[k]]
        else:
            raw[k] = [-0.02 * (1 + 0.2 * g.standard_normal()),
                      0.004 * (1 + 0.2 * g.standard_normal()),
                      -0.001, 0.0005]
    R = (Rotation.from_rotvec(g.normal(0, 0.01, 3)).as_matrix()
         @ np.array(raw["R"]).reshape(3, 3))
    raw["R"] = R.reshape(-1).tolist()
    raw["t"] = (np.array(raw["t"]) + g.normal(0, 0.002, 3)).tolist()
    return raw


def calib(raw: dict, width: int, height: int):
    """The port's calibration (maps and camera) through the loader."""
    return calib_from_yaml(dict(cam0=cam0(raw, dict(width=width,
                                                    height=height))))


def rig(raw: dict, width: int, height: int) -> ref.Rig:
    return ref.Rig.of(dict(raw=raw, camera=dict(width=width, height=height)))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_maps_against_the_plain_reference(model, seed):
    raw = near_euroc(seed, model)
    cal = calib(raw, 96, 64)
    map_l, map_r, cam = ref.rectify_maps(rig(raw, 96, 64))
    assert cal.map_l.shape == (64, 96, 2) and cal.map_l.dtype == np.float32
    np.testing.assert_allclose(cal.map_l, map_l.numpy(), rtol=0,
                               atol=MAP_TOL)
    np.testing.assert_allclose(cal.map_r, map_r.numpy(), rtol=0,
                               atol=MAP_TOL)
    for k in ("fx", "fy", "cx", "cy", "b"):
        assert abs(getattr(cal.cam, k) - cam[k]) < 1e-9, k
    # the maps bend: far from the identity grid
    yy, xx = np.meshgrid(np.arange(64), np.arange(96), indexing="ij")
    assert np.abs(cal.map_l[..., 0] - xx).max() > 1.0


def test_the_maps_in_bfloat16_would_fail():
    raw = near_euroc(0, "radtan")
    map_l = calib(raw, 96, 64).map_l
    want = ref.rectify_maps(rig(raw, 96, 64))[0].numpy()
    bf16 = torch.from_numpy(map_l).bfloat16().float().numpy()
    assert np.abs(bf16 - want).max() > 100 * MAP_TOL


@pytest.mark.parametrize("lead", [(), (3,)])
def test_tap_remap_equals_rectify_remap(lead):
    cal = calib(scaled(160, 120), 160, 120)
    # a map that reaches past the image too: taps outside read 0
    far = cal.map_r * 1.3 - 20.0
    g = torch.Generator().manual_seed(7)
    for map_l, map_r in ((cal.map_l, cal.map_r), (cal.map_l, far)):
        taps = tcam.rectify_taps(map_l, map_r, (120, 160), "cpu")
        imgs = torch.rand((2,) + lead + (120, 160), generator=g) * 255
        got_l, got_r = tcam.remap_taps(imgs[0], imgs[1], taps)
        want_l = tcam.rectify_remap(imgs[0], torch.from_numpy(map_l))
        want_r = tcam.rectify_remap(imgs[1], torch.from_numpy(map_r))
        assert got_l.dtype == torch.float32 and got_l.is_contiguous()
        assert torch.equal(got_l, want_l) and torch.equal(got_r, want_r)
    outside = [((m[..., 0] < 0) | (m[..., 0] > 159) | (m[..., 1] < 0)
                | (m[..., 1] > 119)).mean() for m in (cal.map_l, far)]
    assert outside[1] > 0.1
    assert taps.outside_share == pytest.approx(sum(outside) / 2)


def _same(a, b) -> bool:
    """Equal bit for bit, NaN where the other has NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return torch.equal(a, b)


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _raw_sequence(raw: dict, width: int, height: int, n: int, seed: int):
    """n raw pairs of the rig: rendered through its rectified camera, then
    made raw by the plain reference."""
    c = ref.rectified_camera(rig(raw, width, height))
    cam = render.Camera(*(c[k] for k in render.Camera._fields))
    left, right, truth = render.render_pool(
        seed, 1, cam, dict(n_points=260, n_lines=24, extent=(8.0, 4.0, 16.0),
                           z_near=1.5), n, 0.05, "cpu")
    r = rig(raw, width, height)
    return (ref.raw_from_rectified(left, r, 0),
            ref.raw_from_rectified(right, r, 1), truth)


def test_one_lane_step_rectifies_inside_bit_for_bit():
    W, H, N = 240, 180, 8
    raw = scaled(W, H)
    cal = calib(raw, W, H)
    L, R, _ = _raw_sequence(raw, W, H, N, seed=2 ** 33 + 3)
    cfg = VOConfig(**SMALL)
    taps = tcam.rectify_taps(cal.map_l, cal.map_r, (H, W), "cpu")
    inside = frontend.compile_vo_step(cal.cam, cfg, device="cpu",
                                      rectify=taps)
    plain = frontend.compile_vo_step(cal.cam, cfg, device="cpu")
    maps = [torch.from_numpy(m) for m in (cal.map_l, cal.map_r)]
    s_in = s_pl = frontend.init_state(cfg, device="cpu")
    kfs = 0
    for i in range(N):
        s_in, t_in = inside(s_in, L[i], R[i])
        s_pl, t_pl = plain(s_pl, tcam.rectify_remap(L[i], maps[0]),
                           tcam.rectify_remap(R[i], maps[1]))
        a, b = _leaves((s_in, t_in)), _leaves((s_pl, t_pl))
        assert len(a) == len(b) and all(map(_same, a, b)), i
        kfs += int(t_in.is_kf)
    assert kfs and int(t_in.n_inliers_pt) > 20
    names = ["begin", "points", "lines", "f2f", "optimizer", "keyframe"]
    assert plain.stages()[0] == names
    assert inside.stages()[0] == names[:1] + ["rectify"] + names[1:]
    with pytest.raises(ValueError, match="shape"):
        inside(s_in, L[0][:-1], R[0][:-1])
    with pytest.raises(ValueError, match="rectification makes"):
        frontend.compile_vo_step(cal.cam._replace(width=W + 1), cfg,
                                 device="cpu", rectify=taps)


def test_raw_frames_come_back_through_the_port():
    W, H = 240, 180
    raw = scaled(W, H)
    r = rig(raw, W, H)
    yy, xx = torch.meshgrid(torch.arange(H, dtype=torch.float64),
                            torch.arange(W, dtype=torch.float64),
                            indexing="ij")
    img = (128 + 60 * torch.sin(2 * np.pi * xx / 29)
           * torch.cos(2 * np.pi * yy / 23)).float()[None]
    raw_l = ref.raw_from_rectified(img, r, 0)
    raw_r = ref.raw_from_rectified(img, r, 1)
    assert torch.equal(raw_l, torch.round(raw_l))
    assert 0 <= float(raw_l.min()) and float(raw_l.max()) <= 255
    errors = {}
    for k1 in (1.0, 1.02):
        cal = calib(scaled(W, H, k1_scale=k1), W, H)
        taps = tcam.rectify_taps(cal.map_l, cal.map_r, (H, W), "cpu")
        back = tcam.remap_taps(raw_l, raw_r, taps)
        for eye, (b, mp) in enumerate(zip(back, (cal.map_l, cal.map_r))):
            m = torch.from_numpy(mp)
            valid = ((m[..., 0] > 2) & (m[..., 0] < W - 3) & (m[..., 1] > 2)
                     & (m[..., 1] < H - 3))
            valid[:3] = valid[-3:] = False
            valid[:, :3] = valid[:, -3:] = False
            assert valid.float().mean() > 0.85
            d = (b[0] - img[0]).abs()[valid]
            errors[k1, eye] = float(d.mean()), float(d.max())
    for eye in (0, 1):
        mean, worst = errors[1.0, eye]
        assert mean <= ROUND_TRIP_MEAN and worst <= ROUND_TRIP_MAX, errors
        mean, worst = errors[1.02, eye]
        assert mean > ROUND_TRIP_MEAN and worst > ROUND_TRIP_MAX, errors


def test_dataset_iterates_raw_and_rectified_pairs(tmp_path):
    from PIL import Image
    W, H, N = 160, 120, 3
    raw = scaled(W, H)
    L, R, _ = _raw_sequence(raw, W, H, N, seed=11)
    for sub, seq in (("image_0", L), ("image_1", R)):
        (tmp_path / sub).mkdir()
        for i in range(N):
            Image.fromarray(seq[i].numpy().astype(np.uint8)).save(
                tmp_path / sub / f"{i:06d}.png")
    block = cam0(raw, dict(width=W, height=H))
    lines = ["images_subfolder_l: image_0/", "images_subfolder_r: image_1/",
             "cam0:"] + [f"  {k}: {v}" for k, v in block.items()]
    (tmp_path / "dataset_params.yaml").write_text("\n".join(lines) + "\n")
    seq = ImageSequence(str(tmp_path), device="cpu")
    taps = seq.rectification
    assert isinstance(taps, tcam.RectifyTaps) and taps.raw_hw == (H, W)
    raw_pairs = list(seq.prefetch(raw=True))
    assert seq.loader == "native" and len(raw_pairs) == N
    maps = [torch.from_numpy(m) for m in (seq.calib.map_l, seq.calib.map_r)]
    for i, (pair, rect, it) in enumerate(zip(raw_pairs, seq.prefetch(),
                                             seq)):
        files = [torch.from_numpy(load_gray(p)) for p in (seq.paths_l[i],
                                                          seq.paths_r[i])]
        assert all(torch.equal(x, y) for x, y in zip(pair, files))
        want = [tcam.rectify_remap(x, m) for x, m in zip(files, maps)]
        assert all(torch.equal(x, y) for x, y in zip(rect, want))
        assert all(torch.equal(x, y) for x, y in zip(it, want))
        assert all(torch.equal(x, y) for x, y in zip(seq.frame(i), want))
