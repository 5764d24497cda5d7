"""The rectification of a distorted rig on the card, at the EuRoC MAV
rig's 752 x 480 (vobench/configs/euroc_pl.json, the frames of the
benchmark's `euroc_pl.online` cell: rendered, then made raw by
vobench/reference/rectify.py).

- The one-lane step captured with the rectification (the raw pair in,
  remapped inside the graph) equals, bit for bit, the eager
  `rectify_remap` of each eye followed by the step captured without it,
  over 20 frames; its graph holds one stamp node more.
- The card's tap remap against the float64 reference's remap with the
  reference's maps, within 0.02 grey levels (float32 maps are 3e-5 px
  from float64, against gradients of up to 215 grey levels a pixel; 6.5e-3
  measured on the CPU's float32).
- B1, B2 and B3 against their plain versions (torch.equal) at the EuRoC
  pyramid's and line canvas' shapes, the first run of the kernels at this
  width (chip_smoke.pair_kernels_equal).

Marked `gpu`: each test skips unless a CUDA device is present.  Run with
`pytest --noconftest -m gpu tests/test_torch_rectify_cuda.py`."""

import pytest
import torch

pytestmark = pytest.mark.gpu

FRAMES = 20
SEED = 2 ** 40 + 22
REMAP_TOL = 0.02            # grey levels


@pytest.fixture(scope="module")
def rig():
    """(config, calibration, raw left, raw right [FRAMES, 480, 752],
    rectified-camera renders) of the cell's first sequence, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from stvo_pl_tpu_torch.utils.dataset import calib_from_yaml
    from vobench import registry
    from vobench.reference import rectify as ref
    from vobench.reference import render
    from vobench.system_online import cam0

    cfg = registry.config("euroc_pl")
    mix = registry.traffic("euroc_online")
    cam = render.Camera(*(cfg["camera"][k] for k in render.Camera._fields))
    left, right, _ = render.render_pool(SEED, 1, cam, mix["scene"], FRAMES,
                                        mix["speed_m_per_frame"], "cuda")
    raw_l, raw_r = ref.raw_pool((left, right), cfg)
    cal = calib_from_yaml(dict(cam0=cam0(cfg["raw"], cfg["camera"])))
    return cfg, cal, raw_l, raw_r


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _same(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        return (torch.equal(a.isnan(), b.isnan())
                and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))
    return torch.equal(a, b)


def test_captured_step_rectifies_like_remap_then_step(rig):
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import camera as tcam
    from vobench.reference.graph_nodes import graph_nodes, kept_graphs
    from vobench.system import vo_config

    cfg, cal, raw_l, raw_r = rig
    vo = vo_config(cfg)
    taps = tcam.rectify_taps(cal.map_l, cal.map_r, (480, 752), "cuda")
    maps = [torch.from_numpy(m).cuda() for m in (cal.map_l, cal.map_r)]
    with kept_graphs():
        inside = frontend.compile_vo_step(cal.cam, vo, device="cuda",
                                          rectify=taps)
        plain = frontend.compile_vo_step(cal.cam, vo, device="cuda")
        s_in = s_pl = frontend.init_state(vo, device="cuda")
        inliers = []
        for i in range(FRAMES):
            s_in, t_in = inside(s_in, raw_l[i], raw_r[i])
            s_pl, t_pl = plain(s_pl, tcam.rectify_remap(raw_l[i], maps[0]),
                               tcam.rectify_remap(raw_r[i], maps[1]))
            a, b = _leaves((s_in, t_in)), _leaves((s_pl, t_pl))
            assert len(a) == len(b) and all(map(_same, a, b)), i
            inliers.append(int(t_in.n_inliers_pt))
    assert min(inliers[1:]) > 20, inliers
    (p_in,), (p_pl,) = inside.programs.values(), plain.programs.values()
    n_in, n_pl = graph_nodes(p_in.graph)[0], graph_nodes(p_pl.graph)[0]
    stamps = [sum(v for k, v in n.items() if "stage_stamp" in k)
              for n in (n_in, n_pl)]
    assert stamps == [7, 6], (stamps, sum(n_in.values()), sum(n_pl.values()))
    print(f"graph nodes: {sum(n_in.values())} with the rectification, "
          f"{sum(n_pl.values())} without")
    names, ns = inside.stages()
    assert names[:2] == ["begin", "rectify"] and len(ns) == FRAMES


def test_card_remap_against_the_float64_reference(rig):
    from stvo_pl_tpu_torch.ops import camera as tcam
    from vobench.reference import rectify as ref

    cfg, cal, raw_l, raw_r = rig
    taps = tcam.rectify_taps(cal.map_l, cal.map_r, (480, 752), "cuda")
    got = tcam.remap_taps(raw_l[:4], raw_r[:4], taps)
    maps = ref.rectify_maps(ref.Rig.of(cfg), "cuda")[:2]
    for g, raw, mp in zip(got, (raw_l[:4], raw_r[:4]), maps):
        err = float((g.double() - ref.remap(raw, mp)).abs().max())
        assert err <= REMAP_TOL, err


def test_kernels_at_the_euroc_shapes(rig):
    from chip_smoke import pair_kernels_equal
    from stvo_pl_tpu_torch.ops import camera as tcam
    from vobench.system import vo_config

    cfg, cal, raw_l, raw_r = rig
    taps = tcam.rectify_taps(cal.map_l, cal.map_r, (480, 752), "cuda")
    for i in (0, FRAMES - 1):
        rect_l, rect_r = tcam.remap_taps(raw_l[i], raw_r[i], taps)
        shapes = pair_kernels_equal(rect_l, rect_r, vo_config(cfg),
                                    where=f"euroc frame {i}")
    assert shapes["fast_pack"][0] == [2, 480, 752]
    assert len(shapes["fast_pack"]) == vo_config(cfg).orb_nlevels
