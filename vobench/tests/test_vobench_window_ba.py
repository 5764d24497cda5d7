"""The plain reference of the back end (vobench/reference/window_ba.py)
against the program's `WindowedBA` on the CPU: the port's VO over a small
rendered sequence feeds both the same frames, as the online cell's driver
does, and every window the program refines the reference refines too, to
the same keyframe poses within float32's rounding; a back end that returns
its windows' input poses is told apart by far, and so is the reference
in float32 with its products in TF32."""

import numpy as np
import pytest
import torch

from vobench.reference import compare, render, window_ba

CAM = render.Camera(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                    height=180)
SCENE = dict(n_points=260, n_lines=24, extent=[14.0, 8.0, 40.0], z_near=3.0)
SMALL = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
             lsd_n_dirs=8, min_features=8, fast_feat_th=20)
BA = dict(window=4, kf_every=3, n_iters=8, damping=1e-4, reproj_gate=8.0,
          chi2_tol=1.10, max_disagree_t=0.25, max_disagree_r=1.0,
          max_correction=1.0, max_rot_correction=15.0)


@pytest.fixture(scope="module")
def run24():
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.models.backend import WindowedBA
    from stvo_pl_tpu_torch.ops.camera import StereoCamera

    left, right, _ = render.render_pool(2 ** 31 + 5, 1, CAM, SCENE, 24,
                                        0.25, "cpu")
    cfg = VOConfig(**SMALL)
    cam = StereoCamera(**CAM._asdict())
    state = frontend.init_state(cfg, device="cpu")
    ba = WindowedBA(cam, cfg, window=BA["window"], n_iters=BA["n_iters"],
                    force_kf_every=BA["kf_every"], device="cpu")
    frames, events = [], []
    for i in range(24):
        state, t = frontend.vo_step(state, left[i], right[i], cam, cfg)
        Tfw = t.Tfw.numpy().astype(np.float32)
        ev = ba.observe(i, Tfw, i > 0 and bool(t.is_kf), state.prev_points,
                        state.prev_lines)
        frames.append((0, i, Tfw, bool(t.is_kf), state.prev_points,
                       state.prev_lines))
        if ev is not None:
            events.append((list(ev[0]), np.asarray(ev[1])))
    vo = dict(min_ratio_12_p=cfg.min_ratio_12_p,
              min_ratio_12_l=cfg.min_ratio_12_l,
              best_lr_matches=cfg.best_lr_matches,
              line_sim_th=cfg.line_sim_th, orb_wta_k=cfg.orb_wta_k,
              has_lines=cfg.has_lines)
    return frames, {0: events}, window_ba.Settings.of(vo, BA)


def test_the_reference_refines_the_programs_windows(run24):
    frames, program, settings = run24
    for anchors in (None, program):         # its own chain, the program's
        ref = window_ba.replay(frames, CAM, settings, "cpu", anchors)
        got = compare.judge_ba(program, ref)
        assert got["ba_windows"] == got["ba_windows_ref"] >= 2
        assert got["ba_gap_m"] < 1e-4 and got["ba_gap_deg"] < 1e-3, got


def test_input_poses_are_not_a_refinement(run24):
    frames, program, settings = run24
    ref = window_ba.replay(frames, CAM, settings, "cpu")
    unrefined = window_ba.replay(frames, CAM, settings._replace(n_iters=0),
                                 "cpu")
    as_program = {0: [(list(w.idxs), w.T) for w in unrefined[0]
                      if w.refined]}
    assert compare.judge_ba(as_program, ref)["ba_gap_med_m"] > 0.05


def test_float32_reference_rounds_like_the_program(run24):
    frames, program, settings = run24
    ref = window_ba.replay(frames, CAM, settings, "cpu")
    f32 = _own_windows(window_ba.BackEnd(CAM, settings, torch.float32),
                       frames)
    assert compare.judge_ba(f32, ref)["ba_gap_m"] < 1e-4


def _own_windows(end, frames):
    out = {0: []}
    for _, f, T, kf, pts, lns in frames:
        ev = end.observe(f, T, f > 0 and kf, pts, lns)
        if ev is not None:
            out[0].append(ev)
    return out


def test_tf32_products_are_told_apart(run24):
    from vobench.controls import TF32BackEnd
    frames, program, settings = run24
    sound = compare.judge_ba(program, window_ba.replay(
        frames, CAM, settings, "cpu", program))["ba_gap_med_m"]
    tf32 = _own_windows(TF32BackEnd(CAM, settings, torch.float32), frames)
    control = compare.judge_ba(tf32, window_ba.replay(
        frames, CAM, settings, "cpu", tf32))["ba_gap_med_m"]
    print(f"median window gap: program {sound:.3g} m, TF32 {control:.3g} m")
    assert control > 3 * sound
