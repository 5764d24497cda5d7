"""The port's dataset CLI (stvo_pl_tpu_torch/cli.py), its dataset loader
and trajectory I/O against the JAX package's.

The dataset is 7 frames of the 240x180 point + line scene written to disk
as tests/test_cli_e2e.py writes one (PNG pairs, dataset_params.yaml, a
KITTI ground truth); 7 frames so that `--ba-window 4 --ba-kf-every 2`
fills one window (keyframes every second frame, and the front end's
own).  The JAX CLI runs on its kernel branches (interpret-mode Pallas,
tests/test_torch_helpers.py), the port's with `--device cpu`.

Tolerances: trajectories and the ATE lines within 5 mm, the documented
divergence of the blur's FMA contraction (ROADMAP.md §3); trajectory
files have the same layout (rows, columns, stamps); metrics I/O is numpy
in both packages and must agree exactly; rectification maps and
rectified frames to atol 1e-3 px / grey level (tests/test_torch_rectify.py).
"""

import numpy as np
import pytest
import torch

from stvo_pl_tpu.utils import dataset as jdata
from stvo_pl_tpu.utils import metrics as jmetrics
from stvo_pl_tpu_torch import cli as tcli
from stvo_pl_tpu_torch.utils import dataset as tdata
from stvo_pl_tpu_torch.utils import metrics as tmetrics

from test_torch_helpers import CAM_ARGS, jax_kernel_branch, rendered_sequence

torch.set_num_threads(1)

N_FRAMES = 7
BA_ARGS = ["--ba-window", "4", "--ba-kf-every", "2"]


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    from PIL import Image
    root = tmp_path_factory.mktemp("kitti_like_torch")
    (root / "image_0").mkdir()
    (root / "image_1").mkdir()
    L, R, poses = rendered_sequence(N_FRAMES, seed=3)
    for i in range(N_FRAMES):
        for sub, seq in (("image_0", L), ("image_1", R)):
            arr = np.clip(seq[i], 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(root / sub / f"{i:06d}.png")
    c = CAM_ARGS
    (root / "dataset_params.yaml").write_text(
        "images_subfolder_l: image_0/\n"
        "images_subfolder_r: image_1/\n"
        "cam0:\n"
        "  cam_model: Pinhole\n"
        f"  cam_width: {c['width']}\n  cam_height: {c['height']}\n"
        f"  cam_fx: {c['fx']}\n  cam_fy: {c['fy']}\n"
        f"  cam_cx: {c['cx']}\n  cam_cy: {c['cy']}\n"
        "  cam_d0: 0.0\n  cam_d1: 0.0\n  cam_d2: 0.0\n  cam_d3: 0.0\n"
        f"  cam_bl: {c['b']}\n")
    (root / "cfg.yaml").write_text(
        "orb_nfeatures: 300\norb_nlevels: 2\nlsd_nfeatures: 48\n"
        "min_features: 8\nfast_feat_th: 20\nlsd_n_dirs: 8\n")
    jmetrics.write_kitti(str(root / "gt.txt"), poses)
    return root


def _ate_values(out):
    return [float(l.split()[-2]) if "BA-refined" in l else float(l.split()[2])
            for l in out.splitlines() if "ATE" in l]


@pytest.fixture(scope="module")
def jax_runs(dataset_dir, tmp_path_factory):
    """The JAX CLI, plain and with the BA back end (one trace of the step
    for both): poses, printed lines and the output directory of each."""
    import contextlib
    import io

    from stvo_pl_tpu import cli as jcli
    runs = {}
    with jax_kernel_branch():
        for name, extra in (("plain", []), ("ba", BA_ARGS)):
            out_dir = tmp_path_factory.mktemp(f"jax_{name}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                poses = jcli.main(
                    [str(dataset_dir), "-c", str(dataset_dir / "cfg.yaml"),
                     "--quiet", "-t", str(out_dir / "traj.txt"),
                     "--kitti-out", str(out_dir / "traj_kitti.txt"),
                     "--gt", str(dataset_dir / "gt.txt")] + extra)
            runs[name] = dict(poses=np.asarray(poses), out=buf.getvalue(),
                              dir=out_dir)
    return runs


def _port(dataset_dir, out_dir, extra, capsys):
    capsys.readouterr()
    r = tcli.run([str(dataset_dir), "-c", str(dataset_dir / "cfg.yaml"),
                  "--quiet", "--device", "cpu",
                  "-t", str(out_dir / "traj.txt"),
                  "--kitti-out", str(out_dir / "traj_kitti.txt"),
                  "--gt", str(dataset_dir / "gt.txt")] + extra)
    return r, capsys.readouterr().out


def _same_layout(a, b):
    la = open(a).read().strip().splitlines()
    lb = open(b).read().strip().splitlines()
    assert len(la) == len(lb) == N_FRAMES
    assert [len(x.split()) for x in la] == [len(x.split()) for x in lb]
    return la, lb


def test_cli_plain_against_jax(dataset_dir, jax_runs, tmp_path, capsys):
    jax_run = jax_runs["plain"]
    r, out = _port(dataset_dir, tmp_path, ["--plot",
                                           str(tmp_path / "run.png")],
                   capsys)
    assert r.poses.shape == (N_FRAMES, 4, 4) and r.poses.dtype == np.float32
    assert np.isfinite(r.poses).all() and r.backend is None
    np.testing.assert_allclose(r.poses[:, :3, 3], jax_run["poses"][:, :3, 3],
                               rtol=0, atol=5e-3)
    ates, j_ates = _ate_values(out), _ate_values(jax_run["out"])
    assert len(ates) == len(j_ates) == 1, (out, jax_run["out"])
    assert abs(ates[0] - j_ates[0]) <= 5e-3
    assert ates[0] < 0.2
    la, lb = _same_layout(tmp_path / "traj.txt", jax_run["dir"] / "traj.txt")
    assert [x.split()[0] for x in la] == [x.split()[0] for x in lb]
    _same_layout(tmp_path / "traj_kitti.txt",
                 jax_run["dir"] / "traj_kitti.txt")
    assert (tmp_path / "run.png").stat().st_size > 0
    assert "ms/frame" in out


def test_cli_ba_against_jax(dataset_dir, jax_runs, tmp_path, capsys):
    jax_run = jax_runs["ba"]
    r, out = _port(dataset_dir, tmp_path,
                   BA_ARGS + ["--scene", str(tmp_path / "scene.html")],
                   capsys)
    j_out = jax_run["out"]
    np.testing.assert_array_equal(jax_run["poses"], jax_runs["plain"]["poses"])
    assert "1 window(s) refined" in out and "1 window(s) refined" in j_out
    assert len(r.backend.events) == 1 and r.poses_refined is not None
    ates, j_ates = _ate_values(out), _ate_values(j_out)
    assert len(ates) == len(j_ates) == 2, (out, j_out)
    np.testing.assert_allclose(ates, j_ates, rtol=0, atol=5e-3)
    t_ref = tmetrics.read_tum(str(tmp_path / "traj.txt.refined"))
    j_ref = jmetrics.read_tum(str(jax_run["dir"] / "traj.txt.refined"))
    np.testing.assert_allclose(t_ref[:, :3, 3], j_ref[:, :3, 3], rtol=0,
                               atol=5e-3)
    _same_layout(tmp_path / "traj.txt.refined",
                 jax_run["dir"] / "traj.txt.refined")
    html = (tmp_path / "scene.html").read_text()
    assert html.startswith("<!DOCTYPE html>") and "frustum" in html


def test_cli_decimation_and_gpu_default(dataset_dir):
    poses = tcli.main([str(dataset_dir), "-c", str(dataset_dir / "cfg.yaml"),
                       "-o", "1", "-s", "2", "--quiet", "--device", "cpu"])
    assert poses.shape[0] == 3            # frames 1, 3, 5 of 7
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tcli.main([str(dataset_dir), "--quiet"])


def test_cli_prints_the_stage_line(dataset_dir, capsys):
    """At the end of a run the CLI prints each stage's median time per
    step from the compiled step's stage stamps, in one line: on the CPU
    the host's clock, over every step of the run (frames 0, 2, 4, 6)."""
    import re
    capsys.readouterr()
    tcli.run([str(dataset_dir), "-c", str(dataset_dir / "cfg.yaml"),
              "-s", "2", "--quiet", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("[stvo] stages:")]
    assert len(lines) == 1, lines
    m = re.fullmatch(r"\[stvo\] stages: median host ms per step over 4 "
                     r"step\(s\): points (\S+)  lines (\S+)  f2f (\S+)  "
                     r"optimizer (\S+)  keyframe (\S+)", lines[0])
    assert m, lines[0]
    ms = [float(v) for v in m.groups()]
    assert all(v >= 0 for v in ms) and ms[0] > 0 and ms[3] > 0


def test_image_sequence_against_jax(dataset_dir):
    t = tdata.ImageSequence(str(dataset_dir), offset=1, step=2, nmax=2,
                            device="cpu")
    j = jdata.ImageSequence(str(dataset_dir), offset=1, step=2, nmax=2)
    assert len(t) == len(j) == 2 and t.stamps == j.stamps == [1.0, 3.0]
    for (tl, tr), (jl, jr) in zip(t, j):
        np.testing.assert_array_equal(tl.numpy(), jl)
        np.testing.assert_array_equal(tr.numpy(), jr)
    assert tdata.sorted_images(str(dataset_dir / "image_0")) == \
        jdata.sorted_images(str(dataset_dir / "image_0"))


CALIBS = {
    "pinhole_distorted": {"cam0": dict(
        cam_model="Pinhole", cam_width=240, cam_height=180, cam_fx=160.0,
        cam_fy=158.0, cam_cx=121.0, cam_cy=88.0, cam_bl=0.3, cam_d0=-0.12,
        cam_d1=0.03, cam_d2=0.001, cam_d3=-0.0005)},
    "full_radtan": {"cam0": dict(
        cam_model="Pinhole", cam_width=240, cam_height=180,
        Kl=[160.0, 159.0, 119.0, 91.0], Kr=[161.0, 160.0, 122.0, 89.0],
        Dl=[-0.1, 0.02, 0.0005, -0.0003, 0.0],
        Dr=[-0.09, 0.018, -0.0004, 0.0002, 0.0],
        R=[0.99998, -0.0035, 0.0052, 0.0035, 0.99999, 0.0011, -0.0052,
           -0.0011, 0.99998], t=[-0.3, 0.002, 0.001])},
    "full_fisheye": {"cam0": dict(
        cam_model="fisheye", cam_width=240, cam_height=180,
        Kl=[150.0, 150.0, 120.0, 90.0], Kr=[150.5, 150.5, 121.0, 90.5],
        Dl=[0.01, -0.002, 0.0, 0.0], Dr=[0.012, -0.003, 0.0, 0.0],
        R=[1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0],
        t=[-0.25, 0.0, 0.0])},
    "rectified": {"cam0": dict(
        cam_model="Pinhole", cam_width=240, cam_height=180, cam_fx=160.0,
        cam_fy=160.0, cam_cx=120.0, cam_cy=90.0, cam_bl=0.3)},
}


@pytest.mark.parametrize("name", list(CALIBS))
def test_calib_from_yaml_against_jax(name, dataset_dir, tmp_path):
    """Both calibration forms give the same camera and maps, and the
    sequence's rectified frames agree."""
    params = CALIBS[name]
    t, j = tdata.calib_from_yaml(params), jdata.calib_from_yaml(params)
    assert tuple(t.cam) == tuple(j.cam)
    assert (t.map_l is None) == (j.map_l is None) == (name == "rectified")
    if t.map_l is None:
        return
    np.testing.assert_allclose(t.map_l, j.map_l, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.map_r, j.map_r, rtol=0, atol=1e-3)
    tl, tr = tdata.ImageSequence(str(dataset_dir), nmax=1, calib=t,
                                 device="cpu").frame(0)
    jl, jr = jdata.ImageSequence(str(dataset_dir), nmax=1, calib=j).frame(0)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0, atol=1e-3)
    np.testing.assert_allclose(tr.numpy(), jr, rtol=0, atol=1e-3)


def test_metrics_io_against_jax(tmp_path):
    rng = np.random.default_rng(5)
    poses = np.stack([np.eye(4)] * 6)
    from scipy.spatial.transform import Rotation
    poses[:, :3, :3] = Rotation.from_rotvec(
        rng.normal(0, 0.3, (6, 3))).as_matrix()
    poses[:, :3, 3] = rng.normal(0, 5, (6, 3))
    stamps = 1.5e9 + np.arange(6) * 0.1
    for mod, tag in ((tmetrics, "t"), (jmetrics, "j")):
        mod.write_tum(str(tmp_path / f"{tag}.tum"), poses, stamps=stamps)
        mod.write_kitti(str(tmp_path / f"{tag}.kitti"), poses)
    for ext in ("tum", "kitti"):
        assert (tmp_path / f"t.{ext}").read_text() == \
            (tmp_path / f"j.{ext}").read_text()
    tp, ts = tmetrics.read_trajectory(str(tmp_path / "t.tum"),
                                      return_stamps=True)
    jp, js = jmetrics.read_trajectory(str(tmp_path / "t.tum"),
                                      return_stamps=True)
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tp, poses, atol=1e-9)
    tk, tks = tmetrics.read_trajectory(str(tmp_path / "t.kitti"),
                                       return_stamps=True)
    assert tks is None
    np.testing.assert_array_equal(tk, jmetrics.read_kitti(
        str(tmp_path / "t.kitti")))
    assert tmetrics.trajectory_length(poses) == \
        jmetrics.trajectory_length(poses)
    frame_stamps = stamps[::2] + 0.004
    np.testing.assert_array_equal(
        tmetrics.associate_by_stamps(stamps, frame_stamps),
        jmetrics.associate_by_stamps(stamps, frame_stamps))
    for bad in (frame_stamps * 1e9, frame_stamps + 0.05):
        with pytest.raises(ValueError):
            tmetrics.associate_by_stamps(stamps, bad)
        with pytest.raises(ValueError):
            jmetrics.associate_by_stamps(stamps, bad)
