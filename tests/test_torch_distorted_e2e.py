"""The port's dataset CLI on a distorted rig against the JAX CLI: the
counterpart of tests/test_distorted_e2e.py::test_distorted_dataset_cli_e2e,
on the same raw images (radtan and equidistant lens models rendered
directly through the distortion, 5 frames at 240 x 180, the reference's
Kl/Kr/Dl/Dr/R/t `dataset_params.yaml`).

The JAX CLI rectifies each pair in its dataset loader; the port's CLI
feeds the raw pairs to its step, which rectifies them inside (the
`rectify` stage of its stage line).  The JAX CLI runs on its kernel
branches (interpret-mode Pallas, tests/test_torch_helpers.py), the port's
with `--device cpu`.  Tolerances are tests/test_torch_cli.py's:
trajectories and the ATE lines within 5 mm."""

import re

import numpy as np
import pytest
import torch

from test_distorted_e2e import (DIST, N_FRAMES, _render_distorted,
                                _write_dataset)
from test_torch_helpers import jax_kernel_branch

torch.set_num_threads(1)


def _ate(out: str) -> float:
    lines = [l for l in out.splitlines() if "ATE" in l]
    assert len(lines) == 1, out
    return float(lines[0].split()[2])


@pytest.mark.parametrize("model", ["radtan", "equidistant"])
def test_distorted_dataset_cli_against_jax(model, tmp_path, capsys):
    import jax

    from stvo_pl_tpu import cli as jcli
    from stvo_pl_tpu.utils import synthetic
    from stvo_pl_tpu_torch import cli as tcli

    d_l, d_r = DIST[model]
    scene = synthetic.make_scene(jax.random.PRNGKey(11), n_points=260,
                                 n_lines=24, extent=(14.0, 8.0, 40.0),
                                 z_near=3.0)
    poses = synthetic.smooth_trajectory(N_FRAMES, speed=0.25)
    seq_l, seq_r = _render_distorted(scene, poses, model, d_l, d_r)
    root = tmp_path / model
    root.mkdir()
    _write_dataset(root, model, d_l, d_r, seq_l, seq_r, poses)
    args = [str(root), "-c", str(root / "cfg.yaml"), "--quiet", "--gt",
            str(root / "gt.txt")]

    with jax_kernel_branch():
        j_poses = np.asarray(jcli.main(args))
    j_out = capsys.readouterr().out
    r = tcli.run(args + ["--device", "cpu"])
    out = capsys.readouterr().out

    assert r.poses.shape == (N_FRAMES, 4, 4) and np.isfinite(r.poses).all()
    np.testing.assert_allclose(r.poses[:, :3, 3], j_poses[:, :3, 3], rtol=0,
                               atol=5e-3)
    assert abs(_ate(out) - _ate(j_out)) <= 5e-3
    assert _ate(out) < 0.15
    assert np.linalg.norm(r.poses[-1][:3, 3]) > 0.05
    # the raw pairs went to the step, which rectified them
    assert re.search(r"\[stvo\] raw frames rectified inside the step; "
                     r"\S+% of rectified pixels sample outside", out), out
    stages = [l for l in out.splitlines() if l.startswith("[stvo] stages:")]
    assert len(stages) == 1 and re.search(
        r"step\(s\): rectify \S+  points \S+  lines", stages[0]), stages
