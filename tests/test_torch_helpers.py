"""Shared pieces of the port's line tests (no tests of its own): the JAX
package forced onto its kernel branch on the CPU, the small rendered
stereo sequence, and a matcher of segment sets."""

import contextlib
import functools

import numpy as np
import jax
import pytest

from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.ops import fast as jfast
from stvo_pl_tpu.ops import lsd as jlsd
from stvo_pl_tpu.utils import synthetic as jsyn

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
JCAM = jcam.StereoCamera(**CAM_ARGS)
# the point + line configuration of tests/test_e2e_vo.py with the default
# 3-octave canvas detector (8 canvas directions)
SMALL = dict(orb_nfeatures=300, orb_nlevels=2, lsd_nfeatures=48,
             lsd_n_dirs=8, min_features=8, fast_feat_th=20)
MIN_LEN = 0.025 * 180          # cfg.min_line_length * min(width, height)


class GateOnTpu:
    """Stands in for `jax` inside a module of the JAX package whose branch
    is chosen by `jax.default_backend()`: there it reads "tpu", so the
    Pallas kernel branch runs.  Everything else is the real `jax`."""

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def default_backend():
        return "tpu"


@contextlib.contextmanager
def jax_kernel_branch(lsd: bool = True):
    """The JAX package on its kernel branches (FAST and LSD) with
    `pallas_call` in interpret mode.  `detect_line_segments` and `vo_step`
    are jitted and read the backend while tracing, so the traces made
    before and under the patches are dropped on both sides.  With
    `lsd=False` only FAST takes its kernel branch and the line detector
    stays on the per-direction generator it runs off the TPU."""
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(jfast, "jax", GateOnTpu())
        if lsd:
            mp.setattr(jlsd, "jax", GateOnTpu())
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def rendered_sequence(n_frames: int, seed: int = 0, n_lines: int = 24):
    """(L, R, poses) as numpy: the 240x180 scene of tests/test_e2e_vo.py."""
    scene = jsyn.make_scene(jax.random.PRNGKey(seed), n_points=260,
                            n_lines=n_lines, extent=(14.0, 8.0, 40.0),
                            z_near=3.0)
    poses = jsyn.smooth_trajectory(n_frames, speed=0.25, yaw_rate=0.003)
    L, R = jsyn.render_sequence(scene, poses, JCAM)
    return np.array(L), np.array(R), np.array(poses)


def shared_fraction(sp_a, ep_a, valid_a, sp_b, ep_b, valid_b,
                    tol: float = 0.5) -> float:
    """Share of the valid segments of the larger set that have a partner in
    the other set with both endpoints within `tol` px."""
    a = np.concatenate([sp_a, ep_a], axis=-1)[valid_a]
    b = np.concatenate([sp_b, ep_b], axis=-1)[valid_b]
    if len(a) == 0 or len(b) == 0:
        return float(len(a) == len(b))
    d = np.abs(a[:, None, :] - b[None, :, :]).max(axis=-1)
    hit = (d.min(axis=1) <= tol).sum()
    return hit / max(len(a), len(b))
