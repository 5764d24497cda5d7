"""Shared pieces of the port's tests (no tests of its own): the JAX
package forced onto its kernel branch on the CPU, the small rendered
stereo sequence, a matcher of segment sets, and the audit of host
traffic that a CUDA graph capture would refuse."""

import contextlib
import functools
import traceback

import numpy as np
import jax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
def jax_kernel_branch(lsd: bool = True, orb: bool = False):
    """The JAX package on its kernel branches (FAST and LSD) with
    `pallas_call` in interpret mode.  `detect_line_segments` and `vo_step`
    are jitted and read the backend while tracing, so the traces made
    before and under the patches are dropped on both sides.  With
    `lsd=False` only FAST takes its kernel branch and the line detector
    stays on the per-direction generator it runs off the TPU; `orb=True`
    also puts ORB's patch gather on its Pallas kernel."""
    from jax.experimental import pallas as pl
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call",
                   functools.partial(pl.pallas_call, interpret=True))
        mp.setattr(jfast, "jax", GateOnTpu())
        if lsd:
            mp.setattr(jlsd, "jax", GateOnTpu())
        if orb:
            from stvo_pl_tpu.ops import orb as jorb
            mp.setattr(jorb, "jax", GateOnTpu())
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


def port_vo_frames(n_frames: int, cfg_kwargs: dict, seed: int = 0,
                   img_noise: float = 0.0, n_lines: int = 24):
    """The port's VO on the CPU over the rendered sequence: per frame
    (Tfw [4,4] float32, is_kf, PointSet, LineSet) with numpy leaves
    (descriptors as uint32), and the true poses."""
    from stvo_pl_tpu_torch import convert
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.ops import camera as tcam

    L, R, poses = rendered_sequence(n_frames, seed=seed, n_lines=n_lines)
    if img_noise > 0:
        rng = np.random.default_rng(seed + 1)
        L = (L + img_noise * rng.normal(size=L.shape)).astype(np.float32)
        R = (R + img_noise * rng.normal(size=R.shape)).astype(np.float32)
    cfg = VOConfig(**cfg_kwargs)
    cam = tcam.StereoCamera(**CAM_ARGS)
    state = frontend.init_state(cfg, device="cpu")
    frames = []
    for i in range(n_frames):
        state, t = frontend.vo_step(state, torch.from_numpy(L[i]),
                                    torch.from_numpy(R[i]), cam, cfg)
        frames.append((t.Tfw.numpy().copy(), bool(t.is_kf),
                       convert._tuple_to_numpy(state.prev_points),
                       convert._tuple_to_numpy(state.prev_lines)))
    return frames, poses


def jax_tree(tree):
    """A NamedTuple (nested, None leaves allowed) of numpy arrays -> the
    same structure of jax arrays."""
    import jax.numpy as jnp
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return type(tree)(*[jax_tree(x) for x in tree])
    return jnp.asarray(tree)


_A = torch.ops.aten
_HOST_OPS = {_A._local_scalar_dense.default, _A.is_nonzero.default,
             _A.equal.default, _A.nonzero.default, _A.masked_select.default,
             _A.bincount.default, _A._unique2.default, _A.unique_dim.default,
             _A.unique_consecutive.default, _A.repeat_interleave.Tensor,
             _A.lift_fresh.default}
_INDEX_OPS = {_A.index.Tensor, _A.index_put.default, _A.index_put_.default,
              _A._index_put_impl_.default}


class HostAudit(TorchDispatchMode):
    """Records each operation that a CUDA graph capture would refuse or
    that would wait for the device: a tensor made from host data
    (`lift_fresh`), a tensor read on the host, output shapes that depend
    on the data; with where the port called it."""

    def __init__(self):
        super().__init__()
        self.found = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        bad = func in _HOST_OPS or (func in _INDEX_OPS and any(
            i is not None and i.dtype == torch.bool for i in args[1]))
        if bad:
            frames = [f for f in traceback.extract_stack()
                      if "stvo_pl_tpu_torch" in f.filename]
            at = f"{frames[-1].filename}:{frames[-1].lineno}" if frames \
                else "?"
            self.found.append(f"{func} at {at}")
        return func(*args, **(kwargs or {}))
