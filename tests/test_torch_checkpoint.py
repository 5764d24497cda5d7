"""Checkpoint / resume of the port (stvo_pl_tpu_torch/utils/checkpoint.py)
on the CPU, and against the JAX package's orbax checkpoints.

The port's VO runs on the 240x180 scene and configuration of
tests/test_checkpoint.py.  A run resumed from a checkpoint after 3 frames
must give the straight run's poses bit for bit (torch.equal): the state
round trip is exact, so nothing else may differ.  A state written by the
JAX package's `save_state` and read by its `load_state` must come back,
through `convert`, equal to the port's own round trip of the same state.
"""

import numpy as np
import jax
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frontend as jfrontend
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu.utils import checkpoint as jckpt
from stvo_pl_tpu.utils import synthetic as jsyn
from stvo_pl_tpu_torch import convert
from stvo_pl_tpu_torch.config import VOConfig
from stvo_pl_tpu_torch.models import frontend
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.parallel import batched
from stvo_pl_tpu_torch.utils import checkpoint

torch.set_num_threads(1)

CAM_ARGS = dict(fx=160.0, fy=160.0, cx=120.0, cy=90.0, b=0.3, width=240,
                height=180)
SMALL = dict(orb_nfeatures=200, orb_nlevels=2, lsd_nfeatures=24,
             lsd_n_dirs=8, min_features=8)
CFG = VOConfig(**SMALL)
CAM = tcam.StereoCamera(**CAM_ARGS)
N_FRAMES, SAVE_AT = 6, 3


def leaves_equal(a, b) -> bool:
    fa, fb = checkpoint.flatten(a), checkpoint.flatten(b)
    return fa.keys() == fb.keys() and all(
        fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device
        and torch.equal(fa[k], fb[k]) for k in fa)


@pytest.fixture(scope="module")
def straight():
    """The sequence, the straight run's poses and its state after SAVE_AT
    frames."""
    scene = jsyn.make_scene(jax.random.PRNGKey(0), n_points=220,
                            n_lines=16, extent=(14.0, 8.0, 40.0), z_near=3.0)
    poses = jsyn.smooth_trajectory(N_FRAMES, speed=0.25)
    L, R = jsyn.render_sequence(scene, poses, jcam.StereoCamera(**CAM_ARGS))
    L = torch.from_numpy(np.array(L))
    R = torch.from_numpy(np.array(R))
    st = frontend.init_state(CFG, device="cpu")
    out, saved = [], None
    for i in range(N_FRAMES):
        if i == SAVE_AT:
            saved = st
        st, t = frontend.vo_step(st, L[i], R[i], CAM, CFG)
        out.append(t.Tfw)
    return L, R, torch.stack(out), saved


def test_resume_is_bit_identical(straight, tmp_path):
    L, R, ref, saved = straight
    assert bool(saved.initialized) and bool(saved.prev_points.valid.any())
    checkpoint.save_state(str(tmp_path / "ck"), saved, SAVE_AT,
                          {"note": "t"})
    st, idx, extra = checkpoint.load_state(
        str(tmp_path / "ck"), frontend.init_state(CFG, device="cpu"))
    assert idx == SAVE_AT and extra == {"note": "t"}
    assert leaves_equal(st, saved)
    out = []
    for i in range(SAVE_AT, N_FRAMES):
        st, t = frontend.vo_step(st, L[i], R[i], CAM, CFG)
        out.append(t.Tfw)
    assert torch.equal(torch.stack(out), ref[SAVE_AT:])


def random_state(gen: torch.Generator, template):
    """`template` with every leaf replaced by seeded values of its dtype:
    random bits for int32 (descriptor words included), coin flips for
    bool, normals for float32."""
    def fill(x):
        if x.dtype == torch.bool:
            return torch.rand(x.shape, generator=gen) < 0.5
        if x.dtype == torch.int32:
            return torch.randint(-2 ** 31, 2 ** 31, x.shape, generator=gen,
                                 dtype=torch.int64).to(torch.int32)
        return torch.randn(x.shape, generator=gen, dtype=x.dtype)
    flat = {k: fill(v) for k, v in checkpoint.flatten(template).items()}
    return checkpoint._fill(template, flat, "")


def test_batched_round_trip_leaf_by_leaf(tmp_path):
    template = batched.init_batched_state(CFG, 2, device="cpu")
    st = random_state(torch.Generator().manual_seed(5), template)
    dtypes = {v.dtype for v in checkpoint.flatten(st).values()}
    assert dtypes == {torch.float32, torch.int32, torch.bool}
    assert st.prev_points.desc.shape == (2, CFG.point_capacity, 8)
    checkpoint.save_state(str(tmp_path / "ck"), st, 17)
    got, idx, extra = checkpoint.load_state(str(tmp_path / "ck"), template)
    assert idx == 17 and extra == {}
    assert type(got) is type(st) and type(got.prev_lines) is type(
        st.prev_lines)
    assert leaves_equal(got, st)
    # any tree of tuples, lists and dicts, with None leaves
    tree = {"a": [torch.arange(3), None], "b": (torch.ones(2, 2),)}
    checkpoint.save_state(str(tmp_path / "tree"), tree, 0)
    back, _, _ = checkpoint.load_state(str(tmp_path / "tree"), tree)
    assert back["a"][1] is None and leaves_equal(back, tree)


def test_jax_written_checkpoint_loads_equal(straight, tmp_path):
    saved = straight[3]
    jckpt.save_state(str(tmp_path / "jax"), convert.state_to_numpy(saved),
                     SAVE_AT)
    jstate, idx, _ = jckpt.load_state(str(tmp_path / "jax"),
                                      jfrontend.init_state(JCfg(**SMALL)))
    assert idx == SAVE_AT
    from_jax = convert.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jstate), device="cpu")
    checkpoint.save_state(str(tmp_path / "port"), saved, SAVE_AT)
    own, _, _ = checkpoint.load_state(
        str(tmp_path / "port"), frontend.init_state(CFG, device="cpu"))
    assert leaves_equal(from_jax, own) and leaves_equal(own, saved)


def test_mismatched_template_raises(tmp_path):
    st = frontend.init_state(CFG, device="cpu")
    checkpoint.save_state(str(tmp_path / "ck"), st, 0)
    other = frontend.init_state(VOConfig(**{**SMALL, "orb_nfeatures": 100}),
                                device="cpu")
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_state(str(tmp_path / "ck"), other)
    with pytest.raises(ValueError, match="not in the template"):
        checkpoint.load_state(str(tmp_path / "ck"),
                              st._replace(N_prevKF_currF=None))
    checkpoint.save_state(str(tmp_path / "small"), {"Tfw": st.Tfw}, 0)
    with pytest.raises(KeyError, match="prev_points"):
        checkpoint.load_state(str(tmp_path / "small"), st)
    with pytest.raises(TypeError, match="not a tensor"):
        checkpoint.save_state(str(tmp_path / "bad"), {"x": np.zeros(2)}, 0)
