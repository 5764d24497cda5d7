"""The line half of the port's front end (models/frame.py) against the
JAX package.

Stereo line matching is fed the same segments and descriptors on both
sides: validity and the carried integers equal, disparities and 3-D
endpoints to 1e-4 relative (one division by a pixel difference).  The
multi-octave canvas detector is compared on a rendered 240x180 stereo
pair with the JAX package forced onto its kernel branch: at least 90% of
the valid segments must be shared within 0.5 px.  On this frame they are
in fact all shared, to 1e-3 px with equal descriptors; the looser gate is
the stated one because the blur's multiply-adds are contracted by XLA and
not by the port, which may flip a single bitmask pixel at the angle or
magnitude threshold and with it a candidate."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frame as jframe
from stvo_pl_tpu.ops import lsd as jlsd
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frame as tframe
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.ops import lsd as tlsd

from test_torch_helpers import (CAM_ARGS, JCAM, MIN_LEN, SMALL,
                                jax_kernel_branch, rendered_sequence,
                                shared_fraction)

torch.set_num_threads(1)

TCAM = tcam.StereoCamera(**CAM_ARGS)
tt = torch.from_numpy


def _stereo_segments(rng, K):
    """Left segments and right partners (shifted by a per-endpoint
    disparity, shuffled, some dropped), with descriptors a few bits
    apart."""
    W, H = CAM_ARGS["width"], CAM_ARGS["height"]
    c = rng.random((K, 2)) * np.array([W - 60, H - 40]) + np.array([50, 20])
    th = rng.random(K) * np.pi
    half = (4 + rng.random(K) * 20)[:, None] * np.stack(
        [np.cos(th), np.sin(th)], axis=1)
    sp_l, ep_l = c - half, c + half
    disp = 3 + rng.random((K, 1)) * 25
    skew = 1 + (rng.random((K, 1)) - 0.5) * 0.5       # some fail the ratio
    sp_r = sp_l - np.concatenate([disp, rng.normal(0, 0.2, (K, 1))], axis=1)
    ep_r = ep_l - np.concatenate([disp * skew, rng.normal(0, 0.2, (K, 1))],
                                 axis=1)
    desc_l = rng.integers(0, 2 ** 32, (K, 8), dtype=np.uint32)
    flips = np.zeros((K, 8), np.uint32)
    for _ in range(12):
        flips[np.arange(K), rng.integers(0, 8, K)] ^= np.uint32(1) << \
            rng.integers(0, 32, K).astype(np.uint32)
    perm = rng.permutation(K)
    valid_l = rng.random(K) < 0.9
    valid_r = rng.random(K) < 0.85

    def segs(mod, sp, ep, valid, conv):
        d = ep - sp
        f32 = lambda a: conv(np.asarray(a, np.float32))
        return mod.LineSegments(
            sp=f32(sp), ep=f32(ep), angle=f32(np.arctan2(d[:, 1], d[:, 0])),
            length=f32(np.linalg.norm(d, axis=1)),
            resp=f32(np.linalg.norm(d, axis=1)), valid=conv(valid))

    left = (sp_l, ep_l, valid_l)
    right = (sp_r[perm], ep_r[perm], valid_r[perm])
    desc_r = (desc_l ^ flips)[perm]
    level = rng.integers(0, 3, K).astype(np.int32)
    return left, right, desc_l, desc_r, level, segs


@pytest.mark.parametrize("lsd_scale", [1.0, 1.2])
def test_match_stereo_lines(rng, lsd_scale):
    K = 64
    sets = [_stereo_segments(rng, K) for _ in range(2)]
    segs = sets[0][5]
    jcfg, tcfg = JCfg(lsd_scale=lsd_scale), TCfg(lsd_scale=lsd_scale)
    stack = lambda k: np.stack([s[k] for s in sets])
    t_l = tlsd.LineSegments(*[torch.stack([segs(tlsd, *s[0], tt)[f]
                                           for s in sets]) for f in range(6)])
    t_r = tlsd.LineSegments(*[torch.stack([segs(tlsd, *s[1], tt)[f]
                                           for s in sets]) for f in range(6)])
    out = tframe.match_stereo_lines(
        t_l, tt(stack(2).view(np.int32)), t_r, tt(stack(3).view(np.int32)),
        TCAM, tcfg, level_l=tt(stack(4)))
    for i, s in enumerate(sets):
        ref = jframe.match_stereo_lines(
            segs(jlsd, *s[0], jnp.asarray), jnp.asarray(s[2]),
            segs(jlsd, *s[1], jnp.asarray), jnp.asarray(s[3]), JCAM, jcfg,
            level_l=jnp.asarray(s[4]))
        v = np.asarray(ref.valid)
        assert 10 < v.sum() < K - 5
        np.testing.assert_array_equal(out.valid[i].numpy(), v)
        np.testing.assert_array_equal(out.level[i].numpy(),
                                      np.asarray(ref.level))
        np.testing.assert_array_equal(out.desc[i].numpy().view(np.uint32),
                                      np.asarray(ref.desc))
        for f in ("spl", "epl", "angle"):
            np.testing.assert_array_equal(getattr(out, f)[i].numpy(),
                                          np.asarray(getattr(ref, f)))
        for f in ("sdisp", "edisp", "sP", "eP", "le", "sigma2"):
            np.testing.assert_allclose(getattr(out, f)[i].numpy(),
                                       np.asarray(getattr(ref, f)),
                                       rtol=1e-4, atol=1e-4, err_msg=f)


def test_line_helpers(rng):
    """Layout, coefficients, overlap and length buckets: same numbers."""
    shapes = [(180, 240), (90, 120), (45, 60)]
    assert tframe._octave_layout(shapes) == jframe._octave_layout(shapes)
    assert tframe._octave_layout(shapes[:1]) == jframe._octave_layout(
        shapes[:1])
    sp = (rng.random((2, 30, 2)) * 200).astype(np.float32)
    ep = (rng.random((2, 30, 2)) * 200).astype(np.float32)
    np.testing.assert_allclose(
        tframe._line_coeffs(tt(sp), tt(ep)).numpy(),
        np.asarray(jframe._line_coeffs(jnp.asarray(sp), jnp.asarray(ep))),
        rtol=1e-5, atol=1e-5)
    ys = [(rng.random((2, 30)) * 100).astype(np.float32) for _ in range(4)]
    ys[2][:, :5] = ys[0][:, :5]                 # exact containment edges
    ys[1][:, 5:8] = ys[0][:, 5:8] + 0.05        # near-horizontal left lines
    np.testing.assert_allclose(
        tframe._overlap_stereo(*[tt(y) for y in ys], 0.1).numpy(),
        np.asarray(jframe._overlap_stereo(*[jnp.asarray(y) for y in ys],
                                          0.1)), atol=1e-6)
    length = np.round(rng.random((2, 31)) * 20).astype(np.float32)  # ties
    valid = rng.random((2, 31)) < 0.8
    li, si = tframe._length_buckets(tt(length), tt(valid), 31)
    for i in range(2):
        lj, sj = jframe._length_buckets(jnp.asarray(length[i]),
                                        jnp.asarray(valid[i]), 31)
        np.testing.assert_array_equal(li[i].numpy(), np.asarray(lj))
        np.testing.assert_array_equal(si[i].numpy(), np.asarray(sj))


@pytest.fixture(scope="module")
def frame():
    L, R, _ = rendered_sequence(1)
    return np.stack([L[0], R[0]])


@pytest.mark.parametrize("overrides,pool", [
    ({}, None),                                   # left eye: 1.5x pool
    ({}, 1.0),                                    # right eye
    ({"lbd_long_samples": 16, "lsd_octaves": 2}, None),
], ids=["default", "right_pool", "two_bucket_2_octaves"])
def test_detect_lines_octaves_against_kernel_branch(frame, overrides, pool):
    jcfg, tcfg = JCfg(**SMALL, **overrides), TCfg(**SMALL, **overrides)
    segs, octv, desc = tframe.detect_lines_octaves(tt(frame), MIN_LEN, tcfg,
                                                   pool=pool)
    K = tcfg.line_capacity
    assert segs.sp.shape == (2, K, 2) and desc.shape == (2, K, 8)
    assert octv.dtype == torch.int32 and desc.dtype == torch.int32
    with jax_kernel_branch():
        detect = jax.jit(jframe.detect_lines_octaves,
                         static_argnames=("cfg", "pool"))
        refs = [jax.tree_util.tree_map(np.asarray, detect(
            jnp.asarray(f), jnp.float32(MIN_LEN), cfg=jcfg, pool=pool))
            for f in frame]
    for i, (rs, ro, rd) in enumerate(refs):
        assert rs.valid.sum() >= 8
        share = shared_fraction(segs.sp[i].numpy(), segs.ep[i].numpy(),
                                segs.valid[i].numpy(), rs.sp, rs.ep, rs.valid)
        assert share >= 0.9, (i, share)
        # where the same line sits in the same slot, everything about it
        # agrees
        same = (segs.valid[i].numpy() & rs.valid
                & (np.abs(segs.sp[i].numpy() - rs.sp).max(-1) < 0.5)
                & (np.abs(segs.ep[i].numpy() - rs.ep).max(-1) < 0.5))
        assert same.sum() >= 0.9 * rs.valid.sum()
        np.testing.assert_array_equal(octv[i].numpy()[same], ro[same])
        for f in ("sp", "ep", "length", "resp"):
            np.testing.assert_allclose(getattr(segs, f)[i].numpy()[same],
                                       getattr(rs, f)[same], atol=1e-3)
        x = desc[i].numpy().view(np.uint32)[same] ^ rd[same]
        flipped = np.unpackbits(x.view(np.uint8)).sum()
        assert flipped <= 0.01 * 256 * same.sum(), flipped


def test_extract_stereo_features_with_lines(frame):
    """The whole front end on one stereo pair: lanes = 1, both eyes through
    one canvas batch; points as in the points-only slice, and the line set
    equal to the per-eye detector's followed by the matcher."""
    cfg = TCfg(**SMALL)
    img_l, img_r = tt(frame[:1]), tt(frame[1:])
    th = torch.full((1,), float(cfg.orb_fast_th))
    feats = tframe.extract_stereo_features(img_l, img_r, th, MIN_LEN, TCAM,
                                           cfg)
    assert feats.lines.spl.shape == (1, cfg.line_capacity, 2)
    sl, ol, dl = tframe.detect_lines_octaves(img_l, MIN_LEN, cfg)
    sr, _, dr = tframe.detect_lines_octaves(img_r, MIN_LEN, cfg,
                                            pool=cfg.lsd_oct_pool_right)
    ref = tframe.match_stereo_lines(sl, dl, sr, dr, TCAM, cfg, level_l=ol)
    for a, b in zip(feats.lines, ref):
        assert torch.equal(a, b)
    pts = tframe.extract_stereo_features(
        img_l, img_r, th, MIN_LEN, TCAM, cfg.replace(has_lines=False))
    for a, b in zip(feats.points, pts.points):
        assert torch.equal(a, b)
    assert not pts.lines.valid.any()


@pytest.mark.parametrize("overrides,match", [
    ({"use_edlines": True}, "use_edlines"),
    ({"lsd_octaves": 1}, "lsd_octaves=1"),
])
def test_unported_line_detectors_raise(frame, overrides, match):
    """The EDLine detector raises, naming its roadmap item; the dense
    single-octave detector, which used to, runs: level 0 for every line."""
    cfg = TCfg(**SMALL, **overrides)
    th = torch.full((1,), 20.0)
    args = (tt(frame[:1]), tt(frame[1:]), th, MIN_LEN, TCAM, cfg)
    if cfg.use_edlines:
        with pytest.raises(NotImplementedError, match=match):
            tframe.extract_stereo_features(*args)
        with pytest.raises(NotImplementedError, match="ROADMAP item 12"):
            tframe.extract_stereo_features(*args)
    else:
        lines = tframe.extract_stereo_features(*args).lines
        assert lines.spl.shape == (1, cfg.line_capacity, 2)
        assert lines.desc.dtype == torch.int32 and not lines.level.any()
        assert bool(torch.isfinite(lines.sP).all())
