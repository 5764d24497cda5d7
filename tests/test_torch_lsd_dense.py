"""The dense single-octave line path of the port (the one-direction run
kernel's plain version, the per-direction candidate generator,
`detect_lines_scaled`, `_lbd_two_bucket`) against the JAX package on
identical numpy inputs.

`run_pack_plain` (the twin of the second entry of csrc/lsd_run_pack.cu)
must be bit-equal to the Pallas kernel `_run_pack_pallas` in interpret
mode on any 0/1 mask, and to the JAX package's unpadded XLA twin
`_run_pack_xla` on masks whose last row and column are zero (with set bits
there, runs continue into the kernel's zero padding, which the XLA twin
does not have).  `_candidates_from_packed` is exact on its integers and
1e-5 on the float lengths (one float32 product).  On the CPU the JAX
package takes the per-direction generator itself, so
`detect_line_segments(per_direction=True)` and `detect_lines_scaled` are
held to it unpatched: equal valid masks, endpoints to 1e-3 px (XLA
contracts the blur's multiply-adds, which moves the field by an ulp), and
the two-bucket LBD to equal bits on detected lines, which lie on edges."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from stvo_pl_tpu.config import VOConfig as JCfg
from stvo_pl_tpu.models import frame as jframe
from stvo_pl_tpu.ops import image as jimage
from stvo_pl_tpu.ops import lsd as jlsd
from stvo_pl_tpu.ops import lsd_kernel as jlk
from stvo_pl_tpu_torch.config import VOConfig as TCfg
from stvo_pl_tpu_torch.models import frame as tframe
from stvo_pl_tpu_torch.ops import image as timage
from stvo_pl_tpu_torch.ops import lsd as tlsd
from stvo_pl_tpu_torch.ops import lsd_kernel as tlk

from test_torch_helpers import MIN_LEN, SMALL, rendered_sequence

torch.set_num_threads(1)
tt = torch.from_numpy


@pytest.fixture
def pallas_interpret(monkeypatch):
    from jax.experimental import pallas as pl
    monkeypatch.setattr(pl, "pallas_call",
                        functools.partial(pl.pallas_call, interpret=True))


def _random_mask(rng, shape, density, border):
    """Uniform random 0/1 masks (thickening and gap closing join them into
    runs); `border` sets bits in the last row and column."""
    mask = rng.random(shape) < density
    if border:
        mask[:, -1, ::3] = True
        mask[:, ::2, -1] = True
    else:
        mask[:, -1, :] = False
        mask[:, :, -1] = False
    return mask


RUN_PACK_CASES = [
    # shape, (dx, dy), density, border, dtype
    ((2, 70, 150), (1, 0), 0.3, True, np.bool_),     # W % 128 != 0
    ((2, 70, 150), (-4, 1), 0.4, True, np.int8),     # dx < 0, |dx| = 4
    ((1, 64, 128), (1, 4), 0.4, True, np.bool_),     # no padding, |dy| = 4
    ((2, 97, 130), (-3, 4), 0.5, True, np.int32),    # H % 8 != 0
    ((2, 97, 130), (0, 1), 0.2, False, np.bool_),
    ((1, 45, 260), (4, 3), 0.5, True, np.int8),
    ((1, 45, 260), (-1, 1), 0.3, False, np.bool_),
]


@pytest.mark.parametrize("shape,step,density,border,dtype", RUN_PACK_CASES)
def test_run_pack_plain_bit_equal_to_pallas(pallas_interpret, rng, shape,
                                            step, density, border, dtype):
    mask = _random_mask(rng, shape, density, border).astype(dtype)
    dx, dy = step
    ref = np.asarray(jlk._run_pack_pallas(jnp.asarray(mask), dx, dy, 8))
    out = tlk.run_pack(tt(mask), dx, dy).numpy()
    Hp, Wp = tlk.run_pack_shape(*shape[1:])
    assert out.shape == ref.shape == (shape[0], Hp, Wp)
    assert out.dtype == np.int32
    np.testing.assert_array_equal(out, ref)
    assert (ref > 0).sum() > 20, "the masks must hold runs"
    assert (ref // 64).max() >= 3, "and runs of several hops"
    if border and (Wp > shape[2] or Hp > shape[1]):
        # the padded-domain case is really exercised: run starts in the pad
        assert (ref[:, :, shape[2]:] > 0).any() or (
            ref[:, shape[1]:, :] > 0).any()


@pytest.mark.parametrize("step", [(1, 0), (4, 1), (-1, 4), (-4, 3), (1, 1),
                                  (0, 1)])
def test_run_pack_plain_equals_xla_twin_on_border_zeroed_masks(rng, step):
    """The JAX package's CPU generator pads W to a multiple of 8 only: the
    kernel's map cropped to that width is the same map, and nothing lies
    beyond it."""
    shape = (2, 70, 150)
    mask = _random_mask(rng, shape, 0.35, border=False)
    out = tlk.run_pack(tt(mask), *step).numpy()
    for i in range(shape[0]):
        ref = np.asarray(jlsd._run_pack_xla(jnp.asarray(mask[i]), step))
        h, w = ref.shape
        assert (h, w) == (72, 152)
        np.testing.assert_array_equal(out[i, :h, :w], ref)
        assert not out[i, h:].any() and not out[i, :, w:].any()
        assert (ref > 0).sum() > 20


def test_run_pack_max_doublings_and_bad_input(rng):
    mask = tt(_random_mask(rng, (1, 40, 90), 0.6, True))
    full = tlk.run_pack(mask, 1, 1)
    for md in (0, 2):
        out = tlk.run_pack(mask, 1, 1, md)
        # the same run starts, lengths saturating at 2^md
        assert torch.equal(out > 0, full > 0)
        assert torch.equal(out // 64, torch.clamp(full // 64, max=1 << md))
    with pytest.raises(ValueError, match="mask"):
        tlk.run_pack(mask.float(), 1, 0)
    with pytest.raises(ValueError, match="steps"):
        tlk.run_pack(mask, 5, 0)
    with pytest.raises(ValueError, match="steps"):
        tlk.run_pack(mask, 0, 0)
    assert tlk.run_pack_shape(370, 1226) == (376, 1280)


@pytest.mark.parametrize("n_dirs,k_per_dir,min_len", [(8, 16, 4.5),
                                                      (12, 64, 3.0),
                                                      (4, 500, 6.0)])
def test_candidates_from_packed(rng, n_dirs, k_per_dir, min_len):
    """The same packed maps in (the kernel pads W to 128, the JAX CPU
    generator to 8: other tile indices, the same row-major tile order, so
    the stable top-k breaks ties alike): positions, validity and order
    equal, lengths to 1e-5.  k_per_dir = 500 exceeds the 9 x 19 tiles of
    the JAX map: both clamp k to their pool, and the port's extra tiles
    (all zero) only add invalid entries."""
    steps = tlsd.direction_steps(n_dirs)
    shape = (2, 70, 150)
    masks = [_random_mask(rng, shape, 0.3, border=False) for _ in steps]
    packed = [tlk.run_pack(tt(m), dx, dy) for m, (dx, dy) in zip(masks, steps)]
    pooled = torch.stack([tlsd.pool_tiles(p) for p in packed], dim=1)
    assert pooled.shape == (2, n_dirs, 9, 32)
    out = tlsd._candidates_from_packed(pooled, steps, k_per_dir, min_len)
    k_t = min(k_per_dir, 9 * 32)
    assert out[0].shape == (2, n_dirs * k_t)
    assert int(out[6].sum()) > 10
    for i in range(2):
        for d, step in enumerate(steps):
            ref = jlsd._candidates_from_packed(
                jlsd._run_pack_xla(jnp.asarray(masks[d][i]), step), step,
                k_per_dir, jnp.float32(min_len))
            k_j = np.asarray(ref[0]).shape[0]
            assert k_j == min(k_per_dir, 9 * 19)
            mine = [a[i, d * k_t:(d + 1) * k_t].numpy() for a in out]
            n = min(k_j, k_t)
            np.testing.assert_array_equal(mine[6][:n], np.asarray(ref[6])[:n])
            assert not mine[6][n:].any()
            # entries that hold a run (valid or shorter than min_len):
            # everything equal; the zero tail's positions are tile indices
            # of empty tiles and differ with the padded width
            m = min(n, int((pooled[i, d] > 0).sum()))
            assert m > 5
            for a, b in zip(mine[:4], ref[:4]):
                np.testing.assert_array_equal(a[:m], np.asarray(b)[:m])
            for a, b in zip(mine[4:6], ref[4:6]):
                np.testing.assert_allclose(a[:n], np.asarray(b)[:n],
                                           atol=1e-5)


@pytest.fixture(scope="module")
def frame():
    L, R, _ = rendered_sequence(1)
    return np.stack([L[0], R[0]])


@pytest.mark.parametrize("kw", [
    dict(capacity=48, n_dirs=12, log_eps=0.0),
    dict(capacity=60, n_dirs=16, k_per_dir=8, k_total=100),
    dict(capacity=48, n_dirs=8, log_eps=0.0, refine_samples=8),
], ids=["nfa", "pruned", "lite_samples"])
def test_detect_line_segments_per_direction_against_jax(frame, kw):
    """The whole detector with the per-direction generator against the JAX
    package as it runs on the CPU (unpatched: its per-direction branch).
    `pruned` makes the union of the quotas (16 x 8) exceed k_total."""
    segs = tlsd.detect_line_segments(tt(frame), MIN_LEN, per_direction=True,
                                     **kw)
    for i, f in enumerate(frame):
        ref = jax.tree_util.tree_map(np.asarray, jlsd.detect_line_segments(
            jnp.asarray(f), jnp.float32(MIN_LEN), **kw))
        assert ref.valid.sum() > 10
        np.testing.assert_array_equal(segs.valid[i].numpy(), ref.valid)
        v = ref.valid
        for name in ("sp", "ep", "length", "resp"):
            np.testing.assert_allclose(getattr(segs, name)[i].numpy()[v],
                                       getattr(ref, name)[v], atol=1e-3)
        np.testing.assert_allclose(segs.angle[i].numpy()[v], ref.angle[v],
                                   atol=1e-4)


def test_generators_differ_but_agree_on_most_lines(frame):
    """The two generators are different functions (global pool against
    per-direction quotas); on this frame they still find mostly the same
    lines."""
    from test_torch_helpers import shared_fraction
    a = tlsd.detect_line_segments(tt(frame), MIN_LEN, capacity=48, n_dirs=12)
    b = tlsd.detect_line_segments(tt(frame), MIN_LEN, capacity=48, n_dirs=12,
                                  per_direction=True)
    for i in range(2):
        share = shared_fraction(a.sp[i].numpy(), a.ep[i].numpy(),
                                a.valid[i].numpy(), b.sp[i].numpy(),
                                b.ep[i].numpy(), b.valid[i].numpy(), tol=1.0)
        assert share >= 0.6, share


DENSE = {k: v for k, v in SMALL.items() if k != "lsd_n_dirs"}


@pytest.mark.parametrize("overrides,lite", [
    ({"lsd_scale": 1.0}, False),
    ({"lsd_scale": 1.2}, False),
    ({"lsd_scale": 1.0}, True),
    ({"lsd_scale": 0.8, "lsd_refine": 2, "lsd_log_eps": 0.5}, False),
], ids=["scale_1.0", "scale_1.2", "lite", "scale_0.8_log_eps"])
def test_detect_lines_scaled_against_jax(frame, overrides, lite):
    """`detect_lines_scaled` (resample with the composed blur, mll scaling,
    the NFA rule, the half-pixel-centre inverse map, `lite`) against the
    JAX package on the CPU.  Endpoints to 2e-3 px: the resample is a
    float32 matrix product summed in another order, ahead of the blur."""
    jcfg = JCfg(lsd_octaves=1, **DENSE, **overrides)
    tcfg = TCfg(lsd_octaves=1, **DENSE, **overrides)
    segs = tframe.detect_lines_scaled(tt(frame), MIN_LEN, tcfg, lite=lite,
                                      per_direction=True)
    assert segs.sp.shape == (2, tcfg.line_capacity, 2)
    for i, f in enumerate(frame):
        ref = jax.tree_util.tree_map(np.asarray, jframe.detect_lines_scaled(
            jnp.asarray(f), jnp.float32(MIN_LEN), jcfg, lite=lite))
        assert ref.valid.sum() >= 4
        np.testing.assert_array_equal(segs.valid[i].numpy(), ref.valid)
        v = ref.valid
        for name in ("sp", "ep", "length", "resp"):
            np.testing.assert_allclose(getattr(segs, name)[i].numpy()[v],
                                       getattr(ref, name)[v], atol=2e-3)
        assert (segs.sp[i].numpy()[v] <= [239.0, 179.0]).all()


@pytest.mark.parametrize("long_samples", [8, 16])
def test_lbd_two_bucket(frame, long_samples):
    """The same Sobel planes and detected segments in: the descriptor bits
    are equal (the lines lie on edges, where every band statistic is far
    from its neighbour's)."""
    jcfg = JCfg(lsd_octaves=1, lbd_long_samples=long_samples, **DENSE)
    tcfg = TCfg(lsd_octaves=1, lbd_long_samples=long_samples, **DENSE)
    segs = tframe.detect_lines_scaled(tt(frame), MIN_LEN, tcfg,
                                      per_direction=True)
    g = [jimage.sobel(jnp.asarray(f)) for f in frame]
    gx = np.stack([np.asarray(a[0]) for a in g])
    gy = np.stack([np.asarray(a[1]) for a in g])
    desc = tframe._lbd_two_bucket(tt(gx), tt(gy), segs, tcfg)
    assert desc.shape == (2, tcfg.line_capacity, 8)
    assert desc.dtype == torch.int32
    for i in range(2):
        jsegs = jlsd.LineSegments(*[jnp.asarray(t[i].numpy()) for t in segs])
        ref = np.asarray(jframe._lbd_two_bucket(
            jnp.asarray(gx[i]), jnp.asarray(gy[i]), jsegs, jcfg))
        v = segs.valid[i].numpy()
        assert v.sum() >= 8
        x = desc[i].numpy().view(np.uint32)[v] ^ ref[v]
        assert np.unpackbits(x.view(np.uint8)).sum() == 0
    # the port's Sobel is the JAX package's to float32 rounding
    tgx, tgy = timage.sobel(tt(frame))
    np.testing.assert_allclose(tgx.numpy(), gx, atol=1e-3)
    np.testing.assert_allclose(tgy.numpy(), gy, atol=1e-3)


def test_dense_stereo_front_end(frame):
    """`extract_stereo_features` with lsd_octaves=1: both eyes through one
    field batch equal the per-eye detector followed by the matcher, for
    either generator, and `lsd_right_lite` reaches the right eye only."""
    from stvo_pl_tpu_torch.ops import camera as tcam
    from test_torch_helpers import CAM_ARGS
    cam = tcam.StereoCamera(**CAM_ARGS)
    img_l, img_r = tt(frame[:1]), tt(frame[1:])
    th = torch.full((1,), 20.0)
    for per_direction in (False, True):
        for lite in (False, True):
            cfg = TCfg(lsd_octaves=1, lsd_right_lite=lite, **DENSE)
            feats = tframe.extract_stereo_features(
                img_l, img_r, th, MIN_LEN, cam, cfg,
                per_direction=per_direction)
            sl = tframe.detect_lines_scaled(img_l, MIN_LEN, cfg,
                                            per_direction=per_direction)
            sr = tframe.detect_lines_scaled(img_r, MIN_LEN, cfg, lite=lite,
                                            per_direction=per_direction)
            dl = tframe._lbd_two_bucket(*timage.sobel(img_l), sl, cfg)
            dr = tframe._lbd_two_bucket(*timage.sobel(img_r), sr, cfg)
            ref = tframe.match_stereo_lines(sl, dl, sr, dr, cam, cfg)
            for a, b in zip(feats.lines, ref):
                assert torch.equal(a, b)
            assert not feats.lines.level.any()
            assert int(sl.valid.sum()) >= 8
