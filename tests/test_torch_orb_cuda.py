"""ORB's descriptor kernel (`ops/orb.py orb_describe`,
`csrc/orb_describe.cu`) against the product path on the card.

Marked `gpu`: each test skips unless a CUDA device is present (decided
inside the test, so every worker collects the same tests).  Run on a
machine with a card with
`pytest --noconftest -m gpu tests/test_torch_orb_cuda.py` (the shared
conftest imports jax).

The kernel's descriptor words, cos and sin must equal the product path's
(`orient_describe_product`, the bf16 test-bank product on the card, called
explicitly) bit for bit: on the patch set of tests/orb_cases.py (every bin
boundary within 1e-5 rad on both sides, zero moments, saturated patches,
values off the integer grid), on many random patches, on the patches of a
rendered KITTI-sized and a EuRoC-sized pair at every pyramid level, with
K = 1, a K that is not a multiple of the keypoints a block, and patches
that do not start 16-byte aligned; and the launch counter rises by one a
call."""

import numpy as np
import pytest
import torch

from orb_cases import boundary_patches, random_patches

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(patches, patch_size=31):
    """The kernel's and the product path's outputs, equal bit for bit;
    returns the kernel's."""
    from stvo_pl_tpu_torch.ops import orb
    before = orb.orb_describe.launches
    k = orb.orb_describe(patches, patch_size)
    assert orb.orb_describe.launches == before + (patches.numel() > 0)
    p = orb.orient_describe_product(patches, patch_size)
    torch.cuda.synchronize()
    for name, a, b in zip(("desc", "cos", "sin"), k, p):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert torch.equal(a, b), f"{name}: {int((a != b).sum())} differ"
    return k


@pytest.mark.parametrize("patch_size", [31, 15])
def test_kernel_equals_product_on_boundary_patches(cuda, patch_size):
    from stvo_pl_tpu_torch.ops import orb
    x, bins = boundary_patches()
    desc, c, s = _same(torch.from_numpy(x).to(cuda), patch_size)
    got = orb._bin_index(c, s).cpu().numpy()
    np.testing.assert_array_equal(got[bins >= 0], bins[bins >= 0])
    assert set(got.tolist()) == set(range(orb.N_ORI_BINS))
    # and the kernel's plain twin on the card
    plain = orb.orient_describe_plain(torch.from_numpy(x).to(cuda),
                                      patch_size)
    assert all(torch.equal(a, b) for a, b in zip((desc, c, s), plain))


def test_kernel_equals_product_on_many_random_patches(cuda):
    """200,000 patches: near-boundary angles occur by chance too."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(random_patches(rng, 200_000)).to(cuda)
    _same(x)


@pytest.mark.parametrize("K", [1, 7, 9, 8 * 1000 + 3])
def test_kernel_ragged_and_unaligned(cuda, K):
    """K = 1, K not a multiple of the 8 keypoints a block, and the same
    patches starting 4 bytes past a 16-byte boundary (a view one patch
    in) and in leading dimensions."""
    rng = np.random.default_rng(K)
    x = torch.from_numpy(random_patches(rng, K + 1)).to(cuda)
    whole = _same(x[:K].contiguous())
    shifted = _same(x[1:])
    assert x[1:].data_ptr() % 16 != 0
    assert torch.equal(shifted[0][:K - 1], whole[0][1:])
    if K % 2 == 0 or K == 1:
        return
    lead = _same(x[:K - 1].reshape(2, (K - 1) // 2, 33, 33))
    assert lead[0].shape == (2, (K - 1) // 2, 8)
    assert torch.equal(lead[0].reshape(-1, 8), whole[0][:K - 1])


def test_launch_counter_and_empty(cuda):
    from stvo_pl_tpu_torch.ops import orb
    x = torch.from_numpy(random_patches(np.random.default_rng(1), 16)).to(
        cuda)
    before = orb.orb_describe.launches
    for i in range(3):
        orb.orient_describe(x)
        assert orb.orb_describe.launches == before + i + 1
    d, c, s = orb.orb_describe(x[:0])
    assert d.shape == (0, 8) and c.shape == (0,)
    assert orb.orb_describe.launches == before + 3


def _rendered_levels(cuda, width, height, fx, b, seed):
    """A rendered stereo pair, both eyes, through the VO's pyramid, FAST
    selection, blur and patch gather under VOConfig() (1,200 corners over
    4 levels): the patches of each level, [2, K_level, 33, 33]."""
    from stvo_pl_tpu_torch.config import VOConfig
    from stvo_pl_tpu_torch.models import frame as frame_mod
    from stvo_pl_tpu_torch.ops import camera, fast, orb
    from stvo_pl_tpu_torch.ops.image import gaussian_blur, pyramid_levels
    from stvo_pl_tpu_torch.utils import synthetic
    cfg = VOConfig()
    cam = camera.StereoCamera(fx=fx, fy=fx, cx=width / 2, cy=height / 2, b=b,
                              width=width, height=height)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    scene = synthetic.make_scene(gen, n_points=1400, n_lines=64,
                                 extent=(40.0, 15.0, 90.0), z_near=5.0)
    poses = synthetic.smooth_trajectory(1, speed=0.8, device=cuda)
    left, right = synthetic.render_sequence(scene, poses, cam)
    pair = torch.cat([left, right]).contiguous()
    th = torch.full((2,), float(cfg.orb_fast_th), device=cuda)
    budgets = frame_mod._per_level_budgets(cfg)
    out = []
    for lv, img in enumerate(pyramid_levels(pair, cfg.orb_nlevels,
                                            cfg.orb_scale_factor,
                                            blur_sigma=0.6)):
        uv, _, _ = fast.detect_keypoints(img.contiguous(), th, budgets[lv],
                                         edge=cfg.orb_edge_th, cell=4,
                                         score_type=cfg.orb_score)
        blur = gaussian_blur(img, 2.0, radius=3)
        out.append(orb.gather_patches(blur, uv))
    return out


@pytest.mark.parametrize("rig", ["kitti", "euroc"])
def test_kernel_equals_product_on_rendered_pairs(cuda, rig):
    args = dict(kitti=(1226, 370, 707.0912, 0.537),
                euroc=(752, 480, 458.1205, 0.1101))[rig]
    levels = _rendered_levels(cuda, *args, seed=11)
    assert len(levels) == 4
    for p in levels:
        _same(p)
