"""The CUDA kernels against their plain PyTorch versions on the card.

Marked `gpu`: each test skips unless a CUDA device is present (decided
inside the test, so every worker collects the same tests).  Run on a
machine with a card with
`pytest --noconftest -m gpu tests/test_torch_kernels_cuda.py` (the shared
conftest imports jax);
`python3 chip_smoke.py` makes the same checks at the main path's shapes."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(2, 97, 150), (3, 80, 256),
                                   # the main path's four pyramid levels
                                   (16, 370, 1226), (16, 308, 1022),
                                   (16, 257, 851), (16, 214, 709)])
def test_fast_pack_kernel_equals_plain(cuda, shape):
    from stvo_pl_tpu_torch.ops import fast_kernel
    g = torch.Generator(device=cuda).manual_seed(0)
    img = torch.rand(shape, generator=g, device=cuda) * 255
    before = fast_kernel.fast_pack.launches
    k = fast_kernel.fast_pack(img, 19)
    p = fast_kernel.fast_pack_plain(img, 19)
    torch.cuda.synchronize()
    assert fast_kernel.fast_pack.launches == before + 1
    assert torch.equal(k, p)
    assert int((k > 0).sum()) > 0


@pytest.mark.parametrize("kind", ["constant", "dots"])
def test_fast_pack_kernel_design_cases(cuda, kind):
    """No response anywhere, and bright dots 4 px apart on a dark field
    (every dot inside the border is a survivor)."""
    from stvo_pl_tpu_torch.ops import fast_kernel
    img = torch.full((4, 370, 1226), 10.0 if kind == "dots" else 77.0,
                     device=cuda)
    if kind == "dots":
        img[:, 2::4, 3::4] = 200.0
    k = fast_kernel.fast_pack(img, 19)
    p = fast_kernel.fast_pack_plain(img, 19)
    torch.cuda.synchronize()
    assert torch.equal(k, p)
    n = int((k > 0).sum())
    assert n == 0 if kind == "constant" else n >= 4 * 82 * 296


@pytest.mark.parametrize("patch,dtype", [(33, torch.float32),
                                         ((1, 64), torch.int32),
                                         ((5, 7), torch.float32)])
def test_extract_patches_kernel_equals_plain(cuda, patch, dtype):
    from stvo_pl_tpu_torch.ops import patches
    g = torch.Generator(device=cuda).manual_seed(1)
    img = torch.rand((4, 120, 300), generator=g, device=cuda) * 255
    if dtype == torch.int32:
        img = img.view(torch.int32)
    y0 = torch.randint(-4, 110, (4, 77), generator=g, device=cuda,
                       dtype=torch.int32)
    x0 = torch.randint(-4, 290, (4, 77), generator=g, device=cuda,
                       dtype=torch.int32)
    k = patches.extract_patches(img, y0, x0, patch)
    p = patches.extract_patches_plain(img, y0, x0, patch)
    torch.cuda.synchronize()
    assert k.dtype == img.dtype and torch.equal(k, p)


@pytest.mark.parametrize("N,H,W,K,patch,dtype,where", [
    (1, 50, 80, 1, 33, torch.float32, "edge"),        # K = 1
    (3, 90, 140, 37, 33, torch.float32, "edge"),      # N K PY PX % 4 = 3
    (5, 40, 61, 13, (5, 7), torch.float32, "edge"),
    (3, 90, 140, 29, 33, torch.float32, "outside"),
    (2, 40, 200, 45, (1, 64), torch.uint32, "edge"),  # the row mode
    (2, 40, 200, 1031, (1, 64), torch.uint32, "outside"),
    (16, 370, 1226, 386, 33, torch.float32, "edge"),  # level 0 of the step
])
def test_extract_patches_kernel_edge_cases(cuda, N, H, W, K, patch, dtype,
                                           where):
    """K = 1 and K a multiple of no block size, outputs whose word count
    is not a multiple of 4 (the partial last 16-byte group), corners at
    x0 = W - PX and y0 = H - PY or outside the image, the u32 row mode."""
    from stvo_pl_tpu_torch.ops import patches
    PY, PX = (patch, patch) if isinstance(patch, int) else patch
    g = torch.Generator(device=cuda).manual_seed(5)
    img = (torch.rand((N, H, W), generator=g, device=cuda) - 0.3) * 255
    if dtype == torch.uint32:
        img = img.view(torch.uint32)
    if where == "edge":
        y0 = torch.randint(0, H - PY + 1, (N, K), generator=g, device=cuda,
                           dtype=torch.int32)
        x0 = torch.randint(0, W - PX + 1, (N, K), generator=g, device=cuda,
                           dtype=torch.int32)
        y0[:, 0], x0[:, 0] = H - PY, W - PX
    else:
        y0 = torch.randint(-PY - 2, H + 2, (N, K), generator=g, device=cuda,
                           dtype=torch.int32)
        x0 = torch.randint(-PX - 2, W + 2, (N, K), generator=g, device=cuda,
                           dtype=torch.int32)
    before = patches.extract_patches.launches
    k = patches.extract_patches(img, y0, x0, patch)
    p = patches.extract_patches_plain(img, y0, x0, patch)
    torch.cuda.synchronize()
    assert patches.extract_patches.launches == before + 1
    assert k.dtype == img.dtype and k.shape == (N, K, PY, PX)
    assert torch.equal(k.view(torch.int32), p.view(torch.int32))


@pytest.mark.parametrize("shape,n_dirs,density,border", [
    ((2, 70, 150), 8, 0.3, True),       # H % 64 != 0, set bits at the border
    ((3, 64, 128), 16, 0.1, False),     # no padding at all
    ((2, 97, 130), 12, 0.5, True),
    ((16, 571, 1226), 8, 0.02, True),   # the main path's canvas
])
def test_run_pack_multi_kernel_equals_plain(cuda, shape, n_dirs, density,
                                            border):
    """Uniform random bitmasks; `border` keeps the set bits of the last
    row and column, from which runs continue into the padded domain."""
    from stvo_pl_tpu_torch.ops import lsd, lsd_kernel
    g = torch.Generator(device=cuda).manual_seed(2)
    steps = lsd.direction_steps(n_dirs)
    bits = torch.zeros(shape, dtype=torch.int32, device=cuda)
    for d in range(n_dirs):
        on = torch.rand(shape, generator=g, device=cuda) < density
        bits |= on.to(torch.int32) << d
    if not border:
        bits[:, -1, :] = 0
        bits[:, :, -1] = 0
    before = lsd_kernel.run_pack_multi.launches
    k = lsd_kernel.run_pack_multi(bits, steps)
    p = lsd_kernel.run_pack_multi_plain(bits, steps)
    torch.cuda.synchronize()
    assert lsd_kernel.run_pack_multi.launches == before + 1
    assert k.shape == (shape[0],) + lsd_kernel.packed_shape(*shape[1:],
                                                            n_dirs)
    assert torch.equal(k, p), int((k != p).sum())
    assert int((k > 0).sum()) > 0
    for md in (0, 3):
        assert torch.equal(lsd_kernel.run_pack_multi(bits, steps, md),
                           lsd_kernel.run_pack_multi_plain(bits, steps, md))


def _long_run_bits(shape, steps, seed):
    """2% noise per direction plus, per image and direction, straight
    chains 40-300 hops long (the first 300) inside the image; the last
    row and column set at every third pixel."""
    rng = np.random.default_rng(seed)
    n, H, W = shape
    bits = np.zeros(shape, np.int32)
    for d, (dx, dy) in enumerate(steps):
        bits |= (rng.random(shape) < 0.02).astype(np.int32) << d
        for i in range(n):
            for c in range(8):
                hops = 300 if c == 0 else int(rng.integers(40, 301))
                sy, sx = (hops - 1) * abs(dy), (hops - 1) * abs(dx)
                y0 = int(rng.integers(0, H - sy)) + (sy if dy < 0 else 0)
                x0 = int(rng.integers(0, W - sx)) + (sx if dx < 0 else 0)
                k = np.arange(hops)
                bits[i, y0 + k * dy, x0 + k * dx] |= 1 << d
    bits[:, -1, ::3] |= (1 << len(steps)) - 1
    bits[:, ::3, -1] |= (1 << len(steps)) - 1
    return bits


# steps outside DIR_STEPS that the kernel also takes: dy < 0, and dy == 0
# with |dx| >= 2 (the scalar row walk)
OTHER_STEPS = [(2, 0), (-3, 0), (4, 0), (-1, 0), (0, -2), (1, -3), (-4, -1),
               (3, -2)]


@pytest.mark.parametrize("max_doublings,dirs", [(0, "all"), (3, "all"),
                                                (8, "all"), (8, "other"),
                                                (3, "other")])
def test_run_pack_multi_kernel_long_runs(cuda, max_doublings, dirs):
    """Runs longer than the cap in all 16 directions, across many tiles."""
    from stvo_pl_tpu_torch.ops import lsd, lsd_kernel
    steps = lsd.direction_steps(16) if dirs == "all" else OTHER_STEPS
    bits = torch.from_numpy(_long_run_bits((2, 1280, 1280), steps,
                                           max_doublings)).to(cuda)
    k = lsd_kernel.run_pack_multi(bits, steps, max_doublings)
    p = lsd_kernel.run_pack_multi_plain(bits, steps, max_doublings)
    torch.cuda.synchronize()
    assert torch.equal(k, p), int((k != p).sum())
    hq = torch.tensor([lsd_kernel._hop_q(*s) for s in steps],
                      device=cuda)[None, :, None, None]
    at_cap = ((k >> 6) == hq * (1 << max_doublings)).flatten(2).any(-1)
    assert bool(at_cap.all())


@pytest.mark.parametrize("shape,step,density,border,dtype", [
    ((2, 70, 150), (1, 0), 0.3, True, torch.bool),      # axis-aligned
    ((2, 97, 130), (-4, 1), 0.4, True, torch.int8),     # H % 8 != 0, dx < 0
    ((3, 64, 128), (1, 4), 0.4, False, torch.int32),    # no padding at all
    ((2, 45, 260), (-3, 4), 0.5, True, torch.bool),     # ragged last tile
    ((16, 370, 1226), (4, 3), 0.05, True, torch.bool),  # the dense path
])
def test_run_pack_kernel_equals_plain(cuda, shape, step, density, border,
                                      dtype):
    """Uniform random 0/1 masks; `border` keeps the set bits of the last
    row and column, from which runs continue into the padded domain."""
    from stvo_pl_tpu_torch.ops import lsd_kernel
    g = torch.Generator(device=cuda).manual_seed(3)
    mask = torch.rand(shape, generator=g, device=cuda) < density
    if not border:
        mask[:, -1, :] = False
        mask[:, :, -1] = False
    mask = mask.to(dtype)
    dx, dy = step
    before = lsd_kernel.run_pack.launches
    k = lsd_kernel.run_pack(mask, dx, dy)
    p = lsd_kernel.run_pack_plain(mask, dx, dy)
    torch.cuda.synchronize()
    assert lsd_kernel.run_pack.launches == before + 1
    assert k.shape == (shape[0],) + lsd_kernel.run_pack_shape(*shape[1:])
    assert torch.equal(k, p), int((k != p).sum())
    assert int((k > 0).sum()) > 0
    for md in (0, 3):
        assert torch.equal(lsd_kernel.run_pack(mask, dx, dy, md),
                           lsd_kernel.run_pack_plain(mask, dx, dy, md))


def _long_run_mask(shape, step, seed):
    """2% noise plus, per image, 8 straight chains of the step 40-300 hops
    long (the first 300) inside the image; the last row and column set at
    every third pixel."""
    rng = np.random.default_rng(seed)
    n, H, W = shape
    dx, dy = step
    mask = rng.random(shape) < 0.02
    for i in range(n):
        for c in range(8):
            hops = 300 if c == 0 else int(rng.integers(40, 301))
            sy, sx = (hops - 1) * abs(dy), (hops - 1) * abs(dx)
            y0 = int(rng.integers(0, H - sy)) + (sy if dy < 0 else 0)
            x0 = int(rng.integers(0, W - sx)) + (sx if dx < 0 else 0)
            k = np.arange(hops)
            mask[i, y0 + k * dy, x0 + k * dx] = True
    mask[:, -1, ::3] = True
    mask[:, ::3, -1] = True
    return mask


@pytest.mark.parametrize("max_doublings", [0, 3, 8])
def test_run_pack_kernel_long_runs(cuda, max_doublings):
    """1280 x 1280 masks with runs longer than the cap in each of the 12
    dense directions (and two steps with dy < 0 and dy = 0, |dx| = 4)."""
    from stvo_pl_tpu_torch.ops import lsd, lsd_kernel
    for step in lsd.direction_steps(12) + [(4, 0), (-3, -2)]:
        dx, dy = step
        mask = torch.from_numpy(_long_run_mask((2, 1280, 1280), step,
                                               max_doublings)).to(cuda)
        k = lsd_kernel.run_pack(mask, dx, dy, max_doublings)
        p = lsd_kernel.run_pack_plain(mask, dx, dy, max_doublings)
        torch.cuda.synchronize()
        assert torch.equal(k, p), (step, int((k != p).sum()))
        assert bool(((k >> 6) == 1 << max_doublings).any()), step


def test_run_pack_kernel_unaligned_mask(cuda):
    """A mask view that does not start on 16 bytes is copied, not read
    misaligned; a mask of fewer than 16 bytes is read byte by byte, not
    past its end."""
    from stvo_pl_tpu_torch.ops import lsd_kernel
    g = torch.Generator(device=cuda).manual_seed(6)
    flat = torch.rand(3 * 97 * 130 + 5, generator=g, device=cuda) < 0.3
    mask = flat[5:].view(3, 97, 130)
    assert mask.data_ptr() % 16
    k = lsd_kernel.run_pack(mask, -4, 1)
    assert torch.equal(k, lsd_kernel.run_pack_plain(mask, -4, 1))
    tiny = torch.ones((1, 3, 4), dtype=torch.bool, device=cuda)   # 12 bytes
    assert torch.equal(lsd_kernel.run_pack(tiny, 1, 0),
                       lsd_kernel.run_pack_plain(tiny, 1, 0))


@pytest.mark.parametrize("shape1,shape2", [
    ((300, 8), (257, 8)),               # ragged tiles on both sides
    ((256, 8), (512, 8)),
    ((8, 1200, 8), (8, 1200, 8)),       # the VO step's point matching
    ((3, 1, 70, 8), (2, 90, 8)),        # leading dims broadcast
    ((1, 8), (1, 8)),
    ((70, 8), (1, 8)),                  # M % 4 != 0: 4-byte stores
    ((70, 8), (3, 8)),
    ((9, 8), (257, 8)),
    ((8, 300, 8), (8, 300, 8)),         # the VO step's line matching
])
def test_hamming_popc_kernel_equals_plain(cuda, shape1, shape2):
    """Random words, with the edge words 0, 0xFFFFFFFF, 0x80000000 and
    0x7FFFFFFF in rows of their own and pairs at distance 0 and 256."""
    from stvo_pl_tpu_torch.ops import hamming
    g = torch.Generator(device=cuda).manual_seed(4)
    lo, hi = -2 ** 31, 2 ** 31 - 1
    d1 = torch.randint(lo, hi, shape1, generator=g, device=cuda,
                       dtype=torch.int32)
    d2 = torch.randint(lo, hi, shape2, generator=g, device=cuda,
                       dtype=torch.int32)
    d1[..., 0, :] = d2.reshape(-1, 8)[0]      # pairs at distance 0
    d2[..., 0, :] = d2.reshape(-1, 8)[0]
    n1, n2 = shape1[-2], shape2[-2]
    for i, v in enumerate((0, -1, lo, hi)):
        if i + 1 < n1:
            d1[..., i + 1, :] = v
        if i + 1 < n2:
            d2[..., n2 - 1 - i, :] = v
    if n1 > 5 and n2 > 1:                     # pairs at distance 256
        d2[..., 1, :] = d2.reshape(-1, 8)[1]
        d1[..., 5, :] = ~d2.reshape(-1, 8)[1]
    before = hamming.hamming_matrix_popc.launches
    k = hamming.hamming_matrix(d1, d2, use_mxu=False)
    torch.cuda.synchronize()
    assert hamming.hamming_matrix_popc.launches == before + 1
    p = hamming.hamming_matrix_xla(d1, d2)
    assert k.dtype == torch.int32 and k.shape == p.shape
    assert torch.equal(k, p), int((k != p).sum())
    assert torch.equal(k, hamming.hamming_matrix_mxu(d1, d2))
    assert int(k[..., 0, 0].max()) == 0
    assert k.numel() == 1 or int(k.max()) > 100
    if n1 > 5 and n2 > 1:
        assert int(k[..., 5, 1].min()) == 256


def test_hamming_popc_kernel_unaligned_words(cuda):
    """Descriptors whose data starts 4 bytes past an 8-byte boundary (the
    kernel reads word pairs; the wrapper copies such a tensor)."""
    from stvo_pl_tpu_torch.ops import hamming
    g = torch.Generator(device=cuda).manual_seed(5)
    flat = torch.randint(-2 ** 31, 2 ** 31 - 1, (70 * 8 + 1,), generator=g,
                         device=cuda, dtype=torch.int32)
    d1 = flat[1:].view(70, 8)
    d2 = flat[:-1].view(70, 8)
    assert d1.is_contiguous() and d1.data_ptr() % 8 == 4
    k = hamming.hamming_matrix_popc(d1, d2)
    torch.cuda.synchronize()
    assert torch.equal(k, hamming.hamming_matrix_xla(d1, d2))
