"""The port's native prefetching loader (stvo_pl_tpu_torch/native) against
the JAX package's on the same files, and `ImageSequence.prefetch` against
the sequence's plain iteration.

Tolerances: both packages compile the same decoders, so decoded images are
equal, RGB included; against PIL (`load_gray`), 8-bit gray PGM and PNG are
equal and RGB within 1.0 (PIL rounds the luminance to an integer, the C++
decoder keeps the float, as tests/test_native_loader.py:54 allows).  The
C++ remap is held to both packages' `rectify_remap` within 1e-2, as the
JAX package's test holds its own.  `prefetch()` rectifies on the device
exactly as `frame()` does, so it is `torch.equal` to `iter(seq)`.  The
port's loader raises where the JAX one ends the sequence silently (a file
that does not decode) or overflows its buffer (an image of another size).
"""

import gc
import os

import numpy as np
import pytest
import torch
from PIL import Image

from stvo_pl_tpu.native import loader as jnl
from stvo_pl_tpu.ops import camera as jcam
from stvo_pl_tpu_torch.native import loader as tnl
from stvo_pl_tpu_torch.ops import camera as tcam
from stvo_pl_tpu_torch.utils import dataset as tdata

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
H, W = 24, 32


@pytest.fixture(scope="module")
def lib():
    try:
        return tnl.get_lib()
    except tnl.NativeUnavailable as e:
        pytest.skip(str(e))


@pytest.fixture(scope="module")
def jlib():
    try:
        return jnl.get_lib()
    except jnl.NativeUnavailable as e:
        pytest.skip(str(e))


def write_pgm(path, arr):
    h, w = arr.shape
    with open(path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(arr.astype(np.uint8).tobytes())


def write_image(path, arr):
    if str(path).endswith(".pgm"):
        write_pgm(path, arr)
    else:
        Image.fromarray(arr).save(path)


def pairs(tmp_path, rng, n, ext="png"):
    """n stereo pairs of random 8-bit gray images on disk: (paths_l,
    paths_r, arrays)."""
    paths_l, paths_r, arrays = [], [], []
    for i in range(n):
        a = rng.integers(0, 256, (2, H, W), dtype=np.uint8)
        for eye, paths in enumerate((paths_l, paths_r)):
            p = str(tmp_path / f"{'lr'[eye]}_{i:03d}.{ext}")
            write_image(p, a[eye])
            paths.append(p)
        arrays.append(a)
    return paths_l, paths_r, arrays


@pytest.mark.parametrize("kind", ["pgm", "png_gray", "png_rgb"])
def test_decode_against_jax_and_pil(tmp_path, lib, jlib, rng, kind):
    shape = (37, 53, 3) if kind == "png_rgb" else (37, 53)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    p = str(tmp_path / ("img.pgm" if kind == "pgm" else "img.png"))
    write_image(p, arr)
    out = tnl.decode_image(p)
    assert out.dtype == torch.float32 and out.shape == (37, 53)
    np.testing.assert_array_equal(out.numpy(), jnl.decode_image(p))
    pil = tdata.load_gray(p)
    if kind == "png_rgb":
        np.testing.assert_allclose(out.numpy(), pil, rtol=0, atol=1.0)
    else:
        np.testing.assert_array_equal(out.numpy(), pil)


def test_order_across_threads_against_jax(tmp_path, lib, jlib, rng):
    paths_l, paths_r, arrays = pairs(tmp_path, rng, 9)
    jld = jnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=3)
    ref = list(jld)
    jld.close()
    with tnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=3) as ld:
        got = list(ld)
    assert len(got) == len(ref) == 9
    for (gl, gr), (jl, jr), a in zip(got, ref, arrays):
        assert gl.dtype == torch.float32 and gl.shape == (H, W)
        np.testing.assert_array_equal(gl.numpy(), jl)
        np.testing.assert_array_equal(gr.numpy(), jr)
        np.testing.assert_array_equal(gl.numpy(), a[0].astype(np.float32))
        np.testing.assert_array_equal(gr.numpy(), a[1].astype(np.float32))


def test_remap_against_both_rectify_remaps(tmp_path, lib, rng):
    import jax.numpy as jnp
    img = rng.integers(0, 256, (H, W), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_image(p, img)
    mp = np.stack([np.tile(np.arange(W), (H, 1)) * 0.97 + 0.3,
                   np.tile(np.arange(H)[:, None], (1, W)) * 0.95 + 0.7],
                  axis=-1).astype(np.float32)
    with tnl.PrefetchingLoader([p], [p], W, H, mp, mp) as ld:
        (gl, gr), = list(ld)
    x = img.astype(np.float32)
    ref_t = tcam.rectify_remap(torch.from_numpy(x), torch.from_numpy(mp))
    ref_j = np.asarray(jcam.rectify_remap(jnp.asarray(x), jnp.asarray(mp)))
    for ref in (ref_t.numpy(), ref_j):
        np.testing.assert_allclose(gl.numpy(), ref, rtol=0, atol=1e-2)
    assert torch.equal(gl, gr)


def make_dataset(root, rng, n=6, distorted=False):
    """A dataset directory of n gray PNG pairs in the reference's layout;
    with `distorted`, radial distortion makes the sequence build
    rectification maps."""
    for sub in ("image_0", "image_1"):
        (root / sub).mkdir()
    for i in range(n):
        for sub in ("image_0", "image_1"):
            arr = rng.integers(0, 256, (H, W), dtype=np.uint8)
            write_image(root / sub / f"{i:06d}.png", arr)
    d0 = -0.1 if distorted else 0.0
    (root / "dataset_params.yaml").write_text(
        "images_subfolder_l: image_0/\nimages_subfolder_r: image_1/\n"
        "cam0:\n  cam_model: Pinhole\n"
        f"  cam_width: {W}\n  cam_height: {H}\n"
        "  cam_fx: 30.0\n  cam_fy: 30.0\n  cam_cx: 16.0\n  cam_cy: 12.0\n"
        f"  cam_d0: {d0}\n  cam_d1: 0.0\n  cam_d2: 0.0\n  cam_d3: 0.0\n"
        "  cam_bl: 0.1\n")
    return root


@pytest.mark.parametrize("distorted", [False, True],
                         ids=["rectified", "with_maps"])
def test_prefetch_equals_plain_iteration(tmp_path, lib, rng, distorted):
    root = make_dataset(tmp_path, rng, distorted=distorted)
    seq = tdata.ImageSequence(str(root), device="cpu")
    assert (seq.calib.map_l is not None) == distorted
    assert seq.loader is None
    plain = list(seq)
    got = list(seq.prefetch(n_threads=3))
    assert seq.loader == "native"
    assert len(got) == len(plain) == 6
    for a, b in zip(got, plain):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_prefetch_falls_back_only_when_unavailable(tmp_path, lib, rng,
                                                   monkeypatch, capsys):
    root = make_dataset(tmp_path, rng, n=2)
    seq = tdata.ImageSequence(str(root), device="cpu")

    def unavailable():
        raise tnl.NativeUnavailable("no g++")

    monkeypatch.setattr(tnl, "get_lib", unavailable)
    got = list(seq.prefetch())
    assert seq.loader == "python"
    assert "native loader unavailable" in capsys.readouterr().err
    for a, b in zip(got, seq):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def broken():
        raise OSError("any other fault")

    monkeypatch.setattr(tnl, "get_lib", broken)
    with pytest.raises(OSError, match="any other fault"):
        list(seq.prefetch())


@pytest.mark.parametrize("fault", ["corrupt", "truncated", "wrong_size"])
def test_bad_frame_raises(tmp_path, lib, rng, fault):
    root = make_dataset(tmp_path, rng, n=5)
    bad = root / "image_1" / "000002.png"
    if fault == "corrupt":
        bad.write_bytes(b"not an image at all")
    elif fault == "truncated":
        bad.write_bytes(bad.read_bytes()[:60])
    else:
        write_image(bad, rng.integers(0, 256, (H, W + 8), dtype=np.uint8))
    match = (f"image is {W + 8}x{H}, expected {W}x{H}"
             if fault == "wrong_size" else "native decode failed")
    seq = tdata.ImageSequence(str(root), device="cpu")
    got = []
    with pytest.raises(IOError, match=match) as err:
        for pair in seq.prefetch():
            got.append(pair)
    assert str(bad) in str(err.value)
    assert len(got) == 2 and seq.loader == "native"


def _loader_threads() -> int:
    """Live threads of this process that the native library named
    "stvo-loader": the count is blind to the thread pools of torch, gloo
    or JAX, which start and stop on their own clock when other test files
    ran in the same worker."""
    n = 0
    for tid in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{tid}/comm") as f:
                n += f.read().strip() == "stvo-loader"
        except FileNotFoundError:      # the thread ended meanwhile
            pass
    return n


def test_early_close_joins_workers(tmp_path, lib, rng):
    # more frames than the decode window (CAPACITY), so no worker runs
    # out of frames and ends on its own before close()
    n = tnl.CAPACITY + 8
    paths_l, paths_r, arrays = pairs(tmp_path, rng, n)
    gc.collect()                    # loaders of earlier tests close now
    before = _loader_threads()
    ld = tnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=4)
    assert _loader_threads() == before + 4
    it = iter(ld)
    first = next(it)
    np.testing.assert_array_equal(first[0].numpy(), arrays[0][0])
    it.close()                      # the consumer stops early
    assert ld.handle is None and _loader_threads() == before
    ld.close()                      # idempotent
    with tnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=3) as ld:
        it = iter(ld)
        next(it)
        assert _loader_threads() == before + 3
    assert ld.handle is None and _loader_threads() == before


def test_built_outside_the_package(lib):
    build_dir = tnl.build_dir()
    assert build_dir.parent == tnl.BUILD_ROOT
    assert os.path.samefile(tnl.BUILD_ROOT, os.path.join(ROOT, "build"))
    assert build_dir.name.startswith("native-")
    assert (build_dir / tnl.LIB).exists()
    assert "-march=native" not in tnl.FLAGS
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "build/" in f.read().split()
    pkg = os.path.dirname(tnl.__file__)
    assert set(os.listdir(pkg)) <= {"__init__.py", "loader.py",
                                    "stvo_loader.cpp", "__pycache__"}


def test_slow_frame_behind_a_full_buffer_is_emitted(tmp_path, lib, rng):
    """Frame 0's left image is a FIFO: its worker blocks in fopen while
    the other worker decodes frames 1-11 and waits at the end of the
    decode window (CAPACITY = 12 frames ahead of the consumer). Frame 0 is
    then emitted all the same (here as a file that does not decode: a
    pipe cannot be sized) and the consumer gets its error, where the JAX
    copy, whose finished frames wait for room that only frame 0's emission
    frees, waits forever."""
    import threading
    paths_l, paths_r, _ = pairs(tmp_path, rng, 14)
    fifo = str(tmp_path / "slow.png")
    os.mkfifo(fifo)
    paths_l[0] = fifo
    ld = tnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=2)
    result = {}

    def consume():
        try:
            next(iter(ld))
        except IOError as e:
            result["error"] = str(e)

    consumer = threading.Thread(target=consume, daemon=True)
    consumer.start()
    consumer.join(1.0)                         # the buffer fills meanwhile
    assert consumer.is_alive()
    os.close(os.open(fifo, os.O_WRONLY))       # frame 0's fopen returns
    consumer.join(10.0)
    # (a consumer still blocked inside the library keeps the loader: it
    # cannot be closed under it)
    assert not consumer.is_alive(), "the loader did not emit frame 0"
    assert "native decode failed" in result["error"]
    assert fifo in result["error"]
    assert ld.handle is None                   # the generator closed it


def test_decode_window_bounds_the_buffer(tmp_path, lib, rng):
    """A consumer far slower than the decoders: the frames decoded and not
    yet taken never exceed CAPACITY, and the loader still runs ahead (the
    window fills) and yields every frame in order."""
    import time
    n = 40
    paths_l, paths_r, arrays = pairs(tmp_path, rng, n)
    seen = []
    with tnl.PrefetchingLoader(paths_l, paths_r, W, H, n_threads=4) as ld:
        it = iter(ld)
        for i in range(n):
            time.sleep(0.01)
            seen.append(ld.buffered()[0])
            left, right = next(it)
            np.testing.assert_array_equal(left.numpy(), arrays[i][0])
            np.testing.assert_array_equal(right.numpy(), arrays[i][1])
        peak = ld.buffered()[1]
    assert max(seen) <= peak <= tnl.CAPACITY
    assert peak == tnl.CAPACITY
