"""Package hygiene of the port: it imports with JAX blocked, no source
file names JAX or the JAX package, and its entry points refuse to run
without a GPU unless the caller asks for the CPU."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from stvo_pl_tpu_torch.config import VOConfig

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(__file__), "..")
PKG = os.path.join(ROOT, "stvo_pl_tpu_torch")
SOURCES = sorted(
    os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
    if f.endswith((".py", ".cu"))) + [os.path.join(ROOT, "chip_smoke.py")]
MODULES = sorted(
    os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").replace(
        ".__init__", "")
    for p in SOURCES if p.endswith(".py") and "stvo_pl_tpu_torch" in p)


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "assert not any(k == 'stvo_pl_tpu' or k.startswith('stvo_pl_tpu.')"
            " for k in sys.modules)\n"
            "print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_imports(path):
    src = open(path).read()
    for line in src.splitlines():
        s = line.strip()
        if s.startswith(("import ", "from ")):
            assert not re.search(r"\bjax\b", s), (path, s)
            assert not re.search(r"\bstvo_pl_tpu\b(?!_torch)", s), (path, s)


def test_entry_points_need_gpu_unless_cpu_requested():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from stvo_pl_tpu_torch import convert
    from stvo_pl_tpu_torch.models import frontend
    from stvo_pl_tpu_torch.parallel import batched
    cfg = VOConfig(has_lines=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batched.init_batched_state(cfg, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frontend.init_state(cfg)
    st = batched.init_batched_state(cfg, 2, device="cpu")
    assert st.Tfw.device.type == "cpu" and st.Tfw.shape == (2, 4, 4)
    tree = convert.state_to_numpy(st)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.state_from_numpy(tree)
    assert convert.state_from_numpy(tree, device="cpu").Tfw.shape == (2, 4, 4)


def test_lines_and_bad_inputs_are_refused():
    from stvo_pl_tpu_torch.ops import camera as tcam
    from stvo_pl_tpu_torch.ops import fast_kernel, patches
    from stvo_pl_tpu_torch.parallel import batched
    cam = tcam.StereoCamera(160.0, 160.0, 60.0, 40.0, 0.3, 120, 80)
    img = torch.zeros((2, 80, 120))
    cfg = VOConfig(use_edlines=True)
    st = batched.init_batched_state(cfg, 2, device="cpu")
    with pytest.raises(NotImplementedError, match="use_edlines"):
        batched.vo_step_batched(st, img, img, cam, cfg)
    # the dense single-octave detector runs, with either generator
    cfg = VOConfig(lsd_octaves=1, orb_nfeatures=100, lsd_nfeatures=16)
    for per_direction in (False, True):
        st = batched.init_batched_state(cfg, 2, device="cpu")
        st, tel = batched.vo_step_batched(st, img, img, cam, cfg,
                                          per_direction=per_direction)
        assert bool(st.initialized.all()) and tel.Tfw.shape == (2, 4, 4)
    st = batched.init_batched_state(VOConfig(has_lines=False), 2,
                                    device="cpu")
    with pytest.raises(ValueError, match="shape"):
        batched.vo_step_batched(st, img[:1], img[:1], cam,
                                VOConfig(has_lines=False))
    with pytest.raises(ValueError, match="edge"):
        fast_kernel.fast_pack(img, 3)
    with pytest.raises(ValueError, match="float32"):
        fast_kernel.fast_pack(img.double(), 19)
    y0 = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        patches.extract_patches(img.double(), y0, y0)
    with pytest.raises(ValueError):
        patches.extract_patches(img, y0[:1], y0[:1])
    np.testing.assert_array_equal(
        patches.extract_patches(img, y0, y0, 5).shape, (2, 4, 5, 5))
