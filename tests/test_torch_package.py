"""Package hygiene of the port: it imports with JAX blocked, no source
file imports JAX or the JAX package (for a C++ or CUDA source: includes
nothing of it and names no path of it in a string), and its entry points
refuse to run without a GPU unless the caller asks for the CPU."""

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
    if f.endswith((".py", ".cu", ".cuh", ".cpp"))) + [
        os.path.join(ROOT, "chip_smoke.py")]
# the port-only worker of tests/test_torch_parallel.py
WORKER = os.path.join(ROOT, "tools", "torch_dist_worker.py")
SOURCES.append(WORKER)
MODULES = sorted(
    os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").replace(
        ".__init__", "")
    for p in SOURCES if p.endswith(".py") and "stvo_pl_tpu_torch" in p)


def test_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {MODULES!r}: importlib.import_module(m)\n"
            "import chip_smoke\n"
            "sys.path.insert(0, 'tools'); import torch_dist_worker\n"
            "assert not any(k == 'stvo_pl_tpu' or k.startswith('stvo_pl_tpu.')"
            " for k in sys.modules)\n"
            "assert not any(k.split('.')[0] in ('orbax', 'tensorflow')"
            " for k in sys.modules)\n"
            "print('ok')")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_reference_imports(path):
    src = open(path).read()
    jax_pkg = r"\bstvo_pl_tpu\b(?!_torch)"
    if not path.endswith(".py"):
        # a native source is the port's own: its comments may name the TPU
        # kernel it replaces, but it includes and opens nothing of the JAX
        # package
        for line in src.splitlines():
            s = line.strip()
            if s.startswith("#include"):
                assert not re.search(jax_pkg, s), (path, s)
            for literal in re.findall(r'"[^"]*"', s):
                assert not re.search(jax_pkg, literal), (path, s)
        return
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
    # the EDLine detector runs: full-capacity lines at level 0, finite
    cfg = VOConfig(use_edlines=True, orb_nfeatures=100, lsd_nfeatures=16)
    st = batched.init_batched_state(cfg, 2, device="cpu")
    st, tel = batched.vo_step_batched(st, img, img, cam, cfg)
    assert st.prev_lines.spl.shape == (2, 16, 2)
    assert not st.prev_lines.level.any()
    assert bool(torch.isfinite(tel.Tfw).all())
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


def test_application_modules_are_checked():
    """The windowed BA, the back end, the dataset CLI and its utilities,
    the EDLine detector, the scale-out modules, the native loader,
    checkpoints and profiling are among the modules imported with JAX
    blocked and scanned above, and the multi-process test's worker script
    and the loader's C++ source among the files scanned."""
    assert WORKER in SOURCES
    assert os.path.join(PKG, "native", "stvo_loader.cpp") in SOURCES
    for m in ("stvo_pl_tpu_torch.parallel.ba",
              "stvo_pl_tpu_torch.parallel.window",
              "stvo_pl_tpu_torch.ops.edline",
              "stvo_pl_tpu_torch.parallel.mesh",
              "stvo_pl_tpu_torch.parallel.tp",
              "stvo_pl_tpu_torch.parallel.groups",
              "stvo_pl_tpu_torch.parallel.batched",
              "stvo_pl_tpu_torch.models.backend", "stvo_pl_tpu_torch.cli",
              "stvo_pl_tpu_torch.utils.dataset",
              "stvo_pl_tpu_torch.utils.world",
              "stvo_pl_tpu_torch.utils.visualization",
              "stvo_pl_tpu_torch.utils.scene_html",
              "stvo_pl_tpu_torch.native.loader",
              "stvo_pl_tpu_torch.utils.checkpoint",
              "stvo_pl_tpu_torch.utils.profiling"):
        assert m in MODULES, m


def test_application_entry_points_need_gpu_unless_cpu_requested(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from stvo_pl_tpu_torch import cli, convert
    from stvo_pl_tpu_torch.models.backend import WindowedBA
    from stvo_pl_tpu_torch.ops import camera as tcam
    from stvo_pl_tpu_torch.utils.dataset import ImageSequence
    cam = tcam.StereoCamera(160.0, 160.0, 60.0, 40.0, 0.3, 120, 80)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        WindowedBA(cam, VOConfig())
    assert WindowedBA(cam, VOConfig(), device="cpu").device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ImageSequence(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main([str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convert.problem_from_numpy(dict(X=np.zeros((2, 3), np.float32),
                                        obs=np.zeros((2, 1, 3), np.float32),
                                        mask=np.ones((2, 1), bool),
                                        sigma2=np.ones(2, np.float32),
                                        Xl=None, obs_l=None, mask_l=None,
                                        sigma2_l=None))
