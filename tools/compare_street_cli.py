"""Both dataset CLIs on the textured street, on this host's CPU: the JAX
package's on its kernel branches (interpret-mode Pallas, the route of
tests/test_torch_helpers.py) and the PyTorch port's with `--device cpu`,
over the same images.

    JAX_PLATFORMS=cpu python3 tools/compare_street_cli.py
        [--scale 2] [--frames 40] [--photos bundled|installed|none]
        [--ba] [--out build/compare_street]

The street is tools/export_street_torch.py's (written to
OUT/street_<photos>_s<scale>/, kept if it is already there).  `--ba`
adds chip_smoke.py's back end flags (`--ba-window 4 --ba-kf-every 3`).
Prints one JSON object: for each package the aligned and unaligned ATE
of the raw trajectory (and of the refined one with `--ba`), its BA
line, and the largest translation between the two packages' poses.
A comparison harness like the tests: it imports both packages.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tools"))
sys.path.insert(0, os.path.join(ROOT, "tests"))

BA_FLAGS = ["--ba-window", "4", "--ba-kf-every", "3"]


def _ates(metrics, poses, gt):
    return dict(aligned_m=float(metrics.ate_rmse(poses, gt)),
                unaligned_m=float(metrics.ate_rmse(poses, gt, align=False)))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scale", type=float, default=2.0)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--photos", default="bundled",
                    choices=("bundled", "installed", "none"))
    ap.add_argument("--ba", action="store_true")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "compare_street"))
    args = ap.parse_args(argv)

    from export_street_torch import kitti_camera, write_street_dataset
    from stvo_pl_tpu_torch import cli as tcli
    from stvo_pl_tpu_torch.utils import metrics, world
    from test_torch_helpers import jax_kernel_branch

    from stvo_pl_tpu import cli as jcli

    cam = kitti_camera(args.scale)
    root = os.path.join(args.out, f"street_{args.photos}_s{args.scale:g}")
    gt = write_street_dataset(root, cam, args.frames, photos=args.photos)
    n_photos = len({"bundled": world.bundled_photos,
                    "installed": world.load_photos,
                    "none": lambda: []}[args.photos]())
    extra = BA_FLAGS if args.ba else []
    out = dict(camera=[cam.width, cam.height], frames=args.frames,
               photos=args.photos, n_photos=n_photos, ba=args.ba)
    poses = {}
    for name in ("jax_kernel_branches", "port_cpu"):
        traj = os.path.join(root, f"traj_{name}.txt")
        argv_c = [root, "--quiet", "-t", traj] + extra
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            if name == "port_cpu":
                p = tcli.main(argv_c + ["--device", "cpu"])
            else:
                with jax_kernel_branch():
                    p = jcli.main(argv_c)
        res = dict(seconds=time.perf_counter() - t0,
                   raw=_ates(metrics, np.asarray(p, np.float64), gt))
        if args.ba and os.path.exists(traj + ".refined"):
            res["refined"] = _ates(metrics, metrics.read_tum(
                traj + ".refined"), gt)
        res["ba_line"] = [l for l in buf.getvalue().splitlines()
                          if l.startswith("[stvo] BA")]
        poses[name] = np.asarray(p, np.float64)
        out[name] = res
    out["max_translation_diff_m"] = float(np.abs(
        poses["jax_kernel_branches"][:, :3, 3]
        - poses["port_cpu"][:, :3, 3]).max())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
