"""Write the textured street canyon as a KITTI-style stereo dataset, with
the PyTorch port's renderer (the port's counterpart of
tools/export_scene.py --scene textured).

    python3 tools/export_street_torch.py OUT_DIR [--frames 40] [--scale 1]
        [--speed 0.8] [--seed 0] [--photos bundled|installed|none]

OUT_DIR gets image_0/ and image_1/ (PNG pairs), dataset_params.yaml and a
KITTI gt.txt, so that either CLI runs over it:

    python -m stvo_pl_tpu_torch.cli OUT_DIR --gt OUT_DIR/gt.txt --ba-window 4
    python -m stvo_pl_tpu.cli OUT_DIR --gt OUT_DIR/gt.txt --ba-window 4

The world is utils/world.make_world(seed, length = frames * speed + 120)
over utils/synthetic.street_trajectory at the KITTI camera (fx 718.856,
cx 613, cy 185, b 0.5372, 1226x370), divided by `--scale`.  Its
photographs: `bundled` (the default, chip_smoke.py's) the port's copy of
matplotlib's sample photograph alone, whatever the host has installed;
`installed` world.py's search (the installed packages' photographs,
else the bundled copy); `none` procedural texture alone.  A dataset
already in OUT_DIR that was written with the same parameters is kept.
Runs on the CPU; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))


def kitti_camera(scale: float = 1.0):
    from stvo_pl_tpu_torch.ops import camera as cam_ops
    return cam_ops.StereoCamera(
        fx=718.856 / scale, fy=718.856 / scale, cx=613.0 / scale,
        cy=185.0 / scale, b=0.5372, width=int(round(1226 / scale)),
        height=int(round(370 / scale)))


PHOTO_SETS = ("bundled", "installed", "none")


def _photos(which: str):
    from stvo_pl_tpu_torch.utils import world
    return {"bundled": world.bundled_photos, "installed": world.load_photos,
            "none": lambda: []}[which]()


def write_street_dataset(root: str, cam, n_frames: int, speed: float = 0.8,
                         seed: int = 0, photos: str = "bundled"
                         ) -> np.ndarray:
    """Render the street and write it under `root`; the world is
    n_frames * speed + 120 m long, with the photograph set `photos`
    (PHOTO_SETS).  A dataset already at `root` that was written
    with the same parameters is kept; any other is replaced.  Returns the
    true poses [T, 4, 4] as written to gt.txt."""
    from PIL import Image

    from stvo_pl_tpu_torch.utils import metrics, synthetic, world

    length = n_frames * speed + 120.0
    params = dict(frames=n_frames, speed=speed, seed=seed, length=length,
                  photos=photos, camera=[cam.fx, cam.fy, cam.cx, cam.cy,
                                         cam.b, cam.width, cam.height])
    stamp = os.path.join(root, "street_params.json")
    gt_path = os.path.join(root, "gt.txt")
    if os.path.exists(stamp) and os.path.exists(gt_path):
        with open(stamp) as f:
            if json.load(f) == params:
                return metrics.read_kitti(gt_path)
    shutil.rmtree(root, ignore_errors=True)
    poses = synthetic.street_trajectory(n_frames, speed=speed).numpy()
    scene = world.make_world(seed=seed, length=length,
                             photos=_photos(photos))
    seq_l, seq_r = world.render_sequence(scene, poses, cam)
    for sub, seq in (("image_0", seq_l), ("image_1", seq_r)):
        os.makedirs(os.path.join(root, sub))
        for i in range(n_frames):
            Image.fromarray(np.clip(seq[i], 0, 255).astype(np.uint8)).save(
                os.path.join(root, sub, f"{i:06d}.png"))
    metrics.write_kitti(gt_path, poses)
    with open(os.path.join(root, "dataset_params.yaml"), "w") as f:
        f.write("images_subfolder_l: image_0\n"
                "images_subfolder_r: image_1\n"
                "cam0:\n"
                f"  cam_width: {cam.width}\n  cam_height: {cam.height}\n"
                f"  cam_fx: {cam.fx}\n  cam_fy: {cam.fy}\n"
                f"  cam_cx: {cam.cx}\n  cam_cy: {cam.cy}\n"
                f"  cam_bl: {cam.b}\n  cam_model: Pinhole\n")
    with open(stamp, "w") as f:        # written last: the dataset is whole
        json.dump(params, f)
    return metrics.read_kitti(gt_path)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="divide the KITTI camera's size and focal by this")
    ap.add_argument("--speed", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--photos", choices=PHOTO_SETS, default="bundled")
    args = ap.parse_args(argv)
    cam = kitti_camera(args.scale)
    write_street_dataset(args.out_dir, cam, args.frames, args.speed,
                         args.seed, photos=args.photos)
    print(f"wrote {args.frames} stereo pairs of {cam.width}x{cam.height} "
          f"to {args.out_dir} ({len(_photos(args.photos))} photographs)")


if __name__ == "__main__":
    main()
