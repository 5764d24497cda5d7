"""Dataset loaders: KITTI / EuRoC / generic stereo image directories (port
of stvo_pl_tpu/utils/dataset.py).

Mirrors the reference Dataset (src/dataset.cpp:86-157): directory of left
and right images, numeric-sorted filenames, offset / count / step
decimation, per-frame rectification.  dataset_params.yaml is the
reference's own schema (config/dataset_params/*.yaml): a `cam0` block with
either rectified pinhole intrinsics (cam_fx/.../cam_bl, optionally with
distortion cam_d0..cam_d4) or a full stereo calibration (Kl/Kr/Dl/Dr/R/t);
both distorted forms build rectification maps.

Images are decoded on the host.  `ImageSequence.frame` returns float32
tensors: rectified on the sequence's device when the calibration has
maps, else the decoded host images (in pinned memory when the sequence's
device is a GPU, so the caller's copy to the device can be asynchronous).
`ImageSequence.prefetch` yields the same pairs, decoded ahead on the
native loader's threads (`native/loader.py`) and rectified on the device
as `frame` rectifies them; `prefetch(raw=True)` yields the decoded pairs
before rectification, for a step that rectifies them itself with
`ImageSequence.rectification` (ops/camera.rectify_taps: the maps as
taps and weights on the device, built once).
"""

from __future__ import annotations

import os
import re
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from stvo_pl_tpu_torch.device import resolve_device
from stvo_pl_tpu_torch.ops import camera as cam_ops

_NUM_RE = re.compile(r"^[^0-9]*([0-9]+\.?[0-9]*)[^0-9]*\.[a-zA-Z]{3,4}$")


def sorted_images_with_keys(directory: str) -> list[tuple[float, str]]:
    """Numeric filename sort (reference getSortedImages,
    src/dataset.cpp:49-84).  Returns (numeric_key, path) pairs: the key is
    the frame index for KITTI-style names and the timestamp for
    TUM/EuRoC-style names."""
    entries = []
    for name in os.listdir(directory):
        m = _NUM_RE.match(name)
        if m:
            entries.append((float(m.group(1)), os.path.join(directory, name)))
    entries.sort()
    return entries


def sorted_images(directory: str) -> list[str]:
    return [p for _, p in sorted_images_with_keys(directory)]


def load_gray(path: str) -> np.ndarray:
    """Decode an image to float32 grayscale [H, W]."""
    from PIL import Image
    img = Image.open(path)
    if img.mode != "L":
        img = img.convert("L")
    return np.asarray(img, dtype=np.float32)


@dataclass
class StereoCalib:
    cam: cam_ops.StereoCamera
    map_l: np.ndarray | None = None   # rectification maps [H, W, 2], or
    map_r: np.ndarray | None = None   # None when the images are rectified


def calib_from_yaml(params: dict) -> StereoCalib:
    """Parse the reference dataset_params.yaml `cam0` block
    (src/pinholeStereoCamera.cpp:30-125 constructor semantics)."""
    c = params["cam0"]
    width = int(c["cam_width"])
    height = int(c["cam_height"])
    if "Kl" in c:
        # full stereo calibration -> undistort-rectify maps
        fxl, fyl, cxl, cyl = c["Kl"]
        fxr, fyr, cxr, cyr = c["Kr"]
        K_l = np.array([[fxl, 0, cxl], [0, fyl, cyl], [0, 0, 1.0]])
        K_r = np.array([[fxr, 0, cxr], [0, fyr, cyr], [0, 0, 1.0]])
        d_l = np.asarray(c["Dl"], dtype=np.float64)
        d_r = np.asarray(c["Dr"], dtype=np.float64)
        R = np.asarray(c["R"], dtype=np.float64).reshape(3, 3)
        t = np.asarray(c["t"], dtype=np.float64)
        model = "equidistant" if str(c.get("cam_model", "")).lower() in (
            "fisheye", "equidistant") else "radtan"
        # reference convention: R, t map cam0 -> cam1; invert to get the
        # right camera's pose in the left frame
        R_lr = R.T
        t_lr = -R.T @ t
        if t_lr[0] < 0:  # baseline must be +x of the left camera
            R_lr, t_lr = R, t
        map_l, map_r, cam = cam_ops.build_rectify_maps(
            K_l, d_l, K_r, d_r, R_lr, t_lr, width, height, model=model)
        return StereoCalib(cam=cam, map_l=map_l, map_r=map_r)
    # already-rectified pinhole (KITTI)
    cam = cam_ops.StereoCamera(
        fx=float(c["cam_fx"]), fy=float(c["cam_fy"]),
        cx=float(c["cam_cx"]), cy=float(c["cam_cy"]),
        b=float(c["cam_bl"]), width=width, height=height)
    dist = any(float(c.get(f"cam_d{i}", 0.0)) != 0.0 for i in range(4))
    if dist:
        d = np.array([float(c.get(f"cam_d{i}", 0.0)) for i in range(5)])
        K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1.0]])
        map_l, map_r, cam2 = cam_ops.build_rectify_maps(
            K, d, K, d, np.eye(3), np.array([cam.b, 0.0, 0.0]),
            width, height)
        return StereoCalib(cam=cam2, map_l=map_l, map_r=map_r)
    return StereoCalib(cam=cam)


@dataclass
class ImageSequence:
    """Reference Dataset equivalent: iterate rectified stereo pairs.
    `device` ("cuda" unless the caller asks for the CPU) is where frames
    are rectified and where the caller runs the VO."""
    base_dir: str
    offset: int = 0
    nmax: int = 0
    step: int = 1
    calib: StereoCalib = field(default=None)
    device: torch.device | str | None = None
    paths_l: list[str] = field(default_factory=list)
    paths_r: list[str] = field(default_factory=list)
    stamps: list[float] = field(default_factory=list)  # numeric filename key
    #   per retained left frame: frame index (KITTI) or timestamp (TUM/EuRoC)
    loader: str | None = field(default=None, init=False)  # the path
    #   prefetch() took, "native" or "python" (PIL); set as it starts

    def __post_init__(self):
        import yaml
        self.device = resolve_device(self.device)
        params_path = os.path.join(self.base_dir, "dataset_params.yaml")
        if not os.path.exists(params_path):
            raise FileNotFoundError(
                f"[Dataset] Dataset parameters not found: {params_path}")
        with open(params_path) as f:
            params = yaml.safe_load(f)
        if self.calib is None:
            self.calib = calib_from_yaml(params)
        dir_l = os.path.join(self.base_dir, params["images_subfolder_l"])
        dir_r = os.path.join(self.base_dir, params["images_subfolder_r"])
        keyed_l = sorted_images_with_keys(dir_l)
        all_r = sorted_images(dir_r)
        if len(keyed_l) != len(all_r):
            raise RuntimeError("[Dataset] Left and right image counts differ")
        # decimation (src/dataset.cpp:133-140)
        offset = max(0, self.offset)
        nmax = self.nmax if self.nmax > 0 else len(keyed_l)
        step = max(1, self.step)
        idx = range(offset, len(keyed_l), step)
        self.paths_l = [keyed_l[i][1] for i in idx][:nmax]
        self.stamps = [keyed_l[i][0] for i in idx][:nmax]
        self.paths_r = [all_r[i] for i in idx][:nmax]
        self.rectification = None       # ops/camera.RectifyTaps or None
        if self.calib.map_l is not None:
            cam = self.calib.cam
            self.rectification = cam_ops.rectify_taps(
                self.calib.map_l, self.calib.map_r, (cam.height, cam.width),
                self.device)

    def __len__(self):
        return len(self.paths_l)

    def _host(self, path: str) -> torch.Tensor:
        img = torch.from_numpy(load_gray(path))
        return img.pin_memory() if self.device.type == "cuda" else img

    def _rectify(self, img_l: torch.Tensor, img_r: torch.Tensor):
        if self.rectification is None:
            return img_l, img_r
        return cam_ops.remap_taps(img_l.to(self.device, non_blocking=True),
                                  img_r.to(self.device, non_blocking=True),
                                  self.rectification)

    def frame(self, i: int):
        """Load (and rectify) one stereo pair: float32 [H, W] tensors."""
        return self._rectify(self._host(self.paths_l[i]),
                             self._host(self.paths_r[i]))

    def __iter__(self):
        for i in range(len(self)):
            yield self.frame(i)

    def prefetch(self, n_threads: int = 2, raw: bool = False):
        """Iterate the pairs `__iter__` yields, bit for bit on 8-bit gray
        images, decoded ahead on the native loader's C++ threads (into
        pinned tensors on a GPU device) and rectified on the device as
        `frame` rectifies them; with `raw`, the decoded pairs as they are,
        not rectified.  Falls back to PIL, with a line on stderr, only
        when the native library cannot be built; a frame that does not
        decode or has the wrong size raises `IOError`.  RGB files differ:
        the C++ decoder keeps the float luminance, PIL rounds it (within
        1.0)."""
        from stvo_pl_tpu_torch.native import loader as native
        cam = self.calib.cam
        try:
            ld = native.PrefetchingLoader(
                self.paths_l, self.paths_r, cam.width, cam.height,
                n_threads=n_threads, pin_memory=self.device.type == "cuda")
        except native.NativeUnavailable as e:
            sys.stderr.write(f"[Dataset] native loader unavailable, "
                             f"decoding with PIL: {e}\n")
            self.loader = "python"
            for a, b in zip(self.paths_l, self.paths_r):
                pair = self._host(a), self._host(b)
                yield pair if raw else self._rectify(*pair)
            return
        self.loader = "native"
        with ld:
            for img_l, img_r in ld:
                yield (img_l, img_r) if raw else self._rectify(img_l, img_r)
