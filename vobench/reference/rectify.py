"""The plain reference of a distorted stereo rig's rectification, and the
inverse that turns the renderer's rectified frames into the rig's raw
frames.  Float64 torch throughout; it imports nothing of the program, so
that no later change of the program moves the benchmark's raw inputs or
the maps they are held to.

- Rectifying rotations: Bouguet's algorithm as the OpenCV book describes
  `cv::stereoRectify` (Bradski and Kaehler, Learning OpenCV, ch. 12):
  each camera turns half of the relative rotation, then both turn so that
  the baseline is the x axis, e1 along it, e2 = z x e1, e3 = e1 x e2.
  OpenCV's own code takes the least rotation onto the x axis instead,
  which differs from e2 = z x e1 by a turn about the baseline of second
  order in the baseline's tilt.  The new camera matrix departs from
  OpenCV as the program does: one focal length, the mean of the two
  eyes' fx, and the principal point at the image's centre.
- Distortion: radial-tangential (k1, k2, p1, p2[, k3]) and equidistant
  (k1..k4), forward, and undistortion by fixed-point iteration
  (radial-tangential, as `cv::undistortPoints`) or Newton's method on the
  angle (equidistant), run until converged.
- `rectify_maps`: the source point in the raw image of every rectified
  pixel; `remap`: bilinear sampling, taps outside the image reading 0.
- `raw_from_rectified`: for every raw pixel, undistort, rotate into the
  rectified frame, project, and sample the rectified image there (taps
  clamped to its border), rounded to the 8-bit grey levels a sensor
  gives; `raw_pool` makes a whole rendered pool raw.

A rig (`Rig`) is the dataset file's calibration (`dataset_params/
euroc_params.yaml`): Kl, Kr as (fx, fy, cx, cy), the distortion Dl, Dr,
and R, t mapping a point of the left (cam0) frame into the right (cam1)
frame, X_r = R X_l + t.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

F64 = torch.float64
UNDISTORT_ITERS = 200       # at most; the loops stop once converged
CONVERGED = 1e-12           # normalized units


class Rig(NamedTuple):
    Kl: tuple           # fx, fy, cx, cy
    Kr: tuple
    Dl: tuple
    Dr: tuple
    R: tuple            # 9 values, row-major: X_r = R X_l + t
    t: tuple
    model: str          # "radtan" or "equidistant"
    width: int
    height: int

    @classmethod
    def of(cls, config: dict) -> "Rig":
        """The rig of a configuration file's `raw` table and `camera`
        size."""
        r, c = config["raw"], config["camera"]
        return cls(tuple(r["Kl"]), tuple(r["Kr"]), tuple(r["Dl"]),
                   tuple(r["Dr"]), tuple(r["R"]), tuple(r["t"]),
                   r.get("model", "radtan"), int(c["width"]),
                   int(c["height"]))


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64, device=device)


def _skew(w: torch.Tensor) -> torch.Tensor:
    z = torch.zeros((), dtype=F64, device=w.device)
    return torch.stack([torch.stack([z, -w[2], w[1]]),
                        torch.stack([w[2], z, -w[0]]),
                        torch.stack([-w[1], w[0], z])])


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: rotation vector [3] -> [3, 3]."""
    th = torch.linalg.vector_norm(w)
    K = _skew(w)
    eye = torch.eye(3, dtype=F64, device=w.device)
    if float(th) < 1e-12:
        return eye + K
    return (eye + torch.sin(th) / th * K
            + (1 - torch.cos(th)) / (th * th) * (K @ K))


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[3, 3] rotation (of less than pi) -> rotation vector [3]."""
    c = torch.clamp((torch.trace(R) - 1) / 2, -1.0, 1.0)
    th = torch.arccos(c)
    v = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    if float(th) < 1e-12:
        return v / 2
    return th / (2 * torch.sin(th)) * v


def rectifying_rotations(R_lr: torch.Tensor, t_lr: torch.Tensor):
    """(R_l, R_r): the rotations from each raw camera's frame into its
    rectified frame, for the right camera's pose in the left frame
    (X_l = R_lr X_r + t_lr)."""
    half = exp_so3(-0.5 * log_so3(R_lr))
    R_l, R_r = half, half @ R_lr
    e1 = R_l @ t_lr
    e1 = e1 / torch.linalg.vector_norm(e1)
    if float(e1[0]) < 0:
        e1 = -e1
    e2 = torch.stack([-e1[1], e1[0], torch.zeros((), dtype=F64,
                                                 device=e1.device)])
    e2 = e2 / torch.linalg.vector_norm(e2)
    e3 = torch.linalg.cross(e1, e2)
    rect = torch.stack([e1, e2, e3])
    return rect @ R_l, rect @ R_r


def rig_pose(rig: Rig, device=None):
    """(R_lr, t_lr): the right camera's pose in the left frame, from the
    file's cam0 -> cam1 transform, with the baseline toward +x of the
    left camera (as the dataset loader reads it)."""
    R = _t(rig.R, device).reshape(3, 3)
    t = _t(rig.t, device)
    R_lr, t_lr = R.T, -R.T @ t
    if float(t_lr[0]) < 0:
        R_lr, t_lr = R, t
    return R_lr, t_lr


def rectified_camera(rig: Rig) -> dict:
    """The rectified camera: fx = fy = the eyes' mean fx, the principal
    point at the image's centre, the baseline |t|."""
    f = 0.5 * (rig.Kl[0] + rig.Kr[0])
    return dict(fx=f, fy=f, cx=rig.width / 2.0, cy=rig.height / 2.0,
                b=math.sqrt(sum(v * v for v in rig.t)), width=rig.width,
                height=rig.height)


def distort(x: torch.Tensor, y: torch.Tensor, d, model: str):
    """Normalized undistorted (x, y) -> normalized distorted."""
    if model == "radtan":
        k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
        r2 = x * x + y * y
        radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
        return (x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x),
                y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y)
    if model == "equidistant":
        k1, k2, k3, k4 = (list(d) + [0.0] * 4)[:4]
        r = torch.clamp(torch.sqrt(x * x + y * y), min=1e-12)
        th = torch.arctan(r)
        t2 = th * th
        thd = th * (1 + k1 * t2 + k2 * t2 ** 2 + k3 * t2 ** 3 + k4 * t2 ** 4)
        return x * thd / r, y * thd / r
    raise ValueError(f"unknown distortion model {model!r}")


def undistort(xd: torch.Tensor, yd: torch.Tensor, d, model: str):
    """Normalized distorted -> normalized undistorted (x, y)."""
    if model == "radtan":
        k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
        x, y = xd.clone(), yd.clone()
        for _ in range(UNDISTORT_ITERS):
            r2 = x * x + y * y
            radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
            dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
            dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
            xn, yn = (xd - dx) / radial, (yd - dy) / radial
            step = float(torch.max(torch.abs(xn - x) + torch.abs(yn - y)))
            x, y = xn, yn
            if step < CONVERGED:
                break
        return x, y
    if model == "equidistant":
        k = (list(d) + [0.0] * 4)[:4]
        thd = torch.sqrt(xd * xd + yd * yd)
        th = thd.clone()
        for _ in range(UNDISTORT_ITERS):
            t2 = th * th
            f = th * (1 + k[0] * t2 + k[1] * t2 ** 2 + k[2] * t2 ** 3
                      + k[3] * t2 ** 4) - thd
            df = (1 + 3 * k[0] * t2 + 5 * k[1] * t2 ** 2 + 7 * k[2] * t2 ** 3
                  + 9 * k[3] * t2 ** 4)
            th = th - f / df
            if float(torch.max(torch.abs(f))) < CONVERGED:
                break
        s = torch.where(thd > 1e-12, torch.tan(th) / torch.clamp(
            thd, min=1e-12), torch.ones_like(thd))
        return xd * s, yd * s
    raise ValueError(f"unknown distortion model {model!r}")


def _K(k) -> tuple:
    return tuple(float(v) for v in k)


def rectify_maps(rig: Rig, device=None):
    """(map_l, map_r, cam): map_* float64 [H, W, 2], the raw source point
    (x, y) of every rectified pixel; cam the rectified camera."""
    R_lr, t_lr = rig_pose(rig, device)
    rots = rectifying_rotations(R_lr, t_lr)
    cam = rectified_camera(rig)
    v, u = torch.meshgrid(torch.arange(rig.height, dtype=F64, device=device),
                          torch.arange(rig.width, dtype=F64, device=device),
                          indexing="ij")
    rays = torch.stack([(u - cam["cx"]) / cam["fx"],
                        (v - cam["cy"]) / cam["fy"], torch.ones_like(u)], -1)
    maps = []
    for K, d, Rot in ((rig.Kl, rig.Dl, rots[0]), (rig.Kr, rig.Dr, rots[1])):
        fx, fy, cx, cy = _K(K)
        raw = rays @ Rot             # Rot^T applied: rectified -> raw frame
        xd, yd = distort(raw[..., 0] / raw[..., 2], raw[..., 1] / raw[..., 2],
                         d, rig.model)
        maps.append(torch.stack([fx * xd + cx, fy * yd + cy], -1))
    return maps[0], maps[1], cam


def remap(img: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """Bilinear sampling of img [..., H, W] at mp [Ho, Wo, 2] (x, y), in
    float64; taps outside the image read 0."""
    H, W = img.shape[-2:]
    x, y = mp[..., 0], mp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = img.to(F64).reshape(img.shape[:-2] + (H * W,))
    out = 0
    for dy, dx, w in ((0, 0, (1 - wx) * (1 - wy)), (0, 1, wx * (1 - wy)),
                      (1, 0, (1 - wx) * wy), (1, 1, wx * wy)):
        xi, yi = x0.long() + dx, y0.long() + dy
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = (torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1))
        v = flat[..., idx.reshape(-1)].reshape(img.shape[:-2] + idx.shape)
        out = out + torch.where(inb, v, torch.zeros_like(v)) * w
    return out


def raw_coords(rig: Rig, eye: int, device=None) -> torch.Tensor:
    """[H, W, 2] float64: for every raw pixel of eye 0 (left) or 1
    (right), the point (x, y) of the rectified image that it sees."""
    R_lr, t_lr = rig_pose(rig, device)
    Rot = rectifying_rotations(R_lr, t_lr)[eye]
    cam = rectified_camera(rig)
    fx, fy, cx, cy = _K(rig.Kl if eye == 0 else rig.Kr)
    d = rig.Dl if eye == 0 else rig.Dr
    v, u = torch.meshgrid(torch.arange(rig.height, dtype=F64, device=device),
                          torch.arange(rig.width, dtype=F64, device=device),
                          indexing="ij")
    x, y = undistort((u - cx) / fx, (v - cy) / fy, d, rig.model)
    ray = torch.stack([x, y, torch.ones_like(x)], -1) @ Rot.T
    return torch.stack([cam["cx"] + cam["fx"] * ray[..., 0] / ray[..., 2],
                        cam["cy"] + cam["fy"] * ray[..., 1] / ray[..., 2]],
                       -1)


def raw_from_rectified(imgs: torch.Tensor, rig: Rig, eye: int,
                       coords: torch.Tensor | None = None,
                       chunk: int = 32) -> torch.Tensor:
    """The raw frames [N, H, W] float32 (whole grey levels in 0..255) of
    eye 0 or 1 that see the rectified frames imgs [N, H, W]: each raw
    pixel samples its rectified point bilinearly, taps clamped to the
    rectified image's border.  `coords`: `raw_coords` of the eye, if
    already made."""
    if coords is None:
        coords = raw_coords(rig, eye, imgs.device)
    H, W = imgs.shape[-2:]
    x = torch.clamp(coords[..., 0], 0.0, W - 1.0).reshape(-1)
    y = torch.clamp(coords[..., 1], 0.0, H - 1.0).reshape(-1)
    x0 = torch.clamp(torch.floor(x), max=W - 2.0)
    y0 = torch.clamp(torch.floor(y), max=H - 2.0)
    wx, wy = x - x0, y - y0
    i00 = (y0 * W + x0).long()
    taps = ((i00, (1 - wx) * (1 - wy)), (i00 + 1, wx * (1 - wy)),
            (i00 + W, (1 - wx) * wy), (i00 + W + 1, wx * wy))
    out = torch.empty((imgs.shape[0],) + tuple(coords.shape[:2]),
                      dtype=torch.float32, device=imgs.device)
    for lo in range(0, imgs.shape[0], chunk):
        flat = imgs[lo:lo + chunk].reshape(-1, H * W).to(F64)
        acc = sum(flat[:, i] * w for i, w in taps)
        out[lo:lo + chunk] = torch.clamp(torch.round(acc), 0, 255).reshape(
            (-1,) + tuple(coords.shape[:2])).float()
    return out


def raw_pool(pool: tuple, config: dict) -> tuple:
    """(left, right) rendered rectified frames [N, H, W] -> the rig's raw
    frames of the same shape (the raw images are the rectified size)."""
    rig = Rig.of(config)
    return tuple(raw_from_rectified(imgs, rig, eye)
                 for eye, imgs in enumerate(pool))
