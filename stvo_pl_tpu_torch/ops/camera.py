"""Rectified pinhole stereo camera (port of stvo_pl_tpu/ops/camera.py;
reference src/pinholeStereoCamera.cpp): projection (:231-237),
back-projection (:221-229) and undistort-rectify maps for
radial-tangential and fisheye / equidistant stereo rigs (:48-121).

The rectification maps are computed once on the host in float64 (numpy,
Bouguet's algorithm) and applied on the device as a float32 bilinear
gather (`rectify_remap`, the cv::remap of :196-208).  `rectify_taps` turns
a rig's two maps into a constant of the device, the four source taps of
every rectified pixel and their weights, so that a frame's remap
(`remap_taps`, both eyes at once) is one gather and a weighted sum, equal
to `rectify_remap` bit for bit; the one-lane VO step can run it inside its
captured program (models/frontend.compile_vo_step).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class StereoCamera(NamedTuple):
    """Static rectified-stereo intrinsics (Python scalars)."""
    fx: float
    fy: float
    cx: float
    cy: float
    b: float          # baseline [m]
    width: int
    height: int

    @property
    def bfx(self) -> float:
        return self.b * self.fx


def project(cam: StereoCamera, P: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2] pixels."""
    z = P[..., 2]
    u = cam.cx + cam.fx * P[..., 0] / z
    v = cam.cy + cam.fy * P[..., 1] / z
    return torch.stack([u, v], dim=-1)


def back_project(cam: StereoCamera, uv: torch.Tensor,
                 disp: torch.Tensor) -> torch.Tensor:
    """[..., 2] pixels + [...] disparity -> [..., 3] points,
    P = (b/d) [u-cx, v-cy, fx]."""
    bd = cam.b / disp
    x = bd * (uv[..., 0] - cam.cx)
    y = bd * (uv[..., 1] - cam.cy)
    z = bd * cam.fx
    return torch.stack([x, y, z], dim=-1)


# ---------------------------------------------------------------------------
# Host-side rectification-map construction (numpy, once per dataset)
# ---------------------------------------------------------------------------

def _distort_radtan(x, y, d):
    k1, k2, p1, p2, k3 = (list(d) + [0.0] * 5)[:5]
    r2 = x * x + y * y
    radial = 1.0 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return xd, yd


def _distort_equidistant(x, y, d):
    k1, k2, k3, k4 = (list(d) + [0.0] * 4)[:4]
    r = np.sqrt(x * x + y * y)
    r = np.maximum(r, 1e-12)
    th = np.arctan(r)
    th2 = th * th
    thd = th * (1.0 + k1 * th2 + k2 * th2**2 + k3 * th2**3 + k4 * th2**4)
    scale = thd / r
    return x * scale, y * scale


def _rectifying_rotations(R: np.ndarray, t: np.ndarray):
    """Bouguet stereo rectification: split the relative rotation, then
    align the x-axis with the baseline (the capability of cv::stereoRectify
    as used at src/pinholeStereoCamera.cpp:82-91)."""
    from scipy.spatial.transform import Rotation
    rvec = Rotation.from_matrix(R).as_rotvec()
    # R maps right->left (X_l = R X_r + t, t = right cam origin in left
    # frame); split it so each camera rotates half-way toward the other
    # (parallel frames require R_r_new = R_l_new @ R).
    R_l = Rotation.from_rotvec(-0.5 * rvec).as_matrix()
    R_r = R_l @ R
    # align baseline with x axis
    t_new = R_l @ t
    e1 = t_new / np.linalg.norm(t_new)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross(np.array([0.0, 0.0, 1.0]), e1)
    e2 /= np.linalg.norm(e2)
    e3 = np.cross(e1, e2)
    Rrect = np.stack([e1, e2, e3], axis=0)
    return Rrect @ R_l, Rrect @ R_r


def build_rectify_maps(K_l: np.ndarray, d_l: np.ndarray, K_r: np.ndarray,
                       d_r: np.ndarray, R: np.ndarray, t: np.ndarray,
                       width: int, height: int, model: str = "radtan"):
    """(map_l, map_r, cam): map_* is [H, W, 2] float32 numpy, the source
    pixel (x, y) of every rectified pixel, for `rectify_remap`; cam is the
    rectified StereoCamera.  R, t: right-camera pose in the left frame
    (T_l_r).  model: "radtan" or "equidistant"."""
    if model not in ("radtan", "equidistant"):
        raise ValueError(f"unknown distortion model {model!r}")
    R_l, R_r = _rectifying_rotations(R, t)
    baseline = float(np.linalg.norm(t))

    # new projection: shared intrinsics (mean focal), principal point centered
    fx_new = 0.5 * (K_l[0, 0] + K_r[0, 0])
    fy_new = fx_new
    cx_new = width / 2.0
    cy_new = height / 2.0
    cam = StereoCamera(fx=float(fx_new), fy=float(fy_new), cx=float(cx_new),
                       cy=float(cy_new), b=baseline, width=int(width),
                       height=int(height))

    distort = _distort_radtan if model == "radtan" else _distort_equidistant

    maps = []
    for K, d, Rr in ((K_l, d_l, R_l), (K_r, d_r, R_r)):
        u, v = np.meshgrid(np.arange(width, dtype=np.float64),
                           np.arange(height, dtype=np.float64))
        # rectified pixel -> rectified normalized ray
        x = (u - cx_new) / fx_new
        y = (v - cy_new) / fy_new
        rays = np.stack([x, y, np.ones_like(x)], axis=-1)
        # rotate back into the original camera frame
        rays = rays @ Rr  # (R^T applied to rays) since Rr maps orig->rect
        xn = rays[..., 0] / rays[..., 2]
        yn = rays[..., 1] / rays[..., 2]
        xd, yd = distort(xn, yn, np.asarray(d, dtype=np.float64))
        us = K[0, 0] * xd + K[0, 2]
        vs = K[1, 1] * yd + K[1, 2]
        maps.append(np.stack([us, vs], axis=-1).astype(np.float32))
    return maps[0], maps[1], cam


class RectifyTaps(NamedTuple):
    """A rig's raw-to-rectified remap as a constant of the device
    (`rectify_taps`).  Taps are ordered (y0, x0), (y0, x0 + 1), (y0 + 1,
    x0), (y0 + 1, x0 + 1) around each rectified pixel's source point."""
    idx: torch.Tensor       # int64 [2, 4 * Ho * Wo]: each eye's taps, flat
    #                         raw-pixel indices clamped into the image
    wx: torch.Tensor        # float32 [2, 4, Ho * Wo]: 1 - wx, wx, 1 - wx,
    #                         wx; 0 for a tap outside the raw image
    wy: torch.Tensor        # float32 [2, 2, Ho * Wo]: 1 - wy, wy
    raw_hw: tuple           # (H, W) of the raw images
    out_hw: tuple           # (Ho, Wo) of the rectified images
    outside_share: float    # share of rectified pixels (both eyes) whose
    #                         source lies outside the raw image


def rectify_taps(map_l: np.ndarray, map_r: np.ndarray, raw_hw: tuple,
                 device=None) -> RectifyTaps:
    """The taps and weights of both eyes' maps ([Ho, Wo, 2] float32 source
    (x, y), as `build_rectify_maps` returns them) for raw images of
    `raw_hw`, on `device` ("cuda" unless the caller asks for the CPU).
    The weights are `rectify_remap`'s, computed by the same float32
    operations, with a tap outside the raw image weighted 0 where
    `rectify_remap` reads 0 there."""
    from stvo_pl_tpu_torch.device import resolve_device
    H, W = (int(v) for v in raw_hw)
    mp = torch.from_numpy(np.stack([map_l, map_r]).astype(np.float32)).to(
        resolve_device(device))
    Ho, Wo = mp.shape[1:3]
    x, y = mp[..., 0].reshape(2, -1), mp[..., 1].reshape(2, -1)
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    idx, w = [], []
    for dy, dx, wt in ((0, 0, 1 - wx), (0, 1, wx), (1, 0, 1 - wx),
                       (1, 1, wx)):
        yi, xi = y0i + dy, x0i + dx
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx.append(torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1))
        w.append(torch.where(inb, wt, torch.zeros_like(wt)))
    outside = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    return RectifyTaps(idx=torch.stack(idx, dim=1).reshape(2, -1),
                       wx=torch.stack(w, dim=1),
                       wy=torch.stack([1 - wy, wy], dim=1),
                       raw_hw=(H, W), out_hw=(int(Ho), int(Wo)),
                       outside_share=float(outside.float().mean()))


def remap_taps(imgs_l: torch.Tensor, imgs_r: torch.Tensor,
               taps: RectifyTaps) -> tuple[torch.Tensor, torch.Tensor]:
    """Both eyes' raw images [..., H, W] (on the taps' device) -> their
    rectified float32 images [..., Ho, Wo]: one gather of the four taps,
    then `top * (1 - wy) + bot * wy` with `top = s00 * (1 - wx) + s01 *
    wx`, the float32 operations of `rectify_remap`, so on finite images
    the two agree bit for bit."""
    H, W = taps.raw_hw
    lead = imgs_l.shape[:-2]
    n = taps.wx.shape[-1]
    flat = torch.stack([imgs_l, imgs_r], dim=-3).to(torch.float32).reshape(
        lead + (2, H * W))
    s = torch.gather(flat, -1, taps.idx.expand(lead + taps.idx.shape))
    p = s.view(lead + (2, 2, 2, n)) * taps.wx.view(2, 2, 2, n)
    q = (p[..., 0, :] + p[..., 1, :]) * taps.wy       # [..., eye, top/bot, n]
    out = (q[..., 0, :] + q[..., 1, :]).view(lead + (2,) + taps.out_hw)
    return out[..., 0, :, :].contiguous(), out[..., 1, :, :].contiguous()


def rectify_remap(img: torch.Tensor, mp: torch.Tensor) -> torch.Tensor:
    """Bilinear remap in float32: img [..., H, W], mp [Ho, Wo, 2] source
    (x, y) on the same device -> [..., Ho, Wo].  Out-of-bounds taps read
    0."""
    H, W = img.shape[-2:]
    x, y = mp[..., 0], mp[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape(img.shape[:-2] + (H * W,))

    def sample(yi, xi):
        inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)
        v = flat[..., idx.reshape(-1)].reshape(img.shape[:-2] + idx.shape)
        return torch.where(inb, v, torch.zeros_like(v))

    top = sample(y0i, x0i) * (1 - wx) + sample(y0i, x0i + 1) * wx
    bot = sample(y0i + 1, x0i) * (1 - wx) + sample(y0i + 1, x0i + 1) * wx
    return top * (1 - wy) + bot * wy
