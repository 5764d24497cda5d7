"""Procedural stereo sequences with a known ground-truth trajectory (port
of stvo_pl_tpu/utils/synthetic.py): a random 3-D world of textured point
landmarks and bright line segments rendered into rectified stereo pairs,
all frames of a sequence at once, on the device of the scene's tensors.

`street_trajectory` drives the textured street canyon of utils/world.py
and `render_stereo` renders one pose.  `render_depth` gives the left eye's
metric depth maps of the same sequence, for the RGB-D front end (an
addition of the port: the JAX package's renderer has no depth output).

`make_scene` draws from a `torch.Generator`, so the same seed gives other
scenes than the JAX package's; to render the JAX package's scene, build a
`Scene` from its arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from stvo_pl_tpu_torch.ops import camera as cam_ops
from stvo_pl_tpu_torch.ops import se3

STAMP = 9        # rendered landmark stamp size (pixels)
BASE = 6         # per-landmark random texture resolution


class Scene(NamedTuple):
    P: torch.Tensor           # [Np, 3] world points
    tex: torch.Tensor         # [Np, BASE, BASE] per-point texture
    brightness: torch.Tensor  # [Np]
    sA: torch.Tensor          # [Nl, 3] line segment endpoints (world)
    sB: torch.Tensor          # [Nl, 3]
    line_w: torch.Tensor      # [Nl] line brightness


def make_scene(generator: torch.Generator, n_points=600, n_lines=48,
               extent=(30.0, 12.0, 60.0), z_near=4.0) -> Scene:
    """Random scene on the generator's device."""
    dev = generator.device
    ex, ey, ez = extent

    def uniform(shape, lo, hi):
        lo = torch.as_tensor(lo, dtype=torch.float32, device=dev)
        hi = torch.as_tensor(hi, dtype=torch.float32, device=dev)
        u = torch.rand(shape, generator=generator, device=dev)
        return lo + u * (hi - lo)

    P = uniform((n_points, 3), [-ex, -ey, z_near], [ex, ey, z_near + ez])
    tex = uniform((n_points, BASE, BASE), 0.0, 1.0)
    brightness = uniform((n_points,), 90.0, 200.0)
    A = uniform((n_lines, 3), [-ex, -ey, z_near + 2.0],
                [ex, ey, z_near + ez])
    d = torch.randn((n_lines, 3), generator=generator, device=dev)
    d = d * torch.tensor([1.0, 3.0, 1.0], device=dev)  # vertical bias
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)
    length = uniform((n_lines, 1), 3.0, 10.0)
    line_w = uniform((n_lines,), 60.0, 140.0)
    return Scene(P=P, tex=tex, brightness=brightness, sA=A, sB=A + d * length,
                 line_w=line_w)


def smooth_trajectory(n_frames: int, speed=0.6, yaw_rate=0.004,
                      device="cpu", dtype=torch.float32) -> torch.Tensor:
    """[T, 4, 4] camera-to-world poses: forward motion with gentle yaw and
    a small sinusoidal sway (computed in float64 on the host)."""
    from scipy.linalg import expm
    poses = []
    T = np.eye(4, dtype=np.float64)
    for i in range(n_frames):
        poses.append(T.copy())
        xi = np.array([
            0.02 * np.sin(0.05 * i),
            0.005 * np.sin(0.03 * i),
            speed,
            0.001 * np.sin(0.02 * i),
            yaw_rate * np.sin(0.01 * i + 0.5),
            0.0005 * np.cos(0.04 * i),
        ])
        W = np.zeros((4, 4))
        W[:3, 3] = xi[:3]
        wx, wy, wz = xi[3:]
        W[:3, :3] = np.array([[0, -wz, wy], [wz, 0, -wx], [-wy, wx, 0]])
        T = T @ expm(W)
    return torch.tensor(np.stack(poses), dtype=dtype, device=device)


def street_trajectory(n_frames: int, speed=0.8, sway=0.3, bob=0.06,
                      yaw_amp=0.008, pitch_amp=0.004, device="cpu",
                      dtype=torch.float32) -> torch.Tensor:
    """[T, 4, 4] camera-to-world poses for a street-canyon world
    (utils/world.py): straight forward motion with BOUNDED sinusoidal
    sway / bob / yaw / pitch, so the camera stays inside the canyon for any
    horizon (smooth_trajectory's integrated increments random-walk out of
    it on long runs).  Computed in float64 on the host."""
    poses = []
    for i in range(n_frames):
        x = sway * np.sin(2 * np.pi * i / 140.0)
        y = -bob * np.sin(2 * np.pi * i / 90.0)
        z = speed * i
        yaw = yaw_amp * np.sin(2 * np.pi * i / 200.0)
        pitch = pitch_amp * np.sin(2 * np.pi * i / 170.0)
        cy_, sy_ = np.cos(yaw), np.sin(yaw)
        cp, sp = np.cos(pitch), np.sin(pitch)
        Ry = np.array([[cy_, 0, sy_], [0, 1, 0], [-sy_, 0, cy_]])
        Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
        T = np.eye(4)
        T[:3, :3] = Ry @ Rx
        T[:3, 3] = (x, y, z)
        poses.append(T)
    return torch.tensor(np.stack(poses), dtype=dtype, device=device)


def _splat_points(img, uv, z, tex, brightness, H, W):
    """Scatter textured stamps at projected positions into img [T, H, W];
    uv [T, Np, 2], z [T, Np]."""
    T_, n = uv.shape[:2]
    dev = img.device
    fl = torch.floor(uv)
    u0 = fl[..., 0].to(torch.int64) - STAMP // 2
    v0 = fl[..., 1].to(torch.int64) - STAMP // 2
    fu = uv[..., 0] - fl[..., 0]
    fv = uv[..., 1] - fl[..., 1]

    g = torch.arange(STAMP, dtype=torch.float32, device=dev)
    sy = ((g[None, None, :, None] - fv[..., None, None]) * (BASE - 1)
          / (STAMP - 1))
    sx = ((g[None, None, None, :] - fu[..., None, None]) * (BASE - 1)
          / (STAMP - 1))
    sy = torch.clamp(sy, 0.0, BASE - 1.001)
    sx = torch.clamp(sx, 0.0, BASE - 1.001)
    ty0 = torch.floor(sy).to(torch.int64)
    tx0 = torch.floor(sx).to(torch.int64)
    wy = sy - ty0
    wx = sx - tx0
    tex_flat = tex.reshape(n, BASE * BASE)

    def t_at(yy, xx):
        idx = (yy * BASE + xx).expand(T_, n, STAMP, STAMP)
        src = tex_flat[None].expand(T_, n, BASE * BASE)
        return torch.gather(src, 2, idx.reshape(T_, n, -1)).reshape(
            T_, n, STAMP, STAMP)

    stamp = (t_at(ty0, tx0) * (1 - wy) * (1 - wx)
             + t_at(ty0, tx0 + 1) * (1 - wy) * wx
             + t_at(ty0 + 1, tx0) * wy * (1 - wx)
             + t_at(ty0 + 1, tx0 + 1) * wy * wx)
    cy = (STAMP - 1) / 2.0
    r2 = ((g[:, None] - cy) ** 2 + (g[None, :] - cy) ** 2) / (cy * cy)
    fall = torch.clamp(1.0 - r2, min=0.0)
    visible = ((z > 0.5) & (uv[..., 0] > -STAMP) & (uv[..., 0] < W + STAMP)
               & (uv[..., 1] > -STAMP) & (uv[..., 1] < H + STAMP))
    stamp = (stamp * fall * brightness[None, :, None, None]
             * visible[..., None, None])

    gi = torch.arange(STAMP, device=dev)
    yy = torch.clamp(v0[..., None, None] + gi[:, None], 0, H - 1)
    xx = torch.clamp(u0[..., None, None] + gi[None, :], 0, W - 1)
    frame = torch.arange(T_, device=dev)[:, None, None, None]
    flat_idx = (frame * (H * W) + yy * W + xx).reshape(-1)
    out = img.reshape(-1).index_add(0, flat_idx, stamp.reshape(-1))
    return out.reshape(T_, H, W)


def _draw_lines(img, sa_uv, sb_uv, vis, w, H, W):
    """Additive anti-aliased segments via a distance field per line, in
    line order; img [T, H, W], endpoints [T, Nl, 2], vis [T, Nl]."""
    dev = img.device
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    for li in range(sa_uv.shape[1]):
        a = sa_uv[:, li, :, None, None]          # [T, 2, 1, 1]
        d = sb_uv[:, li, :, None, None] - a
        L2 = torch.clamp(torch.sum(d * d, dim=1), min=1e-6)   # [T, 1, 1]
        t = ((xx - a[:, 0]) * d[:, 0] + (yy - a[:, 1]) * d[:, 1]) / L2
        t = torch.clamp(t, 0.0, 1.0)
        px = a[:, 0] + t * d[:, 0]
        py = a[:, 1] + t * d[:, 1]
        dist2 = (xx - px) ** 2 + (yy - py) ** 2
        v = vis[:, li].to(img.dtype)[:, None, None]
        img = img + w[li] * torch.exp(-dist2 / (2.0 * 0.8 ** 2)) * v
    return img


def render_sequence(scene: Scene, poses: torch.Tensor,
                    cam: cam_ops.StereoCamera):
    """[T, 4, 4] camera-to-world poses -> (left [T, H, W], right [T, H, W])
    grayscale frames in [0, 255]."""
    H, W = cam.height, cam.width
    dev = scene.P.device
    T_cw = se3.inverse_se3(poses)
    Pc = se3.transform_points(T_cw, scene.P)
    sAc = se3.transform_points(T_cw, scene.sA)
    sBc = se3.transform_points(T_cw, scene.sB)
    far = torch.tensor([0.0, 0.0, 1e3], device=dev)

    def eye(shift):
        off = torch.tensor([shift, 0.0, 0.0], device=dev)
        Pe, sAe, sBe = Pc - off, sAc - off, sBc - off
        z = Pe[..., 2]
        uv = cam_ops.project(cam, torch.where(z[..., None] > 0.5, Pe, far))
        yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        base = 40.0 + 10.0 * (xx / W) + 6.0 * (yy / H)
        img = base.expand(poses.shape[0], H, W).contiguous()
        img = _splat_points(img, uv, z, scene.tex, scene.brightness, H, W)
        vis = (sAe[..., 2] > 0.5) & (sBe[..., 2] > 0.5)
        sa_uv = cam_ops.project(cam, torch.where(vis[..., None], sAe, far))
        sb_uv = cam_ops.project(cam, torch.where(vis[..., None], sBe, far))
        img = _draw_lines(img, sa_uv, sb_uv, vis, scene.line_w, H, W)
        return torch.clamp(img, 0.0, 255.0)

    return eye(0.0), eye(cam.b)


def render_stereo(scene: Scene, T_wc: torch.Tensor,
                  cam: cam_ops.StereoCamera):
    """The (left [H, W], right [H, W]) pair seen from one camera-to-world
    pose T_wc [4, 4]."""
    left, right = render_sequence(scene, T_wc[None], cam)
    return left[0], right[0]


def render_depth(scene: Scene, poses: torch.Tensor,
                 cam: cam_ops.StereoCamera) -> torch.Tensor:
    """[T, 4, 4] camera-to-world poses -> [T, H, W] metric depth of the
    left eye's frames as a registered depth camera would give it: the z of
    the nearest landmark whose stamp covers the pixel, or of the nearest
    line within 1.5 px (1 / z interpolated along the projected segment),
    and 0 (no measurement) where the frame shows only background."""
    H, W = cam.height, cam.width
    dev = scene.P.device
    T_ = poses.shape[0]
    T_cw = se3.inverse_se3(poses)
    Pc = se3.transform_points(T_cw, scene.P)
    sAc = se3.transform_points(T_cw, scene.sA)
    sBc = se3.transform_points(T_cw, scene.sB)
    far = torch.tensor([0.0, 0.0, 1e3], device=dev)
    inf = torch.full((), float("inf"), device=dev)

    # landmarks: the stamp window of _splat_points, nearest z wins
    z = Pc[..., 2]
    uv = cam_ops.project(cam, torch.where(z[..., None] > 0.5, Pc, far))
    fl = torch.floor(uv)
    u0 = fl[..., 0].to(torch.int64) - STAMP // 2
    v0 = fl[..., 1].to(torch.int64) - STAMP // 2
    gi = torch.arange(STAMP, device=dev)
    yy = v0[..., None, None] + gi[:, None]
    xx = u0[..., None, None] + gi[None, :]
    inside = ((z > 0.5)[..., None, None] & (yy >= 0) & (yy < H) & (xx >= 0)
              & (xx < W))
    frame = torch.arange(T_, device=dev)[:, None, None, None]
    flat_idx = (frame * (H * W) + torch.clamp(yy, 0, H - 1) * W
                + torch.clamp(xx, 0, W - 1)).reshape(-1)
    zz = torch.where(inside, z[..., None, None], inf).reshape(-1)
    depth = torch.full((T_ * H * W,), float("inf"), device=dev)
    depth = depth.scatter_reduce(0, flat_idx, zz, "amin").reshape(T_, H, W)

    # lines: the distance field of _draw_lines
    vis = (sAc[..., 2] > 0.5) & (sBc[..., 2] > 0.5)
    sa_uv = cam_ops.project(cam, torch.where(vis[..., None], sAc, far))
    sb_uv = cam_ops.project(cam, torch.where(vis[..., None], sBc, far))
    py = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    px = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    for li in range(sa_uv.shape[1]):
        a = sa_uv[:, li, :, None, None]
        d = sb_uv[:, li, :, None, None] - a
        L2 = torch.clamp(torch.sum(d * d, dim=1), min=1e-6)
        t = ((px - a[:, 0]) * d[:, 0] + (py - a[:, 1]) * d[:, 1]) / L2
        t = torch.clamp(t, 0.0, 1.0)
        dist2 = ((px - a[:, 0] - t * d[:, 0]) ** 2
                 + (py - a[:, 1] - t * d[:, 1]) ** 2)
        za = sAc[:, li, 2, None, None]
        zb = sBc[:, li, 2, None, None]
        zl = 1.0 / ((1.0 - t) / za + t / zb)
        on = (dist2 <= 1.5 ** 2) & vis[:, li, None, None]
        depth = torch.where(on, torch.minimum(depth, zl), depth)
    return torch.where(torch.isfinite(depth), depth,
                       torch.zeros_like(depth))
