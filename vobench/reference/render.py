"""The benchmark's traffic generator: procedural stereo sequences with a
known ground-truth trajectory, rendered on the device of a
`torch.Generator`.

A frozen copy of `stvo_pl_tpu_torch/utils/synthetic.py` (lines 26-60
`make_scene`, 63-88 `smooth_trajectory`, 117-184 `_splat_points` and
`_draw_lines`, 187-213 `render_sequence`, as of the commit that added this
benchmark), with the helpers it calls inlined: `project` from
`stvo_pl_tpu_torch/ops/camera.py:33-38`, `inverse_se3` and
`transform_points` from `stvo_pl_tpu_torch/ops/se3.py:18-21, 133-137,
163-167`.  It imports nothing of the program, so that no later change of
the program moves the benchmark's inputs or its truth.

The scene parameters are those of the repository's `bench.py`
(1,400 textured point landmarks, 64 bright line segments, extent
40 x 15 x 90 m, nearest plane at 5 m), and the trajectory moves 0.8 m per
frame; the traffic files pass them in.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

STAMP = 9        # rendered landmark stamp size (pixels)
BASE = 6         # per-landmark random texture resolution


class Camera(NamedTuple):
    """Rectified stereo pinhole camera (Python scalars)."""
    fx: float
    fy: float
    cx: float
    cy: float
    b: float          # baseline [m]
    width: int
    height: int


class Scene(NamedTuple):
    P: torch.Tensor           # [Np, 3] world points
    tex: torch.Tensor         # [Np, BASE, BASE] per-point texture
    brightness: torch.Tensor  # [Np]
    sA: torch.Tensor          # [Nl, 3] line segment endpoints (world)
    sB: torch.Tensor          # [Nl, 3]
    line_w: torch.Tensor      # [Nl] line brightness


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., n, k] @ [..., k, m] as elementwise products and a sum, in
    float32 whatever the matrix-multiply backends' precision switches."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def _inverse(T: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] rigid inverse."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    tinv = -_mm(Rt, T[..., :3, 3:4])
    bottom = torch.tensor([[0.0, 0.0, 0.0, 1.0]], dtype=T.dtype,
                          device=T.device).expand(T.shape[:-2] + (1, 4))
    return torch.cat([torch.cat([Rt, tinv], dim=-1), bottom], dim=-2)


def _transform(T: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    """Apply [..., 4, 4] to points [..., N, 3]."""
    return (_mm(P, T[..., :3, :3].transpose(-1, -2))
            + T[..., :3, 3][..., None, :])


def _project(cam: Camera, P: torch.Tensor) -> torch.Tensor:
    """[..., 3] camera-frame points -> [..., 2] pixels."""
    z = P[..., 2]
    return torch.stack([cam.cx + cam.fx * P[..., 0] / z,
                        cam.cy + cam.fy * P[..., 1] / z], dim=-1)


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


def smooth_trajectory(n_frames: int, speed=0.6,
                      yaw_rate=0.004) -> np.ndarray:
    """[T, 4, 4] camera-to-world poses in float64: forward motion with
    gentle yaw and a small sinusoidal sway."""
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
    return np.stack(poses)


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


def render_sequence(scene: Scene, poses: torch.Tensor, cam: Camera):
    """[T, 4, 4] float32 camera-to-world poses on the scene's device ->
    (left [T, H, W], right [T, H, W]) grayscale frames in [0, 255]."""
    H, W = cam.height, cam.width
    dev = scene.P.device
    T_cw = _inverse(poses)
    Pc = _transform(T_cw, scene.P)
    sAc = _transform(T_cw, scene.sA)
    sBc = _transform(T_cw, scene.sB)
    far = torch.tensor([0.0, 0.0, 1e3], device=dev)

    def eye(shift):
        off = torch.tensor([shift, 0.0, 0.0], device=dev)
        Pe, sAe, sBe = Pc - off, sAc - off, sBc - off
        z = Pe[..., 2]
        uv = _project(cam, torch.where(z[..., None] > 0.5, Pe, far))
        yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
        xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
        base = 40.0 + 10.0 * (xx / W) + 6.0 * (yy / H)
        img = base.expand(poses.shape[0], H, W).contiguous()
        img = _splat_points(img, uv, z, scene.tex, scene.brightness, H, W)
        vis = (sAe[..., 2] > 0.5) & (sBe[..., 2] > 0.5)
        sa_uv = _project(cam, torch.where(vis[..., None], sAe, far))
        sb_uv = _project(cam, torch.where(vis[..., None], sBe, far))
        img = _draw_lines(img, sa_uv, sb_uv, vis, scene.line_w, H, W)
        return torch.clamp(img, 0.0, 255.0)

    return eye(0.0), eye(cam.b)


def lane_seed(seed: int, lane: int) -> int:
    """The scene seed of one lane: a 64-bit mix of the run's seed and the
    lane, so that every lane of every seed gets its own scene."""
    ss = np.random.SeedSequence([int(seed) & (2 ** 64 - 1), int(lane)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> 1)


def render_pool(seed: int, lanes: int, cam: Camera, scene_kw: dict,
                n_frames: int, speed: float, device):
    """`lanes` sequences, each through a scene of its own, rendered on
    `device`: (left, right) [lanes * n_frames, H, W] float32 in [0, 255]
    (sequence-major), and the true camera-to-world poses
    [n_frames, 4, 4] float64, the same trajectory through every scene."""
    truth = smooth_trajectory(n_frames, speed=speed)
    poses = torch.tensor(truth, dtype=torch.float32, device=device)
    H, W = cam.height, cam.width
    left = torch.empty((lanes * n_frames, H, W), dtype=torch.float32,
                       device=device)
    right = torch.empty_like(left)
    for lane in range(lanes):
        gen = torch.Generator(device=device)
        gen.manual_seed(lane_seed(seed, lane))
        scene = make_scene(gen, **scene_kw)
        lo = lane * n_frames
        left[lo:lo + n_frames], right[lo:lo + n_frames] = render_sequence(
            scene, poses, cam)
    return left, right, truth
