"""Realistic textured-world stereo renderer (hard synthetic benchmark;
numpy copy of stvo_pl_tpu/utils/world.py).

The stamp-scene generator (utils/synthetic.py) plants isolated textured
blobs — easy to match, unlike the natural imagery the reference targets
(/root/reference/app/imagesStVO.cpp:88-125 drives KITTI/EuRoC frames).
This module closes that realism gap without dataset downloads: a small
3-D world of *continuously textured surfaces* — ground plane, facade
walls, box occluders — ray-cast into rectified stereo pairs.

Realism ingredients (each a known failure source for detectors/matchers):
  * natural texture: real photographs shipped with matplotlib/pygame,
    mirror-tiled into large surface textures and mixed with multi-octave
    procedural noise (repetition + self-similar structure);
  * repeated structure: window grids painted on facades (repetitive
    corners that stress descriptor distinctiveness, plus crisp edges
    that feed the line detector);
  * occlusion: boxes at varying depth occlude the facades as the camera
    moves (features die and are reborn);
  * photometric nuisance: per-eye independent sensor noise, optional
    per-frame exposure variation/flicker, slight defocus blur.

Rendering is plain numpy (host-side, one-time fixture generation); this
is test/bench scaffolding like the reference's (absent) dataset tooling.
Where none of the installed packages' photographs is found (no
matplotlib), the port's own copy of matplotlib's sample photograph
(data/grace_hopper.jpg, a public-domain portrait) is used, so the world
is the reference's as a host with matplotlib alone would build it.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

_PHOTO_CANDIDATES = [
    # real photographs bundled with installed packages (natural texture)
    "matplotlib/mpl-data/sample_data/grace_hopper.jpg",
    "pygame/docs/generated/_images/intro_freedom.jpg",
    "pygame/docs/generated/_images/intro_blade.jpg",
    "pygame/examples/data/alien1.jpg",
]


# matplotlib's sample photograph, for hosts without matplotlib
_BUNDLED_PHOTO = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "data", "grace_hopper.jpg")


def _site_packages() -> str | None:
    try:
        import matplotlib
    except ImportError:
        return None
    return os.path.dirname(os.path.dirname(matplotlib.__file__))


def _read_gray(paths: list[str]) -> list[np.ndarray]:
    from PIL import Image
    return [np.asarray(Image.open(p).convert("L"), np.float32)
            for p in paths]


def load_photos() -> list[np.ndarray]:
    """Grayscale float32 real photographs found on disk: the installed
    packages' (_PHOTO_CANDIDATES), else the bundled copy of matplotlib's
    (make_world falls back to procedural texture when none is found)."""
    base = _site_packages()
    paths = [] if base is None else [
        os.path.join(base, rel) for rel in _PHOTO_CANDIDATES]
    paths = [p for p in paths if os.path.exists(p)]
    if not paths and os.path.exists(_BUNDLED_PHOTO):
        paths = [_BUNDLED_PHOTO]
    return _read_gray(paths)


def bundled_photos() -> list[np.ndarray]:
    """The bundled copy of matplotlib's sample photograph alone: the
    photograph set of a host with matplotlib and without pygame, whatever
    this host has installed."""
    return _read_gray([_BUNDLED_PHOTO])


def _mirror_tile(img: np.ndarray, reps_y: int, reps_x: int) -> np.ndarray:
    """Seamless tiling by mirroring alternate tiles."""
    rows = []
    for iy in range(reps_y):
        row = []
        for ix in range(reps_x):
            t = img
            if ix % 2:
                t = t[:, ::-1]
            if iy % 2:
                t = t[::-1]
            row.append(t)
        rows.append(np.concatenate(row, axis=1))
    return np.concatenate(rows, axis=0)


def _fractal_noise(rng, shape, octaves=4) -> np.ndarray:
    """Multi-octave value noise in [0, 1] (cheap Perlin stand-in)."""
    H, W = shape
    acc = np.zeros(shape, np.float32)
    amp, tot = 1.0, 0.0
    for o in range(octaves):
        h = max(2, H >> (octaves - 1 - o))
        w = max(2, W >> (octaves - 1 - o))
        coarse = rng.uniform(0, 1, (h, w)).astype(np.float32)
        ys = np.linspace(0, h - 1, H, dtype=np.float32)
        xs = np.linspace(0, w - 1, W, dtype=np.float32)
        y0 = np.clip(ys.astype(np.int32), 0, h - 2)
        x0 = np.clip(xs.astype(np.int32), 0, w - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        c = (coarse[y0][:, x0] * (1 - fy) * (1 - fx)
             + coarse[y0][:, x0 + 1] * (1 - fy) * fx
             + coarse[y0 + 1][:, x0] * fy * (1 - fx)
             + coarse[y0 + 1][:, x0 + 1] * fy * fx)
        acc += amp * c
        tot += amp
        amp *= 0.5
    return acc / tot


def _paint_windows(tex: np.ndarray, rng, rows=3, cols=8,
                   dark=0.35, frame=1.9) -> np.ndarray:
    """Repetitive window grid: dark panes with bright frames — repeated
    corners + long straight edges (what facades give LSD/ORB)."""
    H, W = tex.shape
    out = tex.copy()
    wh = H // (rows * 2 + 1)
    ww = W // (cols * 2 + 1)
    for r in range(rows):
        for c in range(cols):
            y0 = (2 * r + 1) * wh
            x0 = (2 * c + 1) * ww
            out[y0:y0 + wh, x0:x0 + ww] *= dark
            t = max(2, wh // 10)
            out[y0 - t:y0, x0 - t:x0 + ww + t] = \
                np.minimum(out[y0 - t:y0, x0 - t:x0 + ww + t] * frame, 235)
            out[y0 + wh:y0 + wh + t, x0 - t:x0 + ww + t] = \
                np.minimum(out[y0 + wh:y0 + wh + t,
                               x0 - t:x0 + ww + t] * frame, 235)
            out[y0:y0 + wh, x0 - t:x0] = \
                np.minimum(out[y0:y0 + wh, x0 - t:x0] * frame, 235)
            out[y0:y0 + wh, x0 + ww:x0 + ww + t] = \
                np.minimum(out[y0:y0 + wh, x0 + ww:x0 + ww + t] * frame, 235)
    return out


def _surface_texture(photo: np.ndarray, rng, reps=(3, 6), windows=False,
                     window_grid=(3, 8), size=(1024, 2048)) -> np.ndarray:
    """Natural-texture surface: mirror-tiled photo x fractal noise."""
    tiled = _mirror_tile(photo, *reps)
    # resample to target size (nearest is fine pre-noise)
    ys = np.linspace(0, tiled.shape[0] - 1, size[0]).astype(np.int32)
    xs = np.linspace(0, tiled.shape[1] - 1, size[1]).astype(np.int32)
    tex = tiled[ys][:, xs]
    noise = _fractal_noise(rng, size, octaves=5)
    tex = tex * (0.6 + 0.5 * noise) + 25.0 * noise
    if windows:
        tex = _paint_windows(tex, rng, rows=window_grid[0],
                             cols=window_grid[1])
    return np.clip(tex, 5, 250).astype(np.float32)


@dataclass
class Quad:
    """Textured finite plane: origin p0, edge vectors u, v (world)."""
    p0: np.ndarray
    u: np.ndarray
    v: np.ndarray
    tex: np.ndarray
    n: np.ndarray = field(init=False)

    def __post_init__(self):
        n = np.cross(self.u, self.v)
        self.n = (n / np.linalg.norm(n)).astype(np.float64)


@dataclass
class World:
    quads: list[Quad]
    noise_sigma: float = 2.0
    exposure_amp: float = 0.0     # sinusoidal exposure variation
    flicker_frame: int = -1       # one-frame exposure drop (adversarial)
    flicker_gain: float = 0.25
    seed: int = 0


def make_world(seed: int = 0, length: float = 120.0, half_width: float = 9.0,
               cam_height: float = 1.6, exposure_amp: float = 0.0,
               flicker_frame: int = -1,
               photos: list[np.ndarray] | None = None) -> World:
    """Street-canyon world: ground + two window facades + box occluders.
    KITTI-like scale (camera ~1.6 m above ground, ~9 m to each wall).
    `photos` pins the photograph set (default: load_photos(), which
    depends on the installed packages; [] for procedural texture alone)."""
    rng = np.random.default_rng(seed)
    if photos is None:
        photos = load_photos()
    if not photos:
        photos = [255.0 * _fractal_noise(rng, (512, 512), 5)]

    def photo(i):
        return photos[i % len(photos)]

    L = length
    # texture density must track LENGTH: the facade/ground textures map a
    # fixed texel grid onto the whole world, so a long world with the
    # original fixed sizes stretches to ~9 px/texel at viewing distance —
    # featureless blur that free-falls tracking (found by 1000-frame drift
    # runs).  sf = 1 for all lengths <= 120 keeps every
    # existing test world bit-identical.
    sf = max(1.0, L / 120.0)
    quads = [
        # ground plane: y = +cam_height (camera y points down in image
        # coords; world here is the camera start frame: x right, y down,
        # z forward)
        Quad(np.array([-half_width * 2, cam_height, -5.0]),
             np.array([4.0 * half_width, 0.0, 0.0]),
             np.array([0.0, 0.0, L + 15.0]),
             _surface_texture(photo(0), rng, reps=(4, int(8 * sf)),
                              size=(1024, int(4096 * sf)))),
        # left facade (x = -half_width), spans full length, 8 m tall.
        # texture rows follow v (height), cols follow u (length):
        # ~60 texels/m both ways, windows every ~4.5 m
        Quad(np.array([-half_width, cam_height, -5.0]),
             np.array([0.0, 0.0, L + 15.0]),
             np.array([0.0, -8.0, 0.0]),
             _surface_texture(photo(1), rng, reps=(2, int(24 * sf)),
                              windows=True,
                              window_grid=(2, int(30 * sf)),
                              size=(512, int(8192 * sf)))),
        # right facade (x = +half_width)
        Quad(np.array([half_width, cam_height, -5.0]),
             np.array([0.0, 0.0, L + 15.0]),
             np.array([0.0, -8.0, 0.0]),
             _surface_texture(photo(2), rng, reps=(2, int(24 * sf)),
                              windows=True,
                              window_grid=(2, int(30 * sf)),
                              size=(512, int(8192 * sf)))),
    ]
    # box occluders: fronto-facing textured quads at varying depth/side
    n_box = max(6, int(round(6 * sf)))
    for k in range(n_box):
        z = 14.0 + k * (L - 20.0) / n_box + rng.uniform(-3, 3)
        # keep the drive corridor CLEAR: the camera sways +-0.3 m around
        # x = 0 and the right eye rides another +0.54 m out, so a box
        # whose x-interval crosses ~[-0.9, 0.9] puts an eye INSIDE the
        # quad as the camera passes its z — one garbage frame, zero
        # stereo-consistent features, a full-motion coasting error
        # (found on textured60 frame 39, right eye only).  Boxes
        # draw from a side band with >=1.6 m clearance instead.
        w = rng.uniform(1.5, 3.0)
        if rng.uniform() < 0.5:
            x = rng.uniform(-half_width + 1.5, -2.5 - w)
        else:
            x = rng.uniform(2.5, half_width - 3.5)
        h = rng.uniform(1.2, 2.4)
        quads.append(Quad(
            np.array([x, cam_height - 0.05, z]),
            np.array([w, 0.0, 0.0]),
            np.array([0.0, -h, 0.0]),
            _surface_texture(photo(k + 1), rng, reps=(2, 2),
                             size=(256, 256))))
    return World(quads=quads, seed=seed, exposure_amp=exposure_amp,
                 flicker_frame=flicker_frame)


def render_view(world: World, T_wc: np.ndarray, cam,
                eye_shift: float) -> np.ndarray:
    """Ray-cast one eye: [H, W] float32 in [0, 255] (no noise/exposure —
    applied per-frame in render_sequence)."""
    H, W = cam.height, cam.width
    xs = (np.arange(W, dtype=np.float64) - cam.cx) / cam.fx
    ys = (np.arange(H, dtype=np.float64) - cam.cy) / cam.fy
    d_cam = np.stack(np.broadcast_arrays(
        xs[None, :], ys[:, None], np.ones((1, 1))), axis=-1)   # [H, W, 3]
    R = T_wc[:3, :3].astype(np.float64)
    o = T_wc[:3, 3].astype(np.float64) + R @ np.array([eye_shift, 0.0, 0.0])
    d_w = d_cam @ R.T                                           # [H, W, 3]

    img = np.full((H, W), 35.0, np.float32)
    # faint sky gradient so far background is not flat
    img += (8.0 * (np.arange(H, dtype=np.float32) / H))[:, None]
    zbuf = np.full((H, W), np.inf)
    for q in world.quads:
        # z-cull: skip quads fully behind the camera or far beyond the
        # horizon (long worlds carry dozens of occluder boxes; without the
        # cull the render cost grows linearly with world length).  World-z
        # is compared against the camera ORIGIN, which assumes a roughly
        # +z-facing view (true for the street/corridor worlds this module
        # builds); all four corners are tested so quads whose u/v have
        # opposite-sign z components cannot be wrongly culled.
        zs = (q.p0[2], q.p0[2] + q.u[2], q.p0[2] + q.v[2],
              q.p0[2] + q.u[2] + q.v[2])
        if max(zs) < o[2] + 0.2 or min(zs) > o[2] + 200.0:
            continue
        denom = d_w @ q.n
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = ((q.p0 - o) @ q.n) / denom
        X = o + t[..., None] * d_w
        rel = X - q.p0
        a = (rel @ q.u) / (q.u @ q.u)
        b = (rel @ q.v) / (q.v @ q.v)
        hit = (t > 0.2) & (a >= 0) & (a < 1) & (b >= 0) & (b < 1) \
            & (t < zbuf)
        th, tw = q.tex.shape
        ty = np.clip(b * (th - 1), 0, th - 1.001)
        tx = np.clip(a * (tw - 1), 0, tw - 1.001)
        y0 = ty.astype(np.int32)
        x0 = tx.astype(np.int32)
        fy = (ty - y0).astype(np.float32)
        fx = (tx - x0).astype(np.float32)
        y0 = np.where(hit, y0, 0)
        x0 = np.where(hit, x0, 0)
        sample = (q.tex[y0, x0] * (1 - fy) * (1 - fx)
                  + q.tex[y0, x0 + 1] * (1 - fy) * fx
                  + q.tex[y0 + 1, x0] * fy * (1 - fx)
                  + q.tex[y0 + 1, x0 + 1] * fy * fx)
        img = np.where(hit, sample, img)
        zbuf = np.where(hit, t, zbuf)
    return img.astype(np.float32)


def _blur3(img: np.ndarray) -> np.ndarray:
    """Slight defocus: separable [1 2 1]/4 blur."""
    p = np.pad(img, 1, mode="edge")
    h = 0.25 * (p[:, :-2] + 2 * p[:, 1:-1] + p[:, 2:])   # [H+2, W]
    return 0.25 * (h[:-2] + 2 * h[1:-1] + h[2:])         # [H, W]


def render_sequence(world: World, poses: np.ndarray, cam,
                    noise: bool = True):
    """[T, 4, 4] -> (seq_l [T, H, W], seq_r [T, H, W]) float32 frames with
    defocus blur, per-eye sensor noise, and exposure variation applied."""
    rng = np.random.default_rng(world.seed + 1234)
    seq_l, seq_r = [], []
    for i, T in enumerate(poses):
        il = _blur3(render_view(world, T, cam, 0.0))
        ir = _blur3(render_view(world, T, cam, cam.b))
        gain = 1.0
        if world.exposure_amp > 0:
            gain *= 1.0 + world.exposure_amp * np.sin(0.6 * i)
        if i == world.flicker_frame:
            gain *= world.flicker_gain
        il = il * gain
        ir = ir * gain
        if noise and world.noise_sigma > 0:
            il = il + rng.normal(0, world.noise_sigma, il.shape)
            ir = ir + rng.normal(0, world.noise_sigma, ir.shape)
        seq_l.append(np.clip(il, 0, 255).astype(np.float32))
        seq_r.append(np.clip(ir, 0, 255).astype(np.float32))
    return np.stack(seq_l), np.stack(seq_r)
