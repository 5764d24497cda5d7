"""Patch sets for ORB's orientation-binned descriptor, shared by the CPU
tests (tests/test_torch_orb.py) and the card's (tests/test_torch_orb_cuda.py).

`boundary_patches` builds float32 33 x 33 patches whose quantized
intensity-centroid moments are chosen integers: angles 2e-6 and 8e-6 rad
on both sides of each of the 30 bin boundaries, the bin centres, the
angle pi itself, zero moments (constant, point-symmetric and all-zero
patches) and saturated ones (0 / 255 halves, values far outside 0..255),
then seeded random patches.  Values sit off the integer grid by up to
0.5 (exact halves on even integers, which round to them), so the
quantization is exercised too.  Numpy only: no JAX, no torch."""

import numpy as np

P, R = 33, 16
N_BINS = 30
DELTAS = (2e-6, 8e-6)       # rad from a bin boundary


def disc():
    """(dx, dy, mask) over the patch: the radius-15 centroid disc."""
    d = np.arange(P) - R
    dy, dx = np.meshgrid(d, d, indexing="ij")
    return dx, dy, (dx * dx + dy * dy) <= 15 * 15


def moments(q: np.ndarray):
    """Integer moments (m10, m01) of quantized patches [..., P, P]."""
    dx, dy, m = disc()
    q = q.astype(np.int64)
    return (q * dx * m).sum((-2, -1)), (q * dy * m).sum((-2, -1))


def _lattice_near(theta: float, lo: int = 100_000, hi: int = 180_000):
    """Integer (m10, m01) of length in [lo, hi) whose angle is nearest
    theta."""
    r = np.arange(lo, hi, dtype=np.float64)
    a, b = np.round(r * np.cos(theta)), np.round(r * np.sin(theta))
    err = np.abs(np.angle(np.exp(1j * (np.arctan2(b, a) - theta))))
    i = int(np.argmin(err))
    return int(a[i]), int(b[i])


def _with_moments(m10: int, m01: int, rng) -> np.ndarray:
    """Integer patch in 0..255 with moments exactly (m10, m01): a ramp
    along the angle with noise, its residual moved out along the middle
    row (dy = 0 moves m10 alone) and the middle column (dx = 0, m01)."""
    dx, dy, mask = disc()
    n2 = float((dx * dx * mask).sum())
    q = np.clip(np.round(128 + (m10 * dx + m01 * dy) / n2
                         + rng.normal(0, 4, (P, P))), 0, 255)
    for axis, target in ((0, m10), (1, m01)):
        r = target - int(moments(q)[axis])
        for d in range(15, 0, -1):
            for o in (d, -d):
                px = (R, R + o) if axis == 0 else (R + o, R)
                t = int(np.sign(r) * np.sign(o))
                room = 255 - q[px] if t > 0 else q[px]
                n = min(abs(r) // d, int(room))
                q[px] += t * n
                r -= o * t * n
        assert r == 0, "the residual moment did not fit"
    assert tuple(int(m) for m in moments(q)) == (m10, m01)
    return q


def _off_grid(q: np.ndarray, rng) -> np.ndarray:
    """Float patch that quantizes back to q: offsets within +-0.49, exact
    +-0.5 on even values, far below 0 or above 255 where saturated."""
    off = rng.uniform(-0.49, 0.49, q.shape)
    half = (q % 2 == 0) & (rng.random(q.shape) < 0.2)
    off = np.where(half, np.where(rng.random(q.shape) < 0.5, -0.5, 0.5), off)
    x = q + off
    x = np.where(q == 0, np.where(rng.random(q.shape) < 0.5,
                                  -rng.uniform(0.5, 300, q.shape), x), x)
    x = np.where(q == 255, np.where(rng.random(q.shape) < 0.5,
                                    rng.uniform(255.5, 600, q.shape), x), x)
    return x.astype(np.float32)


def boundary_angles():
    """Every near-boundary and centre angle."""
    step = 2 * np.pi / N_BINS
    out = []
    for b in range(N_BINS):
        edge = (b + 0.5) * step
        out += [edge + s * d for d in DELTAS for s in (-1, 1)]
        out.append(b * step)
    return out


def expected_bins(q: np.ndarray) -> np.ndarray:
    """Orientation bin of quantized patches [K, P, P] from their exact
    moments in float64, -1 where the angle lies within 2e-7 rad of a bin
    boundary (float32 rounding decides there: at 90 and 270 degrees the
    2e-6 targets land on the boundary, since m10 = 0 is the nearest
    lattice point)."""
    m10, m01 = moments(q)
    zero = (m10 == 0) & (m01 == 0)
    u = np.where(zero, 0.0, np.arctan2(m01, m10)) * N_BINS / (2 * np.pi)
    tie = np.abs(u - np.floor(u) - 0.5) < 2e-7 * N_BINS / (2 * np.pi)
    return np.where(tie, -1, np.round(u).astype(np.int64) % N_BINS)


def boundary_patches(seed: int = 0, n_random: int = 256):
    """float32 patches [K, 33, 33] and each one's expected orientation
    bin (`expected_bins`)."""
    rng = np.random.default_rng(seed)
    qs = [_with_moments(*_lattice_near(theta), rng)
          for theta in boundary_angles()]
    # the angle pi: m01 = 0 exactly, m10 < 0
    qs.append(_with_moments(-150_000, 0, rng))
    # zero moments: bin 0, cos 1, sin 0 (a patch equal to itself turned
    # by 180 degrees has none)
    v = rng.integers(0, 128, (P, P))
    for q in (np.zeros((P, P)), np.full((P, P), 255.0),
              np.full((P, P), 77.0), v + v[::-1, ::-1]):
        assert moments(q) == (0, 0)
        qs.append(q.astype(np.float64))
    # saturated halves: 0 on one side of a line, 255 on the other
    dx, dy, _ = disc()
    for ang in np.linspace(0, 2 * np.pi, 12, endpoint=False):
        qs.append(np.where(dx * np.cos(ang) + dy * np.sin(ang) > 0, 255.0,
                           0.0))
    x = np.concatenate([_off_grid(np.stack(qs), rng),
                        random_patches(rng, n_random)])
    return x, expected_bins(np.clip(np.round(x), 0, 255))


def random_patches(rng, k: int) -> np.ndarray:
    """Seeded random float32 patches: a level, a gradient and noise."""
    dx, dy, _ = disc()
    base = rng.uniform(20, 235, (k, 1, 1))
    g = rng.normal(0, 3, (k, 2, 1, 1))
    p = base + g[:, 0] * dx + g[:, 1] * dy + rng.normal(0, 25, (k, P, P))
    return np.clip(p, -20, 280).astype(np.float32)
