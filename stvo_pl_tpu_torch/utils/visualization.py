"""Offline visualization: trajectory, covariance, feature overlays (numpy
copy of stvo_pl_tpu/utils/visualization.py).

Capability replacement for the reference's optional MRPT live scene
(src/sceneRepresentation.cpp:263-504 — trajectory line, covariance
ellipsoid, camera frustum, image + feature overlay) as offline matplotlib
renders; no GUI dependency.
"""

from __future__ import annotations

import numpy as np


def plot_run(path: str, poses: np.ndarray, stats: list[dict] | None = None,
             gt_poses: np.ndarray | None = None,
             cov: np.ndarray | None = None):
    """Trajectory top-down + stats panel (the MRPT scene, offline).

    `cov` (6x6 pose covariance, translation block first) draws the 2-sigma
    x/z uncertainty ellipse at the final pose — the MRPT covariance
    ellipsoid (src/sceneRepresentation.cpp:345-348) in the top-down view.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3 if stats else 1, figsize=(15, 5))
    axes = np.atleast_1d(axes)

    ax = axes[0]
    xyz = poses[:, :3, 3]
    ax.plot(xyz[:, 0], xyz[:, 2], "-", lw=1.5, label="estimate")
    if gt_poses is not None:
        g = gt_poses[:, :3, 3]
        ax.plot(g[:, 0], g[:, 2], "--", lw=1.0, label="ground truth")
    if cov is not None:
        c2 = np.asarray(cov)[np.ix_([0, 2], [0, 2])]  # x/z translation block
        w, v = np.linalg.eigh(c2)
        t = np.linspace(0.0, 2.0 * np.pi, 64)
        ell = (v * (2.0 * np.sqrt(np.maximum(w, 0.0)))) @ np.stack(
            [np.cos(t), np.sin(t)])
        ax.plot(xyz[-1, 0] + ell[0], xyz[-1, 2] + ell[1], "-", lw=0.8,
                color="gray", label="2-sigma cov")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.set_title("trajectory (top-down)")

    if stats:
        errs = [s["err"] for s in stats]
        ms = [s["ms"] for s in stats]
        npt = [s["npt"] for s in stats]
        nls = [s["nls"] for s in stats]
        axes[1].plot(errs, lw=0.8)
        axes[1].set_title("residual norm")
        axes[1].set_xlabel("frame")
        axes[2].plot(npt, lw=0.8, label="pt inliers")
        axes[2].plot(nls, lw=0.8, label="ls inliers")
        axes[2].set_title("inlier counts")
        axes[2].set_xlabel("frame")
        axes[2].legend()

    fig.tight_layout()
    fig.savefig(path, dpi=110)
    import matplotlib.pyplot as plt
    plt.close(fig)


def plot_frame_features(path: str, img: np.ndarray, points=None, lines=None):
    """Feature overlay on one image (reference plotStereoFrame,
    src/stereoFrame.cpp:618-663)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)
    if points is not None:
        uv = np.asarray(points.uv)[np.asarray(points.valid)]
        ax.plot(uv[:, 0], uv[:, 1], "o", ms=2.5, mfc="none", mec="lime",
                mew=0.8)
    if lines is not None:
        v = np.asarray(lines.valid)
        sp = np.asarray(lines.spl)[v]
        ep = np.asarray(lines.epl)[v]
        for a, b in zip(sp, ep):
            ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="red", lw=1.0)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_pair_matches(path: str, img1: np.ndarray, img2: np.ndarray,
                      uv1: np.ndarray, uv2: np.ndarray,
                      valid: np.ndarray | None = None,
                      lines1: np.ndarray | None = None,
                      lines2: np.ndarray | None = None,
                      lines_valid: np.ndarray | None = None):
    """Side-by-side match rendering.

    Capability of the reference's plotLeftPair
    (src/stereoFrameHandler.cpp:1222-1284) and drawLineMatches
    (3rdparty/line_descriptor/src/draw_custom.cpp): two images side by
    side, matched points connected, matched line segments drawn in the
    same per-match color on both sides.  `uv1`/`uv2` are [N,2] matched
    point observations; `lines1`/`lines2` are [M,2,2] (sp, ep) matched
    segments.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1]), np.float32)
    canvas[:img1.shape[0], :w1] = img1
    canvas[:img2.shape[0], w1:] = img2

    fig, ax = plt.subplots(figsize=(14, 4))
    ax.imshow(canvas, cmap="gray", vmin=0, vmax=255)
    rng = np.random.default_rng(7)

    if uv1 is not None and len(uv1):
        uv1 = np.asarray(uv1, np.float64)
        uv2 = np.asarray(uv2, np.float64)
        keep = (np.ones(len(uv1), bool) if valid is None
                else np.asarray(valid, bool))
        for a, b in zip(uv1[keep], uv2[keep]):
            c = rng.uniform(0.15, 1.0, 3)
            ax.plot([a[0], b[0] + w1], [a[1], b[1]], "-", lw=0.5, color=c,
                    alpha=0.7)
            ax.plot(a[0], a[1], "o", ms=2.5, mfc="none", mec=c, mew=0.8)
            ax.plot(b[0] + w1, b[1], "o", ms=2.5, mfc="none", mec=c, mew=0.8)

    if lines1 is not None and len(lines1):
        lines1 = np.asarray(lines1, np.float64)
        lines2 = np.asarray(lines2, np.float64)
        keep = (np.ones(len(lines1), bool) if lines_valid is None
                else np.asarray(lines_valid, bool))
        for s1, s2 in zip(lines1[keep], lines2[keep]):
            c = rng.uniform(0.15, 1.0, 3)
            ax.plot([s1[0, 0], s1[1, 0]], [s1[0, 1], s1[1, 1]], "-", lw=1.2,
                    color=c)
            ax.plot([s2[0, 0] + w1, s2[1, 0] + w1], [s2[0, 1], s2[1, 1]],
                    "-", lw=1.2, color=c)
            m1 = s1.mean(0)
            m2 = s2.mean(0)
            ax.plot([m1[0], m2[0] + w1], [m1[1], m2[1]], ":", lw=0.4,
                    color=c, alpha=0.6)

    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def plot_projection_error(path: str, img: np.ndarray,
                          pt_obs: np.ndarray | None = None,
                          pt_proj: np.ndarray | None = None,
                          pt_valid: np.ndarray | None = None,
                          ls_obs: np.ndarray | None = None,
                          ls_proj: np.ndarray | None = None,
                          ls_valid: np.ndarray | None = None,
                          title: str | None = None):
    """Per-iteration reprojection-residual overlay.

    Capability of the reference's plotStereoFrameProjerr
    (src/stereoFrameHandler.cpp:1286-1368): observed features in red,
    model-projected features in blue, residual connector in green.
    Points are [N,2]; line segments are [M,2,2] (sp, ep).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(10, 4))
    ax.imshow(img, cmap="gray", vmin=0, vmax=255)

    if pt_obs is not None and len(pt_obs):
        keep = (np.ones(len(pt_obs), bool) if pt_valid is None
                else np.asarray(pt_valid, bool))
        o = np.asarray(pt_obs, np.float64)[keep]
        p = np.asarray(pt_proj, np.float64)[keep]
        ax.plot(o[:, 0], o[:, 1], "o", ms=3, mfc="none", mec="red", mew=0.9)
        ax.plot(p[:, 0], p[:, 1], "o", ms=3, mfc="none", mec="blue", mew=0.9)
        for a, b in zip(p, o):
            ax.plot([a[0], b[0]], [a[1], b[1]], "-", color="lime", lw=0.8)

    if ls_obs is not None and len(ls_obs):
        keep = (np.ones(len(ls_obs), bool) if ls_valid is None
                else np.asarray(ls_valid, bool))
        o = np.asarray(ls_obs, np.float64)[keep]
        p = np.asarray(ls_proj, np.float64)[keep]
        for seg in o:
            ax.plot(seg[:, 0], seg[:, 1], "-", color="red", lw=1.2)
        for seg in p:
            ax.plot(seg[:, 0], seg[:, 1], "-", color="blue", lw=1.2)

    if title:
        ax.set_title(title)
    ax.set_axis_off()
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
