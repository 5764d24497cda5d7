"""Frozen VO configuration: a field-for-field copy of the JAX package's
`VOConfig` (stvo_pl_tpu/config.py) with the same defaults, and the same
YAML loading with per-key fallback.

Defaults replicate the reference StVO-PL defaults (src/config.cpp:36-113);
unknown YAML keys are ignored and missing keys keep their defaults
(Config::loadFromFile, src/config.cpp:123-206).  The port runs every
configuration: points, the multi-octave canvas line detector, the dense
single-octave one (`lsd_octaves=1`) and the EDLine detector
(`use_edlines=True`).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Mapping


@dataclass(frozen=True)
class VOConfig:
    # ---- keyframe decision ---------------------------------------------
    min_entropy_ratio: float = 0.85
    max_kf_t_dist: float = 5.0
    max_kf_r_dist: float = 15.0

    # ---- StVO-PL options ----------------------------------------------
    has_points: bool = True
    has_lines: bool = True
    use_fld_lines: bool = False
    # left/right and point/line parallelism flags of the reference; the
    # eyes are a batch axis here, so they change nothing
    lr_in_parallel: bool = True
    pl_in_parallel: bool = True
    best_lr_matches: bool = True     # mutual-consistency check in matching
    adaptative_fast: bool = True     # adaptive FAST threshold controller
    use_motion_model: bool = False   # constant-velocity motion prior

    # ---- tracking: point features -------------------------------------
    max_dist_epip: float = 1.0       # max epipolar distance [px]
    min_disp: float = 1.0
    min_ratio_12_p: float = 0.9      # NN ratio test for points

    # ---- tracking: line features --------------------------------------
    line_sim_th: float = 0.75
    stereo_overlap_th: float = 0.75
    f2f_overlap_th: float = 0.75
    min_line_length: float = 0.025   # relative to min(img_w, img_h)
    line_horiz_th: float = 0.1
    min_ratio_12_l: float = 0.9
    ls_min_disp_ratio: float = 0.7

    # ---- adaptive FAST ------------------------------------------------
    fast_min_th: int = 5
    fast_max_th: int = 50
    fast_inc_th: int = 5
    fast_feat_th: int = 50
    fast_err_th: float = 0.5

    # ---- rgbd ---------------------------------------------------------
    rgbd_min_depth: float = 0.3
    rgbd_max_depth: float = 10.0

    # ---- optimization -------------------------------------------------
    homog_th: float = 1e-7
    min_features: int = 10
    max_iters: int = 5
    max_iters_ref: int = 10
    min_error: float = 1e-7
    min_error_change: float = 1e-7
    inlier_k: float = 4.0
    # solver mode: 0 = GN, 1 = robust GN (MAD-scaled), 2 = LM
    optim_mode: int = 0
    # robust kernel: cauchy | tukey | huber | welsch | parabola | tstudent
    robust_kernel: str = "cauchy"

    # ---- matching windows ---------------------------------------------
    matching_strategy: int = 0
    tp_min_features: int = 4096      # column-sharded matcher switch (tp.py)
    matching_s_ws: int = 10          # stereo search window [grid cells]
    matching_f2f_ws: int = 3         # f2f search window [grid cells]

    # ---- ORB-equivalent point detector --------------------------------
    orb_nfeatures: int = 1200
    orb_scale_factor: float = 1.2
    orb_nlevels: int = 4
    orb_edge_th: int = 19
    orb_wta_k: int = 2
    orb_score: int = 1               # 0 = Harris, 1 = FAST score
    orb_patch_size: int = 31
    orb_fast_th: int = 20

    # ---- LSD-equivalent line detector ---------------------------------
    lsd_nfeatures: int = 300
    lsd_refine: int = 0
    lsd_scale: float = 1.0
    lsd_sigma_scale: float = 0.6
    lsd_octaves: int = 3
    lsd_quant: float = 2.0
    lsd_ang_th: float = 22.5
    lsd_log_eps: float = 1.0
    lsd_density_th: float = 0.6
    lsd_n_bins: int = 1024
    lsd_right_lite: bool = False

    # ---- EDLine-style line detector -----------------------------------
    use_edlines: bool = False
    edline_grad_th: float = 20.0
    edline_anchor_th: float = 8.0
    edline_ang_tol: float = 20.0
    edline_min_support: int = 10
    edline_straight_tol: float = 0.1
    edline_density_th: float = 0.4
    edline_split_rounds: int = 2
    edline_scale: int = 1

    # ---- additions of the JAX package ---------------------------------
    grid_rows: int = 48
    grid_cols: int = 64
    lbd_long_samples: int = 8
    lsd_n_dirs: int = 12
    lsd_oct_pool: float = 1.5
    lsd_oct_l0_samples: int = 16
    lsd_oct_pool_right: float = 1.0
    lsd_oct_n_dirs: int = 8
    # sub-pixel corners (parabola fit in the FAST kernel) and photometric
    # stereo disparity (ops/subpix.py)
    subpix_points: bool = True
    subpix_disp: bool = True
    # compute dtype of the geometry / optimizer path
    dtype: str = "float32"
    # +/-1 matmul Hamming distances instead of XOR + popcount
    hamming_use_mxu: bool = True

    # ------------------------------------------------------------------
    def replace(self, **kw: Any) -> "VOConfig":
        return dataclasses.replace(self, **kw)

    @property
    def point_capacity(self) -> int:
        """Static per-image feature capacity for points."""
        return self.orb_nfeatures

    @property
    def line_capacity(self) -> int:
        """Static per-image feature capacity for line segments."""
        return self.lsd_nfeatures if self.lsd_nfeatures > 0 else 512


_FIELD_NAMES = {f.name for f in dataclasses.fields(VOConfig)}


def config_from_mapping(mapping: Mapping[str, Any],
                        base: VOConfig | None = None) -> VOConfig:
    """Build a VOConfig from a dict, ignoring unknown keys and coercing
    values to the declared field types."""
    base = base or VOConfig()
    types = {f.name: f.type for f in dataclasses.fields(VOConfig)}
    coerced = {}
    for k, v in mapping.items():
        if k not in _FIELD_NAMES:
            continue
        t = types[k]
        if t in ("int", int):
            coerced[k] = int(v)
        elif t in ("float", float):
            coerced[k] = float(v)
        elif t in ("bool", bool):
            coerced[k] = bool(v)
        else:
            coerced[k] = v
    cfg = base.replace(**coerced)
    _warn_inert_keys(cfg)
    return cfg


def _warn_inert_keys(cfg: VOConfig) -> None:
    """Reject or warn about knobs that are parsed but cannot take effect,
    with the same rules as the JAX package."""
    import warnings
    if cfg.orb_wta_k not in (2, 3, 4):
        raise ValueError(
            f"orb_wta_k={cfg.orb_wta_k}: cv::ORB supports WTA_K of 2 "
            "(256 binary tests, HAMMING) or 3/4 (128 2-bit argmax cells, "
            "HAMMING2) — see ops/orb.py describe/describe_wta")
    if cfg.orb_patch_size > 33:
        warnings.warn(
            f"orb_patch_size={cfg.orb_patch_size} exceeds the gathered "
            "33x33 patch; test points are clipped to a 13 px radius "
            "(see ops/orb.py:_make_pattern)", stacklevel=3)
    if cfg.lsd_right_lite and (cfg.lsd_octaves > 1 or cfg.use_edlines):
        warnings.warn(
            "lsd_right_lite has no effect when lsd_octaves > 1 or "
            "use_edlines is set: the multi-octave and EDLine detection "
            "branches use full sampling for both eyes", stacklevel=3)
    if cfg.lsd_n_bins != 1024:
        warnings.warn(
            f"lsd_n_bins={cfg.lsd_n_bins} is parsed for config parity but "
            "has no analogue here: the dense detector has no seed "
            "ordering", stacklevel=3)


def load_config(path: str | None, base: VOConfig | None = None) -> VOConfig:
    """Load a YAML config file with per-key fallback to defaults; a missing
    or invalid file keeps the defaults."""
    base = base or VOConfig()
    if path is None:
        return base
    try:
        import yaml
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
    except (OSError, ValueError):
        return base
    if not isinstance(data, dict):
        return base
    return config_from_mapping(data, base)
