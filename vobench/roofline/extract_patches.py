"""B2, the ORB patch gather (`csrc/patches.cu`), once per pyramid level:
33 x 33 float32 patches around each of the level's corner budget in both
eyes of every lane.  Counted as `chip_smoke.py:1850-1854` counts it, less
the source pixels: the corners (two int32 each) read and the patches
written once.  The distinct source pixels that the windows cover depend
on where the corners fall, which the trace does not show, so they are
left out and the bound is a lower one."""

ID = "B2"
KERNELS = ("extract_kernel",)
PATCH = 33


def budgets(vo: dict) -> list[int]:
    """Corners per level (`models/frame._per_level_budgets`: cv::ORB's
    geometric split of orb_nfeatures)."""
    L = vo["orb_nlevels"]
    q = 1.0 / vo["orb_scale_factor"]
    weights = [q ** i for i in range(L)]
    s = sum(weights)
    out = [max(8, int(round(vo["orb_nfeatures"] * w / s))) for w in weights]
    out[0] += vo["orb_nfeatures"] - sum(out)
    return out


def launch(N: int, K: int, P: int = PATCH) -> tuple[float, float]:
    return 2 * N * K * 4 + N * K * P * P * 4, 0.0


def calls(vo: dict, cam: dict, lanes: int) -> list[tuple[float, float]]:
    if not vo["has_points"]:
        return []
    return [launch(2 * lanes, K) for K in budgets(vo)]
