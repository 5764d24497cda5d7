"""B1, the fused FAST kernel (`csrc/fast_pack.cu`), once per pyramid level
over both eyes of every lane.  Counted as `chip_smoke.py:1802-1803`
counts it: the level's float32 image read once, the packed [N, Hs, Wp]
int32 survivors (`ops/fast_kernel.packed_shape`: rows rounded up to the
40-row strip, columns to 128) written once, and the FAST response's
operations per pixel."""

from vobench.reference.bounds import FAST_OPS_PER_PIXEL, round_up

ID = "B1"
KERNELS = ("fast_pack_kernel",)
STRIP = 40


def level_shapes(vo: dict, cam: dict) -> list[tuple[int, int]]:
    """(H, W) of each pyramid level (`ops/image._pyramid_matrices`: level
    l at max(16, round(size / scale ** l)))."""
    H, W = cam["height"], cam["width"]
    out = [(H, W)]
    for lv in range(1, vo["orb_nlevels"]):
        s = vo["orb_scale_factor"] ** lv
        out.append((max(16, int(round(H / s))), max(16, int(round(W / s)))))
    return out


def launch(N: int, H: int, W: int) -> tuple[float, float]:
    Hs, Wp = round_up(H, STRIP), round_up(W, 128)
    return N * H * W * 4 + N * Hs * Wp * 4, N * H * W * FAST_OPS_PER_PIXEL


def calls(vo: dict, cam: dict, lanes: int) -> list[tuple[float, float]]:
    if not vo["has_points"]:
        return []
    return [launch(2 * lanes, H, W) for H, W in level_shapes(vo, cam)]
