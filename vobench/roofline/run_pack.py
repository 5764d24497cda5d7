"""B4, the one-direction LSD run kernel (`csrc/lsd_run_pack.cu`
`stvo_lsd_run_pack`), which only the dense single-octave detector with the
per-direction generator launches (once per direction).  Counted as
`chip_smoke.py:2073-2074` counts one launch: the [N, H, W] one-byte mask
read once, the packed [N, Hp, Wp] int32 map written once
(`ops/lsd_kernel.run_pack_shape`: rows rounded up to 8, columns to 128).
No cell of this benchmark runs that detector yet."""

from vobench.reference.bounds import RUN_PACK_ONE_OPS_PER_PIXEL, round_up

ID = "B4"
KERNELS = ("run_plane_kernel", "start_pack_kernel")


def launch(N: int, H: int, W: int) -> tuple[float, float]:
    Hp, Wp = round_up(H, 8), round_up(W, 128)
    return (N * H * W + N * Hp * Wp * 4,
            N * Hp * Wp * RUN_PACK_ONE_OPS_PER_PIXEL)


def calls(vo: dict, cam: dict, lanes: int) -> list[tuple[float, float]]:
    if (not vo["has_lines"] or vo["use_edlines"] or vo["lsd_octaves"] > 1
            or not vo.get("per_direction", False)):
        return []
    raise NotImplementedError("the per-direction detector's call shapes are "
                              "not modelled")
