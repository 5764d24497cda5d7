"""B3, the all-direction LSD run kernel (`csrc/lsd_run_pack.cu`
`stvo_lsd_run_pack_multi`), once per step over the octave canvases of
both eyes of every lane.  Counted as `chip_smoke.py:1984-1985` counts it:
the [N, Hc, Wc] int32 direction bitmask read once, the packed
[N, D, Hp / 8, Wp] int32 maps written once (`ops/lsd_kernel.packed_shape`:
rows rounded up to 64, columns to 128), and the run-pack operations per
padded pixel and direction."""

from vobench.reference.bounds import RUN_PACK_OPS_PER_PIXEL_DIR, round_up

ID = "B3"
KERNELS = ("run_planes_kernel", "chain_pack_kernel")
GAP = 16


def canvas_shape(vo: dict, cam: dict) -> tuple[int, int]:
    """(Hc, Wc) of one octave canvas (`models/frame._octave_images` and
    `_octave_layout`: ratio-2 octaves while the side stays >= 64, octave 0
    on top, the coarser ones side by side below it, 16 px apart)."""
    H, W = cam["height"], cam["width"]
    shapes = [(H, W)]
    for _ in range(1, max(1, vo["lsd_octaves"])):
        h, w = shapes[-1]
        if min(h, w) < 64:
            break
        shapes.append((h // 2, w // 2))
    if len(shapes) == 1:
        return H, W
    x = sum(w + GAP for _, w in shapes[1:]) - GAP
    return H + GAP + shapes[1][0], max(W, x)


def launch(N: int, H: int, W: int, D: int) -> tuple[float, float]:
    Ht, Wp = round_up(H, 64) // 8, round_up(W, 128)
    return (N * H * W * 4 + N * D * Ht * Wp * 4,
            N * Ht * 8 * Wp * D * RUN_PACK_OPS_PER_PIXEL_DIR)


def calls(vo: dict, cam: dict, lanes: int) -> list[tuple[float, float]]:
    if not vo["has_lines"] or vo["use_edlines"]:
        return []
    if vo["lsd_octaves"] <= 1:
        raise NotImplementedError("the dense single-octave detector's call "
                                  "shapes are not modelled")
    D = vo["lsd_oct_n_dirs"] if vo["lsd_oct_n_dirs"] > 0 else vo["lsd_n_dirs"]
    Hc, Wc = canvas_shape(vo, cam)
    return [launch(2 * lanes, Hc, Wc, D)]
