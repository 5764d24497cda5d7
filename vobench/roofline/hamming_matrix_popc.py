"""B5, the XOR + popcount Hamming kernel on the tensor cores
(`csrc/hamming.cu`), which the step launches only with
`hamming_use_mxu: false`.  Counted as `chip_smoke.py:2124-2125` counts one
launch: both descriptor sets ([.., R, 8] int32) read once, the [.., R1, R2]
distance matrix written once, 24 operations per pair.  No cell of this
benchmark runs that route yet."""

from vobench.reference.bounds import HAMMING_OPS_PER_PAIR

ID = "B5"
KERNELS = ("hamming_mma_kernel",)


def launch(batch: int, rows1: int, rows2: int,
           words: int = 8) -> tuple[float, float]:
    pairs = batch * rows1 * rows2
    return ((batch * (rows1 + rows2) * words + pairs) * 4,
            pairs * HAMMING_OPS_PER_PAIR)


def calls(vo: dict, cam: dict, lanes: int) -> list[tuple[float, float]]:
    if vo["hamming_use_mxu"]:
        return []
    raise NotImplementedError("the popcount route's call shapes are not "
                              "modelled")
