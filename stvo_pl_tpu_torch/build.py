"""Build and load the port's CUDA kernels.

Every source in `csrc/` is compiled by its own `nvcc` process (all started
together) and the objects are linked into one shared library with a plain
C interface, loaded with `ctypes`.  The build happens at first use, into
`build/kernels-<hash>/` beside the package; the hash covers the sources,
their shared headers and the flags, so an edited file is rebuilt.  A
missing `nvcc` or a failed compile raises: there is no fallback to the
plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("fast_pack", "patches", "lsd_run_pack", "hamming", "stage_stamp",
           "pose_optim", "orb_describe")
LIB = "libstvo_kernels.so"

# -fmad=false: fast_pack needs IEEE float arithmetic in the reference
# kernel's order, with no FMA contraction (its source also spells the
# sensitive lines with __f*_rn intrinsics), pose_optim the plain
# optimizer's operations one by one, and orb_describe the plain
# orientation's; patches, lsd_run_pack and hamming and stage_stamp do no
# float math.
# -Xptxas=-v reports each kernel's registers and spills (`ptxas_report`).
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas=-v"]

# C signatures: every entry returns cudaGetLastError() as an int.
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "stvo_fast_pack": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stvo_extract_patches_f32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stvo_extract_patches_b32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "stvo_lsd_run_pack_multi": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I,
                                _P],
    "stvo_lsd_run_pack": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "stvo_hamming_popc": [_P, _P, _P, _I, _I, _I, _P],
    "stvo_stage_stamp": [_P, _P, _I, _I, _I, _I, _P],
    "stvo_pose_optim": [_P, _P],
    "stvo_pose_optim_smem": [_I, _I, _P, _P],
    "stvo_orb_describe": [_P, _P, _P, _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None
last_build_seconds: float | None = None
ptxas_report: list[str] = []    # ptxas' lines of the last build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_ROOT / f"kernels-{h.hexdigest()[:16]}"


def _run(cmds: list[list[str]]) -> list[str]:
    """Run the commands side by side and return their logs; raise with the
    logs of any that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    logs = [p.communicate()[0].decode(errors="replace") for p in procs]
    errors = [f"{' '.join(c)}\n{log}" for c, p, log in zip(cmds, procs, logs)
              if p.returncode != 0]
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return logs


def build_all() -> Path:
    """Compile and link the kernels unless this build exists; returns the
    build directory."""
    global last_build_seconds, ptxas_report
    out_dir = _build_dir()
    if (out_dir / LIB).exists():
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    # intermediate files carry the pid, so concurrent builds do not collide
    tag = f".{os.getpid()}"
    objs = [str(out_dir / f"{name}{tag}.o") for name in SOURCES]
    logs = _run([[nvcc, *FLAGS, "-c", "-o", obj, str(CSRC / f"{name}.cu")]
                 for name, obj in zip(SOURCES, objs)])
    ptxas_report = [line.strip() for log in logs for line in log.splitlines()
                    if "ptxas info" in line or "spill" in line]
    _run([[nvcc, *FLAGS, "-shared", "-o", str(out_dir / (LIB + tag)),
           *objs]])
    os.replace(out_dir / (LIB + tag), out_dir / LIB)
    for obj in objs:
        os.remove(obj)
    last_build_seconds = time.perf_counter() - t0
    return out_dir


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_all() / LIB))
        for fn, argtypes in SIGNATURES.items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise when a kernel entry returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
