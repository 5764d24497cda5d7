"""ctypes binding and lazy build of the native stereo loader.

`stvo_loader.cpp` is compiled with g++ on first use (plain C ABI, no
Python headers) into `build/native-<hash>/libstvo_loader.so` beside the
package; the hash covers the source and the flags, so an edited source is
rebuilt, and the flags name no host CPU (no `-march=native`), so a library
built on one machine loads on another.  A missing g++ or zlib raises
`NativeUnavailable`; `utils.dataset.ImageSequence.prefetch` then decodes
with PIL.

`PrefetchingLoader` decodes frame pairs on a pool of C++ threads, at most
`CAPACITY` frames ahead of the consumer, and yields them in order as
float32 [H, W] CPU tensors, written by the library straight into freshly
allocated (optionally pinned) tensors.  A frame that does not decode, or
whose image is not `width x height`, raises `IOError` naming the file.
Its optional bilinear remap (`map_l`, `map_r`) keeps the JAX package's
API; the port's dataset rectifies on the device and passes no maps.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

SRC = Path(__file__).resolve().parent / "stvo_loader.cpp"
BUILD_ROOT = Path(__file__).resolve().parent.parent.parent / "build"
LIB = "libstvo_loader.so"
FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz", "-lpthread"]

# frames decoded ahead of the consumer, at most: the JAX copy's 8 ready
# and 4 completion slots
CAPACITY = 12

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# stvo_loader_next returns -(2 * status + eye) for a failed frame, with
# status 1 for a file that does not decode and 2 for an image of the wrong
# size
_WRONG_SIZE = 2


class NativeUnavailable(RuntimeError):
    """The native library cannot be built or loaded on this host."""


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(FLAGS + LIBS).encode())
    h.update(SRC.read_bytes())
    return BUILD_ROOT / f"native-{h.hexdigest()[:16]}"


def _build() -> Path:
    out_dir = build_dir()
    lib = out_dir / LIB
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    # a pid-tagged file renamed into place: concurrent builds do not collide
    tmp = out_dir / f"{LIB}.{os.getpid()}"
    cmd = ["g++", *FLAGS, str(SRC), "-o", str(tmp), *LIBS]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise NativeUnavailable(f"native loader build failed: {e}") from e
    except subprocess.CalledProcessError as e:
        raise NativeUnavailable(
            f"native loader build failed: {e.stderr}") from e
    os.replace(tmp, lib)
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build()))
        except OSError as e:
            raise NativeUnavailable(f"native loader load failed: {e}") from e
        fp = ctypes.POINTER(ctypes.c_float)
        ip = ctypes.POINTER(ctypes.c_int)
        lib.stvo_loader_open.restype = ctypes.c_void_p
        lib.stvo_loader_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, fp, fp, ctypes.c_int,
            ctypes.c_int]
        lib.stvo_loader_next.restype = ctypes.c_int
        lib.stvo_loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                         ctypes.c_void_p, ip]
        lib.stvo_loader_buffered.restype = ctypes.c_int
        lib.stvo_loader_buffered.argtypes = [ctypes.c_void_p, ip]
        lib.stvo_loader_close.restype = None
        lib.stvo_loader_close.argtypes = [ctypes.c_void_p]
        lib.stvo_image_decode.restype = ctypes.c_void_p
        lib.stvo_image_decode.argtypes = [ctypes.c_char_p, ip, ip]
        lib.stvo_image_take.restype = None
        lib.stvo_image_take.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
        return _lib


def decode_image(path: str) -> torch.Tensor:
    """Decode one PGM/PPM/PNG file to a float32 grayscale [H, W] tensor
    with the C++ decoder."""
    lib = get_lib()
    w, h = ctypes.c_int(), ctypes.c_int()
    image = lib.stvo_image_decode(os.fsencode(path), ctypes.byref(w),
                                  ctypes.byref(h))
    if not image:
        raise IOError(f"native decode failed: {path}")
    out = torch.empty((h.value, w.value), dtype=torch.float32)
    lib.stvo_image_take(image, out.data_ptr())
    return out


class PrefetchingLoader:
    """Threaded C++ loader: decode (and, given maps, remap) off the main
    thread, at most `CAPACITY` frames ahead of the consumer, yielding
    (left, right) float32 [height, width] CPU tensors in sequence order;
    pinned when `pin_memory`, so that the caller's
    `non_blocking` copy to the GPU is asynchronous.  Each pair is a fresh
    allocation: PyTorch's pinned-memory cache keeps a block until the copy
    that reads it has finished, which a reused buffer would not wait for.

    Equivalent role to the reference's per-frame imread + rectify
    (src/dataset.cpp:147-157), overlapped with device compute.  Use as a
    context manager, or call `close()`; a consumer that stops iterating
    early closes it too.
    """

    def __init__(self, paths_l, paths_r, width: int, height: int,
                 map_l=None, map_r=None, n_threads: int = 2,
                 pin_memory: bool = False):
        if len(paths_l) != len(paths_r):
            raise ValueError(f"{len(paths_l)} left and {len(paths_r)} right "
                             f"images")
        if (map_l is None) != (map_r is None):
            raise ValueError("pass both rectification maps or neither")
        self.lib = get_lib()
        self.paths = (list(paths_l), list(paths_r))
        self.n = len(paths_l)
        self.width = int(width)
        self.height = int(height)
        self.pin_memory = pin_memory
        arr_l = (ctypes.c_char_p * self.n)(*map(os.fsencode, paths_l))
        arr_r = (ctypes.c_char_p * self.n)(*map(os.fsencode, paths_r))
        fp = ctypes.POINTER(ctypes.c_float)
        ml = mr = ctypes.cast(None, fp)
        if map_l is not None:
            maps = []
            for m in (map_l, map_r):
                m = np.ascontiguousarray(np.asarray(m), np.float32)
                want = (self.height, self.width, 2)
                if m.shape != want:
                    raise ValueError(f"rectification map of shape "
                                     f"{m.shape}, expected {want}")
                maps.append(m)
            # the library copies the paths and maps before returning
            ml, mr = (m.ctypes.data_as(fp) for m in maps)
        self.handle = self.lib.stvo_loader_open(
            arr_l, arr_r, self.n, self.width, self.height, ml, mr,
            int(n_threads), CAPACITY)

    def _error(self, i: int, rc: int, wh) -> IOError:
        status, eye = divmod(-rc, 2)
        path = self.paths[eye][i]
        if status == _WRONG_SIZE:
            return IOError(f"{path}: image is {wh[0]}x{wh[1]}, expected "
                           f"{self.width}x{self.height}")
        return IOError(f"native decode failed: {path}")

    def __iter__(self):
        wh = (ctypes.c_int * 2)()
        try:
            for i in range(self.n):
                if self.handle is None:
                    raise RuntimeError("the loader is closed")
                out = [torch.empty((self.height, self.width),
                                   dtype=torch.float32,
                                   pin_memory=self.pin_memory)
                       for _ in range(2)]
                rc = self.lib.stvo_loader_next(
                    self.handle, out[0].data_ptr(), out[1].data_ptr(), wh)
                if rc == 0:
                    raise IOError(f"the loader ended after {i} of "
                                  f"{self.n} frames")
                if rc < 0:
                    raise self._error(i, rc, wh)
                yield out[0], out[1]
        finally:
            self.close()

    def buffered(self) -> tuple[int, int]:
        """(frames decoded and not yet taken, the most there have been at
        once); at most `CAPACITY` each."""
        if self.handle is None:
            raise RuntimeError("the loader is closed")
        peak = ctypes.c_int()
        now = self.lib.stvo_loader_buffered(self.handle, ctypes.byref(peak))
        return now, peak.value

    def close(self) -> None:
        """Stop and join the worker threads (idempotent)."""
        if self.handle is not None:
            self.lib.stvo_loader_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if getattr(self, "handle", None) is not None:
            self.close()
