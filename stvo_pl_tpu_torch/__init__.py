"""stvo_pl_tpu_torch: the PyTorch/CUDA port of stvo_pl_tpu (stereo visual
odometry with points and lines).

It carries the default point + line VO step end to end: batched entry
point, 4-level FAST (CUDA kernel `csrc/fast_pack.cu`) and rBRIEF over
patches gathered by the CUDA kernel `csrc/patches.cu`, the multi-octave
canvas line detector around the all-direction run kernel
(`csrc/lsd_run_pack.cu`) with LBD descriptors, stereo and frame-to-frame
matching of both modalities, robust Gauss-Newton and the keyframe
decision.  Around the step it carries the application: the dataset CLI
(`cli.py`: images on disk -> `utils/dataset.ImageSequence` -> the VO step
per frame -> `models/backend.WindowedBA`, the windowed bundle adjustment
of `parallel/window.py` and `parallel/ba.py` over keyframe windows ->
refined trajectory, TUM / KITTI files and ATE against ground truth), with
its plots, HTML scene and the textured street world for test data; the
native prefetching loader that the CLI reads frames through
(`native/`: PGM/PNG decode on C++ threads, built by g++ at first use),
checkpoint / resume of the VO state (`utils/checkpoint.py`) and
torch.profiler tracing (`utils/profiling.py`).  It has a counterpart of
every module of the JAX package, and of its `jax.jit` entry points: the
VO step and the BA window, unsharded and sharded, captured as CUDA graphs
(`parallel/compiled.py`), which the entry points use on CUDA.
Entry points run on the GPU unless the caller passes device="cpu"
(`--device cpu` for the CLI).  The package never imports JAX or the JAX
package.
"""

from stvo_pl_tpu_torch.config import VOConfig, load_config
from stvo_pl_tpu_torch.device import resolve_device

__all__ = ["VOConfig", "load_config", "resolve_device"]
