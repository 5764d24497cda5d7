"""stvo_pl_tpu_torch: the PyTorch/CUDA port of stvo_pl_tpu (stereo visual
odometry with points and lines).

It carries the default point + line VO step end to end: batched entry
point, 4-level FAST (CUDA kernel `csrc/fast_pack.cu`) and rBRIEF over
patches gathered by the CUDA kernel `csrc/patches.cu`, the multi-octave
canvas line detector around the all-direction run kernel
(`csrc/lsd_run_pack.cu`) with LBD descriptors, stereo and frame-to-frame
matching of both modalities, robust Gauss-Newton and the keyframe
decision.  Entry points run
on the GPU unless the caller passes device="cpu".  The package never
imports JAX or the JAX package.
"""

from stvo_pl_tpu_torch.config import VOConfig, load_config
from stvo_pl_tpu_torch.device import resolve_device

__all__ = ["VOConfig", "load_config", "resolve_device"]
