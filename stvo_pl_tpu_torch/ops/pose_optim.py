"""The pose optimizer's state machine as one CUDA kernel
(`csrc/pose_optim.cu`): `models/optimizer.optimize_pose` routes CUDA
tensors here, one thread block per lane; CPU tensors keep the plain
version in `models/optimizer.py`, which the kernel mirrors.

`pose_optim` takes the matches and the previous increment with any
leading lane dims and returns the raw outputs; `models/optimizer` packs
them into its `PoseEstimate`.  The matches are staged in shared memory,
29 bytes a point and 61 a line: a capacity beyond the card's shared
memory raises here, before any launch (so at capture, never in a
replay).  The kernel computes in float32."""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from stvo_pl_tpu_torch import build

ROBUST_KERNELS = ("cauchy", "parabola", "tukey", "huber", "welsch",
                  "tstudent")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_INPUTS = ("P", "obs", "p_sigma2", "p_valid", "p_inlier", "sP", "eP", "spl",
           "epl", "le", "l_sigma2", "l_valid", "l_inlier", "DT_prev",
           "cov_prev", "err_prev")
_OUTPUTS = ("DT", "cov", "eig", "err", "good", "n_pt", "n_ls", "iters",
            "p_inlier_out", "l_inlier_out")
_INTS = ("B", "Np", "Nl")
_FLOATS = ("fx", "fy", "cx", "cy", "homog_th", "min_error",
           "min_error_change", "inlier_k")
_SETTINGS = ("min_features", "max_iters", "max_iters_ref", "optim_mode",
             "robust_kernel", "use_motion_model", "has_points", "has_lines")


class _Args(ctypes.Structure):
    """`PoseOptimArgs` of the kernel source, field for field."""
    _fields_ = ([(n, _P) for n in _INPUTS + _OUTPUTS]
                + [(n, _I) for n in _INTS] + [(n, _F) for n in _FLOATS]
                + [(n, _I) for n in _SETTINGS])


class Outputs(NamedTuple):
    """The kernel's outputs; the first eight in `PoseEstimate`'s order."""
    DT: torch.Tensor            # [..., 4, 4]
    cov: torch.Tensor           # [..., 6, 6]
    eig: torch.Tensor           # [..., 6]
    err: torch.Tensor           # [...]
    good: torch.Tensor          # [...] bool
    n_pt: torch.Tensor          # [...] int64
    n_ls: torch.Tensor          # [...] int64
    iters: torch.Tensor         # [...] int32
    p_inlier: torch.Tensor      # [..., Np] bool
    l_inlier: torch.Tensor      # [..., Nl] bool


def _prepare(pm, lm, cam, cfg, DT_prev, DT_prev_cov, err_prev):
    """(args, outputs, inputs): the launch's argument block, the output
    tensors it writes ([B, ...], lanes flattened) and the contiguous
    inputs it reads (to be kept alive until the launch).  Checks what the
    kernel does not take."""
    if cfg.robust_kernel not in ROBUST_KERNELS:
        raise ValueError(f"unknown robust kernel: {cfg.robust_kernel}")
    if cfg.optim_mode not in (0, 1, 2):
        raise ValueError(f"unknown optim_mode: {cfg.optim_mode}")
    lead = DT_prev.shape[:-2]
    B = 1
    for d in lead:
        B *= d
    Np, Nl = pm.P.shape[-2], lm.sP.shape[-2]
    dev = DT_prev.device

    def flat(t, dtype, *tail):
        if t.dtype != dtype:
            raise ValueError(f"pose_optim takes {dtype} tensors, got "
                             f"{t.dtype}")
        if t.device != dev:
            raise ValueError(f"pose_optim: tensors on {t.device} and {dev}")
        return t.expand(lead + tail).reshape((B,) + tail).contiguous()

    f32, b8 = torch.float32, torch.bool
    ins = dict(
        P=flat(pm.P, f32, Np, 3), obs=flat(pm.obs, f32, Np, 2),
        p_sigma2=flat(pm.sigma2, f32, Np), p_valid=flat(pm.valid, b8, Np),
        p_inlier=flat(pm.inlier, b8, Np), sP=flat(lm.sP, f32, Nl, 3),
        eP=flat(lm.eP, f32, Nl, 3), spl=flat(lm.spl, f32, Nl, 2),
        epl=flat(lm.epl, f32, Nl, 2), le=flat(lm.le_obs, f32, Nl, 3),
        l_sigma2=flat(lm.sigma2, f32, Nl), l_valid=flat(lm.valid, b8, Nl),
        l_inlier=flat(lm.inlier, b8, Nl),
        DT_prev=flat(DT_prev, f32, 4, 4),
        cov_prev=flat(DT_prev_cov, f32, 6, 6),
        err_prev=flat(err_prev, f32))
    empty = lambda *s, dt=f32: torch.empty((B,) + s, dtype=dt, device=dev)
    outs = Outputs(DT=empty(4, 4), cov=empty(6, 6), eig=empty(6),
                   err=empty(), good=empty(dt=b8),
                   n_pt=empty(dt=torch.int64), n_ls=empty(dt=torch.int64),
                   iters=empty(dt=torch.int32), p_inlier=empty(Np, dt=b8),
                   l_inlier=empty(Nl, dt=b8))
    ptrs = dict({k: v.data_ptr() for k, v in ins.items()},
                **dict(zip(_OUTPUTS, (t.data_ptr() for t in outs))))
    args = _Args(
        **ptrs, B=B, Np=Np, Nl=Nl, fx=cam.fx, fy=cam.fy, cx=cam.cx,
        cy=cam.cy, homog_th=cfg.homog_th, min_error=cfg.min_error,
        min_error_change=cfg.min_error_change, inlier_k=cfg.inlier_k,
        min_features=cfg.min_features, max_iters=cfg.max_iters,
        max_iters_ref=cfg.max_iters_ref, optim_mode=cfg.optim_mode,
        robust_kernel=ROBUST_KERNELS.index(cfg.robust_kernel),
        use_motion_model=int(cfg.use_motion_model),
        has_points=int(cfg.has_points), has_lines=int(cfg.has_lines))
    return args, outs, ins


def _check_capacity(lib, Np: int, Nl: int) -> None:
    """Raise where Np points and Nl lines do not fit in a block's shared
    memory."""
    need, limit = ctypes.c_longlong(), ctypes.c_longlong()
    build.check(lib.stvo_pose_optim_smem(Np, Nl, ctypes.byref(need),
                                         ctypes.byref(limit)),
                "pose_optim capacity")
    if need.value > limit.value:
        raise ValueError(
            f"pose_optim: {Np} points and {Nl} lines need {need.value} bytes "
            f"of shared memory a lane, more than the {limit.value} a block "
            f"has on this card (29 bytes a point, 61 a line)")


def pose_optim(pm, lm, cam, cfg, DT_prev, DT_prev_cov,
               err_prev) -> Outputs:
    """optimize_pose's outputs for CUDA tensors, lanes as the leading dims
    of DT_prev (counted in `pose_optim.launches`)."""
    if DT_prev.device.type != "cuda":
        raise ValueError(f"pose_optim runs on CUDA tensors, got "
                         f"{DT_prev.device}")
    lead = DT_prev.shape[:-2]
    lib = build.library()
    with torch.cuda.device(DT_prev.device):
        _check_capacity(lib, pm.P.shape[-2], lm.sP.shape[-2])
        args, outs, ins = _prepare(pm, lm, cam, cfg, DT_prev, DT_prev_cov,
                                  err_prev)
        if args.B > 0:
            stream = torch.cuda.current_stream(DT_prev.device).cuda_stream
            build.check(lib.stvo_pose_optim(ctypes.byref(args), stream),
                        "pose_optim")
            pose_optim.launches += 1
    return Outputs(*[t.reshape(lead + t.shape[1:]) for t in outs])


pose_optim.launches = 0
