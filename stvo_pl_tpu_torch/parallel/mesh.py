"""Process group, device mesh and batch-slicing helpers (port of
stvo_pl_tpu/parallel/mesh.py).

The scale-out is SPMD: one process per GPU, as `torchrun` starts them.
Every rank runs the same program on its own slice of the batch; a 2-D
`DeviceMesh` with the dimensions ("data", "model") names which ranks
share lanes (the model axis, for column-sharded matching) and which hold
different lanes (the data axis).  NCCL runs the collectives between GPUs,
gloo between CPU processes; neither is chosen in place of the other
behind the caller's back.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from stvo_pl_tpu_torch.device import resolve_device

DATA_AXIS = "data"
MODEL_AXIS = "model"

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def init_distributed(backend: str | None = None, device_type: str = "cuda",
                     init_method: str | None = None,
                     rank: int | None = None,
                     world_size: int | None = None) -> None:
    """Start the default process group; a no-op when one is up.

    The backend is NCCL for `device_type="cuda"` and gloo for "cpu" unless
    named.  `init_method` (for example "file:///path") with `rank` and
    `world_size` joins an explicit world; else `torchrun`'s environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) is read; without either
    the process forms a world of one through an in-process HashStore, so
    no port has to be found.  On CUDA each rank takes the GPU LOCAL_RANK
    names.  Asking for CUDA without a GPU raises."""
    if dist.is_initialized():
        return
    dev = resolve_device(device_type)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs device_type='cuda'")
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    if init_method is not None:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size)
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """A ("data", "model") mesh over every rank of the default group,
    rank-major: ranks r and r + 1 share a data row when n_model > 1.
    n_data defaults to world_size // n_model."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh does not cover the "
                         f"{world} ranks")
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def axis(mesh: DeviceMesh, name: str):
    """(process group or None, size, this rank's index) of a mesh
    dimension; a dimension the mesh lacks has size 1."""
    if name not in (mesh.mesh_dim_names or ()):
        return None, 1, 0
    return (mesh.get_group(name), mesh.size(mesh.mesh_dim_names.index(name)),
            mesh.get_local_rank(name))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def data_slice(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global [B, ...] tensor: the counterpart of
    sharding the batch axis over the data axis.  B must be a multiple of
    the data-axis size."""
    _, n, i = axis(mesh, DATA_AXIS)
    if x.shape[0] % n != 0:
        raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                         f"{n} data-axis ranks")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]
