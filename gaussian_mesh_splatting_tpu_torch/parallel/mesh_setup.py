"""Device meshes for multi-device training (port of
`gaussian_mesh_splatting_tpu/parallel/mesh_setup.py`).

A `torch.distributed.device_mesh.DeviceMesh` stands where the JAX package
has a `jax.sharding.Mesh`: the `data` axis carries camera parallelism, and a
second `model` axis the rendering of one camera in portions. PyTorch runs
one process per device, so a mesh is a grid of process ranks, and each of
its axes a process group (`mesh.get_group(axis)`) that the collectives of
`parallel/` run over. Every process of the job builds every mesh, in the
same order: making a mesh makes its groups, a collective call.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _device_type() -> str:
    """The mesh's device type: that of the default group's transport (NCCL:
    cuda; gloo: cpu, which also carries CUDA tensors, through host memory)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def create_mesh(n_devices: int | None = None, axis_name: str = "data") -> DeviceMesh:
    """1-D mesh over the first `n_devices` ranks (default: all). Ranks
    outside it take part in making it and hold no coordinate on it."""
    n = dist.get_world_size() if n_devices is None else n_devices
    return DeviceMesh(_device_type(), torch.arange(n), mesh_dim_names=(axis_name,))


def create_mesh2d(
    n_data: int,
    n_model: int,
    axis_names: tuple[str, str] = ("data", "model"),
) -> DeviceMesh:
    """2-D (data x model) mesh over the first n_data * n_model ranks, for
    composed camera-DP x sharded-render training (parallel/sharded_step.py).
    The model axis is the fast one: ranks r and r + 1 render portions of
    one camera, so one camera's collectives stay on adjacent devices."""
    ranks = torch.arange(n_data * n_model).reshape(n_data, n_model)
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=axis_names)


def _mesh_index(mesh: DeviceMesh) -> int | None:
    """This rank's position in the mesh's rank grid, flattened row-major;
    None outside the mesh."""
    hits = (mesh.mesh.flatten() == dist.get_rank()).nonzero()
    return int(hits[0, 0]) if len(hits) else None


def local_batch_slice(global_batch: int, mesh: DeviceMesh) -> tuple[int, int]:
    """(start, size) of this process's share of a camera batch. A torch
    process holds one device, so the share is one device's: `global_batch //
    mesh.size()` cameras from its position in the mesh; (0, 0) for a rank
    outside the mesh."""
    idx = _mesh_index(mesh)
    if idx is None:
        return 0, 0
    per = global_batch // mesh.size()
    return idx * per, per
