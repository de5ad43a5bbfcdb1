"""Process-group start-up and the scaling-efficiency harness (port of
`gaussian_mesh_splatting_tpu/parallel/multihost.py`).

PyTorch runs one process per device. Every process of a job calls
`initialize` first; `global_mesh` is then the 1-D `data` mesh over all of
them:

    from gaussian_mesh_splatting_tpu_torch.parallel import multihost
    multihost.initialize()              # torch.distributed under the hood
    mesh = multihost.global_mesh()

Under `torchrun` (or a SLURM or Open MPI launch that exports MASTER_ADDR and
MASTER_PORT) the arguments come from the environment. Elsewhere, e.g. CPU
processes in a test, pass them:

    multihost.initialize("file:///tmp/store", world_size=2, rank=r, backend="gloo")

`measure_scaling` times a step at several process counts and reports its
efficiency against the narrowest.
"""
from __future__ import annotations

import os
import time

import torch
import torch.distributed as dist

# torchrun's variables, and those of SLURM and Open MPI launches
_TORCHRUN_ENV_VARS = ("WORLD_SIZE", "RANK", "MASTER_ADDR")
_LAUNCHER_ENV = (  # (world size, rank, local rank) variables of each launcher
    ("SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID"),
    ("OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"),
)


def _launcher() -> tuple[str, str, str] | None:
    """The SLURM or Open MPI variables of a launch of more than one process."""
    for names in _LAUNCHER_ENV:
        if int(os.environ.get(names[0], "1")) > 1:
            return names
    return None


def local_rank(rank: int | None = None) -> int:
    """This process's index among the processes of its host: LOCAL_RANK
    (torchrun) or the SLURM / Open MPI counterpart, else the global rank
    (`rank`, or this process's) modulo the host's CUDA device count, so
    that every rank shares the one card of a one-card host."""
    for name in ("LOCAL_RANK", "SLURM_LOCALID", "OMPI_COMM_WORLD_LOCAL_RANK"):
        if name in os.environ:
            return int(os.environ[name])
    if rank is None:
        rank = dist.get_rank() if is_initialized() else int(os.environ.get("RANK", "0"))
    return rank % max(torch.cuda.device_count(), 1)


def initialize(
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    backend: str | None = None,
    **kwargs,
) -> bool:
    """Join this process to the job's default process group (idempotent).

    With an explicit `init_method`, `world_size` or `rank`, or in a cluster
    environment (torchrun's WORLD_SIZE / RANK / MASTER_ADDR; SLURM or Open
    MPI with more than one task, whose world size and rank are read from
    their variables), this calls `torch.distributed.init_process_group` and
    lets its errors propagate: a launch that cannot join must fail loudly,
    not train 1/N of the job alone. On a plain single process without those
    arguments it is a no-op that returns False, whatever `backend` says.

    `backend=None` takes NCCL where CUDA is available and gloo elsewhere;
    gloo also takes CUDA tensors (through host memory), which lets several
    ranks share one card. Where CUDA is available each rank's current device
    becomes cuda:`local_rank()`. `init_method` defaults to "env://". Other
    keyword arguments (e.g. `timeout=`) go to `init_process_group`.

    Returns True when the process group is (or already was) up."""
    if is_initialized():
        return True
    explicit = any(a is not None for a in (init_method, world_size, rank))
    launcher = _launcher()
    in_cluster = launcher is not None or any(v in os.environ for v in _TORCHRUN_ENV_VARS)
    if not explicit and not in_cluster:
        return False  # a plain single process: nothing to join
    if launcher is not None and "WORLD_SIZE" not in os.environ:
        world_size = int(os.environ[launcher[0]]) if world_size is None else world_size
        rank = int(os.environ[launcher[1]]) if rank is None else rank
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if torch.cuda.is_available():
        torch.cuda.set_device(local_rank(rank))
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=-1 if world_size is None else world_size,
                            rank=-1 if rank is None else rank, **kwargs)
    return True


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def global_mesh(axis_name: str = "data"):
    """1-D mesh over every process of the job (all hosts)."""
    from .mesh_setup import create_mesh

    return create_mesh(axis_name=axis_name)


def _sync() -> None:
    """Wait for this process's CUDA work, where there is a card: the host
    clock then times the work, not its enqueueing."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def measure_scaling(step_builder, widths=None, iters: int = 10) -> dict:
    """Time a step at several process counts.

    Every rank calls it. For each width w the first w ranks form a 1-D
    `data` mesh (every rank takes part in making it, in the same order), and
    those ranks build and run the step; the others wait at a barrier.

    Args:
      step_builder: fn(mesh) -> (step_fn, args), called on the mesh's ranks;
        step_fn(*args) runs one step.
      widths: process counts to test (default 1, 2, 4, ..., all).
    Returns, on every rank:
      {width: {"ms": mean step ms of the slowest rank, "efficiency": vs the
      first width}}; per-step work grows with the width (one camera per
      rank), so the ideal time is constant.
    """
    from .mesh_setup import create_mesh

    n = dist.get_world_size()
    if widths is None:
        widths = [w for w in (1, 2, 4, 8, 16, 32, 64) if w <= n]
        if n not in widths:
            widths.append(n)
    results = {}
    base_ms = None
    for w in widths:
        mesh = create_mesh(w)
        ms = torch.zeros((), dtype=torch.float64)
        if dist.get_rank() < w:
            step_fn, args = step_builder(mesh)
            step_fn(*args)  # warm-up
            _sync()
            dist.barrier(group=mesh.get_group())
            t0 = time.perf_counter()
            for _ in range(iters):
                step_fn(*args)
            _sync()
            ms = torch.tensor((time.perf_counter() - t0) / iters * 1000, dtype=torch.float64)
        # the slowest rank's time, on every rank
        ms = ms.to(_collective_device())
        dist.all_reduce(ms, op=dist.ReduceOp.MAX)
        ms = float(ms)
        if base_ms is None:
            base_ms = ms
        results[w] = {"ms": ms, "efficiency": base_ms / ms}
    return results


def _collective_device() -> torch.device:
    """Where a small tensor must live for the default group's backend."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
