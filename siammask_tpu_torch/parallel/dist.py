"""Process groups and collectives for data-parallel training.

Counterpart of ``siammask_tpu/parallel/mesh.py``. The JAX package lays one
global batch over a 1-D device mesh and lets XLA insert the collectives;
here each device is one process of a ``torch.distributed`` group (NCCL
between cards, gloo on the CPU), each process loads its own rows of the
global batch, and the trainer issues the collectives itself
(``train/trainer.py``):

- ``init_distributed``: joins the group from torchrun's environment or
  SLURM's when it names more than one process (``init_multihost``), or
  from explicit arguments, and binds the process's device;
- ``local_rows``: a rank's rows of the global batch, the rows that
  ``shard_batch`` places on device r of the mesh;
- ``AllReduceSum``: a summing all-reduce whose backward is the same
  all-reduce of the gradient (sync-BN's statistics);
- ``all_reduce_tensors``: a sum or a mean over the group of a list of
  tensors in place, as one flat bucket: the gradient exchange (summed in
  the exact mode, averaged in the fused one, the JAX package's bucketed
  pmean), the BN running statistics and the step's metrics;
- ``spawn``: a function run on ``world`` new processes, one per rank.

Every collective goes through ``_all_reduce``, whose ``calls`` attribute
counts them.
"""
from __future__ import annotations

import datetime
import os
import socket
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist

from siammask_tpu_torch.utils import trace


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def init_distributed(device_type: str = "cuda", *, rank: int | None = None,
                     world: int | None = None, init_method: str = "env://",
                     backend: str | None = None, timeout: float | None = None,
                     local_rank: int | None = None) -> tuple[int, int, torch.device]:
    """Join a process group and bind this process's device; returns (rank,
    world, device).

    ``rank`` and ``world`` default to torchrun's ``RANK`` / ``WORLD_SIZE``,
    else SLURM's ``SLURM_PROCID`` / ``SLURM_NTASKS`` (as ``init_multihost``
    reads them). When neither names more than one process and no ``world``
    is given there is no group, as ``init_multihost`` makes none for one
    process: (0, 1, device), the process alone. The rendezvous is
    ``init_method``, torchrun's ``MASTER_ADDR`` / ``MASTER_PORT`` by default;
    SLURM sets neither, and a world read from the environment without them
    raises.

    On ``cuda`` the process binds card ``local_rank``: by default
    ``LOCAL_RANK``, else ``SLURM_LOCALID``, else the rank; a card that is not
    there raises. The backend is NCCL on cards and gloo on the CPU unless
    ``backend`` names another (gloo on cards lets ranks share one card,
    which NCCL refuses). NCCL's communicator is made here, so a failed
    init raises here. ``timeout`` is the collectives' limit in seconds
    (torch's default when None)."""
    if world is None:
        world = _env_int("WORLD_SIZE", "SLURM_NTASKS")
        rank = _env_int("RANK", "SLURM_PROCID")
        if world is None or world <= 1:
            return 0, 1, torch.device(device_type)
        missing = [n for n in ("MASTER_ADDR", "MASTER_PORT") if n not in os.environ]
        if init_method == "env://" and missing:
            raise RuntimeError(f"{world} processes in the environment, but "
                               f"{' and '.join(missing)} unset: set MASTER_ADDR to the rank-0 "
                               "host (under SLURM the first of SLURM_JOB_NODELIST) and "
                               "MASTER_PORT to a free port")
    rank = rank or 0
    if device_type == "cuda":
        if local_rank is None:
            local_rank = _env_int("LOCAL_RANK", "SLURM_LOCALID")
        index = rank if local_rank is None else local_rank
        if index >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs card {index}, but "
                               f"{torch.cuda.device_count()} are visible")
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    elif device_type == "cpu":
        device = torch.device("cpu")
    else:
        raise ValueError(f"device_type {device_type!r}: 'cuda' or 'cpu'")
    backend = backend or ("nccl" if device_type == "cuda" else "gloo")
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if backend == "nccl":
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world,
                            **kwargs)
    return rank, world, device


def local_rows(global_batch: int, rank: int, world: int) -> slice:
    """Rows ``[r B / W, (r + 1) B / W)`` of a global batch of B rows: rank
    r's share, the split ``shard_batch`` gives device r of the mesh."""
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split over {world} "
                         "ranks")
    n = global_batch // world
    return slice(rank * n, (rank + 1) * n)


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """In-place sum of ``t`` over the group; counted in ``_all_reduce.calls``,
    its bytes in the trace counter ``all_reduce_bytes``."""
    dist.all_reduce(t)
    _all_reduce.calls += 1
    trace.count("all_reduce_bytes", t.nbytes)
    return t


_all_reduce.calls = 0


class AllReduceSum(torch.autograd.Function):
    """The sum of a tensor over the group. Each rank's output is the same
    sum, so the gradient of any rank's input is the sum of every rank's
    output gradient: the backward is the same all-reduce."""

    @staticmethod
    def forward(ctx, x):
        return _all_reduce(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(memory_format=torch.contiguous_format))


def all_reduce_tensors(tensors: list[torch.Tensor], op: str = "sum") -> None:
    """Sum (``op="sum"``) or average (``"mean"``, the sum divided by the
    world size, as ``pmean``) tensors over the group, in place: one
    collective over all of them flattened into a single bucket of their
    promoted dtype (a bf16 tensor among float32 ones goes over in float32)."""
    if op not in ("sum", "mean"):
        raise ValueError(f"op {op!r}: 'sum' or 'mean'")
    if not tensors:
        return
    with trace.span("dist.all_reduce_tensors", calls=1):
        flat = _all_reduce(torch.cat([t.reshape(-1) for t in tensors]))
        if op == "mean":
            flat.div_(dist.get_world_size())
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, fn, world, device_type, init_method, backend, timeout, threads,
             local_ranks, out_dir, args):
    if threads:
        torch.set_num_threads(threads)
    rank, world, device = init_distributed(
        device_type, rank=rank, world=world, init_method=init_method, backend=backend,
        timeout=timeout, local_rank=None if local_ranks is None else local_ranks[rank])
    try:
        torch.save(fn(rank, world, device, *args), Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn, world: int, device_type: str, *args, backend: str | None = None,
          timeout: float | None = None, local_ranks: list[int] | None = None) -> list:
    """Run ``fn(rank, world, device, *args)`` on ``world`` new processes
    (``torch.multiprocessing``, spawned), one per rank of a group that
    meets on a free localhost port; returns each rank's return value, in
    rank order, its tensors on the CPU. ``fn`` and ``args`` are pickled, so
    ``fn`` is a module-level function of a module the children can import;
    CPU tensors in ``args`` are shared with the children
    (``torch.multiprocessing`` moves them to shared memory), not copied.
    On the CPU each rank takes 1/world of this process's torch threads.
    ``local_ranks`` gives each rank's card (rank r on card r by default); a
    rank that raises makes ``spawn`` raise, and the others are stopped."""
    import torch.multiprocessing as mp

    threads = max(1, torch.get_num_threads() // world) if device_type == "cpu" else None
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_spawned, nprocs=world, join=True,
                 args=(fn, world, device_type, f"tcp://127.0.0.1:{_free_port()}", backend,
                       timeout, threads, local_ranks, out_dir, args))
        return [torch.load(Path(out_dir) / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(world)]
