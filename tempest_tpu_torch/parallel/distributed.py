"""Multi-process initialisation and the mesh of one shard per process — the
counterpart of ``tempest_tpu/parallel/distributed.py``.

Each process (rank) calls :func:`initialize`, which brings up
``torch.distributed``: NCCL with one rank per card (on ``cuda:LOCAL_RANK``),
or gloo when the caller asks for ``device="cpu"``.  Then
:func:`global_mesh` is a mesh of one shard per rank, and the sharded
pipelines of ``parallel.sharded`` run unchanged on it: every rank calls the
same function with the same arguments, computes its own shard, and gets
the replicated outputs (JAX's multi-controller contract).

One process per card matters here: the reconstruction step is bound by the
host's launches, so one process driving four cards enqueues four steps in
turn.  A torchrun launch of one rank per card::

    torchrun --nproc-per-node 4 my_stream.py   # calls initialize(), global_mesh()

Nothing here tells a program of a cluster: address, world size and rank come
from the arguments or from ``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
``RANK`` and ``LOCAL_RANK`` as torchrun sets them.
"""

from __future__ import annotations

import os

import torch

from .mesh import Mesh, ProcessGroupCollectives, make_mesh

__all__ = ["initialize", "global_mesh", "is_distributed"]


def _env_int(name: str) -> int:
    value = os.environ.get(name)
    if value is None:
        raise ValueError(f"pass it as an argument or set {name} (torchrun does)")
    return int(value)


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: torch.device | str | None = None,
) -> None:
    """Join the process group of a multi-process run; a second call does
    nothing.

    ``coordinator_address`` is ``host:port`` (or ``tcp://host:port``) of
    rank 0, default ``MASTER_ADDR:MASTER_PORT``; ``num_processes`` and
    ``process_id`` default to ``WORLD_SIZE`` and ``RANK``.  ``device=None``
    is the card ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` defaulting to the rank)
    with NCCL, and raises when there is no card; ``device="cpu"`` joins
    with gloo."""
    import torch.distributed as dist

    if dist.is_initialized():
        return
    addr = coordinator_address
    if addr is None:
        host, port = os.environ.get("MASTER_ADDR"), os.environ.get("MASTER_PORT")
        if not (host and port):
            raise ValueError("no coordinator address: pass coordinator_address='host:port' "
                             "or set MASTER_ADDR and MASTER_PORT")
        addr = f"{host}:{port}"
    if "://" not in addr:
        addr = f"tcp://{addr}"
    world = _env_int("WORLD_SIZE") if num_processes is None else int(num_processes)
    rank = _env_int("RANK") if process_id is None else int(process_id)
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize() puts each rank on a CUDA card and found none; "
                               "pass device='cpu' to join with gloo on the CPU")
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo", init_method=addr,
                            world_size=world, rank=rank)


def is_distributed() -> bool:
    """Whether this process is one of several ranks of a process group."""
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def global_mesh(axis_name: str = "blocks") -> Mesh:
    """A 1-D mesh of one shard per rank, in rank order, this rank's shard on
    its device (the current card with NCCL, the CPU with gloo).  Without a
    process group: the one-process mesh over every visible card."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return make_mesh(axis_name=axis_name)
    if dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    comm = ProcessGroupCollectives(axis_name)
    return Mesh({axis_name: comm.world}, [comm.rank], [device], comm)
