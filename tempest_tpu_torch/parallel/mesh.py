"""Device meshes for the sharded pipelines — the counterpart of
``tempest_tpu/parallel/mesh.py``, with the collectives those pipelines use.

A mesh is a grid of shards with named axes: ``"blocks"`` (time spans of one
stream, candidate modes or carriers, one per shard) and, for the 2-D mode
search, ``"modes"``.  Every function of ``parallel.sharded`` is written as a
per-shard function on one device (shard in, halo in, partial out) and five
collectives over one axis, the interface of :class:`LocalCollectives` and
:class:`ProcessGroupCollectives`:

* ``from_next``: each shard receives the next shard's tensor, circularly
  (the halo; JAX's ``ppermute``);
* ``all_gather``: every shard receives the stack of all shards' tensors;
* ``all_reduce_sum`` and ``all_reduce_min`` (``psum``, ``pmin``);
* ``mean`` (``pmean``).

The collectives take ``parts``, one tensor per shard that this process
drives (``Mesh.local``), and return one tensor per such shard, on its
device.  Two backends, as JAX has two:

* :func:`make_mesh` — ONE process drives every shard, in a Python loop (the
  single-controller ``Mesh``).  Collectives are copies between the shards'
  devices (``.to(device, non_blocking=True)`` on each card's current
  stream); sums are taken in shard order, so they do not depend on where the
  shards lie.  A device list may repeat a device: four shards on one card
  run the mesh's code on one card, eight on the CPU run it in the tests.
* ``parallel.distributed.global_mesh`` — one process per shard
  (``torch.distributed``: NCCL between cards, gloo on the CPU), the
  multi-controller run: every rank calls the same sharded function with the
  same arguments and gets the replicated outputs.

``block_sharding`` and ``replicated`` keep the JAX module's names.  Torch has
no sharded tensor to attach them to, so here they only describe how a host
array is laid onto the shards (:meth:`Sharding.place`); JAX's ``P`` and
``NamedSharding``, which that module re-exports from JAX, have no
counterpart.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np
import torch

__all__ = [
    "Mesh",
    "Sharding",
    "LocalCollectives",
    "ProcessGroupCollectives",
    "make_mesh",
    "block_sharding",
    "replicated",
]


class _Traffic:
    """Calls of each collective and the bytes a shard receives from the
    others in them (``from_next``: the neighbour's tensor; the gathers and
    reductions: the other shards' tensors), summed over this process's
    shards — the same count whichever backend moves them."""

    def __init__(self) -> None:
        self.calls: collections.Counter = collections.Counter()
        self.nbytes: collections.Counter = collections.Counter()

    def count(self, op: str, parts: list[torch.Tensor], peers: int) -> None:
        self.calls[op] += 1
        self.nbytes[op] += sum(p.numel() * p.element_size() for p in parts) * peers

    def reset(self) -> None:
        self.calls.clear()
        self.nbytes.clear()


class LocalCollectives(_Traffic):
    """The collectives of a one-process mesh: every shard's part is here,
    and a collective is copies between the shards' devices."""

    def __init__(self, shape: dict[str, int], devices: list[torch.device]) -> None:
        super().__init__()
        self._axes = list(shape)
        self._grid = np.arange(len(devices)).reshape(tuple(shape.values()))
        self._devices = list(devices)

    def _groups(self, axis: str) -> np.ndarray:
        """Shard indices along ``axis``: one row per combination of the
        other axes' coordinates, in the axis's order."""
        g = np.moveaxis(self._grid, self._axes.index(axis), -1)
        return g.reshape(-1, g.shape[-1])

    def _per_device(self, parts, axis, combine) -> list[torch.Tensor]:
        """``combine(list of the group's parts on a device)`` for every
        shard, computed once per distinct device of each group."""
        out: list[torch.Tensor | None] = [None] * len(parts)
        for group in self._groups(axis):
            done: dict[torch.device, torch.Tensor] = {}
            for k in group:
                dev = self._devices[k]
                if dev not in done:
                    done[dev] = combine([parts[j].to(dev, non_blocking=True) for j in group])
                out[k] = done[dev]
        return out

    def from_next(self, parts: list[torch.Tensor], axis: str) -> list[torch.Tensor]:
        out: list[torch.Tensor | None] = [None] * len(parts)
        for group in self._groups(axis):
            for i, k in enumerate(group):
                nxt = group[(i + 1) % len(group)]
                out[k] = parts[nxt].to(self._devices[k], non_blocking=True)
        self.count("from_next", parts, 1)
        return out

    def all_gather(self, parts: list[torch.Tensor], axis: str) -> list[torch.Tensor]:
        self.count("all_gather", parts, self._groups(axis).shape[1] - 1)
        return self._per_device(parts, axis, torch.stack)

    def all_reduce_sum(self, parts: list[torch.Tensor], axis: str) -> list[torch.Tensor]:
        def in_order(xs):
            acc = xs[0]
            for x in xs[1:]:
                acc = acc + x
            return acc

        self.count("all_reduce_sum", parts, self._groups(axis).shape[1] - 1)
        return self._per_device(parts, axis, in_order)

    def all_reduce_min(self, parts: list[torch.Tensor], axis: str) -> list[torch.Tensor]:
        self.count("all_reduce_min", parts, self._groups(axis).shape[1] - 1)
        return self._per_device(parts, axis, lambda xs: torch.amin(torch.stack(xs), dim=0))

    def mean(self, parts: list[torch.Tensor], axis: str) -> list[torch.Tensor]:
        n = self._groups(axis).shape[1]
        return [s / n for s in self.all_reduce_sum(parts, axis)]


class ProcessGroupCollectives(_Traffic):
    """The collectives of a mesh of one shard per process, through
    ``torch.distributed`` (the process group of ``distributed.initialize``).
    One axis: the ranks in order.  A collective that fails raises."""

    def __init__(self, axis: str) -> None:
        import torch.distributed as dist

        super().__init__()
        self._dist = dist
        self._axis = axis
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()

    def _check(self, parts, axis) -> torch.Tensor:
        if axis != self._axis or len(parts) != 1:
            raise ValueError(f"a process-group mesh has one axis {self._axis!r} and one shard "
                             f"a process; got axis {axis!r} and {len(parts)} parts")
        return parts[0].contiguous()

    def from_next(self, parts, axis):
        part = self._check(parts, axis)
        self.count("from_next", parts, 1)
        if self.world == 1:
            return [part]
        dist = self._dist
        got = torch.empty_like(part)
        ops = [dist.P2POp(dist.isend, part, (self.rank - 1) % self.world),
               dist.P2POp(dist.irecv, got, (self.rank + 1) % self.world)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [got]

    def all_gather(self, parts, axis):
        part = self._check(parts, axis)
        self.count("all_gather", parts, self.world - 1)
        out = [torch.empty_like(part) for _ in range(self.world)]
        self._dist.all_gather(out, part)
        return [torch.stack(out)]

    def _all_reduce(self, op_name, parts, axis, op):
        part = self._check(parts, axis).clone()
        self.count(op_name, parts, self.world - 1)
        self._dist.all_reduce(part, op=op)
        return [part]

    def all_reduce_sum(self, parts, axis):
        return self._all_reduce("all_reduce_sum", parts, axis, self._dist.ReduceOp.SUM)

    def all_reduce_min(self, parts, axis):
        return self._all_reduce("all_reduce_min", parts, axis, self._dist.ReduceOp.MIN)

    def mean(self, parts, axis):
        return [s / self.world for s in self.all_reduce_sum(parts, axis)]


class Mesh:
    """A grid of shards: ``shape`` maps axis names to sizes (as JAX's
    ``mesh.shape``), ``local`` lists the flat (row-major) indices of the
    shards that this process drives and ``devices`` their devices, and
    ``comm`` holds the collectives.  ``device`` is where replicated outputs
    are placed: the device of this process's first shard."""

    def __init__(self, shape: dict[str, int], local: list[int], devices: list[torch.device],
                 comm) -> None:
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))
        self.local = list(local)
        self.devices = [torch.device(d) for d in devices]
        self.comm = comm

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def coord(self, index: int, axis: str) -> int:
        """Coordinate of shard ``index`` along ``axis``."""
        return int(np.unravel_index(index, tuple(self.shape.values()))[self.axis_names.index(axis)])

    def shards(self):
        """(flat index, device) of each shard that this process drives."""
        return list(zip(self.local, self.devices))

    def gather(self, parts: list[torch.Tensor], axis: str) -> torch.Tensor:
        """The parts of an output split along ``axis``, concatenated in shard
        order along dim 0 on ``self.device`` — JAX's replicated
        ``out_shardings``.  On a mesh of more axes, the shards that share the
        first shard's other coordinates (the others hold replicas)."""
        if isinstance(self.comm, ProcessGroupCollectives):
            return self.comm.all_gather(parts, axis)[0].flatten(0, 1)
        first = {a: self.coord(self.local[0], a) for a in self.axis_names if a != axis}
        row = [p for k, p in zip(self.local, parts)
               if all(self.coord(k, a) == c for a, c in first.items())]
        self.comm.count("all_gather", row[1:], 1)
        return torch.cat([p.to(self.device, non_blocking=True) for p in row])

    def __repr__(self) -> str:
        where = "processes" if isinstance(self.comm, ProcessGroupCollectives) else "one process"
        return f"Mesh({self.shape}, devices {[str(d) for d in self.devices]}, {where})"


@dataclasses.dataclass(frozen=True)
class Sharding:
    """How an array is laid onto a mesh's shards: split along its leading
    axis over mesh axis ``axis``, or (``axis=None``) one copy a shard."""

    mesh: Mesh
    axis: str | None

    def place(self, x) -> list[torch.Tensor]:
        """The part of ``x`` (numpy array or tensor) of each shard this
        process drives, on that shard's device.  A split takes row
        ``coord(shard, axis)`` of an ``x`` with one row a shard."""
        out = []
        for k, dev in self.mesh.shards():
            part = x if self.axis is None else x[self.mesh.coord(k, self.axis)]
            if isinstance(part, np.ndarray):
                part = torch.from_numpy(np.ascontiguousarray(part))
            out.append(part.to(dev, non_blocking=True))
        return out


def make_mesh(
    n_devices: int | dict[str, int] | None = None,
    axis_name: str = "blocks",
    devices: list | None = None,
) -> Mesh:
    """A one-process mesh over the first ``n_devices`` CUDA cards (default:
    all visible), on one axis ``axis_name``; raises when fewer cards are
    visible, and never puts two shards on one card by itself.

    ``devices`` names the shards' devices instead, and may repeat one
    (``["cpu"] * 8``, ``["cuda:0"] * 4``).  ``n_devices`` may be a dict of
    axis sizes, ``{"blocks": 2, "modes": 4}``, for a mesh of several axes
    (row-major over ``devices``)."""
    shape = dict(n_devices) if isinstance(n_devices, dict) else None
    want = int(np.prod(list(shape.values()))) if shape else n_devices
    if want is not None and want < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n_devices}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = count if want is None else want
        if count == 0 or want > count:
            raise RuntimeError(
                f"make_mesh needs {want or 1} CUDA card(s) and sees {count}; pass "
                "devices=[...] to name the shards' devices (a list may repeat one)")
        devs = [torch.device("cuda", i) for i in range(want)]
    else:
        devs = [torch.device(d) for d in devices]
        if want is not None:
            if len(devs) < want:
                raise ValueError(f"{want} shards asked for, {len(devs)} devices given")
            devs = devs[:want]
    if shape is None:
        shape = {axis_name: len(devs)}
    return Mesh(shape, list(range(len(devs))), devs, LocalCollectives(shape, devs))


def block_sharding(mesh: Mesh, axis_name: str = "blocks") -> Sharding:
    """Split the leading (time-block / stream / candidate) axis over
    ``axis_name``.  Torch has no sharded tensor for this to annotate, as
    JAX's ``NamedSharding`` does: it only says how :meth:`Sharding.place`
    lays an array onto the shards."""
    return Sharding(mesh, axis_name)


def replicated(mesh: Mesh) -> Sharding:
    """One copy of the whole array a shard (a description for
    :meth:`Sharding.place`, as :func:`block_sharding`)."""
    return Sharding(mesh, None)
