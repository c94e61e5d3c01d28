"""Meshes of ``(data, model, seq, expert)`` ranks: port of
``tpu_flash/parallel/mesh.py``, with the ``expert`` axis of the reference's
expert-parallel dry run (``__graft_entry__.py``'s one-axis ``("expert",)``
mesh) as a fourth axis, 1 unless asked for.

A rank has a device and a process holds ranks. The mesh's ranks are
numbered row-major over ``(data, model, seq, expert)``; a ``torch.distributed``
group of ``W`` processes (one process without it) splits them into ``W``
consecutive blocks of ``L = data·model·seq / W``, and process ``p`` holds
ranks ``[p·L, (p + 1)·L)``. Each rank has a ``torch.device``: all on the
current card by default (the counterpart of the reference's virtual CPU
devices), the caller's cards in consecutive blocks when it lists several
(then this process's ranks must lie on one axis line), the CPU in the
tests.

A collective over an axis runs on the line of that axis through this
process's ranks (:class:`AxisGroup`) in two parts: over the ranks inside
the process, a sum, max or concatenation in fixed rank order on the first
rank's device; then, where the line spans several processes, one
``torch.distributed`` collective on the sub-group of those processes.
``torch.distributed.device_mesh`` cannot hold several ranks in one
process, so the sub-groups are built with ``dist.new_group``: every
process calls :func:`make_mesh` with the same sizes, which creates the
groups of every axis line in one order on all of them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist

AXES = ("data", "model", "seq", "expert")


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def on(device: torch.device):
    """The context in which a rank's kernels launch: its card current (the
    launches take the current device), nothing on the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class _AllReduce(torch.autograd.Function):
    """Sum over a process group; the cotangent passes through unchanged
    (the row-parallel completion)."""

    @staticmethod
    def forward(ctx, x, group, op):
        out = x.clone()
        dist.all_reduce(out, op=op, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


class _Replicated(torch.autograd.Function):
    """A value that every process of a group holds alike; its cotangent is
    summed over the group (the column-parallel input)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


@dataclasses.dataclass
class AxisGroup:
    """This process's ranks on one line of a mesh axis.

    ``size`` ranks make up the line; this process holds positions
    ``first … first + len(devices) − 1`` of it, on ``devices``; ``group``
    is the ``torch.distributed`` sub-group of the processes holding the
    line, or None when it lies in this process."""

    name: str
    size: int
    first: int
    devices: List[torch.device]
    group: Optional[object] = None

    @property
    def local(self) -> int:
        return len(self.devices)

    @property
    def indices(self) -> range:
        return range(self.first, self.first + self.local)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def map(self, fn, *per_rank):
        """``[fn(i, *args_i) for each local rank i]``: one rank's work
        after another, each with its card current, ``per_rank`` holding one
        argument list a rank."""
        out = []
        for i, dev in enumerate(self.devices):
            with on(dev):
                out.append(fn(i, *(a[i] for a in per_rank)))
        return out

    def broadcast(self, x: torch.Tensor) -> List[torch.Tensor]:
        """A replicated value on each local rank's device (the same tensor
        where the device is the first rank's). Across processes its
        cotangent is summed over the group."""
        if self.group is not None and x.requires_grad:
            x = _Replicated.apply(x, self.group)
        return [x.to(dev) for dev in self.devices]

    def _reduce(self, parts, op):
        out = parts[0]
        for p in parts[1:]:
            p = p.to(out.device)
            out = out + p if op == "sum" else torch.maximum(out, p)
        if self.group is not None:
            rop = dist.ReduceOp.SUM if op == "sum" else dist.ReduceOp.MAX
            if op == "sum" and out.requires_grad:
                return _AllReduce.apply(out, self.group, rop)
            out = out.clone()
            dist.all_reduce(out, op=rop, group=self.group)
        return out

    def sum(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Σ over the line: the local parts in rank order on the first
        rank's device, then over the processes (the reference's psum)."""
        return self._reduce(list(parts), "sum")

    def max(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """Elementwise max over the line (the reference's pmax)."""
        return self._reduce(list(parts), "max")


@dataclasses.dataclass
class Mesh:
    """Ranks over ``(data, model, seq, expert)`` and the processes that
    hold them.

    ``shape``: axis sizes; ``devices``: the device of each rank this
    process holds, by global rank; ``world``/``process``: the
    ``torch.distributed`` group's size and this process's rank in it (1
    and 0 without one); ``box``: the extent of this process's block of
    ranks along each axis."""

    shape: dict
    devices: dict
    world: int
    process: int
    box: tuple
    groups: dict

    @property
    def size(self) -> int:
        return math.prod(self.shape[a] for a in AXES)

    @property
    def local_ranks(self) -> range:
        n = self.size // self.world
        return range(self.process * n, (self.process + 1) * n)

    def coords(self, rank: int) -> tuple:
        out = []
        for a in reversed(AXES):
            out.append(rank % self.shape[a])
            rank //= self.shape[a]
        return tuple(reversed(out))

    def rank_of(self, coords) -> int:
        rank = 0
        for a, c in zip(AXES, coords):
            rank = rank * self.shape[a] + c
        return rank

    def _process_of(self, rank: int) -> int:
        return rank // (self.size // self.world)

    def axis(self, name: str) -> AxisGroup:
        """The line of axis ``name`` through this process's first rank."""
        ax = AXES.index(name)
        c0 = list(self.coords(self.local_ranks[0]))
        devices = []
        for j in range(self.box[ax]):
            c = list(c0)
            c[ax] += j
            devices.append(self.devices[self.rank_of(c)])
        return AxisGroup(name=name, size=self.shape[name], first=c0[ax],
                         devices=devices,
                         group=self.groups.get((name, self._line_key(ax, c0))))

    def _line_key(self, ax: int, coords) -> tuple:
        """The processes holding the line of axis ``ax`` through
        ``coords``, in order."""
        procs = []
        for j in range(self.shape[AXES[ax]]):
            c = list(coords)
            c[ax] = j
            p = self._process_of(self.rank_of(c))
            if p not in procs:
                procs.append(p)
        return tuple(procs)


def _box(shape, local: int) -> tuple:
    """The extents of a row-major block of ``local`` consecutive ranks
    along the axes, which must be a box: whole trailing axes, then a part
    of one axis that divides it."""
    box, rest = [1] * len(AXES), local
    for ax in reversed(range(len(AXES))):
        size = shape[AXES[ax]]
        if rest % size == 0:
            box[ax], rest = size, rest // size
        elif size % rest == 0:
            box[ax], rest = rest, 1
        else:
            break
    if rest != 1:
        raise ValueError(f"{local} consecutive ranks of a mesh {shape} do "
                         "not form a box: choose sizes the process count "
                         "divides")
    return tuple(box)


def _normalize(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def make_mesh(data: int = 1, model: int = 1, seq: int = 1,
              devices=None, expert: int = 1) -> Mesh:
    """A ``(data, model, seq, expert)`` mesh of ``data·model·seq·expert``
    ranks.

    Axis roles as the reference's: ``data`` the batch, ``model`` tensor
    parallelism over heads and the MLP hidden dim, ``seq`` sequence
    sharding, ``expert`` a MoE layer's experts (``models/moe.py``). ``devices``: one device for all of this process's ranks, or
    a list that takes the ranks in consecutive blocks (four cards and
    eight ranks: two ranks a card); default the current card. A list
    needs this process's ranks on one axis line (its block spans one axis):
    the collectives run on the lines through the process's first rank, so
    the ranks off those lines would hold cards that no work runs on, and
    such a mesh raises. Under
    ``torch.distributed`` every process calls this with the same sizes;
    the ranks split evenly over the processes and each process gets the
    sub-groups of its axis lines."""
    shape = dict(data=data, model=model, seq=seq, expert=expert)
    if min(shape.values()) < 1:
        raise ValueError(f"mesh axes must be >= 1, got {shape}")
    world = dist.get_world_size() if _distributed() else 1
    process = dist.get_rank() if _distributed() else 0
    n = math.prod(shape.values())
    if n % world:
        raise ValueError(f"{n} ranks do not split over {world} processes")
    local = n // world
    box = _box(shape, local)
    if devices is None:
        devices = ["cuda"]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = [_normalize(dv) for dv in devices]
    if len(devs) > local:
        raise ValueError(f"{len(devs)} devices for {local} ranks")
    if len(devs) > 1 and sum(e > 1 for e in box) > 1:
        raise ValueError(f"a list of devices needs this process's ranks on "
                         f"one axis line; its block spans {box} of {shape}")
    first = process * local
    rank_dev = {first + j: devs[j * len(devs) // local] for j in range(local)}
    mesh = Mesh(shape=shape, devices=rank_dev, world=world, process=process,
                box=box, groups={})
    if world > 1:
        # every process creates every line's group, in one order
        made = {}
        for ax, name in enumerate(AXES):
            for rank in range(n):
                c = mesh.coords(rank)
                if c[ax]:
                    continue
                key = mesh._line_key(ax, c)
                if len(key) > 1 and key not in made:
                    made[key] = dist.new_group(list(key))
                if len(key) > 1:
                    mesh.groups[(name, key)] = made[key]
    return mesh
