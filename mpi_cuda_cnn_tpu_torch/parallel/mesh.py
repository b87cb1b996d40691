"""The device mesh of one rank (counterpart of the reference's
`parallel/mesh.py`).

The C reference's "mesh" is MPI_COMM_WORLD with contiguous rank sharding
(cnnmpi.c:456-458); the JAX package's is a `jax.sharding.Mesh` with named
axes. Here one process drives one device, so a `Mesh` is this rank's view
of the named axes: their sizes, its rank and the world size, its
`torch.device`, the `torch.distributed` group the axes span, and its
coordinates. Rank r sits at the coordinates of r in the axes' shape with
the last axis varying fastest, as `jax.make_mesh` lays its devices out
(`data:2,seq:2`: rank d * 2 + s; `pipe:2,data:2`: rank p * 2 + d). The
axes are 'data', 'model' (`parallel/tp.py`, `parallel/tp_sp.py`), 'pipe'
(`parallel/pp.py`, `parallel/pp_lm.py`), 'seq' (`parallel/sp.py`) and
'expert' (`parallel/ep.py`). A rank has a process group for its line
along every axis, and along every set of axes, that spans part of the
world (`Mesh.group_of`), so that a reduction over 'data' and 'seq' of a
four-axis mesh is one collective.
"""

from __future__ import annotations

import dataclasses
import itertools
import math

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"


def local_device_count() -> int:
    """Cards this process sees, or 1 on a machine without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. `group` is the process group of the
    axes (None: the world-1 mesh of a process with no group, where every
    collective is the identity and none is made). `axis_groups` holds,
    for an axis, or a tuple of axes in the mesh's order, of size > 1
    that spans part of the world, the group of this rank's line along
    it (`axis_lines`); axes that span the world use `group`."""

    shape: dict[str, int]
    rank: int
    world: int
    device: torch.device
    group: object | None
    axis_groups: dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def index(self, axis: str) -> int:
        """This rank's coordinate along `axis` (0 for an axis the mesh
        does not have)."""
        if axis not in self.shape:
            return 0
        coords = np.unravel_index(self.rank, tuple(self.shape.values()))
        return int(coords[list(self.shape).index(axis)])

    def line(self, axis: str | tuple[str, ...]) -> list[int]:
        """The global ranks of this rank's line along `axis` (or a tuple
        of axes), in the axes' order, the last fastest."""
        axes = [a for a in ((axis,) if isinstance(axis, str) else axis)
                if a in self.shape]
        if not axes:
            return [self.rank]
        return next(ln for ln in axis_lines(self.shape, axes)
                    if self.rank in ln)

    def sub(self, axis: str | tuple[str, ...]) -> "Mesh":
        """This rank's line along `axis` (or a tuple of axes) as a mesh
        of its own: its shape those axes', its rank the index in the
        line, its group the line's (None when the line is this rank
        alone). A collective on it spans the line."""
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        line = self.line(axes)
        return Mesh(shape={a: self.shape.get(a, 1) for a in axes},
                    rank=line.index(self.rank), world=len(line),
                    device=self.device,
                    group=self.group_of(axes) if len(line) > 1 else None)

    def axis_group(self, axis: str):
        """The process group of this rank's line along `axis`."""
        if self.shape.get(axis, 1) == self.world:
            return self.group
        return self.axis_groups[axis]

    def group_of(self, axes: str | tuple[str, ...]):
        """The process group of this rank's ranks along `axes` (one axis
        or a tuple of them): the mesh's group when they are the world
        (a one-rank group's too), None when they are this rank alone of
        a larger world or there is no group (no collective is needed),
        else the group of this rank's line along the one axis of size >
        1 among them."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        wide = [a for a in axes if self.shape.get(a, 1) > 1]
        n = math.prod(self.shape[a] for a in wide)
        if self.group is None:
            return None
        if n >= self.world:
            return self.group
        if n == 1:
            return None
        key = wide[0] if len(wide) == 1 else tuple(
            a for a in self.shape if a in wide)
        return self.axis_groups[key]


def axis_lines(shape: dict[str, int],
               axis: str | list[str] | tuple[str, ...]) -> list[list[int]]:
    """The ranks of every line along `axis`, or along a set of axes
    (ranks that differ in those coordinates only), each in the axes'
    order (the mesh's, the last fastest), the lines in rank order of
    their first rank."""
    names = list(shape)
    axes = sorted({axis} if isinstance(axis, str) else set(axis),
                  key=names.index)
    ranks = np.arange(math.prod(shape.values())).reshape(
        tuple(shape.values()))
    lines = np.moveaxis(ranks, [names.index(a) for a in axes],
                        range(-len(axes), 0))
    return lines.reshape(-1, math.prod(shape[a] for a in axes)).tolist()


def describe_mesh(mesh: Mesh) -> dict:
    """JSON-able mesh summary (axis name -> size, plus the device count),
    as the reference records it in checkpoint manifests. Axis order is
    kept."""
    return {"axes": dict(mesh.shape), "devices": int(mesh.size)}


def mesh_devices(axes: dict[str, int],
                 devices: list[torch.device]) -> list[torch.device]:
    """The devices of a mesh of `axes`: the first prod(sizes) of
    `devices`, one per rank. Raises ValueError when there are fewer."""
    total = math.prod(axes.values())
    if total > len(devices):
        raise ValueError(f"mesh {axes} needs {total} devices, have "
                         f"{len(devices)}")
    return list(devices[:total])


def device_mesh(device: torch.device) -> Mesh:
    """The world-1 data mesh of one device with no process group: every
    collective on it is the identity and none is made (a trainer given
    no mesh runs on this one)."""
    return Mesh(shape={DATA_AXIS: 1}, rank=0, world=1,
                device=torch.device(device), group=None)


def make_mesh(axes: dict[str, int] | None = None, *,
              devices: list[torch.device] | None = None) -> Mesh:
    """This rank's mesh of `axes` (None: {'data': every rank}) over
    `devices`, one per rank in rank order; rank r runs on devices[r]. The
    axis sizes must multiply to the world size of the initialized process
    group, or to 1 without one. `devices` None: without a group, the
    visible cards, or the CPU; in a group, where a process knows only its
    own device, this process's current card (cuda:LOCAL_RANK under
    torchrun, `distributed.initialize_distributed`), else the CPU."""
    grouped = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if grouped else 1
    rank = dist.get_rank() if grouped else 0
    cuda = torch.cuda.is_available()
    if devices is None and grouped:
        devices = [torch.device("cuda", torch.cuda.current_device())
                   if cuda else torch.device("cpu")] * world
    elif devices is None:
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if cuda else [torch.device("cpu")])
    if axes is None:
        axes = {DATA_AXIS: world}
    devices = mesh_devices(axes, devices)
    if len(devices) != world:
        raise ValueError(f"mesh {axes} has {len(devices)} ranks, the process "
                         f"group {world}: start one process per rank "
                         "(parallel.distributed.run_ranks or torchrun)")
    # One group per line of every axis, and of every set of axes, of size
    # > 1 that spans part of the world: every rank creates every group, in
    # one order, or the creation hangs.
    axis_groups = {}
    wide = [a for a, n in axes.items() if n > 1]
    for k in range(1, len(wide) + 1):
        for subset in itertools.combinations(wide, k):
            n = math.prod(axes[a] for a in subset)
            if not grouped or n >= world:
                continue
            for ranks in axis_lines(axes, subset):
                g = dist.new_group(ranks)
                if rank in ranks:
                    axis_groups[subset[0] if k == 1 else subset] = g
    return Mesh(shape=dict(axes), rank=rank, world=world,
                device=torch.device(devices[rank]),
                group=dist.group.WORLD if grouped else None,
                axis_groups=axis_groups)
