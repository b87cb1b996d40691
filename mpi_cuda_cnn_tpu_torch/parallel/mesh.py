"""The device mesh of one rank (counterpart of the reference's
`parallel/mesh.py`).

The C reference's "mesh" is MPI_COMM_WORLD with contiguous rank sharding
(cnnmpi.c:456-458); the JAX package's is a `jax.sharding.Mesh` with named
axes. Here one process drives one device, so a `Mesh` is this rank's view
of the named axes: their sizes, its rank and the world size, its
`torch.device`, and the `torch.distributed` group the axes span. Only the
'data' axis is ported (`utils.config.check_supported`); the names of the
others stay so that a later axis slots in without an API change.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
PIPE_AXIS = "pipe"


def local_device_count() -> int:
    """Cards this process sees, or 1 on a machine without one."""
    return torch.cuda.device_count() if torch.cuda.is_available() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh. `group` is the process group of the
    axes (None: the world-1 mesh of a process with no group, where every
    collective is the identity and none is made)."""

    shape: dict[str, int]
    rank: int
    world: int
    device: torch.device
    group: object | None

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


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
    return Mesh(shape=dict(axes), rank=rank, world=world,
                device=torch.device(devices[rank]),
                group=dist.group.WORLD if grouped else None)
