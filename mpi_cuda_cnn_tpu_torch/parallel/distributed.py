"""Process management of data-parallel runs (counterpart of the
reference's `parallel/distributed.py`).

The C reference starts its ranks with `mpirun -np 8` and joins them with
MPI_Init (Makefile:44, cnnmpi.c:419); the JAX package joins host
processes with `jax.distributed.initialize()`. Here one process drives
one device, over `torch.distributed`:

- `initialize_distributed()` joins a group that `torchrun` set up (its
  RANK, WORLD_SIZE, LOCAL_RANK and MASTER_ADDR variables) and otherwise
  stays single-process;
- `run_ranks(fn, world, ...)` starts `world` processes itself, with the
  spawn start method (CUDA does not survive a fork), joins them through a
  `FileStore` in a fresh temporary directory (no TCP port to collide
  over), builds each rank's mesh of the given axes (the data axis of
  every rank by default), calls `fn(mesh, ...)` on each and returns each
  rank's
  picklable result. `fn` must be importable from the port: a spawned
  child imports the module that defines it, and nothing of the JAX
  package may come with it.

The backend follows the ranks-to-devices map (`pick_backend`): NCCL when
every rank has a card of its own, gloo on the CPU and when ranks share a
card (NCCL refuses two ranks on one GPU; gloo stages CUDA tensors through
the host). A backend is never swapped after an error.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import traceback
from contextlib import contextmanager
from multiprocessing.connection import wait
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .._device import local_card
from ..utils.clock import monotonic
from ..utils.logging import get_logger
from .mesh import DATA_AXIS, local_device_count, make_mesh

# A collective that waits this long has lost a rank.
COLLECTIVE_TIMEOUT_S = 300


@dataclasses.dataclass(frozen=True)
class ProcessInfo:
    process_index: int
    process_count: int
    local_devices: int
    global_devices: int


def launched_by_torchrun() -> bool:
    """The environment names this process a rank of a torchrun world."""
    return all(k in os.environ for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK",
                                          "MASTER_ADDR"))


def initialize_distributed(device: torch.device | None = None
                           ) -> ProcessInfo:
    """Join the process group `torchrun` describes in the environment,
    this rank on `device` (None: its card, `_device.local_card`, when
    CUDA is available, else the CPU): NCCL on a card, gloo on the CPU.
    Without those variables, or once joined, a no-op."""
    if launched_by_torchrun() and not dist.is_initialized():
        if device is None:
            device = (local_card() if torch.cuda.is_available()
                      else torch.device("cpu"))
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if device.type == "cuda" else "gloo",
            init_method="env://",
            timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return process_info()


def process_info() -> ProcessInfo:
    grouped = dist.is_initialized()
    count = dist.get_world_size() if grouped else 1
    return ProcessInfo(process_index=dist.get_rank() if grouped else 0,
                       process_count=count,
                       local_devices=local_device_count(),
                       global_devices=count)


def barrier(name: str) -> None:
    """Block until every rank reaches this point; a no-op at world 1.
    `name` names the site in a hang's traceback (gloo and NCCL barriers
    carry no key)."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def pick_backend(devices: list[torch.device]) -> str:
    """NCCL when every rank has a card of its own; gloo when every rank
    is on the CPU or ranks share a card."""
    devices = [torch.device(d) for d in devices]
    kinds = {d.type for d in devices}
    if kinds == {"cpu"}:
        return "gloo"
    if kinds != {"cuda"}:
        raise ValueError(f"ranks on {devices}: all on the CPU or all on "
                         "cards")
    if len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


@contextmanager
def process_group(backend: str, rank: int, world: int, store_path: str):
    """Join a `world`-rank group of `backend` through the FileStore at
    `store_path` for the duration of the block."""
    store = dist.FileStore(store_path, world)
    dist.init_process_group(
        backend, store=store, rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        # Every rank is connected before any runs: a rank that fails at
        # once and leaves would otherwise cut a slower peer's connection
        # mid-join, and the peer would report that instead of its own run.
        dist.barrier()
        yield
    finally:
        dist.destroy_process_group()


def _rank_main(fn, rank: int, backend: str, devices: list[torch.device],
               store_path: str, args: tuple, kwargs: dict,
               out_dir: str, axes: dict[str, int]) -> None:
    """A spawned rank: pin its device, join the group, run fn(mesh, *args,
    **kwargs) on its mesh of `axes` and pickle its result to
    out_dir/<rank>.pkl, or its failure: the traceback, the names of the
    exception's classes (base classes too) and the planned faults that
    had fired (`fired_faults`, which the rank entries set on the way
    out; `train.ranks.supervise_world` restarts from them)."""
    out = Path(out_dir) / f"{rank}.pkl"
    world = len(devices)
    try:
        if devices[rank].type == "cuda":
            torch.cuda.set_device(devices[rank])
        else:
            # One intra-op thread: with several, MKL and oneDNN split some
            # products by the threads they get, and on a loaded host a
            # launch can round another way (1.4e-7 apart after 8 steps),
            # so two launches of a world would not end bit for bit.
            torch.set_num_threads(1)
        with process_group(backend, rank, world, store_path):
            mesh = make_mesh(axes, devices=devices)
            result = ("ok", fn(mesh, *args, **kwargs))
    except BaseException as e:
        failure = {"traceback": traceback.format_exc(),
                   "types": [c.__name__ for c in type(e).__mro__],
                   "fired": list(getattr(e, "fired_faults", ()))}
        out.write_bytes(pickle.dumps(("error", failure)))
        raise
    out.write_bytes(pickle.dumps(result))


class RankError(RuntimeError):
    """A rank of run_ranks failed (its traceback is in the message).
    `failures`: {"rank", "types", "fired"} of each rank that reported a
    failure (a rank stopped by the others' failure may report none);
    `exits`: the "exit" of each rank that returned a result."""

    def __init__(self, msg: str, failures: list[dict] | None = None,
                 exits: list[int] | None = None):
        super().__init__(msg)
        self.failures = list(failures or ())
        self.exits = list(exits or ())


def run_ranks(fn, world: int, *, devices: list | None = None,
              args: tuple = (), kwargs: dict | None = None,
              timeout: float | None = None,
              axes: dict[str, int] | None = None) -> list:
    """Run fn(mesh, *args, **kwargs) on `world` spawned ranks, rank r on
    devices[r] (None: the CPU for every rank), over
    `pick_backend(devices)`, each with its mesh of `axes` (None: {"data":
    world}), and return their results in rank order. Raises RankError
    when a rank fails (after stopping the others) and TimeoutError when
    the ranks outlive `timeout` seconds (None: no limit)."""
    if world < 1:
        raise ValueError(f"world {world}: want >= 1")
    axes = dict(axes or {DATA_AXIS: world})
    devices = [torch.device(d) for d in
               (devices or [torch.device("cpu")] * world)]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    backend = pick_backend(devices)
    get_logger().info("ranks=%d backend=%s devices=%s", world, backend,
                      ",".join(str(d) for d in devices))
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, backend, devices, store, args,
                                   kwargs or {}, tmp, axes), daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _wait_all(procs, timeout)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        results, errors, failures = [], [], []
        for r, p in enumerate(procs):
            path = Path(tmp) / f"{r}.pkl"
            if not path.exists():
                errors.append(f"rank {r}: exit code {p.exitcode}, no result")
                continue
            status, value = pickle.loads(path.read_bytes())
            if status != "ok":
                errors.append(f"rank {r}:\n{value['traceback']}")
                failures.append({"rank": r, "types": value["types"],
                                 "fired": value["fired"]})
                continue
            results.append(value)
    if errors:
        raise RankError("\n".join(errors), failures,
                        [x["exit"] for x in results
                         if isinstance(x, dict) and "exit" in x])
    return results


def _wait_all(procs, timeout: float | None) -> None:
    """Wait for every process to exit. When one exits non-zero, give the
    others a few seconds (their collectives fail) and stop waiting."""
    deadline = None if timeout is None else monotonic() + timeout
    failed_at = None
    while any(p.is_alive() for p in procs):
        now = monotonic()
        if deadline is not None and now > deadline:
            raise TimeoutError(f"ranks still running after {timeout} s")
        if failed_at is not None and now > failed_at + 10:
            return
        wait([p.sentinel for p in procs if p.is_alive()], timeout=1)
        if failed_at is None and any(p.exitcode not in (None, 0)
                                     for p in procs):
            failed_at = monotonic()
