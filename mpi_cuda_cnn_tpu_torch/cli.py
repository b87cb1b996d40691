"""Command line of the port: `python -m mpi_cuda_cnn_tpu_torch <command>`.

    train         the CNN trainer (reference CLI contract: 4 positional
                  IDX paths, exit 100 on a wrong count, 111 on bad data
                  files, 2 on a bad config; or --dataset NAME)
    train-bench   the MNIST-shaped epoch wall-clock bench (train/bench.py)
    serve-bench   the paged continuous-batching serving bench
                  (serve/bench.py)
    fleet-bench   N serving replicas behind the failure-aware router
                  under a seeded storm (serve/fleet.py; --compute sim
                  needs no device, --compute engine runs one PagedEngine
                  per replica)
    lm            the transformer-LM trainer (train/lm_trainer.py; exit 2
                  on a bad or unported flag)
    lm-bench      the LM pretraining throughput matrix (train/lm_bench.py)
    conv-bench    per-shape conv forward times: PyTorch's conv, the direct
                  kernel and the implicit-GEMM kernel
                  (bench/conv_shapes.py)

The run-file tools read the JSONL that `train`, `lm`, `serve-bench` and
`fleet-bench` write with --metrics-jsonl (or the JAX package's), import
nothing of the card's stack beyond torch, and print what the
reference's tools print:

    report        summary tables of a run (obs/report.py)
    compare       a run against a baseline under a gate, exit 1 on a
                  regression (obs/regress.py)
    explain       causal blame of each request's latency (obs/causal.py)
    trace         per-request lifecycles and the slot Gantt
                  (obs/timeline.py)
    health        per-tenant SLO verdicts, exit 1 on a violation
                  (obs/health.py)
    top           a live dashboard over a run file (obs/top.py)
    replay        the tick trail folded back into the serving state, its
                  digests checked (obs/replay.py)
    diverge       the first tick where two trails disagree
                  (obs/diverge.py)

Every command runs on the card unless given --device cpu. `train` and
`lm` take `--num-devices N` / `--mesh-shape data:N` (N = 0: every visible
card, 1 on the CPU); `train` also the model and pipe axes and FSDP
(`--mesh-shape data:2,model:2`, `pipe:2,data:2 --num-microbatches 4`,
`--fsdp`; `parallel/tp.py`, `parallel/pp.py`), and `lm` a seq axis,
`--mesh-shape seq:P` or `data:N,seq:P` (sequence parallelism,
`parallel/sp.py`): a world of 1
runs in this process; a world of N > 1 spawns N ranks
(`parallel.distributed.run_ranks`), NCCL with rank r on cuda:r, or gloo
ranks under --device cpu, and fails with exit 2 when N is more than the
visible cards. Under `torchrun` the environment names the
world and this process is one rank of it. The command returns non-zero
when any rank fails.

`train` and `lm` checkpoint (`--checkpoint-dir`, `--checkpoint-every`,
`train`'s `--checkpoint-every-steps`, `--resume`), inject planned faults
(`--fault-plan`), guard against non-finite steps (`--nan-policy`) and
restart a crashed run from its latest checkpoint (`--max-restarts N`,
which needs `--checkpoint-dir`; one process supervises itself, a spawned
world is supervised from this process and restarted whole,
`train.ranks.supervise_world`; under torchrun each rank runs one attempt
and torchrun's own restarts with `--resume` take the supervisor's
place). Exit codes: 0 done; 2 a bad flag or config; 75
preempted (SIGTERM/SIGINT, or a planned ``preempt``) with a snapshot
written: relaunch with `--resume`; 1 a failure, a preemption without a
snapshot, or a world whose ranks disagree.
"""

from __future__ import annotations

import sys

_USAGE = ("usage: python -m mpi_cuda_cnn_tpu_torch "
          "{train,train-bench,serve-bench,fleet-bench,lm,lm-bench,"
          "conv-bench,report,compare,explain,trace,health,top,replay,"
          "diverge} [flags]")

# the run-file tools: command -> (module under obs/, its main)
_TOOLS = {
    "report": ("report", "report_main"),
    "compare": ("regress", "compare_main"),
    "explain": ("causal", "explain_main"),
    "trace": ("timeline", "trace_main"),
    "health": ("health", "health_main"),
    "top": ("top", "top_main"),
    "replay": ("replay", "replay_main"),
    "diverge": ("diverge", "diverge_main"),
}


def rank_devices(device: str, num_devices: int, mesh_shape: str,
                 batch_size: int, queue: str,
                 ported: tuple[str, ...] | None = ("data",)) -> list:
    """One device per rank of the mesh the flags ask for (of the `ported`
    axes, `utils.config.data_axes`): the CPU for every rank under
    --device cpu, else the first
    cards. Under torchrun the environment names the world, and each
    process knows only its own device: this process's card
    (cuda:LOCAL_RANK), or the CPU, once per rank. Raises RuntimeError when
    CUDA is asked for and absent, NotImplementedError for an unported
    mesh, ValueError for more ranks than cards, a mesh that is not the
    torchrun world, or a batch the data axis does not divide."""
    import math
    import os

    import torch

    from ._device import resolve_device
    from .parallel.distributed import launched_by_torchrun
    from .parallel.mesh import DATA_AXIS, mesh_devices
    from .utils.config import check_batch_divides, data_axes

    own = resolve_device(device)
    cuda = own.type == "cuda"
    if launched_by_torchrun():
        world = int(os.environ["WORLD_SIZE"])   # --num-devices is moot
        axes = data_axes(0, mesh_shape, world, queue=queue, ported=ported)
        if math.prod(axes.values()) != world:
            raise ValueError(f"mesh {axes} for a torchrun world of {world}")
        check_batch_divides(batch_size, axes.get(DATA_AXIS, 1))
        return [own] * world
    visible = torch.cuda.device_count() if cuda else 1
    axes = data_axes(num_devices, mesh_shape, visible, queue=queue,
                     ported=ported)
    check_batch_divides(batch_size, axes.get(DATA_AXIS, 1))
    if not cuda:
        return mesh_devices(axes, [own] * (num_devices
                                           or math.prod(axes.values())))
    return mesh_devices(axes, [torch.device("cuda", i)
                               for i in range(visible)])


def _check_supervisor(cfg) -> None:
    """The reference's check: a restarted attempt resumes from the latest
    checkpoint, so --max-restarts needs --checkpoint-dir (ValueError)."""
    if cfg.max_restarts > 0 and not cfg.checkpoint_dir:
        raise ValueError("--max-restarts needs --checkpoint-dir: a restarted "
                         "attempt resumes from the latest valid checkpoint")


def world_exit(codes: list[int]) -> int:
    """One exit code for a world's ranks: theirs when they agree, else
    the largest other than 75 (a world is resumable only when every rank
    wrote its snapshot), and 1 in place of 0."""
    from .faults import EXIT_PREEMPTED

    if len(set(codes)) == 1:
        return codes[0]
    return max(c for c in codes if c != EXIT_PREEMPTED) or 1


def _run_world(entry, devices: list, args: tuple,
               axes: dict | None = None) -> int:
    """Run entry(mesh, cfg, *rest) -> {"exit": code, ...} (`args` = (cfg,
    *rest); `train/ranks.py`) on the mesh of `axes` (None: the data axis
    of every device): in this process as one rank of a torchrun world, in
    this process alone for one device (the entry supervises its
    attempts), else on one spawned rank per device, the world supervised
    from this process (`train.ranks.supervise_world`). Returns the ranks'
    exit code (`world_exit`), 1 when a rank failed for good."""
    from .parallel.distributed import (
        RankError,
        initialize_distributed,
        launched_by_torchrun,
    )
    from .parallel.mesh import make_mesh
    from .train.ranks import supervise_world
    from .utils.logging import get_logger

    if launched_by_torchrun():
        initialize_distributed(devices[0])
        results = [entry(make_mesh(axes, devices=devices), *args)]
    elif len(devices) == 1:
        results = [entry(None, *args)]
    else:
        try:
            results = supervise_world(entry, devices, args, axes)
        except RankError as e:
            get_logger().error("%s", e)
            return 1
    return world_exit([r["exit"] for r in results])


def run_train(argv: list[str]) -> int:
    """The `train` command, mirroring the reference's `cli.run`."""
    from .data.datasets import get_dataset, load_idx_dataset
    from .data.idx import IdxError
    from .models.presets import get_model
    from .utils.config import (
        check_supported,
        check_train_flags,
        data_axes,
        parse_args,
    )
    from .utils.logging import get_logger

    try:
        cfg = parse_args(argv)
    except SystemExit as e:  # 100 on a wrong IDX count, 2 on a bad flag
        return e.code if isinstance(e.code, int) else 2
    log = get_logger()
    try:
        check_supported(cfg)
        devices = rank_devices(cfg.device, cfg.num_devices, cfg.mesh_shape,
                               cfg.batch_size, "E", None)
        # the mesh of those ranks (a bare axis takes all of them)
        axes = data_axes(0, cfg.mesh_shape, len(devices), ported=None)
        check_train_flags(cfg, axes)
        _check_supervisor(cfg)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        log.error("%s", e)
        return 2
    try:
        if cfg.dataset == "idx":
            ds = load_idx_dataset("idx", cfg.train_images, cfg.train_labels,
                                  cfg.test_images, cfg.test_labels)
        else:
            ds = get_dataset(cfg.dataset, data_dir=cfg.data_dir)
    except (OSError, IdxError, TypeError) as e:
        # The reference exits 111 on any file problem (cnn.c:432,440).
        log.error("data load failed: %s", e)
        return 111
    except (KeyError, ValueError) as e:
        log.error("bad dataset config: %s", e)
        return 2
    try:
        model = get_model(cfg.model, input_shape=ds.input_shape)
    except KeyError as e:
        log.error("%s", e)
        return 2
    log.info("model=%s dataset=%s input=%s backend=%s ranks=%d", model.name,
             ds.name, ds.input_shape, "cuda" if cfg.use_kernels else "torch",
             len(devices))
    from .train.ranks import cnn_rank

    return _run_world(cnn_rank, devices, (cfg, ds), axes)


def run_lm(argv: list[str]) -> int:
    """The `lm` command, mirroring the reference's `cli.run_lm`."""
    from .utils.config import check_lm_supported, data_axes, parse_lm_args
    from .utils.logging import get_logger

    try:
        cfg = parse_lm_args(argv)
    except SystemExit as e:  # argparse: 2 on a bad flag, 0 on --help
        return e.code if isinstance(e.code, int) else 2
    log = get_logger()
    try:
        check_lm_supported(cfg)
        devices = rank_devices(cfg.device, cfg.num_devices, cfg.mesh_shape,
                               cfg.batch_size, "F", None)
        # the mesh of those ranks (a bare axis takes all of them), "data"
        # first when it names none, as `utils.config.lm_axes`
        axes = data_axes(0, cfg.mesh_shape, len(devices), ported=None)
        axes = axes if "data" in axes else {"data": 1, **axes}
        _check_supervisor(cfg)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        log.error("%s", e)
        return 2
    from .train.ranks import lm_rank

    return _run_world(lm_rank, devices, (cfg,), axes)


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "train":
        return run_train(argv[1:])
    if argv and argv[0] == "train-bench":
        from .train.bench import train_bench_main

        return train_bench_main(argv[1:])
    if argv and argv[0] == "serve-bench":
        from .serve.bench import serve_bench_main

        return serve_bench_main(argv[1:])
    if argv and argv[0] == "fleet-bench":
        from .serve.bench import fleet_bench_main

        return fleet_bench_main(argv[1:])
    if argv and argv[0] == "lm":
        return run_lm(argv[1:])
    if argv and argv[0] == "lm-bench":
        from .train.lm_bench import lm_bench_main

        return lm_bench_main(argv[1:])
    if argv and argv[0] == "conv-bench":
        from .bench.conv_shapes import conv_bench_main

        return conv_bench_main(argv[1:])
    if argv and argv[0] in _TOOLS:
        import importlib

        module, fn = _TOOLS[argv[0]]
        return getattr(importlib.import_module(f".obs.{module}", __package__),
                       fn)(argv[1:])
    print(_USAGE, file=sys.stderr)
    return 2
