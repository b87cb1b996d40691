"""Rank entries, one per trainer: what the `train` and `lm` commands run
on each rank (in their own process for one device, on ranks spawned by
`parallel.run_ranks` for more), and what the data-parallel checks spawn.
They live in the port so that a spawned rank imports the port and
nothing else.

Each entry takes the rank's mesh first (None: one device, no mesh) and
trains through the trainer's own `train()`. On one device it runs under
the crash supervisor (`faults.supervise`, `--max-restarts`: a crashed
attempt is rebuilt with `resume` and goes on from the latest checkpoint,
with the same fault injector and preemption guard). A world of several
spawned ranks is supervised from its parent (`supervise_world`): a rank
runs one attempt, and when any rank fails the parent stops the others,
backs off and spawns the whole world again with `resume` forced, the
planned faults that fired marked fired (`attempt`, `fired`). Each entry
returns a picklable dict: `exit` (0; 2
when the trainer refuses its setup, as the commands exit; 75 when
preempted with a snapshot written, 1 without), the result, the final
params as numpy arrays, the trainer's records ({"event", **fields}
dicts, `MetricsLogger.rows`), and the per-process
counts of kernel launches (`ops._kernels.launches`), collectives
(`parallel.dp.collectives`) and checkpoint files written
(`train.checkpoint.counts`) of each part of the run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..data.datasets import Dataset, synthetic_stripes
from ..faults import (
    EXIT_PREEMPTED,
    PASS_THROUGH,
    FaultInjector,
    Preempted,
    PreemptionGuard,
    supervise,
)
from ..models.layers import tree_leaves
from ..models.presets import get_model
from ..obs.metrics import MetricsRegistry
from ..ops import _kernels
from ..parallel import dp
from ..parallel.distributed import RankError, run_ranks
from ..utils.logging import MetricsLogger, get_logger
from . import checkpoint
from .lm_trainer import LMTrainer
from .trainer import Trainer


def _counts() -> dict:
    return {"launches": dict(_kernels.launches),
            "collectives": dict(dp.collectives),
            "checkpoints": dict(checkpoint.counts)}


class _Tally:
    """The process's counts since the last `take` (the counters
    themselves are left running)."""

    def __init__(self):
        self._mark = _counts()

    def take(self) -> dict:
        now = _counts()
        since = {kind: {k: v - self._mark[kind].get(k, 0)
                        for k, v in now[kind].items()} for kind in now}
        self._mark = now
        return since


def _add(total: dict, counts: dict) -> dict:
    return {kind: {k: total.get(kind, {}).get(k, 0) + v
                   for k, v in counts[kind].items()} for kind in counts}


def _numpy(tensors) -> list[np.ndarray]:
    return [t.detach().float().cpu().numpy() for t in tensors]


class _PhaseLogger(MetricsLogger):
    """The trainer's metrics logger (echoing on rank 0, keeping its
    records in `rows`, appending them to the JSONL file at `path` when
    given) that also files the counts since the last record under the
    record's phase: the steps at an "epoch" record, the eval at an "eval"
    record."""

    def __init__(self, tally: _Tally, path: str | None = None,
                 new_run: bool = True):
        super().__init__(path=path, capture=True, new_run=new_run)
        self.tally = tally
        self.counts = {"steps": {}, "eval": {}}

    def log(self, event: str, **fields) -> None:
        super().log(event, **fields)
        self.file({"epoch": "steps", "eval": "eval"}.get(event))

    def file(self, phase: str | None) -> None:
        if phase is not None:
            self.counts[phase] = _add(self.counts[phase], self.tally.take())


def _sink(mesh, cfg) -> str | None:
    """cfg.metrics_jsonl on rank 0, None on the other ranks: one writer
    of the run's file, as the reference's process 0."""
    return cfg.metrics_jsonl if mesh is None or mesh.rank == 0 else None


def _supervised(cfg, first, make_trainer, metrics, world: int, registry,
                faults: FaultInjector | None):
    """`first.train()` under `faults.supervise` with cfg.max_restarts
    restarts, each attempt after the first on a trainer rebuilt by
    `make_trainer` with `resume` forced. Returns (result, last trainer).

    In a world of several ranks the rank runs one attempt: a rank
    restarting by itself would meet its peers in another collective, so
    the world's parent restarts the whole world (`supervise_world`). On
    the way out of a failed attempt the rank logs the fired faults'
    records and sets the plan indices that fired on the exception
    (`fired_faults`, pickled by `parallel.distributed._rank_main`)."""
    if world == 1:
        trainer = first

        def attempt(n: int):
            nonlocal trainer
            if n > 0:
                trainer = make_trainer(dataclasses.replace(cfg, resume=True))
            return trainer.train()

        result = supervise(attempt, max_restarts=cfg.max_restarts,
                           logger=get_logger(), metrics=metrics,
                           registry=registry)
        return result, trainer
    try:
        return first.train(), first
    except BaseException as e:
        if faults is not None:
            for ev in faults.drain_events():
                metrics.log("fault", **ev)
            e.fired_faults = faults.fired()
        raise


def _restartable(e: BaseException) -> bool:
    """Whether a failed world may be restarted: no rank failed in a way
    the supervisor passes through (`faults.PASS_THROUGH`, by the class
    names the ranks reported) and none returned preempted."""
    names = {c.__name__ for c in PASS_THROUGH}
    return (isinstance(e, RankError)
            and not any(names & set(f["types"]) for f in e.failures)
            and EXIT_PREEMPTED not in e.exits)


def supervise_world(entry, devices: list, args: tuple,
                    axes: dict | None = None) -> list:
    """entry(mesh, cfg, *rest) (`args` = (cfg, *rest); `cnn_rank`,
    `lm_rank`) on one spawned rank per device (`run_ranks`) under the
    reference's supervisor (`faults.supervise`, cfg.max_restarts): when
    any rank fails, `run_ranks` stops the others and raises RankError;
    unless a rank failed in a way the supervisor passes through or was
    preempted (`_restartable`), the parent backs off, writes the
    ``fault`` record (kind "restart", its delay) to cfg.metrics_jsonl,
    rank 0's run file (no rank is alive then), and spawns the whole world
    again with cfg.resume forced, handing its ranks the attempt index
    (their `train.restarts` count) and the union of the plan indices that
    the failed ranks reported fired (they do not fire again: the
    reference keeps one injector for the supervised run). Returns the
    ranks' results of the attempt that ended; raises the last RankError
    when none did."""
    cfg, *rest = args
    fired: set[int] = set()

    def attempt(n: int) -> list:
        c = cfg if n == 0 else dataclasses.replace(cfg, resume=True)
        try:
            return run_ranks(entry, len(devices), devices=devices,
                             args=(c, *rest), axes=axes,
                             kwargs={"attempt": n,
                                     "fired": tuple(sorted(fired))})
        except RankError as e:
            for f in e.failures:
                fired.update(f["fired"])
            raise

    with MetricsLogger(path=cfg.metrics_jsonl, echo=False,
                       new_run=False) as metrics:
        return supervise(attempt, max_restarts=cfg.max_restarts,
                         logger=get_logger(), metrics=metrics,
                         registry=MetricsRegistry(),
                         restartable=_restartable)


def _attempt_state(cfg, attempt: int, fired: tuple[int, ...]):
    """The rank's fault injector (None without a plan), `fired` marked
    fired, and its registry, one for every in-process attempt, counting
    the `attempt` restarts of the world before this one."""
    faults = (FaultInjector(cfg.fault_plan, fired=fired)
              if cfg.fault_plan else None)
    registry = MetricsRegistry()
    if attempt:
        registry.inc("train.restarts", attempt)
    return faults, registry


def _preempted(e: Preempted, metrics: _PhaseLogger) -> dict:
    log = get_logger()
    if e.resumable:
        log.warning("run preempted (%s); exiting %d: relaunch with "
                    "--resume to continue", e, e.code)
    else:
        log.warning("run preempted (%s) with no checkpoint to resume "
                    "from; exiting %d", e, e.code)
    return {"exit": int(e.code), "records": metrics.rows}


def cnn_rank(mesh, cfg, data, params=None, *, grads: bool = False,
             logits: bool = False, attempt: int = 0,
             fired: tuple[int, ...] = ()) -> dict:
    """The `train` command on one rank: a Trainer of cfg.model on `data`
    (a Dataset, or the keyword arguments of `synthetic_stripes`) from
    `params` (None: the seeded init), then `Trainer.train()` (its epochs,
    its evals and the reference's `ntests=, ncorrect=` line). Returns the
    exit code, the counts of the construction (the init's broadcast), of
    the steps and of the evals, the last epoch's metrics (None when a
    resumed run had no step left), the result, the final params, the
    trainer's records, and, if asked, the first step's
    gradients (before training) and the logits of the whole test set
    (after it). `attempt` and `fired`: `supervise_world`'s."""
    ds = data if isinstance(data, Dataset) else synthetic_stripes(**data)
    model = get_model(cfg.model, input_shape=ds.input_shape)
    faults, registry = _attempt_state(cfg, attempt, fired)
    with _PhaseLogger(tally := _Tally(), _sink(mesh, cfg),
                      new_run=attempt == 0) as metrics, \
            PreemptionGuard() as guard:
        def make_trainer(c):
            return Trainer(model, ds, c, metrics=metrics, params=params,
                           mesh=mesh, faults=faults, preempt=guard,
                           registry=registry)

        try:
            tr = make_trainer(cfg)
        except ValueError as e:
            get_logger().error("trainer setup failed: %s", e)
            return {"exit": 2}
        res = {"exit": 0, "init": tally.take()}
        if grads:
            res["grads"] = _numpy(tr.first_grads())
        tally.take()
        try:
            result, tr = _supervised(cfg, tr, make_trainer, metrics,
                                     tr.mesh.size, registry, faults)
        except Preempted as e:
            metrics.file("steps")
            return {**res, **_preempted(e, metrics),
                    "epoch_counts": metrics.counts["steps"]}
    metrics.file("eval")           # the final eval, when no record follows it
    get_logger().info("done: epochs=%d acc=%.4f mean_step=%.3fms",
                      result.epochs_run, result.test_accuracy,
                      result.mean_step_ms)
    epochs = [r for r in metrics.rows if r["event"] == "epoch"]
    res.update(epoch=epochs[-1] if epochs else None,
               epoch_counts=metrics.counts["steps"],
               eval_counts=metrics.counts["eval"],
               eval=(result.ntests, result.ncorrect), step=result.final_step,
               result=dataclasses.asdict(result),
               params=_numpy(tr.full_leaves()),
               records=metrics.rows)
    if logits:
        res["logits"] = _numpy([tr.predict(
            torch.from_numpy(tr.test_x).to(tr.device)).float()])[0]
    return res


def cnn_rank_each(mesh, runs: list[tuple]) -> list[dict]:
    """`cnn_rank(m, cfg, data, params, **kw)` for each (cfg, data, params,
    kw) of `runs` in turn, on this rank's mesh of cfg's axes
    (`utils.config.cnn_axes`, built here over the ranks' group, so that
    one spawn of the ranks runs meshes of several shapes), each result
    with the run's wall seconds (`wall_s`)."""
    from ..parallel.mesh import make_mesh
    from ..utils.config import cnn_axes

    out = []
    for cfg, data, params, kw in runs:
        t0 = time.perf_counter()
        axes = cnn_axes(cfg, mesh.world)
        m = mesh if axes == mesh.shape else make_mesh(
            axes, devices=[mesh.device] * mesh.world)
        out.append({**cnn_rank(m, cfg, data, params, **kw),
                    "wall_s": time.perf_counter() - t0})
    return out


def lm_rank(mesh, cfg, params=None, *, grads: bool = False,
            final_params: bool = False, attempt: int = 0,
            fired: tuple[int, ...] = ()) -> dict:
    """The `lm` command on one rank: an LMTrainer of `cfg` from `params`
    (None: the seeded init), trained for cfg.steps and evaluated
    (`LMTrainer.train()`), then, with cfg.sample_tokens, a sample on rank
    0 logged as the reference's command logs it. The rank's mesh may have
    any of the LM's axes (its block of every batch and of the params).
    Returns the
    exit code, the losses logged (every cfg.log_every steps), the
    result's final and eval losses, the launches and collectives of
    `train()` (the steps and the eval), its wall seconds, the trainer's
    records, the sample's tokens (rank 0 with cfg.sample_tokens, else
    None), and, if asked, step 0's gradients (before training) and the
    final params (numpy, whole, in the standard tree's `tree_leaves`
    order). `attempt` and `fired`: `supervise_world`'s."""
    log = get_logger()
    faults, registry = _attempt_state(cfg, attempt, fired)
    with _PhaseLogger(tally := _Tally(), _sink(mesh, cfg),
                      new_run=attempt == 0) as metrics, \
            PreemptionGuard() as guard:
        def make_trainer(c):
            return LMTrainer(c, metrics=metrics, params=params, mesh=mesh,
                             faults=faults, preempt=guard, registry=registry)

        try:
            trainer = make_trainer(cfg)
        except (OSError, ValueError) as e:
            log.error("lm setup failed: %s", e)
            return {"exit": 2}
        log.info("lm model=d%dx%d h%d seq=%d vocab=%d moe=%d device=%s "
                 "attn=%s", cfg.dim, cfg.depth, cfg.heads, cfg.seq_len,
                 trainer.model.vocab, cfg.moe_experts, trainer.device,
                 trainer.attn_impl)
        res = {"exit": 0}
        if grads:
            res["grads"] = _numpy(trainer.first_grads())
        tally.take()
        t0 = time.perf_counter()
        try:
            result, trainer = _supervised(cfg, trainer, make_trainer,
                                          metrics, trainer.mesh.size,
                                          registry, faults)
        except Preempted as e:
            return {**res, **_preempted(e, metrics), "counts": tally.take()}
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    log.info("done: steps=%d eval_ppl=%.3f tokens/s=%.0f", result.steps_run,
             result.eval_ppl, result.tokens_per_s)
    res.update(losses=[r["loss"] for r in metrics.rows
                       if r["event"] == "train"],
               final_loss=result.final_loss, eval_loss=result.eval_loss,
               seconds=time.perf_counter() - t0, counts=tally.take(),
               records=metrics.rows, sample=None)
    if final_params:
        res["params"] = _numpy(trainer.full_leaves())
    if cfg.sample_tokens:
        trainer.standard_params()   # on every rank (a sharded mesh gathers)
    if cfg.sample_tokens and (mesh is None or mesh.rank == 0):
        _, cont = trainer.sample(cfg.sample_tokens,
                                 temperature=cfg.sample_temperature,
                                 seed=cfg.seed)
        # Char-level corpora decode as bytes; the rest prints as escapes.
        text = bytes(int(t) & 0xFF for t in cont)
        log.info("sample (%d tokens): %r", cfg.sample_tokens, text)
        res["sample"] = cont.tolist()
    return res


def lm_rank_runs(mesh, runs: list[tuple]) -> list[dict]:
    """`lm_rank(m, cfg, params, **kw)` for each (cfg, params, kw) of
    `runs` in turn, on this rank's mesh of cfg's axes
    (`utils.config.lm_axes`, built here over the ranks' group, so that
    one spawn of the ranks runs meshes of several shapes), each result
    with the run's wall seconds (`wall_s`)."""
    from ..parallel.mesh import make_mesh
    from ..utils.config import lm_axes

    out = []
    for cfg, params, kw in runs:
        t0 = time.perf_counter()
        axes = lm_axes(cfg)
        m = mesh if axes == mesh.shape else make_mesh(
            axes, devices=[mesh.device] * mesh.world)
        out.append({**lm_rank(m, cfg, params, **kw),
                    "wall_s": time.perf_counter() - t0})
    return out
