"""Rank entries, one per trainer: what the `train` and `lm` commands run
on each rank (in their own process for one device, on ranks spawned by
`parallel.run_ranks` for more), and what the data-parallel checks spawn.
They live in the port so that a spawned rank imports the port and
nothing else.

Each entry takes the rank's mesh first (None: one device, no mesh),
trains through the trainer's own `train()`, and returns a picklable
dict: `exit` (0, or 2 when the trainer refuses its setup, as the
commands exit), the result, the final params as numpy arrays, and the
per-process counts of kernel launches (`ops._kernels.launches`) and
collectives (`parallel.dp.collectives`) of each part of the run.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..data.datasets import Dataset, synthetic_stripes
from ..models.presets import get_model
from ..ops import _kernels
from ..parallel import dp
from ..utils.logging import MetricsLogger, get_logger
from .lm_trainer import LMTrainer
from .trainer import Trainer


def _counts() -> dict:
    return {"launches": dict(_kernels.launches),
            "collectives": dict(dp.collectives)}


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
    """The trainer's metrics logger (echoing on rank 0) that also keeps
    its records and files the counts since the last record under the
    record's phase: the steps at an "epoch" record, the eval at an
    "eval" record."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally
        self.records: list[tuple[str, dict]] = []
        self.counts = {"steps": {}, "eval": {}}

    def log(self, event: str, **fields) -> None:
        super().log(event, **fields)
        self.records.append((event, fields))
        self.file({"epoch": "steps", "eval": "eval"}.get(event))

    def file(self, phase: str | None) -> None:
        if phase is not None:
            self.counts[phase] = _add(self.counts[phase], self.tally.take())


def cnn_rank(mesh, cfg, data, params=None, *, grads: bool = False,
             logits: bool = False) -> dict:
    """The `train` command on one rank: a Trainer of cfg.model on `data`
    (a Dataset, or the keyword arguments of `synthetic_stripes`) from
    `params` (None: the seeded init), then `Trainer.train()` (its epochs,
    its evals and the reference's `ntests=, ncorrect=` line). Returns the
    exit code, the counts of the construction (the init's broadcast), of
    the steps and of the evals, the last epoch's metrics, the result, the
    final params, and, if asked, the first step's gradients (before
    training) and the logits of the whole test set (after it)."""
    ds = data if isinstance(data, Dataset) else synthetic_stripes(**data)
    metrics = _PhaseLogger(tally := _Tally())
    try:
        tr = Trainer(get_model(cfg.model, input_shape=ds.input_shape), ds,
                     cfg, metrics=metrics, params=params, mesh=mesh)
    except ValueError as e:
        get_logger().error("trainer setup failed: %s", e)
        return {"exit": 2}
    res = {"exit": 0, "init": tally.take()}
    if grads:
        res["grads"] = _numpy(tr.first_grads())
    tally.take()
    result = tr.train()
    metrics.file("eval")           # the final eval, when no record follows it
    get_logger().info("done: epochs=%d acc=%.4f mean_step=%.3fms",
                      result.epochs_run, result.test_accuracy,
                      result.mean_step_ms)
    res.update(epoch=[f for e, f in metrics.records if e == "epoch"][-1],
               epoch_counts=metrics.counts["steps"],
               eval_counts=metrics.counts["eval"],
               eval=(result.ntests, result.ncorrect), step=result.final_step,
               result=dataclasses.asdict(result), params=_numpy(tr.leaves))
    if logits:
        res["logits"] = _numpy([tr.predict(
            torch.from_numpy(tr.test_x).to(tr.device)).float()])[0]
    return res


def lm_rank(mesh, cfg, params=None, *, grads: bool = False) -> dict:
    """The `lm` command on one rank: an LMTrainer of `cfg` from `params`
    (None: the seeded init), trained for cfg.steps and evaluated
    (`LMTrainer.train()`). Returns the exit code, the losses logged (every
    cfg.log_every steps), the result's final and eval losses, the
    launches and collectives of `train()` (the steps and the eval), its
    wall seconds, and, if asked, step 0's gradients (before training)."""
    metrics = _PhaseLogger(tally := _Tally())
    log = get_logger()
    try:
        trainer = LMTrainer(cfg, metrics=metrics, params=params, mesh=mesh)
    except (OSError, ValueError) as e:
        log.error("lm setup failed: %s", e)
        return {"exit": 2}
    log.info("lm model=d%dx%d h%d seq=%d vocab=%d device=%s attn=%s",
             cfg.dim, cfg.depth, cfg.heads, cfg.seq_len, trainer.model.vocab,
             trainer.device, trainer.attn_impl)
    res = {"exit": 0}
    if grads:
        res["grads"] = _numpy(trainer.first_grads())
    tally.take()
    t0 = time.perf_counter()
    result = trainer.train()
    if trainer.device.type == "cuda":
        torch.cuda.synchronize(trainer.device)
    log.info("done: steps=%d eval_ppl=%.3f tokens/s=%.0f", result.steps_run,
             result.eval_ppl, result.tokens_per_s)
    res.update(losses=[f["loss"] for e, f in metrics.records if e == "train"],
               final_loss=result.final_loss, eval_loss=result.eval_loss,
               seconds=time.perf_counter() - t0, counts=tally.take())
    return res
