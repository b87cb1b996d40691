"""CNN train and eval loops, on one device or one rank of a data mesh
(counterpart of the reference's `train/trainer.py`).

The reference's loop (cnn.c:445-474) is per-sample SGD with gradients
accumulated over 32 samples; eval is a forward argmax sweep printing
"ntests=%d, ncorrect=%d" (cnn.c:494-518). As in the JAX package the loop
is batched (batch == the reference's accumulator period), the epoch order
is a numpy permutation keyed on (seed, epoch), and an epoch runs one of
two ways with identical arithmetic:

- device-resident (default, `parallel/dp.make_dp_scan_epoch`, the twin
  of `_run_epoch_scanned`): the uint8 images and int32 labels are staged
  on the device once; each step gathers its batch by index, divides by
  PIXEL_SCALE and one-hots on the device. Metric sums stay on the
  device, so the host waits only at `log_every` and at the end;
- per batch (`scan=False`, or a dataset over `scan_max_bytes`): the host
  normalizes each batch and copies it over.

A step is the forward, softmax-CE, `torch.autograd.grad` through the
backend's ops (with `use_kernels`, the hand-written CUDA kernels of
`ops/kernel_ops.py` in both directions) and the in-place SGD update.
With `compute_dtype="bfloat16"` the forward and backward run in bf16
(`Sequential.apply` casts on entry) while the params, their gradients
and the SGD update stay float32. With `param_dtype="bfloat16"` the params
are held and updated in bf16: in bf16 compute every gradient is bf16; in
float32 compute (the kernels only, as the reference's Pallas path) the
kernels take float32 copies of their operands and their gradients come
back float32 (`Sequential.grad_view`). `grad_accum` splits the rank's
rows into micro-batches, `remat` recomputes each layer's forward in the
backward, `augment` shifts (and flips) the rank's rows on the device
from host draws, and `elastic_width` takes the width-invariant step
(`parallel/dp.py`, `data/augment.py`, `parallel/elastic.py`).

On a mesh with a 'model' axis, or with `fsdp`, each rank holds blocks of
the params and steps through `parallel/tp.py` (`ShardedCNN`: tensor
parallelism, FSDP and both); on a 'pipe' axis it holds its stage and
steps through `parallel/pp.py` (`Pipeline`, with TP x PP and FSDP x PP),
`num_microbatches` microbatches a step. Both take the same batches as
the data mesh (the pipeline's per-batch rows in the reference's
microbatch order, `pp.microbatch_rows`), evaluate through their own
forward, and checkpoint the reference's arrays: whole leaves gathered
from the blocks, or the pipeline's packed stage rows.

As in the JAX trainer, one device and many use the same code path, that
of a data mesh (`parallel.make_mesh`, one process per rank): the seeded
init is broadcast from rank 0 (`parallel/dp.replicate`), each step takes
this rank's contiguous share of the batch (its columns of the
permutation on the device-resident route, `dp_shard_perm`; its rows of
the host batch on the other, `dp_shard_batch`), and the step averages
the gradients and metrics in one all-reduce before the same SGD update
on every rank (`dp.make_dp_train_step`). The eval splits each eval
batch across the ranks and sums the correct counts. Given no mesh, the
trainer runs on the world-1 mesh of its device (`mesh.device_mesh`),
which has no process group: every share is the whole, and no collective
is made.

Crash safety follows the JAX trainer (its hooks in `train/recovery.py`,
shared with the LM trainer). With `checkpoint_dir` the state is saved
every `checkpoint_every` epochs, every `checkpoint_every_steps` steps and
at the end; `resume` restores the newest valid checkpoint and re-enters
its epoch at step `step % steps_per_epoch`. The fault hooks: "train.step"
after every step (a planned fault's step ends a device-resident chunk,
as a checkpoint step does) and "train.batch" on the host batch. A plan
with a "train.batch" fault, or an active NaN guard (which checks, and
may undo, every single step), forces the per-batch route. A preemption
(SIGTERM, or a planned ``preempt``) snapshots at the next boundary and
raises `faults.Preempted`.

Telemetry follows the JAX trainer: each epoch's timer splits its wall
time into the data, dispatch, device and checkpoint phases; with a
JSONL sink the trainer writes the "step_phases", "memory", "metrics"
(the registry, shared across supervised attempts), "epoch", "eval",
"span" and "train" records, and a "program" record of its first step
("scan_epoch" on the device-resident route, "train_step" per batch),
counted as it runs (`obs/cost.py`; that step is a chunk of its own on
every rank, and its time is kept out of the phases); `profile_dir`
traces the epochs with `torch.profiler`. Without a sink nothing is
written and no host sync is added.
"""

from __future__ import annotations

import dataclasses
import math
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data import prng
from ..data.augment import make_augment
from ..data.pipeline import (
    ensure_channel_axis,
    normalize_images,
    one_hot,
)
from ..faults import PreemptionGuard, RollbackToCheckpoint, poison_batch
from ..models.initializers import get_initializer
from ..models.layers import tree_leaves
from ..ops.activations import stable_softmax
from ..ops.gemv import tree_map
from ..ops.losses import softmax_cross_entropy, squared_error_total
from ..obs.cost import ProgramLog
from ..obs.device import emit_step_telemetry
from ..obs.metrics import MetricsRegistry
from ..obs.trace import span
from ..parallel.dp import (
    all_reduce_sum,
    dp_shard_batch,
    dp_shard_perm,
    make_dp_scan_epoch,
    make_dp_train_step,
    replicate,
)
from ..parallel.mesh import DATA_AXIS, MODEL_AXIS, PIPE_AXIS, device_mesh
from ..utils.config import (
    COMPUTE_DTYPES,
    PARAM_DTYPES,
    check_batch_divides,
    check_supported,
    check_train_flags,
    cnn_axes,
)
from ..utils.logging import MetricsLogger, get_logger
from ..utils.profiling import StepTimer, profile_trace
from .optimizer import make_optimizer
from .recovery import Recovery

METRICS = ("loss", "etotal", "acc")
# The augmentation stream's seed is the run's seed plus this (the
# reference's offset: a stream apart from the init's).
AUG_SEED_OFFSET = 0x5EED


def make_loss_fn(model, *, backend: str = "torch",
                 compute_dtype: torch.dtype | None = None,
                 remat: bool = False, apply=None):
    """Softmax-CE loss + the reference's metrics (squared-error total,
    cnn.c:275-282; argmax accuracy, cnn.c:508-513). The metrics are
    computed from detached logits: only the loss is differentiated. With
    a compute_dtype the forward runs in it and the float32 logits feed
    the loss, as in the reference; with remat each layer's forward is
    recomputed in the backward. `apply(params, x)` (a sharded rank's
    forward) replaces the model's own."""

    def loss_fn(params, x, y_onehot):
        if apply is not None:
            logits = apply(params, x)
        else:
            logits = model.apply(params, x, backend=backend,
                                 compute_dtype=compute_dtype, remat=remat)
        loss = softmax_cross_entropy(logits, y_onehot)
        with torch.no_grad():
            logits = logits.detach()
            probs = stable_softmax(logits)
            acc = (logits.argmax(-1) == y_onehot.argmax(-1)).float().mean()
            aux = {"etotal": squared_error_total(probs, y_onehot), "acc": acc}
        return loss, aux

    return loss_fn


@dataclasses.dataclass
class TrainResult:
    epochs_run: int
    final_step: int
    test_accuracy: float
    ntests: int
    ncorrect: int
    epoch_seconds: list[float]
    mean_step_ms: float


class Trainer:
    """model + dataset + config -> trained params, as one rank of the
    data mesh `mesh` (on `mesh.device`), or on config.device alone.

    `params` (a params tree of tensors, e.g. `convert.params_from_jax` of
    the JAX trainer's initial params) replaces the seeded init. `faults`
    is a `faults.FaultInjector` (shared across a supervised run's
    attempts) and `preempt` a `faults.PreemptionGuard` (the caller's, with
    its signal handlers; by default one that answers planned preempt
    faults only).
    """

    def __init__(self, model, dataset, config, *,
                 metrics: MetricsLogger | None = None, params=None,
                 mesh=None, faults=None,
                 preempt: PreemptionGuard | None = None, registry=None,
                 clock=None):
        check_supported(config)
        if mesh is None and math.prod(cnn_axes(config).values()) > 1:
            raise ValueError(
                f"num_devices={config.num_devices}, mesh_shape="
                f"{config.mesh_shape!r}: a Trainer is one rank; pass the "
                "rank's mesh (parallel.make_mesh under parallel.run_ranks "
                "or torchrun), or run the train command")
        self.model = model
        self.ds = dataset
        self.cfg = config
        self.log = get_logger()
        self.metrics = metrics or MetricsLogger()
        self.registry = registry if registry is not None \
            else MetricsRegistry()
        self._clock = clock if clock is not None else time.perf_counter
        self.device = resolve_device(config.device if mesh is None
                                     else mesh.device)
        self.mesh = mesh = mesh or device_mesh(self.device)
        n_data = mesh.shape.get(DATA_AXIS, 1)
        check_batch_divides(config.batch_size, n_data)
        check_train_flags(config, dict(mesh.shape))
        self.backend = "cuda" if config.use_kernels else "torch"
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.param_dtype = PARAM_DTYPES[config.param_dtype]
        self.n_pipe = mesh.shape.get(PIPE_AXIS, 1)
        self.pp_m = (config.num_microbatches or self.n_pipe
                     if self.n_pipe > 1 else 1)
        self.par = self._sharding(model, mesh)
        self.loss_fn = make_loss_fn(
            model, backend=self.backend, compute_dtype=self.compute_dtype,
            remat=config.remat,
            apply=getattr(self.par, "apply", None))
        # bf16 params, float32 compute (the kernels only): differentiate
        # the float32 copies the kernels take, for the reference's
        # gradient dtypes.
        self._view = None
        if self.compute_dtype is None and self.param_dtype != torch.float32:
            self._view = lambda p: model.grad_view(p, torch.float32)

        self.num_train = len(dataset.train_images)
        self.test_x = normalize_images(dataset.test_images)
        self.test_labels = np.asarray(dataset.test_labels)
        self.steps_per_epoch = self.num_train // config.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds train set size "
                f"{self.num_train}: no full batches")
        # The pipeline clips in its step, with the norm over its ranks,
        # as the reference's does (its chain then holds no clip).
        self.optimizer = make_optimizer(
            config.lr, momentum=config.momentum, schedule=config.lr_schedule,
            total_steps=self.steps_per_epoch * config.epochs or None,
            grad_clip=0.0 if self.n_pipe > 1 else config.grad_clip)

        if params is None:
            params = model.init(prng.key(config.seed),
                                get_initializer(config.init))
        params = tree_map(
            lambda t: t.detach().to(self.device, self.param_dtype).clone()
            .requires_grad_(True), params)
        replicate(params, mesh)
        augment = make_augment(config.augment, pad=config.aug_pad)
        aug_seed = config.seed + AUG_SEED_OFFSET
        if self.par is None:
            self.state = {"params": params,
                          "opt_state": self.optimizer.init(
                              tree_leaves(params)), "step": 0}
            self._step = make_dp_train_step(
                self.loss_fn, self.optimizer, mesh, view=self._view,
                augment=augment, aug_seed=aug_seed,
                grad_accum=config.grad_accum,
                elastic_width=config.elastic_width)
        else:
            self._template = params
            self.state = self.par.place(params, self.optimizer)
            if self.n_pipe > 1:
                self._step = self.par.make_train_step(
                    self.optimizer, augment=augment, aug_seed=aug_seed,
                    grad_clip=config.grad_clip)
            else:
                self._step = self.par.make_train_step(
                    self.loss_fn, self.optimizer, view=self._view,
                    augment=augment, aug_seed=aug_seed,
                    grad_accum=config.grad_accum,
                    grad_clip=config.grad_clip)
        self.params = self.state["params"]
        self.leaves = tree_leaves(self.params)
        self.opt_state = self.state["opt_state"]
        self._scan_epoch = make_dp_scan_epoch(self._step, dataset.num_classes)
        self._eval_batch = self._pick_eval_batch(len(self.test_x),
                                                 n_data * self.pp_m)
        self._dev_images = None
        self._dev_labels = None
        self._classes = torch.arange(dataset.num_classes, device=self.device)
        self._warned: set[str] = set()
        self.programs = ProgramLog(self.metrics, self.device,
                                   config.compute_dtype,
                                   configured=bool(config.metrics_jsonl))
        self.recovery = Recovery(config, mesh, self.optimizer,
                                 metrics=self.metrics, logger=self.log,
                                 faults=faults, preempt=preempt,
                                 codec=self._codec())

    def _sharding(self, model, mesh):
        """The rank's sharded path (`pp.Pipeline` on a pipe axis,
        `tp.ShardedCNN` on a model axis or under FSDP over a data axis),
        or None: the data-parallel path."""
        cfg = self.cfg
        n_data = mesh.shape.get(DATA_AXIS, 1)
        n_model = mesh.shape.get(MODEL_AXIS, 1)
        if self.n_pipe > 1:
            from ..parallel.pp import Pipeline, make_pipeline_plan

            self.pp_plan = make_pipeline_plan(
                model, self.n_pipe, backend=self.backend,
                compute_dtype=self.compute_dtype, n_model=n_model,
                remat=cfg.remat, fsdp_degree=n_data if cfg.fsdp else 1)
            return Pipeline(self.pp_plan, mesh, self.pp_m,
                            has_data=DATA_AXIS in mesh.shape)
        if n_model > 1 or (cfg.fsdp and n_data > 1):
            from ..parallel.tp import ShardedCNN

            return ShardedCNN(model, mesh, fsdp=cfg.fsdp,
                              backend=self.backend,
                              compute_dtype=self.compute_dtype,
                              remat=cfg.remat)
        return None

    def _codec(self):
        """(state -> checkpoint arrays, (state, arrays) -> None) of a
        sharded path: the reference's arrays of the whole state (the
        pipeline's packed rows), made on every rank from its blocks, and
        each rank's blocks of a restored file; None on the data path."""
        if self.par is None:
            return None
        opt = self.optimizer
        if self.n_pipe > 1:
            return (lambda st: self.par.checkpoint_arrays(st, opt,
                                                          self._template),
                    lambda st, arrays: self.par.load_arrays(
                        st, arrays, opt, self._template))
        from ..convert import checkpoint_arrays, load_checkpoint_arrays

        def load(st, arrays):
            full = self.par.full_state(st)    # the whole shapes, refilled
            load_checkpoint_arrays(full, arrays, opt)
            self.par.load_full(st, full)

        return (lambda st: checkpoint_arrays(self.par.full_state(st), opt),
                load)

    @property
    def step(self) -> int:
        """Steps taken (batches consumed, a dropped update included)."""
        return self.state["step"]

    def _epoch_order(self, epoch: int) -> np.ndarray:
        """The epoch's sample permutation — derived, never stored."""
        return np.random.default_rng((self.cfg.seed, epoch)).permutation(
            self.num_train)

    @staticmethod
    def _pick_eval_batch(ntest: int, granularity: int,
                         target: int = 2048) -> int:
        """Largest eval batch <= target divisible by `granularity`."""
        b = min(target, ntest)
        b -= b % granularity
        return max(b, granularity)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _warn_once(self, msg: str) -> None:
        if msg not in self._warned:
            self._warned.add(msg)
            self.log.warning("%s", msg)

    def _use_device_data(self) -> bool:
        """Stage the whole uint8 set on the device unless scan is off, a
        fault plan targets train.batch (the device-resident epoch builds
        its batches on the device, where no batch fault can reach), the
        NaN guard is on (it checks, and may undo, every single step) or
        the set is over --scan-max-bytes (then stream per batch)."""
        if not self.cfg.scan:
            return False
        faults = self.recovery.faults
        if faults is not None and any(f.site == "train.batch"
                                      for f in faults.plan):
            self._warn_once("fault plan targets train.batch: per-batch "
                            "stepping (the device-resident epoch cannot "
                            "inject batch faults)")
            return False
        if self.recovery.nan.active:
            self._warn_once(f"--nan-policy={self.cfg.nan_policy} active: "
                            "per-batch stepping (the device-resident epoch "
                            "cannot skip or roll back single steps)")
            return False
        nbytes = self.ds.train_images.nbytes + 4 * self.num_train
        return nbytes <= self.cfg.scan_max_bytes

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One SGD step on this rank's share of a device batch; returns
        the step's (loss, etotal, acc), averaged over the ranks, as one
        device tensor."""
        self.state, m = self._step(self.state, x, y)
        return m

    def first_grads(self) -> list[torch.Tensor]:
        """The gradients the first step of epoch 0 applies, at the current
        params and step: this rank's share of that batch through the
        step's gradient path (its augmentation, accumulation or elastic
        reduction, and the reduction over the ranks)."""
        grads, _ = self._step.grads(
            self.state,
            *self._host_batch(self._epoch_order(0)[:self.cfg.batch_size]))
        if self.par is not None:
            grads = [t.clone() for t in self.par.full_leaves(grads)]
        return grads

    def full_leaves(self) -> list[torch.Tensor]:
        """The whole params' leaves, on every rank (on a sharded path one
        all-gather of the blocks)."""
        if self.par is None:
            return self.leaves
        return self.par.full_leaves(self.leaves)

    def _shard_rows(self, n: int) -> np.ndarray:
        """The indices of this rank's rows of a batch of n, in the order
        its step takes them: its data block, or on the pipe axis each
        microbatch's data block in turn (`pp.microbatch_rows`)."""
        if self.n_pipe > 1:
            from ..parallel.pp import microbatch_rows

            return microbatch_rows(n, self.pp_m,
                                   self.mesh.shape.get(DATA_AXIS, 1),
                                   self.mesh.index(DATA_AXIS))
        return dp_shard_batch(np.arange(n), self.mesh)

    def _log_train(self, epoch: int, step: int, sums: torch.Tensor,
                   n: int) -> None:
        with self._timer.phase("device"):
            vals = (sums / n).tolist()
        self.metrics.log("train", epoch=epoch, step=step,
                         **dict(zip(METRICS, vals)))
        self.registry.set("train.loss", vals[0])

    def _stage_dataset(self) -> None:
        images = ensure_channel_axis(self.ds.train_images)
        self._dev_images = torch.from_numpy(
            np.ascontiguousarray(images, np.uint8)).to(self.device)
        self._dev_labels = torch.from_numpy(
            np.asarray(self.ds.train_labels, np.int32)).to(self.device)

    def run_epoch(self, epoch: int, *, skip_steps: int = 0) -> dict:
        """One epoch over the training set in the (seed, epoch) order,
        from its step `skip_steps` on (a mid-epoch resume). Returns the
        steps run, the mean loss/etotal/acc over the updates kept, and
        the wall seconds, which end after the device has finished the
        epoch."""
        cfg = self.cfg
        t0 = self._clock()
        self._timer = timer = StepTimer(clock=self._clock)
        timer.start()
        b = cfg.batch_size
        nsteps = self.steps_per_epoch
        order = self._epoch_order(epoch)[: nsteps * b]
        sums, ngood = self._run_steps(epoch, order, self._use_device_data(),
                                      skip_steps)
        with timer.phase("device"):
            self._sync()
            means = ((sums / ngood).tolist() if ngood
                     else [float("nan")] * len(METRICS))
        seconds = self._clock() - t0
        timer.stop(max(nsteps - skip_steps, 1))
        self._emit_epoch_obs(epoch, timer, nsteps - skip_steps)
        return {"epoch": epoch, "steps": nsteps - skip_steps,
                **dict(zip(METRICS, means)), "seconds": seconds}

    def _emit_epoch_obs(self, epoch: int, timer: StepTimer,
                        nsteps: int) -> None:
        """The epoch's "step_phases" and "memory" records (with a JSONL
        sink) and its registry fold: the step counters, the step-time
        histogram and the samples/s gauge, then a "metrics" snapshot.
        Reads the timer's intervals only (no clock, no sync)."""
        emit_step_telemetry(self.metrics, timer, nsteps,
                            devices=[self.device], epoch=epoch)
        if nsteps <= 0:
            return
        reg = self.registry
        reg.inc("train.steps", nsteps)
        reg.inc("train.heartbeats")
        step_ms = timer.mean_step_ms
        reg.observe("train.step_ms", step_ms)
        if step_ms > 0:
            reg.set("train.samples_per_s",
                    1e3 * self.cfg.batch_size / step_ms)
        reg.emit(self.metrics, epoch=epoch)

    def _host_batch(self, rows: np.ndarray, global_step: int | None = None
                    ) -> tuple[torch.Tensor, ...]:
        """The batch of train rows `rows`, normalized and one-hot; with
        `global_step`, the planned train.batch faults of that step
        applied; then this rank's share of it, on the device."""
        x = normalize_images(self.ds.train_images[rows])
        y = one_hot(np.asarray(self.ds.train_labels)[rows],
                    self.ds.num_classes)
        faults = self.recovery.faults
        if faults is not None and global_step is not None:
            for f in faults.fire("train.batch", global_step):
                if f.kind == "nan":
                    x = poison_batch(x, f)
            self.recovery.drain_events()
        mine = self._shard_rows(len(x))
        x, y = x[mine], y[mine]
        return (torch.from_numpy(np.ascontiguousarray(x)).to(self.device),
                torch.from_numpy(np.ascontiguousarray(y)).to(self.device))

    def _batch_step(self, global_step: int, rows: np.ndarray,
                    sums: torch.Tensor) -> bool:
        """One step of the per-batch route; its metrics added to `sums`.
        Under the NaN guard a non-finite step is undone (abort and a
        rollback raise); returns whether the update was kept."""
        with self._timer.phase("data"):
            x, y = self._host_batch(rows, global_step)
        snap = self.recovery.snapshot(self.state)
        with self.programs.dispatch("train_step", self._timer):
            m = self.train_step(x, y)
        if not self.recovery.check_step(self.state, m, global_step, snap):
            return False
        sums += m
        return True

    def _chunk_end(self, base: int, done: int) -> int:
        """Where the device-resident chunk from in-epoch step `done` ends:
        the next multiple of log_every (the epoch's end without logging),
        checkpoint step or planned train.step fault (`base` is the
        epoch's first global step)."""
        cfg, nsteps = self.cfg, self.steps_per_epoch
        chunk = cfg.log_every if cfg.log_every > 0 else nsteps
        stops = [done + chunk - done % chunk, nsteps]
        g = base + done
        every = cfg.checkpoint_every_steps
        if self.recovery.ckpt is not None and every:
            stops.append(g + every - g % every - base)
        if self.recovery.faults is not None:
            stops += [f.at - base for f in
                      self.recovery.faults.pending("train.step") if f.at > g]
        return min(stops)

    def _run_steps(self, epoch: int, order: np.ndarray, device_data: bool,
                   skip_steps: int) -> tuple[torch.Tensor, int]:
        """The epoch's steps from `skip_steps` on: on the device-resident
        route in chunks (`_chunk_end`), each one call of the scan epoch
        over this rank's columns of the permutation; on the other one
        host batch a step. After each chunk or step: the train log at
        multiples of log_every, the step checkpoint, the fault hooks.
        Returns the metric sums (on the device) and the updates kept."""
        cfg = self.cfg
        b, nsteps = cfg.batch_size, self.steps_per_epoch
        base = epoch * nsteps
        timer = self._timer
        if device_data:
            with timer.phase("data"):
                if self._dev_images is None:
                    self._stage_dataset()
                perm = torch.from_numpy(np.ascontiguousarray(dp_shard_perm(
                    order.reshape(nsteps, b), self.mesh))).to(self.device)
        sums = torch.zeros(len(METRICS), device=self.device)
        ngood, done = 0, skip_steps
        while done < nsteps:
            if device_data:
                # the counted step is a chunk of its own on every rank
                # (the steps are the same however the epoch is cut)
                end = (done + 1 if self.programs.first("scan_epoch")
                       else self._chunk_end(base, done))
                with self.programs.dispatch("scan_epoch", timer,
                                            counting="static-body"):
                    self.state = self._scan_epoch(
                        self.state, self._dev_images, self._dev_labels,
                        perm[done:end], sums)
                kept = True
                ngood += end - done
            else:
                end = done + 1
                kept = self._batch_step(base + done, order[done * b:end * b],
                                        sums)
                ngood += kept
            if kept and cfg.log_every > 0 and end % cfg.log_every == 0:
                self._log_train(epoch, end, sums, ngood)
            with timer.phase("checkpoint"):
                self.recovery.save_every(self.state,
                                         cfg.checkpoint_every_steps,
                                         base + end)
            self.recovery.step_boundary(self.state, base + end)
            done = end
        return sums, ngood

    def train(self) -> TrainResult:
        """The configured epochs (from the latest checkpoint with
        `resume`), evals every `eval_every` epochs or one at the end, and
        the reference's `ntests=, ncorrect=` line."""
        cfg = self.cfg
        start_epoch = skip_steps = 0
        if self.recovery.resume(self.state):
            start_epoch, skip_steps = divmod(self.step, self.steps_per_epoch)
        epoch_seconds: list[float] = []
        steps = 0
        ntests, ncorrect, result_acc = len(self.test_x), 0, 0.0
        sink = self.metrics.sink_or_none()
        ckpt = self.recovery.ckpt
        try:
            with profile_trace(cfg.profile_dir):
                epoch = start_epoch
                while epoch < cfg.epochs:
                    try:
                        em = self.run_epoch(epoch, skip_steps=skip_steps)
                    except RollbackToCheckpoint:
                        self.recovery.rollback(self.state)
                        epoch, skip_steps = divmod(self.step,
                                                   self.steps_per_epoch)
                        continue
                    skip_steps = 0
                    steps += em["steps"]
                    epoch_seconds.append(em["seconds"])
                    self.metrics.log("epoch", **em)
                    if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                        with span("eval", metrics=sink):
                            ntests, ncorrect = self.evaluate()
                        result_acc = ncorrect / ntests
                        self.metrics.log("eval", epoch=epoch, ntests=ntests,
                                         ncorrect=ncorrect,
                                         accuracy=result_acc)
                    if ckpt is not None and cfg.checkpoint_every and \
                            (epoch + 1) % cfg.checkpoint_every == 0:
                        with span("checkpoint", metrics=sink):
                            self.recovery.save_every(
                                self.state, cfg.checkpoint_every, epoch + 1)
                    epoch += 1
                if ckpt is not None:
                    with span("checkpoint", metrics=sink):
                        self.recovery.finish(self.state)
        finally:
            self.recovery.close()
        if not (cfg.eval_every and cfg.epochs > start_epoch
                and cfg.epochs % cfg.eval_every == 0):
            ntests, ncorrect = self.evaluate()
            result_acc = ncorrect / ntests
        # The reference's one benchmark line (cnn.c:518).
        self.log.info("ntests=%d, ncorrect=%d", ntests, ncorrect)
        return TrainResult(
            epochs_run=cfg.epochs - start_epoch, final_step=self.step,
            test_accuracy=result_acc, ntests=ntests, ncorrect=ncorrect,
            epoch_seconds=epoch_seconds,
            mean_step_ms=1e3 * sum(epoch_seconds) / max(steps, 1))

    @torch.no_grad()
    def predict(self, x: torch.Tensor, params=None,
                microbatches: int = 1) -> torch.Tensor:
        """Logits of a device batch (on a sharded path this rank's
        forward, the same on every rank; the pipeline's in
        `microbatches`)."""
        params = self.params if params is None else params
        if self.n_pipe > 1:
            return self.par.forward(params, x, microbatches)
        if self.par is not None:
            return self.par.forward(params, x)
        return self.model.apply(params, x, backend=self.backend,
                                compute_dtype=self.compute_dtype)

    def evaluate(self, params=None) -> tuple[int, int]:
        """Forward argmax sweep over the test set (cnn.c:494-518). The
        tail batch is padded to the eval batch; padding rows are not
        counted. With a mesh each rank predicts its rows of each eval
        batch (`_shard_rows`; on the pipe axis in the step's microbatches)
        and the counts are summed over the data line (one all-reduce).
        Returns (ntests, ncorrect)."""
        params = self.params if params is None else params
        n = len(self.test_x)
        b = self._eval_batch
        ncorrect = 0
        mine = self._shard_rows(b)
        for start in range(0, n, b):
            chunk = self.test_x[start:start + b]
            valid = len(chunk)
            if valid < b:
                pad = np.zeros((b - valid, *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            x = torch.from_numpy(np.ascontiguousarray(chunk[mine]))
            logits = self.predict(x.to(self.device), params, self.pp_m)
            keep = mine < valid
            pred = logits.argmax(-1).cpu().numpy()[keep]
            ncorrect += int((pred == self.test_labels[start + mine[keep]])
                            .sum())
        total = torch.tensor([ncorrect], dtype=torch.float64,
                             device=self.device)
        return n, int(all_reduce_sum(total, self.mesh, DATA_AXIS).item())
