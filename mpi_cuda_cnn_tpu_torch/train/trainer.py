"""CNN train and eval loops on one device (counterpart of the
reference's `train/trainer.py`).

The reference's loop (cnn.c:445-474) is per-sample SGD with gradients
accumulated over 32 samples; eval is a forward argmax sweep printing
"ntests=%d, ncorrect=%d" (cnn.c:494-518). As in the JAX package the loop
is batched (batch == the reference's accumulator period), the epoch order
is a numpy permutation keyed on (seed, epoch), and an epoch runs one of
two ways with identical arithmetic:

- device-resident (default, the twin of `_run_epoch_scanned` and
  `parallel/dp.make_dp_scan_epoch`): the uint8 images and int32 labels
  are staged on the device once; each step gathers its batch by index,
  divides by PIXEL_SCALE and one-hots on the device. Metric sums stay on
  the device, so the host waits only at `log_every` and at the end;
- per batch (`scan=False`, or a dataset over `scan_max_bytes`): the host
  normalizes each batch and copies it over.

A step is the forward, softmax-CE, `torch.autograd.grad` through the
backend's ops (with `use_kernels`, the hand-written CUDA kernels of
`ops/kernel_ops.py` in both directions) and the in-place SGD update.
With `compute_dtype="bfloat16"` the forward and backward run in bf16
(`Sequential.apply` casts on entry) while the params, their gradients
and the SGD update stay float32.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .._device import resolve_device
from ..data.pipeline import (
    PIXEL_SCALE,
    ensure_channel_axis,
    normalize_images,
    one_hot,
)
from ..models.initializers import get_initializer
from ..models.layers import tree_leaves
from ..ops.activations import stable_softmax
from ..ops.gemv import tree_map
from ..ops.losses import softmax_cross_entropy, squared_error_total
from ..utils.config import COMPUTE_DTYPES, check_supported
from ..utils.logging import MetricsLogger, get_logger
from .optimizer import make_optimizer

METRICS = ("loss", "etotal", "acc")


def make_loss_fn(model, *, backend: str = "torch",
                 compute_dtype: torch.dtype | None = None):
    """Softmax-CE loss + the reference's metrics (squared-error total,
    cnn.c:275-282; argmax accuracy, cnn.c:508-513). The metrics are
    computed from detached logits: only the loss is differentiated. With
    a compute_dtype the forward runs in it and the float32 logits feed
    the loss, as in the reference."""

    def loss_fn(params, x, y_onehot):
        logits = model.apply(params, x, backend=backend,
                             compute_dtype=compute_dtype)
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
    """model + dataset + config -> trained params, on one device.

    `params` (a params tree of tensors, e.g. `convert.params_from_jax` of
    the JAX trainer's initial params) replaces the seeded init.
    """

    def __init__(self, model, dataset, config, *,
                 metrics: MetricsLogger | None = None, params=None):
        check_supported(config)
        self.model = model
        self.ds = dataset
        self.cfg = config
        self.log = get_logger()
        self.metrics = metrics or MetricsLogger()
        self.device = resolve_device(config.device)
        self.backend = "cuda" if config.use_kernels else "torch"
        self.compute_dtype = COMPUTE_DTYPES[config.compute_dtype]
        self.loss_fn = make_loss_fn(model, backend=self.backend,
                                    compute_dtype=self.compute_dtype)

        self.num_train = len(dataset.train_images)
        self.test_x = normalize_images(dataset.test_images)
        self.test_labels = np.asarray(dataset.test_labels)
        self.steps_per_epoch = self.num_train // config.batch_size
        if self.steps_per_epoch == 0:
            raise ValueError(
                f"batch_size {config.batch_size} exceeds train set size "
                f"{self.num_train}: no full batches")
        self.optimizer = make_optimizer(
            config.lr, momentum=config.momentum, schedule=config.lr_schedule,
            total_steps=self.steps_per_epoch * config.epochs or None,
            grad_clip=config.grad_clip)

        if params is None:
            params = model.init(torch.Generator().manual_seed(config.seed),
                                get_initializer(config.init))
        self.params = tree_map(
            lambda t: t.detach().to(self.device, torch.float32).clone()
            .requires_grad_(True), params)
        self.leaves = tree_leaves(self.params)
        self.opt_state = self.optimizer.init(self.leaves)
        self.step = 0
        self._eval_batch = self._pick_eval_batch(len(self.test_x), 1)
        self._dev_images = None
        self._dev_labels = None
        self._classes = torch.arange(dataset.num_classes, device=self.device)

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

    def _use_device_data(self) -> bool:
        """Stage the whole uint8 set on the device unless scan is off or
        the set is over --scan-max-bytes (then stream per batch)."""
        nbytes = self.ds.train_images.nbytes + 4 * self.num_train
        return self.cfg.scan and nbytes <= self.cfg.scan_max_bytes

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One SGD step on a device batch; returns the step's (loss,
        etotal, acc) as one device tensor."""
        loss, aux = self.loss_fn(self.params, x, y)
        grads = torch.autograd.grad(loss, self.leaves)
        self.optimizer.update(self.leaves, grads, self.opt_state)
        self.step += 1
        return torch.stack([loss.detach(), aux["etotal"], aux["acc"]])

    def _log_train(self, epoch: int, step: int, sums: torch.Tensor,
                   n: int) -> None:
        vals = (sums / n).tolist()
        self.metrics.log("train", epoch=epoch, step=step,
                         **dict(zip(METRICS, vals)))

    def _stage_dataset(self) -> None:
        images = ensure_channel_axis(self.ds.train_images)
        self._dev_images = torch.from_numpy(
            np.ascontiguousarray(images, np.uint8)).to(self.device)
        self._dev_labels = torch.from_numpy(
            np.asarray(self.ds.train_labels, np.int32)).to(self.device)

    def run_epoch(self, epoch: int) -> dict:
        """One epoch over the training set in the (seed, epoch) order.
        Returns the mean loss/etotal/acc and the wall seconds, which end
        after the device has finished the epoch."""
        cfg = self.cfg
        t0 = time.perf_counter()
        b = cfg.batch_size
        nsteps = self.steps_per_epoch
        order = self._epoch_order(epoch)[: nsteps * b]
        device_data = self._use_device_data()
        if device_data:
            if self._dev_images is None:
                self._stage_dataset()
            perm = torch.from_numpy(order.reshape(nsteps, b)).to(self.device)
        else:
            labels = np.asarray(self.ds.train_labels)
        sums = torch.zeros(len(METRICS), device=self.device)
        for i in range(nsteps):
            if device_data:
                idx = perm[i]
                x = self._dev_images.index_select(0, idx).float() / PIXEL_SCALE
                y = (self._dev_labels.index_select(0, idx)[:, None]
                     == self._classes).float()
            else:
                idx = order[i * b:(i + 1) * b]
                x = torch.from_numpy(
                    normalize_images(self.ds.train_images[idx])).to(self.device)
                y = torch.from_numpy(
                    one_hot(labels[idx], self.ds.num_classes)).to(self.device)
            sums += self.train_step(x, y)
            if cfg.log_every > 0 and (i + 1) % cfg.log_every == 0:
                self._log_train(epoch, i + 1, sums, i + 1)
        self._sync()
        seconds = time.perf_counter() - t0
        means = (sums / nsteps).tolist()
        return {"epoch": epoch, "steps": nsteps,
                **dict(zip(METRICS, means)), "seconds": seconds}

    def train(self) -> TrainResult:
        cfg = self.cfg
        epoch_seconds: list[float] = []
        steps = 0
        ntests, ncorrect, result_acc = len(self.test_x), 0, 0.0
        for epoch in range(cfg.epochs):
            em = self.run_epoch(epoch)
            steps += em["steps"]
            epoch_seconds.append(em["seconds"])
            self.metrics.log("epoch", epoch=epoch, seconds=em["seconds"])
            if cfg.eval_every and (epoch + 1) % cfg.eval_every == 0:
                ntests, ncorrect = self.evaluate()
                result_acc = ncorrect / ntests
                self.metrics.log("eval", epoch=epoch, ntests=ntests,
                                 ncorrect=ncorrect, accuracy=result_acc)
        if not (cfg.eval_every and cfg.epochs > 0
                and cfg.epochs % cfg.eval_every == 0):
            ntests, ncorrect = self.evaluate()
            result_acc = ncorrect / ntests
        # The reference's one benchmark line (cnn.c:518).
        self.log.info("ntests=%d, ncorrect=%d", ntests, ncorrect)
        return TrainResult(
            epochs_run=cfg.epochs, final_step=self.step,
            test_accuracy=result_acc, ntests=ntests, ncorrect=ncorrect,
            epoch_seconds=epoch_seconds,
            mean_step_ms=1e3 * sum(epoch_seconds) / max(steps, 1))

    @torch.no_grad()
    def predict(self, x: torch.Tensor, params=None) -> torch.Tensor:
        """Logits of a device batch."""
        return self.model.apply(self.params if params is None else params, x,
                                backend=self.backend,
                                compute_dtype=self.compute_dtype)

    def evaluate(self, params=None) -> tuple[int, int]:
        """Forward argmax sweep over the test set (cnn.c:494-518). The
        tail batch is padded to the eval batch; padding rows are not
        counted. Returns (ntests, ncorrect)."""
        n = len(self.test_x)
        b = self._eval_batch
        ncorrect = 0
        for start in range(0, n, b):
            chunk = self.test_x[start:start + b]
            valid = len(chunk)
            if valid < b:
                pad = np.zeros((b - valid, *chunk.shape[1:]), chunk.dtype)
                chunk = np.concatenate([chunk, pad])
            logits = self.predict(torch.from_numpy(chunk).to(self.device),
                                  params)
            pred = logits[:valid].argmax(-1).cpu().numpy()
            ncorrect += int((pred == self.test_labels[start:start + valid]).sum())
        return n, ncorrect
