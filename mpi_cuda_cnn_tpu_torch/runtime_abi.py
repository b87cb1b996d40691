"""String-in/string-out driver of both trainers (counterpart of the
reference's `runtime_abi.py`, the Python side of its C ABI,
native/tpu_abi.h).

One module-level trainer, driven by calls that take and return JSON
strings: `init` builds the CNN `Trainer` from one config JSON, and each
later call returns one JSON metrics line; `lm_init` and `lm_train` do
the same for the `LMTrainer`. The state (params, optimizer, the step)
stays on the device for the life of the process.

The reference's C front end (native/tpu_abi.c) imports
`mpi_cuda_cnn_tpu.runtime_abi` by name, so it drives the JAX package
only; this twin is called from Python. It reads the same config JSON
(`utils.config.Config.from_json` / `LMConfig.from_json`: the
reference's field and device names are mapped) and runs on the device
the config names, the card unless it says "cpu" (the reference's
"jax-cpu"); a card that is not there raises, with no fallback to the
CPU. `save` and `load` write and read the reference's checkpoint
format (train/checkpoint.py), so either package restores the other's
files.
"""

from __future__ import annotations

import dataclasses
import json

_STATE: dict = {}


def init(config_json: str) -> str:
    from ._device import resolve_device
    from .data.datasets import get_dataset, load_idx_dataset
    from .models.presets import get_model
    from .train.trainer import Trainer
    from .utils.config import Config
    from .utils.logging import MetricsLogger

    cfg = Config.from_json(config_json)
    resolve_device(cfg.device)      # no card: raise before loading data
    if cfg.dataset == "idx":
        ds = load_idx_dataset(
            "idx", cfg.train_images, cfg.train_labels,
            cfg.test_images, cfg.test_labels,
        )
    else:
        ds = get_dataset(cfg.dataset, data_dir=cfg.data_dir)
    model = get_model(cfg.model, input_shape=ds.input_shape)
    trainer = Trainer(model, ds, cfg, metrics=MetricsLogger(echo=False))
    _STATE.update(trainer=trainer, cfg=cfg, epoch=0)
    return json.dumps({"ok": True, "model": model.name,
                       "n_params": model.num_params(trainer.state["params"])})


def _trainer():
    if "trainer" not in _STATE:
        raise RuntimeError("runtime_abi.init() not called")
    return _STATE["trainer"]


def train_epoch() -> str:
    """Run one epoch through Trainer.run_epoch (the loop the `train`
    command runs: one implementation, one shuffle stream); returns the
    epoch's metrics as JSON."""
    t = _trainer()
    metrics = t.run_epoch(_STATE["epoch"])
    _STATE["epoch"] += 1
    metrics["seconds"] = round(metrics["seconds"], 3)
    return json.dumps(metrics)


def evaluate() -> str:
    ntests, ncorrect = _trainer().evaluate()
    return json.dumps({"ntests": ntests, "ncorrect": ncorrect})


def lm_init(config_json: str) -> str:
    """LM twin of init(): build an LMTrainer from an LMConfig JSON (the
    loop the `lm` command runs: corpus loading, the mesh dispatch and
    checkpointing)."""
    from ._device import resolve_device
    from .train.lm import count_params
    from .train.lm_trainer import LMTrainer
    from .utils.config import LMConfig
    from .utils.logging import MetricsLogger

    cfg = LMConfig.from_json(config_json)
    resolve_device(cfg.device)
    trainer = LMTrainer(cfg, metrics=MetricsLogger(echo=False))
    _STATE["lm"] = trainer
    return json.dumps({
        "ok": True,
        "vocab": trainer.model.vocab,
        "n_params": count_params(trainer.state["params"]),
    })


def lm_train() -> str:
    """Run the configured LM training (cfg.steps optimizer steps, the
    eval at the end) and return the LMResult as one JSON line."""
    if "lm" not in _STATE:
        raise RuntimeError("runtime_abi.lm_init() not called")
    res = _STATE["lm"].train()
    out = dataclasses.asdict(res)
    out["tokens_per_s"] = round(out["tokens_per_s"], 1)
    for k in ("final_loss", "eval_loss", "eval_ppl"):
        out[k] = round(out[k], 4)
    return json.dumps(out)


def save(path: str) -> str:
    """The CNN trainer's state as the reference's checkpoint arrays, into
    ckpt_{step}.npz under `path`."""
    from .train.checkpoint import save_checkpoint

    t = _trainer()
    out = save_checkpoint(path, t.recovery.arrays(t.state), t.step)
    return json.dumps({"path": str(out)})


def load(path: str) -> str:
    """Restore the newest checkpoint under `path` (or the file `path`)
    into the CNN trainer's live state, in place: each tensor keeps its
    device and placement, as the reference's `place_state` keeps its
    shardings."""
    from .train.checkpoint import latest_checkpoint, restore_checkpoint

    t = _trainer()
    ckpt = latest_checkpoint(path) or path
    t.recovery.install(t.state, restore_checkpoint(
        ckpt, t.recovery.arrays(t.state)))
    return json.dumps({"restored": str(ckpt)})
