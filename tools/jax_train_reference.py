#!/usr/bin/env python3
"""Test accuracy the JAX package reaches on the CPU for the port's train
phase (`chip_smoke.py` train): reference_cnn on synthetic_stripes(60,000,
10,000), batch 32, SGD at lr 0.1, seed 0, two epochs (the phase's
warm-up epoch plus its measured epoch), then the test split.

    JAX_PLATFORMS=cpu python3 tools/jax_train_reference.py

Prints one JSON line. It imports the JAX package, so it lives outside
both packages; the port never imports it.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu.models.presets import get_model
    from mpi_cuda_cnn_tpu.train.trainer import Trainer
    from mpi_cuda_cnn_tpu.utils.config import Config
    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger

    t0 = time.perf_counter()
    ds = synthetic_stripes(num_train=60_000, num_test=10_000)
    cfg = Config(model="reference_cnn", epochs=2, batch_size=32, lr=0.1,
                 seed=0, num_devices=1, log_every=0, eval_every=0)
    trainer = Trainer(get_model("reference_cnn"), ds, cfg,
                      metrics=MetricsLogger(echo=False))
    epochs = [trainer.run_epoch(e) for e in range(cfg.epochs)]
    ntests, ncorrect = trainer.evaluate()
    print(json.dumps({
        "reference": "jax", "backend": jax.default_backend(),
        "model": "reference_cnn", "num_train": 60_000, "epochs": cfg.epochs,
        "epoch_loss": [e["loss"] for e in epochs],
        "epoch_acc": [e["acc"] for e in epochs],
        "ntests": ntests, "ncorrect": ncorrect,
        "accuracy": ncorrect / ntests,
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
