#!/usr/bin/env python3
"""Test accuracy the JAX package reaches on the CPU for the port's train
phases: reference_cnn on synthetic_stripes(60,000, 10,000), batch 32, SGD
at lr 0.1, seed 0, then the test split. In float32 (`chip_smoke.py`
train) two epochs, the phase's warm-up epoch plus its measured epoch;
with `--compute-dtype bfloat16` (`chip_smoke.py` train_bf16) one epoch
with bf16 compute on the Pallas kernels (`use_pallas=True`, interpret
mode on the CPU), as that phase runs.

    JAX_PLATFORMS=cpu python3 tools/jax_train_reference.py
    JAX_PLATFORMS=cpu python3 tools/jax_train_reference.py --compute-dtype bfloat16

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
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--compute-dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args()
    bf16 = args.compute_dtype == "bfloat16"

    import jax

    jax.config.update("jax_platforms", "cpu")
    from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu.models.presets import get_model
    from mpi_cuda_cnn_tpu.train.trainer import Trainer
    from mpi_cuda_cnn_tpu.utils.config import Config
    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger

    t0 = time.perf_counter()
    ds = synthetic_stripes(num_train=60_000, num_test=10_000)
    cfg = Config(model="reference_cnn", epochs=1 if bf16 else 2,
                 batch_size=32, lr=0.1, seed=0, num_devices=1,
                 use_pallas=bf16, compute_dtype=args.compute_dtype,
                 log_every=0, eval_every=0)
    trainer = Trainer(get_model("reference_cnn"), ds, cfg,
                      metrics=MetricsLogger(echo=False))
    epochs = [trainer.run_epoch(e) for e in range(cfg.epochs)]
    ntests, ncorrect = trainer.evaluate()
    print(json.dumps({
        "reference": "jax", "backend": jax.default_backend(),
        "model": "reference_cnn", "num_train": 60_000, "epochs": cfg.epochs,
        "compute_dtype": cfg.compute_dtype, "use_pallas": cfg.use_pallas,
        "epoch_loss": [e["loss"] for e in epochs],
        "epoch_acc": [e["acc"] for e in epochs],
        "ntests": ntests, "ncorrect": ncorrect,
        "accuracy": ncorrect / ntests,
        "seconds": time.perf_counter() - t0,
    }))


if __name__ == "__main__":
    main()
