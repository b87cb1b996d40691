"""`python -m mpi_cuda_cnn_tpu_torch train-bench` — MNIST-shaped epoch
wall-clock of the CNN trainer (counterpart of the reference's `bench.py`).

The reference's training config: its exact model (reference_cnn), batch
32 (its accumulator period), lr 0.1, SGD, on 60,000 MNIST-shaped samples
(synthetic stripes; the compute per step is the same as on MNIST). One
warm-up epoch stages the dataset and builds the kernels, then the
measured epochs run through the device-resident path; `value` is their
median wall time. `device_epoch_s` is the median time between two CUDA
events recorded on the stream at the start and end of each measured
epoch (the span the device timeline covers, idle gaps included). Then
the test split is evaluated. Prints one JSON line, with the keys of the
reference's bench line (`metric`, `value`, `unit`, `vs_baseline`,
`best_s`), the kernel launches of the measured epochs and of the eval.

    python -m mpi_cuda_cnn_tpu_torch train-bench --use-kernels
    python -m mpi_cuda_cnn_tpu_torch train-bench --device cpu \\
        --num-train 256 --num-test 64 --epochs 1
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import torch

REFERENCE_EPOCH_S = 99.0  # the serial C reference on a CPU (BASELINE.md)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch train-bench",
        description="Epoch wall-clock of reference_cnn training on "
                    "MNIST-shaped synthetic data, one device.")
    ap.add_argument("--use-kernels", action="store_true",
                    help="the hand-written CUDA kernels (csrc/) instead of "
                         "PyTorch's own ops")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--num-train", type=int, default=60_000)
    ap.add_argument("--num-test", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=5,
                    help="measured epochs, after one warm-up epoch")
    return ap


def train_bench(argv: list[str] | None = None) -> dict:
    """Run the bench; return {"line": the JSON line's dict, "trainer"}.
    Raises RuntimeError without a card when the card is asked for."""
    from ..data.datasets import synthetic_stripes
    from ..models.presets import get_model
    from ..ops import _kernels
    from ..utils.config import Config
    from ..utils.logging import MetricsLogger
    from .trainer import Trainer

    args = _parser().parse_args(argv)
    if args.epochs < 1:
        raise ValueError("--epochs must be >= 1")
    t_start = time.perf_counter()
    ds = synthetic_stripes(num_train=args.num_train, num_test=args.num_test)
    cfg = Config(model="reference_cnn", epochs=1 + args.epochs,
                 batch_size=32, lr=0.1, seed=0, device=args.device,
                 use_kernels=args.use_kernels, log_every=0, eval_every=0)
    trainer = Trainer(get_model("reference_cnn"), ds, cfg,
                      metrics=MetricsLogger(echo=False))
    cuda = trainer.device.type == "cuda"

    trainer.run_epoch(0)  # warm-up: stages the data, builds the kernels
    times, device_times = [], []
    before = dict(_kernels.launches)
    for epoch in range(1, 1 + args.epochs):
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
            start.record()
        t0 = time.perf_counter()
        em = trainer.run_epoch(epoch)
        times.append(time.perf_counter() - t0)
        if cuda:
            end.record()
            end.synchronize()
            device_times.append(start.elapsed_time(end) / 1e3)
    launches = {k: _kernels.launches[k] - before[k] for k in before}
    before = dict(_kernels.launches)
    ntests, ncorrect = trainer.evaluate()
    eval_launches = {k: _kernels.launches[k] - before[k] for k in before}

    epoch_s = statistics.median(times)
    steps = trainer.steps_per_epoch
    line = {
        "schema": 1, "event": "bench",
        "t": round(time.perf_counter() - t_start, 4),
        "metric": "mnist_epoch_wallclock",
        "value": epoch_s, "unit": "s",
        "vs_baseline": REFERENCE_EPOCH_S / epoch_s,
        "best_s": min(times),
        "device_epoch_s": statistics.median(device_times) if cuda else None,
        "epoch_s": times,
        "steps_per_epoch": steps,
        "step_ms": 1e3 * epoch_s / steps,
        "samples_per_s": steps * cfg.batch_size / epoch_s,
        "loss": em["loss"], "acc": em["acc"], "etotal": em["etotal"],
        "ntests": ntests, "ncorrect": ncorrect,
        "backend": trainer.backend,
        "device": (torch.cuda.get_device_name(trainer.device) if cuda
                   else "cpu"),
        "kernel_launches": launches,
        "eval_kernel_launches": eval_launches,
        "note": f"value = median wall-clock of {args.epochs} measured "
                "epochs after one warm-up (device-resident data, one host "
                "sync per epoch); device_epoch_s = CUDA-event span of the "
                "same epochs",
    }
    return {"line": line, "trainer": trainer}


def train_bench_main(argv: list[str] | None = None) -> int:
    try:
        out = train_bench(argv)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    print(json.dumps(out["line"]))
    return 0
