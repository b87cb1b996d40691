"""Command line of the port: `python -m mpi_cuda_cnn_tpu_torch <command>`.

    train         the CNN trainer (reference CLI contract: 4 positional
                  IDX paths, exit 100 on a wrong count, 111 on bad data
                  files, 2 on a bad config; or --dataset NAME)
    train-bench   the MNIST-shaped epoch wall-clock bench (train/bench.py)
    serve-bench   the paged continuous-batching serving bench
                  (serve/bench.py)
    lm            the transformer-LM trainer (train/lm_trainer.py; exit 2
                  on a bad or unported flag)
    lm-bench      the LM pretraining throughput matrix (train/lm_bench.py)

Every command runs on the card unless given --device cpu.
"""

from __future__ import annotations

import sys

_USAGE = ("usage: python -m mpi_cuda_cnn_tpu_torch "
          "{train,train-bench,serve-bench,lm,lm-bench} [flags]")


def run_train(argv: list[str]) -> int:
    """The `train` command, mirroring the reference's `cli.run`."""
    from ._device import resolve_device
    from .data.datasets import get_dataset, load_idx_dataset
    from .data.idx import IdxError
    from .models.presets import get_model
    from .train.trainer import Trainer
    from .utils.config import check_supported, parse_args
    from .utils.logging import MetricsLogger, get_logger

    try:
        cfg = parse_args(argv)
    except SystemExit as e:  # 100 on a wrong IDX count, 2 on a bad flag
        return e.code if isinstance(e.code, int) else 2
    log = get_logger()
    try:
        check_supported(cfg)
        resolve_device(cfg.device)
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
    log.info("model=%s dataset=%s input=%s backend=%s", model.name, ds.name,
             ds.input_shape, "cuda" if cfg.use_kernels else "torch")
    try:
        trainer = Trainer(model, ds, cfg, metrics=MetricsLogger())
    except ValueError as e:
        log.error("trainer setup failed: %s", e)
        return 2
    result = trainer.train()
    log.info("done: epochs=%d acc=%.4f mean_step=%.3fms", result.epochs_run,
             result.test_accuracy, result.mean_step_ms)
    return 0


def run_lm(argv: list[str]) -> int:
    """The `lm` command, mirroring the reference's `cli.run_lm` on one
    device."""
    from ._device import resolve_device
    from .train.lm_trainer import LMTrainer
    from .utils.config import check_lm_supported, parse_lm_args
    from .utils.logging import MetricsLogger, get_logger

    try:
        cfg = parse_lm_args(argv)
    except SystemExit as e:  # argparse: 2 on a bad flag, 0 on --help
        return e.code if isinstance(e.code, int) else 2
    log = get_logger()
    try:
        check_lm_supported(cfg)
        resolve_device(cfg.device)
    except (NotImplementedError, RuntimeError, ValueError) as e:
        log.error("%s", e)
        return 2
    try:
        trainer = LMTrainer(cfg, metrics=MetricsLogger())
    except (OSError, ValueError) as e:
        log.error("lm setup failed: %s", e)
        return 2
    log.info("lm model=d%dx%d h%d seq=%d vocab=%d device=%s attn=%s",
             cfg.dim, cfg.depth, cfg.heads, cfg.seq_len, trainer.model.vocab,
             trainer.device, trainer.attn_impl)
    result = trainer.train()
    log.info("done: steps=%d eval_ppl=%.3f tokens/s=%.0f", result.steps_run,
             result.eval_ppl, result.tokens_per_s)
    return 0


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
    if argv and argv[0] == "lm":
        return run_lm(argv[1:])
    if argv and argv[0] == "lm-bench":
        from .train.lm_bench import lm_bench_main

        return lm_bench_main(argv[1:])
    print(_USAGE, file=sys.stderr)
    return 2
