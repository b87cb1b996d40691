"""Logging (the part of the reference's `utils/logging.py` the trainer
uses).

The reference's entire observability surface is fprintf(stderr, ...): a
running squared-error every 1000 steps (cnn.c:470-473) and one final
"ntests=%d, ncorrect=%d" line (cnn.c:518). `MetricsLogger` echoes the
trainer's records as the same human-readable `event k=v ...` lines the
reference's logger prints, or stays silent. The JSONL sink is not ported
yet (`--metrics-jsonl` is refused, ROADMAP queue E item 6).

In a data-parallel run every rank runs the same loop and only rank 0
echoes, so a run prints each line once, as the reference's rank-0-only
eval print does (cnnmpi.c:521). A rank's failure reaches the launcher
as its traceback (`parallel.distributed.run_ranks`).
"""

from __future__ import annotations

import logging
import sys

import torch.distributed as dist

_LOGGER_NAME = "mpi_cuda_cnn_tpu_torch"


def is_rank_zero() -> bool:
    """True outside a process group and on its rank 0."""
    return not (dist.is_available() and dist.is_initialized()) \
        or dist.get_rank() == 0


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                              "%H:%M:%S"))
        handler.addFilter(lambda record: is_rank_zero())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsLogger:
    """Trainer records as `event k=v ...` lines on the package logger
    (echo=True, on rank 0 only), or nowhere (echo=False). With capture,
    every record is also kept in `rows` as {"event": event, **fields},
    as the reference's logger keeps them."""

    def __init__(self, echo: bool = True, capture: bool = False):
        self._echo = echo
        self._log = get_logger()
        self.rows: list[dict] | None = [] if capture else None

    def log(self, event: str, **fields) -> None:
        if self.rows is not None:
            self.rows.append({"event": event, **fields})
        if self._echo:
            body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            self._log.info("%s %s", event, body)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
