"""Logging (the part of the reference's `utils/logging.py` the trainer
uses).

The reference's entire observability surface is fprintf(stderr, ...): a
running squared-error every 1000 steps (cnn.c:470-473) and one final
"ntests=%d, ncorrect=%d" line (cnn.c:518). `MetricsLogger` echoes the
trainer's records as the same human-readable `event k=v ...` lines the
reference's logger prints, or stays silent. The JSONL sink is not ported
yet (`--metrics-jsonl` is refused, ROADMAP queue E item 6).
"""

from __future__ import annotations

import logging
import sys

_LOGGER_NAME = "mpi_cuda_cnn_tpu_torch"


def get_logger() -> logging.Logger:
    logger = logging.getLogger(_LOGGER_NAME)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(levelname)s %(message)s",
                              "%H:%M:%S"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


class MetricsLogger:
    """Trainer records as `event k=v ...` lines on the package logger
    (echo=True), or nowhere (echo=False)."""

    def __init__(self, echo: bool = True):
        self._echo = echo
        self._log = get_logger()

    def log(self, event: str, **fields) -> None:
        if self._echo:
            body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            self._log.info("%s %s", event, body)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
