"""Logging (the part of the reference's `utils/logging.py` the trainer
uses).

The reference's entire observability surface is fprintf(stderr, ...): a
running squared-error every 1000 steps (cnn.c:470-473) and one final
"ntests=%d, ncorrect=%d" line (cnn.c:518). `MetricsLogger` echoes the
trainer's records as the same human-readable `event k=v ...` lines the
reference's logger prints, or stays silent, and with a path appends them
to a JSONL file as schema-stamped records (`obs/schema.py`), after a
`# run <UTC stamp>` marker: the file the reference's `report` reads.

In a data-parallel run every rank runs the same loop and only rank 0
echoes, so a run prints each line once, as the reference's rank-0-only
eval print does (cnnmpi.c:521). A rank's failure reaches the launcher
as its traceback (`parallel.distributed.run_ranks`).
"""

from __future__ import annotations

import json
import logging
import sys
import time
from pathlib import Path

import torch.distributed as dist

from ..obs.schema import RUN_MARKER, make_record
from .clock import utc_stamp

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
    (echo=True, on rank 0 only), appended to the JSONL file at `path`
    (None: none), and, with capture, kept in `rows` as {"event": event,
    **fields}. A file record is `obs.schema.make_record`'s: "t" is
    seconds since the logger was made on `clock` (time.perf_counter's
    shape). The file starts with a run marker line unless `new_run` is
    False (a restarted world's attempt, or its parent, goes on with the
    run the first attempt opened). A context manager: the file
    is closed on the way out, an exception included, so the records
    written so far survive it."""

    def __init__(self, path: str | Path | None = None, echo: bool = True,
                 capture: bool = False, clock=None, new_run: bool = True):
        self._clock = clock if clock is not None else time.perf_counter
        self._file = None
        if path is not None:
            p = Path(path)
            p.parent.mkdir(parents=True, exist_ok=True)
            self._file = p.open("a")
            if new_run:
                self._file.write(f"{RUN_MARKER} {utc_stamp()}\n")
                self._file.flush()
        self._echo = echo
        self._log = get_logger()
        self._t0 = self._clock()
        self.rows: list[dict] | None = [] if capture else None
        # Streaming observer: called with every record (the file's
        # shape) as it is logged; `obs.alerts.AlertEngine.attach` hangs
        # here, so the live alert fold sees exactly what the file gets.
        # It may log() again (alerts go back through the same sink).
        self.observer = None

    @property
    def jsonl_enabled(self) -> bool:
        """Whether a JSONL file is open: the gate of the telemetry that
        costs something to make (phase records, memory snapshots)."""
        return self._file is not None

    def sink_or_none(self) -> MetricsLogger | None:
        """self when the file is open, else None (`obs.trace.span`'s
        `metrics` argument)."""
        return self if self.jsonl_enabled else None

    def log(self, event: str, **fields) -> None:
        if self.rows is not None:
            self.rows.append({"event": event, **fields})
        record = None
        if self._file is not None or self.observer is not None:
            record = make_record(event, self._clock() - self._t0, **fields)
        if self._file is not None:
            self._file.write(json.dumps(record) + "\n")
            self._file.flush()
        if self._echo:
            body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
            self._log.info("%s %s", event, body)
        if self.observer is not None:
            self.observer(record)

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self) -> MetricsLogger:
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return v
