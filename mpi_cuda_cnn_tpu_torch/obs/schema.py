"""The JSONL record shape every metrics producer shares (counterpart of
the reference's `obs/schema.py`; the same version, keys and reader, so
that each package reads the other's run files).

Records are one JSON object per line, each with a version stamp
("schema"), an event name ("event") and "t", seconds since the producer
started (relative, so records of several processes need no clock
agreement). An event family may require more keys (`EVENT_KEYS`); the
others are free-form. Lines starting with '#' are comments; `RUN_MARKER`
comments split an append-mode file into runs (`iter_runs`).
"""

from __future__ import annotations

import json
from collections.abc import Iterable, Iterator
from pathlib import Path

SCHEMA_VERSION = 1

REQUIRED_KEYS = ("schema", "event", "t")

# The keys each family requires beyond REQUIRED_KEYS: the reference's
# table, whole, so a record valid here is valid there.
EVENT_KEYS: dict[str, tuple[str, ...]] = {
    "train": ("step", "loss"),
    "epoch": ("epoch", "seconds"),
    "eval": (),
    "step_phases": ("steps", "phases_ms"),
    "program": ("flops", "collectives"),
    "memory": ("devices",),
    "span": ("name", "ms"),
    "request": ("id", "mode", "prompt_tokens", "output_tokens", "ttft_ms",
                "latency_ms"),
    "serve": ("mode", "requests", "tokens_per_s"),
    "fault": ("kind",),
    "ckpt": ("step", "reason"),
    "metrics": ("counters", "gauges", "histograms"),
    "fleet": ("tick", "now", "replicas"),
    "transport": ("kind",),
    "handoff": ("rid", "state"),
    "replica": ("name", "kind"),
    "tick": ("tick", "now", "queue", "free_pages"),
    "bench": ("metric", "value", "unit"),
    "blame": ("mode", "requests", "categories"),
    "goodput": ("kind",),
    "chaos": ("kind",),
    "alert": ("seq", "rule", "kind", "severity", "at"),
}

# The comment MetricsLogger writes each time it opens a file.
RUN_MARKER = "# run"


def make_record(event: str, t: float, **fields) -> dict:
    """A schema-stamped record (not validated)."""
    return {"schema": SCHEMA_VERSION, "event": event, "t": round(t, 4),
            **fields}


def validate_record(rec: dict) -> dict:
    """Check one record against the schema and return it; ValueError
    names every missing key."""
    if not isinstance(rec, dict):
        raise ValueError(f"record must be an object, got {type(rec).__name__}")
    missing = [k for k in REQUIRED_KEYS if k not in rec]
    if missing:
        raise ValueError(f"record missing required keys {missing}: {rec}")
    if not isinstance(rec["schema"], int):
        raise ValueError(f"record schema must be an int: {rec['schema']!r}")
    if rec["schema"] > SCHEMA_VERSION:
        raise ValueError(f"record schema v{rec['schema']} is newer than "
                         f"this reader (v{SCHEMA_VERSION})")
    missing = [k for k in EVENT_KEYS.get(rec["event"], ()) if k not in rec]
    if missing:
        raise ValueError(f"{rec['event']!r} record missing keys {missing}: "
                         f"{rec}")
    return rec


def iter_records(path: str | Path, *, strict: bool = False) -> Iterator[dict]:
    """The records of a JSONL file, skipping blank and '#' lines. Records
    with a "schema" key are validated; others (and bad JSON) pass, or
    raise with strict=True."""
    for _, rec in _iter_lines(path, strict=strict):
        if rec is not None:
            yield rec


def iter_runs(path: str | Path, *, strict: bool = False
              ) -> Iterator[list[dict]]:
    """One record list per run, split at RUN_MARKER lines (a file with no
    marker is one run)."""
    current: list[dict] = []
    seen_any = False
    for is_marker, rec in _iter_lines(path, strict=strict):
        if is_marker:
            if current or seen_any:
                yield current
                current = []
            seen_any = True
        elif rec is not None:
            current.append(rec)
    if current or not seen_any:
        yield current


def _iter_lines(path: str | Path, *, strict: bool):
    """(is_run_marker, record | None) per line."""
    with Path(path).open() as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if line.startswith(RUN_MARKER):
                yield True, None
                continue
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                if strict:
                    raise ValueError(f"{path}:{lineno}: bad JSON: {e}") from e
                continue
            if strict or (isinstance(rec, dict) and "schema" in rec):
                validate_record(rec)
            yield False, rec


def load_records(path: str | Path, *, strict: bool = False) -> list[dict]:
    return list(iter_records(path, strict=strict))


def dump_records(records: Iterable[dict], path: str | Path) -> None:
    """Write records as JSONL (the round-trip twin of load_records)."""
    with Path(path).open("w") as fh:
        for rec in records:
            fh.write(json.dumps(rec) + "\n")


def fmt_cell(v, prec: int = 6) -> str:
    """The one table-cell formatter every obs renderer (report, trace,
    top, compare) shares: None is an em-dash (a moment that never
    happened), floats render at `prec` significant digits, dicts as
    sorted k:v pairs. The goldens under tests/data pin it."""
    if v is None:
        return "—"
    if isinstance(v, float):
        return f"{v:.{prec}g}"
    if isinstance(v, dict):
        return ", ".join(f"{k}:{n}" for k, n in sorted(v.items())) or "—"
    return str(v)
