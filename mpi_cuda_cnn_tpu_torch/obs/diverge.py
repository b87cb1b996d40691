"""First-divergence localization: `python -m mpi_cuda_cnn_tpu_torch diverge
A B` (counterpart of the reference's `obs/diverge.py`, the same code and
output).

Streams two flight-recorder trails (obs/replay.py's fold) in lockstep
and finds the first tick, in the first stream (engine mode, fleet
router or replica), where the two runs' state digests disagree, then
diffs the two reconstructed states at that tick: rid sets, per-slot
extent and page changes, queue and free-page drift, dispatch and
handoff decisions, and the lifecycle context around them.

Divergence is judged on both signals of each record: the recorded
state_crc pair (two diverged producers stamp different digests) and
each side's own recomputed-against-stamped drift (a tampered or
truncated trail diverges from itself).

Exit codes: 0 the trails are digest-identical end to end, 1 a
divergence found (the report is the output), 2 config errors (an input
without a tick trail, or one older than the state digests).
"""

from __future__ import annotations

import argparse
import json
import sys

from .replay import ReplayError, RunReplay
from .schema import fmt_cell as _fmt
from .schema import iter_runs

# Tick-record event fields worth echoing as the divergence context.
_CONTEXT_FIELDS = ("admitted", "prefill", "decoded", "spec", "preempted",
                   "preempted_for", "finished", "aborted", "blocked",
                   "dispatched", "redispatched", "failed_over",
                   "handoff_started", "handoff_placed", "handoff_done",
                   "handoff_aborted")


def _last_run(path: str) -> list[dict]:
    runs = [r for r in iter_runs(path) if r]
    if not runs:
        raise ReplayError("no records")
    return runs[-1]


def _fold_collect(records: list[dict]):
    """(RunReplay folded best-effort, collected digest stream).
    Entries: (stream_key, stamped, recomputed|None, error|None)."""
    replay = RunReplay(records)
    collected: list = []
    replay.fold(collect=collected)
    return replay, collected


def _state_at(records: list[dict], stop_key) -> dict:
    """Re-fold up to and including the record at `stop_key`'s position
    (first occurrence), best-effort (the divergent record itself may
    not apply cleanly), and snapshot the state."""
    replay = RunReplay(records)
    for kind, key, rec in replay._ordered():
        if kind == "event":
            replay.fleet.apply_replica_event(rec)
            continue
        try:
            if kind == "fleet":
                replay.fleet.apply_fleet(rec)
            elif kind == "replica":
                replay.fleet.apply_replica_tick(rec)
            else:
                replay.mirrors[key[0]].apply(rec)
        except Exception:
            pass  # best-effort: the divergent record may not apply
        if key == stop_key:
            break
    return replay.snapshot()


def _mirror_of(snapshot: dict, stream) -> dict | None:
    if not isinstance(stream, str):
        return None
    if stream.startswith("fleet/"):
        fleet = snapshot.get("fleet") or {}
        return (fleet.get("replicas") or {}).get(stream.split("/", 1)[1])
    if stream == "fleet":
        return None
    return snapshot.get(stream)


def _diff_sched(a: dict, b: dict) -> list[str]:
    lines: list[str] = []
    sa = {row[0]: row for row in a.get("slots", [])}
    sb = {row[0]: row for row in b.get("slots", [])}
    for idx in sorted(set(sa) | set(sb)):
        ra, rb = sa.get(idx), sb.get(idx)
        if ra == rb:
            continue
        def show(r):
            if r is None:
                return "free"
            return (f"rid {r[1]} cached {r[2]} target {r[3]} "
                    f"pages {r[4]} refs {r[5]}")
        lines.append(f"  slot {idx}: A[{show(ra)}]  B[{show(rb)}]")
    for key, label in (("queue_len", "queue length"),
                       ("queue_head", "queue head"),
                       ("queue_tail", "queue tail"),
                       ("free_pages", "free pages")):
        if a.get(key) != b.get(key):
            lines.append(f"  {label}: A={_fmt(a.get(key))} "
                         f"B={_fmt(b.get(key))}")
    pa, pb = a.get("prefix"), b.get("prefix")
    if pa != pb and (pa or pb):
        for k in sorted(set(pa or {}) | set(pb or {})):
            va, vb = (pa or {}).get(k), (pb or {}).get(k)
            if va != vb:
                lines.append(f"  prefix.{k}: A={_fmt(va)} B={_fmt(vb)}")
    return lines


def _diff_fleet(a: dict, b: dict) -> list[str]:
    lines: list[str] = []
    for key, label in (("members", "members"), ("handoffs", "handoffs"),
                       ("pending", "pending"),
                       ("redispatch", "redispatch queue"),
                       ("fence_crc", "fence chain")):
        if a.get(key) != b.get(key):
            lines.append(f"  {label}: A={_fmt(a.get(key))} "
                         f"B={_fmt(b.get(key))}")
    ra, rb = a.get("replicas") or {}, b.get("replicas") or {}
    for name in sorted(set(ra) | set(rb)):
        sub = _diff_sched(ra.get(name) or {}, rb.get(name) or {})
        if sub:
            lines.append(f"  replica {name}:")
            lines += ["  " + ln for ln in sub]
    return lines


def _rids_in(rec: dict) -> set[int]:
    rids: set[int] = set()
    for field in _CONTEXT_FIELDS:
        v = rec.get(field)
        if not v:
            continue
        if field == "prefill":
            rids.add(v[1])
        else:
            for entry in v:
                rids.add(entry[0] if isinstance(entry, list) else entry)
    return rids


def _find_record(records: list[dict], key) -> dict | None:
    stream, tick = key
    for rec in records:
        if rec.get("tick") != tick:
            continue
        if rec.get("event") == "fleet" and stream == "fleet":
            return rec
        if rec.get("event") == "tick" and rec.get("mode") == stream:
            return rec
    return None


def _context_lines(rec: dict | None, label: str) -> list[str]:
    if rec is None:
        return [f"  {label}: (no matching record)"]
    shown = {f: rec[f] for f in _CONTEXT_FIELDS if rec.get(f)}
    body = ", ".join(f"{k}={json.dumps(v)}" for k, v in shown.items()) \
        or "(no events)"
    return [f"  {label}: {body}"]


def diverge_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch diverge",
        description="Localize the first divergent tick between two "
                    "flight-recorder trails (identical-seed runs of a "
                    "determinism-gated storm) and diff the "
                    "reconstructed states into a human-readable delta.",
    )
    ap.add_argument("path_a", help="first run's metrics JSONL (full log)")
    ap.add_argument("path_b", help="second run's metrics JSONL (full log)")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    try:
        recs_a = _last_run(args.path_a)
        recs_b = _last_run(args.path_b)
        _, seq_a = _fold_collect(recs_a)
        _, seq_b = _fold_collect(recs_b)
    except ReplayError as e:
        # The one-line config-error contract (legacy/summary trails).
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (OSError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    div_idx = None
    why = None
    for i in range(min(len(seq_a), len(seq_b))):
        (key_a, stamped_a, _rc_a, err_a) = seq_a[i]
        (key_b, stamped_b, _rc_b, err_b) = seq_b[i]
        if key_a != key_b:
            div_idx, why = i, (f"stream structure differs: A has "
                               f"{key_a}, B has {key_b}")
            break
        if err_a or err_b:
            div_idx = i
            why = "; ".join(filter(None, [
                err_a and f"A drifts from its own stamps: {err_a}",
                err_b and f"B drifts from its own stamps: {err_b}"]))
            break
        if stamped_a != stamped_b:
            div_idx, why = i, (f"stamped state_crc differs: "
                               f"A={stamped_a} B={stamped_b}")
            break
    truncated = False
    if div_idx is None and len(seq_a) != len(seq_b):
        truncated = True
        why = (f"trail lengths differ: A has {len(seq_a)} digest(s), "
               f"B has {len(seq_b)} — one trail ends early")
        div_idx = max(min(len(seq_a), len(seq_b)) - 1, 0)
    if div_idx is None:
        if args.format == "json":
            print(json.dumps({"divergence": None,
                              "digests_compared": len(seq_a)}))
        else:
            print(f"no divergence: {len(seq_a)} per-tick digests "
                  "identical across both trails")
        return 0

    key = seq_a[div_idx][0] if div_idx < len(seq_a) else seq_b[div_idx][0]
    stream, tick = key
    snap_a = _state_at(recs_a, key)
    snap_b = _state_at(recs_b, key)
    rec_a = _find_record(recs_a, key)
    rec_b = _find_record(recs_b, key)
    rids = sorted(_rids_in(rec_a or {}) | _rids_in(rec_b or {}))
    delta: list[str] = []
    if snap_a.get("fleet") is not None or snap_b.get("fleet") is not None:
        # The fleet diff covers every replica mirror (the divergent
        # stream's included), plus membership/handoffs/fences.
        delta += _diff_fleet(snap_a.get("fleet") or {},
                             snap_b.get("fleet") or {})
    else:
        mirror_a = _mirror_of(snap_a, stream)
        mirror_b = _mirror_of(snap_b, stream)
        if mirror_a is not None or mirror_b is not None:
            delta += _diff_sched(mirror_a or {}, mirror_b or {})
    if args.format == "json":
        print(json.dumps({
            "divergence": {"stream": stream, "tick": tick,
                           "index": div_idx, "why": why, "rids": rids},
            "delta": delta,
            "state_a": snap_a, "state_b": snap_b,
        }))
        return 1
    print(f"## Diverge — {args.path_a} vs {args.path_b}\n")
    print(f"first divergence: tick {tick}, stream {stream} "
          f"(digest #{div_idx} of the lockstep fold)")
    print(f"cause: {why}")
    if rids:
        print(f"rids touched at the divergent tick: {rids}")
    print("\nevents at the divergent tick:")
    for line in _context_lines(rec_a, "A") + _context_lines(rec_b, "B"):
        print(line)
    print("\nstate delta after the divergent tick (A vs B):")
    if not delta:
        delta = (["  (states identical at the last common digest — one "
                  "trail simply ends here)"] if truncated else
                 ["  (reconstructed states identical — the divergence "
                  "is in the stamps alone)"])
    for line in delta:
        print(line)
    return 1


if __name__ == "__main__":
    sys.exit(diverge_main())
