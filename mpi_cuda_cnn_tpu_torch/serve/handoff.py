"""Page-granular KV handoff between a prefill and a decode replica (a copy
of the JAX package's `serve/handoff.py`).

A disaggregated fleet splits its replicas by phase: prefill replicas run
chunked prompts, decode replicas stream tokens. A completed prefill's
page set then moves from the sender's PagePool to a decode replica's,
and a crash of either end mid-transfer must still leave every request
served exactly once. This module holds the host-side half of that
protocol: the `Handoff` record serve/fleet.py drives through its states,
the per-page content CRCs stamped at seal time and checked at adoption,
and the committed-context CRC a failover resume checks. The states:

    pending  — pages sealed on the sender (slot detached, private pages
               owned by the handoff token, prefix reader references
               moved to it), per-page CRCs stamped, the rid's fence
               revoked; waiting for a decode replica with room.
    copying  — receiver chosen, destination pages allocated under the
               handoff token in its pool; the transfer is in flight for
               `ticks_left` fleet ticks (the mid-handoff crash window).
    done     — CRCs verified, content adopted (a cross-engine page copy
               under EngineCompute, accounting only under SimCompute),
               the request bound decode-ready into a receiver slot, a
               fresh fence epoch granted, the sender's pages released.
    aborted  — any failure (an end died, the transfer dropped, a CRC
               refused, a cancel): both ends' pages are released on the
               incarnations that still live, and the request re-enters
               the fleet's re-dispatch queue exactly once.

A page's KV rows are a pure function of the token ids whose positions it
covers, so its integrity stamp is the crc32 of that token slice, which
both ends compute on the host with no device sync. `kv_corrupt` faults
flip a stamp; adoption then refuses the page set and the request
re-prefills instead of decoding garbage.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

__all__ = [
    "Handoff", "context_crc", "context_tokens", "handoff_owner",
    "page_crcs", "parse_pools", "verify_page_crcs",
]

POOL_PHASES = ("prefill", "decode")


def parse_pools(spec: str) -> dict[str, int]:
    """The --pools grammar: 'prefill:2,decode:2' -> {"prefill": 2,
    "decode": 2}. Both phases must appear with at least one replica
    each — a pool declared empty is a config error, not a degradation
    (degradation is for pools that EMPTY at runtime)."""
    out: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            phase, n = part.split(":")
            phase = phase.strip()
            n = int(n)
        except ValueError as e:
            raise ValueError(
                f"--pools entry {part!r}: want phase:int "
                "(e.g. 'prefill:2,decode:2')"
            ) from e
        if phase not in POOL_PHASES:
            raise ValueError(
                f"--pools phase {phase!r}: want one of {POOL_PHASES}"
            )
        if phase in out:
            raise ValueError(f"--pools phase {phase!r} given twice")
        if n < 1:
            raise ValueError(f"--pools {part!r}: need at least 1 replica")
        out[phase] = n
    missing = [p for p in POOL_PHASES if p not in out]
    if missing:
        raise ValueError(
            f"--pools must name every phase; missing {', '.join(missing)}"
        )
    return out


def handoff_owner(rid: int, hid: int) -> tuple:
    """The PagePool ownership token one handoff's sealed/destination
    pages live under — unique per (request, handoff attempt), so an
    aborted attempt's release can never touch a later attempt's pages."""
    return ("handoff", rid, hid)


def context_tokens(prompt: np.ndarray, out: list[int]) -> np.ndarray:
    return np.concatenate(
        [np.asarray(prompt, np.int32).reshape(-1),
         np.asarray(out, np.int32).reshape(-1)]
    )


def page_crcs(tokens: np.ndarray, cached: int, page_size: int) -> list[int]:
    """Per-page integrity stamps: crc32 over the int32 token ids whose
    KV rows each page holds (rows 0..cached-1; the last emitted token
    is NOT yet written — it rides in the request record and lands in
    the cache on the receiver's first decode tick)."""
    toks = np.asarray(tokens, np.int32).reshape(-1)[:cached]
    return [
        zlib.crc32(toks[i * page_size:(i + 1) * page_size].tobytes())
        for i in range(-(-cached // page_size))
    ]


def verify_page_crcs(stamped: list[int], tokens: np.ndarray, cached: int,
                     page_size: int) -> bool:
    """The receiver's adoption check: recompute the expected stamps
    from the authoritative token stream and compare. Any mismatch —
    count, order, or content — refuses the whole page set."""
    return list(stamped) == page_crcs(tokens, cached, page_size)


def context_crc(prompt: np.ndarray, out: list[int]) -> int:
    """Integrity stamp over a request's committed context (prompt +
    emitted tokens) — stamped when a failover strands the request and
    verified before a resume re-dispatch re-prefills it (the backfill
    of the path that used to re-adopt committed tokens unchecked). A
    mismatch falls back to discard semantics: the committed tokens are
    dropped and regenerated from the prompt, never decoded as-is."""
    return zlib.crc32(context_tokens(prompt, out).tobytes())


@dataclasses.dataclass
class Handoff:
    """One in-flight prefill->decode KV transfer (module doc). The
    fleet owns the state transitions; everything here is data plus the
    two incarnation references the abort path needs to release the
    right pools (a crashed incarnation's pool dies with it — releasing
    into a restarted namesake's pool would corrupt a stranger)."""

    hid: int
    rid: int
    src: str                 # sender replica name
    src_rep: object          # sender Replica INCARNATION
    pages: list              # full ordered block table (content source)
    private: list            # sender pages owned by the handoff token
    nodes: list              # sender prefix nodes (reader refs held)
    cached: int              # KV rows sealed — the receiver's decode start
    crcs: list               # per-page integrity stamps (seal-time)
    owner: tuple             # PagePool ownership token (handoff_owner)
    state: str = "pending"   # pending -> copying -> done | aborted
    dst: str | None = None
    dst_rep: object = None
    dst_pages: list = dataclasses.field(default_factory=list)
    ticks_left: int = 0
    copied: bool = False     # content adopted (bind may still be waiting)
    drop: bool = False       # a handoff_drop fault claimed this transfer
    cancelled: bool = False  # a client cancel landed mid-handoff
