"""Iteration-level serving schedulers (Orca, Yu et al., OSDI '22).

A copy of the JAX package's `serve/scheduler.py`, host-side and free of
tensors, so that both engines take the same decisions bit for bit: FCFS
admission bounded by free pages, one prefill chunk per iteration for
the earliest-admitted prefilling slot, recompute preemption of the
latest-admitted slot when decode growth finds the pool dry, deadlines,
cancellation, a bounded admission queue, and the livelock guard that
fails a request whose context can never fit. Static batching admits a
batch only when every slot is free, reserves each request's worst-case
extent up front, and drains the batch as one.

Also here: the acceptance-aware page growth of a speculative round and
the rollback of pages that hold only rejected draft rows (`spec_width`,
`commit_spec`), and the SLO-aware scheduler (`SLOScheduler`: priority
classes, per-tenant quotas, burn-driven admission and preemption), and
the fleet's cross-pool handoff (`detach_for_handoff`, `release_handoff`,
`bind_transfer`).
"""

from __future__ import annotations

import dataclasses
import zlib
from array import array as _pack
from collections import deque
from collections.abc import Iterable

import numpy as np

from .pool import PagePool, pages_for
from .prefix_cache import PrefixCache


# -- per-tick state digests ----------------------------------------
#
# Every engine iteration digests its host-side serving state into a
# crc32 and chains it into the run's `state_crc`. The layout below is
# the JAX package's byte for byte, so the two engines' chains are equal
# exactly when their schedules are.

def _rid_sig(rid: int) -> int:
    """Order-insensitive per-rid mixer for the queue-membership
    signature (Knuth multiplicative hash; xor-combined so the
    scheduler maintains it in O(1) per queue mutation)."""
    return (rid * 2654435761 ^ 0x9E3779B9) & 0xFFFFFFFF


def state_digest(queue_len: int, queue_head: int, queue_tail: int,
                 queue_sig: int, slots_flat, free_pages: int,
                 prefix=None, extra=(0, 0)) -> int:
    """THE canonical state digest (crc32), shared by every producer and
    the replayer. `slots_flat` is the FLAT int sequence of
    per-occupied-slot sextets (idx, rid, cached, target, block-table
    pages, shared refs) in idx order — page OWNERSHIP as counts
    (physical indices are an engine layout detail; the logical state
    is what replays). The queue is projected to (length, head rid,
    tail rid, membership signature): exact membership and the
    FCFS-relevant order anchors in O(1) per tick — a mid-queue
    permutation alone is not captured, but any such divergence changes
    the very next admission and lands in `slots_flat` one tick later.
    `prefix` is the prefix-tree stat tuple (or None — a sharing-off
    run; length-framed so the two can never alias), `extra` static
    config (spec on/width). Serialized as a packed int64 array, not
    repr: this runs once per replica per tick of a 10^5 storm, and the
    byte layout is part of the digest contract."""
    parts = [queue_len, queue_head, queue_tail, queue_sig, free_pages,
             len(slots_flat)]
    parts.extend(slots_flat)
    if prefix is None:
        parts.append(-1)
    else:
        parts.append(len(prefix))
        parts.extend(prefix)
    parts.extend(extra)
    return zlib.crc32(_pack("q", parts).tobytes())


def scheduler_digest(sched, extra=(0, 0)) -> int:
    """Producer-side binding of state_digest over a live scheduler:
    queue order anchors + per-slot extents/pages/refs + pool free count
    + prefix-tree stats. O(slots) per call — the storm-scale budget
    (the queue signature is maintained incrementally by the mutation
    helpers below, never recomputed by scan)."""
    q = sched.queue
    flat: list[int] = []
    ext = flat.extend
    for s in sched.slots:
        r = s.req
        if r is not None:
            ext((s.idx, r.rid, s.cached, s.target, len(s.pages),
                 len(s.refs)))
    prefix = None
    pc = sched.prefix
    if pc is not None:
        # ONE spelling (PrefixCache.digest_tuple), length-framed by
        # state_digest.
        prefix = pc.digest_tuple()
    return state_digest(len(q), q[0].rid if q else -1,
                        q[-1].rid if q else -1, sched.queue_sig, flat,
                        sched.pool.free_pages, prefix, extra)


def validate_request(r: Request, *, max_len: int, page_size: int,
                     usable: int) -> None:
    """THE structural-admissibility check, shared by scheduler submit
    and the fleet's up-front workload validation (one spelling, so the
    fleet can never accept a request a replica's submit would then
    raise on mid-run):

    - prompt + max_new_tokens past max_len (block table can't hold it)
    - a prompt alone needing more pages than the pool owns (it could
      never be admitted, let alone decode)
    """
    if r.prompt.size + r.max_new_tokens > max_len:
        raise ValueError(
            f"request {r.rid}: prompt {r.prompt.size} + "
            f"{r.max_new_tokens} new exceeds max_len {max_len}"
        )
    if pages_for(r.prompt.size + 1, page_size) > usable:
        raise ValueError(
            f"request {r.rid}: prompt of {r.prompt.size} tokens "
            f"needs {pages_for(r.prompt.size + 1, page_size)} "
            f"pages but the pool owns {usable} — it can "
            "never be admitted (size the pool or shrink the prompt)"
        )

# A request leaves the system in exactly one of these states.
TERMINAL_STATUSES = ("finished", "expired", "cancelled", "rejected", "failed")


def terminal_fields(r: Request) -> dict:
    """One terminal request as the compact per-tick `terminal` entry:
    what the streaming SLO/alert layer folds good/bad events
    from, emitted INSIDE the run (the end-of-run `request` records are
    too late for a burn-rate alert to be actionable). Latency formulas
    match engine.request_record exactly — the two views of one request
    can never disagree. jax-free on purpose: the fleet's sim path and
    the alert engine consume this without importing the engine."""
    return {
        "id": r.rid,
        "tenant": r.tenant or "default",
        "status": r.status,
        "ttft_ms": (None if r.first_token_at is None
                    else round(1e3 * (r.first_token_at - r.arrival), 3)),
        "tpot_ms": (None if r.status != "finished"
                    else round(1e3 * (r.finished_at - r.first_token_at)
                               / max(len(r.out) - 1, 1), 3)),
        "queue_wait_ms": (None if r.admitted_at is None
                          else round(1e3 * (r.admitted_at - r.arrival), 3)),
    }


def tenant_block(requests: Iterable[Request]) -> dict[str, dict]:
    """Per-tenant status/latency counts for a run summary,
    shared by ServeResult.summary and FleetResult.summary so the two
    surfaces flatten identically in `mctpu compare`. Untagged requests
    aggregate under "default". Percentiles follow the one serving
    convention (obs.metrics.pct_nearest — jax-free, so this module's
    fleet sim path stays jax-free; `mctpu lint` MCT001 pins it)."""
    from ..obs.metrics import pct_nearest

    by_tenant: dict[str, list[Request]] = {}
    for r in requests:
        by_tenant.setdefault(r.tenant or "default", []).append(r)
    out: dict[str, dict] = {}
    for tenant, rs in sorted(by_tenant.items()):
        statuses: dict[str, int] = {}
        for r in rs:
            statuses[r.status] = statuses.get(r.status, 0) + 1
        fin = [r for r in rs if r.status == "finished"]
        ttft = [1e3 * (r.first_token_at - r.arrival) for r in fin]
        tpot = [1e3 * (r.finished_at - r.first_token_at)
                / max(len(r.out) - 1, 1) for r in fin]
        out[tenant] = {
            "requests": len(rs),
            "statuses": statuses,
            "output_tokens": sum(len(r.out) for r in rs),
            "ttft_p50_ms": pct_nearest(ttft, 50),
            "ttft_p99_ms": pct_nearest(ttft, 99),
            "tpot_p50_ms": pct_nearest(tpot, 50),
            "tpot_p99_ms": pct_nearest(tpot, 99),
        }
    return out


@dataclasses.dataclass
class Request:
    """One serving request plus its runtime bookkeeping. `prompt` is a
    1-D int32 array; `out` accumulates emitted tokens (they survive
    preemption — recompute re-prefills prompt + out). `deadline` is an
    absolute time on the engine's clock (same timeline as `arrival`);
    past it the request is dropped/aborted with status "expired".
    `cancel()` requests client-side abort at the next tick boundary.
    `session` is an opaque affinity key: the fleet router's
    session-affinity policy keeps one session's requests on one replica
    so its prefix cache stays hot; None means no affinity. `tenant` is
    the traffic-class identity: the SLO accounting layer
    buckets good/bad events, latency histograms, and health verdicts by
    it; None renders as "default" in every record and table — a
    single-tenant run needs no tagging. `priority` is the
    request's priority class for the SLO-aware scheduler: higher is
    more protected (admitted first, preempted last); the FCFS
    schedulers ignore it."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    deadline: float | None = None
    session: int | str | None = None
    tenant: str | None = None
    priority: int = 0
    out: list[int] = dataclasses.field(default_factory=list)
    status: str = "queued"
    fail_reason: str | None = None
    cancel_requested: bool = False
    admitted_at: float | None = None
    first_token_at: float | None = None
    finished_at: float | None = None
    preemptions: int = 0
    # Queue-wait seconds spent quota-blocked under SLOScheduler
    #: the skip-over share of queue_wait, so the split
    # registry metric can tell policy waits from capacity waits.
    quota_wait_s: float = 0.0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.prompt.size < 1:
            raise ValueError(f"request {self.rid}: empty prompt")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.rid}: max_new_tokens < 1")

    @property
    def context_len(self) -> int:
        return self.prompt.size + len(self.out)

    @property
    def done(self) -> bool:
        return len(self.out) >= self.max_new_tokens

    @property
    def terminal(self) -> bool:
        return self.status in TERMINAL_STATUSES

    def cancel(self) -> None:
        """Client cancellation: the scheduler aborts the request at the
        next sweep (queued: dropped; in-flight: slot + pages released)."""
        self.cancel_requested = True

    def expired_by(self, now: float) -> bool:
        return self.deadline is not None and now >= self.deadline


@dataclasses.dataclass
class Slot:
    """One fixed batch row of the engine. `cached` counts cache rows
    written; while cached < target the slot is prefilling (target =
    the request's context length at admission), after that it decodes —
    the current token (last emitted, not yet cached) goes in at row
    `cached` on the next tick.

    Prefix sharing: `pages` stays THE ordered block-table
    source; `refs` is the subset of those pages that are shared
    read-only prefix pages this slot holds reader references on
    (`prefix_nodes` the matching tree nodes), and a prefix hit binds
    with cached = matched tokens so prefill covers only the suffix.
    `cow` is a pending (src, dst) copy-on-write: the engine copies the
    shared src page into the private dst page before the slot's first
    write (`cow_node` holds the transient source reference)."""

    idx: int
    req: Request | None = None
    pages: list[int] = dataclasses.field(default_factory=list)
    cached: int = 0
    target: int = 0
    admit_seq: int = -1
    refs: list[int] = dataclasses.field(default_factory=list)
    prefix_nodes: list = dataclasses.field(default_factory=list)
    cow: tuple[int, int] | None = None
    cow_node: object = None

    @property
    def free(self) -> bool:
        return self.req is None

    @property
    def prefilling(self) -> bool:
        return self.req is not None and self.cached < self.target

    @property
    def decoding(self) -> bool:
        return self.req is not None and self.cached >= self.target


class _SchedulerBase:
    def __init__(self, *, slots: int, pool: PagePool, page_size: int,
                 max_len: int, max_queue: int | None = None,
                 prefix: PrefixCache | None = None):
        if slots < 1:
            raise ValueError(f"need at least one slot, got {slots}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.slots = [Slot(i) for i in range(slots)]
        self.pool = pool
        self.page_size = page_size
        self.max_len = max_len
        self.max_queue = max_queue
        self.prefix = prefix
        self.queue: deque[Request] = deque()
        # Incremental queue-membership signature: xor of
        # _rid_sig over queued rids, maintained by the _q_* helpers at
        # every mutation site so the per-tick state digest stays O(slots)
        # even when a storm's backlog holds tens of thousands of rids.
        self.queue_sig = 0
        self.finished: list[Request] = []
        # Terminal non-finished requests (expired/cancelled/rejected/
        # failed) — with `finished`, every submitted request lands in
        # exactly one of the two lists.
        self.dropped: list[Request] = []
        self.preemptions = 0
        # (victim rid, beneficiary rid | None) pairs preempted since the
        # last drain_preempted() — the engine folds them into the tick
        # record it emits for the timeline, and the beneficiary is the
        # causal edge `mctpu explain` blames the wait on.
        self.preempted_log: list[tuple[int, int | None]] = []
        # (blocked rid, reason, holder rids) admission attempts that
        # failed since the last drain_blocked(): reason is
        # "pages" / "slots" / "quota", holders the rids occupying the
        # resource the candidate waited on — the blocker edges of the
        # causal DAG. Appended only for candidates actually TRIED this
        # tick (the head under FCFS; every skipped candidate under the
        # SLO scheduler, whose quota skip-overs are their own edge kind).
        self.blocked_log: list[tuple[int, str, list[int]]] = []
        self._admit_seq = 0
        # True once any submitted request carried a deadline: lets a
        # caller (the fleet's per-replica step loop) skip the O(queue)
        # sweep() scan on ticks where nothing can possibly expire.
        self.has_deadlines = False

    def submit(self, requests: Iterable[Request]) -> None:
        """Enqueue requests (FCFS by arrival). Structurally impossible
        requests raise ValueError at submission — a clear error beats a
        request that can only ever preempt-loop:

        - prompt + max_new_tokens past max_len (block table can't hold it)
        - a prompt alone needing more pages than the pool owns (it could
          never be admitted, let alone decode)
        """
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        for r in reqs:
            validate_request(r, max_len=self.max_len,
                             page_size=self.page_size,
                             usable=self.pool.usable)
            if r.deadline is not None:
                self.has_deadlines = True
            self._q_append(r)

    @property
    def unfinished(self) -> int:
        return len(self.queue) + sum(not s.free for s in self.slots)

    def next_arrival(self) -> float | None:
        return min((r.arrival for r in self.queue), default=None)

    # The queue mutation helpers every site below goes through, so the
    # digest signature can never drift from the deque.
    def _q_append(self, r: Request) -> None:
        self.queue.append(r)
        self.queue_sig ^= _rid_sig(r.rid)

    def _q_appendleft(self, r: Request) -> None:
        self.queue.appendleft(r)
        self.queue_sig ^= _rid_sig(r.rid)

    def _q_popleft(self) -> Request:
        r = self.queue.popleft()
        self.queue_sig ^= _rid_sig(r.rid)
        return r

    def _q_rebuild(self, kept: deque[Request]) -> None:
        """Wholesale queue replacement (sweep / queue bound / SLO admit
        — sites that already paid an O(queue) scan)."""
        self.queue = kept
        sig = 0
        for r in kept:
            sig ^= _rid_sig(r.rid)
        self.queue_sig = sig

    def drain_preempted(self) -> list[tuple[int, int | None]]:
        """(victim, beneficiary) pairs preempted since the last call
        (tick-record bookkeeping; beneficiary None when the eviction
        had no single requesting slot)."""
        out, self.preempted_log = self.preempted_log, []
        return out

    def drain_blocked(self) -> list[tuple[int, str, list[int]]]:
        """(rid, reason, holders) admission blocks since the last call
        — the tick record's `blocked` field."""
        out, self.blocked_log = self.blocked_log, []
        return out

    def _occupants(self, tenant: str | None = None) -> list[int]:
        """rids currently holding slots (and therefore pages), sorted —
        the holder set a blocked admission queued behind. With `tenant`,
        only that tenant's occupants (the quota-block holder set)."""
        return sorted(
            s.req.rid for s in self.slots
            if not s.free
            and (tenant is None or (s.req.tenant or "default") == tenant)
        )

    def _note_blocked(self, req: Request, reason: str,
                      holders: list[int]) -> None:
        self.blocked_log.append((req.rid, reason, holders))

    def prefill_backlog(self) -> int:
        """Prompt tokens admitted but not yet cached — the chunked-
        prefill backlog gauge (how far admissions are ahead of the
        prefill interleave)."""
        return sum(s.target - s.cached for s in self.slots
                   if s.prefilling and not s.req.terminal)

    def prefill_slot(self) -> Slot | None:
        """The earliest-admitted slot still prefilling (FCFS: one
        sequence's prompt finishes before the next's starts, so TTFT
        ordering follows admission ordering). Aborted requests whose
        slot is still held (static's reserve-until-drain) never
        prefill."""
        cands = [s for s in self.slots
                 if s.prefilling and not s.req.terminal]
        return min(cands, key=lambda s: s.admit_seq, default=None)

    def decode_slots(self) -> list[Slot]:
        return [s for s in self.slots if s.decoding]

    def _bind(self, slot: Slot, req: Request, pages: list[int],
              now: float, acq=None) -> None:
        slot.req = req
        slot.pages = pages
        slot.cached = 0
        slot.target = req.context_len
        slot.refs = []
        slot.prefix_nodes = []
        slot.cow = None
        slot.cow_node = None
        if acq is not None:
            # Prefix hit: shared pages lead the block table,
            # cached starts at the matched depth — prefill covers only
            # the suffix. A partial match copies-on-write into the
            # slot's FIRST private page (the engine performs the device
            # copy before the slot's first write). Stats count HERE
            # (admission), not at acquire: a page-blocked head retried
            # every tick must leave no phantom hit counts.
            self.prefix.note_admitted(acq, req.rid)
            if acq.matched > 0:
                slot.pages = [n.page for n in acq.nodes] + pages
                slot.refs = [n.page for n in acq.nodes]
                slot.prefix_nodes = list(acq.nodes)
                slot.cached = acq.matched
                if acq.cow is not None:
                    slot.cow = (acq.cow.page, pages[0])
                    slot.cow_node = acq.cow
        slot.admit_seq = self._admit_seq
        self._admit_seq += 1
        req.status = "running"
        if req.admitted_at is None:
            req.admitted_at = now

    def _release(self, slot: Slot) -> None:
        rid = slot.req.rid
        if slot.cow_node is not None:
            # Released before the first write: the pending copy never
            # happened; just return the transient source reference.
            self.prefix.cow_abandon(slot.cow_node, rid)
            slot.cow = None
            slot.cow_node = None
        if slot.prefix_nodes:
            self.prefix.release(slot.prefix_nodes, rid)
        refset = set(slot.refs)
        private = [p for p in slot.pages if p not in refset]
        if private:
            self.pool.free(private, rid)
        slot.req = None
        slot.pages = []
        slot.refs = []
        slot.prefix_nodes = []
        slot.cached = 0
        slot.target = 0
        slot.admit_seq = -1

    def cow_complete(self, slot: Slot) -> None:
        """The engine copied slot.cow's src page into its private dst:
        release the transient source reference (the copy is counted by
        the prefix cache)."""
        self.prefix.cow_done(slot.cow_node, slot.req.rid)
        slot.cow = None
        slot.cow_node = None

    def note_prefill_complete(self, slot: Slot) -> None:
        """Prefill just reached target: adopt the slot's full prompt
        pages into the prefix tree so later same-prefix
        requests hit. No-op without a prefix cache."""
        if self.prefix is not None and slot.req is not None:
            self.prefix.insert(slot.req.prompt, slot)

    def detach_for_handoff(self, slot: Slot, owner) -> tuple:
        """Seal a completed prefill's page set for a cross-pool KV
        handoff: the slot's private pages pass to the handoff token, its
        prefix reader references move to the same token (so LRU reclaim
        cannot evict a shared page mid-transfer), and the slot is
        cleared without freeing anything: the pages stay resident until
        the transfer completes or aborts. Returns (ordered block-table
        pages, private pages, prefix nodes)."""
        req = slot.req
        assert slot.cow is None and slot.cow_node is None, (
            "detach with a pending COW — prefill cannot have completed"
        )
        assert slot.cached >= slot.target, "detach of a prefilling slot"
        pages = list(slot.pages)
        refset = set(slot.refs)
        private = [p for p in pages if p not in refset]
        for p in private:
            self.pool.adopt(p, req.rid, owner)
        nodes = list(slot.prefix_nodes)
        for node in nodes:
            self.pool.unshare(node.page, req.rid)
            self.pool.share(node.page, owner)
        slot.req = None
        slot.pages = []
        slot.refs = []
        slot.prefix_nodes = []
        slot.cached = 0
        slot.target = 0
        slot.admit_seq = -1
        return pages, private, nodes

    def release_handoff(self, private: list[int], nodes: list,
                        owner) -> None:
        """Return a handoff's sealed sender-side resources (transfer done
        or aborted, sender incarnation still live): private pages freed
        through the ownership check, prefix reader references returned so
        the tree pages become reclaimable."""
        if nodes:
            self.prefix.release(nodes, owner)
        if private:
            self.pool.free(private, owner)

    def transfer_quota_ok(self, req: Request) -> bool:
        """Whether this scheduler's admission policy takes a handed-off
        request now. The FCFS schedulers always do; the SLOScheduler
        holds it to the tenant's slot quota."""
        return True

    def bind_transfer(self, req: Request, pages: list[int], cached: int,
                      owner, now: float) -> Slot | None:
        """Bind a completed cross-pool handoff into a free slot: the
        pages (allocated under the handoff token at transfer start,
        content already adopted) become the request's private block
        table, and the slot starts decode-ready (cached = target = the
        sealed extent; the next decode tick writes the in-flight token at
        row `cached`). Returns None, changing nothing, when no slot is
        free or the quota refuses: the handoff waits."""
        slot = next((s for s in self.slots if s.free), None)
        if slot is None or not self.transfer_quota_ok(req):
            return None
        for p in pages:
            self.pool.adopt(p, owner, req.rid)
        self._bind(slot, req, list(pages), now)
        slot.cached = cached
        slot.target = cached
        return slot

    def check(self) -> None:
        """Pool invariant + the slot-level sharing invariants: every
        shared page a slot references sits strictly below its written
        extent (no writable-shared page from the block table's point
        of view), and any pending COW destination is private."""
        self.pool.check()
        ps = self.page_size
        for s in self.slots:
            if s.free:
                assert not s.refs and s.cow is None
                continue
            refset = set(s.refs)
            assert len(refset) == len(s.refs), "duplicate slot ref"
            for i, p in enumerate(s.pages):
                if p in refset:
                    assert self.pool.is_shared(p), (
                        f"slot ref page {p} is not a shared pool page"
                    )
                    assert (i + 1) * ps <= s.cached, (
                        f"shared page {p} extends into slot {s.idx}'s "
                        "writable region"
                    )
            if s.cow is not None:
                assert s.cow[1] in s.pages and s.cow[1] not in refset, (
                    "COW destination is not a private slot page"
                )

    def _on_terminal(self, req: Request, now: float) -> None:
        """Hook: a request just reached a terminal status (finished or
        dropped). The SLO-aware scheduler folds it into its live
        per-tenant accountant; the FCFS schedulers do nothing."""

    def finish(self, slot: Slot, now: float) -> None:
        slot.req.status = "finished"
        slot.req.finished_at = now
        self.finished.append(slot.req)
        self._on_terminal(slot.req, now)
        self._release(slot)

    def _drop(self, req: Request, status: str, now: float,
              reason: str | None = None) -> Request:
        req.status = status
        req.fail_reason = reason
        req.finished_at = now
        self.dropped.append(req)
        self._on_terminal(req, now)
        return req

    # Whether sweep() releases an in-flight aborted request's slot and
    # pages immediately (continuous) or holds the reservation until the
    # batch drains (static — the reserve-until-drain discipline; the
    # aborted row just stops decoding).
    release_on_abort = True

    def sweep(self, now: float) -> list[Request]:
        """Abort expired and cancelled requests, queued AND in-flight.

        Queued ones are dropped before ever holding a page; in-flight
        ones have their slot aborted and (under continuous batching)
        their pages ownership-checked back into the pool. Returns the
        requests dropped by THIS call, for event logging."""
        dropped = []
        kept: deque[Request] = deque()
        for r in self.queue:
            if r.cancel_requested:
                dropped.append(self._drop(r, "cancelled", now))
            elif r.expired_by(now):
                dropped.append(self._drop(r, "expired", now, "deadline"))
            else:
                kept.append(r)
        self._q_rebuild(kept)
        for slot in self.slots:
            if slot.free or slot.req.terminal:
                continue  # terminal slot awaiting static drain
            r = slot.req
            status = ("cancelled" if r.cancel_requested
                      else "expired" if r.expired_by(now) else None)
            if status is None:
                continue
            dropped.append(self._drop(r, status, now,
                                      None if status == "cancelled"
                                      else "deadline"))
            if self.release_on_abort:
                self._release(slot)
        return dropped

    def enforce_queue_bound(self, now: float) -> list[Request]:
        """Backpressure: keep at most max_queue ARRIVED requests waiting;
        later arrivals beyond the bound are rejected with a terminal
        status (explicit rejection instead of unbounded queue memory).
        Returns the requests rejected by this call.

        Only NEVER-ADMITTED requests count toward (and can be evicted
        by) the bound: a preempted request back in the queue is not an
        arrival — rejecting it would silently drop work the engine
        already served tokens for."""
        if self.max_queue is None:
            return []
        arrived = [r for r in self.queue
                   if r.arrival <= now and r.admitted_at is None]
        excess = len(arrived) - self.max_queue
        if excess <= 0:
            return []
        victims = set(id(r) for r in arrived[-excess:])
        rejected = []
        kept: deque[Request] = deque()
        for r in self.queue:
            if id(r) in victims:
                rejected.append(self._drop(r, "rejected", now, "queue full"))
            else:
                kept.append(r)
        self._q_rebuild(kept)
        return rejected


class ContinuousScheduler(_SchedulerBase):
    """FCFS iteration-level scheduling with recompute preemption."""

    _ACQUIRE = object()  # sentinel: _admit_one acquires for itself

    def _admit_one(self, slot: Slot, req: Request, now: float,
                   acq=_ACQUIRE) -> bool:
        """Try to bind `req` into `slot`: prefix-match, cover the remaining extent + one decode row from the
        pool (reclaiming LRU-retained prefix pages before giving up),
        bind. Returns False (and leaves no trace) when the pool cannot
        cover the request. A caller that already acquired (the SLO
        scheduler's quota check needs the match depth first) passes
        its acquisition in; on failure it is released either way."""
        if acq is ContinuousScheduler._ACQUIRE:
            acq = None
            if self.prefix is not None:
                acq = self.prefix.acquire(req.prompt, req.rid,
                                          max_tokens=req.context_len - 1)
        f = len(acq.nodes) if acq is not None else 0
        need = pages_for(req.context_len + 1, self.page_size) - f
        if need > self.pool.free_pages and self.prefix is not None:
            self.prefix.reclaim(need - self.pool.free_pages)
        if need > self.pool.free_pages:
            if acq is not None:
                self._release_acq(acq, req.rid)
            return False
        pages = self.pool.try_alloc(
            pages_for(req.context_len, self.page_size) - f, req.rid
        )
        assert pages is not None
        self._bind(slot, req, pages, now, acq=acq)
        return True

    def _release_acq(self, acq, rid) -> None:
        """Undo an acquisition whose admission did not go through."""
        if acq.cow is not None:
            self.prefix.cow_abandon(acq.cow, rid)
        self.prefix.release(acq.nodes, rid)

    def admit(self, now: float) -> list[Slot]:
        """Move arrived queue-head requests into free slots, bounded by
        free pages: a request is admitted only when the pool covers its
        whole prefill extent AND its first decode row (so an admission
        can never preempt an existing sequence on its very first decode
        token). Head-of-line FCFS: if the head doesn't fit, nothing
        behind it jumps ahead — except a head whose grown context can
        NEVER fit the pool (a preempted-and-requeued request that kept
        generating): that one is failed terminally, the livelock guard's
        admission half."""
        bound = []
        for slot in self.slots:
            if not slot.free or not self.queue:
                continue
            req = self.queue[0]
            if req.arrival > now:
                break
            need = pages_for(req.context_len + 1, self.page_size)
            if need > self.pool.usable:
                # Livelock guard: no sequence of preemptions can ever
                # free enough pages — requeueing forever would starve
                # the head-of-line forever. Terminal failure.
                self._q_popleft()
                self._drop(req, "failed", now,
                           f"context of {req.context_len} tokens needs "
                           f"{need} pages; pool owns {self.pool.usable}")
                continue
            if not self._admit_one(slot, req, now):
                # Page-blocked head: record whom it queued behind — the
                # occupants holding the pages whose release will unblock
                # it (the blocker edge).
                self._note_blocked(req, "pages", self._occupants())
                break
            self._q_popleft()
            bound.append(slot)
        if (self.queue and self.queue[0].arrival <= now
                and not any(s.free for s in self.slots)):
            # Slot-blocked head: every engine slot is occupied — the
            # head waits on a slot release, not on pages.
            self._note_blocked(self.queue[0], "slots", self._occupants())
        return bound

    def preempt(self, slot: Slot, for_rid: int | None = None) -> None:
        """Evict `slot`: free its pages, requeue its request at the
        HEAD (it keeps FCFS priority and its emitted tokens; the grown
        context recomputes via chunked prefill on readmission).
        `for_rid` names the beneficiary — the decoding request whose
        page need forced the eviction (the preempted-by causal edge)."""
        req = slot.req
        req.preemptions += 1
        self.preemptions += 1
        self.preempted_log.append((req.rid, for_rid))
        req.status = "queued"
        self._q_appendleft(req)
        self._release(slot)

    def _choose_victim(self, victims: list[Slot]) -> Slot:
        """FCFS preemption policy: evict the latest-admitted sequence.
        The SLO-aware scheduler overrides this with priority + burn-
        driven choice."""
        return max(victims, key=lambda s: s.admit_seq)

    def spec_width(self, slot: Slot, k: int) -> int:
        """How many candidate tokens this slot's speculative round may
        verify this tick: capped by k, by the tokens the request still
        owes, and by the rows the slot's pages cover (a dry pool narrows
        the round instead of preempting; width 1 is the spec-off tick).
        Always >= 1: the spec-off growth guaranteed the next row's
        page."""
        avail = len(slot.pages) * self.page_size - slot.cached
        remaining = slot.req.max_new_tokens - len(slot.req.out)
        return max(1, min(k, remaining, avail))

    def commit_spec(self, slot: Slot, j: int) -> None:
        """Commit a speculative round's j accepted tokens: advance the
        written extent, then roll back the pages that now hold only
        rejected draft rows (freed through the ownership check, so a
        rejected token's KV is never readable through any block table).
        Stale rejected rows inside the kept tail page are overwritten by
        the next round's writes before any row reads them."""
        slot.cached += j
        keep = pages_for(slot.cached, self.page_size)
        if len(slot.pages) > keep:
            surplus = slot.pages[keep:]
            del slot.pages[keep:]
            self.pool.free(surplus, slot.req.rid)

    def grow_for_decode(self, now: float = 0.0,
                        spec_k: int = 1) -> list[Slot]:
        """Give every decoding slot the page its next cache row needs,
        reclaiming LRU-retained prefix pages first, then preempting victim sequences
        while the pool is dry. Returns the decoding slots that
        survived, oldest-first (the engine's tick order). A slot that
        is dry and ALONE can never grow — no victim remains — so its
        request is failed terminally (the livelock guard's decode
        half) instead of raising: the engine keeps serving everything
        else.

        spec_k > 1: after the guaranteed next-row growth, each survivor
        is extended OPPORTUNISTICALLY toward the pages its verify block
        wants (k rows, capped at the request's remaining budget) by
        try_alloc and prefix reclaim only, never preemption; whatever the
        pool covers is what spec_width reports. So the preemption policy
        and the survivor set are those of a spec-off run.
        """
        survivors = []
        for slot in sorted(self.decode_slots(), key=lambda s: s.admit_seq):
            if slot.free or not slot.decoding:
                continue  # preempted by an earlier iteration below
            stalled = False
            while slot.pages and len(slot.pages) * self.page_size <= slot.cached:
                got = self.pool.try_alloc(1, slot.req.rid)
                if (got is None and self.prefix is not None
                        and self.prefix.reclaim(1)):
                    got = self.pool.try_alloc(1, slot.req.rid)
                if got is not None:
                    slot.pages.extend(got)
                    continue
                victims = [s for s in self.slots if not s.free]
                victim = self._choose_victim(victims)
                if victim is slot and len(victims) == 1:
                    req = slot.req
                    if pages_for(slot.cached + 1,
                                 self.page_size) > self.pool.usable:
                        # STRUCTURALLY impossible: even owning every
                        # usable page it could not hold the next row.
                        self._drop(
                            req, "failed", now,
                            f"context of {req.context_len} tokens cannot "
                            f"fit the pool ({self.pool.usable} usable "
                            f"pages of {self.page_size}) even alone",
                        )
                        self._release(slot)
                    else:
                        # Transiently dry (e.g. an injected squeeze or a
                        # concurrent prefill holds pages): sit out this
                        # tick — writing without the page would land in
                        # the scratch page and corrupt the read mask.
                        stalled = True
                    break
                self.preempt(victim, for_rid=slot.req.rid)
            if not stalled and not slot.free and slot.decoding:
                survivors.append(slot)
        if spec_k > 1:
            for slot in survivors:
                remaining = slot.req.max_new_tokens - len(slot.req.out)
                want = pages_for(slot.cached + min(spec_k, remaining),
                                 self.page_size)
                while len(slot.pages) < want:
                    got = self.pool.try_alloc(1, slot.req.rid)
                    if (got is None and self.prefix is not None
                            and self.prefix.reclaim(1)):
                        got = self.pool.try_alloc(1, slot.req.rid)
                    if got is None:
                        break  # speculate narrower, never preempt
                    slot.pages.extend(got)
        return survivors


class StaticScheduler(_SchedulerBase):
    """Classic static batching over the same paged storage: admit a
    batch only when ALL slots are free, reserve each request's
    worst-case page extent up front (the contiguous cache's reservation
    discipline, expressed in pages — what makes the tick/latency
    comparison against ContinuousScheduler apples-to-apples), never
    preempt, and hold every slot until the whole batch drains. Aborted
    (expired/cancelled) in-flight rows keep their reservation until the
    drain — they only stop decoding."""

    release_on_abort = False

    def admit(self, now: float) -> list[Slot]:
        if any(not s.free for s in self.slots):
            if self.queue and self.queue[0].arrival <= now:
                # The in-flight batch holds every slot until it drains:
                # the arrived head queues behind ALL of it.
                self._note_blocked(self.queue[0], "slots",
                                   self._occupants())
            return []
        bound = []
        for slot in self.slots:
            if not self.queue or self.queue[0].arrival > now:
                break
            req = self.queue[0]
            # Worst-case rows: full context less the final emitted
            # token (which is never written back).
            need = pages_for(req.context_len + req.max_new_tokens - 1,
                             self.page_size)
            if need > self.pool.usable:
                # Even an empty pool could never reserve it: terminal
                # failure (static's livelock-guard analog).
                self._q_popleft()
                self._drop(req, "failed", now,
                           f"worst-case extent of {need} pages exceeds "
                           f"the pool's {self.pool.usable}")
                continue
            pages = self.pool.try_alloc(need, req.rid)
            if pages is None:
                # Reservation-blocked behind the rows already bound into
                # THIS batch (static reserves worst case up front); an
                # empty holder list means no request holds the pages —
                # an injected squeeze does.
                self._note_blocked(req, "pages", self._occupants())
                break
            self._q_popleft()
            self._bind(slot, req, pages, now)
            bound.append(slot)
        return bound

    def grow_for_decode(self, now: float = 0.0,
                        spec_k: int = 1) -> list[Slot]:
        """No growth, no preemption — pages were reserved at admission
        (spec_k is signature compatibility: the engine refuses spec +
        static).
        Decoding slots whose request is already done (or aborted) still
        HOLD their slot and pages (the batch drains as one); the engine
        keeps them out of the tick's valid mask."""
        return [s for s in self.decode_slots()
                if not s.req.done and not s.req.terminal]

    def batch_done(self) -> bool:
        occupied = [s for s in self.slots if not s.free]
        return bool(occupied) and all(
            s.req.terminal or (s.req.done and s.decoding) for s in occupied
        )

    def drain(self, now: float) -> None:
        for slot in self.slots:
            if slot.free:
                continue
            if slot.req.terminal:
                # Aborted mid-batch: already in `dropped`, only the
                # reservation remained.
                self._release(slot)
            else:
                self.finish(slot, now)


# -- SLO-aware scheduling --------------------------------------------


def parse_tenant_priorities(spec: str) -> dict[str, int]:
    """The --tenant-priority grammar: 't0=2,t1=0' -> {'t0': 2,
    't1': 0}. Higher is more protected."""
    out: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            tenant, prio = part.split("=")
            out[tenant.strip()] = int(prio)
        except ValueError as e:
            raise ValueError(
                f"--tenant-priority entry {part!r}: want tenant=int "
                "(e.g. 't0=2,t1=0')"
            ) from e
    return out


def parse_tenant_quotas(spec: str) -> tuple[dict[str, int], dict[str, int]]:
    """The --tenant-quota grammar: 't0=pages:8/slots:2,t1=slots:1' ->
    (slot_quota, page_quota) dicts. A dimension left out of a tenant's
    entry is unbounded for that tenant."""
    slot_q: dict[str, int] = {}
    page_q: dict[str, int] = {}
    for part in filter(None, (p.strip() for p in spec.split(","))):
        try:
            tenant, dims = part.split("=")
        except ValueError as e:
            raise ValueError(
                f"--tenant-quota entry {part!r}: want "
                "tenant=dim:int[/dim:int] (e.g. 't0=pages:8/slots:2')"
            ) from e
        for dim in filter(None, (d.strip() for d in dims.split("/"))):
            try:
                kind, bound = dim.split(":")
                bound = int(bound)
            except ValueError as e:
                raise ValueError(
                    f"--tenant-quota {part!r}: bad dimension {dim!r}"
                ) from e
            if kind == "slots":
                slot_q[tenant.strip()] = bound
            elif kind == "pages":
                page_q[tenant.strip()] = bound
            else:
                raise ValueError(
                    f"--tenant-quota {part!r}: dimension {kind!r} must "
                    "be 'slots' or 'pages'"
                )
    return slot_q, page_q


@dataclasses.dataclass(frozen=True)
class SLOPolicy:
    """Configuration for SLOScheduler: per-tenant priority classes
    (higher = more protected; a request's own nonzero `priority`
    overrides its tenant's class), per-tenant admission quotas (slots
    = concurrent engine slots; pages = PRIVATE pages reserved at
    admission — shared prefix pages are free capacity and don't
    count), and the SLO spec whose objectives drive the live burn
    accounting (obs.slo grammar; None = the default availability-only
    spec)."""

    priorities: dict = dataclasses.field(default_factory=dict)
    slot_quota: dict = dataclasses.field(default_factory=dict)
    page_quota: dict = dataclasses.field(default_factory=dict)
    slo_spec: object = None


class SLOScheduler(ContinuousScheduler):
    """SLO-aware admission and preemption over the continuous-batching
    machinery.

    FCFS treats every request identically; at production scale tenants
    carry different objectives and an over-subscribed tenant can starve
    everyone else's SLOs. This scheduler folds every terminal request
    into a live obs.slo.Accountant and
    lets the numbers drive policy, all host-side and deterministic:

    - ADMISSION reorders arrived requests by (priority class desc,
      tenant burn-rate pressure desc, arrival, rid): protected classes
      first, and within a class the tenant currently burning its error
      budget fastest gets capacity first. Per-tenant quotas bound what
      one tenant can hold (slots and admission-time private pages); a
      quota-blocked tenant is SKIPPED — no head-of-line blocking — but
      a page-blocked top candidate waits (lower-ranked work never
      jumps the page queue).
    - PREEMPTION victims are picked by (priority class asc, tenant
      pressure asc, latest-admitted): the worst-burning tenant's work
      is protected, and FCFS's replace-latest rule only breaks ties.

    Burn pressure is a pure fold over event times the scheduler itself
    stamped, so two identical-seed runs make bitwise-identical
    decisions."""

    def __init__(self, *, policy: SLOPolicy | None = None, **kw):
        super().__init__(**kw)
        # Lazy obs import: this module stays light (obs.slo is
        # stdlib-only).
        from ..obs.slo import Accountant, default_spec

        self.policy = policy or SLOPolicy()
        self.acct = Accountant(self.policy.slo_spec or default_spec())
        # Previous admit() moment: the inter-attempt gap is what a
        # quota-blocked candidate's quota_wait_s accrues per skipped
        # attempt (the skip-over share of queue wait).
        self._prev_admit_now: float | None = None

    def _on_terminal(self, req: Request, now: float) -> None:
        for _ in self.acct.observe(terminal_fields(req), now):
            pass

    def _prio(self, req: Request) -> int:
        if req.priority:
            return req.priority
        return self.policy.priorities.get(req.tenant or "default", 0)

    def pressure(self, tenant: str) -> float:
        """The tenant's worst CURRENT burn-rate multiple across its
        objectives and windows — the live 'how close to paging' number
        admission and victim choice read."""
        worst = 0.0
        for (t, metric), we in self.acct.events.items():
            if t != tenant:
                continue
            obj = next(o for o in self.acct.spec.objectives(t)
                       if o.metric == metric)
            for w in we.windows_s:
                worst = max(worst, we.burn_rate(w, obj.target))
        return worst

    def _choose_victim(self, victims: list[Slot]) -> Slot:
        """Victims by (priority class asc, tenant burn pressure asc,
        latest-admitted): the worst-burning tenant's work is protected;
        FCFS's replace-latest rule only breaks ties."""
        return min(victims, key=lambda s: (
            self._prio(s.req),
            self.pressure(s.req.tenant or "default"),
            -s.admit_seq,
        ))

    def transfer_quota_ok(self, req: Request) -> bool:
        """Decode-pool admission for a handed-off request: the tenant's
        slot quota binds here as at prefill-pool admission (each pool's
        SLOScheduler owns its own budget), so a quota-saturated tenant's
        transfers wait without blocking other tenants' handoffs."""
        sq = self.policy.slot_quota.get(req.tenant or "default")
        if sq is None:
            return True
        held_slots, _ = self._usage(req.tenant or "default")
        return held_slots < sq

    def _usage(self, tenant: str) -> tuple[int, int]:
        """(slots held, private pages held) by `tenant` right now.
        Shared prefix pages don't count — they are deduplicated
        capacity, not the tenant's reservation."""
        slots_held = pages_held = 0
        for s in self.slots:
            if s.free or (s.req.tenant or "default") != tenant:
                continue
            slots_held += 1
            pages_held += len(s.pages) - len(s.refs)
        return slots_held, pages_held

    def admit(self, now: float) -> list[Slot]:
        bound: list[Slot] = []
        prev, self._prev_admit_now = self._prev_admit_now, now
        delta = max(now - prev, 0.0) if prev is not None else 0.0
        free_slots = deque(s for s in self.slots if s.free)
        if not self.queue:
            return bound
        arrived = [r for r in self.queue if r.arrival <= now]
        if not arrived:
            return bound
        if not free_slots:
            # Slot-blocked: every arrived candidate waits on a slot
            # release. One representative blocked entry (the highest-
            # priority earliest arrival — pressure left out: computing
            # it on every saturated tick is the cost the early return
            # exists to skip) keeps the record volume bounded.
            head = min(arrived, key=lambda r: (-self._prio(r),
                                               r.arrival, r.rid))
            self._note_blocked(head, "slots", self._occupants())
            return bound
        # One sort per tick: pressures are a pure fold over already-
        # observed terminals, so neither the ordering key nor the
        # priority changes mid-admit — only quota USAGE does, and that
        # is updated incrementally below (O(n log n) per tick instead
        # of a re-scan per admitted slot: the storm-scale requirement).
        pressures = {t: self.pressure(t) for t in
                     {r.tenant or "default" for r in arrived}}
        order = sorted(arrived, key=lambda r: (
            -self._prio(r), -pressures[r.tenant or "default"],
            r.arrival, r.rid))
        usage = {t: self._usage(t) for t in pressures}
        taken: set[int] = set()
        for req in order:
            if not free_slots:
                # Ran out of slots mid-order: the next-ranked candidate
                # is slot-blocked behind everything now running.
                self._note_blocked(req, "slots", self._occupants())
                break
            tenant = req.tenant or "default"
            need = pages_for(req.context_len + 1, self.page_size)
            if need > self.pool.usable:
                # The livelock guard, verbatim from the FCFS form.
                taken.add(id(req))
                self._drop(req, "failed", now,
                           f"context of {req.context_len} tokens needs "
                           f"{need} pages; pool owns {self.pool.usable}")
                continue
            sq = self.policy.slot_quota.get(tenant)
            pq = self.policy.page_quota.get(tenant)
            held_slots, held_pages = usage[tenant]
            if sq is not None and held_slots >= sq:
                # Quota skip-over: its own causal edge kind —
                # the candidate waits on ITS OWN tenant's occupancy, not
                # on fleet capacity — and its own queue-wait split (the
                # inter-attempt gap accrues as quota_wait_s, clamped to
                # the request's own presence so a late arrival never
                # inherits the whole gap and the quota share stays a
                # subset of its queue wait).
                req.quota_wait_s += min(delta, max(now - req.arrival, 0.0))
                self._note_blocked(req, "quota", self._occupants(tenant))
                continue  # quota-blocked: skip, don't block others
            # The page quota counts PRIVATE pages only (the SLOPolicy
            # contract: shared prefix pages are deduplicated capacity)
            # — so acquire first to learn the match depth, and release
            # if the quota still blocks.
            acq = (self.prefix.acquire(req.prompt, req.rid,
                                       max_tokens=req.context_len - 1)
                   if self.prefix is not None else None)
            alloc_n = (pages_for(req.context_len, self.page_size)
                       - (len(acq.nodes) if acq is not None else 0))
            if pq is not None and held_pages + alloc_n > pq:
                if acq is not None:
                    self._release_acq(acq, req.rid)
                req.quota_wait_s += min(delta, max(now - req.arrival, 0.0))
                self._note_blocked(req, "quota", self._occupants(tenant))
                continue
            slot = free_slots[0]
            if not self._admit_one(slot, req, now, acq=acq):
                # Page-blocked: the top-ranked admissible request
                # waits; nothing below it jumps the page queue.
                self._note_blocked(req, "pages", self._occupants())
                break
            free_slots.popleft()
            taken.add(id(req))
            bound.append(slot)
            usage[tenant] = (held_slots + 1,
                             held_pages + len(slot.pages) - len(slot.refs))
        if taken:
            self._q_rebuild(deque(r for r in self.queue
                                  if id(r) not in taken))
        return bound
