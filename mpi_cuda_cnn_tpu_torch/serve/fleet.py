"""Failure-aware multi-replica serving fleet (a copy of the JAX package's
`serve/fleet.py`).

This module puts N single-engine replicas
behind serve/router.py's deterministic policy layer and makes replica
DEATH a scheduled, tested event rather than an outage:

- Each `Replica` wraps its own scheduler + PagePool (the scheduler's
  policy machinery, unchanged) and a pluggable `compute`: `EngineCompute`
  drives a real PagedEngine's prefill/decode forwards (each replica
  its own page pools; on the card every replica shares the one
  device), while
  `SimCompute` replaces the device math with a pure token function of
  (request, position) so a 10^5-request storm runs on CPU in seconds
  with the SCHEDULING — dispatch, paging, preemption, re-dispatch —
  exercised for real. Both computes produce per-request outputs that
  are a pure function of (prompt, params|salt), which is what makes
  the crash-vs-crash-free output-equality proof meaningful.

- `ReplicaCore.step` is the PagedEngine.run loop body restructured as
  one scheduler iteration (sweep -> admit -> one prefill chunk -> one
  decode tick) so the fleet can interleave N replicas on one clock.
  The deadline sweep is skipped on ticks where no submitted request
  carries a deadline and no cancel is pending — the O(queue) scan is
  what would otherwise dominate a storm.

- The `Fleet` loop advances a FakeClock by `tick_s` per tick; every
  decision (router policy, failure detection, backoff, fencing) is
  host-side and deterministic, so two identical-seed runs produce
  bitwise-equal dispatch traces and per-status totals.

Failure semantics (the exactly-once contract):

- A `replica_crash@fleet.tick:T?replica=K` fault stops replica K. The
  router notices via heartbeat staleness (`heartbeat_miss` ticks), then
  FAILS OVER: the dead replica's non-terminal requests have their
  generation fence revoked, are harvested with their COMMITTED tokens,
  and are re-dispatched exactly once each to surviving replicas —
  `redispatch="resume"` re-prefills prompt + committed output (the
  recompute-preemption path, now across replicas), `"discard"` drops
  the partial output and restarts from the prompt.
- Every token and terminal claim a replica makes passes the router's
  generation-token fence. A crashed-but-partitioned replica
  (``zombie_ticks=N``) keeps stepping after failover; every commit it
  attempts is refused — zero double-generated tokens, pinned by test.
- The crashed replica restarts after utils/retry.backoff_delay and
  rejoins with empty pools; a replica that keeps flapping is
  circuit-opened (permanently removed). `replica_join` scales the
  fleet out elastically; `replica_leave` drains one gracefully.

Disaggregated prefill/decode serving:
`pools={"prefill": N, "decode": M}` splits the fleet by phase — the
router dispatches arrivals to the prefill pool, and a completed
prefill's page set moves to a decode replica through a page-granular
handoff (sealed pages under a per-handoff ownership token, per-page
content CRCs verified at adoption, the rid's generation fence revoked
in flight and re-granted to the receiver). A crash of either end
mid-handoff resolves to exactly-once via the same re-dispatch path a
replica crash uses; a pool that EMPTIES (crashes, circuit breaker,
leave, `pool_crash`) degrades affected requests to unified serving on
whatever can take work — with a `degraded` obs event — instead of
stalling, and a repopulated pool logs `restored`.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import zlib
from collections import deque

from ..faults import FakeClock
from ..obs.metrics import MetricsRegistry
from .host_tier import TIER_SPILL_SITE, HostTier
from .handoff import (
    Handoff,
    context_crc,
    context_tokens,
    handoff_owner,
    page_crcs,
    parse_pools,
    verify_page_crcs,
)
from .pool import PagePool
from .prefix_cache import PrefixCache, empty_prefix_fields
from .router import CircuitOpen, Router, fleet_state_digest
from .spec import LookupProposer, empty_spec_fields, run_round
from .transport import TRANSPORT_SITE, TransportBus, transport_digest_tuple
from .scheduler import (
    ContinuousScheduler,
    Request,
    SLOScheduler,
    scheduler_digest,
    tenant_block,
    terminal_fields,
    validate_request,
)

__all__ = [
    "EngineCompute", "Fleet", "FleetResult", "Replica", "ReplicaCore",
    "SimCompute", "parse_pools",
]


# Test-only chaos target. When set to "skip-revoke",
# _harvest skips the LAST stranded request's fence revoke on every
# failover: the run itself still behaves (the re-dispatch grant bumps
# the epoch, so the zombie's commits stay refused) but the producer's
# fence_crc chain silently diverges from what the dead-replica record
# advertises — exactly the class of one-op bookkeeping drift the replay
# oracle exists to catch. Nothing on the main path ever sets it; a
# chaos harness flips it around one episode.
#
# "skip-dedup" is the transport twin: the bus skips the
# receiver-side seen-check for COMMIT keys, so a duplicated commit
# message applies twice and the authoritative output diverges from the
# SimCompute closed form — the exactly-once canary a single sampled
# msg_dup must expose.
CHAOS_PLANT: str | None = None


def _chaos_plant() -> str | None:
    """Late-bound CHAOS_PLANT read for the transport bus (the chaos
    harness flips the module global AFTER the Fleet — and its bus — is
    constructed)."""
    return CHAOS_PLANT


class SimCompute:
    """Device-free compute: the next token is a pure 32-bit mix of
    (rid, output position, salt) mod vocab. Identical on every replica,
    so a re-dispatched request regenerates exactly the tokens the dead
    replica would have — the sim twin of greedy decode under shared
    weights — while costing nothing, which is what lets the 10^5 storm
    run on this box."""

    def __init__(self, vocab: int = 512, chunk: int = 32, salt: int = 0):
        self.vocab = vocab
        self.chunk = chunk
        self.salt = salt

    def _tok_at(self, req: Request, j: int) -> int:
        h = (req.rid * 1000003 + j * 2654435761 + self.salt * 97
             + int(req.prompt.size) * 8191) & 0xFFFFFFFF
        return h % self.vocab

    def _tok(self, req: Request) -> int:
        return self._tok_at(req, len(req.out))

    def prefill_chunk(self, slot) -> tuple[int, int]:
        n = min(self.chunk, slot.target - slot.cached)
        return n, self._tok(slot.req)

    def decode(self, dslots) -> dict[int, int]:
        return {s.idx: self._tok(s.req) for s in dslots}

    def verify(self, rounds):
        """Speculative verify, sim form: the target's pick
        for verify row i is the pure token mix at output position
        len(out) + i — exactly the token the spec-off tick stream would
        emit there, so sim spec-on outputs are bitwise spec-off's for
        any proposer while the variable-length commit/rollback
        machinery runs for real."""
        return [
            [self._tok_at(s.req, len(s.req.out) + i) for i in range(w)]
            for s, _u, w in rounds
        ]

    def copy_page(self, src: int, dst: int) -> None:
        """Sim COW is pure bookkeeping: tokens are a function of
        (rid, position), not of cache contents — the page accounting
        is exercised for real, the device copy has nothing to copy."""

    def adopt_pages(self, src_compute, src_pages, dst_pages) -> None:
        """Sim cross-pool KV transfer: accounting-only, like
        COW — tokens are a pure function of (rid, position), so the
        protocol (seal, CRC, adopt, release) is exercised for real
        while the content copy has nothing to move."""


class EngineCompute:
    """Model-backed compute: one PagedEngine (its own page pools) per
    replica; prefill/decode go through the engine's forwards via the
    same run_prefill_chunk/run_decode_tick path
    engine.run uses — one implementation, two drivers."""

    def __init__(self, engine):
        self.engine = engine
        # The engine's forwards (prefill chunks; decode ticks and verify
        # rounds), never reset: a failover retires the replica's own
        # counters, but its device work (and a zombie's after it) stays.
        self.prefill_chunks = 0
        self.decode_ticks = 0

    def prefill_chunk(self, slot) -> tuple[int, int]:
        self.prefill_chunks += 1
        return self.engine.run_prefill_chunk(slot)

    def decode(self, dslots):
        self.decode_ticks += 1
        return self.engine.run_decode_tick(dslots)

    def copy_page(self, src: int, dst: int) -> None:
        self.engine.copy_page(src, dst)

    def adopt_pages(self, src_compute, src_pages, dst_pages) -> None:
        """Cross-engine KV page transfer: copy the sender
        engine's page rows into this engine's pools at the destination
        indices — the device half of the prefill->decode handoff."""
        self.engine.adopt_pages(src_compute.engine, src_pages, dst_pages)

    def verify(self, rounds):
        """Speculative verify, engine form: the batched
        verify program — the engine must have been constructed with
        spec="lookup"/"draft" (the fleet bench's compute factory
        threads --spec through)."""
        self.decode_ticks += 1
        return self.engine.run_spec_tick(rounds)


class ReplicaCore:
    """One replica's steppable engine loop over the continuous scheduler.

    `on_emit(req, tok, now)` is the fleet's fenced commit hook, called
    AFTER the token lands in the replica-local request (the local copy
    always advances — a zombie replica keeps generating; only the
    fence decides whether the authoritative output accepts it)."""

    def __init__(self, compute, *, slots: int, num_pages: int,
                 page_size: int, max_len: int, max_queue: int | None = None,
                 on_emit=None, check_every: int = 1, prefix: bool = False,
                 policy=None, spec: str = "off", spec_k: int = 8,
                 spec_ngram: int = 2, host_pages: int = 0,
                 tier_fault_poll=None):
        if spec not in ("off", "lookup"):
            # Fleet speculation is the draft-free form: a per-replica
            # draft model is an engine-construction concern (the bench
            # factory could thread one), and the sim storms have no
            # draft to run — "lookup" is the serving-fleet contract.
            raise ValueError(
                f"fleet spec {spec!r}: want 'off' or 'lookup'")
        self.spec = spec
        self.spec_k = spec_k
        self.proposer = (LookupProposer(spec_ngram) if spec != "off"
                         else None)
        self.spec_stats = empty_spec_fields()
        pool = PagePool(num_pages)
        if host_pages > 0 and not prefix:
            raise ValueError(
                "host_pages > 0 without prefix=True — the host tier "
                "spills prefix-tree pages; there is nothing to spill "
                "without the tree"
            )
        self.tier = None
        # Cache-aware routing digest: the host-side set of
        # cumulative prefix keys this replica can serve a hit from —
        # device-tree paths plus host-tier keys, maintained
        # incrementally by the cache/tier at their insert/readmit/
        # evict/spill seams. Router.pick's cache_aware scoring reads it
        # via Replica.route_keys; it is NEVER digested (replay
        # re-applies recorded routing decisions, not pick()).
        self.route_keys: set | None = set() if prefix else None
        if host_pages > 0:
            # Per-incarnation tier: it dies with the replica
            # like its PagePool — a cold restart comes back with the
            # host tier EMPTY, same as the device tree. Under
            # EngineCompute the tier carries real KV payloads via the
            # replica engine's spill/readmit programs; the sim tier is
            # accounting-only (same schedule, no device rows).
            engine = getattr(compute, "engine", None)
            self.tier = HostTier(
                host_pages,
                spill_fn=engine.spill_page if engine is not None else None,
                readmit_fn=(engine.readmit_page if engine is not None
                            else None),
                fault_poll=tier_fault_poll,
                route_keys=self.route_keys,
            )
        self.prefix = (PrefixCache(pool, page_size, self.tier,
                                   route_keys=self.route_keys)
                       if prefix else None)
        sched_kw = dict(slots=slots, pool=pool, page_size=page_size,
                        max_len=max_len, max_queue=max_queue,
                        prefix=self.prefix)
        if policy is not None:
            self.sched = SLOScheduler(policy=policy, **sched_kw)
        else:
            self.sched = ContinuousScheduler(**sched_kw)
        self.compute = compute
        # Precomputed digest config: built once — step()
        # stamps a state digest per tick of a 10^5 storm.
        self._digest_extra = ((1, spec_k) if spec != "off" else (0, 0))
        self.on_emit = on_emit
        # Disaggregated serving hook: called when a slot's
        # prefill completes with decode work remaining; returning True
        # means the fleet DETACHED the slot for a cross-pool handoff
        # (prefill was this replica's whole job for the rid).
        self.on_prefill_done = None
        self.check_every = check_every
        self.steps = 0
        self.decode_ticks = 0
        self.prefill_chunks = 0
        self._cancel_pending = False
        self._n_fin = 0
        self._n_drop = 0

    def submit(self, req: Request) -> None:
        self.sched.submit([req])

    def flag_cancel(self) -> None:
        """A cancel() landed on one of this core's requests: force the
        sweep on the next step even with no deadlines in play."""
        self._cancel_pending = True

    @property
    def unfinished(self) -> int:
        return self.sched.unfinished

    def _emit(self, req: Request, tok: int, now: float) -> None:
        req.out.append(tok)
        if req.first_token_at is None:
            req.first_token_at = now
        if self.on_emit is not None:
            self.on_emit(req, tok, now)

    def step(self, now: float):
        """One scheduler iteration (the engine.run body, minus the
        idle/fault/watchdog handling the fleet owns). Returns
        (tick-record fields, newly finished locals, newly dropped
        locals) — the fleet syncs terminal statuses from the tails."""
        sched = self.sched
        self.steps += 1
        progressed = False
        if sched.has_deadlines or self._cancel_pending:
            progressed = bool(sched.sweep(now))
            self._cancel_pending = False
        admitted = [[s.idx, s.req.rid] for s in sched.admit(now)]
        if sched.max_queue is not None:
            progressed |= bool(sched.enforce_queue_bound(now))
        prefill_rec = None
        slot = sched.prefill_slot()
        if slot is not None:
            if slot.cow is not None:
                # COW: duplicate the partially matched shared
                # page before the slot's first write (engine.run's rule;
                # SimCompute's copy is accounting-only).
                self.compute.copy_page(*slot.cow)
                sched.cow_complete(slot)
            n, nxt = self.compute.prefill_chunk(slot)
            slot.cached += n
            self.prefill_chunks += 1
            prefill_rec = [slot.idx, slot.req.rid, n]
            progressed = True
            if slot.cached >= slot.target:
                # Prefill complete: adopt the prompt's pages into the
                # prefix tree; the first generated token is
                # due now (TTFT at prefill completion — engine.run's
                # rule).
                sched.note_prefill_complete(slot)
                # Sanctioned sync (engine.run's rule): int() only on
                # the completing chunk, where the token is emitted.
                # mctpu: disable=MCT007
                self._emit(slot.req, int(nxt), now)
                prefill_rec.append("emit")
                if slot.req.done:
                    sched.finish(slot, now)
                elif (self.on_prefill_done is not None
                        and self.on_prefill_done(self, slot, now)):
                    # Handed off: the fleet sealed the page
                    # set and detached the slot — decode happens on the
                    # receiving pool's replica.
                    pass
        dslots = sched.grow_for_decode(
            now, spec_k=self.spec_k if self.spec != "off" else 1)
        decoded = [[s.idx, s.req.rid] for s in dslots]
        spec_rec = None
        if dslots and self.spec != "off":
            # Speculative round: the SAME spec.run_round
            # scaffold engine.run drives — proposal + one batched
            # verify (compute.verify: the verify block on engine replicas,
            # the pure token mix on sim) + greedy acceptance, with
            # commit_spec rolling rejected-draft pages back.
            widths = [sched.spec_width(s, self.spec_k) for s in dslots]
            results = run_round(dslots, widths, self.proposer,
                                self.compute.verify)
            self.decode_ticks += 1
            progressed = True
            spec_rec = []
            for s, w, j, toks_out in results:
                sched.commit_spec(s, j)
                for t in toks_out:
                    self._emit(s.req, t, now)
                spec_rec.append([s.req.rid, w - 1, j - 1])
                self.spec_stats["spec_rounds"] += 1
                self.spec_stats["spec_proposed"] += w - 1
                self.spec_stats["spec_accepted"] += j - 1
                if s.req.done:
                    sched.finish(s, now)
        elif dslots:
            toks = self.compute.decode(dslots)
            self.decode_ticks += 1
            progressed = True
            for s in dslots:
                s.cached += 1
                self._emit(s.req, int(toks[s.idx]), now)
                if s.req.done:
                    sched.finish(s, now)
        preempted_pairs = sched.drain_preempted()
        blocked = sched.drain_blocked()
        prefix_tick = (self.prefix.drain_tick()
                       if self.prefix is not None else None)
        new_fin = sched.finished[self._n_fin:]
        new_drop = sched.dropped[self._n_drop:]
        self._n_fin, self._n_drop = len(sched.finished), len(sched.dropped)
        if self.check_every and self.steps % self.check_every == 0:
            sched.check()
        rec = {
            "queue": len(sched.queue),
            "running": sum(1 for s in sched.slots if not s.free),
            "free_pages": sched.pool.free_pages,
            "admitted": admitted, "prefill": prefill_rec,
            "decoded": decoded,
            "preempted": [v for v, _ in preempted_pairs],
            # Causal edges: blocked admission attempts and
            # preemption beneficiaries, same shape as engine.run's tick
            # record so the explain tools fold both trails identically.
            "blocked": [[rid, reason, holders]
                        for rid, reason, holders in blocked],
            "preempted_for": [[v, b] for v, b in preempted_pairs
                              if b is not None],
            "finished": [r.rid for r in new_fin],
            "aborted": [[r.rid, r.status] for r in new_drop],
            "progressed": progressed or bool(admitted or new_fin or new_drop),
            # Flight recorder: this replica's end-of-step
            # state digest — the ONE scheduler_digest spelling, stamped
            # on every ReplicaCore tick (zombie steps included while
            # their records still flow) and chained into the fleet
            # summary's state_crc.
            "state_crc": scheduler_digest(sched, extra=self._digest_extra),
        }
        if prefix_tick is not None:
            rec["prefix_hits"] = prefix_tick["hits"]
            # Cumulative tree stats: the replay
            # reconstruction derives hit/miss counts itself and adopts
            # the cow/insert/eviction deltas from here (both feed the
            # digest's prefix tuple and the free-page conservation
            # audit).
            rec["prefix"] = {"shared_pages": self.prefix.shared_pages,
                             **self.prefix.stats}
            if self.tier is not None:
                # Host-tier fields: cumulative tier counters
                # + occupancy on the same dict, and the tick's
                # readmission markers — engine.run's spelling, so the
                # replay reconstruction and the trace tools fold engine
                # and fleet trails identically.
                rec["prefix"].update(self.tier.stats)
                rec["prefix"]["host_used"] = self.tier.host_used
                rec["prefix_readmits"] = prefix_tick["readmits"]
        if spec_rec is not None:
            rec["spec"] = spec_rec
        return rec, new_fin, new_drop

    def prefix_stats(self) -> dict:
        """Cumulative prefix counters in the flat fleet-summary shape
        (zeros with sharing off — gated metrics exist in every run)."""
        if self.prefix is None:
            return empty_prefix_fields()
        return self.prefix.summary_fields()

    def reset_prefix_stats(self) -> None:
        """Zero the counters after they were banked (retirement at
        failover: a zombie's later activity must not re-bank)."""
        if self.prefix is not None:
            for k in self.prefix.stats:
                self.prefix.stats[k] = 0
        if self.tier is not None:
            for k in self.tier.stats:
                self.tier.stats[k] = 0

    def reset_spec_stats(self) -> None:
        """Spec-counter twin of reset_prefix_stats (retirement at
        failover — a zombie's later rounds must not re-bank)."""
        self.spec_stats = empty_spec_fields()


class Replica:
    """One fleet member: a named ReplicaCore plus the MetricsRegistry its
    step loop keeps current — `load()` (what least-loaded dispatch
    reads) is queue depth + running slots FROM THE GAUGES, plus the
    dispatches routed here since the last step (so a burst arriving
    within one tick spreads instead of dog-piling the stalest gauge)."""

    def __init__(self, name: str, compute, *, slots: int, num_pages: int,
                 page_size: int, max_len: int, max_queue: int | None = None,
                 check_every: int = 1, on_emit=None, clock=None,
                 prefix: bool = False, policy=None, phase: str | None = None,
                 spec: str = "off", spec_k: int = 8, spec_ngram: int = 2,
                 host_pages: int = 0, tier_fault_poll=None):
        self.name = name
        # Pool membership of a disaggregated fleet:
        # "prefill" | "decode" | None (unified). A restarted
        # incarnation keeps its name's phase.
        self.phase = phase
        self.registry = MetricsRegistry(clock=clock)
        self.core = ReplicaCore(
            compute, slots=slots, num_pages=num_pages, page_size=page_size,
            max_len=max_len, max_queue=max_queue, check_every=check_every,
            on_emit=on_emit, prefix=prefix, policy=policy,
            spec=spec, spec_k=spec_k, spec_ngram=spec_ngram,
            host_pages=host_pages, tier_fault_poll=tier_fault_poll,
        )
        self.alive = True
        self.zombie_until = -1   # fleet tick a partitioned zombie stops at
        self.pending_dispatches = 0
        # Lossy-transport incarnation identity + lease: gen
        # distinguishes this object's bus endpoint ("<name>#<gen>")
        # from a restarted successor's; the replica refuses its OWN
        # commits once the fleet tick passes lease_until (renewed by
        # every hb_ack). Both are inert with the bus off.
        self.gen = 0
        self.lease_until = -1

    def _gauge(self, name: str) -> float:
        g = self.registry.gauges.get(name)
        return g.value if g is not None and g.value is not None else 0.0

    def load(self) -> float:
        return (self._gauge("serve.queue_depth")
                + self._gauge("serve.running_slots")
                + self.pending_dispatches)

    @property
    def route_keys(self):
        """The core's routing digest — what Router.pick's
        cache_aware scoring reads; None with the prefix cache off."""
        return self.core.route_keys

    def step(self, now: float):
        rec, new_fin, new_drop = self.core.step(now)
        r = self.registry
        r.set("serve.queue_depth", rec["queue"])
        r.set("serve.running_slots", rec["running"])
        r.set("serve.free_pages", rec["free_pages"])
        if rec["decoded"]:
            r.inc("serve.decode_ticks")
        if rec["prefill"] is not None:
            r.inc("serve.prefill_chunks")
        if rec["preempted"]:
            r.inc("serve.preemptions", len(rec["preempted"]))
        if rec.get("prefix_hits"):
            r.inc("serve.prefix.hits", len(rec["prefix_hits"]))
            r.inc("serve.prefix.hit_tokens",
                  sum(m for _, m in rec["prefix_hits"]))
        if rec.get("spec"):
            r.inc("serve.spec.rounds", len(rec["spec"]))
            r.inc("serve.spec.proposed",
                  sum(p for _, p, _ in rec["spec"]))
            r.inc("serve.spec.accepted_total",
                  sum(a for _, _, a in rec["spec"]))
        self.pending_dispatches = 0
        return rec, new_fin, new_drop


@dataclasses.dataclass
class FleetResult:
    """One fleet run: every submitted request terminal, plus the
    structural counts the determinism gate compares at exact equality
    and the dispatch trace that IS the schedule (crc32-hashable)."""

    requests: list[Request]
    ticks: int
    duration_s: float
    dispatches: int
    redispatches: int
    fenced_discards: int
    crashes: int
    joins: int
    leaves: int
    restarts: int
    circuit_opens: int
    decode_ticks: int
    prefill_chunks: int
    preemptions: int
    replicas_final: int
    # Disaggregated serving: completed prefill->decode KV
    # handoffs (+ pages moved), aborted transfers (either end died, the
    # transfer dropped, or a CRC refused adoption), integrity refusals
    # (corrupted handoff pages or resume contexts — never decoded), and
    # requests served unified because a pool was empty. All stamped in
    # every run (zeros on a unified fleet) so the gates can pin them.
    handoffs: int = 0
    handoff_pages: int = 0
    handoffs_aborted: int = 0
    kv_refusals: int = 0
    degraded_unified: int = 0
    pools: dict | None = None
    handoff_log: list[dict] = dataclasses.field(default_factory=list)
    # (tick, rid, replica name, epoch, "dispatch" | "redispatch") —
    # every routing decision in order; bitwise-equal across
    # identical-seed runs (the determinism acceptance).
    dispatch_trace: list[tuple] = dataclasses.field(default_factory=list)
    events: list[dict] = dataclasses.field(default_factory=list)
    replica_log: list[dict] = dataclasses.field(default_factory=list)
    # Transport lifecycle records: partition
    # open/heal moments, logged as the obs `transport` event family.
    transport_log: list[dict] = dataclasses.field(default_factory=list)
    # Fleet-wide prefix-cache structural counters: summed
    # across every replica incarnation; zeros with sharing off so the
    # gated metrics exist in every fleet-bench run.
    prefix: dict = dataclasses.field(default_factory=empty_prefix_fields)
    # Fleet-wide speculative-decoding counters: same
    # contract — summed across incarnations, zeros with spec off.
    spec: dict = dataclasses.field(default_factory=empty_spec_fields)
    # Flight-recorder chain: crc32 chained over every
    # per-tick state digest (router record, then each stepped replica)
    # in emission order — the whole state trajectory as ONE gated
    # number, present on summary-only storms.
    state_crc: int = 0
    # Cache-aware routing counters: dispatches whose
    # cache_aware pick scored a positive expected prefix overlap
    # (route_hit_tokens sums the matched tokens). Zeros under any other
    # policy so the gated metrics exist in every fleet-bench run.
    route_hits: int = 0
    route_misses: int = 0
    route_hit_tokens: int = 0
    # Online-autoscaler counters: scale decisions applied,
    # the crc32 chain over the (tick, direction, name) decision log,
    # and the cumulative live-member step count the static-vs-
    # autoscaled capacity comparison reads. Zeros without --autoscale
    # (replica_ticks is always counted — a static fleet spends them
    # too).
    scale_ups: int = 0
    scale_downs: int = 0
    scale_crc: int = 0
    replica_ticks: int = 0
    # Lossy-transport counters: the message bus's wire
    # accounting plus the lease-refusal count (commits/terminals a
    # replica refused to SEND past its own lease — the isolated-replica
    # proof obligation). All stamped (zeros) with the bus off so the
    # transport gate can pin them in every fleet-bench run.
    msgs_sent: int = 0
    msgs_delivered: int = 0
    msgs_dropped: int = 0
    msgs_duped: int = 0
    msgs_delayed: int = 0
    msgs_deduped: int = 0
    retransmits: int = 0
    lease_refusals: int = 0
    partitions: int = 0
    lease_ticks: int = 0

    @property
    def output_tokens(self) -> int:
        return sum(len(r.out) for r in self.requests)

    @property
    def tokens_per_s(self) -> float:
        return self.output_tokens / max(self.duration_s, 1e-9)

    @functools.cached_property
    def trace_crc(self) -> int:
        """crc32 of the dispatch trace — one number that pins the
        whole schedule at exact equality. Cached: a storm's trace holds ~10^5 tuples and the bench reads
        this twice (the trace is complete once the result exists)."""
        return zlib.crc32(json.dumps(self.dispatch_trace).encode())

    def status_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for r in self.requests:
            counts[r.status] = counts.get(r.status, 0) + 1
        return counts

    def outputs(self) -> dict[int, list[int]]:
        """rid -> committed tokens (the authoritative, fenced output)."""
        return {r.rid: list(r.out) for r in self.requests}

    def finished_requests(self) -> list[Request]:
        return [r for r in self.requests if r.status == "finished"]

    def request_records(self) -> list[dict]:
        """Per-request obs `request` field dicts, mode="fleet" — built
        by engine.request_record, the ONE record shape report/trace
        consume for engine and fleet runs alike."""
        from .engine import request_record

        return [request_record(r, "fleet")
                for r in sorted(self.requests, key=lambda r: r.rid)]

    def summary(self) -> dict:
        from ..obs.metrics import pct_nearest

        fin = self.finished_requests()
        ttft = [1e3 * (r.first_token_at - r.arrival) for r in fin]
        tpot = [1e3 * (r.finished_at - r.first_token_at)
                / max(len(r.out) - 1, 1) for r in fin]
        return {
            "mode": "fleet",
            "requests": len(self.requests),
            "statuses": self.status_counts(),
            "output_tokens": self.output_tokens,
            "decode_ticks": self.decode_ticks,
            "prefill_chunks": self.prefill_chunks,
            "preemptions": self.preemptions,
            "duration_s": round(self.duration_s, 4),
            "tokens_per_s": round(self.tokens_per_s, 2),
            "ttft_p50_ms": pct_nearest(ttft, 50),
            "ttft_p99_ms": pct_nearest(ttft, 99),
            "tpot_p50_ms": pct_nearest(tpot, 50),
            "tpot_p99_ms": pct_nearest(tpot, 99),
            "replicas": self.replicas_final,
            "fleet_ticks": self.ticks,
            "dispatches": self.dispatches,
            "redispatches": self.redispatches,
            "fenced_discards": self.fenced_discards,
            "crashes": self.crashes,
            "joins": self.joins,
            "leaves": self.leaves,
            "restarts": self.restarts,
            "circuit_opens": self.circuit_opens,
            "trace_crc": self.trace_crc,
            # Per-tick state-digest chain: the determinism
            # gates pin it at 0%/equal next to trace_crc/blame_crc.
            "state_crc": self.state_crc,
            # Disaggregated-serving counters: flat keys the
            # disagg determinism gate pins at exact equality; zeros on
            # a unified fleet so they exist in every fleet-bench run.
            "handoffs": self.handoffs,
            "handoff_pages": self.handoff_pages,
            "handoffs_aborted": self.handoffs_aborted,
            "kv_refusals": self.kv_refusals,
            "degraded_unified": self.degraded_unified,
            # Cache-aware routing + autoscale counters: flat
            # keys the fleet/autoscale determinism gates pin at exact
            # equality; zeros under other policies / without the
            # autoscaler so they exist in every fleet-bench run.
            "route_hits": self.route_hits,
            "route_misses": self.route_misses,
            "route_hit_tokens": self.route_hit_tokens,
            "scale_ups": self.scale_ups,
            "scale_downs": self.scale_downs,
            "scale_crc": self.scale_crc,
            "replica_ticks": self.replica_ticks,
            # Lossy-transport counters: flat keys the
            # transport determinism gate pins at exact equality; zeros
            # with the bus off so they exist in every fleet-bench run.
            "msgs_sent": self.msgs_sent,
            "msgs_delivered": self.msgs_delivered,
            "msgs_dropped": self.msgs_dropped,
            "msgs_duped": self.msgs_duped,
            "msgs_delayed": self.msgs_delayed,
            "msgs_deduped": self.msgs_deduped,
            "retransmits": self.retransmits,
            "lease_refusals": self.lease_refusals,
            "partitions": self.partitions,
            "lease_ticks": self.lease_ticks,
            **({"pools": dict(self.pools)} if self.pools else {}),
            # Prefix-sharing counters: flat keys the fleet
            # determinism gate pins at exact equality.
            **self.prefix,
            # Speculative-decoding counters: flat keys the
            # fleet/spec determinism gates pin at exact equality.
            **self.spec,
            # Per-tenant status/latency counts — same shape
            # and flattening as ServeResult.summary's block.
            "tenants": tenant_block(self.requests),
        }


class Fleet:
    """The router + N replicas on one deterministic clock (module doc).

    `compute_factory(name)` builds each replica's compute (fresh state
    per incarnation — a restarted replica comes back with empty pools).
    `faults` injects replica_crash / replica_join / replica_leave at
    the "fleet.tick" site. Telemetry is opt-in: `registry` aggregates
    fleet-level counters/latency histograms, `fleet_sink` receives one
    router record per tick, `replica_tick_sink` the per-replica tick
    records (mode "fleet/<name>").
    """

    def __init__(self, compute_factory, *, replicas: int = 2,
                 slots: int = 4, num_pages: int = 64, page_size: int = 16,
                 max_len: int = 256, max_queue: int | None = None,
                 policy: str = "least_loaded", heartbeat_miss: int = 3,
                 backoff_base: float = 0.0, max_flaps: int = 3,
                 redispatch: str = "resume", tick_s: float = 1e-3,
                 check_every: int = 1, faults=None, clock: FakeClock | None = None,
                 registry: MetricsRegistry | None = None, fleet_sink=None,
                 replica_tick_sink=None, jitter=None, prefix: bool = False,
                 sched_policy=None, pools: dict[str, int] | str | None = None,
                 handoff_ticks: int = 1, log_handoffs: bool = True,
                 spec: str = "off", spec_k: int = 8, spec_ngram: int = 2,
                 host_pages: int = 0, autoscale=None,
                 transport: bool = False, lease_ticks: int = 0,
                 rto_base: float = 2.0):
        if isinstance(pools, str):
            pools = parse_pools(pools)
        if pools is not None:
            bad = [k for k, v in pools.items()
                   if k not in ("prefill", "decode") or v < 1]
            if bad or set(pools) != {"prefill", "decode"}:
                raise ValueError(
                    f"pools {pools!r}: want {{'prefill': N>=1, "
                    "'decode': M>=1}}"
                )
            replicas = pools["prefill"] + pools["decode"]
        if replicas < 1:
            raise ValueError(f"need at least one replica, got {replicas}")
        if handoff_ticks < 1:
            raise ValueError(f"handoff_ticks must be >= 1, got "
                             f"{handoff_ticks}")
        if redispatch not in ("resume", "discard"):
            raise ValueError(
                f"redispatch {redispatch!r}: want 'resume' or 'discard'")
        if pools is None and faults is not None:
            # The inert-fault contract, extended to
            # the handoff site: fleet.handoff is only polled on a
            # pooled fleet — a unified run would validate the plan and
            # then silently never fire it. (fleet.resume stays legal
            # everywhere: failover resume re-dispatches exist on
            # unified fleets too.)
            inert = [f"{f.kind}@{f.site}"
                     for f in faults.pending("fleet.handoff")]
            if inert:
                raise ValueError(
                    f"fault(s) {', '.join(sorted(set(inert)))} need a "
                    "disaggregated fleet (--pools) — on a unified fleet "
                    "they would silently never fire"
                )
        if host_pages == 0 and faults is not None:
            # Same inert-fault contract, tier leg: without a host tier
            # no spill ever happens, so a tier.spill fault would
            # silently never fire.
            inert = [f"{f.kind}@{f.site}"
                     for f in faults.pending(TIER_SPILL_SITE)]
            if inert:
                raise ValueError(
                    f"fault(s) {', '.join(sorted(set(inert)))} need a "
                    "host tier (--spill / host_pages > 0) — without one "
                    "they would silently never fire"
                )
        if policy == "cache_aware" and not prefix:
            # Inert-config contract, routing leg: without
            # the prefix cache no replica ever registers a route key,
            # so cache-aware scoring would silently always fall back.
            raise ValueError(
                "policy 'cache_aware' needs prefix=True "
                "(--prefix-cache) — without the prefix tree there are "
                "no cache keys to route on"
            )
        if transport and pools is not None:
            # Scope cut: the handoff control messages of a
            # disaggregated fleet are not bus-routed yet — running both
            # would silently leave the handoff path on the perfect
            # in-process channel, so the combination is refused loudly.
            raise ValueError(
                "transport=True (--transport) does not compose with "
                "--pools yet — the prefill->decode handoff control "
                "plane still uses direct calls"
            )
        if not transport and faults is not None:
            # Inert-fault contract, transport leg: the fleet.transport
            # site is only polled when the message bus exists — with
            # the bus off the fault would validate and silently never
            # fire.
            inert = [f"{f.kind}@{f.site}"
                     for f in faults.pending(TRANSPORT_SITE)]
            if inert:
                raise ValueError(
                    f"fault(s) {', '.join(sorted(set(inert)))} need the "
                    "lossy transport (--transport) — without the "
                    "message bus they would silently never fire"
                )
        if transport:
            if lease_ticks == 0:
                # Default: a lease outlives the detection window by two
                # ticks, so a replica never refuses its own commits
                # while the router still trusts its heartbeats.
                lease_ticks = heartbeat_miss + 2
            if lease_ticks <= heartbeat_miss:
                raise ValueError(
                    f"lease_ticks ({lease_ticks}) must exceed "
                    f"heartbeat_miss ({heartbeat_miss}): a lease "
                    "shorter than the detection window makes a healthy "
                    "replica refuse its own commits"
                )
        if redispatch == "discard" and faults is not None \
                and faults.pending("fleet.resume"):
            # Same contract, resume leg: discard re-dispatches never
            # verify a committed context (there is none to verify), so
            # a fleet.resume fault would silently never fire.
            raise ValueError(
                "kv_corrupt@fleet.resume needs --redispatch resume — "
                "discard re-dispatches carry no committed context, so "
                "the fault would silently never fire"
            )
        self.compute_factory = compute_factory
        # prefix/sched_policy: each replica gets its own
        # PrefixCache over its own pool (a restarted incarnation comes
        # back cold) and, with sched_policy, an SLOScheduler instead of
        # FCFS — the same upgrade engine.run applies single-engine.
        # spec: per-replica speculative decoding — same
        # geometry discipline as prefix: every replica (and every
        # restarted incarnation) speculates identically, so the
        # dispatch trace stays a pure function of (seed, plan, shape).
        # host_pages: per-replica host spill tier, part of
        # the common geometry like the page pool — every incarnation
        # gets its own bounded tier, and a cold restart drops it (the
        # tier dies with the replica, like its pools).
        self.geometry = dict(slots=slots, num_pages=num_pages,
                             page_size=page_size, max_len=max_len,
                             max_queue=max_queue, check_every=check_every,
                             prefix=prefix, policy=sched_policy,
                             spec=spec, spec_k=spec_k,
                             spec_ngram=spec_ngram, host_pages=host_pages)
        self.redispatch = redispatch
        self.tick_s = tick_s
        self.faults = faults
        self.clock = clock if clock is not None else FakeClock()
        self.registry = registry
        self.fleet_sink = fleet_sink
        self.replica_tick_sink = replica_tick_sink
        self.router = Router(policy, heartbeat_miss=heartbeat_miss,
                             backoff_base=backoff_base, max_flaps=max_flaps,
                             jitter=jitter, page_size=page_size)
        # Online autoscaler: an object with step()/
        # observe_terminal() (serve/autoscale.py's Autoscaler) or None.
        # It only ever acts through the SAME join/leave machinery the
        # fault plan drives, so replay needs no new event kinds. On a
        # pooled fleet it governs the decode pool (prefill sizing stays
        # the operator's — the autosize frontier picks the split).
        self.autoscaler = autoscale
        # Cache-aware routing counters: cumulative fleet-
        # wide hit accounting plus the per-replica split the ROUTER
        # top-panel bars read. Stamped (zeros) in every summary — the
        # gate contract.
        self.route_hits = self.route_misses = 0
        self.route_hit_tokens = 0
        self._route_by: dict[str, list[int]] = {}  # name -> [hits, disp]
        self._route_hits_tick: list[list] = []     # [rid, name, matched]
        # Autoscale counters: scale_crc chains every
        # (tick, direction, name) decision in commit order — the
        # scale-event log as ONE gated number.
        self.scale_ups = self.scale_downs = 0
        self.scale_crc = 0
        self.replica_ticks = 0
        self.events: list[dict] = []       # obs `fault` field dicts
        self.replica_log: list[dict] = []  # obs `replica` field dicts
        self.transport_log: list[dict] = []  # obs `transport` dicts
        self.dispatch_trace: list[tuple] = []
        self.dispatches = 0
        self.redispatches = 0
        self.fenced_discards = 0
        self.crashes = self.joins = self.leaves = 0
        self.restarts = self.circuit_opens = 0
        # Disaggregated serving: pool membership plan, the
        # in-flight handoff table, and the degradation latches.
        self.pools = pools
        self.handoff_ticks = handoff_ticks
        self._phase_of: dict[str, str | None] = {}
        self._handoffs: dict[int, Handoff] = {}
        self._handoff_seq = 0
        self._resume_seq = 0
        self.handoffs = self.handoff_pages = 0
        self.handoffs_aborted = self.kv_refusals = 0
        # Unique rids served unified because a pool was empty — a SET,
        # so a request that degrades repeatedly (handoff abort, then
        # again at its re-prefill's completion) counts once, matching
        # the summary key's "requests served unified" semantics.
        self._degraded_rids: set[int] = set()
        self._degraded = {"prefill": False, "decode": False}
        # obs `handoff` field dicts. log_handoffs=False keeps the list
        # EMPTY (summary-mode storms: ~2 retained dicts per transfer
        # would be retained-container GC cost for a log nothing
        # reads); the summary counters and registry
        # increments are unaffected.
        self.log_handoffs = log_handoffs
        self.handoff_log: list[dict] = []
        self._handoff_started_tick: list[tuple[int, str]] = []
        self._handoff_done_tick: list[tuple[int, str]] = []
        self._handoff_aborted_tick: list[tuple[int, str]] = []
        # Placement/re-target markers: a placement allocates
        # the destination pages and an un-place (bind-time re-target)
        # releases them, both without any other trail event — the
        # replay reconstruction needs the moments to account the
        # receiver pool's free count.
        self._handoff_placed_tick: list[tuple[int, str]] = []
        self._handoff_unplaced_tick: list[tuple[int, str]] = []
        # Flight-recorder chain: crc32 chained over every
        # per-tick digest in emission order (fleet/router digest, then
        # each stepped replica's) — the summary's state_crc.
        self.state_chain = 0
        self._retired = [0, 0, 0]  # decode_ticks, prefill_chunks, preempts
        self._retired_prefix = empty_prefix_fields()
        self._retired_spec = empty_spec_fields()
        self._failed_over_tick: list[tuple[int, str]] = []
        self._auth: dict[int, Request] = {}
        # rid -> (holding replica, live local copy): where a cancel()
        # must land (the authoritative object the caller holds is a
        # different Request than the replica-local one in flight).
        self._holder: dict[int, tuple[Replica, Request]] = {}
        self._zombies: list[Replica] = []
        self._pending_restarts: list[tuple[float, str]] = []
        self._next_idx = 0
        self._tick = 0
        # Lossy transport: the deterministic message bus the
        # whole control plane speaks over when transport=True. All the
        # state below is inert (bus None, zeros) on a direct-call
        # fleet.
        self.lease_ticks = lease_ticks if transport else 0
        self.bus: TransportBus | None = None
        if transport:
            self.bus = TransportBus(faults=faults, rto_base=rto_base,
                                    plant=_chaos_plant,
                                    on_event=self._on_bus_event)
            self.bus.register("router", self._router_msg)
        self.lease_refusals = 0
        # Incarnation counter per NAME (the bus endpoint "<name>#<gen>"
        # — a restarted replica is a different destination).
        self._gen_of: dict[str, int] = {}
        # rid -> (epoch, {pos: (tok, now)}): commits that arrived ahead
        # of a gap (reordered/delayed); drained in order as the gap
        # fills. rid -> (epoch, payload): terminal claims waiting for
        # their trailing commits.
        self._commit_stash: dict[int, tuple[int, dict]] = {}
        self._pending_terms: dict[int, tuple[int, dict]] = {}
        # Terminal applications since the last drain (the bus delivers
        # inline mid-step; the loop drains these where the direct path
        # would have called _sync_terminal).
        self._synced_now: list[Request] = []
        # This tick's [rid, name] dispatch deliveries to CURRENT
        # incarnations — the fleet-record marker the replay mirror
        # sources queue membership from under transport.
        self._t_delivered: list[list] = []
        # False-positive failovers: (replica, name) pairs
        # declared dead by heartbeat staleness while actually ALIVE
        # behind a partition. They keep stepping off-trail (like
        # post-failover zombies) until their lease lapses — every
        # commit they attempt must be lease/fence-refused.
        self._isolated: list[tuple[Replica, str]] = []
        self._partition_events: list[dict] = []
        self._lease_refused_tick: list[list] = []
        if pools is None:
            phases: list[str | None] = [None] * replicas
        else:
            # Deterministic initial membership: r0..r{P-1} prefill,
            # then the decode pool — names keep their phase across
            # restarts (self._phase_of).
            phases = (["prefill"] * pools["prefill"]
                      + ["decode"] * pools["decode"])
        for phase in phases:
            self._join(tick=0, now=0.0, log=False, phase=phase)

    # -- membership ----------------------------------------------------

    def _new_replica(self, name: str) -> Replica:
        # The tier fault hook is fleet-shared: every
        # replica's tier polls the ONE injector, each with its own
        # spill sequence — a `kv_corrupt@tier.spill:N` fires on the
        # first tier to reach spill N (deterministic: the fleet steps
        # replicas in name order on one clock).
        poll = None
        if self.faults is not None and self.geometry["host_pages"] > 0:
            poll = functools.partial(self.faults.poll, TIER_SPILL_SITE)
        rep = Replica(name, self.compute_factory(name),
                      clock=self.clock, phase=self._phase_of.get(name),
                      tier_fault_poll=poll, **self.geometry)
        rep.core.on_emit = self._make_emit(rep)
        rep.core.on_prefill_done = self._make_prefill_done(rep)
        if self.bus is not None:
            # Fresh incarnation, fresh bus endpoint: a message in
            # flight to the previous incarnation can never reach this
            # one. The initial lease covers the joining tick (renewed
            # by the first hb_ack).
            rep.gen = self._gen_of.get(name, -1) + 1
            self._gen_of[name] = rep.gen
            rep.lease_until = self._tick + self.lease_ticks
            self.bus.register(self._endpoint(rep),
                              self._make_replica_msg(rep))
        return rep

    def _join(self, *, tick: int, now: float, log: bool = True,
              phase: str | None = None) -> Replica:
        name = f"r{self._next_idx}"
        self._next_idx += 1
        self._phase_of[name] = phase
        rep = self._new_replica(name)
        self.router.register(rep, tick=tick)
        self.joins += log
        if log:
            self._log_replica(name, "join", tick, now,
                              **({"pool": phase} if phase else {}))
        return rep

    def _log_replica(self, name: str, kind: str, tick: int, now: float,
                     **extra) -> None:
        self.replica_log.append({
            "name": name, "kind": kind, "tick": tick,
            "now": round(now, 4), **extra,
        })
        if self.registry is not None:
            self.registry.inc(f"fleet.replica_{kind}")

    # -- fenced commits ------------------------------------------------

    def _make_emit(self, replica: Replica):
        name = replica.name

        def emit(local: Request, tok: int, now: float) -> None:
            if self.bus is not None:
                # Lease fence, sender side: past its lease a
                # replica refuses its OWN commit — it does not even
                # send. ReplicaCore._emit appended tok to local.out
                # before calling us, so the commit's position is
                # len-1; the router applies commits in position order
                # (gap-stashed), so reordered delivery cannot misfile
                # a token.
                if self._tick >= replica.lease_until:
                    self.lease_refusals += 1
                    self._lease_refused_tick.append([local.rid, name])
                    return
                self.bus.send(
                    "commit", self._endpoint(replica), "router",
                    {"rid": local.rid, "epoch": local._fleet_epoch,
                     "pos": len(local.out) - 1, "tok": tok, "now": now,
                     "name": name},
                    tick=self._tick,
                    key=(local.rid, "c", local._fleet_epoch,
                         len(local.out) - 1),
                    reliable=True)
                return
            if self.router.fence_ok(local.rid, name, local._fleet_epoch):
                auth = self._auth[local.rid]
                auth.out.append(tok)
                if auth.first_token_at is None:
                    auth.first_token_at = now
            else:
                self.fenced_discards += 1

        return emit

    def _sync_terminal(self, replica: Replica, locals_,
                       now: float) -> list[Request]:
        """Apply a replica's newly terminal local requests to the
        authoritative records — through the fence, so a zombie's
        terminal claims are refused like its tokens. Returns the
        authoritative requests that became terminal by THIS call (the
        fence-accepted set): the caller counts them toward run
        completion and folds them into the tick's `terminal` entries
        for the streaming SLO layer."""
        synced: list[Request] = []
        if self.registry is not None:
            # Lazy: the sim path need not load the engine.
            from .engine import _observe_request
        for local in locals_:
            if not self.router.fence_ok(local.rid, replica.name,
                                        local._fleet_epoch):
                self.fenced_discards += 1
                continue
            auth = self._auth[local.rid]
            auth.status = local.status
            auth.fail_reason = local.fail_reason
            auth.finished_at = local.finished_at
            auth.preemptions += local.preemptions
            auth.quota_wait_s += local.quota_wait_s
            if auth.admitted_at is None:
                auth.admitted_at = local.admitted_at
            if self.registry is not None:
                _observe_request(self.registry, auth)
            # A terminal rid holds no replica: dropping the holder entry
            # releases the (Replica, local) pair — with EngineCompute a
            # dead incarnation's whole PagedEngine cache would otherwise
            # stay pinned for the rest of the run via finished rids.
            self._holder.pop(local.rid, None)
            synced.append(auth)
        return synced

    # -- lossy transport ------------------------------------

    @staticmethod
    def _endpoint(rep: Replica) -> str:
        return f"{rep.name}#{rep.gen}"

    def _on_bus_event(self, kind: str, fields: dict) -> None:
        # Partition open/heal markers, drained onto the replica log (+
        # registry) by the run loop once it knows the tick's `now`.
        self._partition_events.append({"kind": kind, **fields})

    def _router_msg(self, msg, tick: int) -> None:
        """The router's bus endpoint: heartbeats, commits, terminal
        claims. Commits and terminals pass the SAME generation fence
        the direct path uses — the lease (sender side) and the fence
        (receiver side) together are the exactly-once proof."""
        kind, p = msg.kind, msg.payload
        if kind == "hb":
            member = self.router.members.get(p["name"])
            if member is None:
                return  # unknown / failed-over sender: no ack, no renewal
            rep = member.replica
            if rep.gen != p["gen"] or not rep.alive:
                return
            # Guard against reordered/delayed heartbeats moving
            # last_beat backwards.
            if p["tick"] > member.last_beat:
                self.router.beat(p["name"], p["tick"])
            self.bus.send("hb_ack", "router", msg.src,
                          {"until": tick + self.lease_ticks}, tick=tick)
            return
        if kind == "commit":
            rid, epoch = p["rid"], p["epoch"]
            if not self.router.fence_ok(rid, p["name"], epoch):
                self.fenced_discards += 1
                return
            auth = self._auth[rid]
            if auth.terminal:
                # Post-terminal straggler (its dedup keys were
                # released): the request already left the system.
                return
            pos = p["pos"]
            if pos > len(auth.out):
                # Reordered ahead of a gap: stash until the gap fills.
                # (pos < len can only happen when dedup is bypassed —
                # the skip-dedup canary — and then the duplicate
                # append below is exactly the double-generation the
                # chaos oracle must catch: dedup is load-bearing.)
                ep0, stash = self._commit_stash.get(rid, (epoch, None))
                if stash is None or ep0 != epoch:
                    stash = {}
                    self._commit_stash[rid] = (epoch, stash)
                stash[pos] = (p["tok"], p["now"])
                return
            self._apply_commit(auth, p["tok"], p["now"])
            ep0, stash = self._commit_stash.get(rid, (epoch, None))
            if stash is not None and ep0 == epoch:
                while True:
                    nxt = stash.pop(len(auth.out), None)
                    if nxt is None:
                        break
                    self._apply_commit(auth, nxt[0], nxt[1])
                if not stash:
                    del self._commit_stash[rid]
            self._try_pending_term(rid, epoch)
            return
        if kind == "terminal":
            rid, epoch = p["rid"], p["epoch"]
            if not self.router.fence_ok(rid, p["name"], epoch):
                self.fenced_discards += 1
                return
            if self._auth[rid].terminal:
                return
            if len(self._auth[rid].out) < p["outlen"]:
                # Trailing commits still in flight: exactly-once means
                # the terminal waits for them (retransmission
                # guarantees they arrive while the fence holds).
                self._pending_terms[rid] = (epoch, p)
                return
            self._apply_terminal_msg(p)

    @staticmethod
    def _apply_commit(auth: Request, tok: int, now: float) -> None:
        auth.out.append(tok)
        if auth.first_token_at is None:
            auth.first_token_at = now

    def _try_pending_term(self, rid: int, epoch: int) -> None:
        held = self._pending_terms.get(rid)
        if held is None or held[0] != epoch:
            return
        p = held[1]
        if len(self._auth[rid].out) < p["outlen"]:
            return
        del self._pending_terms[rid]
        # The fence can have moved while the terminal waited (a
        # failover re-dispatched the rid): re-check before applying.
        if not self.router.fence_ok(rid, p["name"], epoch):
            self.fenced_discards += 1
            return
        self._apply_terminal_msg(p)

    def _apply_terminal_msg(self, p: dict) -> None:
        """The bus twin of one _sync_terminal iteration (fence already
        checked): fold the replica-local terminal outcome into the
        authoritative record, exactly once."""
        auth = self._auth[p["rid"]]
        auth.status = p["status"]
        auth.fail_reason = p["fail_reason"]
        auth.finished_at = p["finished_at"]
        auth.preemptions += p["preemptions"]
        auth.quota_wait_s += p["quota_wait_s"]
        if auth.admitted_at is None:
            auth.admitted_at = p["admitted_at"]
        if self.registry is not None:
            from .engine import _observe_request
            _observe_request(self.registry, auth)
        self._holder.pop(p["rid"], None)
        self._commit_stash.pop(p["rid"], None)
        # Terminal rid: its dedup keys are dead weight (the
        # auth.terminal guard above catches post-release stragglers).
        self.bus.release_keys(p["rid"])
        self._synced_now.append(auth)

    def _drain_synced(self) -> list[Request]:
        synced, self._synced_now = self._synced_now, []
        return synced

    def _make_replica_msg(self, rep: Replica):
        def handle(msg, tick: int) -> None:
            if msg.kind == "hb_ack":
                rep.lease_until = max(rep.lease_until,
                                      msg.payload["until"])
                return
            if msg.kind == "dispatch":
                local = msg.payload
                rep.core.submit(local)
                if local.cancel_requested:
                    # A cancel that landed while the dispatch was in
                    # flight re-arms the sweep at delivery (the
                    # send-time flag was consumed by earlier steps).
                    rep.core.flag_cancel()
                member = self.router.members.get(rep.name)
                if member is not None and member.replica is rep:
                    # Delivery marker for the replay mirror — CURRENT
                    # incarnations only: a delivery to an isolated
                    # stale incarnation is off-trail (its records
                    # never sink), like a post-failover zombie's work.
                    self._t_delivered.append([local.rid, rep.name])
        return handle

    def _send_terminals(self, rep: Replica, locals_, tick: int) -> None:
        """Bus twin of the _sync_terminal CALL: each newly terminal
        local becomes a reliable terminal claim — unless the sender's
        lease lapsed, in which case it refuses to claim at all (the
        failover will re-dispatch the rid; lease refusal is what makes
        the false-positive path double-generation-free)."""
        for local in locals_:
            if tick >= rep.lease_until:
                self.lease_refusals += 1
                self._lease_refused_tick.append([local.rid, rep.name])
                continue
            self.bus.send(
                "terminal", self._endpoint(rep), "router",
                {"rid": local.rid, "epoch": local._fleet_epoch,
                 "name": rep.name, "outlen": len(local.out),
                 "status": local.status, "fail_reason": local.fail_reason,
                 "finished_at": local.finished_at,
                 "preemptions": local.preemptions,
                 "quota_wait_s": local.quota_wait_s,
                 "admitted_at": local.admitted_at},
                tick=tick, key=(local.rid, "t", local._fleet_epoch),
                reliable=True)

    # -- prefill->decode KV handoff -------------------------

    def _log_handoff(self, ho: Handoff, state: str, tick: int, now: float,
                     **extra) -> None:
        if self.log_handoffs:
            self.handoff_log.append({
                "rid": ho.rid, "hid": ho.hid, "state": state,
                "src": ho.src, "dst": ho.dst, "pages": len(ho.pages),
                "tick": tick, "now": round(now, 4), **extra,
            })
        if self.registry is not None:
            self.registry.inc(f"fleet.handoff_{state}")

    def _note_degraded(self, pool: str, tick: int, now: float) -> None:
        """Latch + log a pool-collapse degradation exactly once per
        episode: the fleet serves affected requests unified instead of
        stalling; `_check_restored` clears the latch when the pool
        repopulates (restart / join)."""
        if not self._degraded[pool]:
            self._degraded[pool] = True
            self._log_replica(pool, "degraded", tick, now, pool=pool)
            if self.registry is not None:
                self.registry.inc("fleet.degraded")

    def _check_restored(self, tick: int, now: float) -> None:
        if self.pools is None:
            return
        for pool in ("prefill", "decode"):
            if self._degraded[pool] and self.router.dispatchable(pool):
                self._degraded[pool] = False
                self._log_replica(pool, "restored", tick, now, pool=pool)

    def _make_prefill_done(self, replica: Replica):
        def on_done(core: ReplicaCore, slot, now: float) -> bool:
            return self._begin_handoff(replica, core, slot, now)
        return on_done

    def _begin_handoff(self, replica: Replica, core: ReplicaCore, slot,
                       now: float) -> bool:
        """A prefill-pool slot just completed its prefill with decode
        work remaining: seal its page set and open a handoff, or — with
        the decode pool EMPTY — degrade this request to unified serving
        on the prefill replica (return False: the slot keeps decoding
        locally instead of stalling behind a pool that may never come
        back)."""
        if self.pools is None or replica.phase != "prefill":
            return False
        member = self.router.members.get(replica.name)
        if (member is None or member.replica is not replica
                or not replica.alive):
            # A ZOMBIE (or already-failed-over) incarnation completing
            # a prefill must not open a handoff: the failover already
            # re-dispatched its requests, and a zombie-initiated
            # transfer would double-dispatch the rid the moment it
            # aborted (sender_dead) — the exactly-once violation the
            # blame-conservation acceptance caught. The zombie decodes
            # locally instead; every commit it attempts is fenced off.
            return False
        rid0 = slot.req.rid
        if rid0 in self._handoffs or self._auth[rid0].terminal:
            # Defensive: one in-flight transfer per rid, never one for
            # a request that already left the system.
            return False
        tick = self._tick
        if not self.router.dispatchable("decode"):
            self._note_degraded("decode", tick, now)
            self._degraded_rids.add(slot.req.rid)
            return False
        local = slot.req
        rid = local.rid
        hid = self._handoff_seq
        self._handoff_seq += 1
        cached = slot.cached
        owner = handoff_owner(rid, hid)
        # The seal-time integrity stamps, from the SENDER's view of the
        # context (rows 0..cached-1; the just-emitted token is not yet
        # a cache row).
        crcs = page_crcs(context_tokens(local.prompt, local.out), cached,
                         self.geometry["page_size"])
        drop = False
        if self.faults is not None:
            for f in self.faults.poll("fleet.handoff", hid):
                if f.kind == "handoff_drop":
                    drop = True
                elif f.kind == "kv_corrupt":
                    page = min(int(f.arg("page", 0)), len(crcs) - 1)
                    crcs[page] ^= 0x5A5A5A5A
                else:
                    raise ValueError(
                        f"fault kind {f.kind!r} is inert at fleet.handoff"
                    )
        pages, private, nodes = core.sched.detach_for_handoff(slot, owner)
        # Nobody may commit for this rid while its KV is in flight: the
        # per-handoff fence. The receiver gets a fresh epoch at
        # completion; an abort re-grants via the re-dispatch path.
        self.router.revoke(rid)
        auth = self._auth[rid]
        auth.preemptions += local.preemptions
        auth.quota_wait_s += local.quota_wait_s
        if auth.admitted_at is None:
            auth.admitted_at = local.admitted_at
        self._holder.pop(rid, None)
        ho = Handoff(hid=hid, rid=rid, src=replica.name, src_rep=replica,
                     pages=pages, private=private, nodes=nodes,
                     cached=cached, crcs=crcs, owner=owner, drop=drop)
        self._handoffs[rid] = ho
        self._handoff_started_tick.append((rid, replica.name))
        self._log_handoff(ho, "started", tick, now)
        return True

    @staticmethod
    def _can_take(member, ho: Handoff, req: Request) -> bool:
        """THE receiver-capability predicate, shared by handoff
        placement and the bind-time re-target so the two can never
        disagree: a receiver must be able to TAKE the transfer — page
        capacity for the whole set, a free slot, and its own pool's
        admission quota — not merely hold its pages."""
        sched = member.replica.core.sched
        return (member.replica.alive
                and sched.pool.free_pages >= len(ho.pages)
                and any(s.free for s in sched.slots)
                and sched.transfer_quota_ok(req))

    def _src_live(self, ho: Handoff) -> bool:
        m = self.router.members.get(ho.src)
        return (m is not None and m.replica is ho.src_rep
                and m.replica.alive)

    def _dst_live(self, ho: Handoff) -> bool:
        m = self.router.members.get(ho.dst)
        return (m is not None and m.replica is ho.dst_rep
                and m.replica.alive)

    def _abort_handoff(self, ho: Handoff, reason: str, tick: int,
                       now: float, redispatch_q: deque) -> None:
        """Resolve a failed transfer to exactly-once: release whichever
        ends still live (a dead incarnation's pool died with it — the
        receiver's partial adoption is revoked, the sender's sealed
        pages freed), then re-enter the fleet's re-dispatch queue —
        the request re-prefills elsewhere under a fresh fence epoch.
        A corrupted or dropped page set is never decoded."""
        if self._src_live(ho):
            ho.src_rep.core.sched.release_handoff(ho.private, ho.nodes,
                                                  ho.owner)
        if ho.dst_pages and self._dst_live(ho):
            ho.dst_rep.core.sched.pool.free(list(ho.dst_pages), ho.owner)
        ho.state = "aborted"
        self.handoffs_aborted += 1
        auth = self._auth[ho.rid]
        # Resume-path integrity stamp (the handoff abort IS a failover
        # for this rid): the committed context is verified before the
        # re-dispatch re-prefills it.
        auth._ctx_crc = context_crc(auth.prompt, auth.out)
        redispatch_q.append(auth)
        del self._handoffs[ho.rid]
        self._handoff_aborted_tick.append((ho.rid, reason))
        self._log_handoff(ho, "aborted", tick, now, reason=reason)

    def _process_handoffs(self, tick: int, now: float,
                          redispatch_q: deque) -> None:
        """Advance every in-flight handoff one fleet tick (rid order —
        deterministic). Runs BEFORE dispatch, so an abort's re-dispatch
        and a completion's first decode can land this same tick, and
        the tick's fleet record (emitted after) carries the markers
        ordered ahead of any replica emission."""
        for rid in sorted(self._handoffs):
            ho = self._handoffs[rid]
            if not self._src_live(ho):
                # Sender died mid-handoff: the receiver's partial
                # adoption is revoked and the request re-prefills
                # elsewhere (the fence + re-dispatch path, extended
                # to the handoff site).
                self._abort_handoff(ho, "sender_dead", tick, now,
                                    redispatch_q)
                continue
            if ho.cancelled:
                self._abort_handoff(ho, "cancelled", tick, now,
                                    redispatch_q)
                continue
            if ho.state == "pending":
                auth = self._auth[rid]
                pool_members = self.router.dispatchable("decode")
                cands = [m for m in pool_members
                         if self._can_take(m, ho, auth)]
                if not pool_members:
                    # Decode pool collapsed while the transfer waited:
                    # degrade — re-prefill lands unified via dispatch.
                    self._note_degraded("decode", tick, now)
                    self._degraded_rids.add(rid)
                    self._abort_handoff(ho, "decode_pool_empty", tick,
                                        now, redispatch_q)
                    continue
                if not cands:
                    continue  # capacity in flight — retry next tick
                member = min(cands,
                             key=lambda m: (m.replica.load(), m.name))
                dst_pages = member.replica.core.sched.pool.try_alloc(
                    len(ho.pages), ho.owner)
                assert dst_pages is not None
                # Counts toward same-tick load like a dispatch: several
                # placements in one tick spread instead of dog-piling
                # the stalest gauge.
                member.replica.pending_dispatches += 1
                ho.dst = member.name
                ho.dst_rep = member.replica
                ho.dst_pages = dst_pages
                ho.state = "copying"
                ho.ticks_left = self.handoff_ticks
                self._handoff_placed_tick.append((rid, member.name))
                continue
            # state == "copying": the transfer is in flight.
            if not self._dst_live(ho):
                # Receiver died mid-handoff: the sender's sealed pages
                # are released and the router re-targets via the
                # re-dispatch path.
                ho.dst_pages = []  # died with the incarnation's pool
                self._abort_handoff(ho, "receiver_dead", tick, now,
                                    redispatch_q)
                continue
            if ho.ticks_left > 0:
                ho.ticks_left -= 1
            if ho.ticks_left > 0:
                continue
            if ho.drop:
                self._abort_handoff(ho, "dropped", tick, now,
                                    redispatch_q)
                continue
            auth = self._auth[rid]
            if not ho.copied:
                # Adoption check FIRST: a page set whose stamps do not
                # match the authoritative context is refused — the
                # request re-prefills, garbage is never decoded.
                if not verify_page_crcs(
                        ho.crcs, context_tokens(auth.prompt, auth.out),
                        ho.cached, self.geometry["page_size"]):
                    self.kv_refusals += 1
                    self._abort_handoff(ho, "kv_corrupt", tick, now,
                                        redispatch_q)
                    continue
                ho.dst_rep.core.compute.adopt_pages(
                    ho.src_rep.core.compute, ho.pages, ho.dst_pages)
                ho.copied = True
            local = Request(rid=rid, prompt=auth.prompt,
                            max_new_tokens=auth.max_new_tokens,
                            arrival=auth.arrival, deadline=auth.deadline,
                            session=auth.session, tenant=auth.tenant)
            local.out = list(auth.out)
            local.admitted_at = auth.admitted_at
            slot = ho.dst_rep.core.sched.bind_transfer(
                local, ho.dst_pages, ho.cached, ho.owner, now)
            if slot is None:
                # The receiver filled up (slots or quota) between
                # placement and completion. If ANOTHER decode replica
                # could take the transfer right now, re-target instead
                # of pinning pages on the stalled one: release the
                # destination pages and return to pending (the content
                # re-copies — correctness over the wasted copy).
                others = [
                    m for m in self.router.dispatchable("decode")
                    if m.replica is not ho.dst_rep
                    and self._can_take(m, ho, local)
                ]
                if others:
                    ho.dst_rep.core.sched.pool.free(list(ho.dst_pages),
                                                    ho.owner)
                    self._handoff_unplaced_tick.append((rid, ho.dst))
                    ho.dst = None
                    ho.dst_rep = None
                    ho.dst_pages = []
                    ho.copied = False
                    ho.state = "pending"
                continue
            epoch = self.router.grant(rid, ho.dst)
            local._fleet_epoch = epoch
            self._holder[rid] = (ho.dst_rep, local)
            if auth.cancel_requested:
                local.cancel()
                ho.dst_rep.core.flag_cancel()
            ho.state = "done"
            self.handoffs += 1
            self.handoff_pages += len(ho.pages)
            if self._src_live(ho):
                ho.src_rep.core.sched.release_handoff(
                    ho.private, ho.nodes, ho.owner)
            del self._handoffs[rid]
            self._handoff_done_tick.append((rid, ho.dst))
            self._log_handoff(ho, "done", tick, now)

    # -- dispatch ------------------------------------------------------

    def _dispatch(self, req: Request, *, tick: int,
                  redispatch: bool) -> str | None:
        """Place `req` on a replica; returns the member NAME (the
        flight-recorder record needs the routing decision's target, not
        just that one was made) or None when nothing can take work."""
        phase = "prefill" if self.pools is not None else None
        member = self.router.pick(req, phase)
        if member is None and phase is not None:
            # Prefill pool empty (crashes / circuit breaks / leaves):
            # degrade this request to unified serving on whatever can
            # take work instead of stalling behind the dead pool.
            member = self.router.pick(req)
            if member is not None:
                now = self.clock() - self._t0
                self._note_degraded("prefill", tick, now)
                self._degraded_rids.add(req.rid)
        if member is None:
            return None
        if self.router.policy == "cache_aware":
            # Route accounting: last_route_overlap is the
            # matched prefix tokens of the pick above (0 on fallback);
            # a degraded unified re-pick overwrote it, so the read here
            # always describes the decision that actually placed `req`.
            matched = self.router.last_route_overlap
            st = self._route_by.setdefault(member.name, [0, 0])
            st[1] += 1
            if matched > 0:
                st[0] += 1
                self.route_hits += 1
                self.route_hit_tokens += matched
                self._route_hits_tick.append([req.rid, member.name,
                                              matched])
            else:
                self.route_misses += 1
            if self.registry is not None:
                self.registry.inc("fleet.route_hits" if matched > 0
                                  else "fleet.route_misses")
        if redispatch and self.redispatch == "resume" and req.out:
            # KV transfer integrity, failover leg: the
            # committed context a resume re-dispatch re-prefills is
            # verified against the stamp taken when the request was
            # stranded — it used to be re-adopted unchecked. A
            # mismatch (or an injected kv_corrupt@fleet.resume) falls
            # back to discard semantics: the tokens are regenerated
            # from the prompt, never decoded as-is.
            stamp = getattr(req, "_ctx_crc", None)
            if self.faults is not None:
                for f in self.faults.poll("fleet.resume",
                                          self._resume_seq):
                    if f.kind != "kv_corrupt":
                        raise ValueError(
                            f"fault kind {f.kind!r} is inert at "
                            "fleet.resume"
                        )
                    stamp = (stamp ^ 0x5A5A5A5A) if stamp is not None \
                        else 1
            self._resume_seq += 1
            if stamp is None or stamp != context_crc(req.prompt, req.out):
                self.kv_refusals += 1
                self.events.append({
                    "kind": "resume_refused", "id": req.rid,
                    "tokens_discarded": len(req.out),
                })
                req.out.clear()
                req.first_token_at = None
        epoch = self.router.grant(req.rid, member.name)
        if redispatch and self.redispatch == "discard":
            req.out.clear()
            req.first_token_at = None
        local = Request(rid=req.rid, prompt=req.prompt,
                        max_new_tokens=req.max_new_tokens,
                        arrival=req.arrival, deadline=req.deadline,
                        session=req.session, tenant=req.tenant)
        local.out = list(req.out)
        # A request that was ever admitted keeps that mark across
        # failover (even under discard, which regenerates the tokens):
        # enforce_queue_bound exempts admitted_at-bearing requests, and
        # a re-dispatch must never be backpressure-rejected as a fresh
        # arrival when the fleet already served tokens for it.
        local.admitted_at = req.admitted_at
        local._fleet_epoch = epoch
        if self.bus is not None:
            # Bus-routed dispatch: a reliable keyed message
            # to the target's CURRENT incarnation endpoint. Inline
            # delivery at zero faults is the direct submit(); under
            # faults the message can be dropped (retransmitted),
            # delayed, or duplicated (deduped at the endpoint).
            self.bus.send("dispatch", "router",
                          self._endpoint(member.replica), local,
                          tick=tick, key=(req.rid, "d", epoch),
                          reliable=True)
        else:
            member.replica.core.submit(local)
        member.replica.pending_dispatches += 1
        self._holder[req.rid] = (member.replica, local)
        if req.cancel_requested:
            # A cancel that landed while the rid awaited (re-)dispatch
            # carries over to the new incarnation.
            local.cancel()
            member.replica.core.flag_cancel()
        kind = "redispatch" if redispatch else "dispatch"
        self.dispatch_trace.append((tick, req.rid, member.name, epoch, kind))
        self.dispatches += not redispatch
        self.redispatches += redispatch
        if self.registry is not None:
            self.registry.inc(f"fleet.{kind}es")
        return member.name

    def cancel(self, rid: int) -> None:
        """Client-side abort of `rid`, fleet-wide: marks the
        authoritative request AND the replica-local copy currently in
        flight (they are distinct objects), and forces that replica's
        sweep on its next step. Callable mid-run from a sink callback
        (the loop invokes sinks every tick); a terminal or unknown rid
        is a no-op, a rid awaiting re-dispatch picks the cancel up at
        dispatch time."""
        auth = self._auth.get(rid)
        if auth is None or auth.terminal:
            return
        auth.cancel()
        ho = self._handoffs.get(rid)
        if ho is not None:
            # Mid-handoff cancel: the transfer aborts at its next
            # processing step and the cancel rides the re-dispatch
            # (the new incarnation sweeps it terminally).
            ho.cancelled = True
            return
        held = self._holder.get(rid)
        if held is not None:
            replica, local = held
            local.cancel()
            replica.core.flag_cancel()

    # -- failure handling ----------------------------------------------

    def _harvest(self, replica: Replica) -> list[Request]:
        """Authoritative requests stranded on a dead/removed replica
        (fence revoked here — a zombie loses commit rights the moment
        failover begins, before the re-dispatch is even placed)."""
        sched = replica.core.sched
        if self.bus is not None:
            # Holder-based harvest: under the lossy bus a
            # dispatch can still be IN FLIGHT to the dead/isolated
            # incarnation (delayed, or dropped and awaiting
            # retransmit) — it exists in no slot or queue, but its rid
            # is stranded all the same. The holder map is the
            # authoritative "who serves rid" record, written at send
            # time; at zero faults it names exactly the slot+queue set
            # the direct path harvests. Undelivered-terminal rids (the
            # local finished but the claim never landed) are stranded
            # too: their holder entry survives because only a
            # fence-accepted terminal apply pops it.
            locals_ = [local for _rid, (rep2, local)
                       in sorted(self._holder.items())
                       if rep2 is replica]
        else:
            locals_ = [s.req for s in sched.slots if s.req is not None]
            locals_ += list(sched.queue)
        stranded = []
        for local in locals_:
            auth = self._auth[local.rid]
            if auth.terminal:
                continue
            auth.preemptions += local.preemptions
            auth.quota_wait_s += local.quota_wait_s
            if auth.admitted_at is None:
                auth.admitted_at = local.admitted_at
            # Resume-path integrity stamp: taken the moment
            # the failover strands the request; verified before the
            # re-dispatch re-prefills the committed context.
            auth._ctx_crc = context_crc(auth.prompt, auth.out)
            stranded.append(auth)
        stranded.sort(key=lambda r: r.rid)
        # Revoke in SORTED order — the order the dead-replica record's
        # `stranded` list carries, so the replay reconstruction chains
        # the identical fence ops (epoch counters are
        # order-independent, only the fence_crc chain cares).
        revoked = (stranded[:-1] if CHAOS_PLANT == "skip-revoke"
                   else stranded)
        for auth in revoked:
            self.router.revoke(auth.rid)
        if self.bus is not None:
            for auth in stranded:
                # Reordered commits / deferred terminals stashed under
                # the just-revoked epoch can never apply — drop them
                # (a live epoch's stash is rebuilt by retransmission).
                self._commit_stash.pop(auth.rid, None)
                self._pending_terms.pop(auth.rid, None)
        return stranded

    def _fail_over(self, member, *, tick: int, now: float,
                   redispatch_q: deque) -> None:
        name = member.name
        self.router.deregister(name)
        self._retire_counts(member.replica)
        stranded = self._harvest(member.replica)
        redispatch_q.extend(stranded)
        # Causal marker: this tick's fleet record names the
        # rids the failover stranded, so an explain tool can end their
        # active segments at the failover and bill the re-dispatch wait
        # + re-prefill to redispatch_replay instead of self-compute.
        self._failed_over_tick.extend((r.rid, name) for r in stranded)
        self._log_replica(name, "dead", tick, now,
                          stranded=[r.rid for r in stranded],
                          **({"draining": True} if member.draining else {}))
        if self.bus is not None:
            rep = member.replica
            if rep.alive:
                # Failure detection is fallible under a lossy transport
                # (late != dead): this member's heartbeats stopped
                # arriving but the replica itself is fine — a
                # FALSE-POSITIVE death declaration. It keeps stepping
                # off-trail until its lease lapses; the lease (sender
                # side) + the revoked fence (receiver side) guarantee
                # none of its commits ever land again.
                self._isolated.append((rep, name))
                self._log_replica(name, "isolated", tick, now,
                                  lease_until=rep.lease_until)
            elif rep not in self._zombies:
                # Truly dead and done stepping: tear down the
                # incarnation's endpoint (pending retransmits TO it are
                # purged — nobody is listening, ever again).
                self.bus.unregister(self._endpoint(rep))
        if member.draining:
            # The operator already asked this replica to leave; its
            # crash completes the departure (in-flight work was just
            # harvested for re-dispatch). Restarting it would override
            # the drain intent with a fresh dispatch-taking member.
            return
        try:
            delay = self.router.record_crash(name)
            self._pending_restarts.append(((self.clock() - self._t0) + delay,
                                           name))
            self._pending_restarts.sort()
            self._log_replica(name, "restart_scheduled", tick, now,
                              delay_s=round(delay, 4))
        except CircuitOpen as e:
            self.circuit_opens += 1
            self._log_replica(name, "circuit_open", tick, now, reason=str(e))

    def _retire_counts(self, replica: Replica) -> None:
        core = replica.core
        self._retired[0] += core.decode_ticks
        self._retired[1] += core.prefill_chunks
        self._retired[2] += core.sched.preemptions
        for k, v in core.prefix_stats().items():
            self._retired_prefix[k] += v
        for k, v in core.spec_stats.items():
            self._retired_spec[k] += v
        # A later zombie step must not re-bank these.
        core.decode_ticks = core.prefill_chunks = 0
        core.sched.preemptions = 0
        core.reset_prefix_stats()
        core.reset_spec_stats()

    def _resolve_fault_target(self, f) -> str:
        """The rN name a crash/leave fault targets. A name that no
        replica has EVER carried is a config error and raises — the
        plan-validation contract is that a fault
        must never silently not fire. A name that existed but is
        currently dead/absent is a legitimate plan/timing race and is
        the caller's no-op."""
        name = f.arg("replica", "r0")
        name = name if isinstance(name, str) else f"r{name}"
        ever = {f"r{i}" for i in range(self._next_idx)}
        if name not in ever:
            raise ValueError(
                f"fault {f.kind}@{f.site}: replica {name!r} has never "
                f"joined this fleet (members ever: r0..r{self._next_idx - 1})"
                " — the fault would silently never fire"
            )
        return name

    def _crash_member(self, member, *, tick: int, now: float,
                      zombie: int = 0) -> None:
        member.replica.alive = False
        self.crashes += 1
        if zombie > 0:
            member.replica.zombie_until = tick + zombie
            self._zombies.append(member.replica)
        self._log_replica(member.name, "crash", tick, now,
                          zombie_ticks=zombie)

    def _apply_fault(self, f, *, tick: int, now: float,
                     redispatch_q: deque) -> None:
        if f.kind == "replica_crash":
            name = self._resolve_fault_target(f)
            member = self.router.members.get(name)
            if member is None or not member.replica.alive:
                return
            self._crash_member(member, tick=tick, now=now,
                               zombie=int(f.arg("zombie_ticks", 0)))
        elif f.kind == "pool_crash":
            # Pool-collapse driver: kill every live member
            # of one phase pool — the degradation path's test vehicle.
            pool = f.arg("pool")
            if self.pools is None or pool not in ("prefill", "decode"):
                raise ValueError(
                    f"fault {f.kind}@{f.site}: pool={pool!r} needs a "
                    "disaggregated fleet with pool 'prefill' or 'decode'"
                )
            for member in list(self.router.members.values()):
                if (member.replica.phase == pool
                        and member.replica.alive):
                    self._crash_member(member, tick=tick, now=now,
                                       zombie=int(f.arg("zombie_ticks",
                                                        0)))
        elif f.kind == "replica_join":
            phase = f.arg("pool")
            if phase is None:
                # A disaggregated fleet's unlabeled join lands in the
                # decode pool (capacity there unblocks handoffs); a
                # unified fleet's join stays phaseless.
                phase = "decode" if self.pools is not None else None
            elif phase not in ("prefill", "decode"):
                raise ValueError(
                    f"fault {f.kind}@{f.site}: pool={phase!r} must be "
                    "'prefill' or 'decode'"
                )
            elif self.pools is None:
                raise ValueError(
                    f"fault {f.kind}@{f.site}: pool={phase!r} on a "
                    "unified fleet — there are no pools to join"
                )
            for _ in range(int(f.arg("replicas", 1))):
                self._join(tick=tick, now=now, phase=phase)
        elif f.kind == "replica_leave":
            name = self._resolve_fault_target(f)
            member = self.router.members.get(name)
            if member is not None and not member.draining:
                member.draining = True
                self.leaves += 1
                self._log_replica(name, "leave", tick, now)

    # -- online autoscaling ---------------------------------

    def _autoscale_step(self, tick: int, now: float,
                        redispatch_q: deque) -> None:
        """One autoscaler consult: fold the live pressure gauges into
        the policy and apply its decision through the SAME membership
        machinery the fault plan drives — a scale-out is a _join (the
        mirrored "join" record), a scale-in drains the least-loaded
        member (the mirrored "leave" record; drain completion
        deregisters it like an operator leave). The scale_up/scale_down
        marker records carry no digested state — obs surfaces read
        them, the replay mirror ignores them."""
        phase = "decode" if self.pools is not None else None
        cands = [m for m in self.router.dispatchable(phase)
                 if m.replica.alive]
        live = len(cands)
        load = sum(m.replica.load() for m in cands) + len(redispatch_q)
        decision = self.autoscaler.step(now=now, live=live, load=load,
                                        dispatched=self.dispatches)
        if decision == "up":
            rep = self._join(tick=tick, now=now, phase=phase)
            self.scale_ups += 1
            self._log_replica(rep.name, "scale_up", tick, now,
                              replicas=live + 1)
            self.scale_crc = zlib.crc32(
                repr((tick, "up", rep.name)).encode(), self.scale_crc)
        elif decision == "down" and cands:
            victim = min(cands, key=lambda m: (m.replica.load(), m.name))
            victim.draining = True
            self.leaves += 1
            self._log_replica(victim.name, "leave", tick, now)
            self.scale_downs += 1
            self._log_replica(victim.name, "scale_down", tick, now,
                              replicas=live - 1)
            self.scale_crc = zlib.crc32(
                repr((tick, "down", victim.name)).encode(), self.scale_crc)

    # -- the loop ------------------------------------------------------

    def _validate(self, requests) -> None:
        """Fail a structurally impossible workload at run() entry,
        before any replica sees it — the same shared check a replica's
        submit() would apply, evaluated against the common geometry
        (every replica owns an identical pool)."""
        g = self.geometry
        usable = PagePool(g["num_pages"]).usable
        for r in requests:
            validate_request(r, max_len=g["max_len"],
                             page_size=g["page_size"], usable=usable)

    def run(self, requests: list[Request]) -> FleetResult:
        reqs = sorted(requests, key=lambda r: (r.arrival, r.rid))
        self._validate(reqs)
        self._auth = {r.rid: r for r in reqs}
        if len(self._auth) != len(reqs):
            raise ValueError("duplicate request ids in the workload")
        pending = deque(reqs)
        redispatch_q: deque[Request] = deque()
        # Arrival announcements: each fleet record names the
        # rids whose arrival fell due since the last one — the tick
        # anchor the explain tools start every blame span at.
        announce = deque((r.arrival, r.rid) for r in reqs)
        clock, tick_s = self.clock, self.tick_s
        self._t0 = t0 = clock()
        n_done = 0
        n_total = len(reqs)
        tick = self._tick
        while n_done < n_total:
            self._tick = tick
            now = clock() - t0
            if self.faults is not None:
                for f in self.faults.fire("fleet.tick", tick):
                    self._apply_fault(f, tick=tick, now=now,
                                      redispatch_q=redispatch_q)
                self.events.extend(self.faults.drain_events())
            pump_synced: list[Request] = []
            if self.bus is not None:
                # Transport tick: poll fleet.transport
                # (partitions open/heal, message effects arm), then
                # pump — due retransmits go back on the wire and due
                # delayed copies deliver. A delivery can complete a
                # request (a deferred terminal whose trailing commits
                # just landed): those count toward run completion here,
                # and ride the fleet record's t_terminal marker.
                self.bus.apply_tick_faults(tick)
                if self.faults is not None:
                    self.events.extend(self.faults.drain_events())
                for ev in self._partition_events:
                    self._log_replica(ev["name"], ev["kind"], tick, now,
                                      **({"heal": ev["heal"]}
                                         if "heal" in ev else {}))
                    self.transport_log.append(
                        {"kind": ev["kind"], "name": ev["name"],
                         "tick": tick, "now": round(now, 6),
                         **({"heal": ev["heal"]} if "heal" in ev else {})})
                self._partition_events.clear()
                self.bus.pump(tick)
                pump_synced = self._drain_synced()
                n_done += len(pump_synced)
                if self.autoscaler is not None:
                    for r in pump_synced:
                        self.autoscaler.observe_terminal(
                            terminal_fields(r), now)
            # Restarts whose backoff elapsed rejoin with fresh state.
            while self._pending_restarts and self._pending_restarts[0][0] <= now:
                _, name = self._pending_restarts.pop(0)
                rep = self._new_replica(name)
                self.router.register(rep, tick=tick)
                # Counted HERE, not at scheduling: a run that ends
                # before the backoff elapses had no restart, and the
                # summary must agree with the replica_log's events.
                self.restarts += 1
                self._log_replica(name, "restart", tick, now)
            # Failure detection: heartbeat staleness, then failover.
            for member in self.router.stale(tick):
                self._fail_over(member, tick=tick, now=now,
                                redispatch_q=redispatch_q)
            # Graceful leave completes when the drain empties — under
            # the bus, only once every terminal CLAIM also landed (an
            # unacked terminal still retransmitting would be lost with
            # the endpoint).
            for member in list(self.router.members.values()):
                if member.draining and member.replica.core.unfinished == 0 \
                        and (self.bus is None
                             or not any(rep2 is member.replica
                                        for rep2, _l in
                                        self._holder.values())):
                    self.router.deregister(member.name)
                    self._retire_counts(member.replica)
                    if self.bus is not None:
                        self.bus.unregister(self._endpoint(member.replica))
                    self._log_replica(member.name, "drain_complete", tick,
                                      now)
            # Online autoscaling: AFTER drain completions
            # and failure handling (the membership it reads is this
            # tick's), BEFORE the fleet record (the digest at emission
            # time already reflects the decision — the replay mirror
            # applies the tick's join/leave events before checking it).
            if self.autoscaler is not None:
                self._autoscale_step(tick, now, redispatch_q)
            # Disaggregation: clear degradation latches for
            # pools that repopulated, then advance every in-flight KV
            # handoff (aborts feed redispatch_q ahead of the dispatch
            # pass below; completions bind decode-ready this tick).
            self._check_restored(tick, now)
            if self._handoffs:
                self._process_handoffs(tick, now, redispatch_q)
            # Dispatch: failovers first (they already waited), then due
            # arrivals, FCFS. A re-dispatch happens EXACTLY once per
            # failover — the queue is drained head-first and a request
            # enters it only via _harvest.
            dispatched, redispatched = [], []
            dispatched_to, redispatched_to = [], []
            while redispatch_q:
                req = redispatch_q[0]
                name = self._dispatch(req, tick=tick, redispatch=True)
                if name is None:
                    break
                redispatch_q.popleft()
                redispatched.append(req.rid)
                # Target + carried context length (post discard/refusal
                # — the replica-local out the new incarnation starts
                # with): what the replay reconstruction re-submits.
                redispatched_to.append([req.rid, name, len(req.out)])
            while pending and pending[0].arrival <= now:
                req = pending[0]
                name = self._dispatch(req, tick=tick, redispatch=False)
                if name is None:
                    break
                pending.popleft()
                dispatched.append(req.rid)
                dispatched_to.append([req.rid, name])
            # The fleet record goes out BEFORE the replicas step: the
            # tick's routing decisions precede, in the JSONL, any token
            # the target replica emits this same tick — which is what
            # lets a trace anchor a discard re-dispatch's token
            # reset ahead of the new replica's first emission.
            failed_over, self._failed_over_tick = self._failed_over_tick, []
            ho_started, self._handoff_started_tick = \
                self._handoff_started_tick, []
            ho_done, self._handoff_done_tick = self._handoff_done_tick, []
            ho_aborted, self._handoff_aborted_tick = \
                self._handoff_aborted_tick, []
            ho_placed, self._handoff_placed_tick = \
                self._handoff_placed_tick, []
            ho_unplaced, self._handoff_unplaced_tick = \
                self._handoff_unplaced_tick, []
            route_hits_tick, self._route_hits_tick = \
                self._route_hits_tick, []
            # Transport markers: this tick's bus state and
            # delivery/retransmit events, drained for the fleet record
            # (pump + dispatch-phase deliveries both happened above).
            transport_fields = None
            t_delivered: list[list] = []
            t_retransmits: list[list] = []
            lease_refused, self._lease_refused_tick = \
                self._lease_refused_tick, []
            if self.bus is not None:
                transport_fields = self.bus.record_fields()
                t_delivered, self._t_delivered = self._t_delivered, []
                t_retransmits = self.bus.drain_retransmits()
            # Flight recorder: the router/fleet state digest
            # at record-emission time — membership, in-flight handoff
            # states, dispatch backlog, and the running fence chain —
            # computed on every run (the chain is gate-pinned on
            # summary-only storms) and stamped on the fleet record.
            members = self.router.members
            mparts = []
            for name in sorted(members):
                m = members[name]
                mparts.append((name, m.replica.phase or "", m.draining,
                               m.replica.alive))
            hparts = []
            if self._handoffs:
                hparts = [(rid, ho.state, ho.src, ho.dst or "")
                          for rid, ho in sorted(self._handoffs.items())]
            fleet_crc = fleet_state_digest(
                mparts, hparts, len(pending),
                [r.rid for r in redispatch_q] if redispatch_q else (),
                self.router.fence_crc,
                transport=(transport_digest_tuple(transport_fields)
                           if transport_fields is not None else None),
            )
            self.state_chain = zlib.crc32(fleet_crc.to_bytes(4, "little"),
                                          self.state_chain)
            if self.fleet_sink is not None:
                arrived_now = []
                while announce and announce[0][0] <= now:
                    arrived_now.append(announce.popleft()[1])
                self.fleet_sink({
                    "tick": tick, "now": round(now, 4),
                    "state_crc": fleet_crc,
                    "replicas": len(self.router.members),
                    "pending": len(pending) + len(redispatch_q),
                    "arrived": arrived_now,
                    "dispatched": dispatched, "redispatched": redispatched,
                    # Routing targets: which replica each
                    # decision placed the rid on — the event the replay
                    # reconstruction sources queue membership from (the
                    # bare rid lists above keep their older shape
                    # for trace/explain/top).
                    "dispatched_to": dispatched_to,
                    "redispatched_to": redispatched_to,
                    "failed_over": [[rid, name]
                                    for rid, name in failed_over],
                    # Handoff markers, ordered in the JSONL
                    # BEFORE any replica record of this tick: a done
                    # marker always precedes the decode pool's first
                    # emission for the rid, which is what lets a trace
                    # anchor the phase transition.
                    "handoff_started": [[rid, src]
                                        for rid, src in ho_started],
                    "handoff_done": [[rid, dst] for rid, dst in ho_done],
                    "handoff_aborted": [[rid, why]
                                        for rid, why in ho_aborted],
                    "handoff_placed": [[rid, dst]
                                       for rid, dst in ho_placed],
                    "handoff_unplaced": [[rid, dst]
                                         for rid, dst in ho_unplaced],
                    "handoffs_inflight": len(self._handoffs),
                    "redispatch": self.redispatch,
                    # Cache-aware routing fields, only under
                    # the policy that produces them: the tick's scoring
                    # wins [rid, replica, matched_tokens] and the
                    # cumulative per-replica [hits, dispatches] split
                    # the ROUTER top panel / report tables read. Extra
                    # fleet-record fields — replay/blame ignore them.
                    **({"route_hits": route_hits_tick,
                        "route": {n: list(st) for n, st in
                                  sorted(self._route_by.items())}}
                       if self.router.policy == "cache_aware" else {}),
                    # Lossy-transport fields, bus runs only:
                    # the digested bus state block, dispatch deliveries
                    # to current incarnations (the mirror's queue-
                    # membership source), pump-applied terminals (the
                    # blame/oracle fold reads them next to the replica
                    # records' fence-accepted sets), and the tick's
                    # retransmit / lease-refusal display markers.
                    **({"transport": transport_fields,
                        "t_delivered": t_delivered,
                        "t_terminal": [terminal_fields(r)
                                       for r in pump_synced],
                        "t_retransmits": t_retransmits,
                        "lease_refused": lease_refused}
                       if self.bus is not None else {}),
                    "load": {m.name: [len(m.replica.core.sched.queue),
                                      sum(1 for s in
                                          m.replica.core.sched.slots
                                          if not s.free),
                                      m.replica.core.sched.pool.free_pages]
                             for m in sorted(self.router.members.values(),
                                             key=lambda m: m.name)},
                })
            # Step every live member (and any zombies — partitioned
            # replicas the router no longer trusts); only live members
            # heartbeat.
            any_work = False
            for member in sorted(self.router.members.values(),
                                 key=lambda m: m.name):
                rep = member.replica
                if not rep.alive:
                    continue
                rec, new_fin, new_drop = rep.step(now)
                # Cumulative live-member step count: the
                # capacity actually spent — what the static-vs-
                # autoscaled acceptance compares. Zombies excluded
                # (their steps serve nobody the fence accepts).
                self.replica_ticks += 1
                if self.bus is None:
                    self.router.beat(member.name, tick)
                    synced = self._sync_terminal(rep, new_fin + new_drop,
                                                 now)
                else:
                    # Heartbeat as a MESSAGE: liveness is
                    # now whatever the router can observe over the
                    # lossy channel — a partition starves last_beat
                    # and staleness declares this member dead even
                    # though it is fine (the false-positive path). The
                    # hb_ack carries the lease renewal back.
                    self.bus.send("hb", self._endpoint(rep), "router",
                                  {"name": member.name, "gen": rep.gen,
                                   "tick": tick}, tick=tick)
                    self._send_terminals(rep, new_fin + new_drop, tick)
                    synced = self._drain_synced()
                n_done += len(synced)
                if self.autoscaler is not None and synced:
                    # Burn-rate pressure feed: the SAME
                    # fence-accepted terminal set the streaming SLO
                    # layer folds — a zombie's refused claims never
                    # push the autoscaler.
                    for r in synced:
                        self.autoscaler.observe_terminal(
                            terminal_fields(r), now)
                any_work = any_work or rec["progressed"] or rep.core.unfinished
                self.state_chain = zlib.crc32(
                    rec["state_crc"].to_bytes(4, "little"), self.state_chain)
                if self.replica_tick_sink is not None:
                    # `terminal` carries the FENCE-ACCEPTED set (the
                    # authoritative requests), not the replica-local
                    # claims: a zombie's post-failover "finished" must
                    # not count as a good SLO event when the commit was
                    # refused.
                    self.replica_tick_sink({
                        "tick": tick, "now": round(now, 4),
                        "mode": f"fleet/{member.name}",
                        **{k: rec[k] for k in
                           ("queue", "running", "free_pages", "admitted",
                            "prefill", "decoded", "preempted",
                            "blocked", "preempted_for", "finished",
                            "aborted", "state_crc")},
                        **({"prefix_hits": rec["prefix_hits"],
                            "prefix": rec["prefix"]}
                           if "prefix_hits" in rec else {}),
                        **({"prefix_readmits": rec["prefix_readmits"]}
                           if "prefix_readmits" in rec else {}),
                        **({"spec": rec["spec"]}
                           if "spec" in rec else {}),
                        "terminal": [terminal_fields(r) for r in synced],
                    })
            for rep in list(self._zombies):
                if tick >= rep.zombie_until:
                    self._zombies.remove(rep)
                    if self.bus is not None:
                        member = self.router.members.get(rep.name)
                        if member is None or member.replica is not rep:
                            # Already failed over: the incarnation is
                            # done stepping — tear down its endpoint.
                            # (Pre-failover expiry keeps it: the
                            # failover's unregister handles it.)
                            self.bus.unregister(self._endpoint(rep))
                    continue
                rec, new_fin, new_drop = rep.step(now)
                # Terminal claims from a zombie are fenced like tokens:
                # before failover revokes its fences the zombie's
                # completions are authoritative commits and must count
                # toward n_done; after revocation they are discarded.
                if self.bus is None:
                    synced = self._sync_terminal(rep, new_fin + new_drop,
                                                 now)
                else:
                    # A zombie never heartbeats (alive=False), so its
                    # lease starves and its late claims are first
                    # lease-refused, then fence-refused — both counted.
                    self._send_terminals(rep, new_fin + new_drop, tick)
                    synced = self._drain_synced()
                n_done += len(synced)
                if self.autoscaler is not None and synced:
                    # Fence-accepted only — same feed as live members.
                    for r in synced:
                        self.autoscaler.observe_terminal(
                            terminal_fields(r), now)
                # Pre-failover the zombie is still a member and its
                # commits still land — its tick telemetry is part of
                # the same in-flight drain, and a trace needs it
                # to account the committed tokens. Post-failover its
                # commits are fence-refused, so the trail rightly
                # excludes its records.
                member = self.router.members.get(rep.name)
                if member is not None and member.replica is rep:
                    # Pre-failover zombie telemetry is part of the same
                    # in-flight drain: its state digest chains exactly
                    # while its records still flow (post-failover both
                    # stop together — the trail and the chain agree).
                    self.state_chain = zlib.crc32(
                        rec["state_crc"].to_bytes(4, "little"),
                        self.state_chain)
                if (member is not None and member.replica is rep
                        and self.replica_tick_sink is not None):
                    self.replica_tick_sink({
                        "tick": tick, "now": round(now, 4),
                        "mode": f"fleet/{rep.name}",
                        **{k: rec[k] for k in
                           ("queue", "running", "free_pages", "admitted",
                            "prefill", "decoded", "preempted",
                            "blocked", "preempted_for", "finished",
                            "aborted", "state_crc")},
                        **({"prefix_hits": rec["prefix_hits"],
                            "prefix": rec["prefix"]}
                           if "prefix_hits" in rec else {}),
                        **({"prefix_readmits": rec["prefix_readmits"]}
                           if "prefix_readmits" in rec else {}),
                        **({"spec": rec["spec"]}
                           if "spec" in rec else {}),
                        "terminal": [terminal_fields(r) for r in synced],
                    })
            # False-positive failovers: an isolated replica
            # does not know it was declared dead — it keeps stepping,
            # heartbeating into the partition, and trying to commit.
            # Off-trail like a post-failover zombie (no records, no
            # state chain: the fleet's trail covers what the router
            # TRUSTS). Every commit it sends is fence-refused; once
            # its lease lapses it refuses its own sends
            # (lease_refusals), and after a grace window it is torn
            # down.
            for rep, name in list(self._isolated):
                if (rep.core.unfinished == 0
                        or tick >= rep.lease_until + self.lease_ticks):
                    self._isolated.remove((rep, name))
                    self.bus.unregister(self._endpoint(rep))
                    self._log_replica(name, "isolated_end", tick, now)
                    continue
                _rec, new_fin, new_drop = rep.step(now)
                self.bus.send("hb", self._endpoint(rep), "router",
                              {"name": name, "gen": rep.gen,
                               "tick": tick}, tick=tick)
                self._send_terminals(rep, new_fin + new_drop, tick)
                synced = self._drain_synced()
                n_done += len(synced)
                if self.autoscaler is not None and synced:
                    for r in synced:
                        self.autoscaler.observe_terminal(
                            terminal_fields(r), now)
            if self.registry is not None:
                self.registry.set("fleet.replicas",
                                  len(self.router.members))
                self.registry.set("fleet.pending",
                                  len(pending) + len(redispatch_q))
            tick += 1
            clock.advance(tick_s)
            if n_done >= n_total:
                break
            if not any_work and not self._zombies and not self._handoffs:
                # Fleet idle: nothing in flight on any LIVE replica. A
                # dead-but-undetected member may still hold work — keep
                # ticking until heartbeat staleness surfaces it. Else
                # jump the clock to the next event, or — with no
                # replicas and none restarting — fail what remains
                # terminally (requests must always leave).
                if self.bus is not None and (self.bus.busy()
                                             or self._isolated):
                    # The WIRE still holds work (a delayed dispatch, an
                    # unacked retransmitting send) or an isolated
                    # replica is still lapsing — neither shows up as
                    # replica work, but jumping the clock past it would
                    # strand the run.
                    continue
                if any(not m.replica.alive
                       for m in self.router.members.values()):
                    continue
                now = clock() - t0
                if (not self.router.members and not self._pending_restarts
                        and self.faults is not None
                        and self.faults.pending("fleet.tick",
                                                "replica_join")):
                    # Empty fleet, but the plan still schedules a join:
                    # capacity is in flight exactly like a pending
                    # restart — keep ticking until its tick arrives.
                    continue
                if not self.router.members and not self._pending_restarts:
                    # Nothing can ever serve again — future arrivals
                    # included (waiting for one would spin forever: it
                    # arrives, no member can take it, repeat).
                    failed_now = []
                    for req in list(pending) + list(redispatch_q):
                        if req.terminal:
                            continue
                        req.status = "failed"
                        req.fail_reason = "fleet has no replicas"
                        # A future arrival fails AT its arrival moment,
                        # never before it — finished_at < arrival would
                        # put negative latencies in the obs records.
                        req.finished_at = max(now, req.arrival)
                        self._holder.pop(req.rid, None)
                        n_done += 1
                        failed_now.append(req)
                    pending.clear()
                    redispatch_q.clear()
                    if failed_now and self.registry is not None:
                        # A total outage is the SLO event that matters
                        # most: these terminals must reach the same
                        # registry twins every fenced completion does.
                        from .engine import _observe_request
                        for req in failed_now:
                            _observe_request(self.registry, req)
                    if failed_now:
                        # The mass failure empties both dispatch queues:
                        # chain the post-clear router digest so the
                        # flight-recorder chain reflects the transition
                        # (the synthetic record below carries it too).
                        router_crc = fleet_state_digest(
                            (), (), 0, (), self.router.fence_crc,
                            transport=(self.bus.digest_tuple()
                                       if self.bus is not None
                                       else None))
                        self.state_chain = zlib.crc32(
                            router_crc.to_bytes(4, "little"),
                            self.state_chain)
                    if failed_now and self.replica_tick_sink is not None:
                        # One router-attributed tick record carries the
                        # mass failure into the trail: the burn-rate
                        # rules fold its `terminal` entries (a fleet
                        # that died with work outstanding must page),
                        # and a trace sees the aborted rids so
                        # the lifecycles stay consistent with the
                        # request records.
                        self.replica_tick_sink({
                            "tick": tick, "now": round(now, 4),
                            "mode": "fleet/router",
                            "state_crc": router_crc,
                            "queue": 0, "running": 0, "free_pages": 0,
                            "admitted": [], "prefill": None,
                            "decoded": [], "preempted": [],
                            "blocked": [], "preempted_for": [],
                            "finished": [],
                            "aborted": [[r.rid, r.status]
                                        for r in failed_now],
                            "terminal": [terminal_fields(r)
                                         for r in failed_now],
                        })
                    continue
                targets = [pending[0].arrival] if pending else []
                if self._pending_restarts:
                    targets.append(self._pending_restarts[0][0])
                # Only a FUTURE event can be jumped to; a target <= now
                # (work already here, capacity arriving via a restart
                # that pops next iteration) just keeps ticking.
                future = [t for t in targets if t > now]
                if future:
                    clock.advance(min(future) - now)
                elif not targets and not (pending or redispatch_q):
                    raise RuntimeError(
                        "fleet stalled: replicas idle but "
                        f"{n_total - n_done} request(s) unaccounted for"
                    )
        self._tick = tick
        # Pool invariant at exit on every surviving replica: zero
        # leaked, zero double-booked pages, fleet-wide.
        for member in self.router.members.values():
            member.replica.core.sched.check()
        decode_ticks = self._retired[0] + sum(
            m.replica.core.decode_ticks for m in self.router.members.values())
        prefills = self._retired[1] + sum(
            m.replica.core.prefill_chunks
            for m in self.router.members.values())
        preempts = self._retired[2] + sum(
            m.replica.core.sched.preemptions
            for m in self.router.members.values())
        prefix_totals = dict(self._retired_prefix)
        for m in self.router.members.values():
            for k, v in m.replica.core.prefix_stats().items():
                prefix_totals[k] += v
        spec_totals = dict(self._retired_spec)
        for m in self.router.members.values():
            for k, v in m.replica.core.spec_stats.items():
                spec_totals[k] += v
        return FleetResult(
            requests=reqs, ticks=tick, duration_s=clock() - t0,
            dispatches=self.dispatches, redispatches=self.redispatches,
            fenced_discards=self.fenced_discards, crashes=self.crashes,
            joins=self.joins, leaves=self.leaves, restarts=self.restarts,
            circuit_opens=self.circuit_opens, decode_ticks=decode_ticks,
            prefill_chunks=prefills, preemptions=preempts,
            replicas_final=len(self.router.members),
            handoffs=self.handoffs, handoff_pages=self.handoff_pages,
            handoffs_aborted=self.handoffs_aborted,
            kv_refusals=self.kv_refusals,
            degraded_unified=len(self._degraded_rids), pools=self.pools,
            handoff_log=self.handoff_log,
            dispatch_trace=self.dispatch_trace, events=self.events,
            replica_log=self.replica_log,
            transport_log=self.transport_log, prefix=prefix_totals,
            spec=spec_totals, state_crc=self.state_chain,
            route_hits=self.route_hits, route_misses=self.route_misses,
            route_hit_tokens=self.route_hit_tokens,
            scale_ups=self.scale_ups, scale_downs=self.scale_downs,
            scale_crc=self.scale_crc, replica_ticks=self.replica_ticks,
            lease_refusals=self.lease_refusals,
            lease_ticks=self.lease_ticks,
            **({"msgs_sent": self.bus.counters["sent"],
                "msgs_delivered": self.bus.counters["delivered"],
                "msgs_dropped": self.bus.counters["dropped"],
                "msgs_duped": self.bus.counters["duped"],
                "msgs_delayed": self.bus.counters["delayed"],
                "msgs_deduped": self.bus.counters["deduped"],
                "retransmits": self.bus.counters["retransmits"],
                "partitions": self.bus.counters["partitions"]}
               if self.bus is not None else {}),
        )


def make_fleet_workload(*, n: int, vocab: int, prompt_min: int,
                        prompt_max: int, out_min: int, out_max: int,
                        rate: float, seed: int, sessions: int = 0,
                        deadline_s: float = 0.0, tenants: int = 0,
                        prefix_mix: float = 0.0,
                        len_dist: str = "uniform",
                        templates: int = 0,
                        turns_dist: str | None = None,
                        turn_gap_s: float = 0.0,
                        diurnal_amp: float = 0.0,
                        diurnal_period_s: float = 10.0) -> list[Request]:
    """The serve-bench workload generator plus session keys: request i
    belongs to session i % sessions (0 = sessionless), so the
    session-affinity policy has stable keys to rendezvous-hash.
    `tenants`/`prefix_mix`/`len_dist`/`templates` pass through to
    make_workload's seeded tenant mix, shared-template-prefix mix,
    heavy-tail length mix, and sized template
    pool.

    Two workload shapes compose on top, both leaving the
    base stream bitwise-unchanged when off: `diurnal_amp` > 0 time-warps
    the arrivals into a day cycle (bench.diurnal_warp — no new draws),
    then `turns_dist` grows each session's first request into a
    multi-turn conversation whose turns re-arrive carrying the previous
    turn's context (bench.add_session_turns — (seed, 5) spawn). Turns
    chain off WARPED arrivals: think-time gaps trail the conversation's
    actual start, which is what puts follow-up traffic inside the same
    diurnal peak that anchored it."""
    from .bench import add_session_turns, diurnal_warp, make_workload

    reqs = make_workload(n=n, vocab=vocab, prompt_min=prompt_min,
                         prompt_max=prompt_max, out_min=out_min,
                         out_max=out_max, rate=rate, seed=seed,
                         deadline_s=deadline_s, tenants=tenants,
                         prefix_mix=prefix_mix, len_dist=len_dist,
                         templates=templates)
    if sessions > 0:
        for r in reqs:
            r.session = r.rid % sessions
    if diurnal_amp > 0:
        reqs = diurnal_warp(reqs, amp=diurnal_amp,
                            period_s=diurnal_period_s)
    if turns_dist:
        if sessions <= 0:
            raise ValueError("turns_dist needs sessions > 0 (turns are "
                             "per-session conversations; a sessionless "
                             "workload has no chains to grow)")
        reqs = add_session_turns(reqs, turns_dist=turns_dist,
                                 turn_gap_s=turn_gap_s, vocab=vocab,
                                 out_min=out_min, out_max=out_max,
                                 max_len=prompt_max + out_max, seed=seed)
    return reqs
