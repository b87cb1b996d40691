"""Deterministic flight-recorder replay: `python -m mpi_cuda_cnn_tpu_torch
replay RUN` (counterpart of the reference's `obs/replay.py`, the same
code and output).

The producers stamp every tick with `state_crc`, the crc32 of a
canonical projection of their host-side serving state (queue order
anchors, slot table, page counts, prefix-tree stats, fence epochs,
in-flight handoffs, pool membership; `serve.scheduler.state_digest` and
`serve.router.fleet_state_digest`, the one spelling both sides call).
This module folds the trail back into a reconstructed state machine,
recomputes that digest at every tick and exits 1 on the first drift.
obs/diverge.py builds on the same fold to diff two trails at their
first disagreement.

The reconstruction is event-sourced: per-replica scheduler mirrors
apply exactly the events the producers emit (admitted, prefill,
decoded, spec, preempted, finished, aborted, and the fleet's
routing-target and handoff-placement markers), deriving slot extents,
block-table page counts, queue membership, token counts and pool free
counts by the scheduler's own page laws (admission allocates
pages_for(context), decode growth lands at pages_for(max(cached,
target)), a spec commit rolls back to pages_for(cached)). Along the way
it audits conservation: the reconstructed free-page count must equal
the recorded one at every tick, every fence grant must move an epoch
forward, and every request reaches a terminal status at most once.

Exit codes: 0 clean replay, 1 digest drift or an invariant violation,
2 config errors or a trail without `state_crc` (regenerate the run).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import deque

from ..serve.pool import pages_for
from ..serve.router import fence_chain, fleet_state_digest
from ..serve.scheduler import _rid_sig, state_digest
from ..serve.transport import COUNTER_KEYS, transport_digest_tuple
from .schema import fmt_cell as _fmt
from .schema import iter_runs

_PREFIX_STATS = ("hits", "misses", "hit_tokens", "cow_copies",
                 "inserts", "evictions")
# Host-tier counters, adopted cumulatively from the tick
# record's prefix block like cow/inserts/evictions: the readmit delta
# drives the free-page law (a readmission allocates a device page with
# no other trail event), the rest ride the digest's tier tuple.
_TIER_STATS = ("spills", "readmits", "refusals", "host_evictions")


class ReplayError(Exception):
    """Config/legacy-trail problem (CLI exit 2): the trail cannot be
    replayed at all — as opposed to a replay that RAN and drifted."""


class DriftError(Exception):
    """The reconstruction disagreed with the producer (CLI exit 1)."""

    def __init__(self, msg: str, *, tick=None, stream=None, rids=()):
        super().__init__(msg)
        self.tick = tick
        self.stream = stream
        self.rids = tuple(rids)


class _Slot:
    """One reconstructed engine slot."""

    __slots__ = ("rid", "cached", "target", "npages", "nrefs", "terminal")

    def __init__(self, rid, cached, target, npages, nrefs):
        self.rid = rid
        self.cached = cached
        self.target = target
        self.npages = npages
        self.nrefs = nrefs
        self.terminal = False  # static reserve-until-drain flag


class SchedMirror:
    """One scheduler's state, reconstructed purely from its tick
    records. `apply` replays one tick's events in the producer's
    order, then `check` recomputes the canonical digest against the
    stamped one."""

    def __init__(self, *, label: str, slots: int, num_pages: int,
                 page_size: int, reqinfo: dict, static: bool = False,
                 prefix: bool = False, spec_extra=(0, 0), tier: bool = False,
                 draft_usable: int = 0):
        self.label = label
        self.slots: list[_Slot | None] = [None] * slots
        self.queue: deque[int] = deque()
        self.queue_sig = 0
        self.free = num_pages - 1
        self.page_size = page_size
        self.reqinfo = reqinfo          # rid -> (prompt_tokens, max_new)
        self.static = static
        self.prefix = prefix
        self.spec_extra = tuple(spec_extra)
        self.outlen: dict[int, int] = {}   # rid -> replica-LOCAL tokens
        # Prefix-tree stats: hits/misses/hit_tokens derived from the
        # events; cow/inserts/evictions adopted from the per-tick
        # cumulative stats block (their deltas drive the free-page and
        # refs accounting, and the digest pins the adopted values).
        self.pstats = dict.fromkeys(_PREFIX_STATS, 0)
        # Host spill tier: cumulative tier counters + host
        # occupancy, adopted from the tick record's prefix block; the
        # readmit delta joins the free-page law and the whole tuple
        # joins the digest (the producer's PrefixCache.digest_tuple).
        self.tier = tier
        self.tstats = dict.fromkeys(_TIER_STATS, 0)
        self.host_used = 0
        # Paged draft cache: per-engine-slot draft page
        # counts re-derived from the spec rounds via the page law
        # "after a slot's round the draft holds pages_for(committed
        # rows)" — entries persist lazily across slot release, exactly
        # like the producer's PagedDraftProposer state.
        self.draft_usable = draft_usable       # 0 = no paged draft
        self.draft_pages: dict[int, int] = {}  # engine slot idx -> pages

    # -- queue ops (mirroring the scheduler's _q_* helpers) ------------

    def q_append(self, rid: int) -> None:
        self.queue.append(rid)
        self.queue_sig ^= _rid_sig(rid)

    def _q_appendleft(self, rid: int) -> None:
        self.queue.appendleft(rid)
        self.queue_sig ^= _rid_sig(rid)

    def _q_remove(self, rid: int) -> bool:
        if not self.queue:
            return False
        if self.queue[0] == rid:
            self.queue.popleft()
        else:
            try:
                self.queue.remove(rid)
            except ValueError:
                return False
        self.queue_sig ^= _rid_sig(rid)
        return True

    # -- helpers -------------------------------------------------------

    def _slot_of(self, rid: int) -> tuple[int, _Slot] | None:
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                return i, s
        return None

    def _release(self, i: int) -> None:
        s = self.slots[i]
        self.free += s.npages - s.nrefs
        self.slots[i] = None

    def _req(self, rid: int, tick, what: str):
        info = self.reqinfo.get(rid)
        if info is None:
            raise DriftError(
                f"{self.label}: tick {tick}: {what} for rid {rid} with no "
                "request record in the trail", tick=tick,
                stream=self.label, rids=[rid])
        return info[0], info[1]

    def seed_queue(self) -> None:
        """An engine run submits the WHOLE workload up front (sorted by
        (arrival, rid) — make_workload arrivals are monotone in rid, so
        the rounded arrival_s preserves the order); fleet replica queues
        start empty and fill via the dispatch markers."""
        for rid, _info in sorted(self.reqinfo.items(),
                                 key=lambda kv: (kv[1][2], kv[0])):
            self.q_append(rid)

    # -- the fold ------------------------------------------------------

    def apply(self, rec: dict) -> tuple[int, _Slot] | None:
        tick = rec.get("tick")
        ps = self.page_size
        hits = {rid: m for rid, m in rec.get("prefix_hits") or []}
        prec = rec.get("prefix")
        evict_delta = 0
        insert_delta = 0
        readmit_delta = 0
        if prec is not None:
            insert_delta = prec["inserts"] - self.pstats["inserts"]
            evict_delta = prec["evictions"] - self.pstats["evictions"]
            self.pstats["cow_copies"] = prec["cow_copies"]
            self.pstats["inserts"] = prec["inserts"]
            self.pstats["evictions"] = prec["evictions"]
            if self.tier:
                readmit_delta = prec["readmits"] - self.tstats["readmits"]
                for k in _TIER_STATS:
                    self.tstats[k] = prec[k]
                self.host_used = prec["host_used"]
        # LRU reclaim returns tree leaves to the pool (admission or
        # growth pressure — the tick's eviction delta is the only
        # trace); a host-tier readmission pulls one page back OUT per
        # readmit (the tier's re-insert allocates a fresh device page,
        # which the requesting slot then shares like any resident hit).
        self.free += evict_delta - readmit_delta

        # 1. Aborts (sweep expiries/cancels, queue-bound rejections,
        # livelock failures): wherever the rid sits. Static in-flight
        # aborts HOLD their reservation until the batch drains.
        for rid, _status in rec.get("aborted") or []:
            at = self._slot_of(rid)
            if at is not None:
                if self.static:
                    at[1].terminal = True
                else:
                    self._release(at[0])
            else:
                self._q_remove(rid)

        # 2. Admissions: bind at the recorded slot. The page law:
        # admission allocates pages_for(context) (static: the worst-case
        # reservation), a prefix hit leads with matched//ps shared pages.
        for idx, rid in rec.get("admitted") or []:
            prompt, max_new = self._req(rid, tick, "admission")
            out = self.outlen.setdefault(rid, 0)
            target = prompt + out
            m = hits.get(rid, 0)
            nrefs = m // ps
            if self.static:
                npages = pages_for(target + max_new - 1, ps)
            else:
                npages = pages_for(target, ps)
            if self.slots[idx] is not None:
                raise DriftError(
                    f"{self.label}: tick {tick}: admission of rid {rid} "
                    f"into occupied slot {idx}", tick=tick,
                    stream=self.label, rids=[rid])
            self.slots[idx] = _Slot(rid, m, target, npages, nrefs)
            self.free -= npages - nrefs
            self._q_remove(rid)
            if self.prefix:
                if m > 0:
                    self.pstats["hits"] += 1
                    self.pstats["hit_tokens"] += m
                else:
                    self.pstats["misses"] += 1

        # 3. The prefill chunk (at most one per tick). A completing
        # chunk emits the first token; with sharing on, the completed
        # prompt's new pages adopt into the tree (the tick's insert
        # delta) and the slot becomes their first reader.
        pf = rec.get("prefill")
        detached = None
        if pf:
            at = self._slot_of(pf[1])
            if at is None:
                raise DriftError(
                    f"{self.label}: tick {tick}: prefill for rid {pf[1]} "
                    "with no bound slot", tick=tick, stream=self.label,
                    rids=[pf[1]])
            s = at[1]
            s.cached += pf[2]
            if s.cached >= s.target:
                if insert_delta:
                    s.nrefs += insert_delta
                if pf[-1] == "emit":
                    self.outlen[s.rid] = self.outlen.get(s.rid, 0) + 1
            detached = at  # candidate for a fleet KV handoff (caller)

        # 4. Preemptions: release + requeue at the head, in log order.
        for rid in rec.get("preempted") or []:
            at = self._slot_of(rid)
            if at is None:
                raise DriftError(
                    f"{self.label}: tick {tick}: preemption of rid {rid} "
                    "with no bound slot", tick=tick, stream=self.label,
                    rids=[rid])
            self._release(at[0])
            self._q_appendleft(rid)

        # 5. The decode tick / speculative round. Page law: growth
        # lands at pages_for(max(cached, target)); a spec commit's
        # rejected-draft rollback lands there too (cached >= target in
        # decode, so the two spellings agree).
        spec = rec.get("spec")
        if spec is not None:
            slot_of_rid = {rid: idx for idx, rid in rec.get("decoded") or []}
            for rid, _proposed, accepted in spec:
                at = self._slot_of(rid)
                if at is None:
                    raise DriftError(
                        f"{self.label}: tick {tick}: spec round for rid "
                        f"{rid} with no bound slot", tick=tick,
                        stream=self.label, rids=[rid])
                s = at[1]
                if self.draft_usable:
                    # The paged-draft page law: after this
                    # slot's round the draft holds pages_for(committed
                    # rows), committed rows = context-1 at propose time
                    # (the last committed token is the round's input,
                    # not yet a draft cache row).
                    prompt, _mx = self._req(rid, tick, "draft round")
                    rows = prompt + self.outlen.get(rid, 0) - 1
                    self.draft_pages[slot_of_rid[rid]] = pages_for(rows, ps)
                j = 1 + accepted
                s.cached += j
                self.outlen[rid] = self.outlen.get(rid, 0) + j
                new = pages_for(max(s.cached, s.target), ps)
                self.free -= new - s.npages
                s.npages = new
        else:
            for _idx, rid in rec.get("decoded") or []:
                at = self._slot_of(rid)
                if at is None:
                    raise DriftError(
                        f"{self.label}: tick {tick}: decode for rid {rid} "
                        "with no bound slot", tick=tick,
                        stream=self.label, rids=[rid])
                s = at[1]
                s.cached += 1
                self.outlen[rid] = self.outlen.get(rid, 0) + 1
                if not self.static:
                    new = pages_for(max(s.cached, s.target), ps)
                    self.free -= new - s.npages
                    s.npages = new

        # 6. Finishes release immediately under continuous batching;
        # static finishes arrive all at once at the drain.
        for rid in rec.get("finished") or []:
            at = self._slot_of(rid)
            if at is not None:
                self._release(at[0])
        if self.static:
            occupied = [i for i, s in enumerate(self.slots) if s is not None]
            if occupied and all(self.slots[i].terminal for i in occupied):
                # The drain's aborted leg: terminal rows held their
                # reservation until the whole batch ended (no event
                # marks it — the batch_done law is mirrored instead).
                for i in occupied:
                    self._release(i)
        return detached

    def digest(self, squeezed: int = 0) -> int:
        slots: list[int] = []
        for i, s in enumerate(self.slots):
            if s is not None:
                slots.extend((i, s.rid, s.cached, s.target, s.npages,
                              s.nrefs))
        prefix = None
        if self.prefix:
            st = self.pstats
            # Node count: inserts - evictions, plus readmits with a
            # tier on (a readmitted node re-enters the tree without an
            # insert — the producer counts only fresh adoptions).
            nodes = st["inserts"] - st["evictions"]
            if self.tier:
                nodes += self.tstats["readmits"]
            prefix = (nodes, st["hits"],
                      st["misses"], st["hit_tokens"], st["cow_copies"],
                      st["inserts"], st["evictions"])
            if self.tier:
                prefix += (self.tstats["spills"], self.tstats["readmits"],
                           self.tstats["refusals"],
                           self.tstats["host_evictions"], self.host_used)
        extra = self.spec_extra
        if self.draft_usable:
            # The paged-draft digest extension (engine.run's spelling):
            # (spec on, k, draft paged, free draft pages, tracked slots).
            extra = extra + (1,
                             self.draft_usable
                             - sum(self.draft_pages.values()),
                             len(self.draft_pages))
        q = self.queue
        return state_digest(len(q), q[0] if q else -1, q[-1] if q else -1,
                            self.queue_sig, slots, self.free - squeezed,
                            prefix, extra)

    def check(self, rec: dict) -> None:
        """The per-tick cross-check: recomputed digest == stamped, and
        the free-page conservation audit (a split error message — the
        pages invariant is the one that names the leak directly)."""
        tick = rec.get("tick")
        squeezed = rec.get("squeezed", 0)
        if self.free - squeezed != rec["free_pages"]:
            raise DriftError(
                f"{self.label}: tick {tick}: page conservation violated — "
                f"reconstructed free {self.free - squeezed} != recorded "
                f"{rec['free_pages']}", tick=tick, stream=self.label)
        got = self.digest(squeezed)
        if got != rec["state_crc"]:
            raise DriftError(
                f"{self.label}: tick {tick}: state digest drift — "
                f"recomputed {got} != stamped {rec['state_crc']}",
                tick=tick, stream=self.label)

    def snapshot(self) -> dict:
        q = self.queue
        out = {
            "label": self.label,
            "slots": [[i, s.rid, s.cached, s.target, s.npages, s.nrefs]
                      for i, s in enumerate(self.slots) if s is not None],
            "queue_len": len(q),
            "queue_head": q[0] if q else None,
            "queue_tail": q[-1] if q else None,
            "free_pages": self.free,
        }
        if self.prefix:
            out["prefix"] = dict(self.pstats)
        if self.tier:
            out["tier"] = {**self.tstats, "host_used": self.host_used}
        if self.draft_usable:
            out["draft"] = {
                "free": self.draft_usable - sum(self.draft_pages.values()),
                "tracked": len(self.draft_pages),
            }
        return out


class _Member:
    __slots__ = ("name", "phase", "draining", "alive", "gen", "sched")

    def __init__(self, name, phase, gen, sched):
        self.name = name
        self.phase = phase
        self.draining = False
        self.alive = True
        self.gen = gen
        self.sched = sched


class _HandoffM:
    __slots__ = ("rid", "src", "src_gen", "pages", "private", "cached",
                 "outlen", "state", "dst", "dst_gen")

    def __init__(self, rid, src, src_gen, pages, private, cached, outlen):
        self.rid = rid
        self.src = src
        self.src_gen = src_gen
        self.pages = pages
        self.private = private
        self.cached = cached
        self.outlen = outlen
        self.state = "pending"
        self.dst = None
        self.dst_gen = -1


class FleetMirror:
    """The fleet-level reconstruction: membership, fences, handoffs,
    and one SchedMirror per replica incarnation. Replica lifecycle
    comes from the `replica` records (indexed by tick), routing targets
    from the fleet records' routing and handoff fields."""

    def __init__(self, *, config: dict, reqinfo: dict):
        self.cfg = config
        self.reqinfo = reqinfo
        self.members: dict[str, _Member] = {}
        self._gen: dict[str, int] = {}
        self._phase_of: dict[str, str | None] = {}
        self.handoffs: dict[int, _HandoffM] = {}
        self.fence_crc = 0
        self.epochs: dict[int, int] = {}
        self.pending = len(reqinfo)
        self.redispatch: deque[int] = deque()
        self.terminal: set[int] = set()
        # Lossy transport: the latest adopted per-tick bus
        # block (None = bus off), and the dispatches granted but not
        # yet wire-delivered — rid -> (replica name, resume outlen).
        # The bus's internals (retransmit timers, dedup stores) are not
        # event-sourced; the mirror adopts the producer's block after
        # AUDITING its invariants (conservation + counter monotonicity)
        # and folds it through the SAME transport_digest_tuple spelling.
        self.transport: dict | None = None
        self._inflight: dict[int, tuple[str, int]] = {}
        pools = config.get("pools")
        n = int(config.get("replicas_initial") or config.get("replicas", 0))
        phases: list[str | None] = [None] * n
        if pools:
            phases = (["prefill"] * int(pools["prefill"])
                      + ["decode"] * int(pools["decode"]))
        for i, phase in enumerate(phases):
            self._add_member(f"r{i}", phase)

    def _spec_extra(self):
        on = self.cfg.get("spec", "off") != "off"
        return (1 if on else 0, int(self.cfg.get("spec_k", 0)) if on else 0)

    def _add_member(self, name: str, phase) -> _Member:
        gen = self._gen.get(name, -1) + 1
        self._gen[name] = gen
        # Names keep their pool across restarts (the fleet's
        # _phase_of law): remember it for the restart path.
        self._phase_of[name] = phase
        sched = SchedMirror(
            label=f"fleet/{name}", slots=int(self.cfg["slots"]),
            num_pages=int(self.cfg["pages"]),
            page_size=int(self.cfg["page_size"]), reqinfo=self.reqinfo,
            prefix=bool(self.cfg.get("prefix_cache")),
            spec_extra=self._spec_extra(),
            tier=bool(self.cfg.get("host_pages")),
        )
        m = _Member(name, phase, gen, sched)
        self.members[name] = m
        return m

    # -- fence chain (the ONE router.fence_chain spelling) -------------

    def _grant(self, rid: int, name: str) -> None:
        epoch = self.epochs.get(rid, -1) + 1
        self.epochs[rid] = epoch
        self.fence_crc = fence_chain(self.fence_crc, "g", rid, name, epoch)

    def _revoke(self, rid: int) -> None:
        self.fence_crc = fence_chain(self.fence_crc, "r", rid)

    # -- liveness (incarnation-exact, like the producer's checks) ------

    def _live(self, name: str, gen: int) -> bool:
        m = self.members.get(name)
        return m is not None and m.gen == gen and m.alive

    # -- replica lifecycle events --------------------------------------

    def apply_replica_event(self, ev: dict) -> None:
        kind, name = ev.get("kind"), ev.get("name")
        if kind == "join":
            pools = self.cfg.get("pools")
            phase = ev.get("pool")
            if phase is None and pools:
                phase = "decode"  # the unlabeled-join law (fleet.py)
            self._add_member(name, phase)
        elif kind == "crash":
            m = self.members.get(name)
            if m is not None:
                m.alive = False
        elif kind == "dead":
            for rid in ev.get("stranded") or []:
                self._revoke(rid)
                self.redispatch.append(rid)
                # A dispatch still on the wire to the dead incarnation
                # can never produce a t_delivered marker (deliveries
                # are stamped for CURRENT incarnations only) — the
                # harvest strands it and re-dispatch will re-stash it.
                self._inflight.pop(rid, None)
            self.members.pop(name, None)
        elif kind == "restart":
            if self.members.get(name) is None:
                # Names keep their pool across restarts: whatever phase
                # this name joined with (initial plan or a pooled join).
                self._add_member(name, self._phase_of.get(name))
        elif kind == "leave":
            m = self.members.get(name)
            if m is not None:
                m.draining = True
        elif kind == "drain_complete":
            self.members.pop(name, None)
        # restart_scheduled / circuit_open / degraded / restored carry
        # no digested state.

    # -- fleet (router) records ----------------------------------------

    def _handoff(self, rid: int, tick, what: str) -> _HandoffM:
        ho = self.handoffs.get(rid)
        if ho is None:
            raise DriftError(
                f"fleet: tick {tick}: {what} for rid {rid} with no "
                "in-flight handoff (tampered or truncated trail)",
                tick=tick, stream="fleet", rids=[rid])
        return ho

    def _member(self, name: str, tick, what: str) -> _Member:
        m = self.members.get(name)
        if m is None:
            raise DriftError(
                f"fleet: tick {tick}: {what} names {name}, which is not "
                "a member (tampered or truncated trail)", tick=tick,
                stream="fleet")
        return m

    def _adopt_transport(self, rec: dict) -> None:
        """Audit + adopt the record's bus block. The audits
        are what make adoption more than trust: conservation must hold
        bitwise (sent == delivered + deduped + dropped + inflight) and
        every counter must be monotone vs the previous tick's block —
        a truncated/tampered/nondeterministic trail trips one of them
        before the digest would even be compared."""
        t = rec.get("transport")
        if t is None:
            return
        tick = rec.get("tick")
        c = {k: int(t[k]) for k in COUNTER_KEYS}
        wire = c["sent"] - c["delivered"] - c["deduped"] - c["dropped"]
        if wire != int(t["inflight"]):
            raise DriftError(
                f"fleet: tick {tick}: transport conservation violated — "
                f"sent {c['sent']} != delivered {c['delivered']} + "
                f"deduped {c['deduped']} + dropped {c['dropped']} + "
                f"inflight {t['inflight']}", tick=tick, stream="fleet")
        if self.transport is not None:
            for k in COUNTER_KEYS:
                if c[k] < int(self.transport[k]):
                    raise DriftError(
                        f"fleet: tick {tick}: transport counter {k} "
                        f"went backwards ({self.transport[k]} -> "
                        f"{c[k]})", tick=tick, stream="fleet")
        self.transport = t

    def apply_fleet(self, rec: dict) -> None:
        tick = rec.get("tick")
        self._adopt_transport(rec)
        for t in rec.get("t_terminal") or []:
            self.terminal.add(t["id"])
        for rid, reason in rec.get("handoff_aborted") or []:
            ho = self._handoff(rid, tick, "handoff abort")
            del self.handoffs[rid]
            if self._live(ho.src, ho.src_gen):
                self.members[ho.src].sched.free += ho.private
            if (ho.dst is not None and reason != "receiver_dead"
                    and self._live(ho.dst, ho.dst_gen)):
                self.members[ho.dst].sched.free += ho.pages
            self.redispatch.append(rid)
        for rid, dst in rec.get("handoff_unplaced") or []:
            ho = self._handoff(rid, tick, "handoff un-place")
            self._member(dst, tick, "handoff un-place").sched.free += \
                ho.pages
            ho.state, ho.dst = "pending", None
        for rid, dst in rec.get("handoff_placed") or []:
            ho = self._handoff(rid, tick, "handoff placement")
            m = self._member(dst, tick, "handoff placement")
            m.sched.free -= ho.pages
            ho.state, ho.dst, ho.dst_gen = "copying", dst, m.gen
        for rid, dst in rec.get("handoff_done") or []:
            ho = self._handoff(rid, tick, "handoff completion")
            del self.handoffs[rid]
            sched = self._member(dst, tick, "handoff completion").sched
            idx = next((i for i, s in enumerate(sched.slots) if s is None),
                       None)
            if idx is None:
                raise DriftError(
                    f"fleet: tick {tick}: handoff bind for rid {rid} with "
                    f"no free slot on {dst}", tick=tick, stream="fleet",
                    rids=[rid])
            sched.slots[idx] = _Slot(rid, ho.cached, ho.cached, ho.pages, 0)
            sched.outlen[rid] = ho.outlen
            self._grant(rid, dst)
            if self._live(ho.src, ho.src_gen):
                self.members[ho.src].sched.free += ho.private
        bus = "transport" in rec
        for rid, name, outl in rec.get("redispatched_to") or []:
            if not self.redispatch or self.redispatch[0] != rid:
                raise DriftError(
                    f"fleet: tick {tick}: re-dispatch of rid {rid} out of "
                    "queue order", tick=tick, stream="fleet", rids=[rid])
            self.redispatch.popleft()
            self._grant(rid, name)
            if bus:
                # The grant is the SEND; queue membership waits for the
                # wire (the t_delivered marker, same tick when inline).
                self._inflight[rid] = (name, outl)
            else:
                sched = self._member(name, tick, "re-dispatch").sched
                sched.outlen[rid] = outl
                sched.q_append(rid)
        for rid, name in rec.get("dispatched_to") or []:
            self.pending -= 1
            self._grant(rid, name)
            if bus:
                self._inflight[rid] = (name, 0)
            else:
                sched = self._member(name, tick, "dispatch").sched
                sched.outlen[rid] = 0
                sched.q_append(rid)
        # Wire deliveries LAST: an inline zero-fault delivery rides the
        # same record as its send, and must pop the stash it just made.
        for rid, name in rec.get("t_delivered") or []:
            ent = self._inflight.pop(rid, None)
            if ent is None or ent[0] != name:
                raise DriftError(
                    f"fleet: tick {tick}: wire delivery of rid {rid} to "
                    f"{name} without a matching in-flight dispatch "
                    f"(stashed: {ent})", tick=tick, stream="fleet",
                    rids=[rid])
            sched = self._member(name, tick, "wire delivery").sched
            sched.outlen[rid] = ent[1]
            sched.q_append(rid)

    def fleet_digest(self) -> int:
        return fleet_state_digest(
            ((m.name, m.phase or "", m.draining, m.alive)
             for m in sorted(self.members.values(), key=lambda m: m.name)),
            ((rid, ho.state, ho.src, ho.dst or "")
             for rid, ho in sorted(self.handoffs.items())),
            self.pending, tuple(self.redispatch), self.fence_crc,
            transport=(transport_digest_tuple(self.transport)
                       if self.transport is not None else None))

    def check_fleet(self, rec: dict) -> None:
        tick = rec.get("tick")
        got = self.fleet_digest()
        if got != rec["state_crc"]:
            raise DriftError(
                f"fleet: tick {tick}: router state digest drift — "
                f"recomputed {got} != stamped {rec['state_crc']}",
                tick=tick, stream="fleet")

    # -- replica tick records ------------------------------------------

    def apply_replica_tick(self, rec: dict) -> None:
        tick = rec.get("tick")
        name = rec["mode"].split("/", 1)[1]
        if name == "router":
            # The mass-failure record: every undispatched request
            # failed terminally and both dispatch queues emptied.
            for rid, _status in rec.get("aborted") or []:
                self.terminal.add(rid)
            self.pending = 0
            self.redispatch.clear()
            self._inflight.clear()
            self.check_fleet(rec)
            return
        m = self.members.get(name)
        if m is None:
            raise DriftError(
                f"fleet: tick {tick}: tick record from {name}, which is "
                "not a member", tick=tick, stream=f"fleet/{name}")
        detached = m.sched.apply(rec)
        if detached is not None:
            self._maybe_handoff(m, detached, rec)
        for t in rec.get("terminal") or []:
            self.terminal.add(t["id"])
        if rec["queue"] != len(m.sched.queue):
            raise DriftError(
                f"fleet/{name}: tick {tick}: queue length drift — "
                f"reconstructed {len(m.sched.queue)} != recorded "
                f"{rec['queue']}", tick=tick, stream=f"fleet/{name}")
        m.sched.check(rec)

    def _maybe_handoff(self, m: _Member, detached, rec) -> None:
        """Mirror the _begin_handoff decision: a prefill-pool slot that
        just COMPLETED its prefill with decode work remaining detaches
        into a KV handoff — iff the sender incarnation is a live member
        of a pooled fleet and the decode pool has dispatchable members
        (else it degrades to unified decoding in place)."""
        idx, s = detached
        pf = rec.get("prefill")
        if not (pf and pf[-1] == "emit" and s.cached >= s.target):
            return
        if not self.cfg.get("pools") or m.phase != "prefill":
            return
        if not m.alive:
            return  # a zombie's completed prefill never opens a handoff
        rid = s.rid
        _prompt, max_new = m.sched._req(rid, rec.get("tick"), "handoff")
        if m.sched.outlen.get(rid, 0) >= max_new:
            return  # done at its first token: finished, not handed off
        if rid in self.handoffs or rid in self.terminal:
            return
        if not any(mm.phase == "decode" and not mm.draining
                   for mm in self.members.values()):
            return  # decode pool empty: degraded to unified, slot kept
        self._revoke(rid)
        self.handoffs[rid] = _HandoffM(
            rid, m.name, m.gen, s.npages, s.npages - s.nrefs, s.cached,
            m.sched.outlen.get(rid, 0))
        m.sched.slots[idx] = None  # detached: sealed, nothing freed

    def snapshot(self) -> dict:
        return {
            "members": [[m.name, m.phase or "", m.draining, m.alive]
                        for m in sorted(self.members.values(),
                                        key=lambda m: m.name)],
            "handoffs": [[rid, ho.state, ho.src, ho.dst or ""]
                         for rid, ho in sorted(self.handoffs.items())],
            "pending": self.pending,
            "redispatch": list(self.redispatch),
            "fence_crc": self.fence_crc,
            "replicas": {m.name: m.sched.snapshot()
                         for m in self.members.values()},
            **({"transport": dict(self.transport),
                "wire_inflight": sorted(self._inflight)}
               if self.transport is not None else {}),
        }


# -- run assembly ------------------------------------------------------


def split_run(records: list[dict]) -> dict:
    """Partition one run's records into replayable streams:
    {"engine": {mode: [tick recs]}, "fleet": [fleet+tick recs in file
    order] or None, "configs": {mode: serve rec}, "reqinfo": {mode:
    {rid: (prompt, max_new)}}, "replica_events": {tick: [replica recs]}}.
    Raises ReplayError when the trail has no ticks or predates the
    flight recorder (no state_crc)."""
    engine: dict[str, list[dict]] = {}
    fleet: list[dict] = []
    configs: dict[str, dict] = {}
    reqinfo: dict[str, dict] = {}
    replica_events: dict[int, list[dict]] = {}
    saw_tick = saw_digest = False
    for rec in records:
        ev = rec.get("event")
        if ev == "tick":
            saw_tick = True
            saw_digest = saw_digest or "state_crc" in rec
            mode = rec.get("mode", "?")
            if mode.startswith("fleet/"):
                fleet.append(rec)
            else:
                engine.setdefault(mode, []).append(rec)
        elif ev == "fleet":
            saw_tick = True
            saw_digest = saw_digest or "state_crc" in rec
            fleet.append(rec)
        elif ev == "serve":
            configs[rec.get("mode", "?")] = rec
        elif ev == "request":
            per = reqinfo.setdefault(rec.get("mode", "?"), {})
            if "max_new_tokens" not in rec:
                raise ReplayError(
                    "request records carry no max_new_tokens — "
                    "older trail; regenerate the run")
            per[rec["id"]] = (rec["prompt_tokens"], rec["max_new_tokens"],
                              rec.get("arrival_s", 0.0))
        elif ev == "replica":
            replica_events.setdefault(rec.get("tick", 0), []).append(rec)
    if not saw_tick:
        raise ReplayError(
            "no tick trail to replay (run with --metrics-jsonl and "
            "--log full)")
    if not saw_digest:
        raise ReplayError(
            "tick records carry no state_crc — older trail; "
            "regenerate the run with a flight-recorder producer")
    for mode in list(engine) + (["fleet"] if fleet else []):
        if mode not in configs:
            raise ReplayError(
                f"mode {mode!r} has tick records but no serve summary "
                "record — the replay needs the run's geometry")
        if mode not in reqinfo:
            raise ReplayError(
                f"mode {mode!r} has tick records but no request records "
                "— the replay needs per-request prompt/budget info")
    return {"engine": engine, "fleet": fleet or None, "configs": configs,
            "reqinfo": reqinfo, "replica_events": replica_events}


def _engine_mirror(mode: str, cfg: dict, reqinfo: dict) -> SchedMirror:
    spec_on = (mode == "continuous" and cfg.get("spec", "off") != "off")
    draft_usable = 0
    if (spec_on and cfg.get("spec") == "draft"
            and cfg.get("draft_cache") == "paged"):
        # The draft pool's usable size: slots x
        # pages_for(max_len) — PagedDraftProposer's full-coverage
        # sizing, so the mirror can re-derive free draft pages from
        # the per-slot page law alone.
        draft_usable = int(cfg["slots"]) * pages_for(
            int(cfg["max_len"]), int(cfg["page_size"]))
    return SchedMirror(
        label=mode, slots=int(cfg["slots"]), num_pages=int(cfg["pages"]),
        page_size=int(cfg["page_size"]), reqinfo=reqinfo,
        static=(mode == "static"),
        prefix=bool(cfg.get("prefix_cache")) and mode == "continuous",
        spec_extra=(1, int(cfg.get("spec_k", 0))) if spec_on else (0, 0),
        tier=(mode == "continuous" and bool(cfg.get("host_pages"))),
        draft_usable=draft_usable,
    )


class RunReplay:
    """One run's full replay: engine-mode mirrors + the fleet mirror,
    folded record by record. `fold` raises DriftError at the first
    disagreement; `fold(collect=...)` records per-digest outcomes and
    keeps going best-effort (the diverge path)."""

    def __init__(self, records: list[dict]):
        self.parts = split_run(records)
        self.mirrors: dict[str, SchedMirror] = {}
        for mode, _ticks in self.parts["engine"].items():
            self.mirrors[mode] = _engine_mirror(
                mode, self.parts["configs"][mode],
                self.parts["reqinfo"][mode])
            self.mirrors[mode].seed_queue()
        self.fleet: FleetMirror | None = None
        if self.parts["fleet"] is not None:
            self.fleet = FleetMirror(config=self.parts["configs"]["fleet"],
                                     reqinfo=self.parts["reqinfo"]["fleet"])
        self.ticks_checked = 0

    def _ordered(self):
        """(kind, stream_key, rec) in replay order. Engine modes fold
        independently; the fleet stream interleaves replica lifecycle
        events (applied at their tick, before that tick's records —
        the producer's own chronology) with router and replica ticks."""
        for mode, ticks in self.parts["engine"].items():
            for rec in ticks:
                yield "engine", (mode, rec.get("tick")), rec
        if self.parts["fleet"] is not None:
            seen_ticks: set[int] = set()
            for rec in self.parts["fleet"]:
                tick = rec.get("tick")
                if tick not in seen_ticks:
                    seen_ticks.add(tick)
                    for ev in self.parts["replica_events"].get(tick, ()):
                        yield "event", ("replica-event", tick), ev
                if rec.get("event") == "fleet":
                    yield "fleet", ("fleet", tick), rec
                else:
                    yield "replica", (rec.get("mode"), tick), rec

    def fold(self, *, stop_tick=None, collect: list | None = None):
        """Replay every record. With `collect`, digest mismatches and
        apply errors are appended as (stream_key, stamped, recomputed,
        error) and the fold continues best-effort (the diverge path);
        without it the first problem raises DriftError. `stop_tick`
        ends the fold after the given tick (the `--at-tick` rendering)."""
        for kind, key, rec in self._ordered():
            tick = key[1]
            if stop_tick is not None and tick is not None \
                    and tick > stop_tick:
                continue
            if kind == "event":
                self.fleet.apply_replica_event(rec)
                continue
            if "state_crc" not in rec:
                raise ReplayError(
                    f"tick record at tick {tick} carries no state_crc — "
                    "older trail; regenerate the run")
            try:
                if kind == "fleet":
                    self.fleet.apply_fleet(rec)
                    self.fleet.check_fleet(rec)
                elif kind == "replica":
                    self.fleet.apply_replica_tick(rec)
                else:
                    mirror = self.mirrors[key[0]]
                    mirror.apply(rec)
                    mirror.check(rec)
                self.ticks_checked += 1
                if collect is not None:
                    collect.append((key, rec["state_crc"],
                                    rec["state_crc"], None))
            except DriftError as e:
                if collect is None:
                    raise
                collect.append((key, rec.get("state_crc"), None, str(e)))
        return self

    def snapshot(self) -> dict:
        out = {mode: m.snapshot() for mode, m in self.mirrors.items()}
        if self.fleet is not None:
            out["fleet"] = self.fleet.snapshot()
        return out


# -- rendering ---------------------------------------------------------


def _render_sched(snap: dict) -> list[str]:
    lines = [
        f"free pages: {snap['free_pages']}   queue: "
        f"len={snap['queue_len']} head={_fmt(snap['queue_head'])} "
        f"tail={_fmt(snap['queue_tail'])}",
    ]
    if snap["slots"]:
        lines += ["| slot | rid | cached | target | pages | refs |",
                  "|---|---|---|---|---|---|"]
        for i, rid, cached, target, npages, nrefs in snap["slots"]:
            lines.append(f"| {i} | {rid} | {cached} | {target} "
                         f"| {npages} | {nrefs} |")
    else:
        lines.append("(no occupied slots)")
    if "prefix" in snap:
        p = snap["prefix"]
        lines.append(
            "prefix: " + ", ".join(f"{k}={p[k]}" for k in _PREFIX_STATS))
    if "tier" in snap:
        t = snap["tier"]
        lines.append("host tier: " + ", ".join(
            f"{k}={t[k]}" for k in (*_TIER_STATS, "host_used")))
    if "draft" in snap:
        d = snap["draft"]
        lines.append(f"draft pool: free={d['free']} "
                     f"tracked={d['tracked']}")
    return lines


def render_state(snapshot: dict, *, replica: str | None = None) -> str:
    lines: list[str] = []
    for mode in sorted(k for k in snapshot if k != "fleet"):
        lines.append(f"### [{mode}]")
        lines += _render_sched(snapshot[mode])
        lines.append("")
    fleet = snapshot.get("fleet")
    if fleet is not None:
        lines.append("### [fleet]")
        lines.append(
            "members: " + (", ".join(
                f"{n}{'(' + p + ')' if p else ''}"
                f"{'!' if not alive else ''}{'~' if draining else ''}"
                for n, p, draining, alive in fleet["members"]) or "none"))
        lines.append(f"pending: {fleet['pending']}   redispatch queue: "
                     f"{fleet['redispatch']}   fence chain: "
                     f"{fleet['fence_crc']}")
        if fleet["handoffs"]:
            lines.append("handoffs: " + ", ".join(
                f"rid {rid} {state} {src}->{dst or '?'}"
                for rid, state, src, dst in fleet["handoffs"]))
        for name in sorted(fleet["replicas"]):
            if replica is not None and name != replica:
                continue
            lines.append(f"#### replica {name}")
            lines += _render_sched(fleet["replicas"][name])
        lines.append("")
    return "\n".join(lines)


# -- the CLI -----------------------------------------------------------


def replay_main(argv: list[str] | None = None) -> int:
    """`replay RUN [--at-tick T] [--replica R]` — fold a tick
    trail back into the reconstructed serving state, cross-checking the
    stamped per-tick state digests the whole way. Exit 0 clean, 1 on
    drift/invariant violation, 2 on config/legacy errors."""
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch replay",
        description="Deterministic flight-recorder replay: reconstruct "
                    "the full serving state from a run's tick trail, "
                    "cross-checking the stamped state_crc at every tick "
                    "and auditing page/fence/rid conservation.",
    )
    ap.add_argument("path", help="metrics JSONL with a full tick trail")
    ap.add_argument("--at-tick", type=int, default=None,
                    help="render the reconstructed state as of this tick "
                         "(default: end of run)")
    ap.add_argument("--replica", default=None,
                    help="restrict the fleet rendering to one replica")
    ap.add_argument("--format", choices=("md", "json"), default="md")
    args = ap.parse_args(argv)

    try:
        runs = [r for r in iter_runs(args.path) if r]
    except (OSError, ValueError) as e:
        print(f"error: {args.path}: {e}", file=sys.stderr)
        return 2
    if not runs:
        print(f"error: {args.path}: no records", file=sys.stderr)
        return 2
    rc = 0
    for i, records in enumerate(runs, 1):
        label = args.path if len(runs) == 1 \
            else f"{args.path} (run {i}/{len(runs)})"
        try:
            replay = RunReplay(records)
            replay.fold(stop_tick=args.at_tick)
        except ReplayError as e:
            print(f"error: {args.path}: {e}", file=sys.stderr)
            return 2
        except DriftError as e:
            print(f"error: {label}: REPLAY DRIFT — {e}", file=sys.stderr)
            print("the trail does not reproduce its own stamped state: "
                  "producer nondeterminism or a tampered/truncated file",
                  file=sys.stderr)
            rc = max(rc, 1)
            continue
        snap = replay.snapshot()
        if args.format == "json":
            print(json.dumps({
                "path": args.path, "run": i,
                "ticks_checked": replay.ticks_checked,
                "at_tick": args.at_tick, "state": snap,
            }))
        else:
            at = f" at tick {args.at_tick}" if args.at_tick is not None \
                else ""
            print(f"## Replay — {label}{at}\n")
            print(f"{replay.ticks_checked} tick digest(s) cross-checked, "
                  "zero drift\n")
            print(render_state(snap, replica=args.replica))
    return rc


if __name__ == "__main__":
    sys.exit(replay_main())
