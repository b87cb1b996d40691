"""Deterministic simulated message bus for the fleet's control plane (a
copy of the JAX package's `serve/transport.py`).

Without the bus, the router and its replicas talk through perfect
in-process calls. With it, dispatches, commits, terminals and heartbeats
become sequenced messages that faults can drop, duplicate, delay or cut
off by a partition, while the fleet stays deterministic bit for bit.

- Typed messages on per-(src, dst) links, each stamped with a per-link
  sequence number. Endpoints are "router" and ``"<name>#<gen>"``: the
  incarnation counter keeps a restarted replica's address apart from
  its predecessor's, so a message to a dead incarnation never reaches
  its successor.
- With no armed fault and no open partition, ``send`` calls the
  destination handler at once, which is the direct-call fleet: a
  zero-fault run with the bus equals one without it.
- Reliable kinds are retransmitted at least once more on a
  `utils.retry.backoff_delay` schedule (no jitter, delays rounded up to
  whole ticks, no retry cap) until acked or torn down. Receivers ack on
  delivery and on dedup.
- Receiver dedup: reliable messages carry a key
  ``(rid, kind0, epoch[, pos])``; a receiver remembers delivered keys
  per rid and drops repeats. The fleet releases a rid's keys once the
  rid is terminal.
- Faults at site ``fleet.transport``, polled once per tick:
  ``partition`` drops everything to and from one replica name for a
  window; ``msg_drop`` / ``msg_dup`` / ``msg_delay`` arm one-shot
  effects on the next matching send (optionally filtered by message
  kind and replica).
- Conservation: ``sent == delivered + deduped + dropped + inflight``. A
  dup counts in sent and duped; a retransmit in sent and retransmits.

``record_fields()`` is the bus's whole observable state;
``transport_digest_tuple`` of it enters ``fleet_state_digest``.
"""

from __future__ import annotations

from ..utils.retry import backoff_delay

TRANSPORT_SITE = "fleet.transport"

#: Message kinds carried on the bus. "ack" is bus-internal (clears the
#: sender's retransmit entry); the rest are fleet control-plane traffic.
MSG_KINDS = ("dispatch", "commit", "terminal", "hb", "hb_ack", "ack")

#: Counters every TransportBus maintains (record_fields order).
COUNTER_KEYS = ("sent", "delivered", "dropped", "duped", "delayed",
                "deduped", "retransmits", "partitions")

#: backoff_delay attempt values are capped here so the retransmit
#: interval plateaus (~32 ticks with the default base) instead of
#: growing without bound across a long partition.
_RTO_ATTEMPT_CAP = 5
_RTO_TICK_CAP = 32


def _no_jitter() -> float:
    return 0.0


def transport_digest_tuple(fields: dict) -> tuple:
    """Canonical hashable form of a transport record block — the ONE
    spelling shared by the producer (`fleet_state_digest`'s transport
    component) and the replay mirror, so the two can never drift on
    how bus state folds into the per-tick state_crc."""
    return (
        tuple(int(fields[k]) for k in COUNTER_KEYS),
        int(fields["inflight"]),
        int(fields["unacked"]),
        tuple((str(s), str(d), int(n)) for s, d, n in fields["links"]),
        tuple((str(n), int(u)) for n, u in fields["partitioned"]),
    )


class _Message:
    """One wire message. Payloads are in-memory python objects (the bus
    is simulated); a delayed or retransmitted copy re-delivers the SAME
    payload object, which is what a real network's byte copy would
    decode to."""

    __slots__ = ("seq", "kind", "src", "dst", "payload", "key",
                 "reliable", "sent_tick")

    def __init__(self, seq, kind, src, dst, payload, key, reliable,
                 sent_tick):
        self.seq = seq
        self.kind = kind
        self.src = src
        self.dst = dst
        self.payload = payload
        self.key = key
        self.reliable = reliable
        self.sent_tick = sent_tick


def _endpoint_replica(endpoint: str) -> str:
    """The replica NAME behind an endpoint ("r1#2" -> "r1"); the router
    endpoint maps to itself (never partitioned)."""
    return endpoint.partition("#")[0]


class TransportBus:
    """Seeded-deterministic message bus (see module docstring).

    `faults` is the fleet's FaultInjector (or None); the fleet calls
    `apply_tick_faults(tick)` once per tick to poll ``fleet.transport``
    and arm effects, then `pump(tick)` to retransmit due unacked sends
    and deliver due delayed copies. `plant` is a zero-arg callable
    returning the active chaos plant tag (the "skip-dedup" canary
    bypasses commit dedup so the oracle can prove dedup is
    load-bearing). `on_event` receives (kind, fields) for partition
    open/heal so the fleet can log them on the obs trail.
    """

    def __init__(self, *, faults=None, site: str = TRANSPORT_SITE,
                 rto_base: float = 2.0, plant=None, on_event=None):
        if rto_base < 1:
            raise ValueError(f"rto_base must be >= 1, got {rto_base}")
        self.faults = faults
        self.site = site
        self.rto_base = float(rto_base)
        self.plant = plant
        self.on_event = on_event
        self._endpoints: dict[str, object] = {}
        self._next_seq: dict[tuple[str, str], int] = {}
        # dst -> rid -> set of delivered reliable keys (released per
        # rid by the fleet at terminal apply).
        self._seen: dict[str, dict] = {}
        # key -> [attempt, due_tick, message]; insertion order is the
        # deterministic retransmit scan order.
        self._unacked: dict[tuple, list] = {}
        self._delayed: list[list] = []  # [due_tick, order, message]
        self._order = 0
        self._armed: list[dict] = []
        self.partitions: dict[str, int] = {}  # name -> heal tick
        self.counters = {k: 0 for k in COUNTER_KEYS}
        self._retx_tick: list[list] = []

    # ------------------------------------------------------------------
    # endpoints

    def register(self, endpoint: str, handler) -> None:
        self._endpoints[endpoint] = handler
        self._seen.setdefault(endpoint, {})

    def unregister(self, endpoint: str) -> None:
        """Tear down an endpoint. Its unacked sends stop retransmitting
        (the sender is gone) and pending retransmits TO it are dropped
        from the schedule; delayed copies already in flight stay in
        flight and count as dropped at delivery time if nobody is
        listening — the network does not know the process died."""
        self._endpoints.pop(endpoint, None)
        self._seen.pop(endpoint, None)
        stale = [k for k, ent in self._unacked.items()
                 if ent[2].src == endpoint or ent[2].dst == endpoint]
        for k in stale:
            del self._unacked[k]

    def release_keys(self, rid: int) -> None:
        """Drop the dedup key store for a terminal rid (bounds memory
        across a 10^5 storm); the fleet's terminal-request guard makes
        a post-release straggler commit harmless."""
        for per_rid in self._seen.values():
            per_rid.pop(rid, None)

    # ------------------------------------------------------------------
    # faults

    def apply_tick_faults(self, tick: int) -> None:
        """Poll ``fleet.transport`` at `tick`: open partitions, arm
        one-shot message effects, heal expired partitions."""
        healed = [n for n, until in self.partitions.items()
                  if tick >= until]
        for name in sorted(healed):
            del self.partitions[name]
            if self.on_event is not None:
                self.on_event("partition_heal", {"name": name,
                                                 "tick": tick})
        if self.faults is None:
            return
        for f in self.faults.poll(self.site, tick):
            if f.kind == "partition":
                rep = f.arg("replica", 0)
                name = rep if isinstance(rep, str) else f"r{int(rep)}"
                ticks = max(1, int(f.arg("ticks", 8)))
                self.partitions[name] = tick + ticks
                self.counters["partitions"] += 1
                if self.on_event is not None:
                    self.on_event("partition_open",
                                  {"name": name, "tick": tick,
                                   "heal": tick + ticks})
            elif f.kind in ("msg_drop", "msg_dup", "msg_delay"):
                rep = f.arg("replica", None)
                self._armed.append({
                    "effect": f.kind[4:],  # drop / dup / delay
                    "kind": f.arg("kind", None),
                    "replica": (None if rep is None
                                else rep if isinstance(rep, str)
                                else f"r{int(rep)}"),
                    "count": max(1, int(f.arg("count", 1))),
                    "ticks": max(1, int(f.arg("ticks", 2))),
                })
            else:  # pragma: no cover - validate_plan_sites blocks this
                raise ValueError(
                    f"fault kind {f.kind!r} is inert at {self.site}")

    def _blocked(self, endpoint: str, tick: int) -> bool:
        until = self.partitions.get(_endpoint_replica(endpoint))
        return until is not None and tick < until

    def _match_armed(self, msg: _Message):
        ep = msg.dst if msg.dst != "router" else msg.src
        rep = _endpoint_replica(ep)
        for i, a in enumerate(self._armed):
            if a["kind"] is not None and a["kind"] != msg.kind:
                continue
            if a["replica"] is not None and a["replica"] != rep:
                continue
            a["count"] -= 1
            if a["count"] <= 0:
                self._armed.pop(i)
            return a
        return None

    # ------------------------------------------------------------------
    # send / deliver

    def send(self, kind: str, src: str, dst: str, payload, *, tick: int,
             key: tuple | None = None, reliable: bool = False) -> None:
        if reliable and key is None:
            raise ValueError("reliable sends need a dedup key")
        link = (src, dst)
        seq = self._next_seq.get(link, 0)
        self._next_seq[link] = seq + 1
        msg = _Message(seq, kind, src, dst, payload, key, reliable, tick)
        if reliable:
            self._unacked[key] = [0, tick + self._rto(0), msg]
        self._transmit(msg, tick)

    def _rto(self, attempt: int) -> int:
        delay = backoff_delay(min(attempt, _RTO_ATTEMPT_CAP),
                              base=float(self.rto_base),
                              jitter=_no_jitter)
        return min(_RTO_TICK_CAP, max(1, -int(-delay // 1)))

    def _transmit(self, msg: _Message, tick: int) -> None:
        """One wire attempt: partition check, armed-effect check, then
        inline delivery."""
        c = self.counters
        c["sent"] += 1
        if self._blocked(msg.src, tick) or self._blocked(msg.dst, tick):
            c["dropped"] += 1
            return
        eff = self._match_armed(msg)
        if eff is not None:
            effect = eff["effect"]
            if effect == "drop":
                c["dropped"] += 1
                return
            if effect == "dup":
                c["duped"] += 1
                c["sent"] += 1  # the duplicate is a second wire copy
                self._deliver(msg, tick)
                self._deliver(msg, tick)
                return
            # delay: park a copy; pump() re-checks partitions at the
            # due tick (a window can open while the copy is in flight).
            c["delayed"] += 1
            self._delayed.append([tick + eff["ticks"], self._order, msg])
            self._order += 1
            return
        self._deliver(msg, tick)

    def _deliver(self, msg: _Message, tick: int) -> None:
        c = self.counters
        handler = self._endpoints.get(msg.dst)
        if handler is None:
            c["dropped"] += 1  # nobody listening at this incarnation
            return
        if msg.kind == "ack":
            c["delivered"] += 1
            self._unacked.pop(msg.payload, None)
            return
        if msg.key is not None:
            per_rid = self._seen[msg.dst].setdefault(msg.key[0], set())
            skip_dedup = (self.plant is not None
                          and self.plant() == "skip-dedup"
                          and msg.key[1] == "c")
            if msg.key in per_rid and not skip_dedup:
                c["deduped"] += 1
                if msg.reliable:
                    # re-ack: the retransmit means our first ack was
                    # lost (or the copy was duped) — answer it anyway.
                    self.send("ack", msg.dst, msg.src, msg.key,
                              tick=tick)
                return
            per_rid.add(msg.key)
        c["delivered"] += 1
        handler(msg, tick)
        if msg.reliable:
            self.send("ack", msg.dst, msg.src, msg.key, tick=tick)

    # ------------------------------------------------------------------
    # per-tick pump

    def pump(self, tick: int) -> None:
        """Retransmit due unacked sends, then deliver due delayed
        copies (oldest due first, FIFO within a tick)."""
        for key in list(self._unacked):
            ent = self._unacked.get(key)
            if ent is None:  # acked by an earlier retransmit this pump
                continue
            if ent[1] > tick:  # not due yet
                continue
            ent[0] += 1
            ent[1] = tick + self._rto(ent[0])
            self.counters["retransmits"] += 1
            msg = ent[2]
            self._retx_tick.append(
                [msg.kind, msg.dst, msg.key[0] if msg.key else -1])
            self._transmit(msg, tick)
        if not self._delayed:
            return
        due = [e for e in self._delayed if e[0] <= tick]
        if not due:
            return
        self._delayed = [e for e in self._delayed if e[0] > tick]
        due.sort(key=lambda e: (e[0], e[1]))
        for _due, _order, msg in due:
            if (self._blocked(msg.src, tick)
                    or self._blocked(msg.dst, tick)):
                self.counters["dropped"] += 1
                continue
            self._deliver(msg, tick)

    def busy(self) -> bool:
        """True while the wire still holds work: a delayed copy in
        flight or an unacked reliable send awaiting retransmission —
        the fleet must keep ticking through either (a clock jump would
        strand them)."""
        return bool(self._delayed or self._unacked)

    def drain_retransmits(self) -> list[list]:
        """This tick's retransmit markers ([kind, dst, rid]) for the
        fleet record."""
        out, self._retx_tick = self._retx_tick, []
        return out

    # ------------------------------------------------------------------
    # observability

    def record_fields(self) -> dict:
        """The bus's whole observable state, as it rides the per-tick
        fleet record. `transport_digest_tuple` of this dict is the
        transport component of `fleet_state_digest`."""
        fields = {k: self.counters[k] for k in COUNTER_KEYS}
        fields["inflight"] = len(self._delayed)
        fields["unacked"] = len(self._unacked)
        fields["links"] = [[s, d, n] for (s, d), n
                           in sorted(self._next_seq.items())]
        fields["partitioned"] = [[n, u] for n, u
                                 in sorted(self.partitions.items())]
        return fields

    def digest_tuple(self) -> tuple:
        return transport_digest_tuple(self.record_fields())
