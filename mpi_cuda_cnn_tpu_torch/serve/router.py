"""Fleet router policy: dispatch, membership, health and fences (a copy
of the JAX package's `serve/router.py`).

The policy half of the fleet, free of engines and tensors: it decides
where a request goes and whose outputs count, while serve/fleet.py owns
the replicas that do the work. Everything here is deterministic (sorted
membership, pure hash functions, an injectable jitter), so a seeded
fleet storm gives the same dispatch trace bit for bit run to run.

- **Dispatch** (`Router.pick`): least_loaded reads each replica's
  queue/slot telemetry (the MetricsRegistry gauges its step loop keeps)
  and picks the smallest backlog; session affinity rendezvous-hashes
  (session, replica), so only a departed replica's sessions move;
  cache_aware scores candidates by expected prefix overlap against each
  replica's `route_keys` (the page-aligned prefix keys its device tree
  and host tier hold), walking the request's cumulative chunk keys to
  the first miss. Ties break least-loaded-then-name; zero overlap falls
  back to hash affinity (with a session) or least-loaded.
- **Membership and health**: replicas heartbeat every tick they step;
  `heartbeat_miss` missed ticks in a row declare one dead. Restarts are
  paced by utils/retry.backoff_delay, and a replica that crashes
  `max_flaps` times has its circuit opened: it is removed for good.
- **Generation fences** (`Router.grant` / `fence_ok`): every dispatch
  of a request carries a rising epoch, and one (replica, epoch) pair
  holds a request's fence at a time. A re-dispatch bumps the epoch, so
  a partitioned zombie replica that keeps generating after failover has
  every commit refused: no token position is generated twice into the
  authoritative output.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

from ..utils.retry import backoff_delay

POLICIES = ("least_loaded", "session", "cache_aware")


def fence_chain(crc: int, *op) -> int:
    """THE fence-epoch chain step: one grant/revoke op
    folded into the running crc32 — `("g", rid, name, epoch)` /
    `("r", rid)`. The JAX package's obs/replay.py FleetMirror chains the
    same ops from a run's trail, so the spelling must not drift."""
    return zlib.crc32(repr(op).encode(), crc)


def fleet_state_digest(members, handoffs, pending: int, redispatch,
                       fence_crc: int, transport=None) -> int:
    """THE canonical fleet/router state digest, shared by
    serve/fleet.py (producer) and the JAX package's obs/replay.py
    (reconstruction):
    `members` is an iterable of (name, phase, draining, alive) in name
    order, `handoffs` of (rid, state, src, dst) in rid order, `pending`
    the undispatched-arrival count, `redispatch` the re-dispatch queue's
    rids in order, and `fence_crc` the router's running generation-fence
    chain (Router.fence_crc — every grant/revoke in commit order, so the
    whole epoch history folds into one number without serializing the
    O(total rids) fence map per tick). `transport` is
    `serve.transport.transport_digest_tuple` of the message bus's
    record block when the fleet runs over the lossy bus —
    None (transport off) preserves the historical 5-tuple spelling
    bit-for-bit."""
    parts = (tuple(members), tuple(handoffs), pending,
             tuple(redispatch), fence_crc)
    if transport is not None:
        parts = parts + (transport,)
    return zlib.crc32(repr(parts).encode())


def stable_hash(*parts) -> int:
    """32-bit FNV-1a over the parts' string forms — a process-stable,
    seed-independent mixer (Python's str hash is randomized per
    process, which would unseat every session on restart)."""
    h = 2166136261
    for part in parts:
        for b in str(part).encode():
            h = ((h ^ b) * 16777619) & 0xFFFFFFFF
        h = (h ^ 0x2E) & 0xFFFFFFFF  # field separator
    return h


@dataclasses.dataclass
class Member:
    """One replica as the router sees it: health bookkeeping. The
    replica object itself (serve/fleet.py) hangs off `replica`; flap
    counts live in Router._flap_history (one authority — they must
    survive deregistration, so a per-Member copy could only go stale)."""

    name: str
    replica: object
    joined_tick: int = 0
    last_beat: int = 0
    draining: bool = False


class CircuitOpen(Exception):
    """Raised by record_crash when a replica exhausts its flap budget."""


class Router:
    """Deterministic dispatch + membership + fencing (see module doc).

    `jitter` has the random.random call shape and feeds
    backoff_delay's de-synchronization term; every current surface
    keeps the default 0.5 — restart pacing stays deterministic, the
    FakeClock contract. The hook exists so a real multi-host deploy
    can de-synchronize restarts without touching the pacing logic."""

    def __init__(self, policy: str = "least_loaded", *,
                 heartbeat_miss: int = 3, backoff_base: float = 0.0,
                 max_flaps: int = 3, jitter=None, page_size: int = 0):
        if policy not in POLICIES:
            raise ValueError(f"policy {policy!r}: want one of {POLICIES}")
        if heartbeat_miss < 1:
            raise ValueError(f"heartbeat_miss must be >= 1, got "
                             f"{heartbeat_miss}")
        if policy == "cache_aware" and page_size < 1:
            raise ValueError("policy 'cache_aware' needs page_size >= 1 "
                             "(the prefix keys are page-aligned)")
        self.policy = policy
        self.page_size = page_size
        # Matched prefix tokens of the LAST cache_aware pick (0 on
        # fallback / other policies): the fleet reads it right after
        # pick() to account route hits. Observability only — never part
        # of any digest, so replay (which re-applies recorded routing,
        # not pick()) is untouched.
        self.last_route_overlap = 0
        self.heartbeat_miss = heartbeat_miss
        self.backoff_base = backoff_base
        self.max_flaps = max_flaps
        self.jitter = jitter if jitter is not None else (lambda: 0.5)
        self.members: dict[str, Member] = {}
        # Flap counts survive deregistration: a restarted replica keeps
        # its crash history, which is what makes the circuit breaker a
        # breaker and not a per-incarnation counter.
        self._flap_history: dict[str, int] = {}
        self.circuit_open: set[str] = set()
        # rid -> (replica name, epoch): the generation-token fence.
        self._fence: dict[int, tuple[str, int]] = {}
        self._epoch: dict[int, int] = {}
        # Running crc32 chain over every grant/revoke in commit order:
        # the fence-epoch component of the per-tick fleet
        # state digest. O(1) per fence op; a replay of the trail
        # chains the same ops and must land on the same number.
        self.fence_crc = 0

    # -- membership ----------------------------------------------------

    def register(self, replica, tick: int = 0) -> Member:
        name = replica.name
        if name in self.members:
            raise ValueError(f"replica {name!r} already registered")
        if name in self.circuit_open:
            raise ValueError(f"replica {name!r} is circuit-open")
        m = Member(name=name, replica=replica, joined_tick=tick,
                   last_beat=tick)
        self.members[name] = m
        return m

    def deregister(self, name: str) -> Member:
        return self.members.pop(name)

    def beat(self, name: str, tick: int) -> None:
        self.members[name].last_beat = tick

    def stale(self, tick: int) -> list[Member]:
        """Members that have MISSED `heartbeat_miss` consecutive beats
        — the router's failure detector (a crashed replica stops
        beating; detection lags the crash by the miss budget). The
        check runs BEFORE the current tick's beats land, so a healthy
        member's lag is already 1: missed beats = lag - 1, hence the
        strict comparison (a replica crashed at tick T is declared
        dead at tick T + heartbeat_miss)."""
        return [m for m in sorted(self.members.values(),
                                  key=lambda m: m.name)
                if tick - m.last_beat > self.heartbeat_miss]

    def record_crash(self, name: str) -> float:
        """Account one crash of `name`; returns the backoff delay (s)
        before its restart may rejoin, or raises CircuitOpen once the
        flap budget is exhausted (the replica never comes back)."""
        flaps = self._flap_history.get(name, 0) + 1
        self._flap_history[name] = flaps
        if flaps > self.max_flaps:
            self.circuit_open.add(name)
            raise CircuitOpen(
                f"replica {name} crashed {flaps} times "
                f"(max_flaps={self.max_flaps}); circuit opened"
            )
        return backoff_delay(flaps - 1, self.backoff_base, self.jitter)

    def dispatchable(self, phase: str | None = None) -> list[Member]:
        """Members that may receive NEW work, in deterministic order.
        `phase` restricts to one pool of a disaggregated fleet: only
        members whose replica carries that phase tag —
        an empty result is how the fleet detects a collapsed pool and
        degrades to unified serving instead of stalling."""
        return [m for m in sorted(self.members.values(),
                                  key=lambda m: m.name)
                if not m.draining
                and (phase is None
                     or getattr(m.replica, "phase", None) == phase)]

    # -- dispatch ------------------------------------------------------

    def _chunk_keys(self, req) -> list[bytes]:
        """The request's cumulative page-aligned prefix keys, in depth
        order — THE SAME key spelling serve/prefix_cache.py inserts
        (`toks[:(i+1)*ps].tobytes()` over full chunks only), so a
        membership test against a replica's route_keys is exact."""
        toks = np.asarray(req.prompt, np.int32).reshape(-1)
        ps = self.page_size
        return [toks[:(i + 1) * ps].tobytes()
                for i in range(len(toks) // ps)]

    def _overlap(self, member, keys) -> int:
        """Expected prefix-hit tokens of dispatching onto `member`:
        walk the cumulative keys in depth order, stop at the first one
        the replica holds in neither its device tree nor its host tier
        (a deeper chunk can't hit without its parent — the tree is
        prefix-closed, and readmission re-walks from the root)."""
        route = getattr(member.replica, "route_keys", None)
        if not route:
            return 0
        n = 0
        for k in keys:
            if k not in route:
                break
            n += 1
        return n * self.page_size

    def pick(self, req, phase: str | None = None) -> Member | None:
        """The replica `req` should run on, or None when nothing can
        take work. Least-loaded reads each replica's load() (backed by
        its registry gauges); session requests rendezvous-hash
        onto the surviving membership; cache_aware takes the
        highest expected prefix overlap, ties broken least-loaded, and
        falls back to hash affinity / least-loaded at zero overlap;
        ties break on name, so identical fleets make identical choices.
        `phase` restricts the candidate set to one pool —
        session affinity then rendezvous-hashes over that pool's
        membership only."""
        self.last_route_overlap = 0
        cands = self.dispatchable(phase)
        if not cands:
            return None
        if self.policy == "cache_aware":
            keys = self._chunk_keys(req)
            if keys:
                scored = [(self._overlap(m, keys), m) for m in cands]
                best = max(s for s, _ in scored)
                if best > 0:
                    self.last_route_overlap = best
                    return min((m for s, m in scored if s == best),
                               key=lambda m: (m.replica.load(), m.name))
            # Zero overlap: deterministic fallback. Hash affinity keeps
            # a cold session pinned (its SECOND turn then scores), and
            # membership changes still move only the dead replica's
            # sessions — the rendezvous property cache scoring alone
            # would not give.
            if req.session is not None:
                return max(cands,
                           key=lambda m: (stable_hash(req.session, m.name),
                                          m.name))
            return min(cands, key=lambda m: (m.replica.load(), m.name))
        if self.policy == "session" and req.session is not None:
            return max(cands,
                       key=lambda m: (stable_hash(req.session, m.name),
                                      m.name))
        return min(cands, key=lambda m: (m.replica.load(), m.name))

    # -- generation-token fences ---------------------------------------

    def grant(self, rid: int, name: str) -> int:
        """Fence `rid`'s generation to replica `name`; returns the new
        epoch. Every dispatch and re-dispatch goes through here —
        epochs only ever move forward."""
        epoch = self._epoch.get(rid, -1) + 1
        self._epoch[rid] = epoch
        self._fence[rid] = (name, epoch)
        self.fence_crc = fence_chain(self.fence_crc, "g", rid, name, epoch)
        return epoch

    def fence_ok(self, rid: int, name: str, epoch: int) -> bool:
        """Whether (name, epoch) still holds `rid`'s fence — checked on
        every token commit and terminal claim; a stale holder (zombie
        or superseded dispatch) is refused."""
        return self._fence.get(rid) == (name, epoch)

    def revoke(self, rid: int) -> None:
        """Invalidate `rid`'s fence IMMEDIATELY (failover harvest, rid
        awaiting re-dispatch): nobody may commit until the next grant —
        the window where a zombie could otherwise race the failover
        shut. The epoch counter is untouched, so the next grant still
        moves forward."""
        self._fence.pop(rid, None)
        self.fence_crc = fence_chain(self.fence_crc, "r", rid)

    def fence_of(self, rid: int) -> tuple[str, int] | None:
        return self._fence.get(rid)
