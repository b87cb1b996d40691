"""Seeded fault-schedule sampler over the live `faults.SITES` registry.

Hand-written fault plans cover the schedules their authors thought of;
the bugs worth finding live in the cross-products no hand plan covers
(a pool collapse during an autoscaler drain, a zombie handoff racing a
kv_corrupt readmit). This module draws random multi-fault plans from
the same registry `--fault-plan` validates against (kinds x sites x
trigger ticks x params), weighted toward cross-kind interleavings, and
spells each draw back through `faults.format_plan`, so every sampled
episode is a one-line repro.

The sampler reads the registry: a kind or site added to
`faults.SITES["fleet-bench"]` is searchable the moment it exists. The
axis gates below only subtract the sites an episode's topology never
reaches.
"""

from __future__ import annotations

import dataclasses
import random

from ..faults import SITES, Fault, format_plan, validate_plan_sites

# The CLI surface whose registered sites the sampler draws from — the
# fleet storm is the one surface where every fault domain (membership,
# handoff, resume, spill) composes.
SURFACE = "fleet-bench"

# fire("fleet.tick") raises these straight out of Fleet.run — simulated
# whole-PROCESS death. There is no post-episode state left to check
# invariants on, so the schedule search skips them; every other
# registered kind is fair game.
RAISING_KINDS = frozenset({"crash", "io"})


@dataclasses.dataclass(frozen=True)
class EpisodeAxes:
    """The topology/feature axes one episode samples over: the
    prefix + spec + disagg + spill + autoscale + transport matrix. The
    axes gate which fault sites are LIVE (a handoff fault on a unified
    fleet would fail Fleet's inert-fault validation; a spill fault
    without a host tier would silently never fire)."""

    # --pools grammar ("prefill:P,decode:D") disagg split, None=unified
    pools: str | None = None
    prefix: bool = False       # shared prefix cache
    spill: bool = False        # host-tier spill (requires prefix)
    spec: str = "off"          # speculative decoding: off | lookup
    autoscale: bool = False    # online goodput autoscaler
    transport: bool = False    # lossy message bus + leases

    def label(self) -> str:
        parts = [f"pools={self.pools}" if self.pools else "unified"]
        if self.prefix:
            parts.append("prefix")
        if self.spill:
            parts.append("spill")
        if self.spec != "off":
            parts.append(f"spec={self.spec}")
        if self.autoscale:
            parts.append("autoscale")
        if self.transport:
            parts.append("transport")
        return ",".join(parts)


def sample_axes(rng: random.Random) -> EpisodeAxes:
    """One seeded draw over the axes matrix. Probabilities lean toward
    feature-ON (the whole point is the interactions); spill stays
    conditioned on prefix — the host tier spills prefix-tree pages, so
    the combination is a constructor error, not a samplable point."""
    pools = rng.choice([None, None, "prefill:1,decode:2",
                        "prefill:2,decode:1"])
    prefix = rng.random() < 0.5
    return EpisodeAxes(
        pools=pools,
        prefix=prefix,
        spill=prefix and rng.random() < 0.5,
        spec="lookup" if rng.random() < 0.4 else "off",
        autoscale=rng.random() < 0.35,
        # The bus routes the unified control plane only — transport +
        # pools is a Fleet constructor error (the handoff plane stays
        # direct-call), so like spill-without-prefix it is not a
        # samplable point.
        transport=pools is None and rng.random() < 0.5,
    )


def _live_pairs(axes: EpisodeAxes) -> list[tuple[str, str]]:
    """The (site, kind) pairs this episode's topology can actually
    reach, from the live registry: fleet.handoff exists only on a
    pooled fleet (Fleet rejects the plan as inert otherwise),
    tier.spill only with the host tier on, pool_crash only with pools
    to crash. Sorted for seed-stable iteration order."""
    pairs = []
    for site, kinds in sorted(SITES[SURFACE].items()):
        if site == "fleet.handoff" and not axes.pools:
            continue
        if site == "tier.spill" and not axes.spill:
            continue
        if site == "fleet.transport" and not axes.transport:
            continue
        for kind in sorted(kinds - RAISING_KINDS):
            if kind == "pool_crash" and not axes.pools:
                continue
            pairs.append((site, kind))
    return pairs


def _sample_args(rng: random.Random, site: str, kind: str,
                 axes: EpisodeAxes, *, replicas: int) -> dict:
    """Seeded params for one fault, kept inside what the fleet accepts
    (replica indices that have joined by construction, pool names that
    exist). Optional knobs (zombie_ticks) appear with some probability
    — they are exactly what the shrinker's coordinate pass later tries
    to drop."""
    args: dict = {}
    if kind in ("replica_crash", "replica_leave"):
        args["replica"] = rng.randrange(replicas)
        if kind == "replica_crash" and rng.random() < 0.35:
            args["zombie_ticks"] = rng.randint(1, 4)
    elif kind == "pool_crash":
        args["pool"] = rng.choice(["prefill", "decode"])
        if rng.random() < 0.25:
            args["zombie_ticks"] = rng.randint(1, 3)
    elif kind == "replica_join":
        if rng.random() < 0.5:
            args["replicas"] = rng.randint(1, 2)
        if axes.pools and rng.random() < 0.5:
            args["pool"] = rng.choice(["prefill", "decode"])
    elif kind == "kv_corrupt" and site == "fleet.handoff":
        args["page"] = rng.randrange(4)
    elif kind == "partition":
        args["replica"] = rng.randrange(replicas)
        args["ticks"] = rng.randint(4, 12)
    elif kind == "msg_delay":
        args["ticks"] = rng.randint(1, 6)
        if rng.random() < 0.5:
            args["count"] = rng.randint(1, 3)
        if rng.random() < 0.5:
            args["kind"] = rng.choice(["commit", "dispatch",
                                       "terminal", "hb"])
    elif kind in ("msg_drop", "msg_dup"):
        args["count"] = rng.randint(1, 3)
        if rng.random() < 0.5:
            args["kind"] = rng.choice(["commit", "dispatch",
                                       "terminal", "hb"])
    return args


def _sample_at(rng: random.Random, site: str, *, max_tick: int) -> int:
    """Trigger values per site class: fleet.tick triggers on the fleet
    tick counter; the polled sites trigger on their own SEQUENCE
    numbers (Nth handoff / resume re-dispatch / spill), which stay
    small at episode scale."""
    if site in ("fleet.tick", "fleet.transport"):
        # Both trigger on the fleet tick counter (transport faults arm
        # at the top of the named tick via apply_tick_faults).
        return rng.randint(1, max_tick)
    return rng.randrange(7)


def sample_plan(rng: random.Random, axes: EpisodeAxes, *,
                replicas: int, max_tick: int = 96) -> str:
    """Draw one multi-fault plan, serialized to the `--fault-plan`
    grammar.

    Weighted toward CROSS-KIND interleavings: the entry count leans
    multi-fault (2-4 common), and kinds are drawn without replacement
    first — distinct kinds before repeats — because the untested
    surface is kind A's recovery racing kind B's trigger, not the Nth
    instance of A. Entries are sorted by trigger tick within
    fleet.tick draws only where it costs nothing: plan order is
    semantically irrelevant (the injector matches on (site, at)), so
    the spelling stays exactly as drawn for seed stability."""
    pairs = _live_pairs(axes)
    n = rng.choices([1, 2, 3, 4, 5], weights=[1, 4, 5, 4, 1])[0]
    picks: list[tuple[str, str]] = []
    unseen = list(pairs)
    seen_kinds: set[str] = set()
    for _ in range(n):
        fresh = [p for p in unseen if p[1] not in seen_kinds]
        pool = fresh if fresh else pairs
        site, kind = rng.choice(pool)
        picks.append((site, kind))
        seen_kinds.add(kind)
    plan = [
        Fault(kind=kind, site=site,
              at=_sample_at(rng, site, max_tick=max_tick),
              args=_sample_args(rng, site, kind, axes, replicas=replicas))
        for site, kind in picks
    ]
    # Self-check against the registry the CLI validates with: a sampled
    # plan that --fault-plan would reject is a sampler bug, and it must
    # surface at sample time, not mid-episode.
    validate_plan_sites(plan, SURFACE)
    return format_plan(plan)
