"""One chaos episode: a sampled fault plan through the real fleet
storm, then the global invariant oracle.

The episode harness is the same fleet construction `fleet-bench` and
`autosize` use (SimCompute, FakeClock, identical defaults), so every
sampled schedule is a one-line ``fleet-bench --fault-plan '<plan>'``
repro and the storm's
trace/state/blame CRCs mean the same thing they mean everywhere else.
What chaos adds is the oracle: a declarative correctness spec (the
FATE & DESTINI shape — Gunawi et al., NSDI'11) checked after EVERY
episode, not a per-feature assertion checked where an author thought
to look:

1. every request terminal exactly once (statuses AND the trail's
   fence-accepted terminal stream agree — no loss, no double count);
2. finished outputs equal the SimCompute closed form, and every
   committed token matches it (no double generation, no zombie leak);
3. blame conservation, bitwise (obs.causal: per-request categories sum
   exactly to the end-to-end span);
4. PagePool.check() + host-tier accounting clean at exit (the fleet
   run itself raises on a pool violation — the harness converts any
   raise into a violation instead of dying);
5. `replay` zero-drift on the in-memory trail (the event-sourced
   mirror re-derives every state digest);
6. same-(seed, plan) re-run bitwise: trace/state/blame CRCs equal
   across two independent runs.

Each episode runs the plan TWICE — check 6 needs the twin, and the
pair of trails is exactly what `diverge` wants when a violation
survives shrinking.
"""

from __future__ import annotations

import dataclasses
import json
import zlib

from ..faults import parse_plan

# Statuses a request may legally end in (serve/scheduler.py contract).
TERMINAL_STATUSES = frozenset(
    {"finished", "expired", "cancelled", "rejected", "failed"})


@dataclasses.dataclass(frozen=True)
class EpisodeConfig:
    """One episode's full recipe: (seed, plan) plus the sampled axes
    and the tier-1 scale knobs. Frozen and hashable on purpose — the
    shrinker re-runs `dataclasses.replace(cfg, plan=...)` variants and
    caches verdicts by spelling."""

    seed: int
    plan: str = ""
    replicas: int = 3
    pools: str | None = None
    prefix: bool = False
    spill: bool = False
    spec: str = "off"
    autoscale: bool = False
    transport: bool = False
    requests: int = 32
    rate: float = 48.0
    vocab: int = 64
    prompt_min: int = 4
    prompt_max: int = 40
    out_min: int = 4
    out_max: int = 16
    slots: int = 4
    page_size: int = 16
    tick_ms: float = 2.0
    # Test-only: names a planted invariant bug in serve/fleet.py
    # (CHAOS_PLANT) the oracle must catch. Never set outside tests and
    # `chaos --plant`.
    plant: str | None = None

    @property
    def n_replicas(self) -> int:
        if self.pools:
            # The --pools grammar: "prefill:P,decode:D" (serve.handoff
            # .parse_pools); replica count is the phase sum.
            return sum(int(part.rsplit(":", 1)[1])
                       for part in self.pools.split(","))
        return self.replicas


def config_for(seed: int, plan: str, axes, **scale) -> EpisodeConfig:
    """Fold sampled axes + a sampled plan into one EpisodeConfig."""
    return EpisodeConfig(
        seed=seed, plan=plan, pools=axes.pools, prefix=axes.prefix,
        spill=axes.spill, spec=axes.spec, autoscale=axes.autoscale,
        transport=axes.transport, **scale,
    )


@dataclasses.dataclass
class EpisodeResult:
    config: EpisodeConfig
    violations: list[dict]
    crc: int
    row: dict
    records_a: list[dict]
    records_b: list[dict]

    @property
    def ok(self) -> bool:
        return not self.violations


def _crc(obj) -> int:
    return zlib.crc32(json.dumps(obj, sort_keys=True).encode())


def _run_once(cfg: EpisodeConfig, records: list[dict]) -> dict:
    """One storm; `records` fills with the replayable trail (the same
    event spellings fleet-bench writes to JSONL) even when the run
    raises mid-way — a partial trail is still forensic material."""
    from ..faults import FakeClock, FaultInjector
    from ..obs.causal import BlameAccumulator
    from ..obs.metrics import MetricsRegistry
    # The one import outside the torch-free modules, as in
    # obs/autosize.py: serve/fleet.py is torch-free on the SimCompute
    # path but hosts the engine-compute factory too.
    from ..serve import fleet as fleet_mod  # mctpu: disable=MCT001
    from ..serve.pool import pages_for

    max_len = cfg.prompt_max + cfg.out_max
    pages = cfg.slots * pages_for(max_len, cfg.page_size) + 1
    host_pages = pages if cfg.spill else 0
    reqs = fleet_mod.make_fleet_workload(
        n=cfg.requests, vocab=cfg.vocab, prompt_min=cfg.prompt_min,
        prompt_max=cfg.prompt_max, out_min=cfg.out_min,
        out_max=cfg.out_max, rate=cfg.rate, seed=cfg.seed,
    )
    clock = FakeClock()
    registry = MetricsRegistry(clock=clock)
    blame = BlameAccumulator()

    def fleet_sink(rec: dict) -> None:
        blame.ingest_fleet(rec)
        records.append({"event": "fleet", **rec})

    def tick_sink(rec: dict) -> None:
        blame.ingest_tick(rec)
        records.append({"event": "tick", **rec})

    autoscaler = None
    if cfg.autoscale:
        from ..serve.autoscale import Autoscaler, parse_autoscale

        autoscaler = Autoscaler(parse_autoscale("on"))
    fleet = fleet_mod.Fleet(
        lambda name: fleet_mod.SimCompute(vocab=cfg.vocab, chunk=16,
                                          salt=cfg.seed),
        replicas=cfg.replicas, slots=cfg.slots, num_pages=pages,
        page_size=cfg.page_size, max_len=max_len,
        policy="least_loaded", heartbeat_miss=3, backoff_base=0.05,
        max_flaps=3, redispatch="resume", tick_s=cfg.tick_ms / 1e3,
        check_every=16,
        faults=FaultInjector(cfg.plan) if cfg.plan else None,
        clock=clock, registry=registry,
        fleet_sink=fleet_sink, replica_tick_sink=tick_sink,
        prefix=cfg.prefix, spec=cfg.spec, spec_k=8, spec_ngram=2,
        pools=cfg.pools, handoff_ticks=1, log_handoffs=False,
        host_pages=host_pages, autoscale=autoscaler,
        transport=cfg.transport,
    )
    # The planted bug (test-only): flipped around the run alone so a
    # raise can never leak the toggle into the next episode.
    fleet_mod.CHAOS_PLANT = cfg.plant
    try:
        result = fleet.run(reqs)
    finally:
        fleet_mod.CHAOS_PLANT = None
    for rec in result.replica_log:
        records.append({"event": "replica", **rec})
    for rec in result.request_records():
        records.append({"event": "request", **rec})
    s = result.summary()
    # The run-geometry record the replay mirror reconstructs from —
    # the same spelling fleet_bench_main stamps (mode comes from **s).
    records.append({
        "event": "serve", "bench": "fleet", "policy": "least_loaded",
        "autoscale": cfg.autoscale, "redispatch": "resume",
        "spec": cfg.spec, "spec_k": 8, "replicas_initial": cfg.n_replicas,
        "rate": cfg.rate, "slots": cfg.slots, "page_size": cfg.page_size,
        "pages": pages, "compute": "sim", "prefix_cache": cfg.prefix,
        "host_pages": host_pages, "transport": cfg.transport,
        "lease_ticks": fleet.lease_ticks, **s,
    })
    for rec in result.transport_log:
        records.append({"event": "transport", **rec})
    return {"result": result, "fleet": fleet, "summary": s,
            "blame": blame, "sim": fleet_mod.SimCompute(
                vocab=cfg.vocab, chunk=16, salt=cfg.seed),
        "host_pages": host_pages}


def _check_requests(cfg: EpisodeConfig, run: dict,
                    violations: list[dict]) -> None:
    """Oracle checks 1+2: terminal-exactly-once and the closed form."""
    result, sim = run["result"], run["sim"]
    if len(result.requests) != cfg.requests:
        violations.append({
            "check": "terminal",
            "detail": f"{len(result.requests)} requests in the result, "
                      f"workload had {cfg.requests}"})
    for r in sorted(result.requests, key=lambda r: r.rid):
        if r.status not in TERMINAL_STATUSES:
            violations.append({
                "check": "terminal",
                "detail": f"rid {r.rid} ended non-terminal: {r.status!r}"})
            continue
        if r.status == "finished" and len(r.out) != r.max_new_tokens:
            violations.append({
                "check": "outputs",
                "detail": f"rid {r.rid} finished with {len(r.out)} "
                          f"tokens, budget {r.max_new_tokens}"})
        bad = next((j for j, tok in enumerate(r.out)
                    if tok != sim._tok_at(r, j)), None)
        if bad is not None:
            violations.append({
                "check": "outputs",
                "detail": f"rid {r.rid} token {bad} diverges from the "
                          "SimCompute closed form (lost/duplicated or "
                          "zombie-committed generation)"})


def _check_terminal_stream(cfg: EpisodeConfig, records: list[dict],
                           violations: list[dict]) -> None:
    """Check 1, trail half: the fence-accepted terminal stream must
    name every rid exactly once — a request terminal in the result but
    absent (or doubled) in the stream is a lost/duplicated SLO event."""
    seen: dict[int, int] = {}
    for rec in records:
        if rec.get("event") == "tick":
            stream = rec.get("terminal") or ()
        elif rec.get("event") == "fleet":
            # Deferred terminals applied at bus pump ride
            # the fleet record's t_terminal stream ONLY — they never
            # reach a replica tick record — so exactly-once is over
            # the union of both streams.
            stream = rec.get("t_terminal") or ()
        else:
            continue
        for t in stream:
            rid = t.get("id")
            seen[rid] = seen.get(rid, 0) + 1
    dup = sorted(rid for rid, n in seen.items() if n > 1)
    if dup:
        violations.append({
            "check": "terminal",
            "detail": f"rid(s) {dup} terminal more than once in the "
                      "trail's fence-accepted stream"})
    if len(seen) != cfg.requests:
        violations.append({
            "check": "terminal",
            "detail": f"trail carries {len(seen)} terminal rids, "
                      f"workload had {cfg.requests}"})


def _check_blame(run: dict, violations: list[dict]) -> None:
    """Check 3: bitwise blame conservation (obs.causal)."""
    for problem in run["blame"].check("fleet"):
        violations.append({"check": "blame", "detail": problem})


def _check_pools(cfg: EpisodeConfig, run: dict,
                 violations: list[dict]) -> None:
    """Check 4, tier half: Fleet.run already re-checks every surviving
    PagePool at exit (a violation raises and lands as an `exception`
    violation); what it does not assert is host-tier occupancy staying
    inside its bound."""
    for member in run["fleet"].router.members.values():
        tier = member.replica.core.tier
        if tier is not None and tier.host_used > run["host_pages"]:
            violations.append({
                "check": "pool",
                "detail": f"{member.name} host tier holds "
                          f"{tier.host_used} pages, bound "
                          f"{run['host_pages']}"})


def _check_replay(records: list[dict], violations: list[dict]) -> int:
    """Check 5: fold the event-sourced mirror over the trail and
    cross-check every stamped state digest. Returns ticks checked."""
    from ..obs.replay import DriftError, ReplayError, RunReplay

    try:
        replay = RunReplay(records)
        replay.fold()
        return replay.ticks_checked
    except (DriftError, ReplayError) as e:
        violations.append({"check": "replay",
                           "detail": f"{type(e).__name__}: {e}"})
        return 0


def run_episode(cfg: EpisodeConfig) -> EpisodeResult:
    """Run (seed, plan) twice, check the full oracle, fold the episode
    CRC. Violations carry {"check", "detail"}; an empty list is a pass."""
    violations: list[dict] = []
    records_a: list[dict] = []
    records_b: list[dict] = []
    runs, errors = [], []
    for records in (records_a, records_b):
        try:
            runs.append(_run_once(cfg, records))
            errors.append(None)
        except Exception as e:  # noqa: BLE001 — the oracle reports, never dies
            runs.append(None)
            errors.append(f"{type(e).__name__}: {e}")
    a, b = runs
    crcs = statuses = None
    replay_ticks = 0
    if errors[0]:
        violations.append({"check": "exception", "detail": errors[0]})
    if a is not None:
        _check_requests(cfg, a, violations)
        _check_terminal_stream(cfg, records_a, violations)
        _check_blame(a, violations)
        _check_pools(cfg, a, violations)
        replay_ticks = _check_replay(records_a, violations)
        bf = a["blame"].summary_fields("fleet")
        crcs = {"trace_crc": a["summary"]["trace_crc"],
                "state_crc": a["summary"]["state_crc"],
                "blame_crc": bf["crc"]}
        statuses = a["summary"]["statuses"]
    # Check 6: the deterministic twin. With both runs dead, the raise
    # itself must at least be deterministic.
    if a is not None and b is not None:
        twin = {"trace_crc": b["summary"]["trace_crc"],
                "state_crc": b["summary"]["state_crc"],
                "blame_crc": b["blame"].summary_fields("fleet")["crc"]}
        if twin != crcs:
            violations.append({
                "check": "determinism",
                "detail": f"same-(seed, plan) re-run diverged: {crcs} "
                          f"vs {twin}"})
    elif (a is None) != (b is None) or errors[0] != errors[1]:
        violations.append({
            "check": "determinism",
            "detail": f"re-run outcome diverged: {errors[0]!r} vs "
                      f"{errors[1]!r}"})
    crc = _crc({
        "seed": cfg.seed, "plan": cfg.plan, "pools": cfg.pools,
        "prefix": cfg.prefix, "spill": cfg.spill, "spec": cfg.spec,
        "autoscale": cfg.autoscale, "transport": cfg.transport,
        "statuses": statuses,
        "violations": sorted({v["check"] for v in violations}), **(crcs or {}),
    })
    row = {
        "kind": "episode", "seed": cfg.seed, "plan": cfg.plan,
        "faults": len(parse_plan(cfg.plan)) if cfg.plan else 0,
        "requests": cfg.requests,
        "violations": sorted({v["check"] for v in violations}),
        "replay_ticks": replay_ticks, "episode_crc": crc,
        **(crcs or {}),
    }
    return EpisodeResult(config=cfg, violations=violations, crc=crc,
                         row=row, records_a=records_a,
                         records_b=records_b)
