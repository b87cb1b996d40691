"""The fleet's host-side parts in the port against the JAX package's, on
the CPU: the handoff protocol's helpers, the router (fence chain, stable
hash, state digest, pick sequences under each policy, fences and the
circuit breaker), the lossy transport bus under a seeded fault walk, the
autoscaler's decisions, and the workload shapes (diurnal warp, the fleet
workload). Both sides get the same inputs; every result is compared
exactly.
"""

import json
import zlib

import numpy as np
import pytest

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.obs.slo import SLOSpec as JaxSLOSpec
from mpi_cuda_cnn_tpu.serve import autoscale as jax_autoscale
from mpi_cuda_cnn_tpu.serve import handoff as jax_handoff
from mpi_cuda_cnn_tpu.serve import router as jax_router
from mpi_cuda_cnn_tpu.serve import transport as jax_transport
from mpi_cuda_cnn_tpu.serve.bench import diurnal_warp as jax_diurnal_warp
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.fleet import (
    make_fleet_workload as jax_make_fleet_workload,
)
from mpi_cuda_cnn_tpu.serve.scheduler import Request as JaxRequest
from mpi_cuda_cnn_tpu_torch.faults import FaultInjector
from mpi_cuda_cnn_tpu_torch.obs.slo import SLOSpec
from mpi_cuda_cnn_tpu_torch.serve import autoscale, handoff, router, transport
from mpi_cuda_cnn_tpu_torch.serve.bench import diurnal_warp, make_workload
from mpi_cuda_cnn_tpu_torch.serve.fleet import make_fleet_workload
from mpi_cuda_cnn_tpu_torch.serve.scheduler import Request
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)


def _outcome(fn, *args, **kw):
    """(True, value) or (False, exception type name and message)."""
    try:
        return True, fn(*args, **kw)
    except ValueError as e:
        return False, (type(e).__name__, str(e))


# ------------------------------------------------------------- handoff


@pytest.mark.parametrize("spec", [
    "prefill:2,decode:2", " decode:1 , prefill:3 ", "prefill:1",
    "prefill:0,decode:1", "prefill:1,decode:1,prefill:2", "mixed:1",
    "prefill:x,decode:1", "prefill:1:2,decode:1", "",
])
def test_parse_pools_matches_jax(spec):
    assert (_outcome(handoff.parse_pools, spec)
            == _outcome(jax_handoff.parse_pools, spec))


def test_page_crcs_context_crc_and_owner_match_jax():
    rng = np.random.default_rng(0)
    for n, cached, ps in [(1, 1, 4), (37, 36, 8), (64, 64, 16),
                          (50, 17, 16), (9, 0, 4)]:
        toks = rng.integers(0, 8192, n).astype(np.int32)
        crcs = handoff.page_crcs(toks, cached, ps)
        assert crcs == jax_handoff.page_crcs(toks, cached, ps)
        assert len(crcs) == -(-cached // ps)
        assert handoff.verify_page_crcs(crcs, toks, cached, ps)
        if crcs:
            bad = list(crcs)
            bad[-1] ^= 1
            assert not handoff.verify_page_crcs(bad, toks, cached, ps)
            assert not jax_handoff.verify_page_crcs(bad, toks, cached, ps)
        prompt, out = toks[: n // 2], [int(t) for t in toks[n // 2:]]
        assert (handoff.context_crc(prompt, out)
                == jax_handoff.context_crc(prompt, out))
        np.testing.assert_array_equal(
            handoff.context_tokens(prompt, out),
            jax_handoff.context_tokens(prompt, out))
    assert handoff.handoff_owner(3, 7) == jax_handoff.handoff_owner(3, 7)
    assert handoff.POOL_PHASES == jax_handoff.POOL_PHASES


# -------------------------------------------------------------- router


def test_fence_chain_stable_hash_and_state_digest_match_jax():
    crc = jcrc = 0
    for op in [("g", 1, "r0", 0), ("r", 1), ("g", 1, "r2", 1),
               ("g", 40000, "replica-12", 3)]:
        crc = router.fence_chain(crc, *op)
        jcrc = jax_router.fence_chain(jcrc, *op)
        assert crc == jcrc
    for parts in [(0,), ("s3", "r1"), (12345, "replica-0"), ("", ""),
                  (None, 1.5, "x")]:
        assert router.stable_hash(*parts) == jax_router.stable_hash(*parts)
    members = [("r0", "", False, True), ("r1", "decode", True, False)]
    handoffs = [(4, "copying", "r0", "r1"), (9, "pending", "r0", "")]
    tfields = {**{k: i for i, k in enumerate(transport.COUNTER_KEYS)},
               "inflight": 2, "unacked": 1,
               "links": [["router", "r0#0", 3]],
               "partitioned": [["r1", 40]]}
    for transport_tuple in (None, transport.transport_digest_tuple(tfields)):
        jt = (None if transport_tuple is None
              else jax_transport.transport_digest_tuple(tfields))
        assert transport_tuple == jt
        assert (router.fleet_state_digest(members, handoffs, 3, [5, 6], crc,
                                          transport=transport_tuple)
                == jax_router.fleet_state_digest(members, handoffs, 3,
                                                 [5, 6], crc, transport=jt))


class _Replica:
    """What the router reads of a replica: name, phase, load, route keys."""

    def __init__(self, name, phase=None):
        self.name, self.phase = name, phase
        self.load_value = 0.0
        self.route_keys = set()

    def load(self):
        return self.load_value


@pytest.mark.parametrize("policy", ["least_loaded", "session",
                                    "cache_aware"])
def test_router_pick_sequence_matches_jax(policy):
    """One seeded script of joins, leaves, loads, route-key changes,
    picks, grants, revokes and crashes through both routers: every pick,
    epoch, fence answer, backoff and circuit opening is equal."""
    ps = 4
    rng = np.random.default_rng(11)
    routers = [router.Router(policy, page_size=ps, max_flaps=2,
                             backoff_base=0.05),
               jax_router.Router(policy, page_size=ps, max_flaps=2,
                                 backoff_base=0.05)]
    reps = [{}, {}]
    prompts = [rng.integers(0, 6, int(rng.integers(3, 20))).astype(np.int32)
               for _ in range(8)]
    trail = [[], []]
    for step in range(160):
        op = int(rng.integers(0, 9))
        name = f"r{int(rng.integers(0, 5))}"
        k = int(rng.integers(0, len(prompts)))
        arg = int(rng.integers(0, 1000))
        for side in (0, 1):
            rt, rp, out = routers[side], reps[side], trail[side]
            if op == 0 and name not in rt.members:
                phase = None if arg % 3 else "decode"
                out.append(_outcome(lambda: rt.register(
                    rp.setdefault(name, _Replica(name, phase)), step).name))
            elif op == 1 and name in rt.members:
                rt.deregister(name)
                out.append(("left", name))
            elif op == 2 and name in rp:
                rp[name].load_value = float(arg % 7)
            elif op == 3 and name in rp:
                toks = prompts[k]
                rp[name].route_keys.update(
                    toks[:(i + 1) * ps].tobytes()
                    for i in range(len(toks) // ps))
            elif op == 4:
                req = (Request if side == 0 else JaxRequest)(
                    rid=step, prompt=prompts[k], max_new_tokens=4,
                    session=(arg % 5 if arg % 2 else None))
                m = rt.pick(req, phase=("decode" if arg % 11 == 0
                                        else None))
                out.append((m.name if m else None, rt.last_route_overlap))
            elif op == 5 and name in rt.members:
                out.append(rt.grant(arg % 10, name))
            elif op == 6:
                rid = arg % 10
                out.append((rt.fence_of(rid), rt.fence_ok(rid, name, 1)))
                rt.revoke(rid)
            elif op == 7 and name in rt.members:
                try:
                    out.append(rt.record_crash(name))
                except Exception as e:  # CircuitOpen in both packages
                    out.append(type(e).__name__)
            elif op == 8:
                rt.beat(name, step) if name in rt.members else None
                out.append(sorted(m.name for m in rt.stale(step)))
    assert trail[0] == trail[1]
    assert routers[0].fence_crc == routers[1].fence_crc
    assert routers[0].circuit_open == routers[1].circuit_open
    assert len(trail[0]) > 60


def test_router_config_errors_match_jax():
    for kw in [dict(policy="random"), dict(heartbeat_miss=0),
               dict(policy="cache_aware")]:
        assert (_outcome(router.Router, **kw)
                == _outcome(jax_router.Router, **kw))


# ----------------------------------------------------------- transport


def _walk(mod, injector, plan):
    """The seeded send/pump walk of the reference's conservation test,
    through `mod`'s bus; returns per-tick record fields and deliveries."""
    bus = mod.TransportBus(faults=injector(plan))
    got = []
    bus.register("router", lambda m, t: got.append(
        ("router", m.kind, m.src, m.seq, t)))
    for name in ("r0#0", "r1#0", "r2#1"):
        bus.register(name, lambda m, t, n=name: got.append(
            (n, m.kind, m.src, m.seq, t)))
    rng = np.random.default_rng(20)
    kinds = ["dispatch", "commit", "terminal", "hb"]
    records = []
    for tick in range(1, 120):
        bus.apply_tick_faults(tick)
        for _ in range(int(rng.integers(0, 4)) if tick < 30 else 0):
            kind = kinds[int(rng.integers(len(kinds)))]
            dst = ["r0#0", "r1#0", "r2#1"][int(rng.integers(3))]
            rid = int(rng.integers(6))
            if kind == "hb":
                bus.send("hb", dst, "router", {}, tick=tick)
            elif kind == "dispatch":
                bus.send("dispatch", "router", dst, {}, tick=tick,
                         key=(rid, "d", 0), reliable=True)
            else:
                k0 = "c" if kind == "commit" else "t"
                key = (rid, k0, 0, tick) if k0 == "c" else (rid, k0, 0)
                bus.send(kind, dst, "router", {}, tick=tick, key=key,
                         reliable=True)
        bus.pump(tick)
        f = bus.record_fields()
        assert (f["sent"]
                == f["delivered"] + f["deduped"] + f["dropped"]
                + f["inflight"]), f"conservation broken at tick {tick}"
        records.append(json.dumps(f, sort_keys=True))
        if tick >= 30 and not bus.busy():
            break
    assert not bus.busy()
    return records, got, bus.counters, bus.drain_retransmits()


def test_transport_bus_matches_jax_under_seeded_faults():
    plan = ";".join(
        f"msg_{k}@fleet.transport:{t}?count=2"
        for t, k in enumerate(["drop", "dup", "delay", "drop", "dup"],
                              start=2))
    plan += (";partition@fleet.transport:6?replica=1&ticks=4"
             ";msg_delay@fleet.transport:9?kind=commit&ticks=3"
             ";msg_drop@fleet.transport:11?replica=2")
    ours = _walk(transport, FaultInjector, plan)
    theirs = _walk(jax_transport, JaxFaultInjector, plan)
    assert ours == theirs
    c = ours[2]
    assert c["dropped"] > 0 and c["duped"] > 0 and c["delayed"] > 0
    assert c["retransmits"] > 0 and c["partitions"] == 1
    assert transport.COUNTER_KEYS == jax_transport.COUNTER_KEYS
    assert transport.TRANSPORT_SITE == jax_transport.TRANSPORT_SITE


# ----------------------------------------------------------- autoscale


@pytest.mark.parametrize("spec", [
    "on", "min=1,max=4,up=2,down=20", "min=2,max=3,high=1.5,low=0.2",
    "cooldown=0.01,burn=2", "min=3,max=2", "up=0", "speed=9", "min=x",
    "min", "",
])
def test_parse_autoscale_matches_jax(spec):
    ok, pol = _outcome(autoscale.parse_autoscale, spec)
    jok, jpol = _outcome(jax_autoscale.parse_autoscale, spec)
    assert ok == jok
    if ok:
        assert vars(pol) == vars(jpol)
    else:
        assert pol == jpol


SLO = {
    "tenants": {"*": {"availability": 0.99,
                      "ttft_ms": {"target": 0.9, "threshold_ms": 5.0}}},
    "burn": {"windows_s": [[0.05, 0.01]], "max_rate": 2.0},
}


@pytest.mark.parametrize("frontier", [0.0, 300.0])
def test_autoscaler_decisions_match_jax(tmp_path, frontier):
    """A seeded walk of loads, dispatch counts and terminals (good and
    bad) through both autoscalers: every decision is equal, and the walk
    scales both ways."""
    path = tmp_path / "slo.json"
    path.write_text(json.dumps(SLO))
    pol = "min=1,max=5,up=2,down=6,cooldown=0.002,burn=2"
    ours = autoscale.Autoscaler(autoscale.parse_autoscale(pol),
                                slo_spec=SLOSpec.load(path),
                                per_chip_rps=frontier)
    theirs = jax_autoscale.Autoscaler(jax_autoscale.parse_autoscale(pol),
                                      slo_spec=JaxSLOSpec.load(path),
                                      per_chip_rps=frontier)
    rng = np.random.default_rng(4)
    live, dispatched, out = 2, 0, []
    for tick in range(400):
        now = tick * 1e-3
        dispatched += int(rng.integers(0, 3))
        wave = 1.0 + np.sin(tick / 40.0)
        load = float(live * wave * rng.uniform(0.2, 2.5))
        for _ in range(int(rng.integers(0, 3))):
            # a burst of bad terminals trips the burn feed for a while
            good = not (100 <= tick < 130 and rng.uniform() < 0.5)
            term = {"id": tick, "tenant": "default",
                    "status": "finished" if good else "expired",
                    "ttft_ms": round(float(rng.uniform(0.5, 4.0)), 3),
                    "tpot_ms": 1.0, "queue_wait_ms": 0.5}
            ours.observe_terminal(dict(term), now)
            theirs.observe_terminal(dict(term), now)
        d = ours.step(now=now, live=live, load=load, dispatched=dispatched)
        assert d == theirs.step(now=now, live=live, load=load,
                                dispatched=dispatched)
        out.append(d)
        live += {"up": 1, "down": -1, None: 0}[d]
    assert "up" in out and "down" in out


def test_load_frontier_matches_jax(tmp_path):
    good = tmp_path / "good.jsonl"
    good.write_text("\n".join(json.dumps(r) for r in [
        {"event": "goodput", "kind": "cell", "best_per_chip_rps": 9.0},
        {"event": "goodput", "kind": "frontier", "best_per_chip_rps": 123.5},
    ]) + "\n")
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"event": "goodput", "kind": "frontier",
                               "best_per_chip_rps": 0}) + "\n")
    for p in (good, bad):
        assert (_outcome(autoscale.load_frontier, p)
                == _outcome(jax_autoscale.load_frontier, p))


# ------------------------------------------------------------ workloads


def _reqs_key(reqs):
    return [(r.rid, r.prompt.tobytes(), r.max_new_tokens, r.arrival,
             r.deadline, r.session, r.tenant) for r in reqs]


@pytest.mark.parametrize("amp,period", [(0.0, 10.0), (0.5, 0.2),
                                        (1.0, 0.05), (0.3, 1e-3)])
def test_diurnal_warp_matches_jax(amp, period):
    kw = dict(n=50, vocab=64, prompt_min=4, prompt_max=12, out_min=2,
              out_max=8, rate=300.0, seed=2, deadline_s=0.05)
    ours = diurnal_warp(make_workload(**kw), amp=amp, period_s=period)
    theirs = jax_diurnal_warp(jax_make_workload(**kw), amp=amp,
                              period_s=period)
    assert _reqs_key(ours) == _reqs_key(theirs)
    arrivals = [r.arrival for r in ours]
    assert arrivals == sorted(arrivals)
    for amp_, period_ in [(1.5, 1.0), (0.5, 0.0)]:
        assert (_outcome(diurnal_warp, [], amp=amp_, period_s=period_)
                == _outcome(jax_diurnal_warp, [], amp=amp_,
                            period_s=period_))


@pytest.mark.parametrize("extra", [
    {},
    dict(sessions=5, tenants=3, prefix_mix=0.6, templates=3,
         len_dist="lognormal"),
    dict(sessions=4, turns_dist="uniform:1-3", turn_gap_s=0.002,
         diurnal_amp=0.6, diurnal_period_s=0.1, deadline_s=0.2),
    dict(sessions=3, turns_dist="geometric:0.5", prefix_mix=0.5),
])
def test_make_fleet_workload_matches_jax(extra):
    kw = dict(n=40, vocab=64, prompt_min=4, prompt_max=24, out_min=2,
              out_max=12, rate=500.0, seed=7, **extra)
    ours, theirs = make_fleet_workload(**kw), jax_make_fleet_workload(**kw)
    assert _reqs_key(ours) == _reqs_key(theirs)
    assert zlib.crc32(repr(_reqs_key(ours)).encode()) != 0
