"""The port's SLO layer (obs/slo.py's accounting, obs/alerts.py, the
SLOScheduler and its tenant grammars) against the JAX package's, on the
CPU at a small size.

Grammars and their errors, burn rates on a fake clock, and the SLO
scheduler's admission and victim order must agree bit for bit; both
engines serve the same multi-tenant workload under one policy and must
give every request the same tokens, status and quota wait, and chain
the same `state_crc`; the alert engine, attached live to each package's
metrics logger on a FakeClock run with injected slow ticks, must fire
the same alerts (`alerts_crc` equal).
"""

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.faults import FakeClock as JaxFakeClock
from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.obs import alerts as jax_alerts
from mpi_cuda_cnn_tpu.obs import slo as jax_slo
from mpi_cuda_cnn_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from mpi_cuda_cnn_tpu.serve import scheduler as jax_sched
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxLogger
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.faults import FakeClock, FaultInjector
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.obs import alerts, slo
from mpi_cuda_cnn_tpu_torch.obs.metrics import MetricsRegistry
from mpi_cuda_cnn_tpu_torch.serve import scheduler as torch_sched
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, kv_heads=2)
SPEC = {
    "tenants": {"*": {"availability": 0.9,
                      "ttft_ms": {"target": 0.9, "threshold_ms": 200.0}},
                "t0": {"availability": 0.95,
                       "queue_wait_ms": {"target": 0.8,
                                         "threshold_ms": 50.0}}},
    "burn": {"windows_s": [[0.5, 0.1]], "max_rate": 2.0},
    "rules": [{"name": "tick-stale", "kind": "absence", "event": "tick",
               "max_gap_s": 0.1},
              {"name": "deep-queue", "kind": "threshold", "event": "tick",
               "field": "queue", "op": ">=", "value": 3},
              {"name": "pages-drop", "kind": "rate_of_change",
               "event": "tick", "field": "free_pages",
               "max_fall_pct": 50.0}],
}


class StepClock:
    """time_fn and sleep_fn of one deterministic clock: every reading
    advances it by dt."""

    def __init__(self, dt=0.002):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def advance(self, s):
        self.t += s


def _pair():
    jm, tm = JaxLM(**CFG), TransformerLM(**CFG)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("text", [
    "t0=2, t1=0", "t0:high", "a=1,,b=-2", "t0=x",
])
def test_tenant_priorities_grammar_matches_reference(text):
    def parse(mod):
        try:
            return mod.parse_tenant_priorities(text)
        except ValueError as e:
            return ("error", str(e))
    assert parse(torch_sched) == parse(jax_sched)


@pytest.mark.parametrize("text", [
    "t0=pages:8/slots:2,t1=slots:1", "t0=gpus:1", "t0", "t0=pages:x",
    "t0=slots:1/", "a=pages:3,b=pages:4/slots:0",
])
def test_tenant_quotas_grammar_matches_reference(text):
    def parse(mod):
        try:
            return mod.parse_tenant_quotas(text)
        except ValueError as e:
            return ("error", str(e))
    assert parse(torch_sched) == parse(jax_sched)


def test_spec_and_burn_rates_match_reference_on_a_fake_clock():
    """The same terminal events at FakeClock times through both
    Accountants: every (tenant, metric) burn rate in every window, the
    budget math and the spec errors agree."""
    rng = np.random.default_rng(0)
    accs = [mod.Accountant(mod.SLOSpec.from_dict(SPEC))
            for mod in (jax_slo, slo)]
    clock = FakeClock()
    statuses = ["finished"] * 6 + ["expired", "failed", "rejected",
                                   "cancelled"]
    for i in range(60):
        clock.advance(float(rng.exponential(0.02)))
        term = {"status": statuses[int(rng.integers(0, len(statuses)))],
                "tenant": f"t{int(rng.integers(0, 3))}",
                "ttft_ms": float(rng.uniform(0, 400)),
                "queue_wait_ms": float(rng.uniform(0, 100))}
        seen = [[(t, o.metric, g) for t, o, _, g in a.observe(term, clock())]
                for a in accs]
        assert seen[1] == seen[0]
        for key, we in accs[0].events.items():
            twin = accs[1].events[key]
            for w in we.windows_s:
                obj = next(o for o in accs[0].spec.objectives(key[0])
                           if o.metric == key[1])
                assert twin.burn_rate(w, obj.target) == \
                    we.burn_rate(w, obj.target)
            assert twin.worst_burn() == we.worst_burn()
    assert accs[1].tenants() == accs[0].tenants()
    for good, bad, target in ((9, 1, 0.9), (0, 0, 0.9), (5, 5, 0.99)):
        assert slo.budget_remaining(good, bad, target) == \
            jax_slo.budget_remaining(good, bad, target)
    for bad_spec in ({}, {"tenants": {}}, {"tenants": {"*": 3}},
                     {"tenants": {"*": {"ttft_ms": 0.9}}},
                     {"tenants": {"*": {"latency": 0.9}}},
                     {"tenants": {"*": {"availability": 0.9}},
                      "burn": {"windows_s": [[1, 2]]}}):
        errs = []
        for mod in (jax_slo, slo):
            with pytest.raises(ValueError) as e:
                mod.SLOSpec.from_dict(bad_spec)
            errs.append(str(e.value))
        assert errs[1] == errs[0]


def _admission_trace(mod):
    """The reference's quota and victim scenarios on one package."""
    pool = mod.PagePool(33)
    sched = mod.SLOScheduler(
        slots=4, pool=pool, page_size=4, max_len=32,
        policy=mod.SLOPolicy(slot_quota={"t0": 1}, page_quota={"t0": 8}))
    rng = np.random.default_rng(0)
    reqs = [mod.Request(rid=i, prompt=rng.integers(0, 13, (6,)),
                        max_new_tokens=4, tenant="t0") for i in range(4)]
    reqs.append(mod.Request(rid=9, prompt=rng.integers(0, 13, (6,)),
                            max_new_tokens=4, tenant="t1"))
    sched.submit(reqs)
    trace = [[(s.req.rid, s.req.tenant) for s in sched.admit(0.0)]]
    trace.append(sched.admit(0.5))
    trace.append([r.quota_wait_s for r in reqs])
    trace.append(sched.drain_blocked())
    sched.check()
    pool = mod.PagePool(7)
    sched = mod.SLOScheduler(slots=3, pool=pool, page_size=4, max_len=24,
                             policy=mod.SLOPolicy(priorities={"gold": 2}))
    reqs = [mod.Request(rid=0, prompt=rng.integers(0, 13, (4,)),
                        max_new_tokens=12, tenant="bulk"),
            mod.Request(rid=1, prompt=rng.integers(0, 13, (4,)),
                        max_new_tokens=12, tenant="gold")]
    sched.submit(reqs)
    bound = sched.admit(0.0)
    trace.append([s.req.rid for s in bound])
    for s in bound:
        s.cached = s.target
        s.req.out.append(1)
    while sched.preemptions == 0:
        for s in list(sched.decode_slots()):
            s.cached += 1
            s.req.out.append(1)
        sched.grow_for_decode()
        sched.check()
    trace.append([r.preemptions for r in reqs])
    trace.append(sched.drain_preempted())
    return trace


def test_slo_scheduler_admission_and_victims_match_reference():
    want = _admission_trace(jax_sched)
    got = _admission_trace(torch_sched)
    assert got == want
    assert [t for _, t in got[0]].count("t0") == 1
    assert got[4] == [1, 0] and got[5] == [1, 0]


def test_slo_engine_matches_jax():
    """Three tenants under priorities and quotas over a tight pool, with
    deadlines: tokens, statuses, quota waits, preemptions, the tenant
    blocks and the digest chain equal."""
    jm, jp, tm, tp = _pair()
    kw = dict(slots=3, num_pages=10, page_size=8, prefill_chunk=8,
              max_len=40)
    wl = dict(n=14, vocab=64, prompt_min=6, prompt_max=24, out_min=4,
              out_max=16, rate=60.0, seed=3, tenants=3, deadline_s=0.4)
    res = []
    for mod, engine, make in (
            (jax_sched, JaxEngine(jm, jp, **kw), jax_make_workload),
            (torch_sched, PagedEngine(tm, tp, device="cpu", **kw),
             make_workload)):
        policy = mod.SLOPolicy(
            priorities={"t1": 2},
            slot_quota={"t0": 1}, page_quota={"t2": 6},
            slo_spec=(jax_slo if mod is jax_sched else slo)
            .SLOSpec.from_dict(SPEC))
        clock = StepClock()
        res.append(engine.run(make(**wl), mode="continuous", policy=policy,
                              prefix=True, time_fn=clock,
                              sleep_fn=clock.advance))
    want, got = res
    assert got.request_records() == want.request_records()
    assert [r.out for r in got.requests] == [r.out for r in want.requests]
    assert got.summary() == want.summary()
    assert got.events == want.events
    assert any(r.quota_wait_s > 0 for r in got.requests)
    assert len(got.status_counts()) > 1


def _live_alerts(pkg, tmp_path):
    """One FakeClock serve run of `pkg` with the alert engine attached
    live to the metrics logger and slow faults injected."""
    (alerts_mod, slo_mod, clock_cls, inj, logger, registry_cls, engine,
     make) = pkg
    clock = clock_cls()
    ae = alerts_mod.AlertEngine(slo=slo_mod.SLOSpec.from_dict(SPEC))
    wl = dict(n=10, vocab=64, prompt_min=4, prompt_max=12, out_min=6,
              out_max=18, rate=40.0, seed=5, deadline_s=0.3, tenants=2)
    with logger(path=tmp_path, echo=False, clock=clock) as metrics:
        ae.attach(metrics)
        faults = inj("slow@serve.tick:10?s=0.15;slow@serve.tick:20?s=0.15;"
                     "squeeze@serve.tick:24?pages=6&ticks=20", clock=clock)
        res = engine.run(make(**wl), mode="continuous", time_fn=clock,
                         sleep_fn=clock.advance, faults=faults,
                         registry=registry_cls(clock=clock),
                         tick_sink=lambda rec: metrics.log("tick", **rec))
        for rec in res.request_records():
            metrics.log("request", **rec)
    return ae, res


def test_alert_engine_alerts_match_reference(tmp_path):
    jm, jp, tm, tp = _pair()
    kw = dict(slots=3, num_pages=10, page_size=4, prefill_chunk=8,
              max_len=40)
    want, wres = _live_alerts(
        (jax_alerts, jax_slo, JaxFakeClock, JaxFaultInjector, JaxLogger,
         JaxRegistry, JaxEngine(jm, jp, **kw), jax_make_workload),
        tmp_path / "jax.jsonl")
    got, gres = _live_alerts(
        (alerts, slo, FakeClock, FaultInjector, MetricsLogger,
         MetricsRegistry, PagedEngine(tm, tp, device="cpu", **kw),
         make_workload),
        tmp_path / "torch.jsonl")
    assert [r.out for r in gres.requests] == [r.out for r in wres.requests]
    assert {a["kind"] for a in want.alerts} >= {"absence", "burn_rate",
                                                "threshold"}
    assert got.alerts == want.alerts
    assert got.crc == want.crc
    # Replaying the port's file reproduces its live sequence.
    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records

    replay = alerts.AlertEngine(slo=slo.SLOSpec.from_dict(SPEC))
    replay.replay(load_records(tmp_path / "torch.jsonl"))
    assert replay.crc == got.crc
    logged = [r for r in load_records(tmp_path / "torch.jsonl")
              if r["event"] == "alert"]
    assert alerts.alerts_crc(logged) == got.crc
