"""The port's serving faults, metrics registry and tick sink against the
JAX package's, on the CPU at a small size.

`squeeze` and `slow` at "serve.tick" on a deterministic clock, with
deadlines, a bounded queue and the watchdog: both engines must give the
same statuses, tokens, events and watchdog count, the same tick records
key for key (the clock is deterministic, so "now" too) and the same
registry snapshot; `crash` and `io` raise at the same tick; a
`tier.spill` fault without a host tier is refused in the reference's
words; the records a run writes validate against `obs/schema.py`.
"""

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.faults import InjectedCrash as JaxCrash
from mpi_cuda_cnn_tpu.faults import InjectedIOError as JaxIOError
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.faults import (
    FaultInjector,
    InjectedCrash,
    InjectedIOError,
)
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.obs.metrics import MetricsRegistry
from mpi_cuda_cnn_tpu_torch.obs.schema import load_records, validate_record
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, kv_heads=2)
KW = dict(slots=3, num_pages=14, page_size=4, prefill_chunk=8, max_len=40)
WL = dict(n=12, vocab=64, prompt_min=4, prompt_max=20, out_min=4,
          out_max=16, rate=80.0, seed=7, deadline_s=0.25, tenants=2)


class StepClock:
    """time_fn, sleep_fn and the injector's clock in one: every reading
    advances it by dt."""

    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def advance(self, s):
        self.t += s


def _engines():
    jm, tm = JaxLM(**CFG), TransformerLM(**CFG)
    jp = jm.init(jax.random.key(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    return (JaxEngine(jm, jp, **KW),
            PagedEngine(tm, tp, device="cpu", **KW))


PLANS = {
    "squeeze_slow": "squeeze@serve.tick:3?pages=9&ticks=12;"
                    "slow@serve.tick:8?s=0.05;slow@serve.tick:20?s=0.02",
    "squeeze_prefix": "squeeze@serve.tick:4?pages=8&ticks=20",
}


@pytest.mark.parametrize("plan", list(PLANS))
def test_serve_tick_faults_registry_and_ticks_match_jax(plan):
    jax_engine, engine = _engines()
    wl = dict(WL, prefix_mix=0.9 if plan == "squeeze_prefix" else 0.0)
    runs = []
    for eng, make, inj, reg in (
            (jax_engine, jax_make_workload, JaxFaultInjector, JaxRegistry),
            (engine, make_workload, FaultInjector, MetricsRegistry)):
        clock = StepClock()
        ticks = []
        registry = reg(clock=clock)
        res = eng.run(make(**wl), mode="continuous", time_fn=clock,
                      sleep_fn=clock.advance,
                      faults=inj(PLANS[plan], clock=clock), max_queue=4,
                      watchdog_s=0.004, registry=registry,
                      tick_sink=ticks.append,
                      prefix=plan == "squeeze_prefix")
        runs.append((res, ticks, registry.snapshot_fields(mode="x")))
    (want, wticks, wsnap), (got, gticks, gsnap) = runs
    assert [(r.rid, r.status, r.out) for r in got.requests] == \
        [(r.rid, r.status, r.out) for r in want.requests]
    assert got.events == want.events
    assert got.summary() == want.summary()
    assert gticks == wticks
    assert gsnap == wsnap
    kinds = {e["kind"] for e in got.events}
    assert "injected_squeeze" in kinds
    assert any("squeezed" in t for t in gticks)
    if plan == "squeeze_slow":
        assert {"injected_slow", "watchdog_slow_tick"} <= kinds
        assert got.watchdog_slow_ticks > 0
        assert len(got.status_counts()) > 1
    else:
        assert got.summary()["prefix_hits"] > 0
        assert "prefix" in gticks[-1]


@pytest.mark.parametrize("kind,exc,jexc", [("crash", InjectedCrash, JaxCrash),
                                           ("io", InjectedIOError,
                                            JaxIOError)])
def test_crash_and_io_at_serve_tick_raise_like_jax(kind, exc, jexc):
    jax_engine, engine = _engines()
    msgs = []
    for eng, make, inj, err in ((jax_engine, jax_make_workload,
                                 JaxFaultInjector, jexc),
                                (engine, make_workload, FaultInjector, exc)):
        faults = inj(f"{kind}@serve.tick:5")
        clock = StepClock()
        with pytest.raises(err) as e:
            eng.run(make(**WL), mode="continuous", faults=faults,
                    time_fn=clock, sleep_fn=clock.advance)
        msgs.append((str(e.value), faults.drain_events()))
    assert msgs[1] == msgs[0]


def test_tier_fault_without_a_tier_is_refused_in_the_reference_words():
    jax_engine, engine = _engines()
    errs = []
    for eng, make, inj in ((jax_engine, jax_make_workload, JaxFaultInjector),
                           (engine, make_workload, FaultInjector)):
        with pytest.raises(ValueError) as e:
            eng.run(make(**WL), faults=inj("kv_corrupt@tier.spill:0"))
        errs.append(str(e.value))
    assert errs[1] == errs[0]
    assert "need a host tier" in errs[1]


def test_serve_records_validate_against_the_schema(tmp_path):
    _, engine = _engines()
    path = tmp_path / "run.jsonl"
    clock = StepClock()
    with MetricsLogger(path=path, echo=False, clock=clock) as metrics:
        registry = MetricsRegistry(clock=clock)
        res = engine.run(make_workload(**WL), mode="continuous",
                         time_fn=clock, sleep_fn=clock.advance,
                         faults=FaultInjector(PLANS["squeeze_slow"],
                                              clock=clock),
                         registry=registry,
                         tick_sink=lambda rec: metrics.log("tick", **rec))
        registry.emit(metrics, mode="continuous", final=True)
        for rec in res.request_records():
            metrics.log("request", **rec)
        for ev in res.events:
            metrics.log("fault", **{"mode": "continuous", **ev})
        metrics.log("serve", bench="serve", **res.summary())
    records = load_records(path, strict=True)
    for rec in records:
        validate_record(rec)
    events = {r["event"] for r in records}
    assert events == {"tick", "metrics", "request", "fault", "serve"}
