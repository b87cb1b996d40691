"""The port's prefix sharing (copy-on-write through preemption) and host
spill tier (spill, readmit, CRC refusal) against the JAX package's, on
the CPU at a small size.

Both engines serve the same seeded template traffic on one
deterministic clock; every request's tokens, the `state_crc` chain and
the whole summary (prefix hits, COW copies, spills, readmits, refusals,
host evictions, statuses, preemptions) must be equal. Sharing and
spilling move no token: a sharing-on or spill-on run emits the
sharing-off run's tokens (float32, greedy). Tokens and counts are
compared exactly.
"""

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.serve import host_tier as jax_host_tier
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.faults import FaultInjector
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.serve import host_tier
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, kv_heads=2)
WORKLOAD = dict(n=12, vocab=64, prompt_min=10, prompt_max=32, out_min=2,
                out_max=12, rate=0.0, prefix_mix=0.9)


class StepClock:
    """time_fn and sleep_fn of one deterministic clock."""

    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def sleep(self, s):
        self.t += s


def _pair():
    jm, tm = JaxLM(**CFG), TransformerLM(**CFG)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


CASES = {
    # cache dtype, pages, templates, host pages, fault plan
    "cow_preempt_f32": ("float32", 9, 0, 0, None),
    "cow_preempt_int8": ("int8", 9, 0, 0, None),
    "spill_f32": ("float32", 16, 4, 32, None),
    "spill_small_host_int8": ("int8", 16, 4, 2, None),
    "spill_corrupt": ("float32", 16, 4, 32,
                      "kv_corrupt@tier.spill:0;kv_corrupt@tier.spill:3"),
}


def _run(engine, make, wl, host_pages, plan, injector):
    clock = StepClock()
    return engine.run(make(**wl), mode="continuous", prefix=True,
                      host_pages=host_pages,
                      faults=injector(plan) if plan else None,
                      time_fn=clock, sleep_fn=clock.sleep)


@pytest.mark.parametrize("case", list(CASES))
def test_prefix_and_tier_match_jax(case):
    cache_dtype, pages, templates, host_pages, plan = CASES[case]
    jm, jp, tm, tp = _pair()
    kw = dict(slots=3, num_pages=pages, page_size=8, prefill_chunk=8,
              max_len=44, cache_dtype=cache_dtype,
              weights_dtype=cache_dtype)
    wl = dict(WORKLOAD, seed=5, templates=templates)
    want = _run(JaxEngine(jm, jp, **kw), jax_make_workload, wl,
                host_pages, plan, JaxFaultInjector)
    eng = PagedEngine(tm, tp, attn_kernel="cuda", device="cpu", **kw)
    got = _run(eng, make_workload, wl, host_pages, plan, FaultInjector)
    assert [(r.rid, r.status, r.out) for r in got.requests] == \
        [(r.rid, r.status, r.out) for r in want.requests]
    assert got.summary() == want.summary()
    assert got.events == want.events
    s = got.summary()
    assert s["prefix_hits"] > 0 and s["prefix_cow"] > 0
    if host_pages:
        assert s["tier_spills"] > 0 and s["tier_readmits"] > 0
        if host_pages < 4:
            assert s["tier_host_evictions"] > 0
    else:
        assert s["preemptions"] > 0
    if plan:
        assert s["tier_refusals"] > 0
    if cache_dtype == "float32":
        # Sharing off (and so spilling off) emits the same tokens.
        clock = StepClock()
        off = eng.run(make_workload(**wl), mode="continuous",
                      time_fn=clock, sleep_fn=clock.sleep)
        assert {r.rid: r.out for r in off.requests} == \
            {r.rid: r.out for r in got.requests}
        assert off.prefill_chunks > got.prefill_chunks


def test_readmitted_page_reads_as_the_spilled_page():
    """spill_page then readmit_page into another page restores every
    layer's keys, values and int8 scales exactly; copy_page duplicates
    them."""
    _, _, tm, tp = _pair()
    eng = PagedEngine(tm, tp, slots=1, num_pages=6, page_size=8,
                      cache_dtype="int8", device="cpu")
    gen = np.random.default_rng(0)
    for c in eng._cache.pages:
        for t in c.values():
            vals = gen.integers(-100, 100, tuple(t.shape))
            t.copy_(t.new_tensor(vals))
    payload = eng.spill_page(2)
    eng.readmit_page(4, payload)
    eng.copy_page(2, 5)
    for c in eng._cache.pages:
        assert set(c) == {"k", "ks", "v", "vs"}
        for t in c.values():
            assert (t[4] == t[2]).all() and (t[5] == t[2]).all()


def test_host_tier_unit_matches_reference():
    """The same spill/lookup/take sequence through both tiers: stats,
    digests and refusals equal, the LRU bound and the CRC refusal
    held."""
    rng = np.random.default_rng(0)
    chunks = [rng.integers(0, 64, (8,)).astype(np.int32) for _ in range(6)]
    tiers = []
    for mod, inj in ((jax_host_tier, JaxFaultInjector),
                     (host_tier, FaultInjector)):
        faults = inj("kv_corrupt@tier.spill:4")
        tier = mod.HostTier(3, fault_poll=lambda seq, f=faults:
                            f.poll(mod.TIER_SPILL_SITE, seq))
        log = []
        for i, c in enumerate(chunks):
            tier.spill(c.tobytes() * 2, c, page=i)
            log.append(tier.digest_tuple())
        for i, c in enumerate(chunks):
            e = tier.lookup(c.tobytes() * 2, c)
            log.append(e is None)
            if e is not None:
                tier.take(e, page=9)
            log.append(tier.digest_tuple())
        log.append(tier.summary_fields())
        tiers.append(log)
    assert tiers[1] == tiers[0]
    assert tiers[1][-1] == {"tier_spills": 6, "tier_readmits": 2,
                            "tier_refusals": 1, "tier_host_evictions": 3}
    assert host_tier.chunk_crc(chunks[0]) == \
        jax_host_tier.chunk_crc(chunks[0])
    assert host_tier.empty_tier_fields() == jax_host_tier.empty_tier_fields()
    with pytest.raises(ValueError, match="host_pages"):
        host_tier.HostTier(0)
