"""The port's speculative serving (serve/spec.py, the scheduler's
spec_width/commit_spec, the engine's verify block and its two draft
proposers) against the JAX package's, on the CPU at a small size.

The host halves (acceptance law, prompt lookup, page growth and rollback)
must give the same answers bit for bit. The engines run the same seeded
requests on one deterministic clock and must emit the same tokens per
request, chain the same `state_crc` and print the same summary; a
spec-on run must emit the spec-off run's tokens (float32, greedy). The
port's engine runs on the plain kernel versions; the float32 logits
agree with the JAX package's within test_torch_serve's LOGIT_ATOL, and
tokens and digests are compared exactly.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.serve import scheduler as jax_sched
from mpi_cuda_cnn_tpu.serve import spec as jax_spec
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.serve import scheduler as torch_sched
from mpi_cuda_cnn_tpu_torch.serve import spec
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, kv_heads=2)
DRAFT_CFG = dict(CFG, dim=16, depth=1)
WORKLOAD = dict(n=8, vocab=64, prompt_min=8, prompt_max=32, out_min=2,
                out_max=16, rate=0.0, prefix_mix=0.9)


def _models(cfg):
    return JaxLM(**cfg), TransformerLM(**cfg)


def _params(jm, seed):
    jp = jm.init(jax.random.key(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


class StepClock:
    """time_fn and sleep_fn of one deterministic clock: every reading
    advances it by dt."""

    def __init__(self, dt=0.001):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def sleep(self, s):
        self.t += s


# -- the host half ----------------------------------------------------


def _lookup_cases():
    rng = np.random.default_rng(0)
    cases = [np.asarray([1, 2, 3, 9, 9, 1, 2], np.int32),
             np.asarray([5, 6, 7], np.int32),
             np.asarray([4, 8, 4, 8], np.int32),
             np.asarray([1, 2, 5, 1, 2, 6, 1, 2], np.int32)]
    cases += [rng.integers(0, 4, (int(rng.integers(1, 40)),)).astype(np.int32)
              for _ in range(40)]
    return cases


def test_accept_len_and_lookup_propose_match_reference_seeded():
    rng = np.random.default_rng(1)
    for trial in range(64):
        k = int(rng.integers(2, 9))
        u = rng.integers(0, 5, (k,)).astype(np.int32)
        y = rng.integers(0, 5, (k,)).astype(np.int32)
        if trial % 2:
            n_match = int(rng.integers(0, k))
            u[1: 1 + n_match] = y[:n_match]
        assert spec.accept_len(u, y) == jax_spec.accept_len(u, y)
    for ctx in _lookup_cases():
        for n_props in (0, 1, 3, 7):
            for ngram in (1, 2, 3):
                np.testing.assert_array_equal(
                    spec.lookup_propose(ctx, n_props, ngram),
                    jax_spec.lookup_propose(ctx, n_props, ngram))


@settings(max_examples=60, deadline=None)
@given(ctx=st.lists(st.integers(0, 5), min_size=1, max_size=48),
       n_props=st.integers(0, 8), ngram=st.integers(1, 3),
       y=st.lists(st.integers(0, 5), min_size=1, max_size=8))
def test_accept_len_and_lookup_propose_match_reference_hypothesis(
        ctx, n_props, ngram, y):
    c = np.asarray(ctx, np.int32)
    got = spec.lookup_propose(c, n_props, ngram)
    want = jax_spec.lookup_propose(c, n_props, ngram)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    u = np.concatenate([c[-1:], got])[: len(y)]
    yy = np.asarray(y[: len(u)], np.int32)
    assert spec.accept_len(u, yy) == jax_spec.accept_len(u, yy)


def _growth_trace(mod):
    """The reference's growth/rollback scenario on one package's
    scheduler, returning every page count and width it passes."""
    pool = mod.PagePool(12)      # 11 usable pages of 4
    sched = mod.ContinuousScheduler(slots=2, pool=pool, page_size=4,
                                    max_len=44)
    req = mod.Request(rid=0, prompt=np.arange(6, dtype=np.int32) % 13,
                      max_new_tokens=24)
    sched.submit([req])
    (slot,) = sched.admit(0.0)
    slot.cached = slot.target
    req.out.append(1)
    trace = []
    assert sched.grow_for_decode(0.0, spec_k=8) == [slot]
    trace += [len(slot.pages), sched.spec_width(slot, 8), pool.free_pages]
    sched.commit_spec(slot, 3)
    trace += [slot.cached, len(slot.pages), pool.free_pages]
    sched.check()
    req2 = mod.Request(rid=1, prompt=np.arange(4, dtype=np.int32) % 13,
                       max_new_tokens=4)
    sched.submit([req2])
    (slot2,) = sched.admit(0.0)
    blocker = pool.try_alloc(pool.free_pages, "blocker")
    dslots = sched.grow_for_decode(0.0, spec_k=8)
    trace += [slot in dslots, sched.preemptions, sched.spec_width(slot, 8),
              list(slot.pages), list(slot2.pages)]
    pool.free(blocker, "blocker")
    sched.check()
    return trace


def test_spec_growth_and_rollback_match_reference():
    """grow_for_decode(spec_k=) grows toward the round's width without
    preempting; commit_spec rolls back pages of rejected rows."""
    want = _growth_trace(jax_sched)
    got = _growth_trace(torch_sched)
    assert got == want
    assert got[0] == pages_for(7 + 8, 4) and got[1] == 8
    assert got[4] == pages_for(7 + 3, 4)
    assert got[6] is True and got[7] == 0 and 1 <= got[8] < 8


# -- the engine -------------------------------------------------------

ENGINE_CASES = {
    # engine kwargs, run kwargs, pages (0 = ample)
    "lookup_prefix": (dict(spec="lookup", spec_k=4),
                      dict(prefix=True), 0),
    "lookup_preempt_int8": (dict(spec="lookup", spec_k=8,
                                 cache_dtype="int8", weights_dtype="int8"),
                            dict(), 9),
    "draft_window": (dict(spec="draft", spec_k=4, draft_cache="window"),
                     dict(), 0),
    "draft_paged": (dict(spec="draft", spec_k=4, draft_cache="paged"),
                    dict(prefix=True), 0),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_spec_matches_jax(case):
    ekw, rkw, pages = ENGINE_CASES[case]
    jm, tm = _models(CFG)
    jp, tp = _params(jm, 0)
    ps, slots, max_len = 8, 3, 48
    kw = dict(slots=slots, num_pages=pages or slots * (max_len // ps) + 1,
              page_size=ps, prefill_chunk=4, max_len=max_len, **ekw)
    jkw, tkw = dict(kw), dict(kw)
    if ekw["spec"] == "draft":
        djm, dtm = _models(DRAFT_CFG)
        djp, dtp = _params(djm, 1)
        jkw.update(draft_model=djm, draft_params=djp)
        tkw.update(draft_model=dtm, draft_params=dtp)
    results = []
    for engine, make in ((JaxEngine(jm, jp, **jkw), jax_make_workload),
                         (PagedEngine(tm, tp, attn_kernel="cuda",
                                      device="cpu", **tkw), make_workload)):
        clock = StepClock()
        results.append(engine.run(make(seed=11, **WORKLOAD), spec=True,
                                  time_fn=clock, sleep_fn=clock.sleep,
                                  **rkw))
    want, got = results
    assert [(r.rid, r.status, r.out) for r in got.requests] == \
        [(r.rid, r.status, r.out) for r in want.requests]
    assert got.summary() == want.summary()
    assert got.state_crc == want.state_crc
    assert want.spec["spec_accepted"] > 0
    if ENGINE_CASES[case][2]:
        assert want.preemptions > 0
    # Spec off emits the same tokens, in more ticks.
    before = dict(_kernels.launches)
    off_kw = {k: v for k, v in tkw.items()
              if k not in ("spec", "spec_k", "draft_model", "draft_params",
                           "draft_cache")}
    off = PagedEngine(tm, tp, attn_kernel="cuda", device="cpu",
                      **off_kw).run(make_workload(seed=11, **WORKLOAD),
                                    **rkw)
    assert _kernels.launches == before  # the CPU takes the plain versions
    if "int8" not in case:
        assert {r.rid: r.out for r in off.requests} == \
            {r.rid: r.out for r in got.requests}
    assert off.decode_ticks > got.decode_ticks


def test_spec_misconfiguration_errors_match_jax_word_for_word():
    jm, tm = _models(CFG)
    jp, tp = _params(jm, 0)
    kw = dict(slots=2, num_pages=13, page_size=8)
    cases = [dict(spec="nope"), dict(spec="lookup", spec_k=1),
             dict(spec="draft"), dict(draft_cache="disk"),
             dict(spec="draft", draft_model="other", draft_params={})]
    djm, dtm = _models(dict(CFG, vocab=32))
    for case in cases:
        jc, tc = dict(case), dict(case)
        if case.get("draft_model") == "other":
            jc["draft_model"], tc["draft_model"] = djm, dtm
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, jp, **kw, **jc)
        with pytest.raises(ValueError) as got:
            PagedEngine(tm, tp, device="cpu", **kw, **tc)
        assert str(got.value) == str(want.value)
    req = dict(n=1, vocab=64, prompt_min=4, prompt_max=4, out_min=4,
               out_max=4, rate=0.0, seed=0)
    for ekw, rkw in ((dict(), dict(spec=True)),
                     (dict(spec="lookup"), dict(spec=True, mode="static"))):
        with pytest.raises(ValueError) as want:
            JaxEngine(jm, jp, **kw, **ekw).run(jax_make_workload(**req),
                                               **rkw)
        with pytest.raises(ValueError) as got:
            PagedEngine(tm, tp, device="cpu", **kw, **ekw).run(
                make_workload(**req), **rkw)
        assert str(got.value) == str(want.value)
