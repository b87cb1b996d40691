"""The port's fleet on EngineCompute (one PagedEngine per replica, shared
weights) against the JAX package's, on the CPU at the JAX fleet tests'
small width (TransformerLM vocab 13, dim 32, heads 4, depth 2). The
weights come from the JAX init through `convert.params_from_jax`; every
fleet's tokens, statuses and summary must equal the JAX fleet's on the
same workload and fault plan: a one-replica fleet (also against
PagedEngine.run) and a crash with resume and discard (also against the
crash-free fleet). `adopt_pages`, the engine's cross-engine page copy, is
held to a per-tensor copy (int8 scales included) and to the JAX engine's
errors. The disaggregated fleets are in test_torch_fleet_disagg.py.
"""

import contextlib
import functools
import io
import json
import shlex

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.serve import fleet as jax_fleet
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.faults import FakeClock, FaultInjector
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.serve import fleet
from mpi_cuda_cnn_tpu_torch.serve.bench import fleet_bench_main
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

CFG = dict(vocab=13, dim=32, heads=4, depth=2, max_seq=48)
GQA = dict(CFG, kv_heads=2)


@functools.cache
def _models(gqa: bool = False):
    cfg = GQA if gqa else CFG
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
    jp = jm.init(jax.random.key(0))
    return jm, jp, tm, params_from_jax(jax.tree.map(np.asarray, jp))


def _factory(side: str, geom: dict, *, gqa: bool = False, **eng):
    """compute_factory of `side`: one fresh engine per incarnation. The
    port's int8 run reads its pages through the kernel path (plain on the
    CPU), the JAX one through its gather."""
    jm, jp, tm, tp = _models(gqa)
    if side == "torch":
        kw = dict(eng, attn_kernel="cuda") if gqa else eng
        return lambda name: fleet.EngineCompute(PagedEngine(
            tm, tp, device="cpu", **geom, **kw))
    return lambda name: jax_fleet.EngineCompute(JaxEngine(jm, jp, **geom,
                                                          **eng))


def _fleet(side: str, factory, plan=None, **kw):
    mod, injector = ((fleet, FaultInjector) if side == "torch"
                     else (jax_fleet, JaxFaultInjector))
    return mod.Fleet(factory, faults=injector(plan) if plan else None, **kw)


def _reqs(side: str, **kw):
    mod = fleet if side == "torch" else jax_fleet
    return mod.make_fleet_workload(vocab=13, out_min=4, out_max=10,
                                   rate=300.0, **kw)


def _same(ours, theirs):
    assert ours.outputs() == theirs.outputs()
    assert ours.status_counts() == theirs.status_counts()
    assert ours.trace_crc == theirs.trace_crc
    assert ours.summary() == theirs.summary()


def test_single_replica_fleet_matches_paged_engine_run():
    """The same workload through PagedEngine.run and through a one-replica
    engine fleet: identical outputs, statuses and prefill chunks; and the
    fleet equals the JAX one-replica fleet."""
    geom = dict(slots=2, num_pages=13, page_size=8, max_len=48)
    wl = dict(n=12, prompt_min=4, prompt_max=10, seed=3)
    jm, jp, tm, tp = _models()
    clock = FakeClock()
    eng = PagedEngine(tm, tp, prefill_chunk=8, device="cpu", **geom).run(
        _reqs("torch", **wl), mode="continuous", time_fn=clock,
        sleep_fn=clock.advance)
    res = {side: _fleet(side, _factory(side, geom, prefill_chunk=8),
                        replicas=1, **geom).run(_reqs(side, **wl))
           for side in ("torch", "jax")}
    assert res["torch"].status_counts() == {"finished": 12}
    assert res["torch"].outputs() == {r.rid: list(r.out)
                                      for r in eng.requests}
    assert res["torch"].prefill_chunks == eng.prefill_chunks
    _same(res["torch"], res["jax"])


@pytest.mark.parametrize("redispatch", ["resume", "discard"])
def test_engine_fleet_crash_matches_crash_free_and_jax(redispatch):
    """A crash mid-storm re-dispatches in-flight requests to the other
    replica; every output equals the crash-free fleet's, and the crashed
    fleet equals the JAX crashed fleet (max_flaps=0: no rejoin)."""
    geom = dict(slots=2, num_pages=13, page_size=8, max_len=48)
    wl = dict(n=10, prompt_min=4, prompt_max=10, seed=1)
    kw = dict(replicas=2, redispatch=redispatch, max_flaps=0, **geom)
    plan = "replica_crash@fleet.tick:8?replica=0&zombie_ticks=2"
    crash = {side: _fleet(side, _factory(side, geom, prefill_chunk=8),
                          plan, **kw).run(_reqs(side, **wl))
             for side in ("torch", "jax")}
    clean = _fleet("torch", _factory("torch", geom, prefill_chunk=8),
                   **kw).run(_reqs("torch", **wl))
    assert crash["torch"].crashes == 1 and crash["torch"].redispatches > 0
    assert crash["torch"].status_counts() == clean.status_counts() == {
        "finished": 10}
    assert crash["torch"].outputs() == clean.outputs()
    _same(crash["torch"], crash["jax"])


@pytest.mark.parametrize("cache_dtype", ["float32", "int8"])
def test_adopt_pages_copies_every_pool_tensor(cache_dtype):
    jm, jp, tm, tp = _models(gqa=True)
    geom = dict(slots=2, num_pages=9, page_size=4, max_len=48,
                cache_dtype=cache_dtype, device="cpu")
    src, dst = (PagedEngine(tm, tp, **geom) for _ in range(2))
    gen = torch.Generator().manual_seed(0)
    for eng in (src, dst):
        for c in eng._cache.pages:
            for t in c.values():
                if t.dtype == torch.int8:
                    t.copy_(torch.randint(-127, 128, t.shape, generator=gen,
                                          dtype=torch.int8))
                else:
                    t.copy_(torch.randn(t.shape, generator=gen))
    before = [{k: t.clone() for k, t in c.items()} for c in dst._cache.pages]
    dst.adopt_pages(src, [3, 5, 1], [7, 2, 8])
    names = set()
    for c, sc, b in zip(dst._cache.pages, src._cache.pages, before):
        for name, t in c.items():
            names.add(name)
            want = b[name].clone()
            want[[7, 2, 8]] = sc[name][[3, 5, 1]]
            assert torch.equal(t, want), name
    assert names == ({"k", "v", "ks", "vs"} if cache_dtype == "int8"
                     else {"k", "v"})
    dst.adopt_pages(src, [], [])


def test_adopt_pages_errors_match_jax():
    jm, jp, tm, tp = _models()
    kw = dict(slots=2, num_pages=9, max_len=48)
    a = PagedEngine(tm, tp, page_size=4, device="cpu", **kw)
    b = PagedEngine(tm, tp, page_size=8, device="cpu", **kw)
    ja, jb = (JaxEngine(jm, jp, page_size=ps, **kw) for ps in (4, 8))
    msgs = []
    for dst, src in ((a, a), (ja, ja)):
        with pytest.raises(ValueError) as e:
            dst.adopt_pages(src, [1, 2], [3])
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("adopt_pages: 2 source pages vs 1 "
                                  "destinations")
    with pytest.raises(ValueError, match=r"adopt_pages across mismatched "
                       r"cache geometries \(page_size 8 vs 4, dtype "
                       r"float32 vs float32\)"):
        a.adopt_pages(b, [1], [1])
    with pytest.raises(ValueError, match=r"adopt_pages across mismatched "
                       r"cache geometries \(page_size 8 vs 4"):
        ja.adopt_pages(jb, [1], [1])


def _main(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{")], err.getvalue()


def test_fleet_bench_engine_needs_a_card_unless_cpu():
    """Without a card, --compute engine on the default device fails (exit
    1, no fallback); --compute sim needs no device."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, lines, err = _main(fleet_bench_main, shlex.split(
        "--compute engine --dim 32 --depth 1 --heads 4 --vocab 64 "
        "--requests 2"))
    assert rc == 1 and lines == []
    assert "torch.cuda.is_available() is False" in err
    rc, lines, _ = _main(fleet_bench_main, ["--requests", "3"])
    assert rc == 0 and lines[0]["statuses"] == {"finished": 3}
