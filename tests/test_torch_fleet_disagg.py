"""The port's disaggregated fleet on EngineCompute against the JAX
package's, on the CPU at the JAX fleet tests' small width (TransformerLM
vocab 13, dim 32, heads 4, depth 2; a GQA int8 variant with kv_heads 2),
weights from the JAX init through `convert.params_from_jax`. A prefill
replica hands each completed prefill's KV pages to a decode replica
(`adopt_pages`); the tokens must equal the unified fleet's and the JAX
disaggregated fleet's, with prefix sharing off and on, and in int8
through the kernel path's plain versions, where the scale rows must move
with the codes. `fleet-bench --compute engine --device cpu` matches the
JAX bench line for line.
"""

import contextlib
import functools
import io
import json
import shlex

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.faults import FaultInjector as JaxFaultInjector
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.serve import fleet as jax_fleet
from mpi_cuda_cnn_tpu.serve.bench import fleet_bench_main as jax_fleet_main
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.faults import FaultInjector
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


def _main(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, [json.loads(x) for x in out.getvalue().splitlines()
                if x.startswith("{")], err.getvalue()


@pytest.mark.parametrize("prefix", [False, True])
def test_engine_disagg_matches_unified_and_jax(prefix):
    """KV pages handed prefill -> decode through adopt_pages decode to the
    unified fleet's tokens; with prefix sharing on, through handoffs whose
    block tables lead with shared tree pages. Both fleets equal the JAX
    fleets."""
    geom = dict(slots=2, num_pages=17, page_size=4, max_len=48)
    wl = dict(n=14, prompt_min=6, prompt_max=12, seed=3,
              prefix_mix=0.7 if prefix else 0.0)
    pools = {"prefill": 1, "decode": 1}
    res = {side: _fleet(side, _factory(side, geom, prefill_chunk=8),
                        pools=pools, handoff_ticks=2, prefix=prefix,
                        **geom).run(_reqs(side, **wl))
           for side in ("torch", "jax")}
    res["torch"] = (res["torch"],
                    _fleet("torch", _factory("torch", geom, prefill_chunk=8),
                           replicas=2, prefix=prefix,
                           **geom).run(_reqs("torch", **wl)))
    disagg, unified = res["torch"]
    assert disagg.handoffs > 0 and disagg.handoff_pages > 0
    assert disagg.status_counts() == {"finished": 14}
    assert disagg.outputs() == unified.outputs()
    if prefix:
        assert disagg.prefix["prefix_hits"] > 0
    _same(disagg, res["jax"])


def test_engine_disagg_int8_gqa_moves_scales_and_matches_jax():
    """int8 KV pages and int8 weights at GQA: a disaggregated fleet with a
    crash of the decode replica mid-transfer and a corrupted handoff
    decodes the unified fleet's tokens, and the JAX fleet's. Were the
    scale rows left behind, the receiver would read the right codes under
    the wrong scales."""
    geom = dict(slots=3, num_pages=21, page_size=4, max_len=48)
    eng = dict(prefill_chunk=8, cache_dtype="int8", weights_dtype="int8")
    wl = dict(n=12, prompt_min=6, prompt_max=16, seed=5)
    plan = ("kv_corrupt@fleet.handoff:2?page=1;"
            "replica_crash@fleet.tick:12?replica=1")
    res = {side: _fleet(side, _factory(side, geom, gqa=True, **eng), plan,
                        pools={"prefill": 1, "decode": 1}, handoff_ticks=2,
                        backoff_base=0.0, **geom).run(_reqs(side, **wl))
           for side in ("torch", "jax")}
    disagg = res["torch"]
    unified = _fleet("torch", _factory("torch", geom, gqa=True, **eng),
                     replicas=2, **geom).run(_reqs("torch", **wl))
    assert disagg.handoffs > 0 and disagg.kv_refusals == 1
    assert disagg.crashes == 1
    assert disagg.status_counts() == {"finished": 12}
    assert disagg.outputs() == unified.outputs()
    _same(disagg, res["jax"])


def test_fleet_bench_engine_cpu_matches_jax():
    """`fleet-bench --compute engine --device cpu` at a GQA int8 width with
    a disaggregated pool pair and a zombie crash: the port's lines equal
    the JAX bench's (but the wall clock and the port's device,
    launch and forward counts); on the CPU no kernel launches, and the
    forwards summed over every incarnation cover the fleet's own
    counts."""
    base = ("--compute engine --device cpu --dim 32 --depth 1 --heads 4 "
            "--kv-heads 2 --vocab 64 --requests 8 --prompt-min 6 "
            "--prompt-max 20 --out-min 2 --out-max 8 --rate 400 --slots 3 "
            "--page-size 8 --prefill-chunk 8 --cache-dtype auto "
            "--decode-weights-dtype auto --seed 4 --pools prefill:1,decode:2 "
            "--fault-plan replica_crash@fleet.tick:9?replica=2&zombie_ticks=2")
    rc, lines, err = _main(fleet_bench_main,
                           shlex.split(base + " --attn-kernel cuda"))
    jrc, jlines, jerr = _main(jax_fleet_main,
                              shlex.split(base + " --attn-kernel gather"))
    assert rc == jrc == 0, (err, jerr)
    extra = ("device", "kernel_launches", "forwards")

    def strip(x):
        return {k: v for k, v in x.items() if k not in extra
                and not k.startswith("wall_")}

    assert [strip(x) for x in lines] == [strip(x) for x in jlines]
    line = lines[0]
    assert line["statuses"] == {"finished": 8} and line["handoffs"] > 0
    assert line["crashes"] == 1
    assert line["device"] == "cpu"
    assert line["kernel_launches"] == {"paged_attention": 0, "int8_gemm": 0}
    fw = line["forwards"]
    assert fw["replicas"] == 3 + line["restarts"]
    assert fw["decode_ticks"] >= line["decode_ticks"]
    assert fw["prefill_chunks"] >= line["prefill_chunks"]
