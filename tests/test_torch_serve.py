"""The port's serving path (mpi_cuda_cnn_tpu_torch/serve/) against the
JAX package's, end to end on the CPU at a small size.

Weights come from the JAX `TransformerLM.init` and reach the port
through `convert.params_from_jax`. Workloads come from both packages'
`make_workload`, which must agree bit for bit. The engines must emit
the same tokens for every request and chain the same `state_crc` (the
per-iteration scheduler digest), in both batching modes, and with int8
cache and int8 weights, where the JAX side runs its Pallas kernels in
interpret mode and the port its plain versions.

Tolerance: logits of one forward atol 1e-4 (float32, sums in another
order). Tokens and digests are compared exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu.serve.paged_cache import (
    init_paged_cache as jax_init_paged_cache,
    paged_forward as jax_paged_forward,
)
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload, serve_bench
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from mpi_cuda_cnn_tpu_torch.serve.paged_cache import (
    init_paged_cache,
    paged_forward,
)
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

LOGIT_ATOL = 1e-4
CFG = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64)
WORKLOAD = dict(n=6, vocab=64, prompt_min=3, prompt_max=24, out_min=2,
                out_max=16, rate=0.0)


def _models(**over):
    cfg = {**CFG, **over}
    return JaxLM(**cfg), TransformerLM(**cfg)


def _params(jm, seed=0):
    jp = jm.init(jax.random.key(seed))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp))


def test_params_from_jax_round_trip():
    jm, _ = _models(kv_heads=2)
    jp, tp = _params(jm)
    flat_j = jax.tree_util.tree_leaves_with_path(jp)
    back = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))
    assert [p for p, _ in flat_j] == [p for p, _ in back]
    for (path, a), (_, b) in zip(flat_j, back):
        assert b.dtype == np.float32, path
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=str(path))


@pytest.mark.parametrize("over", [dict(), dict(kv_heads=2, pos="rope"),
                                  dict(kv_heads=1)],
                         ids=["mha", "gqa_rope", "mqa"])
def test_token_forward_logits_match_jax(over):
    """One prefill chunk then two decode steps through each package's
    paged_forward (token_forward + the gather read) at float32."""
    jm, tm = _models(**over)
    jp, tp = _params(jm)
    rng = np.random.default_rng(1)
    ps, chunk, b = 8, 6, 2
    jc = jax_init_paged_cache(jm, slots=b, num_pages=9, page_size=ps)
    tc = init_paged_cache(tm, slots=b, num_pages=9, page_size=ps)
    table = np.zeros((b, 8), np.int32)
    table[0, :2], table[1, :2] = [1, 2], [5, 3]
    jc = jc.__class__(pages=jc.pages, block_table=jnp.asarray(table),
                      page_size=ps, kernel="gather")
    tc.block_table = torch.from_numpy(table)
    steps = [(rng.integers(0, 64, (b, chunk)), np.arange(chunk)[None].repeat(b, 0))]
    steps += [(rng.integers(0, 64, (b, 1)), np.full((b, 1), chunk + i))
              for i in range(2)]
    for toks, pos in steps:
        toks, pos = toks.astype(np.int32), pos.astype(np.int32)
        valid = np.ones(toks.shape, bool)
        want, jc = jax_paged_forward(jm, jp, jnp.asarray(toks),
                                     jnp.asarray(pos), jnp.asarray(valid), jc)
        got, tc = paged_forward(tm, tp, torch.from_numpy(toks).long(),
                                torch.from_numpy(pos), torch.from_numpy(valid),
                                tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_ATOL)


@pytest.mark.parametrize("kw", [dict(seed=0), dict(seed=3, rate=50.0,
                                                   deadline_s=0.5),
                                dict(seed=5, tenants=3)],
                         ids=["burst", "poisson_deadline", "tenants"])
def test_make_workload_matches_jax(kw):
    args = {**WORKLOAD, **kw}
    want = jax_make_workload(**args)
    got = make_workload(**args)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert (a.rid, a.max_new_tokens, a.arrival, a.deadline, a.tenant) \
            == (b.rid, b.max_new_tokens, b.arrival, b.deadline, b.tenant)
        assert a.prompt.dtype == b.prompt.dtype
        np.testing.assert_array_equal(a.prompt, b.prompt)


ENGINE_CASES = {
    # mode, cache dtype, weights dtype, JAX read, pages (0 = ample)
    "static_f32": ("static", "float32", "float32", "gather", 0),
    "continuous_f32": ("continuous", "float32", "float32", "gather", 0),
    "continuous_f32_preempt": ("continuous", "float32", "float32",
                               "gather", 6),
    "continuous_int8": ("continuous", "int8", "int8", "pallas", 0),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax(case):
    mode, cache_dtype, weights_dtype, jax_read, pages = ENGINE_CASES[case]
    jm, tm = _models(kv_heads=2)
    jp, tp = _params(jm)
    ps, slots, max_len = 8, 3, 40
    pages = pages or slots * (max_len // ps) + 1
    kw = dict(slots=slots, num_pages=pages, page_size=ps, prefill_chunk=4,
              cache_dtype=cache_dtype, max_len=max_len,
              weights_dtype=weights_dtype)
    want = JaxEngine(jm, jp, attn_kernel=jax_read, **kw).run(
        jax_make_workload(seed=11, **WORKLOAD), mode=mode)
    before = dict(_kernels.launches)
    got = PagedEngine(tm, tp, attn_kernel="cuda", device="cpu", **kw).run(
        make_workload(seed=11, **WORKLOAD), mode=mode)
    assert _kernels.launches == before  # the CPU takes the plain versions
    assert [r.rid for r in got.requests] == [r.rid for r in want.requests]
    for a, b in zip(want.requests, got.requests):
        assert b.status == a.status == "finished"
        assert b.out == a.out, f"request {a.rid}"
    assert (got.decode_ticks, got.prefill_chunks, got.preemptions) == \
        (want.decode_ticks, want.prefill_chunks, want.preemptions)
    if case.endswith("preempt"):
        assert got.preemptions > 0
    assert got.state_crc == want.state_crc


class StepClock:
    """A clock that moves `dt` seconds each time it is read, and by the
    slept time when slept on: both engines read it at the same points
    of an iteration, so deadlines, the queue bound and the watchdog
    fire at the same iterations in both."""

    def __init__(self, dt):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t

    def sleep(self, s):
        self.t += s


def test_engine_deadlines_queue_bound_and_watchdog_match_jax():
    """Poisson arrivals with deadlines, a bounded admission queue and the
    watchdog, on a deterministic clock: every request reaches the same
    terminal status with the same tokens, the events are the same, and
    the digest chains agree."""
    jm, tm = _models(kv_heads=2)
    jp, tp = _params(jm)
    wl = dict(WORKLOAD, n=10, rate=100.0, deadline_s=0.1, seed=2)
    kw = dict(slots=2, num_pages=11, page_size=8, prefill_chunk=4,
              max_len=40)
    results = []
    for engine, make in ((JaxEngine(jm, jp, **kw), jax_make_workload),
                         (PagedEngine(tm, tp, device="cpu", **kw),
                          make_workload)):
        clock = StepClock(0.001)
        results.append(engine.run(make(**wl), mode="continuous",
                                  time_fn=clock, sleep_fn=clock.sleep,
                                  max_queue=2, watchdog_s=0.004))
    want, got = results
    statuses = {r.status for r in want.requests}
    assert {"finished", "expired", "rejected"} <= statuses, statuses
    assert want.watchdog_slow_ticks > 0
    assert [(r.rid, r.status, r.out) for r in got.requests] == \
        [(r.rid, r.status, r.out) for r in want.requests]
    assert got.events == want.events
    assert got.request_records() == want.request_records()
    assert got.summary() == want.summary()
    assert got.state_crc == want.state_crc


def test_serve_bench_on_cpu_prints_the_summary_keys():
    """The bench entry point on the CPU: one line per mode with the JAX
    bench's summary keys, the device, and zero kernel launches."""
    out = serve_bench(["--device", "cpu", "--dim", "32", "--depth", "1",
                       "--heads", "4", "--kv-heads", "2", "--vocab", "64",
                       "--max-seq", "64", "--requests", "3",
                       "--prompt-min", "3", "--prompt-max", "12",
                       "--out-min", "2", "--out-max", "6",
                       "--page-size", "8", "--prefill-chunk", "4",
                       "--cache-dtype", "auto", "--attn-kernel", "cuda",
                       "--decode-weights-dtype", "auto"])
    assert [line["mode"] for line in out["lines"]] == ["static", "continuous"]
    for line in out["lines"]:
        assert line["device"] == "cpu"
        assert line["cache_dtype"] == "int8"
        assert line["weights_dtype"] == "int8"
        assert line["statuses"] == {"finished": 3}
        assert line["kernel_launches"] == {"paged_attention": 0, "int8_gemm": 0}
        for key in ("tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                    "decode_ticks", "prefill_chunks", "state_crc"):
            assert key in line
