"""The counted step (`obs/cost.py`) and the `program` records of the
port's trainers, on the CPU.

- Each kernel's nominal work (`gemm_flops`, `conv_flops`,
  `attention_flops`, `paged_attention_flops`, `int8_gemv_flops`, what its
  wrapper adds to the open counter on the card) equals
  FlopCounterMode's count of its plain version, at every shape the
  port's paths give the wrapper (caught from a CNN step, an LM step and
  a serving run here, f32 and bf16) and at the card's flagship shapes
  (on the meta device).
- The CNN step's record carries the JAX trainer's label, counting and
  steps_per_dispatch at the Config of tests/test_obs.py's telemetry run,
  and its FLOPs are within FLOPS_RTOL of the JAX record's (XLA counts the
  compiled program; the port counts the ops and kernels as they run).
- The LM flagship's step counted on the meta device gives the count the
  CPU's plain path gives at a width the CPU can run (the count
  `chip_smoke.py` holds the card's kernel path to).
- A counted step leaves every parameter bit for bit where an uncounted
  step leaves it.
"""

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import get_model as jax_get_model
from mpi_cuda_cnn_tpu.obs.schema import load_records as jax_load_records
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.obs import cost
from mpi_cuda_cnn_tpu_torch.obs.report import summarize
from mpi_cuda_cnn_tpu_torch.obs.schema import load_records, make_record
from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa
from mpi_cuda_cnn_tpu_torch.ops import gemv
from mpi_cuda_cnn_tpu_torch.ops import kernel_ops as ko
from mpi_cuda_cnn_tpu_torch.ops import paged_attention as pa
from mpi_cuda_cnn_tpu_torch.train.lm import make_lm_state, make_lm_train_step
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

FLOPS_RTOL = 0.03


def _flops(fn) -> int:
    mode = FlopCounterMode(display=False)
    with mode:
        fn()
    return mode.get_total_flops()


# plain version -> (its module, the nominal work of a call's arguments)
def _gemm_work(a, b, *, trans_a=False, trans_b=False, bias=None):
    m, k = a.shape[::-1] if trans_a else a.shape
    n = b.shape[0] if trans_b else b.shape[1]
    return ko.gemm_flops(m, n, k)


def _conv_work(x, w, *, stride=1, pads=(0, 0, 0, 0), dil=1, flip=False):
    n, h, wd, c = x.shape
    kh, kw = w.shape[:2]
    o = w.shape[2] if flip else w.shape[3]
    oh, ow = ko.conv_out_hw(h, wd, kh, kw, stride, pads, dil)
    return ko.conv_flops(n, oh, ow, c, o, kh, kw)


def _dw_work(x, g, *, stride, padding, kh, kw):
    n, _, _, oh, ow, o = (*x.shape[:3], *g.shape[1:])
    return ko.conv_flops(n, oh, ow, x.shape[3], o, kh, kw)


def _conv_gemm_work(x, w, *, padding=0):
    n, h, wd, c = x.shape
    kh, kw, _, o = w.shape
    return ko.conv_flops(n, h + 2 * padding - kh + 1,
                         wd + 2 * padding - kw + 1, c, o, kh, kw)


def _attn_work(kernel):
    return lambda q, *rest, **kw: fa.attention_flops(kernel, *q.shape)


def _paged_work(q, c, positions, block_table, page_size):
    b, kk, h, hd = q.shape
    return pa.paged_attention_flops(b, kk, h, hd,
                                    block_table.shape[1] * page_size)


def _gemv_work(x, w):
    return gemv.int8_gemv_flops(x.shape[0], *w.q.shape)


PLAIN = {
    "gemm": (ko, "gemm_plain", _gemm_work),
    "conv_direct": (ko, "conv_direct_plain", _conv_work),
    "conv_dw": (ko, "conv_dw_plain", _dw_work),
    "conv_gemm": (ko, "conv_gemm_plain", _conv_gemm_work),
    "flash_fwd": (fa, "flash_forward_plain", _attn_work("fwd")),
    "flash_bwd_dq": (fa, "flash_bwd_dq_plain", _attn_work("dq")),
    "flash_bwd_dkv": (fa, "flash_bwd_dkv_plain", _attn_work("dkv")),
    "paged_attention": (pa, "paged_attend_plain", _paged_work),
    "int8_gemm": (gemv, "int8_gemv_plain", _gemv_work),
}


def _catch(monkeypatch, run) -> dict:
    """{kernel: [(args, kwargs), ...]}: the plain versions' calls that
    `run()` makes through the kernel wrappers."""
    calls = {name: [] for name in PLAIN}
    for name, (mod, fn_name, _) in PLAIN.items():
        orig = getattr(mod, fn_name)

        def spy(*a, _orig=orig, _name=name, **kw):
            calls[_name].append((a, kw))
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, fn_name, spy)
    run()
    monkeypatch.undo()
    return calls


def _sig(v):
    """A hashable signature of an argument: shapes and dtypes."""
    if isinstance(v, dict):
        return tuple(sorted((k, _sig(x)) for k, x in v.items()))
    if isinstance(v, torch.Tensor):
        return (tuple(v.shape), str(v.dtype))
    if isinstance(v, gemv.QuantW):
        return ("quantw", tuple(v.q.shape))
    return str(v)


def _check_calls(calls: dict, kernels) -> int:
    """Every caught call's nominal work against the plain version's
    count; returns the calls checked."""
    checked = 0
    for name in kernels:
        mod, fn_name, work = PLAIN[name]
        assert calls[name], f"{name}: the path made no call"
        seen = set()
        for a, kw in calls[name]:
            key = (tuple(_sig(t) for t in a),
                   tuple(sorted((k, _sig(v)) for k, v in kw.items())))
            if key in seen:
                continue
            seen.add(key)
            want = _flops(lambda: getattr(mod, fn_name)(*a, **kw))
            assert work(*a, **kw) == want, (name, key)
            checked += 1
    return checked


def _cnn_step(dtype, gemm=False):
    model = get_model("reference_cnn")
    cfg = Config(device="cpu", epochs=1, batch_size=32, use_kernels=True,
                 compute_dtype=dtype, log_every=0)
    if gemm:   # the stride-1 convs on K6, as conv-bench's rows
        x = torch.randn(4, 12, 12, 8, dtype=getattr(torch, dtype),
                        requires_grad=True)
        w = torch.randn(3, 3, 8, 16, dtype=getattr(torch, dtype),
                        requires_grad=True)
        return lambda: ko.conv2d_gemm_kernel(x, w, padding=1).sum().backward()
    tr = Trainer(model, synthetic_stripes(64, 32), cfg)
    x = torch.rand(32, 28, 28, 1)
    y = torch.nn.functional.one_hot(torch.arange(32) % 10, 10).float()
    return lambda: (tr.train_step(x, y), tr.predict(x))


def _lm_step(dtype):
    cfg = LMConfig(device="cpu", corpus="synthetic", dim=32, depth=1,
                   heads=4, kv_heads=2, seq_len=128, batch_size=2, steps=1,
                   attn_impl="flash", compute_dtype=dtype, log_every=0)
    tr = LMTrainer(cfg)
    tokens = torch.zeros(2, 128, dtype=torch.long)
    return lambda: tr.train_step(tr.state, tokens, tokens)


def _serve_run(cache):
    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
    from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine

    model = TransformerLM(vocab=64, dim=32, heads=4, kv_heads=2, depth=1,
                          max_seq=64)
    eng = PagedEngine(model, model.init(prng.key(0)), slots=3, num_pages=24,
                      page_size=8, prefill_chunk=8, cache_dtype=cache,
                      attn_kernel="cuda", weights_dtype="int8",
                      device="cpu")
    reqs = make_workload(n=4, vocab=64, prompt_min=4, prompt_max=20,
                         out_min=2, out_max=6, rate=0.0, seed=1)
    return lambda: eng.run(reqs, mode="continuous")


PATHS = {
    "cnn-float32": (lambda: _cnn_step("float32"),
                    ("gemm", "conv_direct", "conv_dw")),
    "cnn-bfloat16": (lambda: _cnn_step("bfloat16"),
                     ("gemm", "conv_direct", "conv_dw")),
    "conv_gemm-float32": (lambda: _cnn_step("float32", gemm=True),
                          ("conv_gemm", "conv_direct", "conv_dw")),
    "conv_gemm-bfloat16": (lambda: _cnn_step("bfloat16", gemm=True),
                           ("conv_gemm", "conv_direct", "conv_dw")),
    "lm-float32": (lambda: _lm_step("float32"),
                   ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    "lm-bfloat16": (lambda: _lm_step("bfloat16"),
                    ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")),
    "serve-float32": (lambda: _serve_run("float32"),
                      ("paged_attention", "int8_gemm")),
    "serve-int8": (lambda: _serve_run("int8"),
                   ("paged_attention", "int8_gemm")),
}


@pytest.mark.parametrize("path", list(PATHS))
def test_nominal_work_is_the_plain_count_on_each_path(monkeypatch, path):
    make, kernels = PATHS[path]
    run = make()
    assert _check_calls(_catch(monkeypatch, run), kernels) >= len(kernels)


# the card's shapes (chip_smoke.py): the CNN's FC products and convs at
# batch 32, the LM flagship's attention, conv-bench's stride-1 rows, the
# serve flagship's paged read and products
FLAGSHIP = [
    ("gemm", lambda t: ((t(32, 1568), t(1568, 200)), {})),
    ("gemm", lambda t: ((t(32, 200), t(200, 200)), {"trans_b": True})),
    ("gemm", lambda t: ((t(32, 1568), t(32, 200)), {"trans_a": True})),
    ("conv_direct", lambda t: ((t(32, 28, 28, 1), t(3, 3, 1, 16)),
                               {"stride": 2, "pads": (1, 1, 1, 1)})),
    ("conv_direct", lambda t: ((t(32, 7, 7, 32), t(3, 3, 16, 32)),
                               {"pads": (1, 2, 1, 2), "dil": 2,
                                "flip": True})),
    ("conv_dw", lambda t: ((t(32, 14, 14, 16), t(32, 7, 7, 32)),
                           {"stride": 2, "padding": 1, "kh": 3, "kw": 3})),
    ("conv_gemm", lambda t: ((t(128, 16, 16, 64), t(3, 3, 64, 128)),
                             {"padding": 1})),
    ("flash_fwd", lambda t: ((t(8, 2048, 8, 64), t(8, 2048, 8, 64),
                              t(8, 2048, 8, 64), True), {})),
    ("flash_bwd_dq", lambda t: ((t(8, 2048, 8, 64), t(8, 2048, 2, 64),
                                 t(8, 2048, 2, 64), t(8, 2048, 8, 64),
                                 t(64, 2048, dtype=torch.float32),
                                 t(64, 2048, dtype=torch.float32), True),
                                {})),
    ("flash_bwd_dkv", lambda t: ((t(8, 2048, 8, 96), t(8, 2048, 8, 96),
                                  t(8, 2048, 8, 96), t(8, 2048, 8, 96),
                                  t(64, 2048, dtype=torch.float32),
                                  t(64, 2048, dtype=torch.float32), True),
                                 {})),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", range(len(FLAGSHIP)))
def test_nominal_work_is_the_plain_count_at_the_flagship(case, dtype):
    name, make = FLAGSHIP[case]
    mod, fn_name, work = PLAIN[name]

    def t(*shape, dtype=dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    a, kw = make(t)
    assert work(*a, **kw) == _flops(lambda: getattr(mod, fn_name)(*a, **kw))


def test_paged_and_gemv_work_at_the_serve_flagship():
    """K1 and K2 at the serve flagship (8 slots, 8 heads over 2 kv heads,
    head dim 64, 16-token pages, 32 of them a slot; d 512 products)."""
    q = torch.randn(8, 1, 8, 64)
    pages = {"k": torch.randn(300, 16, 2, 64), "v": torch.randn(300, 16, 2, 64)}
    table = torch.randint(0, 300, (8, 32), dtype=torch.int32)
    pos = torch.full((8, 1), 400, dtype=torch.int32)
    assert _paged_work(q, pages, pos, table, 16) == _flops(
        lambda: pa.paged_attend_plain(q, pages, pos, table, 16))
    w = gemv.quantize_weight(torch.randn(512, 2048))
    x = torch.randn(8, 512)
    assert _gemv_work(x, w) == _flops(lambda: gemv.int8_gemv_plain(x, w))


@pytest.fixture(scope="module")
def jax_program(tmp_path_factory):
    """The JAX trainer's `program` record of tests/test_obs.py's telemetry
    run (reference_cnn, batch 32, 128 stripes)."""
    path = tmp_path_factory.mktemp("jax_prog") / "run.jsonl"
    cfg = JaxConfig(model="reference_cnn", epochs=1, batch_size=32,
                    log_every=2, eval_every=1, num_devices=1)
    with JaxMetrics(path, echo=False) as m:
        JaxTrainer(jax_get_model("reference_cnn"),
                   jax_stripes(num_train=128, num_test=32), cfg,
                   metrics=m).train()
    (rec,) = [r for r in jax_load_records(path) if r["event"] == "program"]
    return rec


def _port_program(tmp_path, **kw) -> dict:
    path = tmp_path / "run.jsonl"
    cfg = Config(device="cpu", model="reference_cnn", epochs=1,
                 batch_size=32, log_every=2, eval_every=1, **kw)
    with MetricsLogger(path, echo=False) as m:
        Trainer(get_model("reference_cnn"), synthetic_stripes(128, 32), cfg,
                metrics=m).train()
    (rec,) = [r for r in load_records(path, strict=True)
              if r["event"] == "program"]
    return rec


def test_cnn_program_is_the_jax_trainers(jax_program, tmp_path):
    rec = _port_program(tmp_path)
    for key in ("label", "counting", "steps_per_dispatch", "compute_dtype"):
        assert rec[key] == jax_program[key], key
    # the update is in place: nothing is aliased, no scratch is taken
    assert rec["backend"] == "cpu" and rec["collectives"] == {}
    assert (rec["aliased_outputs"], rec["alias_bytes"],
            rec["temp_bytes"]) == (0, None, None)
    assert rec["flops"] == pytest.approx(jax_program["flops"],
                                         rel=FLOPS_RTOL)
    assert rec["bytes"] > 0


def test_cnn_kernel_path_counts_the_dilated_input_gradient(tmp_path):
    """With --use-kernels the step counts K4's input gradient as its plain
    version computes it: the transposed conv over the stride-dilated
    cotangent, zero rows and columns included. reference_cnn's one
    strided conv with an input gradient (conv2, 14x14x16 -> 7x7x32, 3x3,
    stride 2) then counts its 14x14 output positions where the torch ops'
    `convolution_backward` counts the 7x7 of the forward."""
    ops = _port_program(tmp_path / "ops")
    kern = _port_program(tmp_path / "kern", use_kernels=True)
    assert (kern["label"], kern["counting"]) == (ops["label"],
                                                 ops["counting"])
    assert kern["flops"] - ops["flops"] == (
        ko.conv_flops(32, 14, 14, 32, 16, 3, 3)
        - ko.conv_flops(32, 7, 7, 32, 16, 3, 3))


def test_cnn_counts_alike_in_both_compute_types_and_routes(tmp_path):
    """FLOPs depend on the shapes only: float32 and bf16 compute, the
    device-resident and per-batch routes, all count the same step."""
    got = {(dt, scan): _port_program(tmp_path / f"{dt}{scan}",
                                     use_kernels=True, compute_dtype=dt,
                                     scan=scan)
           for dt in ("float32", "bfloat16") for scan in (True, False)}
    assert len({r["flops"] for r in got.values()}) == 1
    assert got["bfloat16", True]["compute_dtype"] == "bfloat16"
    assert got["float32", False]["label"] == "train_step"


def _lm_count(dim, depth, heads, seq, batch, device, vocab=251):
    model = TransformerLM(vocab=vocab, dim=dim, heads=heads, depth=depth,
                          max_seq=seq)
    opt = make_optimizer(3e-4)
    state = make_lm_state(model, opt, device=device)
    step = make_lm_train_step(model, opt, attn_impl="flash", seq_len=seq,
                              device=device)
    tokens = torch.zeros(batch, seq, dtype=torch.long, device=device)
    with cost.count_step() as count:
        step(state, tokens, tokens)
    return count


def test_lm_meta_count_is_the_cpu_plain_count():
    shape = dict(dim=64, depth=2, heads=4, seq=128, batch=2)
    meta = _lm_count(**shape, device="meta")
    cpu = _lm_count(**shape, device="cpu")
    assert meta.flops == cpu.flops > 0
    assert meta.bytes == cpu.bytes > 0


def test_lm_program_record(tmp_path):
    path = tmp_path / "lm.jsonl"
    cfg = LMConfig(device="cpu", corpus="synthetic", dim=32, depth=1,
                   heads=2, seq_len=128, batch_size=2, steps=2,
                   attn_impl="flash", log_every=1)
    with MetricsLogger(path, echo=False) as m:
        trainer = LMTrainer(cfg, metrics=m)
        trainer.train()
    (rec,) = [r for r in load_records(path, strict=True)
              if r["event"] == "program"]
    assert (rec["label"], rec["counting"], rec["steps_per_dispatch"]) == (
        "lm_train_step", "program", 1)
    want = _lm_count(dim=32, depth=1, heads=2, seq=128, batch=2,
                     device="meta", vocab=trainer.model.vocab)
    assert rec["flops"] == want.flops


def _params_after(make_trainer, sink) -> list:
    with MetricsLogger(sink, echo=False) as m:
        tr = make_trainer(m, str(sink) if sink else None)
        tr.train()
    return [t.detach().clone() for t in tree_leaves(tr.state["params"])]


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
def test_counted_cnn_step_changes_no_parameter(tmp_path, scan):
    def make(m, sink):
        cfg = Config(device="cpu", epochs=1, batch_size=32, log_every=3,
                     use_kernels=True, scan=scan, metrics_jsonl=sink)
        return Trainer(get_model("reference_cnn"), synthetic_stripes(128, 32),
                       cfg, metrics=m)

    counted = _params_after(make, tmp_path / "run.jsonl")
    plain = _params_after(make, None)
    assert any(r["event"] == "program"
               for r in load_records(tmp_path / "run.jsonl"))
    for a, b in zip(counted, plain):
        assert torch.equal(a, b)


def test_counted_lm_step_changes_no_parameter(tmp_path):
    def make(m, sink):
        cfg = LMConfig(device="cpu", corpus="synthetic", dim=32, depth=1,
                       heads=2, seq_len=128, batch_size=2, steps=3,
                       attn_impl="flash", log_every=1, metrics_jsonl=sink)
        return LMTrainer(cfg, metrics=m)

    counted = _params_after(make, tmp_path / "lm.jsonl")
    plain = _params_after(make, None)
    for a, b in zip(counted, plain):
        assert torch.equal(a, b)


def test_collectives_take_the_hlo_names():
    before = {"all_reduce": 3, "broadcast": 1, "send": 0, "recv": 0}
    after = {"all_reduce": 5, "broadcast": 1, "send": 2, "recv": 2,
             "all_gather": 1, "reduce_scatter": 4}
    assert cost.collective_counts(before, after) == {
        "all-reduce": 2, "all-gather": 1, "reduce-scatter": 4,
        "collective-permute": 2}
    assert cost.collective_counts(before, before) == {}


def test_counts_do_not_nest():
    with cost.count_step():
        with pytest.raises(RuntimeError):
            with cost.count_step():
                pass
    assert cost.OPEN is None


def test_peak_and_mfu_of_a_card_record():
    assert cost.peak_flops("float32", backend="cpu") is None
    assert cost.peak_flops("bfloat16", backend="cuda") == 989e12
    assert cost.peak_flops("float32", backend="cuda") == 67e12
    assert cost.peak_flops("float32", override_tflops=500.0) == \
        pytest.approx(500e12 * 67 / 989)
    recs = [make_record("program", 0.0, label="train_step", flops=2e9,
                        bytes=1e8, collectives={}, backend="cuda",
                        compute_dtype="float32", steps_per_dispatch=1),
            make_record("step_phases", 1.0, steps=10,
                        phases_ms={"dispatch": 1.0, "device": 1.0})]
    (prog,) = summarize(recs)["programs"]
    assert prog["mfu"] == pytest.approx(2e9 / 2e-3 / 67e12)
    recs[0]["backend"] = "cpu"
    assert summarize(recs)["programs"][0]["mfu"] is None
    assert json.loads(json.dumps(summarize(recs)))


def test_the_counted_step_is_out_of_the_timer_mean():
    from mpi_cuda_cnn_tpu_torch.faults import FakeClock
    from mpi_cuda_cnn_tpu_torch.utils.profiling import StepTimer

    clock = FakeClock()
    timer = StepTimer(clock=clock)
    timer.start()
    with timer.exclude(steps=1):
        clock.advance(7.0)             # the counted step
    for _ in range(2):
        with timer.phase("dispatch"):
            clock.advance(0.5)
    timer.stop(3)
    assert timer.steps == 2 and timer.mean_step_ms == 500.0
    assert timer.phases_ms() == {"dispatch": 500.0}
