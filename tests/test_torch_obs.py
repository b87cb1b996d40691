"""The port's observability sinks (`obs/schema.py`, `obs/metrics.py`,
`obs/trace.py`, `obs/device.py`, `utils/logging.py`,
`utils/profiling.py`; `--metrics-jsonl`, `--profile-dir`) against the
JAX package on the CPU (the twin of tests/test_obs.py).

The port's run files are read by the JAX package's own reader
(`obs.schema.load_records`, every record validated) and report
(`obs.report.summarize`), and by the port's own report, which gives the
same summary. For the same run the event sequence is the JAX trainers',
the `program` records included (the port counts its step as it runs,
`obs/cost.py`; the JAX package reads XLA's cost analysis). Step, epoch
and eval counts are equal; losses agree within LOSS_RTOL
(tests/test_torch_train.py's bound); times are not compared.
"""

import json

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.obs.metrics import MetricsRegistry as JaxRegistry
from mpi_cuda_cnn_tpu.obs.report import summarize as jax_summarize
from mpi_cuda_cnn_tpu.obs.schema import iter_runs as jax_iter_runs
from mpi_cuda_cnn_tpu.obs.schema import load_records as jax_load_records
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu.utils.profiling import StepTimer as JaxStepTimer
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.faults import FakeClock
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.obs import schema
from mpi_cuda_cnn_tpu_torch.obs.device import (
    emit_step_telemetry,
    memory_snapshot,
)
from mpi_cuda_cnn_tpu_torch.obs.metrics import (
    MetricsRegistry,
    log_bucket_bounds,
)
from mpi_cuda_cnn_tpu_torch.obs.report import summarize
from mpi_cuda_cnn_tpu_torch.obs.trace import current_path, span
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
from mpi_cuda_cnn_tpu_torch.utils.profiling import StepTimer, profile_trace
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

LOSS_RTOL = 1e-5
N_TRAIN, N_TEST, BATCH = 256, 64, 32


def _events(recs) -> list[str]:
    return [r["event"] for r in recs]


def _same_summary(recs) -> dict:
    """The port's report summary of `recs`, checked equal to the JAX
    report's."""
    ours = summarize(recs)
    assert ours == jax_summarize(recs)
    return ours


def test_schema_tables_are_the_references():
    from mpi_cuda_cnn_tpu.obs import schema as js

    assert schema.SCHEMA_VERSION == js.SCHEMA_VERSION
    assert schema.REQUIRED_KEYS == js.REQUIRED_KEYS
    assert schema.EVENT_KEYS == js.EVENT_KEYS
    assert schema.RUN_MARKER == js.RUN_MARKER
    assert log_bucket_bounds() == __import__(
        "mpi_cuda_cnn_tpu.obs.metrics", fromlist=["x"]).log_bucket_bounds()


@pytest.mark.parametrize("rec,ok", [
    ({"schema": 1, "event": "train", "t": 0.0, "step": 1, "loss": 2.0}, True),
    ({"schema": 1, "event": "train", "t": 0.0, "step": 1}, False),
    ({"schema": 1, "event": "free_form", "t": 0.0}, True),
    ({"schema": 2, "event": "eval", "t": 0.0}, False),
    ({"event": "eval", "t": 0.0}, False),
    ({"schema": "1", "event": "eval", "t": 0.0}, False)])
def test_validate_record_agrees_with_the_reference(rec, ok):
    from mpi_cuda_cnn_tpu.obs.schema import validate_record as jv

    for v in (schema.validate_record, jv):
        if ok:
            assert v(rec) is rec
        else:
            with pytest.raises(ValueError):
                v(rec)


def test_metrics_logger_writes_runs_the_reference_splits(tmp_path):
    p = tmp_path / "m.jsonl"
    for run in range(2):
        with MetricsLogger(p, echo=False, clock=FakeClock(5.0)) as m:
            m.log("train", step=run, loss=1.5)
            m.log("eval", ntests=4, ncorrect=run)
        assert not m.jsonl_enabled and m.sink_or_none() is None
    runs = list(jax_iter_runs(p))
    assert [len(r) for r in runs] == [2, 2]
    assert runs[1][0] == {"schema": 1, "event": "train", "t": 0.0,
                          "step": 1, "loss": 1.5}
    assert list(schema.iter_runs(p)) == runs
    assert p.read_text().count(schema.RUN_MARKER) == 2


def test_metrics_logger_closes_on_exception(tmp_path):
    p = tmp_path / "m.jsonl"
    with pytest.raises(RuntimeError):
        with MetricsLogger(p, echo=False) as m:
            m.log("train", step=1, loss=0.5)
            raise RuntimeError("boom")
    assert m._file is None
    assert [r["event"] for r in jax_load_records(p)] == ["train"]


def test_registry_snapshots_are_the_references():
    """The same observations under a fake clock: the same record."""
    clock = FakeClock(1.0)
    ours, theirs = MetricsRegistry(clock=clock), JaxRegistry(clock=clock)
    for reg in (ours, theirs):
        for v in (0.5, 3.0, 3.0, 250.0, 1e6, 1e-4):
            reg.observe("train.step_ms", v)
        reg.observe("train.step_ms", None)
        reg.inc("train.steps", 8)
        reg.inc("train.restarts")
        reg.set("train.loss", 2.5)
        reg.set("train.loss", 0.25)
    clock.advance(2.0)
    assert ours.snapshot(epoch=3) == theirs.snapshot(epoch=3)
    with pytest.raises(ValueError):
        ours.inc("x", -1)


def test_step_timer_is_the_references():
    clocks = [FakeClock(), FakeClock()]
    timers = [StepTimer(clock=clocks[0]), JaxStepTimer(clock=clocks[1])]
    for t, c in zip(timers, clocks):
        t.start()
        for name, dt in (("data", 0.25), ("dispatch", 0.5), ("device", 1.0),
                         ("checkpoint", 0.125)):
            with t.phase(name):
                c.advance(dt)
        with t.exclude():
            c.advance(9.0)
        c.advance(0.125)
        t.stop(4)
    assert timers[0].phases_ms() == timers[1].phases_ms()
    assert timers[0].mean_step_ms == timers[1].mean_step_ms
    with pytest.raises(RuntimeError):
        StepTimer().stop()


def test_spans_nest_and_log(tmp_path):
    m = MetricsLogger(echo=False, capture=True)
    with span("epoch", metrics=m):
        with span("eval", metrics=m, epoch=0) as path:
            assert path == current_path() == "epoch/eval"
    with span("quiet"):
        pass
    assert [(r["name"], r.get("epoch")) for r in m.rows] == [
        ("epoch/eval", 0), ("epoch", None)]
    assert current_path() == ""


def test_memory_snapshot_is_null_on_the_cpu():
    snap = memory_snapshot([torch.device("cpu")])
    assert snap == [{"id": 0, "platform": "cpu", "stats": None}]
    m = MetricsLogger(echo=False, capture=True)
    emit_step_telemetry(m, StepTimer(), 3, devices=[torch.device("cpu")])
    assert m.rows == []          # no sink open: nothing


def _cnn_cfgs(scan, **kw):
    base = dict(epochs=2, batch_size=BATCH, lr=0.1, log_every=4,
                checkpoint_every=1, **kw)
    return (JaxConfig(num_devices=1, scan=scan, **base),
            Config(device="cpu", scan=scan, **base))


@pytest.fixture(scope="module")
def jax_cnn_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_cnn")
    jcfg, _ = _cnn_cfgs(False, checkpoint_dir=str(d / "ck"))
    tr = JaxTrainer(JAX_PRESETS["reference_cnn"](),
                    jax_stripes(N_TRAIN, N_TEST), jcfg,
                    metrics=JaxMetrics(d / "run.jsonl", echo=False))
    init = jax.device_get(tr.state["params"])
    tr.train()
    tr.metrics.close()
    return init, jax_load_records(d / "run.jsonl")


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
def test_cnn_file_is_the_jax_trainers(jax_cnn_file, tmp_path, scan):
    init, want = jax_cnn_file
    _, cfg = _cnn_cfgs(scan, checkpoint_dir=str(tmp_path / "ck"))
    path = tmp_path / "run.jsonl"
    with MetricsLogger(path, echo=False) as m:
        Trainer(get_model("reference_cnn"),
                synthetic_stripes(N_TRAIN, N_TEST), cfg, metrics=m,
                params=params_from_jax(init)).train()
    got = jax_load_records(path, strict=True)
    assert schema.load_records(path, strict=True) == got
    assert _events(got) == _events(want)
    summary = _same_summary(got)
    assert summary["events"]["epoch"] == 2 and summary["train"]["records"] \
        == summary["events"]["train"]
    for g, w in zip(got, want):
        for key in ("step", "epoch", "ntests", "ncorrect", "steps", "name",
                    "steps_per_dispatch"):
            if key in w:
                assert g[key] == w[key], (g, w)
        if g["event"] == "train":
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
        assert set(w) <= set(g) | {"t"}
    mem = [r for r in got if r["event"] == "memory"]
    assert mem and all(e["stats"] is None for r in mem for e in r["devices"])
    (prog,) = [r for r in got if r["event"] == "program"]
    assert (prog["label"], prog["counting"]) == (
        ("scan_epoch", "static-body") if scan else ("train_step", "program"))
    assert prog["backend"] == "cpu" and summary["programs"][0]["mfu"] is None
    last = [r for r in got if r["event"] == "metrics"][-1]
    assert last["counters"]["train.steps"] == 2 * N_TRAIN // BATCH


def test_lm_file_is_the_jax_trainers(tmp_path):
    base = dict(corpus="synthetic", dim=32, depth=1, heads=2, seq_len=64,
                batch_size=4, steps=4, warmup_steps=20, lr=3e-3,
                attn_impl="oracle", log_every=2)
    jpath, path = tmp_path / "jax.jsonl", tmp_path / "port.jsonl"
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=1, **base),
                       metrics=JaxMetrics(jpath, echo=False))
    init = jax.device_get(jtr.state["params"])
    jtr.train()
    jtr.metrics.close()
    with MetricsLogger(path, echo=False) as m:
        LMTrainer(LMConfig(device="cpu", **base), metrics=m,
                  params=params_from_jax(init)).train()
    want, got = jax_load_records(jpath), jax_load_records(path, strict=True)
    assert _events(got) == _events(want) == [
        "program", "train", "metrics", "train", "metrics", "step_phases",
        "memory", "metrics", "span"]
    assert {k: got[0][k] for k in ("label", "counting", "steps_per_dispatch",
                                   "compute_dtype")} == \
        {k: want[0][k] for k in ("label", "counting", "steps_per_dispatch",
                                 "compute_dtype")}
    for g, w in zip(*(filter(lambda r: r["event"] == "train", x)
                      for x in (got, want))):
        assert g["step"] == w["step"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=LOSS_RTOL)
    assert _same_summary(got)["train"]["last_step"] == 4
    final = [r for r in got if r["event"] == "metrics"][-1]
    assert final["final"] is True and final["counters"]["train.steps"] == 4


def test_cli_world_2_has_one_writer(tmp_path):
    path = tmp_path / "run.jsonl"
    assert main(["train", "--device", "cpu", "--epochs", "1",
                 "--num-devices", "2", "--metrics-jsonl", str(path)]) == 0
    text = path.read_text()
    assert text.count(schema.RUN_MARKER) == 1
    recs = jax_load_records(path, strict=True)
    assert [r["event"] for r in recs].count("epoch") == 1
    assert [r["event"] for r in recs].count("eval") == 1
    (prog,) = [r for r in recs if r["event"] == "program"]
    assert prog["collectives"] == {"all-reduce": 1}   # the step's one


def test_cli_lm_sink_and_supervised_registry(tmp_path):
    """lm --metrics-jsonl under a crash and a restart: one registry across
    the attempts (its restart counter), and the fault records."""
    path = tmp_path / "lm.jsonl"
    assert main(["lm", "--device", "cpu", "--corpus", "synthetic", "--dim",
                 "32", "--depth", "1", "--heads", "2", "--seq-len", "64",
                 "--batch-size", "2", "--steps", "4", "--log-every", "1",
                 "--checkpoint-dir", str(tmp_path / "ck"),
                 "--checkpoint-every", "2", "--max-restarts", "1",
                 "--fault-plan", "crash@train.step:3",
                 "--metrics-jsonl", str(path)]) == 0
    recs = jax_load_records(path, strict=True)
    kinds = [r["kind"] for r in recs if r["event"] == "fault"]
    assert kinds == ["injected_crash", "restart"]
    final = [r for r in recs if r["event"] == "metrics"][-1]
    assert final["counters"]["train.restarts"] == 1


def test_profile_dir_writes_a_trace(tmp_path):
    prof = tmp_path / "prof"
    assert main(["train", "--device", "cpu", "--epochs", "1",
                 "--profile-dir", str(prof)]) == 0
    trace = json.loads((prof / "trace.json").read_text())
    assert trace["traceEvents"]
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "eval" in names            # the span's record_function range


def test_profile_trace_is_written_when_the_block_raises(tmp_path):
    with pytest.raises(KeyError):
        with profile_trace(str(tmp_path)):
            torch.ones(3).sum()
            raise KeyError("x")
    assert (tmp_path / "trace.json").exists()


def test_no_sink_writes_nothing_and_syncs_no_more(tmp_path, monkeypatch):
    """Without --metrics-jsonl no file appears, and the sink adds no read
    of a device value: the run reads as many tensors back with the sink
    as without it."""
    reads = {"n": 0}
    for name in ("tolist", "item"):
        orig = getattr(torch.Tensor, name)

        def counted(self, *a, _orig=orig, **k):
            reads["n"] += 1
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)
    monkeypatch.chdir(tmp_path)
    counts = []
    for sink in (None, str(tmp_path / "run.jsonl")):
        reads["n"] = 0
        cfg = Config(device="cpu", epochs=1, log_every=4, metrics_jsonl=sink)
        with MetricsLogger(sink, echo=False) as m:
            Trainer(get_model("reference_cnn"), synthetic_stripes(128, 32),
                    cfg, metrics=m).train()
        counts.append(reads["n"])
        if sink is None:
            assert list(tmp_path.iterdir()) == []
    assert counts[0] == counts[1] > 0
