"""The port's fault plans, NaN guard, preemption and crash supervisor
(`mpi_cuda_cnn_tpu_torch/faults.py` under both trainers and the `train`
and `lm` commands), against the JAX package's `faults.py` on the CPU.

Ported from tests/test_faults.py and run on the port: the plan grammar
(held to the JAX `parse_plan`/`format_plan` on the same strings), the
injector, the supervisor's backoff, a supervised crash and restart that
ends bit for bit where the uninterrupted run ends (both epoch routes of
the CNN trainer, and the LM trainer), the NaN guard's three policies,
and the orderly preemption (exit 75, then `--resume` bit for bit).
Within the port the comparisons are bitwise; the port's supervised run
against the JAX package's on the same plan holds params within
PARAM_ATOL, as tests/test_torch_train.py does for 8 plain steps.
"""

import dataclasses
import logging

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu import faults as jax_faults
from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import get_model as jax_get_model
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main, world_exit
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.faults import (
    EXIT_PREEMPTED,
    SITES,
    FakeClock,
    FaultInjector,
    InjectedCrash,
    InjectedIOError,
    NonFiniteLossError,
    Preempted,
    PreemptionGuard,
    all_finite,
    format_plan,
    parse_plan,
    supervise,
    validate_plan_sites,
)
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.distributed import RankError, run_ranks
from mpi_cuda_cnn_tpu_torch.train.checkpoint import latest_checkpoint
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.ranks import _restartable, cnn_rank, lm_rank
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger, get_logger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# The port against the JAX trainer: 8 float32 SGD steps from equal
# params, sums in other orders (tests/test_torch_train.py).
PARAM_ATOL = 1e-6


def _quiet(capture=False):
    return MetricsLogger(echo=False, capture=capture)


def _cfg(**kw):
    base = dict(dataset="synthetic", model="reference_cnn", epochs=2,
                batch_size=16, eval_every=0, log_every=0, lr=0.05, seed=7,
                device="cpu")
    base.update(kw)
    return Config(**base)


def _ds():
    return synthetic_stripes(num_train=64, num_test=32)  # 4 steps/epoch


def _params(t):
    return [p.detach().clone() for p in t.leaves]


def _assert_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _kinds(metrics):
    return [r["kind"] for r in metrics.rows if r["event"] == "fault"]


@pytest.fixture
def log_lines():
    """Messages of the port's logger (it does not propagate to root)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


# ---------------------------------------------------------------- plan / injector


PLANS = [
    "crash@train.step:6; nan@train.batch:3?rows=2;"
    "squeeze@serve.tick:2?pages=4&ticks=8;slow@serve.tick:5?s=2.5",
    "preempt@train.step:17",
    "io@ckpt.pre_rename:3;crash@ckpt.manifest:4",
    "msg_delay@fleet.transport:3?kind=commit&ticks=2",
]


@pytest.mark.parametrize("spec", PLANS)
def test_parse_plan_matches_the_jax_grammar(spec):
    got, want = parse_plan(spec), jax_faults.parse_plan(spec)
    assert [(f.kind, f.site, f.at, f.args) for f in got] == \
        [(f.kind, f.site, f.at, f.args) for f in want]
    assert format_plan(got) == jax_faults.format_plan(want)
    assert parse_plan(format_plan(got)) == got


def test_parse_plan_grammar():
    plan = parse_plan(PLANS[0])
    assert [(f.kind, f.site, f.at) for f in plan] == [
        ("crash", "train.step", 6), ("nan", "train.batch", 3),
        ("squeeze", "serve.tick", 2), ("slow", "serve.tick", 5),
    ]
    assert plan[1].arg("rows") == 2
    assert plan[2].args == {"pages": 4, "ticks": 8}
    assert plan[3].arg("s") == 2.5
    for bad in ("boom@x:1", "crash@:3", "crash@a.b", "crash@a.b:x",
                "nan@train.batch:1?rows"):
        with pytest.raises(ValueError, match="bad fault"):
            parse_plan(bad)
        with pytest.raises(ValueError, match="bad fault"):
            jax_faults.parse_plan(bad)


def test_sites_are_the_references():
    assert SITES == jax_faults.SITES
    validate_plan_sites("nan@train.batch:3;crash@ckpt.manifest:1", "train")
    for spec, surface in (("nan@train.batch:3", "train-lm"),
                          ("preempt@train.batch:1", "train"),
                          ("crash@serve.tick:1", "train")):
        with pytest.raises(ValueError, match="never"):
            validate_plan_sites(spec, surface)


def test_injector_fires_once_at_site_and_value():
    inj = FaultInjector("nan@train.batch:3;crash@train.step:5")
    assert inj.poll("train.batch", 2) == []
    assert inj.poll("train.step", 3) == []   # site must match too
    hits = inj.poll("train.batch", 3)
    assert [f.kind for f in hits] == ["nan"]
    assert inj.poll("train.batch", 3) == []  # fires exactly once
    assert [f.at for f in inj.pending("train.step")] == [5]
    with pytest.raises(InjectedCrash):
        inj.fire("train.step", 5)
    assert inj.fire("train.step", 5) == []   # consumed by the raise
    assert inj.pending("train.step") == []
    evs = inj.drain_events()
    assert [e["kind"] for e in evs] == ["injected_nan", "injected_crash"]
    assert inj.drain_events() == []


def test_fake_clock_drives_injector_sleep():
    clock = FakeClock()
    inj = FaultInjector("slow@serve.tick:0?s=2.5", clock=clock)
    (f,) = inj.poll("serve.tick", 0)
    inj.sleep(f.arg("s"))
    assert clock() == 2.5


def test_supervisor_backs_off_exponentially_with_jitter():
    slept = []
    metrics = _quiet(capture=True)

    def attempt(n):
        raise RuntimeError(f"boom {n}")

    with pytest.raises(RuntimeError):
        supervise(attempt, max_restarts=3, metrics=metrics,
                  backoff_base=0.5, sleep=slept.append, jitter=lambda: 0.0)
    assert slept == [0.5, 1.0, 2.0]
    delays = [r["delay_s"] for r in metrics.rows
              if r["event"] == "fault" and r["kind"] == "restart"]
    assert delays == [0.5, 1.0, 2.0]
    slept.clear()
    with pytest.raises(RuntimeError):
        supervise(attempt, max_restarts=2, backoff_base=0)
    assert slept == []


def test_world_exit_keeps_75_only_when_every_rank_says_so():
    assert world_exit([0, 0]) == 0
    assert world_exit([EXIT_PREEMPTED] * 2) == EXIT_PREEMPTED
    assert world_exit([EXIT_PREEMPTED, 1]) == 1
    assert world_exit([EXIT_PREEMPTED, 0]) == 1
    assert world_exit([2, EXIT_PREEMPTED]) == 2


# ---------------------------------------------------------------- supervisor e2e


def _supervised_cnn(ck, plan, *, scan=True, restarts=2, metrics=None,
                    **kw):
    faults = FaultInjector(plan)
    metrics = metrics or _quiet(capture=True)
    attempts = []

    def attempt(n):
        cfg = _cfg(scan=scan, checkpoint_dir=str(ck), resume=n > 0, **kw)
        t = Trainer(get_model("reference_cnn"), _ds(), cfg, metrics=metrics,
                    faults=faults)
        attempts.append(t)
        return t.train()

    res = supervise(attempt, max_restarts=restarts, metrics=metrics,
                    backoff_base=0)
    return res, attempts, metrics


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
def test_supervised_crash_restart_is_bitwise_exact(tmp_path, scan):
    """A run killed after step 6 of 8 (checkpoints every 3 steps),
    restarted by the supervisor, ends bit for bit where the
    uninterrupted run ends, on both epoch routes (on the device-resident
    route the planned step ends a chunk)."""
    full = Trainer(get_model("reference_cnn"), _ds(), _cfg(scan=scan),
                   metrics=_quiet())
    full.train()
    res, attempts, metrics = _supervised_cnn(
        tmp_path / "ck", "crash@train.step:6", scan=scan,
        checkpoint_every_steps=3)
    assert len(attempts) == 2           # one crash, one clean finish
    assert res.final_step == full.step == 8
    _assert_equal(_params(full), _params(attempts[-1]))
    kinds = _kinds(metrics)
    assert "injected_crash" in kinds and "restart" in kinds
    resumes = [r for r in metrics.rows if r["event"] == "ckpt"]
    assert [(r["reason"], r["step"]) for r in resumes] == [("resume", 6)]


def test_device_route_crash_between_checkpoints_fires(tmp_path):
    """A planned step between two checkpoint steps still fires on the
    device-resident route (its chunk ends there); the restart resumes at
    the checkpoint before it and replays the steps in between."""
    full = Trainer(get_model("reference_cnn"), _ds(), _cfg(),
                   metrics=_quiet())
    full.train()
    res, attempts, metrics = _supervised_cnn(
        tmp_path / "ck", "crash@train.step:5", checkpoint_every_steps=3)
    assert len(attempts) == 2 and res.final_step == 8
    assert [r["step"] for r in metrics.rows if r["event"] == "ckpt"] == [3]
    _assert_equal(_params(full), _params(attempts[-1]))


def test_supervisor_exhausts_restarts_and_reraises(tmp_path):
    with pytest.raises(InjectedCrash):
        _supervised_cnn(tmp_path / "ck",
                        "crash@train.step:2;crash@train.step:3",
                        restarts=1, checkpoint_every_steps=1)


def _failure(rank, exc_type, fired=()):
    """A rank's failure as `run_ranks` reports it in RankError.failures."""
    return {"rank": rank, "types": [c.__name__ for c in exc_type.__mro__],
            "fired": list(fired)}


def test_supervisor_reraises_what_it_may_not_restart():
    """`restartable` turns a crash down: it is re-raised at once, with no
    restart. A world's parent (`train.ranks.supervise_world`) restarts a
    world whose ranks crashed, a real bug of one rank included, and turns
    down one where a rank stopped on the NaN guard or an interrupt, or
    returned preempted."""
    calls = []

    def attempt(n):
        calls.append(n)
        raise RankError("rank 1: NaN", [_failure(1, NonFiniteLossError)])

    metrics = _quiet(capture=True)
    with pytest.raises(RankError):
        supervise(attempt, max_restarts=3, metrics=metrics, backoff_base=0,
                  restartable=_restartable)
    assert calls == [0] and _kinds(metrics) == []
    assert _restartable(RankError("x", [_failure(0, InjectedCrash, [0])]))
    assert _restartable(RankError("x", [_failure(1, RuntimeError)]))
    assert _restartable(RankError("x", [_failure(0, InjectedIOError)], [0]))
    assert not _restartable(RankError("x", [_failure(1, KeyboardInterrupt)]))
    assert not _restartable(RankError("x", [_failure(0, RuntimeError)],
                                      [EXIT_PREEMPTED]))
    assert not _restartable(InjectedCrash("x", "train.step"))


def test_cli_train_supervisor_e2e(tmp_path, log_lines):
    """`train --max-restarts 1 --fault-plan crash@...` through the
    command: the crashed attempt restarts, resumes, exits 0, and the
    fault records reach the log."""
    rc = main([
        "train", "--dataset", "synthetic", "--model", "reference_cnn",
        "--epochs", "1", "--batch-size", "500", "--eval-every", "0",
        "--log-every", "0", "--device", "cpu",
        "--checkpoint-dir", str(tmp_path / "ck"),
        "--checkpoint-every-steps", "2", "--max-restarts", "1",
        "--fault-plan", "crash@train.step:2",
    ])
    assert rc == 0
    faults = [m for m in log_lines if m.startswith("fault ")]
    assert any("kind=restart" in m for m in faults)
    assert any("kind=injected_crash" in m for m in faults)
    # A supervisor without a checkpoint dir is a config error, found
    # before any training; so are a bad plan and a bad policy.
    assert main(["train", "--dataset", "synthetic", "--device", "cpu",
                 "--max-restarts", "1"]) == 2
    assert main(["train", "--dataset", "synthetic", "--device", "cpu",
                 "--fault-plan", "boom@train.step:1"]) == 2
    assert main(["train", "--dataset", "synthetic", "--device", "cpu",
                 "--nan-policy", "bogus"]) == 2


def test_the_ports_supervised_run_matches_the_jax_packages(tmp_path):
    """The same plan through both packages' trainers and supervisors
    (per-batch route), from the JAX trainer's initial params: one
    restart each, the same fault records, params within PARAM_ATOL."""
    base = dict(dataset="synthetic", model="reference_cnn", epochs=2,
                batch_size=16, eval_every=0, log_every=0, lr=0.05, seed=7,
                scan=False, checkpoint_every_steps=3)
    jds = jax_stripes(num_train=64, num_test=32)
    jfaults = jax_faults.FaultInjector("crash@train.step:6")
    jmetrics = JaxMetrics(echo=False, capture=True)
    jattempts = []

    def jattempt(n):
        cfg = JaxConfig(num_devices=1, checkpoint_dir=str(tmp_path / "j"),
                        resume=n > 0, **base)
        t = JaxTrainer(jax_get_model("reference_cnn"), jds, cfg,
                       metrics=jmetrics, faults=jfaults)
        jattempts.append(t)
        return t.train()

    jres = jax_faults.supervise(jattempt, max_restarts=1, metrics=jmetrics,
                                backoff_base=0)
    init = jax.device_get(JaxTrainer(
        jax_get_model("reference_cnn"), jds, JaxConfig(num_devices=1, **base),
        metrics=JaxMetrics(echo=False)).state["params"])
    faults = FaultInjector("crash@train.step:6")
    metrics = _quiet(capture=True)
    attempts = []

    def attempt(n):
        cfg = Config(device="cpu", checkpoint_dir=str(tmp_path / "t"),
                     resume=n > 0, **base)
        t = Trainer(get_model("reference_cnn"), _ds(), cfg, metrics=metrics,
                    faults=faults, params=params_from_jax(init))
        attempts.append(t)
        return t.train()

    res = supervise(attempt, max_restarts=1, metrics=metrics, backoff_base=0)
    assert len(attempts) == len(jattempts) == 2
    assert res.final_step == jres.final_step == 8
    assert _kinds(metrics) == [r["kind"] for r in jmetrics.rows
                               if r["event"] == "fault"]
    want = jax.tree.leaves(jax.device_get(jattempts[-1].state["params"]))
    for g, w in zip(_params(attempts[-1]), want, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)


# ---------------------------------------------------------------- preemption


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
def test_preemption_exits_75_and_resumes_bitwise(tmp_path, scan):
    """A planned preempt at step 5 (mid-epoch 1) through the `train`
    command's rank entry: exit 75 with ckpt_5 written, then --resume ends
    bit for bit where the uninterrupted run ends."""
    data = dict(num_train=64, num_test=32)
    full = cnn_rank(None, _cfg(scan=scan), data)
    ck = tmp_path / "ck"
    cut = cnn_rank(None, _cfg(scan=scan, checkpoint_dir=str(ck),
                              fault_plan="preempt@train.step:5"), data)
    assert cut["exit"] == EXIT_PREEMPTED
    assert latest_checkpoint(ck).name == "ckpt_5.npz"
    assert {"event": "ckpt", "step": 5, "reason": "preempt"} \
        in cut["records"]
    resumed = cnn_rank(None, _cfg(scan=scan, checkpoint_dir=str(ck),
                                  resume=True), data)
    assert resumed["exit"] == 0 and resumed["step"] == full["step"] == 8
    for a, b in zip(resumed["params"], full["params"], strict=True):
        np.testing.assert_array_equal(a, b)


def test_preemption_without_a_checkpoint_dir_exits_1(tmp_path):
    data = dict(num_train=64, num_test=32)
    cut = cnn_rank(None, _cfg(fault_plan="preempt@train.step:2"), data)
    assert cut["exit"] == 1
    assert main(["train", "--dataset", "synthetic", "--device", "cpu",
                 "--epochs", "1", "--fault-plan", "preempt@train.step:2",
                 "--checkpoint-dir", str(tmp_path / "ck")]) == EXIT_PREEMPTED


def _preempt_rank_one(mesh, cfg, data, ck):
    """On this rank of a sharded mesh: the run with a preempt planned on
    rank 1 alone (what a signal that reaches one rank does to its
    guard), its resume, and the run without a cut."""
    cut = dataclasses.replace(cfg, checkpoint_dir=ck, fault_plan=(
        "preempt@train.step:5" if mesh.rank == 1 else None))
    return (cnn_rank(mesh, cut, data),
            cnn_rank(mesh, dataclasses.replace(cfg, checkpoint_dir=ck,
                                               resume=True), data),
            cnn_rank(mesh, cfg, data))


def test_a_preemption_on_one_rank_drains_every_rank_of_a_sharded_mesh(
        tmp_path):
    """pipe:2, whose checkpoint is gathered over the world: rank 1's
    guard alone is flagged at step 5, the ranks agree at that boundary,
    both exit 75 with ckpt_5 written, and the resume ends bit for bit
    where the uninterrupted run ends, on both ranks."""
    data = dict(num_train=64, num_test=32)
    ranks = run_ranks(_preempt_rank_one, 2, axes={"pipe": 2}, args=(
        _cfg(mesh_shape="pipe:2", scan=False), data, str(tmp_path / "ck")),
        timeout=300)
    assert (tmp_path / "ck" / "ckpt_5.npz").exists()
    for cut, resumed, full in ranks:
        assert cut["exit"] == EXIT_PREEMPTED
        assert {"event": "ckpt", "step": 5, "reason": "preempt"} \
            in cut["records"]
        assert resumed["exit"] == 0 and resumed["step"] == full["step"] == 8
        for a, b in zip(resumed["params"], full["params"], strict=True):
            np.testing.assert_array_equal(a, b)


def _preempt_rank_one_lm(mesh, cfg, ck):
    """`_preempt_rank_one` of the LM trainer."""
    cut = dataclasses.replace(cfg, checkpoint_dir=ck, fault_plan=(
        "preempt@train.step:3" if mesh.rank == 1 else None))
    return (lm_rank(mesh, cut),
            lm_rank(mesh, dataclasses.replace(cfg, checkpoint_dir=ck,
                                              resume=True),
                    final_params=True),
            lm_rank(mesh, cfg, final_params=True))


@pytest.mark.parametrize("trainer", ["cnn", "lm"])
def test_a_preemption_on_one_rank_drains_every_rank_of_a_data_mesh(
        tmp_path, trainer):
    """data:2, whose params are replicated and whose checkpoint rank 0
    writes alone: rank 1's guard alone is flagged (at step 5 of the CNN,
    3 of the LM), the ranks agree at that boundary (one all-reduce of the
    flags at every boundary of a world of several ranks), both exit 75
    with the snapshot written, and the resume ends bit for bit where the
    uninterrupted run ends. Were the flags not agreed, rank 1 would wait
    at the snapshot's barrier while rank 0 entered the next step's
    all-reduce."""
    ck = str(tmp_path / "ck")
    if trainer == "cnn":
        ranks = run_ranks(_preempt_rank_one, 2, args=(
            _cfg(num_devices=2, scan=False), dict(num_train=64,
                                                  num_test=32), ck),
            timeout=300)
        cut_step, end = 5, "step"
    else:
        ranks = run_ranks(_preempt_rank_one_lm, 2, args=(
            LMConfig(**dict(_LM, num_devices=2)), ck), timeout=300)
        cut_step, end = 3, None
    assert (tmp_path / "ck" / f"ckpt_{cut_step}.npz").exists()
    for cut, resumed, full in ranks:
        assert cut["exit"] == EXIT_PREEMPTED
        assert {"event": "ckpt", "step": cut_step, "reason": "preempt"} \
            in cut["records"]
        assert resumed["exit"] == 0 and full["exit"] == 0
        if end:
            assert resumed[end] == full[end] == 8
        for a, b in zip(resumed["params"], full["params"], strict=True):
            np.testing.assert_array_equal(a, b)


def test_preemption_guard_answers_sigterm():
    """SIGTERM sets the flag (no exit), a second notice goes to the
    previous handler; the handlers are put back on exit."""
    import signal

    before = signal.getsignal(signal.SIGTERM)
    with PreemptionGuard() as guard:
        signal.raise_signal(signal.SIGTERM)
        assert guard.requested and guard.signum == signal.SIGTERM
    assert signal.getsignal(signal.SIGTERM) is before
    assert Preempted("x").code == EXIT_PREEMPTED
    assert Preempted("x", resumable=False).code == 1


# ---------------------------------------------------------------- NaN guard


@pytest.mark.parametrize("bad", [None, float("nan"), float("inf"),
                                 -float("inf")])
def test_all_finite_flags_any_non_finite_and_changes_nothing(bad):
    """The guard's one device check: float32 and float64 tensors (an int
    one ignored), flagged when any element is not finite; every tensor
    is left bit for bit as it was (the check scales by exactly 1)."""
    rng = np.random.default_rng(0)
    ts = [torch.from_numpy(rng.standard_normal((5, 7)).astype(np.float32)),
          torch.tensor([-0.0, 0.0, 3e38, 1e-45], dtype=torch.float32),
          torch.from_numpy(rng.standard_normal(9)),
          torch.arange(4)]
    if bad is not None:
        ts[2][4] = bad
    before = [t.clone() for t in ts]
    assert float(all_finite(ts)) == (0.0 if bad is None else 1.0)
    for t, b in zip(ts, before, strict=True):
        assert torch.equal(t.view(torch.uint8), b.view(torch.uint8)) \
            if t.is_floating_point() else torch.equal(t, b)


def test_nan_policy_abort_raises():
    t = Trainer(get_model("reference_cnn"), _ds(),
                _cfg(epochs=1, nan_policy="abort"), metrics=_quiet(),
                faults=FaultInjector("nan@train.batch:2"))
    with pytest.raises(NonFiniteLossError):
        t.train()


def test_supervisor_does_not_retry_nan_abort(tmp_path):
    attempts = []

    def attempt(n):
        cfg = _cfg(epochs=1, nan_policy="abort",
                   checkpoint_dir=str(tmp_path / "ck"),
                   checkpoint_every_steps=1, resume=n > 0)
        t = Trainer(get_model("reference_cnn"), _ds(), cfg, metrics=_quiet(),
                    faults=FaultInjector("nan@train.batch:2"))
        attempts.append(t)
        return t.train()

    with pytest.raises(NonFiniteLossError):
        supervise(attempt, max_restarts=3)
    assert len(attempts) == 1  # no futile replays


def test_skipped_step_still_fires_planned_step_faults(tmp_path):
    """A NaN-skipped step consumed its batch: a planned crash at the same
    step still fires."""
    res, attempts, metrics = _supervised_cnn(
        tmp_path / "ck", "nan@train.batch:3;crash@train.step:4",
        restarts=1, epochs=1, nan_policy="skip", checkpoint_every_steps=2)
    assert len(attempts) == 2  # the crash did fire, then recovery ran
    assert res.final_step == 4
    kinds = _kinds(metrics)
    assert "injected_crash" in kinds and "nonfinite_step" in kinds


def test_nan_policy_skip_drops_exactly_the_poisoned_update(tmp_path):
    """skip drops the bad update: the params after the poisoned step are
    bitwise those before it (ckpt_2 and ckpt_3), the step counter still
    advances (batches consumed), the params stay finite."""
    from mpi_cuda_cnn_tpu_torch.train.checkpoint import restore_checkpoint

    metrics = _quiet(capture=True)
    ck = tmp_path / "ck"
    t = Trainer(get_model("reference_cnn"), _ds(),
                _cfg(epochs=1, nan_policy="skip", checkpoint_dir=str(ck),
                     checkpoint_every_steps=1),
                metrics=metrics, faults=FaultInjector("nan@train.batch:2"))
    res = t.train()
    assert t.recovery.nan.skipped == 1 and res.final_step == 4
    assert all(torch.isfinite(p).all() for p in t.leaves)
    kinds = _kinds(metrics)
    assert kinds.count("nonfinite_step") == 1
    assert kinds.count("injected_nan") == 1
    template = t.recovery.arrays(t.state)
    before = restore_checkpoint(ck / "ckpt_2.npz", template)
    after = restore_checkpoint(ck / "ckpt_3.npz", template)
    assert (int(before["step"]), int(after["step"])) == (2, 3)
    for name in template:
        if name.startswith("params/"):
            np.testing.assert_array_equal(before[name], after[name])


def test_nan_policy_restore_rolls_back_to_checkpoint(tmp_path):
    metrics = _quiet(capture=True)
    t = Trainer(get_model("reference_cnn"), _ds(),
                _cfg(epochs=1, nan_policy="restore", nan_max_bad=2,
                     checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every_steps=1),
                metrics=metrics,
                faults=FaultInjector("nan@train.batch:1;nan@train.batch:2"))
    res = t.train()
    assert res.final_step == 4  # every batch's update eventually lands
    assert all(torch.isfinite(p).all() for p in t.leaves)
    kinds = _kinds(metrics)
    assert "nan_restore" in kinds
    assert kinds.count("nonfinite_step") == 2


def test_skip_then_crash_restart_stays_bitwise_exact(tmp_path):
    """A run that skips batch 4 and crashes after batch 6 lands, once
    restarted, bitwise on the guarded run without the crash."""
    ref = Trainer(get_model("reference_cnn"), _ds(), _cfg(nan_policy="skip"),
                  metrics=_quiet(), faults=FaultInjector("nan@train.batch:4"))
    ref.train()
    res, attempts, _ = _supervised_cnn(
        tmp_path / "ck", "nan@train.batch:4;crash@train.step:6",
        nan_policy="skip", checkpoint_every_steps=3)
    assert len(attempts) == 2
    assert res.final_step == 8
    _assert_equal(_params(ref), _params(attempts[-1]))


def test_nan_guard_and_batch_faults_force_per_batch_stepping(log_lines):
    ds = _ds()
    t = Trainer(get_model("reference_cnn"), ds, _cfg(nan_policy="skip"),
                metrics=_quiet())
    assert not t._use_device_data()
    assert any("--nan-policy=skip active: per-batch stepping" in m
               for m in log_lines)
    t2 = Trainer(get_model("reference_cnn"), ds, _cfg(), metrics=_quiet(),
                 faults=FaultInjector("nan@train.batch:1"))
    assert not t2._use_device_data()
    assert any("targets train.batch: per-batch stepping" in m
               for m in log_lines)
    t3 = Trainer(get_model("reference_cnn"), ds, _cfg(), metrics=_quiet(),
                 faults=FaultInjector("crash@train.step:1"))
    assert t3._use_device_data()


def test_bad_nan_policy_rejected():
    with pytest.raises(ValueError, match="nan-policy"):
        Trainer(get_model("reference_cnn"), _ds(), _cfg(nan_policy="bogus"),
                metrics=_quiet())
    with pytest.raises(ValueError, match="nan-policy"):
        LMTrainer(LMConfig(**_LM, nan_policy="bogus"))


# ---------------------------------------------------------------- the LM trainer

_LM = dict(device="cpu", corpus="synthetic", dim=32, depth=1, heads=2,
           seq_len=64, batch_size=4, steps=6, warmup_steps=2, lr=3e-3,
           attn_impl="oracle", log_every=1)


def _lm_params(t):
    return [p.detach().clone() for p in tree_leaves(t.state["params"])]


def test_lm_supervised_crash_restart_is_bitwise_exact(tmp_path):
    """lm: crashed after step 4 of 6 (checkpoints every 3 steps),
    restarted, ends bit for bit where the uninterrupted run ends, with
    the re-run step's loss equal to its first run's; AdamW's moments and
    count come back from the file."""
    full = LMTrainer(LMConfig(**_LM), metrics=_quiet(capture=True))
    full.train()
    faults = FaultInjector("crash@train.step:4")
    metrics = _quiet(capture=True)
    attempts = []

    def attempt(n):
        t = LMTrainer(LMConfig(**_LM, checkpoint_dir=str(tmp_path / "ck"),
                               checkpoint_every=3, resume=n > 0),
                      metrics=metrics, faults=faults)
        attempts.append(t)
        return t.train()

    res = supervise(attempt, max_restarts=1, metrics=metrics, backoff_base=0)
    assert len(attempts) == 2 and res.steps_run == 3
    _assert_equal(_lm_params(full), _lm_params(attempts[-1]))
    assert attempts[-1].state["opt_state"]["count"] == 6
    losses = [(r["step"], r["loss"]) for r in metrics.rows
              if r["event"] == "train"]
    assert [s for s, _ in losses] == [1, 2, 3, 4, 4, 5, 6]
    assert losses[3][1] == losses[4][1]       # step 4 run twice, bitwise
    want = [r["loss"] for r in full.metrics.rows if r["event"] == "train"]
    assert [loss for _, loss in losses[:4]] + \
        [loss for _, loss in losses[5:]] == want


def test_lm_preemption_exits_75_and_resumes_bitwise(tmp_path, log_lines):
    """The `lm` command preempted at step 2 exits 75 with ckpt_2; its
    rank entry resumed ends where the uninterrupted run ends."""
    argv = ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
            "--depth", "1", "--heads", "2", "--seq-len", "64",
            "--batch-size", "4", "--steps", "6", "--warmup-steps", "2",
            "--lr", "3e-3", "--attn-impl", "oracle", "--log-every", "1",
            "--checkpoint-dir", str(tmp_path / "ck")]
    assert main(argv + ["--fault-plan", "preempt@train.step:2"]) \
        == EXIT_PREEMPTED
    assert latest_checkpoint(tmp_path / "ck").name == "ckpt_2.npz"
    # lm has no train.batch hook: such a plan is a flag error.
    assert main(argv + ["--fault-plan", "nan@train.batch:1"]) == 2
    resumed = lm_rank(None, LMConfig(**_LM, checkpoint_dir=str(tmp_path / "ck"),
                                     resume=True))
    full = lm_rank(None, LMConfig(**_LM))
    assert resumed["exit"] == 0
    assert resumed["losses"] == full["losses"][2:]
    assert resumed["final_loss"] == full["final_loss"]
    assert resumed["eval_loss"] == full["eval_loss"]


def test_lm_nan_guard_skips_organic_overflow():
    """An organic non-finite update (a learning rate that overflows
    float32): skip drops every update, so the params stay the initial
    ones bit for bit while the step counter advances; abort raises."""
    cfg = dict(_LM, steps=3, lr_schedule="constant", warmup_steps=0,
               lr=1e39)
    t = LMTrainer(LMConfig(**cfg, nan_policy="skip"),
                  metrics=_quiet(capture=True))
    init = _lm_params(t)
    res = t.train()
    assert res.steps_run == 3 and t.state["step"] == 3
    assert t.state["opt_state"]["count"] == 0
    _assert_equal(init, _lm_params(t))
    assert _kinds(t.metrics).count("nonfinite_step") == 3
    with pytest.raises(NonFiniteLossError):
        LMTrainer(LMConfig(**cfg, nan_policy="abort"),
                  metrics=_quiet()).train()
