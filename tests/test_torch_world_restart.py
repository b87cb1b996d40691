"""A world of several spawned ranks supervised from its parent
(`train.ranks.supervise_world`, the `train` command at `--num-devices 2`
with `--max-restarts`), on gloo CPU ranks.

The reference restarts any crash of its one process from the latest
checkpoint (`mpi_cuda_cnn_tpu/cli.py` `_supervised`, `faults.supervise`).
In the port a world is an attempt: when any rank fails, `run_ranks` stops
the others, the parent backs off, writes the reference's ``fault`` record
(kind "restart") to rank 0's run file and spawns the whole world again
with `resume` forced and the planned faults that fired marked fired.
Here:
- a crash at `ckpt.pre_rename` (rank 0's alone: the only writer) exits 0
  and ends bit for bit where the uninterrupted world-2 run ends (its
  latest checkpoint, every array, and the run file's last epoch and eval
  records), with one injected crash and one restart in the run file, one
  run marker and `train.restarts` 1 in the later snapshots; and within
  1e-6 of the JAX trainer supervised on a data:2 mesh of conftest's host
  devices (the same plan through the JAX package's supervisor);
- a real RuntimeError on rank 1 alone, mid-run, is restarted the same
  way, from the checkpoint before it, and ends bit for bit;
- the NaN guard's abort and a preemption are not restarted;
- a fault that fired in one world does not fire in the next.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

import mpi_cuda_cnn_tpu.faults as jax_faults
from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import get_model as jax_get_model
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.faults import EXIT_PREEMPTED, FaultInjector
from mpi_cuda_cnn_tpu_torch.parallel.distributed import RankError, run_ranks
from mpi_cuda_cnn_tpu_torch.train.checkpoint import latest_checkpoint
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank, supervise_world
from mpi_cuda_cnn_tpu_torch.utils.config import Config
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# As tests/test_torch_dp.py: float32 SGD from equal params, the
# all-reduce's sums in another order than the JAX pmean's.
PARAM_ATOL = 1e-6
RANKS_TIMEOUT_S = 240
CPU2 = [torch.device("cpu")] * 2
# `train` at world 2 on the reference's four IDX files at the size of
# tests/test_torch_dp.py's parity: synthetic_stripes(128, 64) at batch 32,
# two epochs of 4 steps, a checkpoint every step, an eval after each
# epoch.
N_TRAIN, N_TEST = 128, 64
TRAIN = ["train", "--device", "cpu", "--num-devices", "2", "--epochs", "2",
         "--batch-size", "32", "--eval-every", "1", "--log-every", "0",
         "--lr", "0.1", "--seed", "7", "--checkpoint-every-steps", "1"]
CRASH = ["--max-restarts", "1", "--fault-plan", "crash@ckpt.pre_rename:3"]
RUN_MARKER = "# run"


def _records(path) -> list[dict]:
    lines = open(path).read().splitlines()
    assert sum(ln.startswith(RUN_MARKER) for ln in lines) == 1
    return [json.loads(ln) for ln in lines if not ln.startswith("#")]


def _end(records: list[dict]) -> list[dict]:
    """The run's last epoch record and its eval records, without their
    clock fields."""
    drop = ("t", "seconds")
    epochs = [r for r in records if r["event"] == "epoch"]
    evals = [r for r in records if r["event"] == "eval"]
    return [{k: v for k, v in r.items() if k not in drop}
            for r in epochs[-1:] + evals]


def _arrays(directory) -> dict:
    with np.load(latest_checkpoint(directory)) as z:
        return {k: z[k] for k in z.files}


def _assert_same_arrays(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _idx(tmp_path) -> list[str]:
    return [str(p) for p in write_synthetic_idx(
        tmp_path / "idx", synthetic_stripes(num_train=N_TRAIN,
                                            num_test=N_TEST)).values()]


def test_world_2_train_restarts_a_ckpt_crash_bitwise(tmp_path):
    full, crash = tmp_path / "full", tmp_path / "crash"
    train = TRAIN + _idx(tmp_path)
    assert main(train + ["--checkpoint-dir", str(full / "ck"),
                         "--metrics-jsonl", str(full / "m.jsonl")]) == 0
    assert main(train + CRASH + [
        "--checkpoint-dir", str(crash / "ck"),
        "--metrics-jsonl", str(crash / "m.jsonl")]) == 0
    got = _arrays(crash / "ck")
    _assert_same_arrays(got, _arrays(full / "ck"))
    assert int(got["step"]) == 2 * N_TRAIN // 32
    records = _records(crash / "m.jsonl")
    assert _end(records) == _end(_records(full / "m.jsonl"))
    faults = [r for r in records if r["event"] == "fault"]
    assert [(f["kind"], f.get("site"), f.get("attempt")) for f in faults] \
        == [("injected_crash", "ckpt.pre_rename", None), ("restart", None, 0)]
    assert faults[1]["delay_s"] > 0 and "RankError" in faults[1]["error"]
    resumes = [r for r in records if r["event"] == "ckpt"]
    assert [(r["reason"], r["step"]) for r in resumes] == [("resume", 2)]
    restarts = [r["counters"].get("train.restarts") for r in records
                if r["event"] == "metrics"]
    assert restarts and set(restarts) == {1.0}

    # The JAX package: the same plan through its trainer and supervisor,
    # one process on a data:2 mesh of host devices, from the same seed.
    jds = jax_stripes(num_train=N_TRAIN, num_test=N_TEST)
    jinj = jax_faults.FaultInjector("crash@ckpt.pre_rename:3")
    jmetrics = JaxMetrics(echo=False, capture=True)

    def attempt(n):
        cfg = JaxConfig(dataset="synthetic", num_devices=2, epochs=2,
                        batch_size=32, eval_every=1, log_every=0, lr=0.1,
                        seed=7, checkpoint_every_steps=1, resume=n > 0,
                        checkpoint_dir=str(tmp_path / "jax"))
        return JaxTrainer(jax_get_model("reference_cnn"), jds, cfg,
                          metrics=jmetrics, faults=jinj).train()

    jres = jax_faults.supervise(attempt, max_restarts=1, metrics=jmetrics,
                                backoff_base=0)
    assert jres.final_step == 8
    assert [r["kind"] for r in jmetrics.rows if r["event"] == "fault"] \
        == ["injected_crash", "restart"]
    want = _arrays(tmp_path / "jax")
    params = [k for k in got if k.startswith("params/")]
    assert params and sorted(params) == sorted(
        k for k in want if k.startswith("params/"))
    for k in params:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=PARAM_ATOL,
                                   err_msg=k)


def _cfg(**kw):
    base = dict(dataset="synthetic", model="reference_cnn", epochs=2,
                batch_size=16, eval_every=0, log_every=0, lr=0.05, seed=7,
                device="cpu", num_devices=2, scan=False,
                checkpoint_every_steps=3)
    return Config(**{**base, **kw})


DATA = dict(num_train=64, num_test=32)       # 4 steps an epoch


def _fails_once_on_rank_1(mesh, cfg, data, marker, **kw):
    """`cnn_rank`, but in the first world (no `marker` file yet) rank 1
    alone raises a real RuntimeError at its step-5 boundary, after the
    step-3 checkpoint."""
    if mesh.rank == 1 and not os.path.exists(marker):
        from mpi_cuda_cnn_tpu_torch.train import recovery

        step_boundary = recovery.Recovery.step_boundary

        def boom(self, state, step):
            if step == 5:
                open(marker, "w").close()
                raise RuntimeError("a real bug on rank 1 at step 5")
            return step_boundary(self, state, step)

        recovery.Recovery.step_boundary = boom
    return cnn_rank(mesh, cfg, data, **kw)


def test_a_real_error_on_rank_1_alone_is_restarted_bitwise(tmp_path):
    full = run_ranks(cnn_rank, 2, args=(
        _cfg(checkpoint_dir=str(tmp_path / "full")), DATA),
        timeout=RANKS_TIMEOUT_S)
    marker = tmp_path / "failed_once"
    got = supervise_world(_fails_once_on_rank_1, CPU2, (
        _cfg(checkpoint_dir=str(tmp_path / "ck"), max_restarts=1,
             metrics_jsonl=str(tmp_path / "m.jsonl")), DATA, str(marker)))
    assert marker.exists()
    for r in range(2):
        assert got[r]["exit"] == 0 and got[r]["step"] == 8
        for a, b in zip(got[r]["params"], full[r]["params"], strict=True):
            np.testing.assert_array_equal(a, b)
        resumes = [f for f in got[r]["records"] if f["event"] == "ckpt"]
        assert [(f["reason"], f["step"]) for f in resumes] == [("resume", 3)]
    faults = [r for r in _records(tmp_path / "m.jsonl")
              if r["event"] == "fault"]
    assert [f["kind"] for f in faults] == ["restart"]
    assert "a real bug on rank 1 at step 5" in faults[0]["error"]
    _assert_same_arrays(_arrays(tmp_path / "ck"), _arrays(tmp_path / "full"))


def test_a_nan_abort_is_not_restarted(tmp_path):
    """The NaN guard's abort (NonFiniteLossError on both ranks) passes
    through the supervisor: one world, no restart record, RankError; the
    command exits 1."""
    cfg = _cfg(checkpoint_dir=str(tmp_path / "ck"), max_restarts=2,
               nan_policy="abort", fault_plan="nan@train.batch:2",
               metrics_jsonl=str(tmp_path / "m.jsonl"))
    with pytest.raises(RankError) as err:
        supervise_world(cnn_rank, CPU2, (cfg, DATA))
    assert {"NonFiniteLossError"} <= set(err.value.failures[0]["types"])
    kinds = [r["kind"] for r in _records(tmp_path / "m.jsonl")
             if r["event"] == "fault"]
    assert "restart" not in kinds and kinds.count("injected_nan") == 1
    assert main(TRAIN + _idx(tmp_path) + [
        "--checkpoint-dir", str(tmp_path / "cli"), "--max-restarts", "1",
        "--nan-policy", "abort", "--fault-plan", "nan@train.batch:2"]) == 1


def test_a_preemption_is_not_restarted(tmp_path):
    """A planned preemption on every rank: each writes nothing more and
    returns 75, the world is not restarted, and the command exits 75 with
    the step-3 snapshot to resume from."""
    cfg = _cfg(checkpoint_dir=str(tmp_path / "ck"), max_restarts=2,
               fault_plan="preempt@train.step:3",
               metrics_jsonl=str(tmp_path / "m.jsonl"))
    got = supervise_world(cnn_rank, CPU2, (cfg, DATA))
    assert [r["exit"] for r in got] == [EXIT_PREEMPTED] * 2
    kinds = [r["kind"] for r in _records(tmp_path / "m.jsonl")
             if r["event"] == "fault"]
    assert "restart" not in kinds
    assert latest_checkpoint(tmp_path / "ck").name == "ckpt_3.npz"


def test_a_fired_fault_does_not_fire_in_the_next_world(tmp_path):
    """The ranks report the plan indices that fired and the parent hands
    them to the next world's injectors: a plan of two crashes, each
    firing once in its own world, ends after two restarts; with one
    restart it is exhausted (the second crash fails the second world)."""
    inj = FaultInjector("crash@train.step:2;crash@train.step:5", fired=(0,))
    assert inj.poll("train.step", 2) == [] and inj.fired() == (0,)
    assert [f.at for f in inj.poll("train.step", 5)] == [5]
    assert inj.fired() == (0, 1)
    plan = "crash@train.step:2;crash@train.step:6"
    with pytest.raises(RankError) as err:
        supervise_world(cnn_rank, CPU2, (
            _cfg(checkpoint_dir=str(tmp_path / "one"), max_restarts=1,
                 fault_plan=plan), DATA))
    assert {f["rank"]: f["fired"] for f in err.value.failures} == {
        0: [0, 1], 1: [0, 1]}
    got = supervise_world(cnn_rank, CPU2, (
        _cfg(checkpoint_dir=str(tmp_path / "two"), max_restarts=2,
             fault_plan=plan, metrics_jsonl=str(tmp_path / "m.jsonl")),
        DATA))
    assert [r["exit"] for r in got] == [0, 0] and got[0]["step"] == 8
    kinds = [r["kind"] for r in _records(tmp_path / "m.jsonl")
             if r["event"] == "fault"]
    assert kinds == ["injected_crash", "restart"] * 2
