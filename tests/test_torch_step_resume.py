"""Step-granular (mid-epoch) checkpoint and resume of the port's CNN
trainer, on one device and at world 2 (ported from
tests/test_step_resume.py).

A run killed after k steps and resumed from its k-step checkpoint ends
with the same params, bit for bit, as the uninterrupted run, also when k
falls mid-epoch: the epoch order is a function of (seed, epoch)
(`Trainer._epoch_order`), so the resumed process rebuilds the epoch's
permutation and skips its first k % steps_per_epoch batches. At world 2
(two spawned gloo ranks on the CPU, through the `train` command's rank
entry) a planned crash fails the world, its parent's supervisor
(`train.ranks.supervise_world`) spawns it again from the checkpoint that
rank 0 alone wrote, and the world ends bit for bit where the
uninterrupted world-2 run ends; so does a crash at rank 0's checkpoint
site through the command.
"""

import json
import re

import time

import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.parallel.distributed import RankError, run_ranks
from mpi_cuda_cnn_tpu_torch.train.checkpoint import (
    checkpoint_meta,
    latest_checkpoint,
)
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank, supervise_world
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# Spawning 2 CPU ranks takes a few seconds; 8 steps a run well under one.
RANKS_TIMEOUT_S = 240


def _quiet():
    return MetricsLogger(echo=False)


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


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
def test_mid_epoch_resume_is_bitwise_exact(tmp_path, scan):
    """Uninterrupted 2-epoch run == run killed at step 6 (mid-epoch 1)
    + resume from the 6-step checkpoint. Bitwise."""
    full = Trainer(get_model("reference_cnn"), _ds(), _cfg(scan=scan),
                   metrics=_quiet())
    full.train()
    ck = tmp_path / "ck"
    killed = Trainer(get_model("reference_cnn"), _ds(),
                     _cfg(scan=scan, checkpoint_dir=str(ck),
                          checkpoint_every_steps=3), metrics=_quiet())
    killed.train()
    kept = ck / "ckpt_6.npz"
    assert kept.exists(), sorted(p.name for p in ck.iterdir())
    for p in ck.glob("ckpt_*.npz"):
        if p != kept:
            p.unlink()
    resumed = Trainer(get_model("reference_cnn"), _ds(),
                      _cfg(scan=scan, checkpoint_dir=str(ck), resume=True),
                      metrics=_quiet())
    res = resumed.train()
    assert res.final_step == full.step == 8
    assert res.epochs_run == 1
    for a, b in zip(_params(full), _params(resumed), strict=True):
        assert torch.equal(a, b)


def test_scan_and_loop_paths_share_batch_order():
    """The (seed, epoch) order makes the two routes interchangeable: the
    same params after one epoch, bit for bit in the port."""
    outs = []
    for scan in (True, False):
        t = Trainer(get_model("reference_cnn"), _ds(),
                    _cfg(scan=scan, epochs=1), metrics=_quiet())
        t.train()
        outs.append(_params(t))
    for a, b in zip(*outs, strict=True):
        assert torch.equal(a, b)


def test_scan_falls_back_for_oversized_datasets():
    t_small = Trainer(get_model("reference_cnn"), _ds(), _cfg(epochs=1),
                      metrics=_quiet())
    assert t_small._use_device_data()
    t_big = Trainer(get_model("reference_cnn"), _ds(),
                    _cfg(epochs=1, scan_max_bytes=1), metrics=_quiet())
    assert not t_big._use_device_data()
    em = t_big.run_epoch(0)
    assert np.isfinite(em["loss"]) and em["steps"] == 4
    assert not Trainer(get_model("reference_cnn"), _ds(),
                       _cfg(epochs=1, scan=False),
                       metrics=_quiet())._use_device_data()


def test_epoch_order_is_stateless():
    t1 = Trainer(get_model("reference_cnn"), _ds(), _cfg(), metrics=_quiet())
    t2 = Trainer(get_model("reference_cnn"), _ds(), _cfg(), metrics=_quiet())
    np.testing.assert_array_equal(t1._epoch_order(3), t2._epoch_order(3))
    assert not np.array_equal(t1._epoch_order(0), t1._epoch_order(1))


def _written(res: dict) -> int:
    """Checkpoint files a rank wrote, over its whole run."""
    return sum(res[part]["checkpoints"]["written"]
               for part in ("init", "epoch_counts", "eval_counts"))


def test_world_2_crash_restart_is_bitwise_with_one_writer(tmp_path):
    """World 2 on gloo, 2 epochs of 4 steps, checkpoints every 3 steps: a
    planned crash after step 5 fires on both ranks and fails the world;
    the parent spawns the second world from ckpt_3 (written by rank 0
    alone; its manifest records the world-2 mesh), which replays steps 4
    and 5; both ranks end bit for bit where the uninterrupted world-2 run
    ends. Rank 0's run file holds the crash and the parent's restart."""
    data = dict(num_train=64, num_test=32)
    base = dict(num_devices=2, checkpoint_every_steps=3, scan=False)
    full = run_ranks(cnn_rank, 2, args=(
        _cfg(checkpoint_dir=str(tmp_path / "full"), **base), data),
        timeout=RANKS_TIMEOUT_S)
    crash = supervise_world(cnn_rank, [torch.device("cpu")] * 2, (
        _cfg(checkpoint_dir=str(tmp_path / "crash"), max_restarts=1,
             fault_plan="crash@train.step:5",
             metrics_jsonl=str(tmp_path / "m.jsonl"), **base), data))
    for r in range(2):
        assert crash[r]["exit"] == 0 and crash[r]["step"] == 8
        for a, b in zip(crash[r]["params"], full[r]["params"], strict=True):
            np.testing.assert_array_equal(a, b)
        resumes = [f for f in crash[r]["records"] if f["event"] == "ckpt"]
        assert [(f["reason"], f["step"]) for f in resumes] == [("resume", 3)]
    kinds = [json.loads(ln)["kind"] for ln in
             open(tmp_path / "m.jsonl").read().splitlines()
             if '"event": "fault"' in ln]
    assert kinds == ["injected_crash", "restart"]
    # the second world wrote steps 6 and 8 (the first, step 3)
    assert [_written(res) for res in crash] == [2, 0]
    assert [_written(res) for res in full] == [3, 0]
    meta = checkpoint_meta(tmp_path / "crash", "ckpt_8.npz")
    assert meta == {"mesh": {"axes": {"data": 2}, "devices": 2},
                    "elastic_width": 0, "process_count": 2}


def _latest(directory) -> dict:
    with np.load(latest_checkpoint(directory)) as z:
        return {k: z[k] for k in z.files}


def test_world_2_crash_of_rank_0_alone_fails_the_world(tmp_path, capfd):
    """A crash at ckpt.pre_rename fires on rank 0 alone (the only writer):
    rank 0 does not restart by itself into a broadcast while rank 1 waits
    at the save's barrier: the world fails with RankError well inside the
    collective timeout. The command supervises the world from its parent
    (--max-restarts 1): it spawns the world again, which resumes from the
    step-2 checkpoint, exits 0 and ends bit for bit where the
    uninterrupted world-2 run ends (the latest checkpoint, every array,
    and the ntests/ncorrect line rank 0 prints)."""
    data = dict(num_train=64, num_test=32)
    cfg = _cfg(num_devices=2, checkpoint_every_steps=3, scan=False,
               checkpoint_dir=str(tmp_path / "ck"), max_restarts=1,
               fault_plan="crash@ckpt.pre_rename:3")
    t0 = time.monotonic()
    with pytest.raises(RankError, match="injected crash at ckpt.pre_rename"):
        run_ranks(cnn_rank, 2, args=(cfg, data), timeout=RANKS_TIMEOUT_S)
    assert time.monotonic() - t0 < 60
    argv = ["train", "--dataset", "synthetic", "--device", "cpu",
            "--num-devices", "2", "--epochs", "2", "--batch-size", "500",
            "--log-every", "0", "--checkpoint-every-steps", "1"]
    assert main(argv + ["--checkpoint-dir", str(tmp_path / "full")]) == 0
    want = capfd.readouterr().err       # the ranks' stderr
    assert main(argv + ["--checkpoint-dir", str(tmp_path / "cli"),
                        "--max-restarts", "1",
                        "--fault-plan", "crash@ckpt.pre_rename:3"]) == 0
    got = capfd.readouterr().err
    a, b = _latest(tmp_path / "cli"), _latest(tmp_path / "full")
    assert sorted(a) == sorted(b) and int(a["step"]) == 8
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    line = re.compile(r"ntests=\d+, ncorrect=\d+")
    assert len(line.findall(want)) == 1
    assert line.findall(got) == line.findall(want)
