"""The `lm` command at `--num-devices 2` (two spawned gloo CPU ranks)
supervised from its parent (`train.ranks.supervise_world`): a crash at
`ckpt.pre_rename` of the step-3 checkpoint, which fires on rank 0 alone
(the only writer), under `--max-restarts 1` exits 0, the second world
resuming from ckpt_2 with the fired crash marked fired, and ends bit for
bit where the uninterrupted world-2 run ends (its latest checkpoint, every
array, the run file's train record of each step, and the final and eval
losses rank 0 prints); and within 1e-6 of the JAX LM trainer supervised
on a data:2 mesh of conftest's host devices with the same plan (its
checkpoint's params).
"""

import json
import re

import numpy as np

import mpi_cuda_cnn_tpu.faults as jax_faults
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.train.checkpoint import latest_checkpoint
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

TOL = 1e-6
BASE = dict(corpus="synthetic", dim=32, depth=1, heads=2, seq_len=64,
            batch_size=4, steps=6, warmup_steps=2, lr=3e-3,
            attn_impl="oracle", log_every=1, seed=0, checkpoint_every=1)
LM = ["lm", "--device", "cpu", "--num-devices", "2"] + [
    a for k, v in BASE.items()
    for a in (f"--{k.replace('_', '-')}", str(v))]
CRASH = ["--max-restarts", "1", "--fault-plan", "crash@ckpt.pre_rename:3"]


def _records(path) -> list[dict]:
    lines = open(path).read().splitlines()
    assert sum(ln.startswith("# run") for ln in lines) == 1
    return [json.loads(ln) for ln in lines if not ln.startswith("#")]


def _end(records: list[dict], err: str) -> dict:
    """Each step's loss (its last train record) and the final and eval
    losses of the `lm done:` line the ranks print (rank 0 alone)."""
    done = re.findall(r"lm done: steps=\d+ (loss=\S+ eval_loss=\S+ ppl=\S+)",
                      err)
    assert len(done) == 1, err
    return {"train": {r["step"]: r["loss"] for r in records
                      if r["event"] == "train"}, "done": done[0]}


def _arrays(directory) -> dict:
    with np.load(latest_checkpoint(directory)) as z:
        return {k: z[k] for k in z.files}


def test_world_2_lm_restarts_a_ckpt_crash_bitwise(tmp_path, capfd):
    full, crash = tmp_path / "full", tmp_path / "crash"
    assert main(LM + ["--checkpoint-dir", str(full / "ck"),
                      "--metrics-jsonl", str(full / "m.jsonl")]) == 0
    full_err = capfd.readouterr().err       # the ranks' stderr
    assert main(LM + CRASH + ["--checkpoint-dir", str(crash / "ck"),
                              "--metrics-jsonl", str(crash / "m.jsonl")]) == 0
    crash_err = capfd.readouterr().err
    got, want = _arrays(crash / "ck"), _arrays(full / "ck")
    assert sorted(got) == sorted(want) and int(got["step"]) == 6
    for k in got:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    records = _records(crash / "m.jsonl")
    end = _end(records, crash_err)
    assert end == _end(_records(full / "m.jsonl"), full_err)
    assert sorted(end["train"]) == list(range(1, 7))
    assert [(r["kind"], r.get("site")) for r in records
            if r["event"] == "fault"] == [
        ("injected_crash", "ckpt.pre_rename"), ("restart", None)]
    assert [(r["reason"], r["step"]) for r in records
            if r["event"] == "ckpt"] == [("resume", 2)]

    # The JAX package: the same plan through its LM trainer and
    # supervisor, one process on a data:2 mesh of host devices.
    jinj = jax_faults.FaultInjector("crash@ckpt.pre_rename:3")
    jmetrics = JaxMetrics(echo=False, capture=True)

    def attempt(n):
        cfg = JaxLMConfig(num_devices=2, checkpoint_dir=str(tmp_path / "jax"),
                          resume=n > 0, **BASE)
        return JaxLMTrainer(cfg, metrics=jmetrics, faults=jinj).train()

    jax_faults.supervise(attempt, max_restarts=1, metrics=jmetrics,
                         backoff_base=0)
    assert [r["kind"] for r in jmetrics.rows if r["event"] == "fault"] \
        == ["injected_crash", "restart"]
    jarrays = _arrays(tmp_path / "jax")
    params = [k for k in got if k.startswith("params/")]
    assert params and sorted(params) == sorted(
        k for k in jarrays if k.startswith("params/"))
    for k in params:
        np.testing.assert_allclose(got[k], jarrays[k], rtol=0, atol=TOL,
                                   err_msg=k)
