"""The port's data-parallel LM trainer against the JAX package's on the
CPU: `JaxLMTrainer(num_devices=2)` (the GSPMD step, state replicated and
batch sharded over 2 of conftest's 8 host devices) and the port's
`LMTrainer` on 2 spawned gloo ranks, from the JAX trainer's initial
params, at the configuration of tests/test_torch_lm.py's trainer parity
(dim 32, depth 1, 2 heads, seq 64, batch 4, 4 steps, oracle attention).
Each rank's windows are the JAX shard's bit for bit; the final and eval
losses agree within LOSS_RTOL (sums in other orders, the all-reduce's
among them).
"""

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.parallel.dp import dp_shard_batch
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig, check_lm_supported

LOSS_RTOL = 1e-5       # tests/test_torch_lm.py's trainer parity
W = 2
STEPS = 4
RANKS_TIMEOUT_S = 240
BASE = dict(corpus="synthetic", dim=32, depth=1, heads=2, seq_len=64,
            batch_size=4, steps=STEPS, warmup_steps=20, lr=3e-3,
            attn_impl="oracle", log_every=1)


@pytest.fixture(scope="module")
def runs():
    """The JAX trainer at num_devices 2 (its initial params, windows of
    step 0 as placed on the mesh, result), and the port's ranks."""
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=W, **BASE))
    init = jax.device_get(jtr.state["params"])
    tokens = jtr._place(jtr._sample_batch(0)[0])
    shards = {s.device.id: np.asarray(s.data)
              for s in tokens.addressable_shards}
    jax_shards = [shards[d.id] for d in jtr.mesh.devices.flat]
    jres = jtr.train()
    ranks = run_ranks(lm_rank, W, args=(
        LMConfig(device="cpu", num_devices=W, **BASE),
        params_from_jax(init)), timeout=RANKS_TIMEOUT_S)
    return {"jax": jres, "jax_shards": jax_shards, "ranks": ranks}


def test_each_rank_keeps_its_rows_of_the_same_windows(runs):
    tr = LMTrainer(LMConfig(device="cpu", **BASE))
    tokens, _ = tr._sample_batch(0)
    for r, want in enumerate(runs["jax_shards"]):
        mesh = Mesh(shape={"data": W}, rank=r, world=W, device=tr.device,
                    group=None)
        np.testing.assert_array_equal(dp_shard_batch(tokens, mesh), want)


def test_lm_dp_matches_the_jax_dp_trainer(runs):
    jres = runs["jax"]
    for res in runs["ranks"]:
        assert len(res["losses"]) == STEPS
        np.testing.assert_allclose(res["final_loss"], jres.final_loss,
                                   rtol=LOSS_RTOL)
        np.testing.assert_allclose(res["eval_loss"], jres.eval_loss,
                                   rtol=LOSS_RTOL)
        # one all-reduce per step, none in the replicated eval
        assert res["counts"]["collectives"] == {"all_reduce": STEPS,
                                                "broadcast": 0}
    assert runs["ranks"][0]["losses"] == runs["ranks"][1]["losses"]


@pytest.mark.parametrize("kw", [dict(mesh_shape="data:2,model:2"),
                                dict(mesh_shape="data:2,seq:2"),
                                dict(fsdp=True, num_devices=2),
                                dict(elastic_width=4,
                                     mesh_shape="data:2,seq:2")],
                         ids=["model", "seq", "fsdp", "elastic"])
def test_what_the_lm_data_mesh_still_refuses(kw):
    with pytest.raises(NotImplementedError, match="queue F item 1"):
        check_lm_supported(LMConfig(**kw))


def test_lm_batch_not_divisible_by_the_data_axis_raises():
    with pytest.raises(ValueError, match="batch_size 6 not divisible by "
                                         "data-axis size 4"):
        check_lm_supported(LMConfig(batch_size=6, num_devices=4))
    with pytest.raises(ValueError, match="an LMTrainer is one rank"):
        LMTrainer(LMConfig(device="cpu", num_devices=2, **BASE))


def test_cli_lm_on_two_cpu_ranks(capfd):
    argv = ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
            "--depth", "1", "--heads", "2", "--seq-len", "64",
            "--batch-size", "4", "--steps", "2", "--log-every", "1",
            "--num-devices", "2"]
    assert main(argv) == 0
    err = capfd.readouterr().err       # the ranks' stderr: rank 0 echoes
    assert err.count("lm done: steps=2") == 1, err
    assert main(argv + ["--ce-chunk", "48"]) == 2    # a rank's setup error
