"""The port's LM trainer on the flash path at head dims beyond the first
kernels' 16/32/64/128, against the JAX package's trainer on the CPU:
`attn_impl="flash"` at dim 96 / 4 heads (D 24, which the card pads to its
32 instance) and dim 160 / 2 heads (D 80, an instance), depth 2, S 256,
and ring-flash on a `seq:2` mesh at D 24 (two spawned gloo ranks against
the JAX trainer on two of conftest's host devices). The JAX flash kernel
runs in Pallas interpret mode; the port runs its kernels' plain versions
(the CPU's route; `test_torch_flash_attention.py` holds the card's pad
route to them). Both packages draw the same weights from `--seed 0`.
After 3 AdamW steps the logged losses agree within 1e-5, the eval loss
within 1e-5 relative, and every parameter leaf within 1e-5 relative L2.
"""

import jax
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

TOL = 1e-5
STEPS = 3
RANKS_TIMEOUT_S = 240
BASE = dict(corpus="synthetic", depth=2, seq_len=256, batch_size=2,
            steps=STEPS, warmup_steps=1, lr=3e-3, log_every=1, seed=0)
CASES = {  # name: (world, flags); head dim = dim / heads
    "d24": (1, dict(dim=96, heads=4, attn_impl="flash")),
    "d80": (1, dict(dim=160, heads=2, attn_impl="flash")),
    "d24_seq2_ring_flash": (2, dict(dim=96, heads=4, attn_impl="ring_flash",
                                    mesh_shape="seq:2")),
}


def _jax_run(world: int, flags: dict):
    metrics = JaxMetrics(echo=False, capture=True)
    tr = JaxLMTrainer(JaxLMConfig(num_devices=world, **BASE, **flags),
                      metrics=metrics)
    res = tr.train()
    losses = [r["loss"] for r in metrics.rows if r["event"] == "train"]
    return tr.attn_impl, losses, res, [
        np.asarray(x) for x in jax.tree.leaves(jax.device_get(
            tr.state["params"]))]


@pytest.mark.parametrize("name", list(CASES))
def test_lm_trainer_on_flash_matches_the_jax_trainer_at_head_dim(name):
    world, flags = CASES[name]
    cfg = LMConfig(device="cpu", **BASE, **flags)
    before = dict(_kernels.launches)
    if world == 1:
        ranks = [lm_rank(None, cfg, final_params=True)]
        assert _kernels.launches == before      # the CPU: plain versions
    else:
        ranks = run_ranks(lm_rank, world, args=(cfg,),
                          kwargs={"final_params": True}, axes={"seq": world},
                          timeout=RANKS_TIMEOUT_S)
    impl, losses, jres, jparams = _jax_run(world, flags)
    assert impl == flags["attn_impl"] and len(losses) == STEPS
    for res in ranks:
        assert res["exit"] == 0
        np.testing.assert_allclose(res["losses"], losses, rtol=0, atol=TOL)
        np.testing.assert_allclose(res["eval_loss"], jres.eval_loss,
                                   rtol=TOL)
        assert len(res["params"]) == len(jparams)
        for got, want in zip(res["params"], jparams):
            assert got.shape == want.shape
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= TOL, (name, rel)
