"""The port's seeded inits against the JAX package's, with no imported
params: `data/prng.normal` against `jax.random.normal`, the CNN presets'
`Sequential.init` (every initializer, and resnet8's residual splits), the
LM's `TransformerLM.init` (MHA and GQA, learned and rope positions) and
an MoE block's `init_moe_params`, each within ULP_MAX float32 ulp per
element (the draws are bit for bit today: only a sum's order may move
one); then the first step of `train --seed 0` and of `lm --seed 0` at
tiny sizes, whose losses agree within LOSS_RTOL (from the same weights,
the two forwards sum in other orders: about 2e-7 of the LM's loss).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.initializers import get_initializer as jax_init
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.parallel.ep import init_moe_params as jax_moe_init
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.parallel.moe import init_moe_params
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

ULP_MAX = 4          # float32 ulp per element, every init
BITWISE_MIN = 0.99   # share of prng.normal's draws equal bit for bit
LOSS_RTOL = 1e-6     # first-step losses of the two packages


def _ulps(a, b) -> np.ndarray:
    """|a - b| in float32 ulp (on the ordered integer line of the bits)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _assert_trees_close(mine, want):
    """Two params trees with the same paths, shapes and values within
    ULP_MAX ulp."""
    flat_m = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.detach().cpu().numpy(), mine))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in flat_m] == [p for p, _ in flat_w]
    for (path, m), (_, w) in zip(flat_m, flat_w):
        w = np.asarray(w)
        assert m.shape == w.shape and m.dtype == w.dtype, path
        assert _ulps(m, w).max() <= ULP_MAX, path


@pytest.mark.parametrize("seed", [0, 1])
def test_normal_is_jax_random_normal(seed):
    for shape in [(100_000,), (5, 1, 2, 9)]:
        want = np.asarray(jax.random.normal(jax.random.key(seed), shape,
                                            jnp.float32))
        got = prng.normal(prng.key(seed), shape).numpy()
        assert got.shape == want.shape and got.dtype == np.float32
        d = _ulps(got, want)
        assert (d == 0).mean() >= BITWISE_MIN and d.max() <= ULP_MAX, shape


@pytest.mark.parametrize("preset,init", [
    ("reference_cnn", "normal"), ("reference_cnn", "irwin_hall"),
    ("resnet8", "he")])
def test_cnn_inits_are_the_jax_packages(preset, init):
    jm = JAX_PRESETS[preset]()
    want = jm.init(jax.random.key(3), jax_init(init))
    mine = get_model(preset, input_shape=jm.input_shape).init(
        prng.key(3), get_initializer(init))
    _assert_trees_close(mine, want)


@pytest.mark.parametrize("kv_heads,pos", [(0, "learned"), (2, "rope")],
                         ids=["mha", "gqa_rope"])
def test_lm_inits_are_the_jax_packages(kv_heads, pos):
    cfg = dict(vocab=61, dim=64, heads=4, depth=2, max_seq=32,
               kv_heads=kv_heads, pos=pos)
    _assert_trees_close(TransformerLM(**cfg).init(prng.key(5)),
                        JaxLM(**cfg).init(jax.random.key(5)))


def test_moe_inits_are_the_jax_packages():
    _assert_trees_close(init_moe_params(prng.key(7), 32, 128, 4),
                        jax_moe_init(jax.random.key(7), 32, 128, 4))
    cfg = dict(vocab=61, dim=32, heads=2, depth=2, max_seq=32,
               moe_experts=4, moe_top_k=2)
    _assert_trees_close(TransformerLM(**cfg).init(prng.key(0)),
                        JaxLM(**cfg).init(jax.random.key(0)))


def test_train_seed_0_first_step_loss_is_the_jax_packages():
    """One step of reference_cnn (the 32 samples of one batch) from each
    package's own `--seed 0` init."""
    kw = dict(epochs=1, batch_size=32, lr=0.1, log_every=0, eval_every=0,
              seed=0)
    jtr = JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(32, 8),
                     JaxConfig(num_devices=1, scan=False, **kw),
                     metrics=JaxMetrics(echo=False))
    tr = Trainer(get_model("reference_cnn"), synthetic_stripes(32, 8),
                 Config(device="cpu", **kw), metrics=MetricsLogger(echo=False))
    want, got = jtr.run_epoch(0)["loss"], tr.run_epoch(0)["loss"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)


def test_lm_seed_0_first_step_loss_is_the_jax_packages():
    kw = dict(corpus="synthetic", dim=32, depth=2, heads=4, seq_len=64,
              batch_size=4, steps=1, warmup_steps=0, attn_impl="oracle",
              log_every=1, seed=0, kv_heads=2)
    want = JaxLMTrainer(JaxLMConfig(num_devices=1, **kw),
                        metrics=JaxMetrics(echo=False)).train()
    got = LMTrainer(LMConfig(device="cpu", **kw),
                    metrics=MetricsLogger(echo=False)).train()
    np.testing.assert_allclose(got.final_loss, want.final_loss,
                               rtol=LOSS_RTOL)
