"""bf16-compute CNN training in the port (`Sequential.apply(...,
compute_dtype=torch.bfloat16)`, `Trainer` with `compute_dtype=
"bfloat16"`, the bf16 K3/K4/K5 wrappers) against the JAX package on the
CPU, with inputs made by numpy from a seed and handed to both.

bf16 rounds at other places in the two frameworks: the JAX package's
Pallas stride-2 conv rounds each of its four phase outputs to bf16 and
sums them in bf16, where the port's kernel sums all taps in float32 and
rounds once; its bias gradients are bf16 reductions of another order.
Each comparison therefore carries a bf16-sized tolerance, measured here
and stated beside it; the dtype of every bf16 result is asserted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.initializers import get_initializer as jax_init
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.ops.pallas_ops import conv2d_pallas, dense_pallas
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.ops import _kernels, kernel_ops
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, check_supported
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

# One op in bf16, output and gradients: relative L2 against the JAX
# package's Pallas op. 3.7e-3 measured at the stride-2 convs (the phase
# roundings above), 0 at stride 1 and for dense (the bias added to the
# bf16-rounded product, as there).
OP_REL_L2 = 1e-2
# reference_cnn's float32 logits of a bf16 forward from equal params:
# 7.2e-3 measured against the JAX Pallas forward (its stride-2 convs),
# 0 between the port's torch backend and the JAX XLA forward.
LOGITS_REL_L2 = 2e-2
# 8 bf16 steps from the JAX trainer's init at lr 0.1: the roundings above
# drift the runs apart. Measured against the JAX per-batch Pallas run:
# mean loss 3.5e-3 apart (relative), equal eval counts. Each param leaf
# is held by the relative L2 gap of its change from init,
# ||d_port - d_jax|| / ||d_jax||, so the limit scales with the update:
# weights 0.040-0.056 measured (limit 0.1); biases, whose gradients the
# JAX package reduces in bf16 in another order, 0.074-0.288 (conv1's
# bias the largest; limit 0.4). A zeroed update of one leaf reads 1 and
# a halved one about 0.5.
LOSS_RTOL = 1e-2
UPDATE_REL_L2 = {"weight": 0.1, "bias": 0.4}
CONV_CASES = [
    (4, 28, 28, 1, 3, 16, 2, 1),
    (4, 14, 14, 16, 3, 32, 2, 1),
    (2, 8, 8, 3, 5, 4, 1, 2),
    (2, 6, 6, 2, 3, 3, 1, 0),
]
DENSE_CASES = [(32, 1568, 200), (5, 7, 3), (32, 200, 10)]
N_TRAIN, N_TEST, BATCH = 256, 64, 32


def _rand(*shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel_l2(got, want):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.fixture
def no_launch():
    before = dict(_kernels.launches)
    yield
    assert _kernels.launches == before


def _both(port_fn, jax_fn, arrays):
    """Output and gradients of sum(f(...)^2) wrt every input, in bf16, on
    the port and on the JAX package."""
    ts = [torch.from_numpy(a).to(torch.bfloat16).requires_grad_(True)
          for a in arrays]
    y = port_fn(*ts)
    grads = torch.autograd.grad((y.float() ** 2).sum(), ts)
    js = [jnp.asarray(a, jnp.bfloat16) for a in arrays]
    jy = jax_fn(*js)
    jgrads = jax.grad(
        lambda *a: jnp.sum(jax_fn(*a).astype(jnp.float32) ** 2),
        argnums=tuple(range(len(js))))(*js)
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert all(g.dtype == torch.bfloat16 for g in grads)
    return [(y, jy)] + list(zip(grads, jgrads))


@pytest.mark.parametrize("m,k,n", DENSE_CASES)
def test_dense_kernel_bf16_matches_dense_pallas(m, k, n, no_launch):
    arrays = (_rand(m, k), _rand(k, n, seed=1) / np.float32(k ** 0.5),
              _rand(n, seed=2))
    for got, want in _both(kernel_ops.dense_kernel, dense_pallas, arrays):
        assert _rel_l2(got, want) <= OP_REL_L2


@pytest.mark.parametrize("n,h,w,cin,k,cout,stride,pad", CONV_CASES)
def test_conv2d_kernel_bf16_matches_conv2d_pallas(n, h, w, cin, k, cout,
                                                  stride, pad, no_launch):
    arrays = (_rand(n, h, w, cin), _rand(k, k, cin, cout, seed=1))
    pairs = _both(lambda a, b: kernel_ops.conv2d_kernel(a, b, stride, pad),
                  lambda a, b: conv2d_pallas(a, b, stride, pad), arrays)
    for got, want in pairs:
        assert _rel_l2(got, want) <= OP_REL_L2


@pytest.mark.parametrize("backend,jax_backend", [("cuda", "pallas"),
                                                 ("torch", "xla")])
def test_sequential_apply_bf16_matches_jax(backend, jax_backend, no_launch):
    jm, tm = JAX_PRESETS["reference_cnn"](), get_model("reference_cnn")
    jp = jm.init(jax.random.key(0), jax_init("normal"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    x = np.random.default_rng(1).random((8, *jm.input_shape), np.float32)
    want = jm.apply(jp, jnp.asarray(x), backend=jax_backend,
                    compute_dtype=jnp.bfloat16)
    got = tm.apply(tp, torch.from_numpy(x), backend=backend,
                   compute_dtype=torch.bfloat16)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert _rel_l2(got, want) <= LOGITS_REL_L2
    # The float32 params get float32 gradients through the cast.
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    logits = tm.apply(tp, torch.from_numpy(x), backend=backend,
                      compute_dtype=torch.bfloat16)
    grads = torch.autograd.grad(logits.square().sum(), leaves)
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads)


@pytest.fixture(scope="module")
def jax_bf16_run():
    """8 bf16 steps of the JAX trainer's per-batch loop on its Pallas
    kernels: its initial params, final params, mean loss and eval."""
    cfg = JaxConfig(epochs=1, batch_size=BATCH, lr=0.1, num_devices=1,
                    use_pallas=True, compute_dtype="bfloat16", scan=False,
                    log_every=0, eval_every=0)
    tr = JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(N_TRAIN, N_TEST),
                    cfg, metrics=JaxMetrics(echo=False))
    init = jax.device_get(tr.state["params"])
    em = tr.run_epoch(0)
    return {"init": init,
            "params": jax.tree.leaves(jax.device_get(tr.state["params"])),
            "loss": em["loss"], "eval": tr.evaluate()}


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["torch", "cuda"])
def test_eight_bf16_steps_match_the_jax_trainer(jax_bf16_run, use_kernels,
                                                scan, no_launch):
    cfg = Config(epochs=1, batch_size=BATCH, lr=0.1, device="cpu",
                 log_every=0, eval_every=0, use_kernels=use_kernels,
                 scan=scan, compute_dtype="bfloat16")
    tr = Trainer(get_model("reference_cnn"), synthetic_stripes(N_TRAIN, N_TEST),
                 cfg, metrics=MetricsLogger(echo=False),
                 params=params_from_jax(jax_bf16_run["init"]))
    assert tr.compute_dtype == torch.bfloat16
    em = tr.run_epoch(0)
    assert em["steps"] == N_TRAIN // BATCH and tr.step == 8
    got = tree_leaves(tr.params)
    assert all(t.dtype == torch.float32 for t in got)   # float32 master params
    init = jax.tree.leaves(jax_bf16_run["init"])
    assert len(got) == len(jax_bf16_run["params"]) == len(init)
    for i, (g, w, w0) in enumerate(zip(got, jax_bf16_run["params"], init)):
        want = np.asarray(w) - np.asarray(w0)
        gap = np.linalg.norm(g.detach().numpy() - w0 - want) / np.linalg.norm(want)
        limit = UPDATE_REL_L2["bias" if g.dim() == 1 else "weight"]
        assert gap <= limit, (i, tuple(g.shape), gap, limit)
    np.testing.assert_allclose(em["loss"], jax_bf16_run["loss"],
                               rtol=LOSS_RTOL)
    assert tr.evaluate() == jax_bf16_run["eval"]


def test_check_supported_keeps_refusing_the_rest_of_item_4():
    check_supported(Config(compute_dtype="bfloat16"))
    for kw in (dict(param_dtype="bfloat16"), dict(grad_accum=2),
               dict(remat=True)):
        with pytest.raises(NotImplementedError, match="queue E item 4"):
            check_supported(Config(**kw))
    with pytest.raises(ValueError, match="compute-dtype"):
        check_supported(Config(compute_dtype="float16"))


@pytest.mark.parametrize("extra", [[], ["--use-kernels"]],
                         ids=["torch", "cuda"])
def test_cli_trains_in_bf16_on_the_cpu(extra, no_launch):
    base = ["train", "--device", "cpu", "--dataset", "synthetic", "--epochs",
            "1", "--log-every", "0"]
    assert main(base + ["--compute-dtype", "bfloat16"] + extra) == 0
    assert main(base + ["--compute-dtype", "float16"]) == 2
