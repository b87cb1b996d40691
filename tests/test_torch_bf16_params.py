"""bf16 params (`--param-dtype bfloat16`) of the port against the JAX
package on the CPU, in the three cases the reference has:

- bf16 params, bf16 compute, on either backend: the step runs, every
  gradient and every updated param is bf16;
- bf16 params, float32 compute, on the kernels (the reference's Pallas
  path): x in float32 against the upcast weights; the gradients come
  back as the reference's mix, float32 where a kernel took the operand
  (conv w, dense w and b) and bf16 for a conv bias, added outside the
  kernel; the params stay bf16 after the update;
- bf16 params, float32 compute, on PyTorch's ops: the reference's XLA
  conv raises a dtype error; the port refuses at construction with a
  ValueError, and the command exits 2.

From the JAX trainer's bf16 initial params, one step (a train set of
one batch) on each side, every gradient leaf and every param held by its
relative L2 to JAX's (measured on this CPU, stated beside each bound).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# Float32 compute: 0 measured for every gradient, up to 3.2e-3 for a
# param after the step (the update's rounding to bf16). bf16 compute: the
# dense leaves' gradients up to 7.4e-3, every weight after the step up
# to 2.3e-3.
REL_L2 = 1e-2
# bf16 compute, the conv leaves: the JAX package rounds its stride-2
# Pallas conv's four phase outputs to bf16 and reduces the bias
# gradients in bf16 in another order (tests/test_torch_bf16_train.py
# says more). Measured: the conv gradients 0.030-0.051, the conv biases
# after the step 0.037-0.051. A zeroed leaf reads 1, a halved one 0.5.
BF16_CONV_REL_L2 = 0.1
BATCH = 32
# tree_leaves order: per layer b then w; conv1, conv2, fc1, fc2, fc3.
MIXED_GRAD_DTYPES = ["bfloat16", "float32"] * 2 + ["float32"] * 6
CASES = {"bf16_xla": (False, "bfloat16"), "bf16_kernels": (True, "bfloat16"),
         "f32_kernels": (True, "float32")}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _dtype_name(t) -> str:
    return str(t.dtype).replace("torch.", "")


@pytest.fixture(scope="module")
def jax_steps():
    """Per case: the JAX trainer's bf16 init, the first step's gradients
    and dtypes, and its params after that one step."""
    out = {}
    for name, (use_pallas, compute) in CASES.items():
        ds = jax_stripes(BATCH, 64)
        tr = JaxTrainer(JAX_PRESETS["reference_cnn"](), ds, JaxConfig(
            epochs=1, batch_size=BATCH, num_devices=1, scan=False,
            log_every=0, eval_every=0, param_dtype="bfloat16",
            compute_dtype=compute, use_pallas=use_pallas),
            metrics=JaxMetrics(echo=False))
        init = jax.device_get(tr.state["params"])
        x = jnp.asarray(tr.train_x[tr._epoch_order(0)])
        y = jnp.asarray(tr.train_y[tr._epoch_order(0)])
        g = jax.jit(jax.grad(lambda p: tr.loss_fn(p, x, y)[0]))(
            tr.state["params"])
        tr.run_epoch(0)
        out[name] = {
            "init": jax.tree.map(lambda a: np.asarray(a, np.float32), init),
            "grads": [np.asarray(t, np.float32) for t in jax.tree.leaves(g)],
            "grad_dtypes": [str(t.dtype) for t in jax.tree.leaves(g)],
            "params": jax.tree.leaves(jax.device_get(tr.state["params"]))}
    return out


def _port(name, init):
    use_kernels, compute = CASES[name]
    return Trainer(get_model("reference_cnn"), synthetic_stripes(BATCH, 64),
                   Config(epochs=1, batch_size=BATCH, device="cpu",
                          log_every=0, eval_every=0, param_dtype="bfloat16",
                          compute_dtype=compute, use_kernels=use_kernels),
                   metrics=MetricsLogger(echo=False),
                   params=params_from_jax(init))


@pytest.mark.parametrize("name", CASES)
def test_gradient_dtypes_are_the_reference_paths(jax_steps, name):
    tr = _port(name, jax_steps[name]["init"])
    assert [_dtype_name(p) for p in tree_leaves(tr.params)] == \
        ["bfloat16"] * 10
    got = [_dtype_name(g) for g in tr.first_grads()]
    assert got == jax_steps[name]["grad_dtypes"]
    want = MIXED_GRAD_DTYPES if name == "f32_kernels" else ["bfloat16"] * 10
    assert got == want


def _bound(name: str, leaf: int, *, grad: bool) -> float:
    """REL_L2, or BF16_CONV_REL_L2 for a conv leaf in bf16 compute (every
    conv leaf's gradient; a conv bias after the step)."""
    conv = leaf < 4 and (grad or leaf % 2 == 0)
    return BF16_CONV_REL_L2 if conv and name != "f32_kernels" else REL_L2


@pytest.mark.parametrize("name", CASES)
def test_first_gradients_match_jax(jax_steps, name):
    tr = _port(name, jax_steps[name]["init"])
    for i, (g, j) in enumerate(zip(tr.first_grads(),
                                   jax_steps[name]["grads"], strict=True)):
        assert _rel_l2(g.float().numpy(), j) <= _bound(name, i, grad=True)


@pytest.mark.parametrize("name", CASES)
def test_one_step_keeps_bf16_params_and_matches_jax(jax_steps, name):
    tr = _port(name, jax_steps[name]["init"])
    em = tr.run_epoch(0)
    assert tr.step == 1 and np.isfinite(em["loss"])
    for i, (p, j) in enumerate(zip(tree_leaves(tr.params),
                                   jax_steps[name]["params"], strict=True)):
        assert p.dtype == torch.bfloat16 and str(j.dtype) == "bfloat16"
        assert _rel_l2(p.float().detach().numpy(), np.asarray(
            j, np.float32)) <= _bound(name, i, grad=False)


def test_float32_compute_on_the_kernels_upcasts_the_weights(jax_steps):
    """The float32 forward reads the bf16 weights upcast exactly: the
    logits are those of float32 params holding the same values."""
    init = jax_steps["f32_kernels"]["init"]
    tr = _port("f32_kernels", init)
    x = torch.from_numpy(tr.test_x[:8])
    ref = tr.model.apply(_float32_copy(tr.params), x, backend="cuda")
    torch.testing.assert_close(tr.predict(x), ref, rtol=0, atol=0)


def _float32_copy(params):
    return [{k: v.detach().float() for k, v in p.items()} for p in params]


def test_float32_compute_on_torch_ops_is_refused_as_jax_raises(jax_steps):
    with pytest.raises(TypeError, match="same dtypes"):
        tr = JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(BATCH, 8),
                        JaxConfig(epochs=1, batch_size=BATCH, num_devices=1,
                                  scan=False, log_every=0, eval_every=0,
                                  param_dtype="bfloat16"),
                        metrics=JaxMetrics(echo=False))
        tr.run_epoch(0)
    with pytest.raises(ValueError, match="kernels only"):
        Trainer(get_model("reference_cnn"), synthetic_stripes(BATCH, 8),
                Config(device="cpu", batch_size=BATCH,
                       param_dtype="bfloat16"))


@pytest.mark.parametrize("argv", [
    ["--param-dtype", "bfloat16"],
    ["--param-dtype", "float16"],
    ["--param-dtype", "bfloat16", "--use-kernels", "--checkpoint-dir", "ck",
     "--mesh-shape", "pipe:2"]],
    ids=["torch_f32", "float16", "checkpoint"])
def test_refused_param_dtypes_exit_2(argv, tmp_path, monkeypatch):
    """bf16 params in float32 compute off the kernels, a dtype the
    reference lacks, and bf16 params on the pipe axis (whose packed stage
    rows are float32 in the reference): exit 2, no checkpoint written.
    bf16 params with --checkpoint-dir on the other meshes are written
    and resumed (test_bf16_params_checkpoint_and_resume_through_the_command)."""
    monkeypatch.chdir(tmp_path)
    assert main(["train", "--device", "cpu", "--epochs", "1", *argv]) == 2
    assert not (tmp_path / "ck").exists()


def _idx_args(tmp_path) -> list[str]:
    """The reference's four IDX paths of a 128-image set (an epoch of 4
    steps)."""
    paths = write_synthetic_idx(tmp_path, synthetic_stripes(128, 64))
    return [str(p) for p in paths.values()]


@pytest.mark.parametrize("argv", [
    ["--compute-dtype", "bfloat16"], ["--use-kernels"],
    ["--use-kernels", "--compute-dtype", "bfloat16"]])
def test_bf16_params_train_through_the_command(argv, tmp_path):
    assert main(["train", *_idx_args(tmp_path), "--device", "cpu",
                 "--epochs", "1", "--param-dtype", "bfloat16", *argv]) == 0


def test_bf16_params_checkpoint_and_resume_through_the_command(tmp_path):
    """bf16 params with --checkpoint-dir: the command writes the bf16
    leaves as `|V2` and resumes its own file for a second epoch."""
    argv = ["train", *_idx_args(tmp_path), "--device", "cpu",
            "--param-dtype", "bfloat16", "--compute-dtype", "bfloat16",
            "--checkpoint-dir", str(tmp_path / "ck"), "--log-every", "0"]
    assert main([*argv, "--epochs", "1"]) == 0
    with np.load(tmp_path / "ck" / "ckpt_4.npz") as f:
        assert f["params/0/w"].dtype == np.dtype("V2")
    assert main([*argv, "--epochs", "2", "--resume"]) == 0
    assert (tmp_path / "ck" / "ckpt_8.npz").exists()
