"""Gradient accumulation (`parallel/dp.local_grads`, `--grad-accum`) and
rematerialization (`Sequential.apply(remat=True)`, `--remat`) of the
port against the JAX package on the CPU (the twin of
tests/test_accum_remat.py).

From the JAX trainer's initial params, 8 SGD steps of reference_cnn on
synthetic_stripes(256, 64) at batch 32 with --grad-accum a run against
the JAX trainer's per-batch loop at the same a: params within
PARAM_ATOL, the loss within LOSS_RTOL, accuracy and eval counts equal;
at world 1 on both of the port's backends and epoch routes, at world 2
on spawned gloo ranks. The micro-batch split is pinned row for row. The
LM at a = 2 keeps JAX's losses within LOSS_RTOL. Remat recomputes the
same forward, so on the CPU it is bit for bit the plain port, and within
PARAM_ATOL of JAX's remat run.
"""

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.parallel.dp import local_grads
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# As tests/test_torch_train.py: 8 float32 SGD steps from equal params,
# sums in other orders (here also the micro-batch sums'), about 30 ulp of
# the largest params.
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5
N_TRAIN, N_TEST, BATCH = 256, 64, 32
RANKS_TIMEOUT_S = 240
ACCUMS = (2, 4)


def _cfg(**kw):
    base = dict(epochs=1, batch_size=BATCH, lr=0.1, device="cpu",
                log_every=0, eval_every=0)
    return Config(**{**base, **kw})


def _jax_run(w: int = 1, **kw) -> dict:
    cfg = JaxConfig(epochs=1, batch_size=BATCH, lr=0.1, num_devices=w,
                    scan=False, log_every=0, eval_every=0, **kw)
    tr = JaxTrainer(JAX_PRESETS["reference_cnn"](),
                    jax_stripes(N_TRAIN, N_TEST), cfg,
                    metrics=JaxMetrics(echo=False))
    init = jax.device_get(tr.state["params"])
    em = tr.run_epoch(0)
    return {"init": init,
            "params": jax.tree.leaves(jax.device_get(tr.state["params"])),
            "eval": tr.evaluate(), "loss": em["loss"], "acc": em["acc"]}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's 8 steps at each (grad_accum, world), and with
    remat."""
    runs = {(a, w): _jax_run(w, grad_accum=a) for a in ACCUMS
            for w in (1, 2)}
    runs["remat"] = _jax_run(remat=True)
    return runs


def _assert_matches(params, em, ev, want):
    assert len(params) == len(want["params"])
    for g, j in zip(params, want["params"], strict=True):
        assert g.shape == j.shape
        np.testing.assert_allclose(g, j, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(em["loss"], want["loss"], rtol=LOSS_RTOL)
    assert em["acc"] == want["acc"]
    assert ev == want["eval"]


def _port_run(init, **kw):
    tr = Trainer(get_model("reference_cnn"),
                 synthetic_stripes(N_TRAIN, N_TEST), _cfg(**kw),
                 metrics=MetricsLogger(echo=False),
                 params=None if init is None else params_from_jax(init))
    em = tr.run_epoch(0)
    return [t.detach().numpy() for t in tree_leaves(tr.params)], em, \
        tr.evaluate(), tr


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["torch", "cuda"])
@pytest.mark.parametrize("a", ACCUMS)
def test_grad_accum_matches_the_jax_trainer(jax_runs, a, use_kernels, scan):
    want = jax_runs[(a, 1)]
    params, em, ev, tr = _port_run(want["init"], grad_accum=a,
                                   use_kernels=use_kernels, scan=scan)
    assert tr.step == N_TRAIN // BATCH
    _assert_matches(params, em, ev, want)


@pytest.mark.parametrize("a,route", [(2, "device"), (4, "device"),
                                     (4, "per_batch")])
def test_grad_accum_at_world_2_matches_the_jax_dp_trainer(jax_runs, a,
                                                          route):
    want = jax_runs[(a, 2)]
    ranks = run_ranks(cnn_rank, 2, args=(
        _cfg(grad_accum=a, scan=route == "device"),
        dict(num_train=N_TRAIN, num_test=N_TEST),
        params_from_jax(want["init"])), timeout=RANKS_TIMEOUT_S)
    for res in ranks:
        _assert_matches(res["params"], res["epoch"], res["eval"], want)
        # still ONE all-reduce a step, whatever a is, and one of the
        # preemption flags at each chunk boundary (the device route's
        # epoch is one chunk, the per-batch route ends one a step)
        steps = N_TRAIN // BATCH
        assert res["epoch_counts"]["collectives"]["all_reduce"] == \
            steps + (1 if route == "device" else steps)


@pytest.mark.parametrize("a", [2, 4, 8])
def test_micro_batches_take_interleaved_rows(a):
    """Micro-batch i takes rows i, a+i, 2a+i, ... (the reference's
    reshape + swapaxes), in order, each through its own grad."""
    seen = []
    w = torch.ones(3, requires_grad=True)

    def loss_fn(params, x, y):
        seen.append(x[:, 0].tolist())
        return (params[0] * x).sum() / len(x), {"n": float(len(x))}

    x = torch.arange(16.0)[:, None].expand(16, 3).contiguous()
    grads, metrics = local_grads(loss_fn, [w], x, x, a)
    assert seen == [list(range(i, 16, a)) for i in range(a)]
    np.testing.assert_allclose(grads[0].numpy(), [7.5] * 3)
    assert metrics.tolist() == [3 * 7.5, 16 / a]


def test_grad_accum_one_is_the_plain_step_bitwise():
    p1, em1, _, _ = _port_run(None, grad_accum=1)
    p0, em0, _, _ = _port_run(None)
    for a, b in zip(p1, p0, strict=True):
        np.testing.assert_array_equal(a, b)
    assert em1["loss"] == em0["loss"]


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["torch", "cuda"])
def test_remat_is_the_plain_port_bitwise_and_matches_jax(jax_runs,
                                                         use_kernels, scan):
    init = jax_runs["remat"]["init"]
    p1, em1, ev1, tr = _port_run(init, remat=True, use_kernels=use_kernels,
                                 scan=scan)
    p0, em0, ev0, _ = _port_run(init, use_kernels=use_kernels, scan=scan)
    for a, b in zip(p1, p0, strict=True):
        np.testing.assert_array_equal(a, b)
    assert (em1["loss"], ev1) == (em0["loss"], ev0)
    _assert_matches(p1, em1, ev1, jax_runs["remat"])


def test_remat_recomputes_each_layer_once(monkeypatch):
    """The backward of a remat step runs each layer's forward again (the
    launch count of a kernel step follows: K3 12, K4 5, K5 2 against
    9/3/2 without remat)."""
    from mpi_cuda_cnn_tpu_torch.models import layers

    calls = []
    for cls in (layers.Conv, layers.Dense):
        orig = cls.apply

        def spy(self, p, x, backend="torch", _orig=orig):
            calls.append(type(self).__name__)
            return _orig(self, p, x, backend=backend)

        monkeypatch.setattr(cls, "apply", spy)
    for remat, want in ((False, 5), (True, 10)):
        calls.clear()
        Trainer(get_model("reference_cnn"), synthetic_stripes(64, 8),
                _cfg(remat=remat), metrics=MetricsLogger(echo=False)
                ).first_grads()
        assert len(calls) == want
        assert calls.count("Conv") == want * 2 // 5


@pytest.mark.parametrize("argv", [["--grad-accum", "5"],
                                  ["--grad-accum", "3"],
                                  ["--grad-accum", "2", "--elastic-width", "8"]])
def test_bad_grad_accum_exits_2(argv):
    assert main(["train", "--device", "cpu", "--epochs", "1", *argv]) == 2
    with pytest.raises(ValueError, match="grad_accum|grad-accum"):
        Trainer(get_model("reference_cnn"), synthetic_stripes(64, 8),
                _cfg(**{"grad_accum": int(argv[1]),
                        "elastic_width": 8 if len(argv) > 2 else 0}))


def test_grad_accum_checks_the_per_rank_batch():
    """At world 2 the rank's 16 rows must divide: a = 32 passes the
    global batch but not the rank's."""
    assert main(["train", "--device", "cpu", "--epochs", "1",
                 "--num-devices", "2", "--grad-accum", "32"]) == 2


LM_BASE = dict(corpus="synthetic", dim=32, depth=1, heads=2, seq_len=64,
               batch_size=4, steps=4, warmup_steps=20, lr=3e-3,
               attn_impl="oracle", log_every=1)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_grad_accum_matches_the_jax_trainer(remat):
    jm = JaxMetrics(echo=False, capture=True)
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=1, grad_accum=2, remat=remat,
                                   **LM_BASE), metrics=jm)
    init = jax.device_get(jtr.state["params"])
    jres = jtr.train()
    metrics = MetricsLogger(echo=False, capture=True)
    ttr = LMTrainer(LMConfig(device="cpu", grad_accum=2, remat=remat,
                             **LM_BASE), metrics=metrics,
                    params=params_from_jax(init))
    tres = ttr.train()
    want = [r["loss"] for r in jm.rows if r["event"] == "train"]
    got = [r["loss"] for r in metrics.rows if r["event"] == "train"]
    assert len(got) == len(want) == LM_BASE["steps"]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.eval_loss, jres.eval_loss, rtol=LOSS_RTOL)


def test_lm_grad_accum_of_one_micro_row_per_rank_is_refused():
    assert main(["lm", "--device", "cpu", "--corpus", "synthetic", "--dim",
                 "32", "--depth", "1", "--heads", "2", "--seq-len", "64",
                 "--batch-size", "4", "--steps", "1", "--grad-accum",
                 "3"]) == 2
