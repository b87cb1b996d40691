"""The port's CNN training slice (`mpi_cuda_cnn_tpu_torch/train`,
`/models`, the `train` and `train-bench` commands) against the JAX
package on the CPU.

Parity: the JAX `Trainer`'s initial params reach the port through
`convert.params_from_jax`; 8 SGD steps of reference_cnn on
synthetic_stripes(256, 64) at batch 32 then run on both of the port's
backends ("torch" and the "cuda" kernels' plain versions) and both of
its epoch paths (device-resident and per batch), against the JAX
trainer with `use_pallas` False and True. Params agree within
PARAM_ATOL and the eval counts are equal. The JAX trainers run their
per-batch loop: at this seed the JAX package's scanned XLA epoch alone
ends 5e-4 away from its own per-batch loop and Pallas path (a
pre-activation a few ulp from zero that only it sends across the ReLU),
while those two and the port agree within 1e-7.
"""

import logging
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.initializers import get_initializer as jax_init
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.train.optimizer import make_optimizer as jax_make_opt
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.models import initializers
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import MODEL_PRESETS, get_model
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.train.bench import train_bench, train_bench_main
from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, check_supported, parse_args
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# 8 float32 SGD steps from equal params, sums in other orders: about 30
# ulp of the largest params (|w| <= 0.5); 8e-8 was measured.
PARAM_ATOL = 1e-6
# Optimizer updates of equal gradients: the same roundings, except
# where a square root or a cosine is taken by another library.
OPT_ATOL = 1e-7
# One forward of a preset from equal params: float32 sums in other
# orders, relative to the logits' magnitude.
FWD_TOL = 1e-5
N_TRAIN, N_TEST, BATCH = 256, 64, 32
PARAM_COUNTS = {"reference_cnn": 360_810}


def _cfg(**kw):
    base = dict(epochs=1, batch_size=BATCH, lr=0.1, device="cpu",
                log_every=0, eval_every=0)
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_runs():
    """8 steps of the JAX trainer on each backend from one init: its
    initial params, final params and eval counts."""
    ds = jax_stripes(N_TRAIN, N_TEST)
    out = {}
    for use_pallas in (False, True):
        cfg = JaxConfig(epochs=1, batch_size=BATCH, lr=0.1, num_devices=1,
                        use_pallas=use_pallas, scan=False, log_every=0,
                        eval_every=0)
        tr = JaxTrainer(JAX_PRESETS["reference_cnn"](), ds, cfg,
                        metrics=JaxMetrics(echo=False))
        init = jax.device_get(tr.state["params"])
        em = tr.run_epoch(0)
        out[use_pallas] = {
            "init": init, "params": jax.tree.leaves(
                jax.device_get(tr.state["params"])),
            "eval": tr.evaluate(), "loss": em["loss"], "acc": em["acc"]}
    return out


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["torch", "cuda"])
def test_eight_steps_match_the_jax_trainer(jax_runs, use_kernels, scan):
    ds = synthetic_stripes(N_TRAIN, N_TEST)
    before = dict(_kernels.launches)
    tr = Trainer(get_model("reference_cnn"), ds,
                 _cfg(use_kernels=use_kernels, scan=scan),
                 metrics=MetricsLogger(echo=False),
                 params=params_from_jax(jax_runs[False]["init"]))
    assert tr.backend == ("cuda" if use_kernels else "torch")
    em = tr.run_epoch(0)
    assert em["steps"] == N_TRAIN // BATCH and tr.step == 8
    got = [t.detach().numpy() for t in tree_leaves(tr.params)]
    for use_pallas in (False, True):
        want = jax_runs[use_pallas]
        assert len(got) == len(want["params"])
        for g, w in zip(got, want["params"]):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL)
        assert tr.evaluate() == want["eval"]
        np.testing.assert_allclose(em["loss"], want["loss"], rtol=1e-5)
        assert em["acc"] == want["acc"]
    assert _kernels.launches == before   # CPU tensors: plain versions


def test_params_from_jax_keeps_the_cnn_tree(jax_runs):
    """The list-of-dicts CNN tree maps leaf for leaf, NHWC/HWIO kept (the
    nested Residual trees go through the preset test below)."""
    jp = jax_runs[False]["init"]
    tp = params_from_jax(jp)
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = tree_leaves(tp)
    assert len(got) == len(want)
    for (path, w), g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), str(path))


# ---------------------------------------------------------------------------
# Optimizer against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(),
    dict(momentum=0.9),
    dict(schedule="cosine", total_steps=5),
    dict(momentum=0.5, schedule="cosine", total_steps=3, grad_clip=0.5),
    dict(grad_clip=100.0),
], ids=["sgd", "momentum", "cosine", "all", "clip_inactive"])
def test_optimizer_matches_optax(kw):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    tx = jax_make_opt(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = make_optimizer(0.1, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for gs in grads:
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(g) for g in gs], tstate)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=OPT_ATOL)
    assert tstate["count"] == len(grads)


def test_optimizer_refuses_the_lm_options():
    """AdamW is the LM trainer's (tests/test_torch_lm.py holds it to
    optax); like the reference's, it refuses SGD's momentum knob."""
    with pytest.raises(ValueError, match="momentum"):
        make_optimizer(0.1, opt="adamw", momentum=0.9)
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(0.1, opt="lamb")
    with pytest.raises(ValueError):
        make_optimizer(0.1, schedule="cosine")


# ---------------------------------------------------------------------------
# Presets and initializers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_preset_counts_and_forward_match_jax(name):
    assert set(MODEL_PRESETS) == set(JAX_PRESETS)
    jm, tm = JAX_PRESETS[name](), get_model(name)
    jp = jm.init(jax.random.key(0), jax_init("he"))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    assert tm.num_params(tp) == jm.num_params(jp)
    if name in PARAM_COUNTS:
        assert tm.num_params(tp) == PARAM_COUNTS[name]
    # The port's own init builds the same tree shapes.
    own = tm.init(prng.key(0),
                  initializers.get_initializer("he"))
    assert [t.shape for t in tree_leaves(own)] == \
        [tuple(a.shape) for a in jax.tree.leaves(jp)]
    x = np.random.default_rng(1).random((2, *jm.input_shape), np.float32)
    want = np.asarray(jm.apply(jp, jnp.asarray(x)))
    before = dict(_kernels.launches)
    for backend in ("torch", "cuda"):
        got = tm.apply(tp, torch.from_numpy(x), backend=backend).numpy()
        assert got.shape == want.shape
        err = np.abs(got - want).max()
        assert err <= FWD_TOL * np.abs(want).max(), (backend, err)
    assert _kernels.launches == before


@pytest.mark.parametrize("name", ["normal", "irwin_hall", "he"])
def test_initializers_draw_the_reference_distributions(name):
    """Seeded, and with the reference's mean and spread (the draws
    themselves are held to jax.random's in tests/test_torch_init.py)."""
    init = initializers.get_initializer(name)
    a = init(prng.key(0), (64, 256))
    b = init(prng.key(0), (64, 256))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    want = np.asarray(jax_init(name)(jax.random.key(0), (64, 256)))
    assert abs(a.mean().item() - want.mean()) < 0.01
    np.testing.assert_allclose(a.std().item(), want.std(), rtol=0.05)
    with pytest.raises(KeyError):
        initializers.get_initializer("nope")


# ---------------------------------------------------------------------------
# CLI and bench
# ---------------------------------------------------------------------------


@pytest.fixture
def log_lines():
    """Records of the port's logger (it does not propagate to root)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("mpi_cuda_cnn_tpu_torch")
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def test_cli_train_exit_codes_and_ntests_line(tmp_path, log_lines):
    paths = [str(p) for p in write_synthetic_idx(
        tmp_path, synthetic_stripes(num_train=64, num_test=20)).values()]
    base = ["train", "--device", "cpu", "--epochs", "1", "--log-every", "0"]
    assert main(base + paths) == 0
    assert any(re.fullmatch(r"ntests=20, ncorrect=\d+", m) for m in log_lines)
    assert main(base + ["--use-kernels", "--no-scan"] + paths) == 0
    assert main(base + paths[:3]) == 100
    assert main(base + paths[:3] + [str(tmp_path / "missing")]) == 111
    assert main(base + ["--model", "nope"] + paths) == 2
    # --fsdp on one device runs, as the reference's; FSDP x PP needs a
    # data axis (the reference's ValueError, exit 2)
    assert main(base + ["--fsdp"] + paths) == 0
    assert main(base + ["--fsdp", "--mesh-shape", "pipe:2"] + paths) == 2
    assert main(base + ["--no-such-flag"]) == 2
    assert main(["--help-me"]) == 2


def test_train_bench_on_the_cpu(capsys):
    rc = train_bench_main(["--device", "cpu", "--num-train", "128",
                           "--num-test", "16", "--epochs", "2",
                           "--use-kernels"])
    assert rc == 0
    import json

    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == "mnist_epoch_wallclock" and line["unit"] == "s"
    for key in ("value", "best_s", "vs_baseline"):
        assert line[key] > 0
    assert line["device_epoch_s"] is None and line["device"] == "cpu"
    assert line["backend"] == "cuda" and line["steps_per_epoch"] == 4
    assert line["ntests"] == 16 and len(line["epoch_s"]) == 2
    assert set(line["kernel_launches"].values()) == {0}


# ---------------------------------------------------------------------------
# What the slice refuses, and no silent CPU
# ---------------------------------------------------------------------------


# What this slice refused before the sharded meshes were ported (ROADMAP
# queue E item 1): (field, value).
FORMERLY_REFUSED = (("fsdp", True),)


@pytest.mark.parametrize("name,on", FORMERLY_REFUSED,
                         ids=[r[0] for r in FORMERLY_REFUSED])
def test_refused_features_raise(name, on):
    """--fsdp, once refused, builds as the JAX trainer's does: on one
    device (where there is nothing to shard) a Trainer, on a data axis
    of 2 the checks pass and a Trainer given no mesh asks for the
    rank's (the sharded runs are tests/test_torch_fsdp.py)."""
    ds = synthetic_stripes(64, 8)
    JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
               JaxConfig(batch_size=BATCH, num_devices=1, **{name: on}),
               metrics=JaxMetrics(echo=False))
    Trainer(get_model("reference_cnn"), ds, _cfg(**{name: on}))
    assert check_supported(_cfg(num_devices=2, **{name: on})) == {"data": 2}
    with pytest.raises(ValueError, match="a Trainer is one rank"):
        Trainer(get_model("reference_cnn"), ds,
                _cfg(num_devices=2, **{name: on}))


@pytest.mark.parametrize("kw", [dict(mesh_shape="pipe:2"),
                                dict(mesh_shape="data:4,seq:2"),
                                dict(mesh_shape="data:2,model:2")])
def test_multi_device_is_refused(kw):
    """The meshes the JAX trainer builds (a pipe axis, a seq axis of
    replicas of the data-parallel step, a model axis) pass the port's
    checks with the reference's axes; a Trainer is one rank, so one given
    no mesh refuses them (the ranks' runs are tests/test_torch_pp.py,
    test_torch_dp.py and test_torch_tp.py)."""
    axes = check_supported(_cfg(**kw))
    assert axes == {k: int(v) for k, v in (
        part.split(":") for part in kw["mesh_shape"].split(","))}
    JaxTrainer(JAX_PRESETS["reference_cnn"](), jax_stripes(64, 8),
               JaxConfig(batch_size=BATCH, num_devices=math.prod(
                   axes.values()), **kw), metrics=JaxMetrics(echo=False))
    with pytest.raises(ValueError, match="a Trainer is one rank"):
        Trainer(get_model("reference_cnn"), synthetic_stripes(64, 8),
                _cfg(**kw))


def test_parse_args_keeps_the_reference_contract():
    cfg = parse_args(["a", "b", "c", "d", "--use-kernels", "--lr", "0.05"])
    assert cfg.dataset == "idx" and cfg.test_labels == "d"
    assert cfg.use_kernels and cfg.lr == 0.05 and cfg.batch_size == 32
    assert not parse_args([]).use_kernels
    with pytest.raises(SystemExit) as e:
        parse_args(["a", "b"])
    assert e.value.code == 100


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_train_entry_points_refuse_to_fall_back_to_cpu(no_gpu, capsys,
                                                       log_lines):
    ds = synthetic_stripes(64, 8)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        Trainer(get_model("reference_cnn"), ds, Config())
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        train_bench(["--num-train", "64", "--epochs", "1"])
    assert train_bench_main(["--num-train", "64", "--epochs", "1"]) != 0
    assert main(["train", "--epochs", "1"]) == 2
    captured = capsys.readouterr()
    assert captured.out == ""            # no result line
    assert "CUDA device requested" in captured.err
    assert any("CUDA device requested" in m for m in log_lines)


# The CNN slice's modules and chip_smoke.py, imported in a fresh
# interpreter with jax blocked (this process has imported jax already).
_PROBE = """
import importlib, sys
sys.modules["jax"] = None
for name in sys.argv[1:]:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m == "mpi_cuda_cnn_tpu" or m.startswith("mpi_cuda_cnn_tpu."))
assert not leaked, leaked
"""


def test_the_slice_imports_without_jax():
    import subprocess
    import sys
    from pathlib import Path

    mods = ["mpi_cuda_cnn_tpu_torch.train.trainer",
            "mpi_cuda_cnn_tpu_torch.train.bench",
            "mpi_cuda_cnn_tpu_torch.ops.kernel_ops",
            "mpi_cuda_cnn_tpu_torch.models.presets",
            "mpi_cuda_cnn_tpu_torch.data.datasets",
            "mpi_cuda_cnn_tpu_torch.utils.config",
            "mpi_cuda_cnn_tpu_torch.cli", "chip_smoke"]
    out = subprocess.run([sys.executable, "-c", _PROBE, *mods],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
