"""Augmentation (`data/augment.py`, `--augment`, `--aug-pad`) and its
numpy threefry copy (`data/prng.py`) against the JAX package on the CPU
(the twin of tests/test_augment.py).

Every comparison here is exact: the PRNG words are integers, and a
zero-filled shift and a flip move values without arithmetic. The
trainer runs are held as tests/test_torch_train.py holds the plain
ones: from the JAX trainer's init, 8 SGD steps of reference_cnn at batch
32 with --augment shift, params within PARAM_ATOL of the JAX trainer's
per-batch loop, at world 1 and on 2 gloo ranks (whose keys fold in the
rank). The shift-flip run at pad 3 is held for 4 steps: at its 6th step
one pre-activation within a few ulp of zero crosses the ReLU on the
torch backend's side only (the params then part by 6e-5, measured), the
same chaos tests/test_torch_train.py describes for the JAX package's
own two epoch paths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.augment import make_augment as jax_make_augment
from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import MODEL_PRESETS as JAX_PRESETS
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.data.augment import make_augment, step_keys
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.data.pipeline import normalize_images
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank
from mpi_cuda_cnn_tpu_torch.train.trainer import AUG_SEED_OFFSET, Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

PARAM_ATOL = 1e-6      # tests/test_torch_train.py's 8-step bound
LOSS_RTOL = 1e-5
N_TRAIN, N_TEST, BATCH = 256, 64, 32
RANKS_TIMEOUT_S = 240
SEEDS = [0, 1, 7, 0x5EED, 0x5EED + 3, 12345, 2**31 - 1, 2**32 - 1]
# fold-in data: small steps, an epoch of MNIST at batch 32 times many
# epochs, and values past int32 (taken mod 2^32, as JAX's uint32 cast).
FOLDS = [0, 1, 2, 31, 1875, 1875 * 37, 123_456_789, 2**31 - 1, 2**31,
         2**32 - 1, 2**33 + 5, -1]


def _kd(k) -> np.ndarray:
    return np.asarray(jax.random.key_data(k))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_fold_ins_are_jax_bitwise(seed):
    k, nk = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(_kd(k), nk)
    for d in FOLDS:
        jd = np.uint32(d % 2**32)
        np.testing.assert_array_equal(_kd(jax.random.fold_in(k, jd)),
                                      prng.fold_in(nk, d))
    want = np.stack([_kd(jax.random.fold_in(k, np.uint32(d % 2**32)))
                     for d in FOLDS])
    np.testing.assert_array_equal(prng.fold_in(nk, np.asarray(FOLDS)), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_split_bits_randint_bernoulli_are_jax_bitwise(seed):
    """128 keys a seed (split), their 32-bit words, randint at several
    spans (2^16 and past it, where the multiplier wraps) and bernoulli."""
    k, nk = jax.random.key(seed), prng.key(seed)
    ks, nks = jax.random.split(k, 128), prng.split(nk, 128)
    np.testing.assert_array_equal(_kd(ks), nks)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(k, (9,), jnp.uint32)),
        prng.random_bits32(nk, 9))
    for lo, hi in ((0, 1), (0, 5), (0, 7), (-3, 9), (0, 65536),
                   (0, 2**20 + 3)):
        want = np.asarray(jax.vmap(
            lambda kk: jax.random.randint(kk, (2,), lo, hi))(ks))
        np.testing.assert_array_equal(prng.randint(nks, 2, lo, hi), want)
    np.testing.assert_array_equal(
        prng.bernoulli_half(nks), np.asarray(jax.vmap(jax.random.bernoulli)(ks)))


def test_step_keys_are_the_trainers_fold_ins():
    steps, shards = [0, 5, 1874, 99_999], [0, 1, 3]
    got = step_keys(0x5EED, steps, shards)
    assert got.shape == (4, 3, 2)
    for i, s in enumerate(steps):
        for j, r in enumerate(shards):
            want = jax.random.fold_in(jax.random.fold_in(
                jax.random.key(0x5EED), s), r)
            np.testing.assert_array_equal(got[i, j], _kd(want))


@pytest.mark.parametrize("pad", [0, 1, 2, 3])
@pytest.mark.parametrize("spec", ["shift", "shift-flip"])
def test_augment_is_jax_bitwise(spec, pad):
    x = np.random.default_rng(pad).random((16, 28, 28, 1), np.float32)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(3), 41), 1)
    want = np.asarray(jax_make_augment(spec, pad=pad)(key, x))
    got = make_augment(spec, pad=pad)(step_keys(3, [41], [1])[0, 0],
                                      torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)


def test_draws_cover_every_offset_and_flip():
    aug = make_augment("shift-flip", pad=2)
    offsets, flips = aug.draw(step_keys(0, np.arange(64), [0])[:, 0], 32)
    assert offsets.shape == (64, 32, 2) and flips.shape == (64, 32)
    assert set(np.unique(offsets)) == set(range(5))
    assert 0.4 < flips.mean() < 0.6


def test_specs():
    assert make_augment("none") is None
    with pytest.raises(ValueError, match="unknown augment spec"):
        make_augment("rotate")
    with pytest.raises(ValueError, match="aug-pad"):
        make_augment("shift", pad=-1)


def _cfg(**kw):
    base = dict(epochs=1, batch_size=BATCH, lr=0.1, device="cpu",
                log_every=0, eval_every=0)
    return Config(**{**base, **kw})


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX trainer's 8 steps with --augment shift at worlds 1 and 2,
    and with shift-flip at pad 3."""
    out = {}
    for key, kw in {1: dict(augment="shift"), 2: dict(augment="shift"),
                    "flip": dict(augment="shift-flip", aug_pad=3)}.items():
        w = key if isinstance(key, int) else 1
        tr = JaxTrainer(JAX_PRESETS["reference_cnn"](),
                        jax_stripes(_n_train(key), N_TEST),
                        JaxConfig(epochs=1, batch_size=BATCH, lr=0.1,
                                  num_devices=w, scan=False, log_every=0,
                                  eval_every=0, **kw),
                        metrics=JaxMetrics(echo=False))
        init = jax.device_get(tr.state["params"])
        em = tr.run_epoch(0)
        out[key] = {"init": init, "loss": em["loss"], "acc": em["acc"],
                    "params": jax.tree.leaves(jax.device_get(
                        tr.state["params"])), "eval": tr.evaluate()}
    return out


def _n_train(run) -> int:
    return N_TRAIN // 2 if run == "flip" else N_TRAIN


def _assert_matches(params, em, ev, want):
    for g, j in zip(params, want["params"], strict=True):
        np.testing.assert_allclose(g, j, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(em["loss"], want["loss"], rtol=LOSS_RTOL)
    assert em["acc"] == want["acc"] and ev == want["eval"]


@pytest.mark.parametrize("scan", [True, False], ids=["device", "per_batch"])
@pytest.mark.parametrize("use_kernels", [False, True], ids=["torch", "cuda"])
@pytest.mark.parametrize("run", [1, "flip"])
def test_augmented_trainer_matches_jax(jax_runs, run, use_kernels, scan):
    kw = (dict(augment="shift") if run == 1
          else dict(augment="shift-flip", aug_pad=3))
    want = jax_runs[run]
    tr = Trainer(get_model("reference_cnn"),
                 synthetic_stripes(_n_train(run), N_TEST),
                 _cfg(use_kernels=use_kernels, scan=scan, **kw),
                 metrics=MetricsLogger(echo=False),
                 params=params_from_jax(want["init"]))
    em = tr.run_epoch(0)
    _assert_matches([t.detach().numpy() for t in tree_leaves(tr.params)],
                    em, tr.evaluate(), want)


@pytest.mark.parametrize("route", ["device", "per_batch"])
def test_augmented_world_2_matches_the_jax_dp_trainer(jax_runs, route):
    want = jax_runs[2]
    ranks = run_ranks(cnn_rank, 2, args=(
        _cfg(augment="shift", scan=route == "device"),
        dict(num_train=N_TRAIN, num_test=N_TEST),
        params_from_jax(want["init"])), timeout=RANKS_TIMEOUT_S)
    for res in ranks:
        _assert_matches(res["params"], res["epoch"], res["eval"], want)


def test_step_batches_are_the_host_draws_applied_on_the_host():
    """The first 3 steps' augmented batches, as the step builds them (the
    chunk's draws, applied on the device), equal the numpy copy's draws
    applied to the host batch by numpy indexing."""
    ds = synthetic_stripes(N_TRAIN, N_TEST)
    tr = Trainer(get_model("reference_cnn"), ds, _cfg(augment="shift"),
                 metrics=MetricsLogger(echo=False))
    order = tr._epoch_order(0)
    offsets, _ = tr._step.draws(np.arange(3), BATCH)
    for s in range(3):
        rows = order[s * BATCH:(s + 1) * BATCH]
        x = normalize_images(ds.train_images[rows])
        keys = step_keys(AUG_SEED_OFFSET, [s], [0])[0, 0]
        offs, _ = make_augment("shift").draw(keys, BATCH)
        np.testing.assert_array_equal(offsets[s].numpy(), offs)
        pad = np.pad(x, ((0, 0), (2, 2), (2, 2), (0, 0)))
        want = np.stack([pad[i, oy:oy + 28, ox:ox + 28]
                         for i, (oy, ox) in enumerate(offs)])
        got = make_augment("shift").apply(
            torch.from_numpy(x), offsets[s], torch.zeros(BATCH, dtype=bool))
        np.testing.assert_array_equal(got.numpy(), want)


def test_cli_augment_runs_and_refuses_a_bad_spec(tmp_path):
    """On the reference's four IDX paths of a 128-image set."""
    paths = write_synthetic_idx(tmp_path, synthetic_stripes(128, 64))
    assert main(["train", *map(str, paths.values()), "--device", "cpu",
                 "--epochs", "1", "--augment", "shift", "--aug-pad",
                 "1"]) == 0
    assert main(["train", "--device", "cpu", "--epochs", "1", "--augment",
                 "rotate"]) == 2
    assert main(["train", "--device", "cpu", "--epochs", "1", "--augment",
                 "shift", "--aug-pad", "-1"]) == 2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_relu_gradient_at_a_tie_is_the_references(dtype):
    """A zero-filled shift meets a zero bias at init: pre-activations of
    exactly 0, where the reference's relu (`jnp.maximum(x, 0)`) passes half
    the gradient. The port's relu does the same, in either dtype."""
    from mpi_cuda_cnn_tpu.ops.activations import relu as jax_relu
    from mpi_cuda_cnn_tpu_torch.ops.activations import relu

    vals = [-1.5, -0.0, 0.0, 1e-30, 2.0]
    want = np.asarray(jax.grad(lambda x: jax_relu(x).sum())(
        jnp.asarray(vals, dtype)), np.float32)
    x = torch.tensor(vals, dtype=getattr(torch, dtype), requires_grad=True)
    relu(x).sum().backward()
    np.testing.assert_array_equal(x.grad.float().numpy(), want)
    np.testing.assert_array_equal(want, [0, 0.5, 0.5, 1, 1])
