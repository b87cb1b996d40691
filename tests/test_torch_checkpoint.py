"""The port's checkpoints (`mpi_cuda_cnn_tpu_torch/train/checkpoint.py`
and the state's names, `convert.checkpoint_arrays`) against the JAX
package's `train/checkpoint.py` on the CPU.

Ported from tests/test_checkpoint.py and the checkpoint half of
tests/test_faults.py, run on the port: the round trip, the pruning, the
manifest's checksums and atomic writes, corrupt and torn files found
and skipped, a crash between the tmp write and the rename, the
asynchronous writer's snapshot and its deferred errors. Across the
packages the files are the same: the port's names equal the JAX
package's `_flatten` names for every optimizer either trainer builds; a
checkpoint the JAX trainer writes mid-run resumes in the port, and one
the port writes resumes in the JAX trainer (its own `restore_latest`
and state template), for the CNN (SGD) and the LM (AdamW, warm-up +
cosine). Within a package a resume is bitwise; across packages the
params are held within PARAM_ATOL and the losses within LOSS_RTOL, as in
tests/test_torch_dp.py.
"""

import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.data.datasets import synthetic_stripes as jax_stripes
from mpi_cuda_cnn_tpu.models.presets import get_model as jax_get_model
from mpi_cuda_cnn_tpu.train import checkpoint as jax_ckpt
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.train.optimizer import make_optimizer as jax_make_opt
from mpi_cuda_cnn_tpu.train.trainer import Trainer as JaxTrainer
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.convert import (
    checkpoint_arrays,
    load_checkpoint_arrays,
    params_from_jax,
)
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
from mpi_cuda_cnn_tpu_torch.faults import FaultInjector, InjectedCrash
from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.presets import get_model
from mpi_cuda_cnn_tpu_torch.train.checkpoint import (
    AsyncCheckpointer,
    CheckpointCorruptError,
    checkpoint_meta,
    latest_checkpoint,
    restore_checkpoint,
    restore_latest,
    save_checkpoint,
)
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# Across packages (tests/test_torch_dp.py): float32 steps from equal
# params, sums in other orders.
PARAM_ATOL = 1e-6
LOSS_RTOL = 1e-5


def _state(seed=0, momentum=0.9):
    """A reference_cnn train state of the port, as checkpoint arrays."""
    model = get_model("reference_cnn")
    params = model.init(prng.key(seed),
                        get_initializer("normal"))
    opt = make_optimizer(0.1, momentum=momentum)
    state = {"params": params, "opt_state": opt.init(tree_leaves(params)),
             "step": 7}
    if momentum:
        for t in state["opt_state"]["trace"]:
            t.normal_(generator=torch.Generator().manual_seed(seed + 1))
    return checkpoint_arrays(state, opt)


def _np(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().numpy()
    return np.asarray(leaf)


def _assert_arrays_equal(want: dict, got: dict):
    assert set(want) == set(got)
    for k in want:
        np.testing.assert_array_equal(_np(want[k]), _np(got[k]))


# ---------------------------------------------------------------- round trip


def test_roundtrip(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, state, 7)
    restored = restore_checkpoint(latest_checkpoint(tmp_path), _state(seed=1))
    _assert_arrays_equal(state, restored)
    assert restored["step"].dtype == np.int32


def test_latest_picks_numeric_max(tmp_path):
    state = _state()
    for step in (2, 10, 9):
        save_checkpoint(tmp_path, state, step)
    assert latest_checkpoint(tmp_path).name == "ckpt_10.npz"


def test_prune_keeps_k(tmp_path):
    state = _state()
    for step in range(6):
        save_checkpoint(tmp_path, state, step, keep=3)
    names = sorted(p.name for p in tmp_path.glob("ckpt_*.npz"))
    assert names == ["ckpt_3.npz", "ckpt_4.npz", "ckpt_5.npz"]
    # The protected file survives every prune.
    for step in range(6, 9):
        save_checkpoint(tmp_path, state, step, keep=2, protect="ckpt_3.npz")
    names = sorted(p.name for p in tmp_path.glob("ckpt_*.npz"))
    assert names == ["ckpt_3.npz", "ckpt_7.npz", "ckpt_8.npz"]


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, {"a": torch.zeros(3)}, 1)
    with pytest.raises(ValueError, match="mismatch"):
        restore_checkpoint(latest_checkpoint(tmp_path), {"b": torch.zeros(3)})


def test_no_checkpoint_returns_none(tmp_path):
    assert latest_checkpoint(tmp_path / "void") is None
    assert restore_latest(tmp_path / "void", _state()) == (None, None)


@pytest.mark.parametrize("async_", [True, False])
def test_async_checkpointer_matches_sync(tmp_path, async_):
    state = _state()
    ck = AsyncCheckpointer(tmp_path / "a", async_=async_)
    ck.save(state, 3)
    ck.save(state, 6)  # drains the first write before copying
    ck.wait()
    assert latest_checkpoint(tmp_path / "a").name == "ckpt_6.npz"
    restored = restore_checkpoint(latest_checkpoint(tmp_path / "a"),
                                  _state(seed=1))
    _assert_arrays_equal(state, restored)
    ck.close()


def test_async_checkpointer_snapshot_precedes_mutation(tmp_path):
    """save() copies the tensors before it returns: an in-place update
    right after it (the next step's) cannot reach the written file."""
    t = torch.arange(4, dtype=torch.float32)
    ck = AsyncCheckpointer(tmp_path)
    ck.save({"a": t}, 1)
    t.mul_(0).sub_(1)                    # the next step, in place
    ck.wait()
    restored = restore_checkpoint(latest_checkpoint(tmp_path),
                                  {"a": torch.zeros(4)})
    np.testing.assert_array_equal(restored["a"],
                                  np.arange(4, dtype=np.float32))
    ck.close()


def test_async_checkpointer_propagates_errors(tmp_path):
    target = tmp_path / "f"
    ck = AsyncCheckpointer(target)
    ck.save(_state(), 1)
    ck.wait()
    shutil.rmtree(target)
    target.write_text("not a directory")
    ck.save(_state(), 2)
    with pytest.raises(OSError):
        ck.wait()
    ck.close()


# ---------------------------------------------------------------- integrity


def test_manifest_records_checksums_and_is_atomic(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, state, 3, meta={"mesh": {"axes": {"data": 1},
                                                       "devices": 1}})
    mf = json.loads((tmp_path / "manifest.json").read_text())
    assert mf["latest_step"] == 3
    assert set(mf["checksums"]) == {"ckpt_3.npz"}
    assert set(mf["checksums"]["ckpt_3.npz"]) == set(mf["keys"]) == set(state)
    assert checkpoint_meta(tmp_path, "ckpt_3.npz")["mesh"]["devices"] == 1
    assert not list(tmp_path.glob(".manifest*"))
    # The JAX package's checksum of the same arrays is the same string.
    flat = {k: _np(v) for k, v in state.items()}
    assert mf["checksums"]["ckpt_3.npz"] == {
        k: jax_ckpt._checksum(v) for k, v in flat.items()}
    for step in (6, 9, 12):
        save_checkpoint(tmp_path, state, step, keep=2)
    mf = json.loads((tmp_path / "manifest.json").read_text())
    assert set(mf["checksums"]) == {"ckpt_9.npz", "ckpt_12.npz"}


def test_corrupt_checkpoint_detected_and_skipped(tmp_path):
    good = _state(seed=0)
    save_checkpoint(tmp_path, good, 1)
    save_checkpoint(tmp_path, _state(seed=1), 2)
    # A valid npz with other bytes: only the checksums can catch it.
    other = {k: _np(v) + 1 if np.issubdtype(_np(v).dtype, np.floating)
             else _np(v) for k, v in _state(seed=1).items()}
    np.savez(tmp_path / "ckpt_2.npz", **other)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path / "ckpt_2.npz", _state(seed=2))
    metrics = MetricsLogger(echo=False, capture=True)
    restored, path = restore_latest(tmp_path, _state(seed=2), metrics=metrics)
    assert path.name == "ckpt_1.npz"
    _assert_arrays_equal(good, restored)
    assert [r["kind"] for r in metrics.rows] == ["ckpt_fallback"]
    # A torn file (not even a zip) falls back too.
    (tmp_path / "ckpt_2.npz").write_bytes(b"torn write")
    restored, path = restore_latest(tmp_path, _state(seed=2))
    assert path.name == "ckpt_1.npz"


def test_restore_without_manifest_globs_and_skips_verification(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, state, 5)
    (tmp_path / "manifest.json").unlink()
    restored = restore_checkpoint(latest_checkpoint(tmp_path), _state(1))
    _assert_arrays_equal(state, restored)
    (tmp_path / "manifest.json").write_text("{torn json")
    restored, path = restore_latest(tmp_path, _state(1))
    assert path.name == "ckpt_5.npz"
    _assert_arrays_equal(state, restored)


def test_crash_between_tmp_write_and_rename(tmp_path):
    state = _state()
    save_checkpoint(tmp_path, state, 3)
    faults = FaultInjector("crash@ckpt.pre_rename:6")
    with pytest.raises(InjectedCrash):
        save_checkpoint(tmp_path, _state(seed=1), 6, faults=faults)
    assert (tmp_path / ".ckpt_6.tmp.npz").exists()  # the torn write
    assert latest_checkpoint(tmp_path).name == "ckpt_3.npz"
    restored, path = restore_latest(tmp_path, _state(seed=2))
    assert path.name == "ckpt_3.npz"
    _assert_arrays_equal(state, restored)
    mf = json.loads((tmp_path / "manifest.json").read_text())
    assert "ckpt_6.npz" not in mf["checksums"]


def test_async_checkpointer_deferred_crash_reraises(tmp_path):
    faults = FaultInjector("crash@ckpt.pre_rename:2")
    ck = AsyncCheckpointer(tmp_path, faults=faults)
    ck.save(_state(), 1)
    ck.wait()
    ck.save(_state(), 2)  # the worker meets the planned crash
    with pytest.raises(InjectedCrash):
        ck.wait()
    assert latest_checkpoint(tmp_path).name == "ckpt_1.npz"
    ck.close()


def _cnn_cfg(**kw):
    base = dict(dataset="synthetic", model="reference_cnn", epochs=2,
                batch_size=16, eval_every=0, log_every=0, lr=0.05, seed=7,
                scan=False)
    base.update(kw)
    return base


def test_trainer_resume_skips_corrupt_latest(tmp_path):
    ds = synthetic_stripes(num_train=64, num_test=32)
    ck = tmp_path / "ck"
    t = Trainer(get_model("reference_cnn"), ds,
                Config(device="cpu", **_cnn_cfg(
                    epochs=1, checkpoint_dir=str(ck),
                    checkpoint_every_steps=1)),
                metrics=MetricsLogger(echo=False))
    t.train()
    latest_checkpoint(ck).write_bytes(b"torn")
    metrics = MetricsLogger(echo=False, capture=True)
    resumed = Trainer(get_model("reference_cnn"), ds,
                      Config(device="cpu", **_cnn_cfg(
                          epochs=1, checkpoint_dir=str(ck), resume=True)),
                      metrics=metrics)
    res = resumed.train()
    assert res.final_step == 4
    kinds = [r["kind"] for r in metrics.rows if r["event"] == "fault"]
    assert "ckpt_fallback" in kinds
    assert [(r["reason"], r["step"]) for r in metrics.rows
            if r["event"] == "ckpt"] == [("resume", 3)]


# ---------------------------------------------------------------- names


OPTIMIZERS = {
    "sgd": dict(),
    "sgd_momentum": dict(momentum=0.9),
    "sgd_cosine": dict(schedule="cosine", total_steps=10),
    "sgd_momentum_cosine": dict(momentum=0.9, schedule="cosine",
                                total_steps=10),
    "sgd_clip": dict(grad_clip=1.0, momentum=0.9),
    "sgd_weight_decay": dict(weight_decay=0.1, momentum=0.9,
                             schedule="cosine", total_steps=10),
    "sgd_weight_decay_clip": dict(weight_decay=0.1, grad_clip=1.0,
                                  schedule="cosine", total_steps=10),
    "adamw": dict(opt="adamw", weight_decay=0.01),
    "adamw_warmup_cosine": dict(opt="adamw", schedule="cosine",
                                total_steps=10, warmup_steps=2,
                                weight_decay=0.01),
    "adamw_cosine_clip": dict(opt="adamw", schedule="cosine",
                              total_steps=10, grad_clip=1.0),
}


@pytest.mark.parametrize("kw", OPTIMIZERS.values(), ids=OPTIMIZERS)
@pytest.mark.parametrize("model", ["reference_cnn", "transformer"])
def test_names_equal_the_jax_packages(model, kw):
    """The port's checkpoint arrays of a state (`checkpoint_arrays`) are
    named, shaped and typed as the JAX package's `_flatten` of its
    {params, opt_state (optax), step} for the same optimizer arguments;
    the values round-trip through `load_checkpoint_arrays`."""
    if model == "transformer":
        from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
        from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM

        lm = dict(vocab=32, dim=16, heads=2, depth=2, max_seq=16)
        jparams = JaxLM(**lm).init(jax.random.key(0))
        tmodel = TransformerLM(**lm)
    else:
        from mpi_cuda_cnn_tpu.models.initializers import get_initializer as ji

        jparams = jax_get_model(model).init(jax.random.key(0), ji("normal"))
        tmodel = get_model(model)
    jtx = jax_make_opt(0.1, **kw)
    jflat = jax_ckpt._flatten({"params": jparams,
                               "opt_state": jtx.init(jparams),
                               "step": jnp.asarray(3, jnp.int32)})
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    assert len(tree_leaves(params)) == len(tree_leaves(
        tmodel.init(prng.key(0)) if model == "transformer"
        else tmodel.init(prng.key(0), get_initializer("normal"))))
    opt = make_optimizer(0.1, **kw)
    state = {"params": params, "opt_state": opt.init(tree_leaves(params)),
             "step": 3}
    state["opt_state"]["count"] = 2      # one update dropped by the guard
    got = checkpoint_arrays(state, opt)
    assert list(got) == list(jflat)          # names, in the same order
    for k, v in jflat.items():
        assert _np(got[k]).shape == v.shape and _np(got[k]).dtype == v.dtype
    # A round trip through another state of the same optimizer.
    values = {k: _np(v) + 1 for k, v in got.items()}
    other = {"params": params_from_jax(jax.tree.map(np.asarray, jparams)),
             "opt_state": opt.init(tree_leaves(params)), "step": 0}
    load_checkpoint_arrays(other, values, opt)
    assert other["step"] == 4
    # Where the chain keeps no count (SGD at a constant rate, which never
    # reads it) the count is the step.
    counted = any(k.endswith(".count") for k in got)
    assert other["opt_state"]["count"] == (3 if counted else 4)
    _assert_arrays_equal(values, checkpoint_arrays(other, opt))


# ---------------------------------------------------------------- across packages


def _jax_cnn(ck=None, **kw):
    cfg = JaxConfig(num_devices=1, **_cnn_cfg(
        checkpoint_dir=str(ck) if ck else None, **kw))
    return JaxTrainer(jax_get_model("reference_cnn"),
                      jax_stripes(num_train=64, num_test=32), cfg,
                      metrics=JaxMetrics(echo=False))


def _port_cnn(params, ck=None, metrics=None, **kw):
    cfg = Config(device="cpu", **_cnn_cfg(
        checkpoint_dir=str(ck) if ck else None, **kw))
    return Trainer(get_model("reference_cnn"),
                   synthetic_stripes(num_train=64, num_test=32), cfg,
                   metrics=metrics or MetricsLogger(echo=False),
                   params=params)


def _keep_only(ck, name):
    for p in ck.glob("ckpt_*.npz"):
        if p.name != name:
            p.unlink()


@pytest.fixture(scope="module")
def jax_cnn_full():
    """The JAX trainer's initial params and its uninterrupted 8 steps."""
    full = _jax_cnn()
    init = params_from_jax(jax.device_get(full.state["params"]))
    full.train()
    return init, jax.tree.leaves(jax.device_get(full.state["params"]))


def test_a_jax_cnn_checkpoint_resumes_in_the_port(tmp_path, jax_cnn_full):
    """The JAX trainer writes every 3 steps; the port resumes from its
    step-6 file (mid-epoch 1): the restored state is the file's bit for
    bit, and the run ends within PARAM_ATOL of JAX's uninterrupted run."""
    init, want = jax_cnn_full
    ck = tmp_path / "ck"
    _jax_cnn(ck, checkpoint_every_steps=3).train()
    _keep_only(ck, "ckpt_6.npz")
    metrics = MetricsLogger(echo=False, capture=True)
    t = _port_cnn(init, ck, metrics, resume=True)
    path = t.recovery.restore(t.state)
    assert path.name == "ckpt_6.npz" and t.step == 6
    with np.load(path) as f:
        for k, v in t.recovery.arrays(t.state).items():
            np.testing.assert_array_equal(_np(v), f[k])
    t = _port_cnn(init, ck, metrics, resume=True)
    res = t.train()
    assert res.final_step == 8
    assert [r["kind"] for r in metrics.rows if r["event"] == "fault"] == []
    for g, w in zip(t.leaves, want, strict=True):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=PARAM_ATOL)


def test_a_port_cnn_checkpoint_resumes_in_jax(tmp_path, jax_cnn_full):
    """The port writes every 3 steps; the JAX package's own
    `restore_latest` loads its step-6 file into the JAX trainer's state
    template (no key mismatch, checksums verified) and the JAX trainer
    goes on to the end within PARAM_ATOL of its uninterrupted run."""
    init, want = jax_cnn_full
    ck = tmp_path / "ck"
    _port_cnn(init, ck, checkpoint_every_steps=3).train()
    _keep_only(ck, "ckpt_6.npz")
    jt = _jax_cnn(ck, resume=True)
    restored, path = jax_ckpt.restore_latest(ck, jax.device_get(jt.state))
    assert path.name == "ckpt_6.npz" and int(restored["step"]) == 6
    res = jt.train()
    assert res.final_step == 8
    for g, w in zip(jax.tree.leaves(jax.device_get(jt.state["params"])), want,
                    strict=True):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=0,
                                   atol=PARAM_ATOL)


_LM = dict(corpus="synthetic", dim=32, depth=1, heads=2, seq_len=64,
           batch_size=4, steps=6, warmup_steps=2, lr=3e-3, lr_schedule="cosine",
           attn_impl="oracle", log_every=1)


@pytest.fixture(scope="module")
def jax_lm_full():
    """The JAX LM trainer's initial params and its uninterrupted run."""
    full = JaxLMTrainer(JaxLMConfig(num_devices=1, **_LM),
                        metrics=JaxMetrics(echo=False))
    init = params_from_jax(jax.device_get(full.state["params"]))
    res = full.train()
    return init, res, jax.tree.leaves(jax.device_get(full.state))


def _close_lm_state(got: list, want: list):
    """AdamW state across packages: params and moments within PARAM_ATOL
    (6e-8 measured), the counts and the step equal."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL)


def test_a_jax_lm_checkpoint_resumes_in_the_port(tmp_path, jax_lm_full):
    """The JAX LM trainer writes every 2 steps (params, AdamW's count, mu
    and nu, the schedule's count); the port resumes from step 4 and ends
    within the tolerances of JAX's uninterrupted run."""
    init, jres, want = jax_lm_full
    ck = tmp_path / "ck"
    JaxLMTrainer(JaxLMConfig(num_devices=1, checkpoint_dir=str(ck),
                             checkpoint_every=2, **_LM),
                 metrics=JaxMetrics(echo=False)).train()
    _keep_only(ck, "ckpt_4.npz")
    t = LMTrainer(LMConfig(device="cpu", checkpoint_dir=str(ck), resume=True,
                           **_LM), params=init)
    res = t.train()
    assert res.steps_run == 2 and t.state["opt_state"]["count"] == 6
    np.testing.assert_allclose(res.final_loss, jres.final_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_loss, jres.eval_loss, rtol=LOSS_RTOL)
    got = [_np(v) for v in checkpoint_arrays(t.state, t.optimizer).values()]
    _close_lm_state(got, want)


def test_a_port_lm_checkpoint_resumes_in_jax(tmp_path, jax_lm_full):
    """The port's LM trainer writes every 2 steps; the JAX LM trainer
    resumes from its step-4 file through its own `restore_latest` and
    ends within the tolerances of its uninterrupted run."""
    init, jres, want = jax_lm_full
    ck = tmp_path / "ck"
    LMTrainer(LMConfig(device="cpu", checkpoint_dir=str(ck),
                       checkpoint_every=2, **_LM), params=init).train()
    _keep_only(ck, "ckpt_4.npz")
    jt = JaxLMTrainer(JaxLMConfig(num_devices=1, checkpoint_dir=str(ck),
                                  resume=True, **_LM),
                      metrics=JaxMetrics(echo=False))
    restored, path = jax_ckpt.restore_latest(ck, jax.device_get(jt.state))
    assert path.name == "ckpt_4.npz" and int(restored["step"]) == 4
    res = jt.train()
    assert res.steps_run == 2
    np.testing.assert_allclose(res.final_loss, jres.final_loss,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(res.eval_loss, jres.eval_loss, rtol=LOSS_RTOL)
    _close_lm_state(jax.tree.leaves(jax.device_get(jt.state)), want)


# ---------------------------------------------------------------------------
# bf16 params (ROADMAP queue A item 2)
# ---------------------------------------------------------------------------


def _bf16_trainers(ck):
    """The JAX and the port's reference_cnn trainers with bf16 params and
    momentum (bf16 compute), checkpointing into `ck`, from one init."""
    cfg = dict(epochs=1, batch_size=32, momentum=0.9, log_every=0,
               eval_every=0, param_dtype="bfloat16", compute_dtype="bfloat16",
               checkpoint_dir=str(ck))
    jt = JaxTrainer(jax_get_model("reference_cnn"), jax_stripes(64, 16),
                    JaxConfig(num_devices=1, scan=False, **cfg),
                    metrics=JaxMetrics(echo=False))
    init = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jax.device_get(jt.state["params"]))
    pt = Trainer(get_model("reference_cnn"), synthetic_stripes(64, 16),
                 Config(device="cpu", resume=True, **cfg),
                 metrics=MetricsLogger(echo=False),
                 params=params_from_jax(init))
    return jt, pt


def _bits(t) -> np.ndarray:
    return t.detach().view(torch.int16).numpy()


def test_bf16_leaves_are_the_jax_packages_bytes_and_resume_bitwise(
        tmp_path):
    """The port writes a bf16 leaf as `|V2`, the manifest's checksum the
    JAX package's `_checksum` of the live bf16 array, and a trainer
    resumes its own file bit for bit."""
    jt, pt = _bf16_trainers(tmp_path / "ck")
    pt.run_epoch(0)
    pt.recovery.finish(pt.state)
    pt.recovery.close()
    with np.load(tmp_path / "ck" / "ckpt_2.npz") as f:
        assert f["params/0/w"].dtype == np.dtype("V2")
        assert f["opt_state/0/.trace/2/w"].dtype == np.dtype("V2")
    sums = json.loads((tmp_path / "ck" / "manifest.json").read_text())[
        "checksums"]["ckpt_2.npz"]
    w = jnp.asarray(pt.params[2]["w"].detach().float().numpy(), jnp.bfloat16)
    assert sums["params/2/w"] == jax_ckpt._checksum(np.asarray(w))
    _, again = _bf16_trainers(tmp_path / "ck")
    assert again.recovery.resume(again.state) and again.step == 2
    for a, b in zip(again.leaves + again.opt_state["trace"],
                    pt.leaves + pt.opt_state["trace"], strict=True):
        assert a.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_a_jax_bf16_checkpoint_resumes_in_the_port_bitwise(tmp_path):
    """The JAX trainer's bf16 state after a step, written by the JAX
    package: the port restores every leaf's bits."""
    jt, _ = _bf16_trainers(tmp_path / "ck")
    jt.run_epoch(0)
    jax_ckpt.save_checkpoint(tmp_path / "ck", jt.state, 2)
    _, pt = _bf16_trainers(tmp_path / "ck")
    assert pt.recovery.resume(pt.state) and pt.step == 2
    want = jax.tree.leaves(jax.device_get(jt.state["params"]))
    want += jax.tree.leaves(jax.device_get(jt.state["opt_state"]))
    got = pt.leaves + pt.opt_state["trace"]
    for a, b in zip(got, [w for w in want if np.ndim(w)], strict=True):
        np.testing.assert_array_equal(_bits(a), np.asarray(b).view(np.int16))


def test_the_jax_package_cannot_restore_its_own_bf16_checkpoint(tmp_path):
    """A reference caveat (ROADMAP C), pinned: the JAX package's checksum
    is taken over "bfloat16:(shape)" at save and over "|V2:(shape)" at
    restore, so its restore of its own bf16 file raises."""
    state = {"w": jnp.arange(3, dtype=jnp.bfloat16)}
    jax_ckpt.save_checkpoint(tmp_path, state, 1)
    with pytest.raises(jax_ckpt.CheckpointCorruptError, match="corrupt"):
        jax_ckpt.restore_checkpoint(tmp_path / "ckpt_1.npz", state)
    assert jax_ckpt.restore_latest(tmp_path, state) == (None, None)
