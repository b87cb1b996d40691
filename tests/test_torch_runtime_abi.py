"""The port's `runtime_abi` (string-in/string-out driver of both
trainers) against the JAX package's `runtime_abi` on the CPU.

The same config JSON, in the C driver's shape (native/driver.c), goes
through both packages: equal model and parameter counts, the epoch's
losses within the trainer parity tests' 1e-5 relative (and its accuracy
and the eval counts equal), the LM's losses within the rounding of the
printed four decimals, and checkpoints that the other package's `load`
restores bit for bit. The port maps the reference's device names
("tpu" is the card, "jax-cpu" the CPU) and falls back to nothing: a
card that is not there raises.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu import runtime_abi as jax_abi
from mpi_cuda_cnn_tpu.utils.config import Config as JaxConfig
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu_torch import runtime_abi
from mpi_cuda_cnn_tpu_torch.data.datasets import (
    synthetic_stripes,
    write_synthetic_idx,
)
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.utils.config import Config, LMConfig, port_device
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

LOSS_RTOL = 1e-5        # tests/test_torch_train.py's epoch-loss tolerance


@pytest.fixture(scope="module")
def idx_config(tmp_path_factory):
    """The C driver's CNN config over four IDX files of 256/64 samples
    (8 steps of batch 32), on the CPU, on one device (the JAX package
    here sees tests/conftest.py's eight)."""
    d = tmp_path_factory.mktemp("idx")
    paths = write_synthetic_idx(d, synthetic_stripes(num_train=256,
                                                     num_test=64))
    return {"dataset": "idx", **{k: str(v) for k, v in paths.items()},
            "model": "reference_cnn", "epochs": 1, "lr": 0.1,
            "batch_size": 32, "seed": 0, "device": "cpu",
            "log_every": 1000000000, "num_devices": 1}


@pytest.fixture(scope="module")
def cnn_runs(idx_config, tmp_path_factory):
    """init, one epoch, evaluate and save through each package, then each
    package's `load` of the other's checkpoint and a second evaluate."""
    d = tmp_path_factory.mktemp("ckpt")
    text = json.dumps(idx_config)
    out = {}
    for side, abi in (("jax", jax_abi), ("torch", runtime_abi)):
        out[side] = {
            "init": json.loads(abi.init(text)),
            "epoch": json.loads(abi.train_epoch()),
            "eval": json.loads(abi.evaluate()),
            "save": json.loads(abi.save(str(d / side))),
        }
    jparams = [np.asarray(x) for x in jax.tree.leaves(jax.device_get(
        jax_abi._trainer().state["params"]))]
    tparams = [t.detach().numpy().copy()
               for t in tree_leaves(runtime_abi._trainer().params)]
    out["torch"]["load"] = json.loads(runtime_abi.load(str(d / "jax")))
    out["torch"]["eval_loaded"] = json.loads(runtime_abi.evaluate())
    out["torch"]["params_loaded"] = [
        t.detach().numpy().copy()
        for t in tree_leaves(runtime_abi._trainer().params)]
    out["jax"]["load"] = json.loads(jax_abi.load(str(d / "torch")))
    out["jax"]["eval_loaded"] = json.loads(jax_abi.evaluate())
    out["jax"]["params_loaded"] = [np.asarray(x) for x in jax.tree.leaves(
        jax.device_get(jax_abi._trainer().state["params"]))]
    out["jax"]["params"], out["torch"]["params"] = jparams, tparams
    return out


def test_init_matches(cnn_runs):
    assert cnn_runs["torch"]["init"] == cnn_runs["jax"]["init"] == {
        "ok": True, "model": "reference_cnn", "n_params": 360810}


def test_epoch_and_eval_match(cnn_runs):
    t, j = cnn_runs["torch"]["epoch"], cnn_runs["jax"]["epoch"]
    assert t["epoch"] == j["epoch"] == 0 and t["steps"] == j["steps"] == 8
    for key in ("loss", "etotal"):
        np.testing.assert_allclose(t[key], j[key], rtol=LOSS_RTOL)
    assert t["acc"] == j["acc"]
    assert t["seconds"] >= 0
    assert cnn_runs["torch"]["eval"] == cnn_runs["jax"]["eval"]
    assert cnn_runs["torch"]["eval"]["ntests"] == 64


def test_checkpoints_restore_across_packages(cnn_runs):
    """Each package's `load` of the other's file restores its params bit
    for bit, and the eval counts stay the same."""
    t, j = cnn_runs["torch"], cnn_runs["jax"]
    assert t["save"]["path"].endswith("ckpt_8.npz")
    assert j["save"]["path"].endswith("ckpt_8.npz")
    assert t["load"]["restored"] == j["save"]["path"]
    assert j["load"]["restored"] == t["save"]["path"]
    for got, want in zip(t["params_loaded"], j["params"]):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(j["params_loaded"], t["params"]):
        np.testing.assert_array_equal(got, want)
    assert t["eval_loaded"] == j["eval"]
    assert j["eval_loaded"] == t["eval"]


def test_load_keeps_the_live_tensors(idx_config, tmp_path):
    """`load` copies into the trainer's tensors in place (their identity,
    device and dtype stay): the placement the trainer chose survives,
    as the reference's place_state keeps its shardings."""
    runtime_abi.init(json.dumps(idx_config))
    trainer = runtime_abi._trainer()
    before = [(id(t), t.device, t.dtype) for t in tree_leaves(trainer.params)]
    runtime_abi.save(str(tmp_path))
    json.loads(runtime_abi.train_epoch())
    ckpt = json.loads(runtime_abi.load(str(tmp_path / "ckpt_0.npz")))
    assert ckpt["restored"].endswith("ckpt_0.npz")
    after = [(id(t), t.device, t.dtype) for t in tree_leaves(trainer.params)]
    assert after == before


def test_lm_matches():
    """The C driver's `lm` config through both packages: the same vocab
    and parameter count, the same steps, and the losses within the
    four-decimal rounding of the line (plus 1e-5 relative)."""
    cfg = json.dumps({
        "corpus": "synthetic", "mesh_shape": "data",
        "compute_dtype": "float32", "pos": "learned", "dim": 32,
        "depth": 1, "heads": 2, "kv_heads": 0, "moe_experts": 0,
        "moe_top_k": 2, "ce_chunk": 0, "grad_accum": 1, "grad_clip": 0,
        "seq_len": 64, "steps": 3, "batch_size": 4, "lr": 3e-3, "seed": 0,
        "device": "jax-cpu", "log_every": 0, "lr_schedule": "constant",
        "warmup_steps": 0, "attn_impl": "oracle", "num_devices": 1})
    out = {}
    for side, abi in (("jax", jax_abi), ("torch", runtime_abi)):
        text = cfg if side == "torch" else cfg.replace("jax-cpu", "cpu")
        out[side] = (json.loads(abi.lm_init(text)),
                     json.loads(abi.lm_train()))
    (tinit, tres), (jinit, jres) = out["torch"], out["jax"]
    assert tinit == jinit and tinit["vocab"] == 251
    assert tres["steps_run"] == jres["steps_run"] == 3
    for key in ("final_loss", "eval_loss", "eval_ppl"):
        assert abs(tres[key] - jres[key]) <= 1e-4 + LOSS_RTOL * abs(jres[key])
    assert tres["tokens_per_s"] > 0


def test_configs_read_the_reference_json():
    """`from_json` reads the JSON of the reference's `to_json`: every
    shared field equal, `use_pallas` as `use_kernels`, `donate` dropped,
    the reference's device names mapped."""
    jcfg = JaxConfig(dataset="synthetic", epochs=3, use_pallas=True,
                     device="tpu", grad_accum=2, fault_plan="crash@x:1")
    cfg = Config.from_json(jcfg.to_json())
    shared = {f.name for f in dataclasses.fields(Config)}
    jd = dataclasses.asdict(jcfg)
    assert {k: v for k, v in dataclasses.asdict(cfg).items()
            if k not in ("use_kernels", "device")} == \
        {k: jd[k] for k in shared if k not in ("use_kernels", "device")}
    assert cfg.use_kernels is True and cfg.device == "cuda"
    lm = JaxLMConfig(dim=48, depth=2, device="cpu", moe_experts=4)
    assert dataclasses.asdict(LMConfig.from_json(lm.to_json())) == \
        dataclasses.asdict(lm)
    assert Config.from_json(Config(epochs=2).to_json()) == Config(epochs=2)
    assert [port_device(n) for n in ("auto", "tpu", "jax-cpu", "cuda:1")] \
        == ["auto", "cuda", "cpu", "cuda:1"]
    for bad in ('{"device": "gpu"}', '{"use_pallas": true, '
                '"use_kernels": false}'):
        with pytest.raises(ValueError):
            Config.from_json(bad)
    with pytest.raises(TypeError):
        Config.from_json('{"not_a_field": 1}')


@pytest.mark.parametrize("device", ["auto", "tpu", "cuda"])
def test_no_card_raises_and_never_falls_back(idx_config, monkeypatch,
                                             device):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(runtime_abi, "_STATE", {})
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        runtime_abi.init(json.dumps({**idx_config, "device": device}))
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        runtime_abi.lm_init(json.dumps({"corpus": "synthetic",
                                        "device": device}))
    assert runtime_abi._STATE == {}
    with pytest.raises(RuntimeError, match="init"):
        runtime_abi.train_epoch()
    with pytest.raises(RuntimeError, match="lm_init"):
        runtime_abi.lm_train()
