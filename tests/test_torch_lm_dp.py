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
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

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
        # one all-reduce per step and one of the preemption flags at its
        # end, none in the replicated eval
        assert res["counts"]["collectives"] == {"all_reduce": 2 * STEPS,
                                                "broadcast": 0}
    assert runs["ranks"][0]["losses"] == runs["ranks"][1]["losses"]


@pytest.mark.parametrize("kw,want", [
    (dict(mesh_shape="data:2,model:2"), {"data": 2, "model": 2}),
    (dict(mesh_shape="data:2,seq:2", moe_experts=4), {"data": 2, "seq": 2}),
    (dict(fsdp=True, num_devices=2), {"data": 2}),
    (dict(elastic_width=4, mesh_shape="data:2,model:2"),
     "--elastic-width needs a pure data-parallel mesh")],
    ids=["model", "seq", "fsdp", "elastic"])
def test_what_the_lm_data_mesh_still_refuses(kw, want):
    """The model axis, MoE under a seq axis and --fsdp are ported: their
    meshes come back; the elastic width beside a model axis is the
    reference trainer's ValueError."""
    if isinstance(want, dict):
        assert check_lm_supported(LMConfig(**kw)) == want
    else:
        with pytest.raises(ValueError, match=want):
            check_lm_supported(LMConfig(**kw))


def test_lm_batch_not_divisible_by_the_data_axis_raises():
    # the reference trainer's first check of the batch is over data x
    # expert, the rows an EP x DP rank takes
    with pytest.raises(ValueError, match=r"batch_size 6 not divisible by "
                                         r"data x expert shards \(4 x 1\)"):
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


# ---------------------------------------------------------------------------
# MoE under data parallelism: the ranks route one global batch
# ---------------------------------------------------------------------------

MOE_BASE = dict(corpus="synthetic", dim=32, depth=2, heads=2, seq_len=32,
                batch_size=8, steps=3, warmup_steps=2, lr=3e-3,
                attn_impl="oracle", log_every=1, moe_experts=4)
MOE_LOSS_RTOL = 1e-6
MOE_CASES = {  # world, flags
    "w2_top1_accum2": (2, dict(moe_top_k=1, grad_accum=2)),
    "w4_top2": (4, dict(moe_top_k=2)),
    "w4_top2_chunk_over_2_ranks": (4, dict(moe_top_k=2,
                                           moe_dispatch_chunk=128)),
    "w2_top2_remat": (2, dict(moe_top_k=2, remat=True)),
}


def _biased(params, c=2.0):
    """The JAX init with every token embedding and every router's expert-0
    column moved along one zero-mean direction: most tokens choose expert
    0 first, so the global capacity drops tokens."""
    w = np.random.default_rng(0).standard_normal(
        params["tok_emb"].shape[1]).astype(np.float32)
    w = (w - w.mean()) / np.linalg.norm(w - w.mean())
    params = jax.tree.map(np.array, params)
    params["tok_emb"] += c * w
    for blk in params["blocks"]:
        blk["moe"]["gate"][:, 0] += c * w
    return params


def _global_drops(kw, init, monkeypatch):
    """Tokens the first step's forward drops when the whole batch is
    routed at once (as the JAX step and the port's ranks route it)."""
    import torch

    from mpi_cuda_cnn_tpu_torch.parallel import moe

    drops = []
    real = moe._dispatch

    def spy(idx, *args, **kw_):
        d, g = real(idx, *args, **kw_)
        drops.append(idx.numel() - float(d.sum()))
        return d, g

    monkeypatch.setattr(moe, "_dispatch", spy)
    tr = LMTrainer(LMConfig(device="cpu", **kw), params=init)
    tokens, _ = tr._sample_batch(0)
    with torch.no_grad():
        tr.model.apply(tr.state["params"], torch.from_numpy(tokens),
                       moe_dispatch_chunk=kw.get("moe_dispatch_chunk", 0))
    return sum(drops)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_dp_routes_the_global_batch_as_jax(case, monkeypatch):
    """The JAX DP trainer's one GSPMD step routes the global batch (its
    capacity, rank-major slot positions, global balance-loss means); the
    port's ranks route theirs together through one all-reduce a MoE
    layer. Per-step losses and the eval loss within 1e-6, with tokens
    dropped at the global capacity."""
    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics

    world, flags = MOE_CASES[case]
    kw = dict(MOE_BASE, **flags)
    jm = JaxMetrics(echo=False, capture=True)
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=world, **kw), metrics=jm)
    init = _biased(jax.device_get(jtr.state["params"]))
    jtr.state["params"] = jax.device_put(
        init, jax.tree.map(lambda a: a.sharding, jtr.state["params"]))
    jres = jtr.train()
    want = [r["loss"] for r in jm.rows if r["event"] == "train"]
    assert _global_drops(kw, params_from_jax(init), monkeypatch) > 0
    ranks = run_ranks(lm_rank, world, args=(
        LMConfig(device="cpu", num_devices=world, **kw),
        params_from_jax(init)), timeout=RANKS_TIMEOUT_S)
    micro = kw.get("grad_accum", 1)
    for res in ranks:
        assert res["losses"] == ranks[0]["losses"]
        np.testing.assert_allclose(res["losses"], want, rtol=MOE_LOSS_RTOL)
        np.testing.assert_allclose(res["eval_loss"], jres.eval_loss,
                                   rtol=MOE_LOSS_RTOL)
        # the step's all-reduce, the preemption flags' at its end, and one
        # a MoE layer a micro-batch (two under remat: the backward runs
        # each block's forward again)
        forwards = 2 if kw.get("remat") else 1
        assert res["counts"]["collectives"]["all_reduce"] == \
            kw["steps"] * (2 + forwards * micro * kw["depth"])


def test_moe_elastic_is_width_invariant_and_matches_jax():
    """--elastic-width 4: each canonical micro-batch routes by itself, as
    in the JAX elastic step; worlds 1 and 2 bit for bit, within 1e-6 of
    the JAX elastic trainer."""
    from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics

    kw = dict(MOE_BASE, moe_top_k=2, elastic_width=4)
    jm = JaxMetrics(echo=False, capture=True)
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=1, **kw), metrics=jm)
    init = _biased(jax.device_get(jtr.state["params"]))
    jtr.state["params"] = jax.device_put(
        init, jax.tree.map(lambda a: a.sharding, jtr.state["params"]))
    jres = jtr.train()
    want = [r["loss"] for r in jm.rows if r["event"] == "train"]
    runs = {w: run_ranks(lm_rank, w, args=(
        LMConfig(device="cpu", num_devices=w, **kw), params_from_jax(init)),
        timeout=RANKS_TIMEOUT_S) for w in (1, 2)}
    ref = runs[1][0]
    np.testing.assert_allclose(ref["losses"], want, rtol=MOE_LOSS_RTOL)
    np.testing.assert_allclose(ref["eval_loss"], jres.eval_loss,
                               rtol=MOE_LOSS_RTOL)
    for res in runs[2]:
        assert res["losses"] == ref["losses"]
        assert res["final_loss"] == ref["final_loss"]
        assert res["eval_loss"] == ref["eval_loss"]


def test_moe_chunk_that_splits_a_rank_unevenly_is_refused():
    """The ranks route a chunk spanning ranks only as whole ranks: 96
    tokens a rank and chunks of 64 (which the JAX package's global
    routing accepts, 384 tokens in all) fail at construction, not at the
    first step."""
    import torch

    kw = dict(MOE_BASE, batch_size=12, moe_dispatch_chunk=64)
    mesh = Mesh(shape={"data": 4}, rank=0, world=4,
                device=torch.device("cpu"), group=None)
    with pytest.raises(ValueError, match="neither divides nor is a multiple"):
        LMTrainer(LMConfig(device="cpu", num_devices=4, **kw), mesh=mesh)
    LMTrainer(LMConfig(device="cpu", num_devices=4,
                       **dict(kw, moe_dispatch_chunk=32)), mesh=mesh)
