"""The port's MoE blocks (`parallel/moe.py`, the MoE `TransformerLM`, the
LM trainer and commands with --moe-experts) against the JAX package's
(`parallel/ep.py` with axis=None, its `TransformerLM`, `LMTrainer`).

Inputs come from numpy seeds; weights go across with
`convert.params_from_jax`. Routing is held bit for bit (the dispatch
tensor: the choices, the capacity and the slot positions), float32
values within 1e-6 (sums in other orders), bf16 within the bf16 band.
"""

import dataclasses
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.parallel import ep
from mpi_cuda_cnn_tpu.train.lm import count_params as jax_count_params
from mpi_cuda_cnn_tpu.train.lm import lm_flops_per_token as jax_flops
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu.utils.logging import MetricsLogger as JaxMetrics
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import checkpoint_arrays, params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.parallel import moe
from mpi_cuda_cnn_tpu_torch.train.lm import count_params, lm_flops_per_token
from mpi_cuda_cnn_tpu_torch.train.lm_bench import lm_bench
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig
from mpi_cuda_cnn_tpu_torch.utils.logging import get_logger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# float32 values from the same inputs: sums in other orders (measured
# up to 5e-7 on outputs of order 1).
F32_ATOL = 1e-6
# One forward / its gradients from equal params, relative to max|.|:
# tests/test_torch_lm.py's FWD_TOL.
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# bf16 gradients of the MoE LM, per leaf (relative L2).
BF16_GRAD_REL_L2 = 5e-2
T, D, E = 64, 16, 4


def _x(seed=0, t=T, d=D):
    return np.random.default_rng(seed).standard_normal((t, d)).astype(np.float32)


def _gate(seed=1, d=D, e=E):
    return np.random.default_rng(seed).standard_normal((d, e)).astype(np.float32)


def _moe_params(seed=0, d=D, e=E):
    jp = ep.init_moe_params(jax.random.key(seed), d, 4 * d, e)
    return jp, {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}


def _np(t):
    return t.detach().float().numpy() if isinstance(t, torch.Tensor) \
        else np.asarray(jnp.asarray(t, jnp.float32))


# ---------------------------------------------------------------------------
# Routing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2])
def test_router_dispatch_matches_jax_with_drops(k):
    x, g = _x(), _gate()
    cap = moe.capacity(T, k, 1.0, E) // 2          # half the slots: drops
    jd, jg, ja = ep.router_dispatch(jnp.asarray(x), jnp.asarray(g), E, cap,
                                    k=k)
    td, tg, ta = moe.router_dispatch(torch.from_numpy(x), torch.from_numpy(g),
                                     E, cap, k=k)
    assert T * k - float(td.sum()) > 0             # tokens were dropped
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=0,
                               atol=F32_ATOL)
    np.testing.assert_allclose(float(ta), float(ja), rtol=0, atol=F32_ATOL)
    # the statistics form and the dense views
    _, _, (jf, jp) = ep.router_dispatch(jnp.asarray(x), jnp.asarray(g), E,
                                        cap, k=k, return_stats=True)
    _, _, (tf, tp) = moe.router_dispatch(torch.from_numpy(x),
                                         torch.from_numpy(g), E, cap, k=k,
                                         return_stats=True)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=F32_ATOL)
    for jfn, tfn in ((ep.top1_dispatch, moe.top1_dispatch),
                     (ep.topk_dispatch, moe.topk_dispatch)):
        args = (E, cap) if jfn is ep.top1_dispatch else (E, cap, k)
        jd, jc, _ = jfn(jnp.asarray(x), jnp.asarray(g), *args)
        td, tc, _ = tfn(torch.from_numpy(x), torch.from_numpy(g), *args)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=F32_ATOL)


def test_bf16_dispatch_is_bit_for_bit():
    x, g = _x(2), _gate(3)
    jd, _, _ = ep.router_dispatch(jnp.asarray(x), jnp.asarray(g), E, 20, k=2,
                                  dtype=jnp.bfloat16)
    td, _, _ = moe.router_dispatch(torch.from_numpy(x), torch.from_numpy(g),
                                   E, 20, k=2, dtype=torch.bfloat16)
    assert td.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(td), _np(jd))


def test_ties_take_the_lower_index_as_lax_top_k():
    """Two experts of exactly equal probability (equal gate columns): the
    first choice is the lower index, the second the other; and a tie for
    second place likewise."""
    x = _x(4, t=16)
    g = _gate(5)
    g[:, 3] = g[:, 1] = 2.0 * np.abs(g).max(0).max() * np.sign(x.sum(0) + 1e-9)
    g[:, 2] = g[:, 0]
    probs = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(g), axis=-1)
    assert bool(jnp.any(probs[:, 1] == probs[:, 3]))
    _, jidx = jax.lax.top_k(probs, 2)
    _, tidx, _ = moe.route_probs(torch.from_numpy(x), torch.from_numpy(g), 2)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    for k in (1, 2):
        jd, _, _ = ep.router_dispatch(jnp.asarray(x), jnp.asarray(g), E, 6,
                                      k=k)
        td, _, _ = moe.router_dispatch(torch.from_numpy(x),
                                       torch.from_numpy(g), E, 6, k=k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))


def test_capacity_is_the_references_float_floor_division():
    for t, k, cf, e in [(16384, 2, 1.25, 8), (64, 1, 1.25, 4), (7, 2, 1.1, 3),
                        (1, 1, 1.0, 16), (512, 2, 1.25, 8)]:
        want = max(1, -int(-t * k * cf // e))
        assert moe.capacity(t, k, cf, e) == want
    assert moe.capacity(16384, 2, 1.25, 8) == 5120


@pytest.mark.parametrize("k,chunk", [(1, 0), (2, 0), (1, 16), (2, 16)])
def test_moe_mlp_matches_jax(k, chunk):
    """moe_mlp and its gradients (x, gate, w1, w2) from the same inputs."""
    jp, tp = _moe_params()
    x = _x(6)

    def jax_loss(p, x):
        y, aux = ep.moe_mlp(x, p, n_experts=E, axis=None, top_k=k,
                            dispatch_chunk=chunk)
        return jnp.sum(y * jnp.cos(jnp.arange(D))) + aux, (y, aux)

    (_, (jy, ja)), jgrads = jax.value_and_grad(jax_loss, argnums=(0, 1),
                                               has_aux=True)(jp, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    leaves = [tp[n].requires_grad_(True) for n in ("gate", "w1", "w2")]
    ty, ta = moe.moe_mlp(tx, tp, n_experts=E, top_k=k, dispatch_chunk=chunk)
    loss = (ty * torch.cos(torch.arange(D))).sum() + ta
    grads = torch.autograd.grad(loss, [*leaves, tx])
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=F32_ATOL)
    np.testing.assert_allclose(float(ta.detach()), float(ja), atol=F32_ATOL)
    want = [jgrads[0][n] for n in ("gate", "w1", "w2")] + [jgrads[1]]
    for got, w in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), rtol=0,
                                   atol=FWD_TOL["float32"] * np.abs(w).max())


@pytest.mark.parametrize("k", [1, 2])
def test_chunked_equals_unchunked_when_nothing_drops(k):
    """With capacity to spare (cf 4: no chunk drops a token) chunked and
    whole-batch routing give the same outputs; the chunked aux loss is
    the whole batch's, formed once from the summed statistics (not a
    mean of per-chunk losses)."""
    _, tp = _moe_params(1)
    x = torch.from_numpy(_x(7))
    y0, a0 = moe.moe_mlp(x, tp, n_experts=E, top_k=k, capacity_factor=4.0)
    y1, a1 = moe.moe_mlp(x, tp, n_experts=E, top_k=k, capacity_factor=4.0,
                         dispatch_chunk=16)
    np.testing.assert_allclose(y1.numpy(), y0.numpy(), rtol=0, atol=F32_ATOL)
    np.testing.assert_allclose(float(a1), float(a0), rtol=0, atol=F32_ATOL)
    # with drops the outputs differ, the aux loss does not
    _, a2 = moe.moe_mlp(x, tp, n_experts=E, top_k=k, capacity_factor=0.5,
                        dispatch_chunk=8)
    np.testing.assert_allclose(float(a2), float(a0), rtol=0, atol=F32_ATOL)


def test_dispatch_dtype_and_bf16_compute():
    """bf16 dispatch under float32 tokens: exact 0/1 entries promote as
    jnp.einsum promotes, so float32 results; bf16 tokens and weights: the
    bf16 band."""
    jp, tp = _moe_params(2)
    x = _x(8)
    jy, _ = ep.moe_mlp(jnp.asarray(x), jp, n_experts=E, axis=None, top_k=2,
                       dispatch_dtype=jnp.bfloat16)
    ty, _ = moe.moe_mlp(torch.from_numpy(x), tp, n_experts=E, top_k=2,
                        dispatch_dtype=torch.bfloat16)
    assert ty.dtype == torch.float32
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=F32_ATOL)
    jb = jax.tree.map(lambda a: a.astype(jnp.bfloat16), jp)
    tb = {n: t.to(torch.bfloat16) for n, t in tp.items()}
    jy, ja = ep.moe_mlp(jnp.asarray(x, jnp.bfloat16), jb, n_experts=E,
                        axis=None, top_k=2, dispatch_chunk=16)
    ty, ta = moe.moe_mlp(torch.from_numpy(x).to(torch.bfloat16), tb,
                         n_experts=E, top_k=2, dispatch_chunk=16)
    assert ty.dtype == torch.bfloat16
    want = _np(jy)
    off = np.abs(_np(ty) - want).max(1) > FWD_TOL["bfloat16"] * np.abs(
        want).max()
    # A row outside the band is a token whose second choice was a tie:
    # bf16 router logits tie often, and XLA's scan body breaks this seed's
    # one exact tie (token 15, experts 2 and 3) the other way than its
    # own whole-batch routing does, which the port matches.
    probs, _, _ = moe.route_probs(torch.from_numpy(x).to(torch.bfloat16),
                                  tb["gate"], 2)
    top3 = torch.sort(probs, dim=-1, descending=True).values[:, :3]
    assert off.sum() <= 1
    assert torch.all(top3[off, 1] - top3[off, 2] < 1e-6)
    # The aux loss: float32 statistics of probabilities of bf16 logits,
    # which XLA's scan body fuses otherwise (1.4e-5 measured): bf16 band.
    np.testing.assert_allclose(float(ta), float(ja),
                               rtol=FWD_TOL["bfloat16"])


@pytest.mark.parametrize("k", [1, 2])
def test_moe_mlp_inference_matches_jax(k):
    jp, tp = _moe_params(3)
    x = _x(9)
    jy = ep.moe_mlp_inference(jnp.asarray(x), jp, n_experts=E, top_k=k)
    ty = moe.moe_mlp_inference(torch.from_numpy(x), tp, n_experts=E, top_k=k)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=F32_ATOL)


def test_expert_relu_gradient_at_zero_is_zero():
    """The expert FFN's ReLU is jax.nn.relu, whose gradient at exactly 0
    is 0 (the CNN's jnp.maximum(x, 0) has 1/2 there, ROADMAP C3). Hidden
    unit 0 of every expert has an all-zero w1 column, so its
    pre-activation is exactly 0 for every token: its w2 row and its w1
    column get gradient 0 on both sides."""
    jp, tp = _moe_params(4)
    jp = dict(jp, w1=jp["w1"].at[:, :, 0].set(0.0))
    tp = dict(tp, w1=tp["w1"].clone())
    tp["w1"][:, :, 0] = 0.0
    x = _x(10)

    def jax_loss(p):
        return jnp.sum(ep.moe_mlp(jnp.asarray(x), p, n_experts=E, axis=None,
                                  top_k=2)[0] ** 2)

    jg = jax.grad(jax_loss)(jp)
    w1 = tp["w1"].requires_grad_(True)
    y, _ = moe.moe_mlp(torch.from_numpy(x), dict(tp, w1=w1), n_experts=E,
                       top_k=2)
    (g,) = torch.autograd.grad((y ** 2).sum(), [w1])
    assert np.all(np.asarray(jg["w1"])[:, :, 0] == 0)
    assert torch.all(g[:, :, 0] == 0)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg["w1"]), rtol=0,
                               atol=FWD_TOL["float32"] * np.abs(
                                   np.asarray(jg["w1"])).max())


# ---------------------------------------------------------------------------
# The MoE block and the LM
# ---------------------------------------------------------------------------

KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64, moe_experts=4)
APPLY_CASES = [  # (top_k, dispatch_chunk, dtype, remat, inference)
    (1, 0, "float32", False, False),
    (2, 0, "float32", True, False),
    (2, 32, "float32", False, False),
    (2, 32, "bfloat16", False, False),
    (1, 0, "bfloat16", False, False),
    (2, 0, "float32", False, True),
]


@pytest.mark.parametrize("k,chunk,dtype,remat,inference", APPLY_CASES,
                         ids=["-".join(map(str, c)) for c in APPLY_CASES])
def test_moe_lm_apply_and_grads_match_jax(k, chunk, dtype, remat, inference):
    cfg = dict(KW, moe_top_k=k, kv_heads=2)
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
    jp = jm.init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = np.random.default_rng(2).integers(0, 64, (2, 32)).astype(np.int32)
    jcd = jnp.bfloat16 if dtype == "bfloat16" else None
    tcd = torch.bfloat16 if dtype == "bfloat16" else None
    opts = dict(remat=remat, moe_inference=inference, moe_dispatch_chunk=chunk)

    def jax_loss(p):
        logits, aux = jm.apply(p, jnp.asarray(toks), compute_dtype=jcd,
                               return_aux=True, **opts)
        return jnp.mean(logits ** 2) + aux, (logits, aux)

    (_, (jl, ja)), jg = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(jp)
    leaves = [t.requires_grad_(True) for t in tree_leaves(tp)]
    tl, ta = tm.apply(tp, torch.from_numpy(toks), compute_dtype=tcd,
                      return_aux=True, **opts)
    grads = torch.autograd.grad((tl ** 2).mean() + ta, leaves)
    tol = FWD_TOL[dtype]
    want = _np(jl)
    assert np.abs(_np(tl) - want).max() <= tol * np.abs(want).max()
    if inference:
        assert float(ta) == 0.0
    np.testing.assert_allclose(float(ta.detach()), float(ja), rtol=tol)
    for got, w in zip(grads, jax.tree.leaves(jg)):
        got, w = _np(got), _np(w)
        if dtype == "float32":
            assert np.abs(got - w).max() <= tol * max(np.abs(w).max(), 1e-6)
        else:
            # bf16 rounds every activation (2^-9), and a pre-activation
            # within an ulp of 0 takes the other side of an expert's ReLU:
            # per leaf, relative L2 (2.1e-2 measured at worst, wq).
            assert np.linalg.norm(got - w) <= BF16_GRAD_REL_L2 * max(
                np.linalg.norm(w), 1e-30)


def test_moe_flops_and_param_count_match_jax():
    for k in (1, 2):
        cfg = dict(KW, moe_top_k=k, kv_heads=2)
        jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
        assert lm_flops_per_token(tm, 64) == jax_flops(jm, 64)
        assert count_params(tm.init(prng.key(0))) == \
            jax_count_params(jm.init(jax.random.key(0)))
    flagship = TransformerLM(vocab=8192, dim=512, heads=8, depth=8,
                             max_seq=2048, moe_experts=8, moe_top_k=2)
    assert count_params(flagship.init(prng.key(0), "meta")) \
        == 152_093_696


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------

LOSS_RTOL = 1e-6
TRAIN = dict(corpus="synthetic", dim=32, depth=2, heads=2, seq_len=32,
             batch_size=4, steps=5, warmup_steps=2, lr=3e-3,
             attn_impl="oracle", log_every=1, moe_experts=4)
TRAIN_CASES = {"top1": dict(moe_top_k=1), "top2": dict(moe_top_k=2),
               "chunked": dict(moe_top_k=2, moe_dispatch_chunk=32),
               "accum": dict(moe_top_k=2, grad_accum=2),
               "remat": dict(moe_top_k=1, remat=True)}


def _losses(metrics_rows):
    return [r["loss"] for r in metrics_rows if r["event"] == "train"]


@pytest.mark.parametrize("case", list(TRAIN_CASES))
def test_moe_trainer_matches_the_jax_trainer(case):
    """5 AdamW steps from the JAX trainer's init: per-step losses within
    1e-6 relative, the params within 1e-6 (Adam's update of a gradient
    that is rounding noise can flip: at most 0.1% of them further, none
    by more than 2 lr x steps), the eval loss within 1e-6."""
    kw = dict(TRAIN, **TRAIN_CASES[case])
    jmet = JaxMetrics(echo=False, capture=True)
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=1, **kw), metrics=jmet)
    init = params_from_jax(jax.device_get(jtr.state["params"]))
    jres = jtr.train()
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    tmet = MetricsLogger(echo=False, capture=True)
    ttr = LMTrainer(LMConfig(device="cpu", **kw), params=init, metrics=tmet)
    tres = ttr.train()
    np.testing.assert_allclose(_losses(tmet.rows), _losses(jmet.rows),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.eval_loss, jres.eval_loss, rtol=LOSS_RTOL)
    diffs = np.concatenate([
        np.abs(t.detach().numpy() - np.asarray(j)).ravel()
        for t, j in zip(tree_leaves(ttr.state["params"]),
                        jax.tree.leaves(jax.device_get(jtr.state["params"])))])
    assert diffs.max() <= 2 * kw["lr"] * kw["steps"]
    assert np.quantile(diffs, 0.999) <= 1e-6


def _keep_only(ck, name):
    for p in ck.glob("ckpt_*.npz"):
        if p.name != name:
            p.unlink()


def test_a_moe_checkpoint_crosses_packages(tmp_path):
    """Each package writes a 4-step MoE run's checkpoints every 2 steps;
    the other resumes from step 2 and ends within 1e-6 of the JAX
    package's uninterrupted run (the loss, and every array of the
    state)."""
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    kw = dict(TRAIN, moe_top_k=2, steps=4)
    full = JaxLMTrainer(JaxLMConfig(num_devices=1, **kw),
                        metrics=JaxMetrics(echo=False))
    init = params_from_jax(jax.device_get(full.state["params"]))
    fres = full.train()
    want = jax.tree.leaves(jax.device_get(full.state))
    ck_j, ck_t = tmp_path / "j", tmp_path / "t"
    JaxLMTrainer(JaxLMConfig(num_devices=1, checkpoint_dir=str(ck_j),
                             checkpoint_every=2, **kw),
                 metrics=JaxMetrics(echo=False)).train()
    _keep_only(ck_j, "ckpt_2.npz")
    t = LMTrainer(LMConfig(device="cpu", checkpoint_dir=str(ck_j),
                           resume=True, **kw), params=init,
                  metrics=MetricsLogger(echo=False))
    tres = t.train()
    assert tres.steps_run == 2
    np.testing.assert_allclose(tres.final_loss, fres.final_loss,
                               rtol=LOSS_RTOL)
    got = [v.detach().numpy() if isinstance(v, torch.Tensor) else v
           for v in checkpoint_arrays(t.state, t.optimizer).values()]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(np.asarray(g, np.float64),
                                   np.asarray(w, np.float64), rtol=0,
                                   atol=1e-6)
    LMTrainer(LMConfig(device="cpu", checkpoint_dir=str(ck_t),
                       checkpoint_every=2, **kw), params=init,
              metrics=MetricsLogger(echo=False)).train()
    _keep_only(ck_t, "ckpt_2.npz")
    jres = JaxLMTrainer(JaxLMConfig(num_devices=1, checkpoint_dir=str(ck_t),
                                    resume=True, **kw),
                        metrics=JaxMetrics(echo=False)).train()
    assert jres.steps_run == 2
    np.testing.assert_allclose(jres.final_loss, fres.final_loss,
                               rtol=LOSS_RTOL)


# The reference trainer's MoE refusals, each with its words.
MOE_REFUSALS = {
    "chunk_without_moe": dict(moe_experts=0, moe_dispatch_chunk=32),
    "dtype_without_moe": dict(moe_experts=0, moe_dispatch_dtype="bfloat16"),
    "bad_dtype": dict(moe_dispatch_dtype="float16"),
    "chunk_with_elastic": dict(moe_dispatch_chunk=32, elastic_width=2),
    "dtype_with_elastic": dict(moe_dispatch_dtype="bfloat16",
                               elastic_width=2),
}


@pytest.mark.parametrize("case", list(MOE_REFUSALS))
def test_moe_flag_refusals_carry_the_references_words(case):
    kw = dict(TRAIN, **MOE_REFUSALS[case])
    with pytest.raises(ValueError) as want:
        JaxLMTrainer(JaxLMConfig(num_devices=1, **kw))
    with pytest.raises(ValueError) as got:
        LMTrainer(LMConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# The commands
# ---------------------------------------------------------------------------


def _capture(logger):
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    return records, handler


LM_ARGV = ["lm", "--device", "cpu", "--corpus", "synthetic", "--dim", "32",
           "--depth", "2", "--heads", "2", "--seq-len", "64",
           "--batch-size", "4", "--steps", "3", "--log-every", "1",
           "--moe-experts", "4", "--moe-top-k", "2",
           "--moe-dispatch-chunk", "32", "--sample-tokens", "16",
           "--sample-speculative-k", "4", "--num-devices", "1"]


def _sample_lines(records):
    return [m for m in records if m.startswith("sample (")]


def test_cli_lm_moe_with_a_speculative_sample_logs_the_jax_line():
    """`lm --moe-experts 4 --moe-top-k 2 --moe-dispatch-chunk 32
    --sample-tokens 16 --sample-speculative-k 4` at a tiny size exits 0
    in both packages and logs the same sample line: both commands draw
    the same seeded weights, train them alike and decode greedily with
    lookup speculation."""
    from mpi_cuda_cnn_tpu.cli import main as jax_main
    from mpi_cuda_cnn_tpu.utils.logging import get_logger as jax_logger

    lines = {}
    for name, run, logger in (
            ("jax", lambda: jax_main(LM_ARGV), jax_logger()),
            ("port", lambda: main(LM_ARGV), get_logger())):
        records, handler = _capture(logger)
        try:
            assert run() == 0
        finally:
            logger.removeHandler(handler)
        lines[name] = _sample_lines(records)
        assert len(lines[name]) == 1
        assert re.match(r"sample \(16 tokens\): b'", lines[name][0])
    assert lines["port"] == lines["jax"]


def test_cli_lm_bench_takes_moe(capsys):
    out = lm_bench(["--device", "cpu", "--dim", "32", "--depth", "1",
                    "--heads", "2", "--vocab", "64", "--seq", "128",
                    "--batch", "2", "--steps", "1", "--quick",
                    "--moe-experts", "2", "--moe-top-k", "2",
                    "--moe-dispatch-chunk", "64"])
    (row,) = out["lines"]
    assert row["moe_dispatch_chunk"] == 64 and np.isfinite(row["loss"])
    assert out["summary"]["model"].endswith("moe2k2")
    model = TransformerLM(vocab=64, dim=32, heads=2, depth=1, max_seq=128,
                          moe_experts=2, moe_top_k=2)
    assert out["summary"]["flops_per_step"] == \
        lm_flops_per_token(model, 128) * 2 * 128
    assert main(["lm-bench", "--device", "cpu", "--dim", "32", "--depth",
                 "1", "--heads", "2", "--vocab", "64", "--seq", "128",
                 "--batch", "2", "--steps", "1", "--moe-experts", "2",
                 "--quick"]) == 0


def test_moe_models_init_the_references_tree():
    cfg = dict(KW, moe_top_k=2)
    jp = JaxLM(**cfg).init(jax.random.key(0))
    tp = TransformerLM(**cfg).init(prng.key(0))
    jflat = jax.tree_util.tree_leaves_with_path(jp)
    tflat = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))
    assert [p for p, _ in jflat] == [p for p, _ in tflat]
    assert [a.shape for _, a in jflat] == [a.shape for _, a in tflat]
    assert dataclasses.replace(TransformerLM(**cfg), moe_experts=0).init(
        prng.key(0))["blocks"][0].keys() >= {"w1", "w2"}
