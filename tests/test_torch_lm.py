"""The port's LM training path against the JAX package: the model's
training forward, AdamW, the train step, the trainer, and the `lm` /
`lm-bench` commands.

Weights go from the JAX package to the port through
`convert.params_from_jax`; batches come from numpy. The JAX flash kernel
runs in Pallas interpret mode on the CPU; the port runs its kernels'
plain versions (CPU tensors).
"""

import json
import logging
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.train.lm import count_params as jax_count_params
from mpi_cuda_cnn_tpu.train.lm import lm_flops_per_token as jax_flops
from mpi_cuda_cnn_tpu.train.lm import make_lm_state as jax_make_state
from mpi_cuda_cnn_tpu.train.lm import make_lm_train_step as jax_make_step
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.train.optimizer import make_optimizer as jax_make_opt
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu_torch.cli import main
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.ops.flash_attention import MAX_HEAD_DIM
from mpi_cuda_cnn_tpu_torch.train.lm import (
    count_params,
    lm_flops_per_token,
    make_lm_state,
    make_lm_train_step,
    pick_attn_impl,
)
from mpi_cuda_cnn_tpu_torch.train.lm_bench import lm_bench, lm_bench_main
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer, load_corpus
from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig, parse_lm_args
from mpi_cuda_cnn_tpu_torch.utils.logging import get_logger
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

# One forward from equal params. float32: sums in other orders, about
# 1e-6 of the logits (measured 1.9e-6 of 3.4); the erf form of gelu is
# 9e-4 away, so this bound tells the two apart. bf16: the residual stream
# and the logits carry 8 bits of mantissa; rounding at other points moves
# a logit by an ulp or two (0.03 at 3.4).
FWD_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
# AdamW / SGD updates of equal gradients: the same roundings, but the
# bias corrections' powers and the square root come from other libraries
# (measured up to 6e-8 on params of order 1).
OPT_ATOL = 1e-6
# Train steps from equal params: per-step losses within 1e-5 relative
# (float32; sums in other orders). Params: Adam divides each update by
# the root of its second moment, so a gradient near 0 (rounding noise)
# gets an update of size lr whose sign is noise: only a bound of
# 2 * lr * steps holds everywhere; everywhere else the params agree far
# closer, so 99.9% of them are held to 1e-5 of lr.
LOSS_RTOL = 1e-5
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=128)


def _pair(**kw):
    cfg = {**KW, **kw}
    return JaxLM(**cfg), TransformerLM(**cfg)


def _tokens(b, s, vocab, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)).astype(np.int32)


def _close(got, want, rtol_of_max):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    assert got.shape == want.shape
    err, tol = np.abs(got - want).max(), rtol_of_max * np.abs(want).max()
    assert err <= tol, (err, tol)
    return err


# ---------------------------------------------------------------------------
# The model's training forward
# ---------------------------------------------------------------------------

APPLY_CASES = [  # (pos, kv heads, dtype, return_features, remat)
    ("learned", 0, "float32", False, False),
    ("rope", 2, "float32", False, True),
    ("learned", 2, "bfloat16", False, False),
    ("rope", 0, "bfloat16", True, False),
    ("learned", 1, "float32", True, True),
]


@pytest.mark.parametrize("pos,kv,dtype,features,remat", APPLY_CASES,
                         ids=["-".join(map(str, c)) for c in APPLY_CASES])
def test_apply_matches_jax(pos, kv, dtype, features, remat):
    jm, tm = _pair(pos=pos, kv_heads=kv)
    jp = jm.init(jax.random.key(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = _tokens(2, 32, KW["vocab"])
    jcd = jnp.bfloat16 if dtype == "bfloat16" else None
    tcd = torch.bfloat16 if dtype == "bfloat16" else None
    want = jax.jit(lambda p, t: jm.apply(p, t, compute_dtype=jcd, remat=remat,
                                         return_features=features))(
        jp, jnp.asarray(toks))
    got, aux = tm.apply(tp, torch.from_numpy(toks), compute_dtype=tcd,
                        remat=remat, return_features=features,
                        return_aux=True)
    assert float(aux) == 0.0
    assert got.dtype == (tcd if features and tcd else torch.float32)
    _close(got, want, FWD_TOL[dtype])


def test_the_gelu_is_the_tanh_form(monkeypatch):
    """jax.nn.gelu defaults to approximate=True. The f32 parity bound
    above is tight enough to tell: with the erf form it fails."""
    jm, tm = _pair()
    jp = jm.init(jax.random.key(2))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    toks = _tokens(2, 32, KW["vocab"], seed=1)
    want = jax.jit(jm.apply)(jp, jnp.asarray(toks))
    _close(tm.apply(tp, torch.from_numpy(toks)), want, FWD_TOL["float32"])
    erf = F.gelu
    monkeypatch.setattr(F, "gelu", lambda x, approximate="none": erf(x))
    with pytest.raises(AssertionError):
        _close(tm.apply(tp, torch.from_numpy(toks)), want, FWD_TOL["float32"])


def test_apply_refuses_what_the_port_lacks():
    _, tm = _pair()
    tp = tm.init(prng.key(0))
    with pytest.raises(ValueError, match="exceeds max_seq"):
        tm.apply(tp, torch.zeros((1, 256), dtype=torch.int32))


def test_flops_and_param_count_match_jax():
    for kv, moe, k in ((0, 0, 1), (2, 0, 1), (0, 4, 1), (2, 4, 2)):
        jm, tm = _pair(kv_heads=kv, moe_experts=moe, moe_top_k=k)
        assert lm_flops_per_token(tm, 2048) == jax_flops(jm, 2048)
        assert count_params(tm.init(prng.key(0))) == \
            jax_count_params(jm.init(jax.random.key(0)))
    flagship = TransformerLM(vocab=8192, dim=512, heads=8, depth=8,
                             max_seq=2048)
    assert count_params(flagship.init(prng.key(0), "meta")) \
        == 34_620_416


def test_pick_attn_impl():
    assert pick_attn_impl("auto", 2048, "cuda") == "flash"
    assert pick_attn_impl("auto", 1024, torch.device("cuda", 0)) == "flash"
    assert pick_attn_impl("auto", 2000, "cuda") == "oracle"
    assert pick_attn_impl("auto", 2048, "cpu") == "oracle"
    assert pick_attn_impl("flash", 2048, "cpu") == "flash"
    assert pick_attn_impl("oracle", 2048, "cuda") == "oracle"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("head_dim", [16, 32, 64, 96, 128, 256])
def test_pick_attn_impl_auto_follows_the_kernels_head_dims(head_dim, device):
    """"auto" takes the flash kernels for every head dim they take (up to
    256, zero-padded to their next instance), on a CUDA device, and the
    oracle beyond (320); an explicit "flash" stays flash (the kernels then
    refuse a head dim beyond 256 themselves)."""
    assert MAX_HEAD_DIM == 256
    for d in (head_dim, head_dim + 1 if head_dim < 256 else 320):
        want = "flash" if device == "cuda" and d <= 256 else "oracle"
        assert pick_attn_impl("auto", 2048, device, d) == want
        assert pick_attn_impl("auto", 2048, device, head_dim=d) == want
        assert pick_attn_impl("flash", 2048, device, d) == "flash"
        assert pick_attn_impl("oracle", 2048, device, d) == "oracle"


def test_lm_callers_pass_the_model_head_dim(monkeypatch):
    """Both callers of pick_attn_impl hand it the model's head dim, so
    that "auto" never resolves to kernels that are not built for it:
    `lm --dim 32 --heads 2` and `--dim 256 --heads 16` (head dim 16)."""
    import mpi_cuda_cnn_tpu_torch.train.lm as lm_mod
    import mpi_cuda_cnn_tpu_torch.train.lm_trainer as trainer_mod

    seen = []

    def spy(impl, seq_len, device="cuda", head_dim=None):
        seen.append(head_dim)
        return pick_attn_impl(impl, seq_len, device, head_dim)

    monkeypatch.setattr(lm_mod, "pick_attn_impl", spy)
    monkeypatch.setattr(trainer_mod, "pick_attn_impl", spy)
    trainer = LMTrainer(parse_lm_args(TINY))   # dim 32 over 2 heads
    assert trainer.attn_impl == "oracle"     # the CPU
    assert seen == [16, 16]
    seen.clear()
    model = TransformerLM(vocab=64, dim=256, heads=16, depth=1, max_seq=128)
    opt = make_optimizer(1e-3, opt="adamw", schedule="constant")
    make_lm_train_step(model, opt, attn_impl="auto", seq_len=128,
                       device="cpu")
    assert seen == [16]


# ---------------------------------------------------------------------------
# AdamW and SGD against optax
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(opt="adamw", schedule="cosine", total_steps=8, warmup_steps=3,
         weight_decay=0.01),
    dict(opt="adamw", schedule="cosine", total_steps=5, grad_clip=0.5),
    dict(opt="adamw"),
    dict(opt="sgd", weight_decay=0.1),
    dict(opt="sgd", weight_decay=0.05, momentum=0.9, schedule="cosine",
         total_steps=6),
], ids=["adamw_warmup_cosine_wd", "adamw_cosine_clip", "adamw", "sgd_wd",
        "sgd_wd_momentum_cosine"])
def test_optimizer_matches_optax(kw):
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (4,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jax_make_opt(0.1, **kw)
    jp = [jnp.asarray(p) for p in params]
    state = tx.init(jp)
    opt = make_optimizer(0.1, **kw)
    tp = [torch.from_numpy(p.copy()) for p in params]
    tstate = opt.init(tp)
    for _ in range(8):
        gs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        updates, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, updates)
        opt.update(tp, [torch.from_numpy(g) for g in gs], tstate)
        for t, j in zip(tp, jp):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                       atol=OPT_ATOL)
    assert tstate["count"] == 8
    with pytest.raises(ValueError, match="momentum"):
        make_optimizer(0.1, opt="adamw", momentum=0.9)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_CASES = [  # (attn, seq, ce_chunk, dtype)
    ("oracle", 64, 0, "float32"),
    ("oracle", 64, 16, "float32"),
    ("flash", 128, 0, "float32"),
    ("oracle", 64, 0, "bfloat16"),
]
STEPS, LR = 3, 3e-3


@pytest.mark.parametrize("attn,seq,ce,dtype", STEP_CASES,
                         ids=["-".join(map(str, c)) for c in STEP_CASES])
def test_train_steps_match_jax(attn, seq, ce, dtype):
    """STEPS AdamW steps from the JAX package's make_lm_state params on
    both sides, the same batches; the flash case runs the JAX kernel in
    interpret mode and the port's kernels' plain versions."""
    jm, tm = _pair(kv_heads=2)
    kw = dict(opt="adamw", schedule="cosine", total_steps=10, warmup_steps=2,
              weight_decay=0.01)
    jopt, topt = jax_make_opt(LR, **kw), make_optimizer(LR, **kw)
    jstate = jax_make_state(jm, jopt, seed=3)
    tstate = make_lm_state(tm, topt, params=params_from_jax(
        jax.device_get(jstate["params"])))
    jcd = jnp.bfloat16 if dtype == "bfloat16" else None
    tcd = torch.bfloat16 if dtype == "bfloat16" else None
    jstep = jax_make_step(jm, jopt, attn_impl=attn, seq_len=seq,
                          compute_dtype=jcd, ce_chunk=ce, donate=False)
    tstep = make_lm_train_step(tm, topt, attn_impl=attn, seq_len=seq,
                               device="cpu", compute_dtype=tcd, ce_chunk=ce)
    before = dict(_kernels.launches)
    for i in range(STEPS):
        toks = _tokens(2, seq + 1, KW["vocab"], seed=10 + i)
        jstate, jm_ = jstep(jstate, jnp.asarray(toks[:, :-1]),
                            jnp.asarray(toks[:, 1:]))
        tstate, tm_ = tstep(tstate, torch.from_numpy(toks[:, :-1]),
                            torch.from_numpy(toks[:, 1:]))
        np.testing.assert_allclose(float(tm_["loss"]), float(jm_["loss"]),
                                   rtol=LOSS_RTOL if dtype == "float32"
                                   else 1e-2)
    assert tstate["step"] == STEPS and _kernels.launches == before
    diffs = np.concatenate([
        np.abs(t.detach().numpy() - np.asarray(j)).ravel()
        for t, j in zip(tree_leaves(tstate["params"]),
                        jax.tree.leaves(jax.device_get(jstate["params"])))])
    assert diffs.max() <= 2 * LR * STEPS
    if dtype == "float32":
        assert np.quantile(diffs, 0.999) <= 1e-5 * LR


# ---------------------------------------------------------------------------
# The trainer
# ---------------------------------------------------------------------------


def _configs(corpus, **kw):
    base = dict(corpus=corpus, dim=32, depth=1, heads=2, seq_len=64,
                batch_size=4, steps=4, warmup_steps=20, lr=3e-3,
                attn_impl="oracle", log_every=2, **kw)
    return JaxLMConfig(num_devices=1, **base), LMConfig(device="cpu", **base)


@pytest.fixture(scope="module")
def text_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("corpus") / "text.txt"
    words = np.random.default_rng(7).choice(
        ["the", "model", "reads", "a", "stream", "of", "bytes", "and",
         "learns", "what", "comes", "next", "."], size=2000)
    path.write_text(" ".join(words))
    return str(path)


@pytest.mark.parametrize("corpus", ["synthetic", "file"])
def test_trainer_matches_the_jax_trainer(corpus, text_file, caplog):
    """Same windows (bitwise), same steps, same final and eval losses; the
    warm-up of 20 over 4 steps is clamped to 3 on both sides."""
    spec = text_file if corpus == "file" else corpus
    jcfg, tcfg = _configs(spec)
    jtr = JaxLMTrainer(jcfg)
    init = jax.device_get(jtr.state["params"])
    ttr = LMTrainer(tcfg, params=params_from_jax(init))
    assert ttr.warmup_steps == 3 and ttr.attn_impl == "oracle"
    assert ttr.model.vocab == jtr.model.vocab
    np.testing.assert_array_equal(ttr.eval_tokens, jtr.eval_tokens)
    for step in (0, 1, 7):
        for a, b in zip(ttr._sample_batch(step), jtr._sample_batch(step)):
            np.testing.assert_array_equal(a, np.asarray(b))
    jres, tres = jtr.train(), ttr.train()
    assert tres.steps_run == jres.steps_run == 4
    np.testing.assert_allclose(tres.final_loss, jres.final_loss, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tres.eval_loss, jres.eval_loss, rtol=LOSS_RTOL)
    assert tres.tokens_per_s > 0 and np.isfinite(tres.eval_ppl)


def test_load_corpus(tmp_path):
    assert load_corpus("synthetic")[:3].tolist() == [0, 1, 2]
    own = load_corpus("self")      # the port's own sources, not the JAX package's
    assert own.dtype == np.int32 and len(own) > 1 << 16 and own.max() < 256
    small = tmp_path / "small.txt"
    small.write_text("too short")
    with pytest.raises(ValueError, match="too small"):
        load_corpus(str(small))


# ---------------------------------------------------------------------------
# The commands
# ---------------------------------------------------------------------------

TINY = ["--device", "cpu", "--corpus", "synthetic", "--dim", "32", "--depth",
        "1", "--heads", "2", "--seq-len", "128", "--batch-size", "2",
        "--steps", "3", "--log-every", "1"]
BENCH_TINY = ["--device", "cpu", "--dim", "32", "--depth", "1", "--heads",
              "2", "--vocab", "64", "--seq", "128", "--batch", "2",
              "--steps", "1"]


@pytest.fixture
def log_lines():
    """Records of the port's logger (it does not propagate to root; set
    up first, so that it keeps its INFO level)."""
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = get_logger()
    logger.addHandler(handler)
    yield records
    logger.removeHandler(handler)


def test_cli_lm_runs_on_the_cpu(log_lines):
    assert main(["lm", *TINY]) == 0
    assert any(re.match(r"lm done: steps=3 loss=[\d.]+ eval_loss=[\d.]+", m)
               for m in log_lines)
    assert main(["lm", *TINY, "--no-such-flag"]) == 2
    assert main(["lm", *TINY, "--compute-dtype", "float16"]) == 2
    assert main(["lm", *TINY, "--ce-chunk", "48"]) == 2


def test_cli_lm_bench_runs_on_the_cpu(capsys):
    assert main(["lm-bench", *BENCH_TINY]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rows, summary = lines[:-1], lines[-1]
    assert [(r["dtype"], r["attn"], r["ce_chunk"]) for r in rows] == [
        ("float32", "oracle", 0), ("float32", "flash", 0),
        ("bfloat16", "oracle", 0), ("bfloat16", "flash", 0),
        ("bfloat16", "flash", 128)]
    assert all(r["bench"] == "lm_pretrain" and r["mfu"] is None
               and set(r["kernel_launches"].values()) == {0} for r in rows)
    assert summary["metric"] == "lm_tokens_per_s" and summary["value"] > 0
    assert summary["device"] == "cpu" and summary["params"] > 0
    out = lm_bench(BENCH_TINY + ["--quick"])
    assert len(out["lines"]) == 1 and out["lines"][0]["attn"] == "flash"


@pytest.mark.parametrize("argv,says", [
    (["--fsdp"], "--fsdp needs a 'data' mesh axis of size > 1")],
    ids=["fsdp"])
def test_lm_refusals_exit_2_naming_queue_f(argv, says, log_lines):
    """--fsdp is ported; without a data axis of size > 1 it is the
    reference trainer's ValueError, exit 2."""
    assert main(["lm", *TINY, *argv]) == 2
    assert any(says in m for m in log_lines)
    with pytest.raises(ValueError, match=re.escape(says)):
        LMTrainer(parse_lm_args([*TINY, *argv]))


@pytest.mark.parametrize("argv,says", [
    (["--mesh-shape", "model:2,seq:2", "--fsdp"],
     "--fsdp does not compose with the TP x SP shard_map step"),
    (["--mesh-shape", "pipe:2"], "depth 1 not divisible by pipe-axis size 2"),
    (["--mesh-shape", "seq:2", "--moe-experts", "2",
      "--moe-dispatch-chunk", "8"],
     "--moe-dispatch-chunk is the SINGLE-DEVICE (or pure-DP)"),
    (["--attn-impl", "ring"], "unknown attention impl 'ring'"),
    (["--attn-impl", "ulysses"], "unknown attention impl 'ulysses'")],
    ids=["model_mesh", "pipe_mesh", "seq_mesh", "ring", "ulysses"])
def test_lm_mesh_and_attention_refusals(argv, says, log_lines):
    """The model, pipe and seq axes are ported; what the reference's
    trainer refuses on them (FSDP under TP x SP, a depth the pipe axis
    does not divide, a dispatch chunk under a seq axis), and a
    sequence-parallel attention without a seq axis, are its ValueErrors,
    in its words. Exit 2 either way."""
    assert main(["lm", *TINY, *argv]) == 2
    assert any(says in m for m in log_lines)


def test_lm_bench_refusals(capsys):
    """--grad-accum N and --accum-dtype run on both dtypes, the rows
    carrying the reference's fields (float32 normalizes to the default
    exact sum, as there); a --grad-accum that does not divide the batch
    exits 2."""
    assert lm_bench_main([*BENCH_TINY, "--grad-accum", "3"]) == 2
    assert "not divisible by grad_accum 3" in capsys.readouterr().err
    for dtype, field, rows_of in (("bfloat16", "bfloat16",
                                   {"float32", "bfloat16"}),
                                  ("float32", None, {"bfloat16"})):
        quick = [] if dtype == "bfloat16" else ["--quick"]
        assert lm_bench_main([*BENCH_TINY, *quick, "--grad-accum", "2",
                              "--accum-dtype", dtype]) == 0
        lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
        rows = lines[:-1]
        assert {r["dtype"] for r in rows} == rows_of
        for r in rows:
            assert r["grad_accum"] == 2 and r.get("accum_dtype") == field
            assert np.isfinite(r["loss"])


@pytest.mark.parametrize("compute,accum,tol", [
    ("bfloat16", "bfloat16", 2e-2), ("float32", None, 1e-5)],
    ids=["bf16_accum_bf16", "f32_accum_f32"])
def test_grad_accum_grads_match_the_reference(compute, accum, tol):
    """First-step gradients at --grad-accum 2 against the reference's
    accumulation (`dp.local_grads_no_aux`, the helper its
    make_lm_train_step runs), from one init, per leaf in relative L2."""
    from mpi_cuda_cnn_tpu.parallel.dp import local_grads_no_aux
    from mpi_cuda_cnn_tpu.train.lm import lm_loss as jax_lm_loss

    jm, tm = _pair()
    jparams = jm.init(jax.random.key(0))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, tm.vocab, (4, 65)).astype(np.int32)
    jcd = None if compute == "float32" else jnp.bfloat16
    _, jg = jax.jit(lambda p, x, y: local_grads_no_aux(
        lambda p_, a, b: jax_lm_loss(jm, p_, a, b, compute_dtype=jcd),
        p, x, y, 2, None if accum is None else jnp.bfloat16))(
        jparams, toks[:, :-1], toks[:, 1:])
    opt = make_optimizer(1e-3, opt="adamw", schedule="constant")
    step = make_lm_train_step(
        tm, opt, attn_impl="oracle", seq_len=64, device="cpu",
        compute_dtype=None if compute == "float32" else torch.bfloat16,
        grad_accum=2, accum_dtype=None if accum is None else torch.bfloat16)
    state = make_lm_state(tm, opt, params=params_from_jax(
        jax.tree.map(np.asarray, jparams)))
    tg, _ = step.grads(state, torch.from_numpy(toks[:, :-1]),
                       torch.from_numpy(toks[:, 1:]))
    for got, want in zip(tg, jax.tree.leaves(jg), strict=True):
        want = np.asarray(want, np.float32)
        assert got.dtype == torch.float32 and got.shape == want.shape
        rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
        assert rel <= tol, rel


@pytest.fixture
def no_gpu(monkeypatch):
    """A machine without a card, whatever this one has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_lm_entry_points_refuse_to_fall_back_to_cpu(no_gpu, capsys, log_lines):
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    assert main(["lm", *argv]) == 2
    assert any("CUDA device requested" in m for m in log_lines)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        LMTrainer(LMConfig(corpus="synthetic"))
    bench_argv = [a for a in BENCH_TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        lm_bench(bench_argv)
    assert lm_bench_main(bench_argv) == 1
    captured = capsys.readouterr()
    assert captured.out == ""            # no result line
    assert "CUDA device requested" in captured.err
