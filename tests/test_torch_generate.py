"""The port's generation after training (`models/generate.py`,
`data/prng.py`'s samplers, `LMTrainer.sample`, the MoE `PagedEngine`)
against the JAX package's.

Weights go across with `convert.params_from_jax`; prompts come from
numpy seeds; sampling keys are `jax.random.key(seed)` and
`prng.key(seed)`. Tokens are held equal. Where XLA's and PyTorch's
float32 sums could pick another greedy argmax, the serve tests' rule
applies: at the first differing step the two best logits must be within
TIE_GAP, a tie and not a mismatch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models import generate as jgen
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.ops.pallas_gemv import quantize_decode_params as jax_quant
from mpi_cuda_cnn_tpu.serve.bench import make_workload as jax_make_workload
from mpi_cuda_cnn_tpu.serve.engine import PagedEngine as JaxEngine
from mpi_cuda_cnn_tpu.train.lm_trainer import LMTrainer as JaxLMTrainer
from mpi_cuda_cnn_tpu.utils.config import LMConfig as JaxLMConfig
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models import generate as tgen
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops import _kernels
from mpi_cuda_cnn_tpu_torch.ops.gemv import quantize_decode_params
from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine
from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
from mpi_cuda_cnn_tpu_torch.utils.config import LMConfig
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

TIE_GAP = 1e-5
KW = dict(vocab=64, dim=32, heads=4, depth=2, max_seq=64)


def _pair(seed=1, **over):
    cfg = {**KW, **over}
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
    jp = jm.init(jax.random.key(seed))
    return jm, tm, jp, params_from_jax(jax.tree.map(np.asarray, jp))


def _prompt(b=2, s=10, seed=0):
    return np.random.default_rng(seed).integers(0, KW["vocab"], (b, s)) \
        .astype(np.int32)


def _equal_or_tied(got, want, tm, tp, prompt, cache_dtype):
    """Greedy rows equal, or equal up to a first difference at which the
    port's logits (prefill of the prompt and the agreed tokens) have
    their two best within TIE_GAP."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    for r in range(len(got)):
        diff = np.nonzero(got[r] != want[r])[0]
        if not len(diff):
            continue
        t = int(diff[0])
        ctx = np.concatenate([prompt[r], want[r, :t]])[None]
        logits, _ = tgen.prefill(tm, tp, torch.from_numpy(ctx).long(),
                                 cache_dtype)
        top2 = torch.topk(logits[0], 2).values
        assert float(top2[0] - top2[1]) < TIE_GAP, (r, t, top2)


# ---------------------------------------------------------------------------
# The samplers of data/prng.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5])
def test_uniform_gumbel_categorical_match_jax_random(seed):
    k, kn = jax.random.key(seed), prng.key(seed)
    for shape in [(5,), (3, 251), (2, 4, 64)]:
        np.testing.assert_array_equal(prng.uniform(kn, shape),
                                      np.asarray(jax.random.uniform(k, shape)))
        np.testing.assert_array_equal(
            prng.uniform(kn, shape, -2.0, 3.0),
            np.asarray(jax.random.uniform(k, shape, minval=-2.0, maxval=3.0)))
        # -log(-log(u)) of the same u: numpy's and XLA's float32 log may
        # differ in the last place
        np.testing.assert_allclose(prng.gumbel(kn, shape),
                                   np.asarray(jax.random.gumbel(k, shape)),
                                   rtol=1e-6, atol=1e-6)
    logits = np.random.default_rng(seed % 97).standard_normal(
        (64, 251)).astype(np.float32)
    np.testing.assert_array_equal(
        prng.categorical(kn, logits),
        np.asarray(jax.random.categorical(k, jnp.asarray(logits))))


@pytest.mark.parametrize("top_k,top_p", [(5, 0.0), (0, 0.9), (8, 0.5),
                                         (64, 0.99), (100, 0.0), (0, 0.3)])
def test_filter_logits_is_bit_for_bit(top_k, top_p):
    """The kept sets bit for bit. (At top_p 1.0 a tail token of
    probability below 2^-24 is kept or cut by the float32 rounding of a
    mass summing to 1: XLA sums in float32, PyTorch's CPU cumsum
    accumulates in float64.)"""
    rng = np.random.default_rng(top_k)
    logits = rng.standard_normal((3, 2, 64)).astype(np.float32) * 3
    logits[0, 0, :8] = logits[0, 0, 8]               # ties at the boundary
    want = np.asarray(jgen.filter_logits(jnp.asarray(logits), top_k, top_p))
    got = tgen.filter_logits(torch.from_numpy(logits), top_k, top_p).numpy()
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

GREEDY_CASES = [  # (moe, kv heads, pos, cache dtype, weights dtype)
    (0, 0, "learned", "float32", "float32"),
    (0, 2, "rope", "bfloat16", "int8"),
    (0, 1, "learned", "int8", "int8"),
    (0, 0, "rope", "int8", "float32"),
    (4, 0, "learned", "float32", "int8"),
    (4, 2, "rope", "int8", "float32"),
    (4, 2, "learned", "bfloat16", "int8"),
]


@pytest.mark.parametrize("moe,kv,pos,cache,weights", GREEDY_CASES,
                         ids=["-".join(map(str, c)) for c in GREEDY_CASES])
def test_greedy_generate_matches_jax(moe, kv, pos, cache, weights):
    jm, tm, jp, tp = _pair(kv_heads=kv, pos=pos, moe_experts=moe,
                           moe_top_k=2 if moe else 1)
    prompt = _prompt()
    want = jgen.generate(jm, jax_quant(jp, weights), jnp.asarray(prompt), 24,
                         cache_dtype=cache)
    tq = quantize_decode_params(tp, weights)
    before = dict(_kernels.launches)
    got = tgen.generate(tm, tq, torch.from_numpy(prompt).long(), 24,
                        cache_dtype=cache)
    assert _kernels.launches == before    # the CPU takes the plain versions
    _equal_or_tied(got.numpy(), want, tm, tq, prompt, cache)


@pytest.mark.parametrize("cache", ["float32", "int8"])
def test_init_cache_and_decode_steps_match_jax(cache):
    """Token by token from an empty cache (`init_cache`; the JAX
    `decode_step`, the port's one-token `decode_block`), then a 3-token
    `decode_block`: the JAX package's logits."""
    jm, tm, jp, tp = _pair(kv_heads=2, moe_experts=4, moe_top_k=2)
    toks = _prompt(2, 8, seed=4)
    jc = jgen.init_cache(jm, 2, jnp.dtype(cache))
    tc = tgen.init_cache(tm, 2, cache)
    assert [sorted(c) for c in tc] == [sorted(c) for c in jc]
    for i in range(5):
        jl, jc = jgen.decode_step(jm, jp, jnp.asarray(toks[:, i]), i, jc)
        tl, tc = tgen.decode_block(
            tm, tp, torch.from_numpy(toks[:, i:i + 1]).long(), i, tc)
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl), rtol=0,
                                   atol=1e-5)
    jl, _ = jgen.decode_block(jm, jp, jnp.asarray(toks[:, 5:]), 5, jc)
    tl, _ = tgen.decode_block(tm, tp, torch.from_numpy(toks[:, 5:]).long(), 5,
                              tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="out of range"):
        tgen.decode_block(tm, tp, torch.from_numpy(toks).long(), 60, tc)


@pytest.mark.parametrize("moe", [0, 4])
def test_sampled_generate_matches_jax(moe):
    """Temperature 0.8 with top-k and top-p, the same key: the same
    tokens (step i's Gumbel noise from the i-th split of the key)."""
    jm, tm, jp, tp = _pair(moe_experts=moe, moe_top_k=2 if moe else 1,
                           kv_heads=2)
    prompt = _prompt(seed=3)
    opts = dict(temperature=0.8, top_k=12, top_p=0.9)
    want = jgen.generate(jm, jp, jnp.asarray(prompt), 20,
                         key=jax.random.key(11), **opts)
    got = tgen.generate(tm, tp, torch.from_numpy(prompt).long(), 20,
                        key=prng.key(11), **opts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    plain = tgen.generate(tm, tp, torch.from_numpy(prompt).long(), 20,
                          key=prng.key(11), temperature=0.8)
    assert not np.array_equal(plain.numpy(), got.numpy())


def test_generate_validates_as_jax():
    jm, tm, jp, tp = _pair()
    prompt = _prompt()
    for kw in (dict(num_tokens=0), dict(num_tokens=60),
               dict(num_tokens=4, temperature=0.5),
               dict(num_tokens=4, top_k=65, temperature=1.0,
                    key="k"),
               dict(num_tokens=4, top_p=1.5, temperature=1.0, key="k"),
               dict(num_tokens=4, top_k=3)):
        kj = dict(kw, key=jax.random.key(0)) if "key" in kw else kw
        kt = dict(kw, key=prng.key(0)) if "key" in kw else kw
        n = kw["num_tokens"]
        with pytest.raises(ValueError) as want:
            jgen.generate(jm, jp, jnp.asarray(prompt),
                          **{k: v for k, v in kj.items() if k != "num_tokens"},
                          num_tokens=n)
        with pytest.raises(ValueError) as got:
            tgen.generate(tm, tp, torch.from_numpy(prompt).long(),
                          **{k: v for k, v in kt.items() if k != "num_tokens"},
                          num_tokens=n)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Prompt-lookup speculation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("moe,cache", [(0, "float32"), (4, "int8")])
def test_lookup_at_temperature_0_is_generate_and_jax(moe, cache):
    """Greedy lookup: the JAX lookup's tokens and stats, and the port's
    own `generate` (on the CPU both sum the same way, so equal)."""
    jm, tm, jp, tp = _pair(moe_experts=moe, moe_top_k=2 if moe else 1)
    prompt = np.tile(_prompt(1, 6, seed=5), (1, 3))        # repetitive
    want, wstats = jgen.lookup_speculative_generate(
        jm, jp, jnp.asarray(prompt), 24, k=4, cache_dtype=cache,
        return_stats=True)
    got, stats = tgen.lookup_speculative_generate(
        tm, tp, torch.from_numpy(prompt).long(), 24, k=4, cache_dtype=cache,
        return_stats=True)
    plain = tgen.generate(tm, tp, torch.from_numpy(prompt).long(), 24,
                          cache_dtype=cache)
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats and stats["rounds"] < 23


@pytest.mark.parametrize("moe", [0, 4])
def test_lookup_at_temperature_08_matches_jax(moe):
    jm, tm, jp, tp = _pair(moe_experts=moe, moe_top_k=2 if moe else 1)
    prompt = np.tile(_prompt(1, 6, seed=6), (1, 3))
    opts = dict(k=4, temperature=0.8, top_k=20, top_p=0.95)
    want, wstats = jgen.lookup_speculative_generate(
        jm, jp, jnp.asarray(prompt), 20, key=jax.random.key(4),
        return_stats=True, **opts)
    got, stats = tgen.lookup_speculative_generate(
        tm, tp, torch.from_numpy(prompt).long(), 20, key=prng.key(4),
        return_stats=True, **opts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats


def test_lookup_validates_as_jax():
    jm, tm, jp, tp = _pair()
    cases = [(_prompt(2, 6), dict()), (_prompt(1, 6), dict(k=1)),
             (_prompt(1, 1), dict()), (_prompt(1, 6), dict(ngram=0)),
             (_prompt(1, 40), dict(k=8)), (_prompt(1, 6), dict(top_k=2))]
    for prompt, kw in cases:
        with pytest.raises(ValueError) as want:
            jgen.lookup_speculative_generate(jm, jp, jnp.asarray(prompt), 20,
                                             **kw)
        with pytest.raises(ValueError) as got:
            tgen.lookup_speculative_generate(
                tm, tp, torch.from_numpy(prompt).long(), 20, **kw)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# LMTrainer.sample and the sampling flags
# ---------------------------------------------------------------------------

SAMPLE = dict(corpus="synthetic", dim=32, depth=2, heads=4, kv_heads=2,
              seq_len=64, batch_size=4, steps=2, warmup_steps=1, lr=3e-3,
              attn_impl="oracle", log_every=1, moe_experts=4, moe_top_k=2,
              sample_tokens=12)
SAMPLE_CASES = {
    "greedy_int8": (dict(decode_weights_dtype="int8",
                         decode_cache_dtype="auto"), 0.0),
    "lookup": (dict(sample_speculative_k=4), 0.0),
    "sampled_top_k": (dict(sample_temperature=0.8, sample_top_k=10), 0.8),
    "lookup_sampled": (dict(sample_speculative_k=4, sample_temperature=0.8,
                            sample_top_p=0.9), 0.8),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_trainer_sample_matches_jax(case):
    """The same trained weights (the port's params set to the JAX
    trainer's after its steps): the same prompt and continuation."""
    flags, temperature = SAMPLE_CASES[case]
    kw = dict(SAMPLE, **flags)
    jtr = JaxLMTrainer(JaxLMConfig(num_devices=1, **kw))
    jtr.train()
    ttr = LMTrainer(LMConfig(device="cpu", **kw), params=params_from_jax(
        jax.device_get(jtr.state["params"])))
    jp, jc = jtr.sample(12, temperature=temperature, seed=3)
    tp, tc = ttr.sample(12, temperature=temperature, seed=3)
    np.testing.assert_array_equal(tp, jp)
    assert tc.dtype == np.int32
    np.testing.assert_array_equal(tc, jc)


# (flags, each with --sample-tokens 0 as well: checked at construction)
FLAG_REFUSALS = {
    "tokens_negative": dict(sample_tokens=-1),
    "tokens_at_seq_len": dict(sample_tokens=64),
    "cache_dtype": dict(decode_cache_dtype="bf16"),
    "weights_dtype": dict(decode_weights_dtype="fp8"),
    "top_k_negative": dict(sample_top_k=-1, sample_temperature=1.0),
    "top_p_above_1": dict(sample_top_p=1.5, sample_temperature=1.0),
    "top_k_greedy": dict(sample_top_k=5),
    "top_p_greedy": dict(sample_top_p=0.5),
    "speculative_k_1": dict(sample_speculative_k=1),
    "speculative_slack": dict(sample_tokens=56, sample_speculative_k=8),
}


@pytest.mark.parametrize("case", list(FLAG_REFUSALS))
def test_sampling_flags_fail_at_construction_with_the_references_words(case):
    kw = dict(SAMPLE, sample_tokens=0)
    kw.update(FLAG_REFUSALS[case])
    with pytest.raises(ValueError) as want:
        JaxLMTrainer(JaxLMConfig(num_devices=1, **kw))
    with pytest.raises(ValueError) as got:
        LMTrainer(LMConfig(device="cpu", **kw))
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# Serving an MoE model
# ---------------------------------------------------------------------------

WORKLOAD = dict(n=5, vocab=64, prompt_min=3, prompt_max=20, out_min=2,
                out_max=12, rate=0.0)


@pytest.mark.parametrize("cache,weights,jax_read", [
    ("float32", "float32", "gather"), ("int8", "int8", "pallas")],
    ids=["f32", "int8"])
def test_moe_engine_matches_jax(cache, weights, jax_read):
    """A PagedEngine over an MoE model (token_forward's MoE branch: every
    expert, no drop): the JAX engine's tokens and state_crc."""
    jm, tm, jp, tp = _pair(moe_experts=4, moe_top_k=2, kv_heads=2)
    kw = dict(slots=3, num_pages=16, page_size=8, prefill_chunk=4,
              cache_dtype=cache, max_len=40, weights_dtype=weights)
    want = JaxEngine(jm, jp, attn_kernel=jax_read, **kw).run(
        jax_make_workload(seed=2, **WORKLOAD))
    got = PagedEngine(tm, tp, attn_kernel="cuda", device="cpu", **kw).run(
        make_workload(seed=2, **WORKLOAD))
    for a, b in zip(want.requests, got.requests):
        assert b.status == a.status == "finished"
        assert b.out == a.out, f"request {a.rid}"
    assert got.state_crc == want.state_crc


def test_moe_decode_weights_keep_the_experts_float32():
    _, tm, _, tp = _pair(moe_experts=4, moe_top_k=2)
    q = quantize_decode_params(tp, "int8")
    blk = q["blocks"][0]
    assert type(blk["wqkv"]).__name__ == "QuantW"
    assert all(t.dtype == torch.float32 for t in blk["moe"].values())
    assert dataclasses.replace(tm, moe_experts=0).moe_experts == 0
