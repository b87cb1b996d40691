"""The port's draft-model speculative decoding (`models/generate.py`
`speculative_generate`) and its bench (`bench/speculative.py`,
`spec-bench`) against the JAX package's `speculative_generate` and
`scripts/bench_speculative.py`.

A target of depth 2, dim 32 and a draft of depth 1, dim 16 carry the
JAX package's seeded weights over (`convert.params_from_jax`); prompts
come from numpy seeds, keys are `jax.random.key(seed)` and
`prng.key(seed)`. Held equal: the tokens and the stats (verify rounds,
mean accepted) greedy at k 2 and 4 (float32 and int8 weights, an int8
cache, and the target as its own draft, which accepts every proposal),
and at temperature 0.8 with top-k and top-p for the same key; greedy
tokens also equal the port's own `generate`; the reference's
ValueErrors word for word. `spec-bench --device cpu` at tiny flags
prints the reference's rows with their keys, and its greedy rows pass
the in-run exactness check.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mpi_cuda_cnn_tpu.models import generate as jgen
from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
from mpi_cuda_cnn_tpu.ops.pallas_gemv import quantize_decode_params as jax_quant
from mpi_cuda_cnn_tpu_torch.bench.speculative import spec_bench
from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
from mpi_cuda_cnn_tpu_torch.data import prng
from mpi_cuda_cnn_tpu_torch.models import generate as tgen
from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
from mpi_cuda_cnn_tpu_torch.ops.gemv import quantize_decode_params
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

VOCAB = 64
TARGET = dict(vocab=VOCAB, dim=32, heads=4, depth=2, max_seq=64)
DRAFT = dict(vocab=VOCAB, dim=16, heads=2, depth=1, max_seq=64)
TOKENS = 20


def _model(cfg: dict, seed: int, weights: str = "float32"):
    jm, tm = JaxLM(**cfg), TransformerLM(**cfg)
    jp = jm.init(jax.random.key(seed))
    tp = params_from_jax(jax.tree.map(np.asarray, jp))
    if weights != "float32":
        jp, tp = jax_quant(jp, weights), quantize_decode_params(tp, weights)
    return jm, tm, jp, tp


def _prompt(s: int = 8, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, VOCAB, (1, s)) \
        .astype(np.int32)


GREEDY = [(2, "float32", "float32", False), (4, "float32", "float32", False),
          (4, "int8", "float32", False), (2, "float32", "int8", False),
          (4, "float32", "float32", True)]


@pytest.mark.parametrize("k,weights,cache,self_draft", GREEDY,
                         ids=[f"k{k}-{w}-{c}" + ("-self" if s else "")
                              for k, w, c, s in GREEDY])
def test_greedy_matches_jax_and_generate(k, weights, cache, self_draft):
    jm, tm, jp, tp = _model(TARGET, 1, weights)
    jd, td, jdp, tdp = ((jm, tm, jp, tp) if self_draft
                        else _model(DRAFT, 2, weights))
    prompt = _prompt(seed=k)
    want, wstats = jgen.speculative_generate(
        jm, jp, jd, jdp, jnp.asarray(prompt), TOKENS, k=k, cache_dtype=cache,
        return_stats=True)
    got, stats = tgen.speculative_generate(
        tm, tp, td, tdp, torch.from_numpy(prompt).long(), TOKENS, k=k,
        cache_dtype=cache, return_stats=True)
    plain = tgen.generate(tm, tp, torch.from_numpy(prompt).long(), TOKENS,
                          cache_dtype=cache)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), plain.numpy())
    assert stats == wstats
    if self_draft:   # every proposal accepted: k tokens a round
        assert stats["rounds"] == -(-(TOKENS - 1) // k)


@pytest.mark.parametrize("k", [2, 4])
def test_sampled_matches_jax(k):
    """Temperature 0.8 with top-k and top-p, the same key: the draft's
    samples, the acceptances, the residual and bonus draws are the JAX
    run's, so the tokens and the stats are."""
    jm, tm, jp, tp = _model(TARGET, 3)
    jd, td, jdp, tdp = _model(DRAFT, 4)
    prompt = _prompt(seed=10 + k)
    opts = dict(k=k, temperature=0.8, top_k=24, top_p=0.95)
    want, wstats = jgen.speculative_generate(
        jm, jp, jd, jdp, jnp.asarray(prompt), TOKENS, key=jax.random.key(5),
        return_stats=True, **opts)
    got, stats = tgen.speculative_generate(
        tm, tp, td, tdp, torch.from_numpy(prompt).long(), TOKENS,
        key=prng.key(5), return_stats=True, **opts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert stats == wstats


def test_speculative_validates_as_jax():
    jm, tm, jp, tp = _model(TARGET, 1)
    jd, td, jdp, tdp = _model(DRAFT, 2)
    jo, to, jop, top = _model({**DRAFT, "vocab": 32}, 2)
    jshort, tshort = JaxLM(**{**DRAFT, "max_seq": 30}), \
        TransformerLM(**{**DRAFT, "max_seq": 30})
    cases = [  # (prompt, tokens, draft pair, kwargs)
        (_prompt().repeat(2, 0), 8, (jd, td, jdp, tdp), {}),
        (_prompt(), 0, (jd, td, jdp, tdp), {}),
        (_prompt(), 8, (jd, td, jdp, tdp), dict(k=1)),
        (_prompt(), 8, (jo, to, jop, top), {}),
        (_prompt(), 52, (jd, td, jdp, tdp), dict(k=8)),
        (_prompt(), 20, (jshort, tshort, jdp, tdp), dict(k=4)),
        (_prompt(), 8, (jd, td, jdp, tdp), dict(temperature=0.5)),
        (_prompt(), 8, (jd, td, jdp, tdp), dict(top_k=3)),
    ]
    for prompt, n, (jd_, td_, jdp_, tdp_), kw in cases:
        with pytest.raises(ValueError) as want:
            jgen.speculative_generate(jm, jp, jd_, jdp_, jnp.asarray(prompt),
                                      n, **kw)
        with pytest.raises(ValueError) as got:
            tgen.speculative_generate(tm, tp, td_, tdp_,
                                      torch.from_numpy(prompt).long(), n,
                                      **kw)
        assert str(got.value) == str(want.value)


# The rows of scripts/bench_speculative.py and their keys (its
# `json.dumps` calls), with --self-corpus-steps > 0.
REF_GREEDY = {"bench", "mode", "ms_per_tok", "tokens_per_s", "mean_accepted",
              "speedup_vs_plain", "greedy_exact"}
REF_SAMPLED = REF_GREEDY - {"greedy_exact"}
REF_ROWS = {
    "plain_greedy": {"bench", "mode", "ms_per_tok", "tokens_per_s",
                     "target_loss", "draft_loss"},
    "draft_k2": REF_GREEDY, "draft_k4": REF_GREEDY,
    "lookup_k2": REF_GREEDY, "lookup_k4": REF_GREEDY,
    "plain_sample_T0.8": {"bench", "mode", "ms_per_tok", "tokens_per_s"},
    "draft_k2_T0.8": REF_SAMPLED, "draft_k4_T0.8": REF_SAMPLED,
    "lookup_k2_T0.8": REF_SAMPLED, "lookup_k4_T0.8": REF_SAMPLED,
    "self_corpus_lookup_k8": {"bench", "mode", "train_steps", "train_loss",
                              "plain_ms_per_tok", "ms_per_tok",
                              "mean_accepted", "speedup_vs_plain",
                              "greedy_exact"},
    "random_draft_k4": {"bench", "mode", "ms_per_tok", "mean_accepted",
                        "speedup_vs_plain"},
}
REF_SUMMARY = {"schema", "event", "t", "metric", "value", "unit", "config",
               "plain_tokens_per_s", "model", "backend"}


def test_spec_bench_prints_the_references_rows(capsys):
    res = spec_bench(["--device", "cpu", "--dim", "32", "--depth", "1",
                      "--heads", "2", "--draft-dim", "16", "--vocab", "32",
                      "--max-seq", "544", "--prompt", "8", "--tokens", "8",
                      "--ks", "2,4", "--train-steps", "20",
                      "--self-corpus-steps", "1"])
    lines = [json.loads(x) for x in
             capsys.readouterr().out.splitlines()]
    assert lines[:-1] == res["rows"] and lines[-1] == res["summary"]
    got = {r["mode"]: set(r) - {"suspect_fast"} for r in res["rows"]}
    assert got == REF_ROWS
    assert set(res["summary"]) == REF_SUMMARY
    # the in-run check: every greedy row's tokens are plain greedy's
    assert all(r["greedy_exact"] for r in res["rows"] if "greedy_exact" in r)
    # the trained pair accepts more than the random draft
    assert res["stats"]["draft_k4"]["mean_accepted"] > \
        res["stats"]["random_draft_k4"]["mean_accepted"]


def test_spec_bench_reuses_a_trained_pair_untimed(capsys):
    """`trained` (an earlier run's pair) skips the training, and `timed`
    False runs every mode's one call alone: the same modes, counts and
    tokens as the timed run, rows with no time keys, the in-run check
    still holding (the int8 run of chip_smoke's spec_generate)."""
    argv = ["--device", "cpu", "--dim", "32", "--depth", "1", "--heads",
            "2", "--draft-dim", "16", "--vocab", "32", "--max-seq", "544",
            "--prompt", "8", "--tokens", "8", "--ks", "2,4",
            "--train-steps", "20", "--self-corpus-steps", "0"]
    first = spec_bench(argv)
    again = spec_bench(argv, trained=first["trained"], timed=False)
    capsys.readouterr()
    assert again["trained"] is first["trained"]
    assert again["stats"] == first["stats"]
    assert [r["mode"] for r in again["rows"]] == [
        r["mode"] for r in first["rows"] if "skipped" not in r]
    times = {"ms_per_tok", "tokens_per_s", "speedup_vs_plain",
             "plain_ms_per_tok", "suspect_fast"}
    for row in again["rows"]:
        assert not times & set(row)
        assert row.get("greedy_exact", True)
    assert again["summary"]["value"] is None
    q8 = spec_bench(argv + ["--weights-dtype", "int8"],
                    trained=first["trained"], timed=False)
    capsys.readouterr()
    assert all(r.get("greedy_exact", True) for r in q8["rows"])
