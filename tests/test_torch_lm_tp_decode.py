"""Model-parallel decoding with a head-sharded KV cache
(`parallel/tp_decode.py`) against the JAX package's sharded inference
(`parallel/tp.py` `shard_lm_params` on a mesh of conftest's CPU devices,
`generate` / `lookup_speculative_generate` partitioned by GSPMD), as
tests/test_tp.py holds the JAX package's own against one device.

Each case runs on spawned gloo ranks, every case of a world size in one
spawn of its ranks (worlds 2 and 4): model:2, model:4 and data:2,model:2
(each model line decoding alone), an MoE model (experts sliced on their
hidden, the gate whole), an int8 cache over GQA (one kv head a rank),
sampling at temperature 0.8 with top-k and top-p, and prompt-lookup
speculation at k 4. Held, on every rank:

- the tokens equal the JAX function's on `shard_lm_params` on the same
  mesh, for the same key;
- the prefill logits lie within PREFILL_TOL of one device's (the
  reference's 1e-5: the row-parallel products sum in another order),
  and one device's top-2 gap exceeds TIE_GAP (1e-3) at each row, so
  that token equality means something;
- the rank's cache holds Hkv / n heads of every layer, and its weights
  are its shards: wqkv / wkv and w1 column blocks, wo and w2 row
  blocks, the embedding and the head split on the vocab.
"""

import numpy as np
import pytest

from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
import torch_cpu  # noqa: F401  (one torch thread, see its docstring)

PREFILL_TOL = 1e-5
TIE_GAP = 1e-3
TOKENS = 8
RANKS_TIMEOUT_S = 300
BASE = dict(vocab=32, dim=32, heads=4, depth=2, max_seq=40)
CASES = {  # id -> (world, axes, model keywords, decode keywords)
    "model2": (2, {"model": 2}, {}, {}),
    "model2-moe": (2, {"model": 2}, dict(moe_experts=4, moe_top_k=2), {}),
    "model2-gqa-int8": (2, {"model": 2}, dict(kv_heads=2),
                        dict(cache_dtype="int8")),
    "model2-t0.8": (2, {"model": 2}, {},
                    dict(temperature=0.8, top_k=12, top_p=0.9, seed=7)),
    "model2-lookup4": (2, {"model": 2}, dict(pos="rope"), dict(lookup=4)),
    "model4": (4, {"model": 4}, {}, {}),
    "data2-model2": (4, {"data": 2, "model": 2}, dict(kv_heads=2), {}),
}


def _inputs(cid: str):
    """(model config, JAX-initialized params as numpy, prompt)."""
    import jax

    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM

    world, axes, over, dec = CASES[cid]
    cfg = {**BASE, **over}
    params = jax.tree.map(np.asarray, JaxLM(**cfg).init(
        jax.random.key(3 + len(cid))))
    rng = np.random.default_rng(len(cid))
    if "lookup" in dec:
        prompt = np.tile(rng.integers(0, cfg["vocab"], (1, 5)), (1, 3))
    else:
        prompt = rng.integers(0, cfg["vocab"], (2, 8))
    return cfg, params, prompt.astype(np.int32)


def _decode_kw(dec: dict) -> dict:
    return {k: v for k, v in dec.items() if k not in ("seed", "lookup")}


def _decode_rank(mesh, cases: list):
    """Every case of this world on this rank: its prefill logits, tokens,
    cache heads and shard shapes."""
    import torch

    from mpi_cuda_cnn_tpu_torch.convert import params_from_jax
    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.models.generate import (
        generate,
        lookup_speculative_generate,
    )
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.parallel.mesh import make_mesh
    from mpi_cuda_cnn_tpu_torch.parallel.tp_decode import TPDecoder

    out = {}
    for cid, cfg, params, prompt in cases:
        _, axes, _, dec = CASES[cid]
        m = make_mesh(axes, devices=[mesh.device] * mesh.world)
        model = TransformerLM(**cfg)
        d = TPDecoder.from_params(model, params_from_jax(params), m)
        p = torch.from_numpy(prompt).long()
        logits, cache = d.prefill(p, dec.get("cache_dtype", "float32"))
        kw = _decode_kw(dec)
        if "seed" in dec:
            kw["key"] = prng.key(dec["seed"])
        if "lookup" in dec:
            toks = lookup_speculative_generate(model, d, p, TOKENS,
                                               k=dec["lookup"], **kw)
        else:
            toks = generate(model, d, p, TOKENS, **kw)
        blk = d.p["blocks"][0]
        out[cid] = {
            "logits": logits.numpy(), "tokens": toks.numpy(),
            "cache_heads": sorted({c["k"].shape[2] for c in cache}),
            "shapes": {name: tuple(t.shape) for name, t in (
                *((n, blk[n]) for n in ("wqkv", "wq", "wkv", "wo", "w1",
                                        "w2") if n in blk),
                *(("moe." + n, blk["moe"][n]) for n in ("w1", "w2", "gate")
                  if "moe" in blk),
                ("tok_emb", d.p["tok_emb"]), ("head", d.p["head"]))},
        }
    return out


def _jax_want(cid: str, cfg, params, prompt) -> dict:
    """The JAX function on shard_lm_params on the case's mesh, and one
    device's prefill logits."""
    import jax
    import jax.numpy as jnp

    from mpi_cuda_cnn_tpu.models import generate as jgen
    from mpi_cuda_cnn_tpu.models.transformer import TransformerLM as JaxLM
    from mpi_cuda_cnn_tpu.parallel.mesh import make_mesh
    from mpi_cuda_cnn_tpu.parallel.tp import shard_lm_params

    world, axes, _, dec = CASES[cid]
    model = JaxLM(**cfg)
    mesh = make_mesh(axes, devices=jax.devices()[:world])
    tp_params = shard_lm_params(model, params, mesh)
    jp = jnp.asarray(prompt)
    one, _ = jgen.prefill(model, params, jp,
                          cache_dtype=dec.get("cache_dtype", "float32"))
    kw = _decode_kw(dec)
    if "seed" in dec:
        kw["key"] = jax.random.key(dec["seed"])
    if "lookup" in dec:
        toks = jgen.lookup_speculative_generate(model, tp_params, jp, TOKENS,
                                                k=dec["lookup"], **kw)
    else:
        toks = jgen.generate(model, tp_params, jp, TOKENS, **kw)
    return {"one_logits": np.asarray(one), "tokens": np.asarray(toks)}


@pytest.fixture(scope="module")
def runs():
    inputs = {cid: _inputs(cid) for cid in CASES}
    got = {}
    for world in sorted({c[0] for c in CASES.values()}):
        mine = [(cid, *inputs[cid]) for cid, c in CASES.items()
                if c[0] == world]
        ranks = run_ranks(_decode_rank, world, args=(mine,),
                          timeout=RANKS_TIMEOUT_S)
        for cid, *_ in mine:
            got[cid] = [r[cid] for r in ranks]
    return inputs, got


@pytest.mark.parametrize("cid", list(CASES))
def test_tp_decode_matches_the_jax_sharded_decode(runs, cid):
    inputs, got = runs
    cfg, params, prompt = inputs[cid]
    want = _jax_want(cid, cfg, params, prompt)
    top2 = np.sort(want["one_logits"], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0]).min() > TIE_GAP, cid
    for r, res in enumerate(got[cid]):
        np.testing.assert_allclose(res["logits"], want["one_logits"],
                                   rtol=PREFILL_TOL, atol=PREFILL_TOL,
                                   err_msg=f"{cid} rank {r}")
        np.testing.assert_array_equal(res["tokens"], want["tokens"],
                                      err_msg=f"{cid} rank {r}")


@pytest.mark.parametrize("cid", list(CASES))
def test_each_rank_holds_its_heads_and_its_shards(runs, cid):
    inputs, got = runs
    cfg, _, _ = inputs[cid]
    _, axes, _, _ = CASES[cid]
    n = axes["model"]
    d, h = cfg["dim"], cfg["heads"]
    hkv = cfg.get("kv_heads") or h
    hd = d // h
    want = {"tok_emb": (cfg["vocab"] // n, d), "head": (d, cfg["vocab"] // n),
            "wo": (h // n, hd, d)}
    if hkv == h:
        want["wqkv"] = (d, 3, h // n, hd)
    else:
        want.update(wq=(d, h // n, hd), wkv=(d, 2, hkv // n, hd))
    if cfg.get("moe_experts"):
        e = cfg["moe_experts"]
        want.update({"moe.w1": (e, d, 4 * d // n), "moe.w2": (e, 4 * d // n, d),
                     "moe.gate": (d, e)})
    else:
        want.update(w1=(d, 4 * d // n), w2=(4 * d // n, d))
    for res in got[cid]:
        assert res["cache_heads"] == [hkv // n]
        assert res["shapes"] == want
