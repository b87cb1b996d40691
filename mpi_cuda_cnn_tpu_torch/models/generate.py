"""Autoregressive decoding with a KV cache (counterpart of the
reference's `models/generate.py`).

- the auto dtype routing of the cache and the decode weights;
- `init_cache`, `prefill` (one `model.apply` whose attention captures
  each block's k/v into max_seq-sized buffers, and attends with the plain
  causal attention), `decode_step` and `decode_block` (k tokens at
  positions [pos, pos + k) of the contiguous cache, `attend_contiguous`);
- `token_forward`, the one cached-decode forward skeleton (embedding,
  QKV, the dense or MoE MLP, the head; serving's paged path runs it too)
  and `attend_kv`, the masked GQA read over materialized cache rows;
- `filter_logits` (top-k / top-p), `generate` (greedy or sampled), and
  `lookup_speculative_generate` (draft-free prompt-lookup speculation,
  exact greedy at temperature 0, rejection sampling above).

Weight products go through `qmatmul`, so int8 `QuantW` weights
(`ops.gemv.quantize_decode_params`) take the int8 kernel K2 on the card.
MoE blocks run `moe_mlp_inference` (every expert, no drop) in prefill and
decode; their expert weights stay float32.

Sampling draws from `jax.random`'s streams bit for bit (`data/prng.py`):
the keys split as the reference's jitted loops split them, and the
uniform draws are the reference's; the Gumbel noise of a whole `generate`
call is made on the host at once and sent to the device in one copy.
The reference's loops are `lax.scan` and `lax.while_loop`; here they are
Python loops whose positions live on the host. `generate` reads nothing
back until its tokens are done; the lookup loop reads its round's picks
and accepted count once a round (the `while_loop`'s condition).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..data import prng
from ..ops.attention import NEG_INF, attention
from ..ops.gemv import qmatmul
from .transformer import TransformerLM, _layernorm

CACHE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                "int8": torch.int8}

# THE auto-dtype routing table, keyed by surface -> (GQA/MQA pick, MHA
# pick): the reference's table, unchanged. It was chosen from the
# reference's own decode measurements; it has not been re-measured on
# the card.
_AUTO_DTYPE_ROUTING: dict[str, tuple[str, str]] = {
    "cache": ("int8", "bfloat16"),
    "weights": ("int8", "float32"),
}


def _route_auto(surface: str, dtype: str, heads: int,
                kv_heads: int | None) -> str:
    if dtype != "auto":
        return dtype
    gqa_pick, mha_pick = _AUTO_DTYPE_ROUTING[surface]
    kv = kv_heads or heads
    return gqa_pick if kv < heads else mha_pick


def pick_cache_dtype(dtype: str, *, heads: int,
                     kv_heads: int | None = None) -> str:
    """Resolve a KV-cache dtype of "auto": int8 for GQA/MQA, bfloat16 for
    MHA. Explicit dtypes pass through."""
    return _route_auto("cache", dtype, heads, kv_heads)


def pick_weights_dtype(dtype: str, *, heads: int,
                       kv_heads: int | None = None) -> str:
    """Resolve a decode-weights dtype of "auto": int8 for GQA/MQA,
    float32 for MHA. Explicit dtypes pass through."""
    return _route_auto("weights", dtype, heads, kv_heads)


def _quant_kv(x: torch.Tensor):
    """Per-(batch, position, head) absmax int8 quantization of a
    (B, T, Hkv, hd) k/v tensor: (int8 values, float32 scales
    (B, T, Hkv, 1)) with x ~= values * scales. `torch.round` rounds half
    to even, as `jnp.round` does."""
    xf = x.to(torch.float32)
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0
    s = torch.clamp_min(s, 1e-10)
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def token_forward(model: TransformerLM, params: dict, toks: torch.Tensor,
                  positions: torch.Tensor, attend) -> torch.Tensor:
    """THE cached-decode forward skeleton: k tokens per row at explicit
    absolute positions, the attention/cache behavior injected per layer.

    toks: (B, k) int64; positions: (k,) shared across rows, or (B, k)
    per-row positions (each serving slot at its own depth).
    attend(i, q, k, v) -> (B, k, H*hd) float32 performs layer i's cache
    write and masked attention read. Every weight matmul goes through
    `qmatmul`, so params may carry int8 QuantW leaves; MoE blocks run
    `moe_mlp_inference`.
    Returns (B, k, vocab) float32 logits."""
    x = params["tok_emb"][toks]                           # (B, k, dim)
    if model.pos == "learned":
        # Padding rows of a last prefill chunk may run past the table;
        # clamp like the reference's gather (their outputs are dropped).
        x = x + params["pos_emb"][positions.long().clamp(max=model.max_seq - 1)]
    for i, blk in enumerate(params["blocks"]):
        y = _layernorm(x, blk["ln1"]["g"], blk["ln1"]["b"])
        q, k, v = model.project_qkv(blk, y, positions=positions)
        o = attend(i, q, k, v)
        x = x + qmatmul(o.to(x.dtype), blk["wo"])
        y = _layernorm(x, blk["ln2"]["g"], blk["ln2"]["b"])
        x = x + model.mlp(blk, y, moe_inference=True)[0]
    x = _layernorm(x, params["ln_f"]["g"], params["ln_f"]["b"])
    return qmatmul(x, params["head"]).to(torch.float32)


def attend_kv(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
              mask: torch.Tensor, cks: torch.Tensor | None = None,
              cvs: torch.Tensor | None = None) -> torch.Tensor:
    """THE masked GQA attention read over materialized cache rows.

    q: (B, k, H, hd); ck/cv: (B, L, Hkv, hd) rows in any storage dtype;
    int8 rows come with absmax scales cks/cvs (B, L, Hkv, 1), applied
    outside the products (a key's scale multiplies its logit, a value's
    scale its probability). mask: (k, L) or (B, k, L) bool, True =
    attend. Scores and softmax are float32; bf16 probabilities are
    rounded to bf16 before the PV product, as in the reference.
    Returns (B, k, H*hd) float32."""
    b, kk, h, hd = q.shape
    hkv = ck.shape[2]
    g = h // hkv
    int8 = ck.dtype == torch.int8
    f32 = torch.float32
    qg = q.reshape(b, kk, hkv, g, hd).to(f32)
    scale = 1.0 / math.sqrt(hd)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, ck.to(f32)) * scale
    if int8:
        logits = logits * cks.permute(0, 2, 3, 1)[:, :, None, :, :]
    if mask.dim() == 2:
        mask = mask[None]
    # A Python scalar, not a tensor made from one: building a CUDA tensor
    # from host memory would wait for the stream on every call.
    logits = logits.masked_fill(~mask[:, None, None, :, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if int8:
        probs = probs * cvs.permute(0, 2, 3, 1)[:, :, None, :, :]
    elif cv.dtype != f32:
        probs = probs.to(cv.dtype).to(f32)
    o = torch.einsum("bhgqk,bkhd->bqhgd", probs, cv.to(f32))
    return o.reshape(b, kk, h * hd)


# ---------------------------------------------------------------------------
# The contiguous cache: prefill, decode steps and blocks
# ---------------------------------------------------------------------------


def _cache_dtype(dtype) -> torch.dtype:
    return CACHE_DTYPES[dtype] if isinstance(dtype, str) else dtype


def _empty_layer(model: TransformerLM, batch: int, dtype: torch.dtype,
                 device) -> dict:
    shape = (batch, model.max_seq, model.n_kv, model.head_dim)
    layer = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        sshape = shape[:-1] + (1,)
        layer["ks"] = torch.zeros(sshape, device=device)
        layer["vs"] = torch.zeros(sshape, device=device)
    return layer


def init_cache(model: TransformerLM, batch: int, dtype="float32",
               device: torch.device | str = "cpu") -> list[dict]:
    """Empty per-block KV buffers (B, max_seq, Hkv, head_dim) in `dtype`
    ("float32", "bfloat16" or "int8"; int8 with float32 absmax scales
    "ks"/"vs" (B, max_seq, Hkv, 1))."""
    dtype = _cache_dtype(dtype)
    return [_empty_layer(model, batch, dtype, device)
            for _ in range(model.depth)]


def _write(c: dict, k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
    """Store k, v (B, n, Hkv, hd) at positions [pos, pos + n) of one
    layer's buffers (quantized for an int8 cache)."""
    n = k.shape[1]
    if c["k"].dtype == torch.int8:
        for name, t in (("k", k), ("v", v)):
            q, sc = _quant_kv(t)
            c[name][:, pos:pos + n] = q
            c[name + "s"][:, pos:pos + n] = sc
    else:
        c["k"][:, pos:pos + n] = k.to(c["k"].dtype)
        c["v"][:, pos:pos + n] = v.to(c["v"].dtype)


def prefill(model: TransformerLM, params: dict, prompt: torch.Tensor,
            cache_dtype="float32"):
    """The batched prompt pass: one `model.apply` (MoE blocks under
    `moe_inference`) whose attention stores each block's k/v in
    max_seq-sized buffers of `cache_dtype` and attends with the plain
    causal attention at full precision. Returns (float32 logits of the
    last position (B, vocab), cache)."""
    b, s0 = prompt.shape
    if s0 > model.max_seq:
        raise ValueError(f"prompt length {s0} exceeds max_seq {model.max_seq}")
    dtype = _cache_dtype(cache_dtype)
    cache: list[dict] = []

    def capture_attn(q, k, v):
        c = _empty_layer(model, b, dtype, prompt.device)
        _write(c, k, v, 0)
        cache.append(c)
        return attention(q, k, v, causal=True)

    logits = model.apply(params, prompt, attn_fn=capture_attn,
                         moe_inference=True)
    return logits[:, -1, :].to(torch.float32), cache


def attend_contiguous(c: dict, q, k, v, pos: int, positions: torch.Tensor):
    """Write k/v at [pos, pos + k) of one layer's contiguous buffers (in
    place), then attend each row i over the keys at positions <=
    positions[i] (`attend_kv`). Returns (o (B, k, H*hd) float32, c)."""
    _write(c, k, v, pos)
    keys = torch.arange(c["k"].shape[1], device=positions.device)
    mask = keys[None, :] <= positions[:, None]            # (k, max_seq)
    return attend_kv(q, c["k"], c["v"], mask, c.get("ks"), c.get("vs")), c


def decode_block(model: TransformerLM, params: dict, toks: torch.Tensor,
                 pos: int, cache: list[dict]):
    """k tokens per row at positions [pos, pos + k): every block writes
    its k cache slots first, then row i attends over keys <= pos + i, so
    stale entries past an accepted prefix are overwritten or masked.
    Returns (logits (B, k, vocab) float32, cache)."""
    kk = toks.shape[1]
    if pos + kk > model.max_seq:
        raise ValueError(f"block [{pos}, {pos + kk}) out of range (max_seq "
                         f"{model.max_seq})")
    positions = pos + torch.arange(kk, device=toks.device)

    def attend(i, q, k, v):
        return attend_contiguous(cache[i], q, k, v, pos, positions)[0]

    return token_forward(model, params, toks, positions, attend), cache


def decode_step(model: TransformerLM, params: dict, tok: torch.Tensor,
                pos: int, cache: list[dict]):
    """One token per row (B,) at position `pos`: the k = 1 case of
    `decode_block`. Returns (logits (B, vocab), cache)."""
    logits, cache = decode_block(model, params, tok[:, None], pos, cache)
    return logits[:, 0, :], cache


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 0.0) -> torch.Tensor:
    """Top-k / nucleus restriction in float32: logits outside the kept set
    become NEG_INF. top_k keeps the k largest (ties at the boundary
    survive; k above the vocab keeps all); top_p keeps the smallest prefix
    of the probability-sorted vocabulary whose mass reaches p (the token
    that crosses p stays). 0 disables either."""
    lg = logits.to(torch.float32)
    if top_k:
        thr = torch.sort(lg, dim=-1).values[..., -min(top_k, lg.shape[-1]),
                                            None]
        lg = torch.where(lg >= thr, lg, NEG_INF)
    if top_p:
        sorted_l = torch.sort(lg, dim=-1, descending=True).values
        probs = torch.softmax(sorted_l, dim=-1)
        kept = torch.cumsum(probs, dim=-1) - probs < top_p
        cutoff = torch.where(kept, sorted_l, math.inf).amin(dim=-1,
                                                             keepdim=True)
        lg = torch.where(lg >= cutoff, lg, NEG_INF)
    return lg


def _filtered_probs(logits, temperature: float, top_k: int, top_p: float):
    """The law `generate` samples: softmax of the temperature-scaled,
    filtered logits, float32."""
    return torch.softmax(filter_logits(logits.to(torch.float32) / temperature,
                                       top_k, top_p), dim=-1)


def sample_noise(key: np.ndarray, steps: int, shape) -> np.ndarray:
    """(steps, *shape) float32: the Gumbel noise `generate` adds to the
    filtered logits of step i, from the second key of the i-th split of
    the carried key (the reference's scan: `carry, k_i = split(carry)`)."""
    out = []
    for _ in range(steps):
        key, step_key = prng.split(key, 2)
        out.append(prng.gumbel(step_key, shape))
    return np.stack(out)


def _validate_sampling(temperature: float, key, top_k: int, top_p: float,
                       vocab: int) -> None:
    if temperature > 0 and key is None:
        raise ValueError("sampling (temperature > 0) needs a PRNG key")
    if top_k < 0 or top_k > vocab:
        raise ValueError(f"top_k {top_k} not in [0, vocab {vocab}]")
    if not 0.0 <= top_p <= 1.0:
        raise ValueError(f"top_p {top_p} not in [0, 1]")
    if (top_k or top_p) and temperature <= 0:
        raise ValueError(
            "top_k/top_p restrict SAMPLING — set temperature > 0 "
            "(greedy argmax already takes the single most likely token)")


@torch.no_grad()
def generate(model: TransformerLM, params: dict, prompt: torch.Tensor,
             num_tokens: int, *, temperature: float = 0.0,
             key: np.ndarray | None = None, cache_dtype="float32",
             top_k: int = 0, top_p: float = 0.0) -> torch.Tensor:
    """Prefill the prompt (B, S0) in one forward, then `num_tokens`
    cached decode steps: greedy argmax at temperature 0, else a sample of
    the temperature-scaled, `filter_logits`-restricted logits with `key`
    (a `data.prng` key: step i's noise from the i-th split, as the
    reference's scan splits its carry). Returns (B, num_tokens) int64 on
    the prompt's device. Greedy tokens stay on the device and feed the
    next step."""
    b, s0 = prompt.shape
    if num_tokens < 1:
        raise ValueError("num_tokens must be >= 1")
    if s0 + num_tokens > model.max_seq:
        raise ValueError(f"prompt {s0} + {num_tokens} new tokens exceeds "
                         f"max_seq {model.max_seq}")
    _validate_sampling(temperature, key, top_k, top_p, model.vocab)
    noise = None
    if temperature > 0:         # every step's noise, in one copy
        noise = torch.from_numpy(sample_noise(
            key, num_tokens, (b, model.vocab))).to(prompt.device)

    def sample(logits, i):
        if noise is None:
            return torch.argmax(logits, dim=-1)
        lg = filter_logits(logits.to(torch.float32) / temperature, top_k,
                           top_p)
        return torch.argmax(lg + noise[i], dim=-1)

    logits, cache = prefill(model, params, prompt, cache_dtype)
    toks = []
    for i in range(num_tokens - 1):
        toks.append(sample(logits, i))
        logits, cache = decode_step(model, params, toks[-1], s0 + i, cache)
    toks.append(sample(logits, num_tokens - 1))
    return torch.stack(toks, dim=1)


# ---------------------------------------------------------------------------
# Prompt-lookup speculative decoding
# ---------------------------------------------------------------------------


def _emit_rows(y: np.ndarray, accept: np.ndarray, out: np.ndarray,
               n_out: int):
    """The buffered emit: y (k,) emit rows, accept (k - 1,) prefix flags.
    j = 1 + the accepted prefix's length; all k rows are written at n_out
    (rows past j are rewritten next round). Returns (j, new cur)."""
    j = 1 + int(np.cumprod(accept.astype(np.int64)).sum())
    out[n_out:n_out + len(y)] = y
    return j, int(y[j - 1])


def _accept_and_emit(u: np.ndarray, y: np.ndarray, out: np.ndarray,
                     n_out: int):
    """Greedy acceptance: the longest prefix where verify input i + 1
    equals the target's pick at row i."""
    return _emit_rows(y, u[1:] == y[:-1], out, n_out)


def _spec_sample_rows(tl: torch.Tensor, props: torch.Tensor,
                      key: np.ndarray, temperature: float, top_k: int,
                      top_p: float):
    """Rejection sampling of one verify block against the one-hot law of
    prompt-lookup proposals: accept proposal x w.p. p(x), replace a
    reject by a sample of p with x zeroed (p itself where that row is
    all zero), sample the bonus row from p. tl (k, V) target logits,
    props (k - 1,) proposals on the device. Returns (y (k,), accept
    (k - 1,)) on the device."""
    kk, v = tl.shape
    p = _filtered_probs(tl, temperature, top_k, top_p)            # (k, V)
    ku, kr, kb = prng.split(key, 3)
    draws = np.concatenate([prng.uniform(ku, (kk - 1,)).ravel(),
                            prng.gumbel(kr, (kk - 1, v)).ravel(),
                            prng.gumbel(kb, (v,))])
    draws = torch.from_numpy(draws).to(tl.device)        # one copy a round
    unif = draws[:kk - 1]
    g_res = draws[kk - 1:kk - 1 + (kk - 1) * v].view(kk - 1, v)
    g_bonus = draws[kk - 1 + (kk - 1) * v:]
    qs = torch.zeros_like(p[:-1]).scatter_(-1, props[:, None], 1.0)
    p_prop = torch.gather(p[:-1], -1, props[:, None])[:, 0]
    accept = unif < p_prop                # u * q(x) < p(x), q(x) = 1
    res = torch.clamp_min(p[:-1] - qs, 0.0)
    res = torch.where(res.sum(-1, keepdim=True) > 0.0, res, p[:-1])
    res_tok = torch.argmax(g_res + torch.log(res), dim=-1)
    bonus = torch.argmax(g_bonus + torch.log(p[-1]))
    y = torch.cat([torch.where(accept, props, res_tok), bonus[None]])
    return y, accept


def _spec_stats(n_out: int, rounds: int, num_tokens: int) -> dict:
    """Verify rounds and mean accepted tokens a round, the emitted count
    capped at num_tokens (a last round's overshoot never lands)."""
    return {"rounds": int(rounds),
            "mean_accepted": (min(int(n_out), num_tokens) - 1)
            / max(int(rounds), 1)}


def _propose(ctx: np.ndarray, pos: int, cur: int, k: int,
             ngram: int) -> np.ndarray:
    """The k - 1 tokens that followed the most recent earlier occurrence
    of the context's ngram-token tail (ctx[pos] == cur); no match
    repeats cur; a match near the buffer's end takes the window clamped
    to L - (k - 1)."""
    big = len(ctx)
    idx = np.arange(big)
    match = (idx >= ngram - 1) & (idx < pos)
    for d in range(ngram):
        match &= np.roll(ctx, d) == ctx[pos - d]
    j = int(np.max(np.where(match, idx, -1)))
    if j < 0:
        return np.full(k - 1, cur, ctx.dtype)
    start = min(max(j + 1, 0), big - (k - 1))
    return ctx[start:start + k - 1].copy()


@torch.no_grad()
def lookup_speculative_generate(model: TransformerLM, params: dict,
                                prompt: torch.Tensor, num_tokens: int, *,
                                k: int = 8, ngram: int = 2,
                                cache_dtype="float32",
                                temperature: float = 0.0,
                                key: np.ndarray | None = None,
                                top_k: int = 0, top_p: float = 0.0,
                                return_stats: bool = False):
    """Draft-free speculative decoding, B = 1: propose the k - 1 tokens
    that followed the latest earlier occurrence of the running context's
    ngram tail, verify them with one `decode_block` forward, and emit the
    accepted prefix plus one. Temperature 0: exactly `generate`'s greedy
    tokens (up to float rounding of the block forward); above it,
    rejection sampling whose output law is plain sampling's. Returns
    tokens (1, num_tokens) int64 on the prompt's device, and with
    `return_stats` also {"rounds", "mean_accepted"}."""
    b, s0 = prompt.shape
    if b != 1:
        raise ValueError(f"speculative decoding is the B=1 latency path "
                         f"(got batch {b}); use generate() for batches")
    if num_tokens < 1:
        raise ValueError("num_tokens must be >= 1")
    if k < 2:
        raise ValueError(f"k must be >= 2 (k={k} would propose nothing)")
    if ngram < 1:
        raise ValueError(f"ngram must be >= 1 (got {ngram})")
    if s0 < ngram:
        raise ValueError(
            f"prompt length {s0} shorter than the lookup ngram {ngram}")
    if s0 + num_tokens + k > model.max_seq:
        raise ValueError(
            f"prompt {s0} + {num_tokens} tokens + k={k} speculative slack "
            f"exceeds max_seq {model.max_seq}")
    _validate_sampling(temperature, key, top_k, top_p, model.vocab)
    sampling = temperature > 0
    dev = prompt.device
    tl, cache = prefill(model, params, prompt, cache_dtype)
    if sampling:
        key, k0 = prng.split(key, 2)
        noise = torch.from_numpy(prng.gumbel(k0, tl.shape)).to(dev)
        cur = torch.argmax(noise + torch.log(
            _filtered_probs(tl, temperature, top_k, top_p)), dim=-1)
    else:
        cur = torch.argmax(tl, dim=-1)
    cur = int(cur[0])
    ctx = np.zeros(model.max_seq, np.int64)
    ctx[:s0] = prompt[0].cpu().numpy()
    ctx[s0] = cur
    out = np.zeros(num_tokens + k, np.int64)
    out[0] = cur
    pos, n_out, rounds = s0, 1, 0
    while n_out < num_tokens:
        u = np.concatenate([[cur], _propose(ctx, pos, cur, k, ngram)])
        ud = torch.from_numpy(u).to(dev)
        tl, cache = decode_block(model, params, ud[None], pos, cache)
        # One read back a round: the picks (and, sampling, the
        # acceptances) decide the emitted count, the reference's
        # while_loop condition.
        if sampling:
            key, kv = prng.split(key, 2)
            y, accept = _spec_sample_rows(tl[0], ud[1:], kv, temperature,
                                          top_k, top_p)
            both = torch.cat([y, accept.to(y.dtype)]).cpu().numpy()
            y = both[:k]
            j, cur = _emit_rows(y, both[k:].astype(bool), out, n_out)
        else:
            y = torch.argmax(tl[0], dim=-1).cpu().numpy()
            j, cur = _accept_and_emit(u, y, out, n_out)
        ctx[pos + 1:pos + 1 + k] = y
        pos, n_out, rounds = pos + j, n_out + j, rounds + 1
    toks = torch.from_numpy(out[None, :num_tokens]).to(dev)
    if return_stats:
        return toks, _spec_stats(n_out, rounds, num_tokens)
    return toks
