"""`python -m mpi_cuda_cnn_tpu_torch spec-bench` — plain greedy decoding
against draft-verified speculative decoding at B = 1 (counterpart of the
reference's `scripts/bench_speculative.py`).

Both models train on the cyclic-successor corpus (token t + 1 = token t
+ 1 mod vocab) until they predict it near perfectly; then decoding is
timed plain and speculative at each k of --ks with the acceptance the
trained pair really reaches, with the draft-free prompt-lookup rows, the
same at temperature 0.8, an optional row of lookup on the port's own
sources (--self-corpus-steps), and a random draft (acceptance about
1/vocab). Every greedy row also says whether its tokens equal plain
greedy's (`greedy_exact`), the bench's in-run check of the exactness
contract. Each time is `utils.sync.two_point` over calls of n and 2n
tokens (median of 3), a call waited for on the card.

One JSON line per row in the reference's format, then the schema-stamped
summary record. `--weights-dtype int8` (the port's flag) decodes with
int8 `QuantW` target and draft weights, so every weight product takes
the int8 kernel K2 on the card; the training stays float32.

    python -m mpi_cuda_cnn_tpu_torch spec-bench [--tokens 256] [--ks 2,4,8]
        [--weights-dtype float32|int8] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

TEMPERATURE = 0.8
SAMPLE_SEED = 11
RANDOM_DRAFT_SEED = 99


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch spec-bench",
        description="Plain greedy against draft-verified and prompt-lookup "
                    "speculative decoding, B = 1.")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--draft-dim", type=int, default=128)
    ap.add_argument("--draft-depth", type=int, default=1)
    ap.add_argument("--vocab", type=int, default=251)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--prompt", type=int, default=64)
    ap.add_argument("--tokens", type=int, default=256)
    ap.add_argument("--ks", default="2,4,8")
    ap.add_argument("--train-steps", type=int, default=150)
    ap.add_argument("--self-corpus-steps", type=int, default=300,
                    help="train a fresh target on the port's own sources "
                         "and measure lookup speculation on real code; 0 "
                         "disables the row")
    ap.add_argument("--weights-dtype", default="float32",
                    choices=["float32", "int8"],
                    help="decode weights of the target and the draft "
                         "(int8: QuantW, the K2 kernel on the card)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _fit(model, batches, *, steps: int, seq: int, lr: float, seed: int,
         device) -> tuple[dict, float]:
    """AdamW at a constant lr on `batches(rng)` -> (B, seq + 1) windows,
    with the oracle attention; returns (params, the last loss)."""
    from ..ops.gemv import tree_map
    from ..train.lm import make_lm_state, make_lm_train_step
    from ..train.optimizer import make_optimizer

    opt = make_optimizer(lr, opt="adamw", schedule="constant")
    step_fn = make_lm_train_step(model, opt, attn_impl="oracle",
                                 seq_len=seq, device=device)
    state = make_lm_state(model, opt, seed, device=device)
    rng = np.random.default_rng(seed)
    loss = float("nan")
    for _ in range(steps):
        w = torch.from_numpy(batches(rng).astype(np.int64)).to(device)
        state, m = step_fn(state, w[:, :-1], w[:, 1:])
        loss = m["loss"]
    return tree_map(lambda t: t.detach(), state["params"]), float(loss)


def train_on_cycle(model, *, steps: int, batch: int, seq: int, device,
                   lr: float = 3e-3, seed: int = 0):
    """Fit `model` to token[t + 1] = token[t] + 1 (mod vocab)."""
    def batches(rng):
        starts = rng.integers(0, model.vocab, size=(batch, 1))
        return (starts + np.arange(seq + 1)[None, :]) % model.vocab

    return _fit(model, batches, steps=steps, seq=seq, lr=lr, seed=seed,
                device=device)


def train_on_text(model, tokens: np.ndarray, *, steps: int, batch: int,
                  seq: int, device, lr: float = 1e-3, seed: int = 0):
    """Fit `model` to a real token stream (random windows, the trainer's
    scheme), for the self-corpus lookup row."""
    n = len(tokens) - seq

    def batches(rng):
        starts = rng.integers(0, n, size=batch)
        return tokens[starts[:, None] + np.arange(seq + 1)[None, :]]

    return _fit(model, batches, steps=steps, seq=seq, lr=lr, seed=seed,
                device=device)


def timed_tokens(fn, n: int, device, attempts: int = 3,
                 floor: float = 0.0) -> tuple[float, bool]:
    """(seconds a token, suspect) of fn(m), which makes m tokens: the
    two-point slope over calls of n and 2n tokens, each waited for. A
    slope at or below `floor` (a transient: non-positive, or faster than
    the mode can be) is measured again, up to `attempts` times; if every
    attempt stays there, the last positive one comes back flagged
    suspect, and with none positive RuntimeError is raised."""
    from ..utils.sync import two_point

    def run(m: int) -> float:
        t0 = time.perf_counter()
        fn(m)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    run(n), run(2 * n)  # warm both sizes
    last_positive = None
    for _ in range(attempts):
        t = two_point(run, n)
        if t > floor:
            return t, False
        if t > 0:
            last_positive = t
    if last_positive is not None:
        return last_positive, True
    raise RuntimeError(
        f"two-point slope stayed non-positive over {attempts} median-of-3 "
        "attempts — backend too unstable to measure")


def try_timed(fn, n: int, device, floor: float):
    """`timed_tokens` for a speculative row: an unmeasurable mode gives
    (None, True), so that the bench goes on with a skipped row."""
    try:
        return timed_tokens(fn, n, device, floor=floor)
    except RuntimeError:
        return None, True


def spec_bench(argv: list[str] | None = None, *, trained: dict | None = None,
               timed: bool = True) -> dict:
    """Run the bench and print its lines; return {"device": the card's
    name, "rows": the printed rows, "summary": the summary record,
    "launches": {mode: the kernel launches of its one untimed call},
    "stats": {mode: its {"rounds", "mean_accepted"}}, "trained": the
    float32 target and draft params and their last losses}. `trained`
    (an earlier run's, at the same model flags) skips the training;
    `timed` False runs every mode's untimed call alone, its rows without
    times. Raises RuntimeError without a card when the card is asked
    for."""
    from .._device import resolve_device
    from ..data import prng
    from ..models.generate import (
        generate,
        lookup_speculative_generate,
        speculative_generate,
    )
    from ..models.transformer import TransformerLM
    from ..obs.schema import make_record
    from ..ops import _kernels
    from ..ops.gemv import quantize_decode_params

    t_start = time.perf_counter()
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    ks = [int(x) for x in args.ks.split(",")]
    target = TransformerLM(vocab=args.vocab, dim=args.dim, heads=args.heads,
                           depth=args.depth, max_seq=args.max_seq)
    draft = TransformerLM(vocab=args.vocab, dim=args.draft_dim, heads=2,
                          depth=args.draft_depth, max_seq=args.max_seq)
    if trained is None:
        t_params, t_loss = train_on_cycle(target, steps=args.train_steps,
                                          batch=8, seq=128, device=dev)
        d_params, d_loss = train_on_cycle(draft, steps=4 * args.train_steps,
                                          batch=8, seq=128, device=dev)
        trained = {"target": t_params, "target_loss": t_loss,
                   "draft": d_params, "draft_loss": d_loss}
    wdt = args.weights_dtype
    t_params = quantize_decode_params(trained["target"], wdt)
    d_params = quantize_decode_params(trained["draft"], wdt)
    prompt = torch.from_numpy(np.arange(args.prompt)[None, :]
                              % args.vocab).to(dev)
    launches, stats = {}, {}
    rows = []

    def emit(row: dict) -> None:
        print(json.dumps(row), flush=True)
        rows.append(row)

    def counted(mode: str, fn):
        """fn() once, its kernel launches and stats kept under `mode`."""
        before = dict(_kernels.launches)
        toks, st = fn()
        launches[mode] = {k: _kernels.launches[k] - before.get(k, 0)
                          for k in _kernels.launches
                          if _kernels.launches[k] != before.get(k, 0)}
        stats[mode] = st
        return toks.cpu().numpy(), st

    def clock(fn, base=None, k: int = 1):
        """(seconds a token, suspect) of fn(m): `timed_tokens`, or with a
        plain time `base` `try_timed` above the floor base / (4 k);
        (None, False) in an untimed run."""
        if not timed:
            return None, False
        if base is None:
            return timed_tokens(fn, args.tokens, dev)
        return try_timed(fn, args.tokens, dev, base / (k * 4.0))

    def times(t, base=None, per_s: bool = True) -> dict:
        """A row's time keys (none in an untimed run): ms_per_tok,
        tokens_per_s, and speedup_vs_plain over a plain time `base`."""
        if t is None:
            return {}
        out = {"ms_per_tok": round(t * 1e3, 3)}
        if per_s:
            out["tokens_per_s"] = round(1.0 / t)
        if base is not None:
            out["speedup_vs_plain"] = round(base / t, 2)
        return out

    def unmeasured(mode: str, t) -> bool:
        """Whether a timed mode was unmeasurable (then its row says so)."""
        if timed and t is None:
            emit({"bench": "speculative", "mode": mode,
                  "skipped": "unmeasurable"})
            return True
        return False

    def sus_key(sus: bool) -> dict:
        return {"suspect_fast": True} if sus else {}

    t_plain, _ = clock(lambda m: generate(target, t_params, prompt, m))
    want = generate(target, t_params, prompt, args.tokens).cpu().numpy()
    emit({"bench": "speculative", "mode": "plain_greedy", **times(t_plain),
          "target_loss": round(trained["target_loss"], 4),
          "draft_loss": round(trained["draft_loss"], 4)})
    best = (rows[0].get("tokens_per_s"), "plain")
    for k in ks:
        got, st = counted(f"draft_k{k}", lambda k=k: speculative_generate(
            target, t_params, draft, d_params, prompt, args.tokens, k=k,
            return_stats=True))
        exact = bool(np.array_equal(got, want))
        t_spec, sus = clock(
            lambda m, k=k: speculative_generate(
                target, t_params, draft, d_params, prompt, m, k=k),
            t_plain, k)
        if unmeasured(f"draft_k{k}", t_spec):
            continue
        emit({"bench": "speculative", "mode": f"draft_k{k}",
              **times(t_spec, t_plain),
              "mean_accepted": round(st["mean_accepted"], 2),
              "greedy_exact": exact, **sus_key(sus)})
        if timed and rows[-1]["tokens_per_s"] > best[0] and exact \
                and not sus:
            best = (rows[-1]["tokens_per_s"], f"k={k}")

    # Draft-free prompt lookup needs earlier occurrences of the
    # continuation's n-grams: its prompt spans more than one cycle.
    lk_prompt = torch.from_numpy(np.arange(args.vocab + 49)[None, :]
                                 % args.vocab).to(dev)
    lk_want = generate(target, t_params, lk_prompt, args.tokens).cpu().numpy()
    lk_plain, _ = clock(lambda m: generate(target, t_params, lk_prompt, m))
    for k in ks:
        lk_got, lst = counted(f"lookup_k{k}", lambda k=k: (
            lookup_speculative_generate(target, t_params, lk_prompt,
                                        args.tokens, k=k,
                                        return_stats=True)))
        t_lk, sus = clock(
            lambda m, k=k: lookup_speculative_generate(
                target, t_params, lk_prompt, m, k=k), lk_plain, k)
        if unmeasured(f"lookup_k{k}", t_lk):
            continue
        exact = bool(np.array_equal(lk_got, lk_want))
        emit({"bench": "speculative", "mode": f"lookup_k{k}",
              **times(t_lk, lk_plain),
              "mean_accepted": round(lst["mean_accepted"], 2),
              "greedy_exact": exact, **sus_key(sus)})
        if timed and rows[-1]["tokens_per_s"] > best[0] and exact \
                and not sus:
            best = (rows[-1]["tokens_per_s"], f"lookup_k{k}")

    # Rejection-sampling speculation at temperature 0.8: the output law
    # is plain sampling's, so no token check applies.
    temp = TEMPERATURE
    sampled = dict(temperature=temp, key=prng.key(SAMPLE_SEED))
    t_plain_t, _ = clock(
        lambda m: generate(target, t_params, prompt, m, **sampled))
    emit({"bench": "speculative", "mode": f"plain_sample_T{temp}",
          **times(t_plain_t)})
    for k in ks:
        _, sst = counted(f"draft_k{k}_T{temp}", lambda k=k: (
            speculative_generate(target, t_params, draft, d_params, prompt,
                                 args.tokens, k=k, return_stats=True,
                                 **sampled)))
        t_st, sus = clock(
            lambda m, k=k: speculative_generate(
                target, t_params, draft, d_params, prompt, m, k=k,
                **sampled), t_plain_t, k)
        if unmeasured(f"draft_k{k}_T{temp}", t_st):
            continue
        emit({"bench": "speculative", "mode": f"draft_k{k}_T{temp}",
              **times(t_st, t_plain_t),
              "mean_accepted": round(sst["mean_accepted"], 2),
              **sus_key(sus)})
    lk_plain_t, _ = clock(
        lambda m: generate(target, t_params, lk_prompt, m, **sampled))
    for k in ks:
        _, lst = counted(f"lookup_k{k}_T{temp}", lambda k=k: (
            lookup_speculative_generate(target, t_params, lk_prompt,
                                        args.tokens, k=k, return_stats=True,
                                        **sampled)))
        t_lt, sus = clock(
            lambda m, k=k: lookup_speculative_generate(
                target, t_params, lk_prompt, m, k=k, **sampled),
            lk_plain_t, k)
        if unmeasured(f"lookup_k{k}_T{temp}", t_lt):
            continue
        emit({"bench": "speculative", "mode": f"lookup_k{k}_T{temp}",
              **times(t_lt, lk_plain_t),
              "mean_accepted": round(lst["mean_accepted"], 2),
              **sus_key(sus)})

    # Lookup on real text: a fresh target trained briefly on the port's
    # own sources, prompted with the corpus head.
    if args.self_corpus_steps:
        from ..train.lm_trainer import load_corpus

        text = load_corpus("self")
        st_model = TransformerLM(vocab=256, dim=args.dim, heads=args.heads,
                                 depth=args.depth, max_seq=args.max_seq)
        st_params, st_loss = train_on_text(
            st_model, text, steps=args.self_corpus_steps, batch=8, seq=256,
            device=dev)
        st_params = quantize_decode_params(st_params, wdt)
        sp = torch.from_numpy(text[:512][None, :].astype(np.int64)).to(dev)
        sp_want = generate(st_model, st_params, sp, args.tokens).cpu().numpy()
        t_sp_plain, _ = clock(lambda m: generate(st_model, st_params, sp, m))
        got, sstats = counted("self_corpus_lookup_k8", lambda: (
            lookup_speculative_generate(st_model, st_params, sp, args.tokens,
                                        k=8, return_stats=True)))
        t_sp_lk, sus = clock(
            lambda m: lookup_speculative_generate(st_model, st_params, sp,
                                                  m, k=8), t_sp_plain, 8)
        if not unmeasured("self_corpus_lookup_k8", t_sp_lk):
            plain_ms = ({"plain_ms_per_tok": round(t_sp_plain * 1e3, 3)}
                        if timed else {})
            emit({"bench": "speculative", "mode": "self_corpus_lookup_k8",
                  "train_steps": args.self_corpus_steps,
                  "train_loss": round(st_loss, 3), **plain_ms,
                  **times(t_sp_lk, t_sp_plain, per_s=False),
                  "mean_accepted": round(sstats["mean_accepted"], 2),
                  "greedy_exact": bool(np.array_equal(got, sp_want)),
                  **sus_key(sus)})

    # The worst case on record: an untrained draft.
    rand = quantize_decode_params(
        draft.init(prng.key(RANDOM_DRAFT_SEED), dev), wdt)
    _, rstats = counted("random_draft_k4", lambda: speculative_generate(
        target, t_params, draft, rand, prompt, args.tokens, k=4,
        return_stats=True))
    t_rand, sus = clock(
        lambda m: speculative_generate(target, t_params, draft, rand, prompt,
                                       m, k=4), t_plain, 4)
    if not unmeasured("random_draft_k4", t_rand):
        emit({"bench": "speculative", "mode": "random_draft_k4",
              **times(t_rand, t_plain, per_s=False),
              "mean_accepted": round(rstats["mean_accepted"], 2),
              **sus_key(sus)})

    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    summary = make_record(
        "bench", time.perf_counter() - t_start,
        metric="speculative_decode_tokens_per_s", value=best[0],
        unit="tokens/s", config=best[1],
        plain_tokens_per_s=rows[0].get("tokens_per_s"),
        model=f"d{args.dim}x{args.depth} draft d{args.draft_dim}x"
              f"{args.draft_depth} v{args.vocab} B=1",
        backend=dev.type)
    print(json.dumps(summary), flush=True)
    return {"device": name, "rows": rows, "summary": summary,
            "launches": launches, "stats": stats, "trained": trained}


def spec_bench_main(argv: list[str] | None = None) -> int:
    try:
        spec_bench(argv)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    return 0
