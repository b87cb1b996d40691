"""`python -m mpi_cuda_cnn_tpu_torch serve-bench` — the serving bench
(counterpart of the reference's `serve/bench.py`).

Drives the PagedEngine with a seeded workload of mixed prompt/output
lengths and prints, per mode, one JSON summary line: throughput, TTFT
and per-output-token latency percentiles, decode-tick, prefill-chunk and
preemption counts, the prefix-cache, host-tier and speculative counters,
per-tenant blocks and the state-digest chain — the reference's line —
plus the device name, the serving kernels' launches in the measured run
and the draft model's forwards. Weights are random, made from --seed
(the draft's from --seed + 1). The workload can be shaped (template
prefixes, heavy-tail lengths, tenants, multi-turn sessions) or replayed
from a finished run's JSONL (--trace); the engine can share prefixes
(--prefix-cache) over a host spill tier (--spill), speculate (--spec
lookup|draft), schedule by SLO (--scheduler slo), take injected faults
(--fault-plan) and stream its tick records and metrics to a JSONL file
(--metrics-jsonl), with live alerts (--slo).

    python -m mpi_cuda_cnn_tpu_torch serve-bench --device cpu \\
        --requests 8 --mode continuous --prefix-mix 0.9 --prefix-cache \\
        --spec lookup --spec-k 8
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from .scheduler import Request

# The kernels of the serving path, whose launches the summary line reports.
SERVE_KERNELS = ("paged_attention", "int8_gemm")


class UsageError(ValueError):
    """A flag combination the bench refuses (exit code 2)."""


def _heavy_tail_len(lrng, lo: int, hi: int) -> int:
    """One lognormal length draw clipped to [lo, hi]: median at the
    geometric midpoint, sigma a quarter of the log-range."""
    if hi <= lo:
        return lo
    mu = 0.5 * (np.log(lo) + np.log(hi))
    sigma = (np.log(hi) - np.log(lo)) / 4.0
    v = int(round(float(lrng.lognormal(mu, sigma))))
    return min(max(v, lo), hi)


def make_workload(*, n: int, vocab: int, prompt_min: int, prompt_max: int,
                  out_min: int, out_max: int, rate: float, seed: int,
                  deadline_s: float = 0.0, tenants: int = 0,
                  prefix_mix: float = 0.0, prefix_pool: int = 4,
                  len_dist: str = "uniform",
                  templates: int = 0) -> list[Request]:
    """n seeded requests: uniform prompt/output lengths in the given
    ranges, Poisson arrivals at `rate` req/s (rate 0 = everything at
    t=0), an absolute deadline of arrival + deadline_s when > 0. The
    reference's draws in the reference's order, so both packages make
    the same requests bit for bit from the same seed.

    Each option draws from its own generator, so the default stream is
    unchanged by any of them: tenants > 0 tags requests "t0".."t{N-1}"
    ((seed, 1)); prefix_mix > 0 starts that fraction of prompts with one
    of `prefix_pool` seeded templates, keeping the last ~1/4 unique
    ((seed, 2)); len_dist "lognormal" draws heavy-tail lengths clipped
    to the ranges ((seed, 3)); templates > 0 sizes the template working
    set explicitly, its content from (seed, 4)."""
    if len_dist not in ("uniform", "lognormal"):
        raise ValueError(f"len_dist {len_dist!r}: want uniform or "
                         "lognormal")
    rng = np.random.default_rng(seed)
    trng = np.random.default_rng([seed, 1])
    prng = np.random.default_rng([seed, 2])
    lrng = (np.random.default_rng([seed, 3])
            if len_dist == "lognormal" else None)
    if templates > 0:
        pool_n = templates
        tmpl_rng = np.random.default_rng([seed, 4])
    else:
        pool_n = prefix_pool
        tmpl_rng = prng
    tmpls = [tmpl_rng.integers(0, vocab, (prompt_max,)).astype(np.int32)
             for _ in range(pool_n)] if prefix_mix > 0 else []
    t = 0.0
    reqs = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        if lrng is None:
            plen = int(rng.integers(prompt_min, prompt_max + 1))
            olen = int(rng.integers(out_min, out_max + 1))
        else:
            plen = _heavy_tail_len(lrng, prompt_min, prompt_max)
            olen = _heavy_tail_len(lrng, out_min, out_max)
        prompt = rng.integers(0, vocab, (plen,)).astype(np.int32)
        tenant = (f"t{int(trng.integers(0, tenants))}" if tenants > 0
                  else None)
        if tmpls and float(prng.random()) < prefix_mix:
            k = int(prng.integers(0, pool_n))
            shared = plen - max(1, plen // 4)
            if shared > 0:
                prompt = np.concatenate([tmpls[k][:shared],
                                         prompt[shared:]])
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=olen,
                            arrival=t,
                            deadline=t + deadline_s if deadline_s > 0
                            else None, tenant=tenant))
    return reqs


def load_trace(path: str) -> list[dict]:
    """The request geometry of a finished run's metrics JSONL: each
    `request` record's id, prompt_tokens, max_new_tokens, arrival_s and
    tenant (the first record per id wins), in arrival order."""
    rows: dict[int, dict] = {}
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"--trace {path}: bad JSONL line: {e}")
            if rec.get("event") != "request":
                continue
            rid = rec.get("id")
            if rid is None or rid in rows:
                continue
            try:
                rows[rid] = {
                    "id": int(rid),
                    "prompt_tokens": int(rec["prompt_tokens"]),
                    "max_new_tokens": int(rec["max_new_tokens"]),
                    "arrival_s": float(rec["arrival_s"]),
                    "tenant": rec.get("tenant"),
                }
            except (KeyError, TypeError, ValueError) as e:
                raise ValueError(
                    f"--trace {path}: request record for id {rid!r} is "
                    f"missing workload geometry ({e})")
    if not rows:
        raise ValueError(f"--trace {path}: no request records — want a "
                         "metrics JSONL from a finished serve-bench / "
                         "fleet-bench run")
    return sorted(rows.values(),
                  key=lambda r: (r["arrival_s"], r["id"]))


def requests_from_trace(rows: list[dict], *, vocab: int, seed: int,
                        deadline_s: float = 0.0) -> list[Request]:
    """Fresh Requests from trace geometry: arrivals, budgets, ids and
    tenants as recorded; prompt CONTENT drawn per id from its own seeded
    generator (records carry no tokens)."""
    reqs = []
    for row in rows:
        rng = np.random.default_rng([seed, 5, row["id"]])
        prompt = rng.integers(0, vocab,
                              (row["prompt_tokens"],)).astype(np.int32)
        reqs.append(Request(
            rid=row["id"], prompt=prompt,
            max_new_tokens=row["max_new_tokens"],
            arrival=row["arrival_s"],
            deadline=(row["arrival_s"] + deadline_s if deadline_s > 0
                      else None),
            tenant=row["tenant"]))
    return reqs


def apply_trace_geometry(args, rows: list[dict]) -> None:
    """Size the bench to the trace: request count and prompt/output
    ranges from the recorded geometry."""
    args.requests = len(rows)
    args.prompt_min = min(r["prompt_tokens"] for r in rows)
    args.prompt_max = max(r["prompt_tokens"] for r in rows)
    args.out_min = min(r["max_new_tokens"] for r in rows)
    args.out_max = max(r["max_new_tokens"] for r in rows)


def parse_turns_dist(spec: str):
    """`--turns-dist`: `uniform:LO-HI` draws each session's turn count
    uniformly in [LO, HI]; `geometric:P` draws Geometric(P) turns (at
    least one). Returns the draw(rng) callable."""
    kind, sep, body = spec.partition(":")
    if sep and kind == "uniform":
        lo_s, dash, hi_s = body.partition("-")
        try:
            lo, hi = int(lo_s), int(hi_s)
        except ValueError:
            lo = hi = 0
        if dash and 1 <= lo <= hi:
            return lambda rng: int(rng.integers(lo, hi + 1))
        raise ValueError(
            f"turns-dist {spec!r}: uniform wants LO-HI with "
            "1 <= LO <= HI")
    if sep and kind == "geometric":
        try:
            p = float(body)
        except ValueError:
            p = 0.0
        if 0.0 < p <= 1.0:
            return lambda rng: int(rng.geometric(p))
        raise ValueError(
            f"turns-dist {spec!r}: geometric wants 0 < P <= 1")
    raise ValueError(
        f"turns-dist {spec!r}: want 'uniform:LO-HI' or 'geometric:P'")


def add_session_turns(reqs, *, turns_dist: str, turn_gap_s: float,
                      vocab: int, out_min: int, out_max: int,
                      max_len: int, seed: int) -> list[Request]:
    """Multi-turn follow-ups: each session's first request anchors a
    conversation; turn k+1 re-arrives carrying turn k's prompt plus a
    drawn continuation, an exponential think-time gap later. Draws come
    from a (seed, 5) generator, so the base workload is unchanged. A
    chain stops when the grown prompt and its next output no longer fit
    `max_len`. Follow-up rids continue from len(reqs); the merged list is
    sorted by (arrival, rid)."""
    draw_turns = parse_turns_dist(turns_dist)
    srng = np.random.default_rng([seed, 5])
    anchors: dict = {}
    for r in reqs:
        if r.session is not None and r.session not in anchors:
            anchors[r.session] = r
    out = list(reqs)
    rid = len(reqs)
    for sess in sorted(anchors):
        prev = anchors[sess]
        for _turn in range(draw_turns(srng) - 1):
            ext = int(srng.integers(out_min, out_max + 1))
            olen = int(srng.integers(out_min, out_max + 1))
            gap = (float(srng.exponential(turn_gap_s))
                   if turn_gap_s > 0 else 0.0)
            if prev.prompt.size + ext + olen > max_len:
                break
            prompt = np.concatenate(
                [prev.prompt,
                 srng.integers(0, vocab, (ext,)).astype(np.int32)])
            arrival = prev.arrival + gap
            rel_deadline = (prev.deadline - prev.arrival
                            if prev.deadline is not None else None)
            nr = Request(rid=rid, prompt=prompt, max_new_tokens=olen,
                         arrival=arrival,
                         deadline=(arrival + rel_deadline
                                   if rel_deadline is not None else None),
                         session=prev.session, tenant=prev.tenant)
            out.append(nr)
            rid += 1
            prev = nr
    out.sort(key=lambda r: (r.arrival, r.rid))
    return out


def diurnal_warp(reqs, *, amp: float, period_s: float):
    """Deterministic diurnal time-warp: remap each Poisson arrival t -> s
    so the instantaneous rate follows rate*(1 + amp*sin(2*pi*s/period)),
    a day cycle with peak rate*(1+amp) and trough rate*(1-amp), without
    drawing anything. s solves Lambda(s) = t with
    Lambda(s) = s + amp*P/(2pi)*(1 - cos(2pi*s/P)), by a fixed number of
    bisection steps (the map is monotone for amp <= 1, so arrival order
    is kept and two runs bisect alike). amp=0 is the identity. Deadlines
    keep their offset from the arrival; the warp mutates in place and
    returns `reqs`."""
    if amp <= 0:
        return reqs
    if amp > 1.0:
        raise ValueError(f"diurnal amp must be <= 1 (got {amp}): past "
                         "it the intensity goes negative at the trough")
    if period_s <= 0:
        raise ValueError(f"diurnal period must be > 0 (got {period_s})")
    two_pi = 2.0 * np.pi
    span = amp * period_s / np.pi  # max warp displacement: Lambda bound
    for r in reqs:
        t = r.arrival
        lo, hi = max(0.0, t - span), t
        for _ in range(52):  # fixed count: runs equal bit for bit
            mid = 0.5 * (lo + hi)
            lam = mid + amp * period_s / two_pi * (
                1.0 - np.cos(two_pi * mid / period_s))
            if lam < t:
                lo = mid
            else:
                hi = mid
        s = 0.5 * (lo + hi)
        if r.deadline is not None:
            r.deadline = s + (r.deadline - r.arrival)
        r.arrival = s
    return reqs


def build_sched_policy(args, slo_spec):
    """The --scheduler/--tenant-priority/--tenant-quota surface: the
    SLOPolicy under `--scheduler slo`, else None. Raises UsageError."""
    if args.scheduler != "slo":
        if args.tenant_priority or args.tenant_quota:
            raise UsageError("--tenant-priority/--tenant-quota need "
                             "--scheduler slo")
        return None
    from .scheduler import (
        SLOPolicy,
        parse_tenant_priorities,
        parse_tenant_quotas,
    )

    try:
        prios = (parse_tenant_priorities(args.tenant_priority)
                 if args.tenant_priority else {})
        slot_q, page_q = (parse_tenant_quotas(args.tenant_quota)
                          if args.tenant_quota else ({}, {}))
    except ValueError as e:
        raise UsageError(str(e)) from e
    return SLOPolicy(priorities=prios, slot_quota=slot_q,
                     page_quota=page_q, slo_spec=slo_spec)


def _parser() -> argparse.ArgumentParser:
    from ..faults import fault_plan_arg

    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch serve-bench",
        description="Serving bench: paged-KV continuous batching vs static "
                    "batching on one device (throughput, TTFT, p50/p99 "
                    "per-token latency).",
    )
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="0 = MHA; fewer = GQA/MQA")
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--slots", type=int, default=4,
                    help="decode batch rows (in-flight sequences)")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page")
    ap.add_argument("--pages", type=int, default=0,
                    help="global page-pool size incl. the scratch page "
                         "(0 = room for `slots` full-length sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--cache-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "auto"],
                    help="auto: int8 for GQA/MQA, bfloat16 for MHA")
    ap.add_argument("--attn-kernel", default="gather",
                    choices=["gather", "cuda"],
                    help="paged-attention read: gather = plain PyTorch "
                         "gather + attend_kv; cuda = the hand-written "
                         "kernel (csrc/paged_attention.cu)")
    ap.add_argument("--decode-weights-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "auto"],
                    help="decode weights storage; int8 runs the int8 "
                         "matmul kernel (csrc/int8_gemm.cu) on the card; "
                         "auto: int8 for GQA/MQA, float32 for MHA")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=96)
    ap.add_argument("--out-min", type=int, default=8)
    ap.add_argument("--out-max", type=int, default=96)
    ap.add_argument("--rate", type=float, default=0.0,
                    help="Poisson arrival rate, requests/s (0 = all at t=0)")
    ap.add_argument("--mode", default="both",
                    choices=["both", "static", "continuous"])
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request deadline (arrival + this many ms; "
                         "0 = none): expired queued requests are dropped, "
                         "in-flight ones aborted with their pages returned")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bound on ARRIVED-but-waiting requests; arrivals "
                         "past it are rejected (0 = unbounded)")
    ap.add_argument("--watchdog-ms", type=float, default=0.0,
                    help="tick watchdog: count + record engine iterations "
                         "slower than this (0 = off)")
    ap.add_argument("--fault-plan", default=None,
                    type=fault_plan_arg("serve-bench"),
                    help="deterministic fault injection, e.g. "
                         "'squeeze@serve.tick:5?pages=4&ticks=8;"
                         "slow@serve.tick:9?s=0.2' or "
                         "'kv_corrupt@tier.spill:0' (sites checked at "
                         "parse time)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="tag requests with a seeded tenant mix over "
                         "t0..t{N-1} (0 = untagged)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="session keys: request i belongs to session "
                         "i %% N (0 = sessionless); the --turns-dist "
                         "conversation anchors")
    ap.add_argument("--turns-dist", default=None,
                    help="multi-turn sessions: 'uniform:LO-HI' or "
                         "'geometric:P' turns per session; turn k+1 "
                         "re-arrives carrying turn k's prompt as its "
                         "prefix (needs --sessions)")
    ap.add_argument("--turn-gap-ms", type=float, default=0.0,
                    help="mean think-time between a session's turns, "
                         "exponential (needs --turns-dist)")
    ap.add_argument("--slo", default=None,
                    help="SLO spec JSON (obs/slo.py grammar): run the "
                         "streaming alert engine on the record stream; "
                         "fired alerts land in the JSONL as `alert` "
                         "records")
    ap.add_argument("--prefix-mix", type=float, default=0.0,
                    help="fraction of requests sharing seeded template "
                         "prompt prefixes (0 = all-unique prompts)")
    ap.add_argument("--len-dist", default="uniform",
                    choices=["uniform", "lognormal"],
                    help="prompt/output length mix: uniform over the "
                         "ranges, or a heavy-tail lognormal clipped to "
                         "them")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="prefix-sharing KV cache on the continuous "
                         "scheduler (refcounted pages + copy-on-write): "
                         "a hit prefills only its suffix")
    ap.add_argument("--templates", type=int, default=0,
                    help="prefix template working-set size (overrides "
                         "the default 4; needs --prefix-mix > 0)")
    ap.add_argument("--spill", action="store_true",
                    help="host-tier KV spill: reclaimed prefix pages "
                         "spill to host memory and readmit on a later "
                         "hit, CRC-checked (needs --prefix-cache)")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-tier capacity in pages (--spill; 0 = match "
                         "the device pool)")
    ap.add_argument("--spec", default="off",
                    choices=["off", "lookup", "draft"],
                    help="batched speculative decoding, continuous mode "
                         "only: lookup = draft-free prompt lookup; draft "
                         "= a cheap draft model. Per tick: per-slot "
                         "proposal + ONE batched verify block")
    ap.add_argument("--spec-k", type=int, default=8,
                    help="speculative round width: candidate tokens "
                         "verified per slot per tick (>= 2)")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="prompt-lookup match length (--spec lookup)")
    ap.add_argument("--draft-dim", type=int, default=0,
                    help="draft model width (--spec draft; 0 = dim/2)")
    ap.add_argument("--draft-depth", type=int, default=0,
                    help="draft model depth (--spec draft; 0 = 1)")
    ap.add_argument("--draft-cache", default="window",
                    choices=["window", "paged"],
                    help="draft KV form (--spec draft): window = "
                         "cacheless sliding-window draft; paged = the "
                         "draft keeps its own paged KV cache")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "slo"],
                    help="continuous-batching policy: fcfs or the "
                         "SLO-aware scheduler (priority classes, "
                         "per-tenant quotas, burn-driven preemption; "
                         "implies --mode continuous)")
    ap.add_argument("--tenant-priority", default=None,
                    help="per-tenant priority classes, e.g. 't0=2,t1=0' "
                         "(needs --scheduler slo)")
    ap.add_argument("--tenant-quota", default=None,
                    help="per-tenant admission quotas, e.g. "
                         "'t0=pages:8/slots:2,t1=slots:1' (needs "
                         "--scheduler slo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="rebuild the workload from a finished run's "
                         "metrics JSONL `request` records; overrides "
                         "--requests, --rate and the length ranges")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append tick, request, fault, metrics and serve "
                         "records here")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def _check_flags(args) -> None:
    """The reference's flag-combination errors (UsageError, exit 2)."""
    if args.spec != "off" and args.mode == "static":
        raise UsageError("--spec needs continuous batching (--mode "
                         "continuous or both; static is the one-token "
                         "baseline)")
    if args.spec != "off" and args.spec_k < 2:
        raise UsageError(f"--spec-k {args.spec_k} would propose nothing "
                         "(want >= 2)")
    if args.draft_cache == "paged" and args.spec != "draft":
        raise UsageError("--draft-cache paged needs --spec draft")
    if args.spill and not args.prefix_cache:
        raise UsageError("--spill needs --prefix-cache (the host tier "
                         "spills prefix-cache pages; there is nothing to "
                         "spill)")
    if args.host_pages and not args.spill:
        raise UsageError("--host-pages needs --spill (without the tier "
                         "the capacity knob would be silently ignored)")
    if args.templates and not args.prefix_mix > 0:
        raise UsageError("--templates needs --prefix-mix > 0 (no request "
                         "draws a template prefix at mix 0)")
    if args.turns_dist and args.sessions <= 0:
        raise UsageError("--turns-dist needs --sessions > 0 (turns are "
                         "per-session conversations; a sessionless "
                         "workload has no chains to grow)")
    if args.turn_gap_ms and not args.turns_dist:
        raise UsageError("--turn-gap-ms needs --turns-dist (without turns "
                         "there are no gaps to draw)")
    if args.turns_dist:
        try:
            parse_turns_dist(args.turns_dist)
        except ValueError as e:
            raise UsageError(str(e)) from e


def serve_bench(argv: list[str] | None = None, *, params=None,
                draft_params=None) -> dict:
    """Run the bench; return {"lines": [summary dict per mode],
    "results": {mode: ServeResult}, "engine", "model", "params",
    "draft_params", "args", "alerts": the alert engine's summary line or
    None, "comparison": the static-vs-continuous line or None}.
    `params`/`draft_params`, the weights an earlier call returned for
    the same model flags and --seed, skip drawing them again. Raises
    UsageError on a refused flag combination, ValueError on an
    inconsistent configuration."""
    from .._device import resolve_device
    from ..data import prng
    from ..faults import FaultInjector
    from ..models.transformer import TransformerLM
    from ..obs.metrics import MetricsRegistry
    from ..ops import _kernels
    from ..utils.logging import MetricsLogger
    from .engine import PagedEngine
    from .pool import pages_for

    args = _parser().parse_args(argv)
    trace_rows = None
    if args.trace:
        if args.turns_dist or args.prefix_mix > 0 or args.templates:
            raise UsageError("--trace replaces the generated workload; "
                             "drop --turns-dist/--prefix-mix/--templates")
        try:
            trace_rows = load_trace(args.trace)
        except (OSError, ValueError) as e:
            raise UsageError(str(e)) from e
        apply_trace_geometry(args, trace_rows)
    if args.prompt_max + args.out_max > args.max_seq:
        raise ValueError(f"prompt {args.prompt_max} + out {args.out_max} "
                         f"exceeds --max-seq {args.max_seq}")
    _check_flags(args)
    device = resolve_device(args.device)
    model = TransformerLM(vocab=args.vocab, dim=args.dim, heads=args.heads,
                          depth=args.depth, max_seq=args.max_seq,
                          kv_heads=args.kv_heads)
    if params is None:
        params = model.init(prng.key(args.seed), device)
    max_len = args.prompt_max + args.out_max
    pages = args.pages or args.slots * pages_for(max_len, args.page_size) + 1
    draft_model = None
    if args.spec == "draft":
        # A narrower, shallower draft from a DIFFERENT key (a draft equal
        # to the target would accept everything and measure nothing).
        draft_model = TransformerLM(
            vocab=args.vocab, dim=args.draft_dim or max(args.dim // 2, 16),
            heads=args.heads, depth=args.draft_depth or 1,
            max_seq=args.max_seq, kv_heads=args.kv_heads)
        if draft_params is None:
            draft_params = draft_model.init(prng.key(args.seed + 1), device)
    engine = PagedEngine(
        model, params, slots=args.slots, num_pages=pages,
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        cache_dtype=args.cache_dtype, max_len=max_len,
        attn_kernel=args.attn_kernel,
        weights_dtype=args.decode_weights_dtype, spec=args.spec,
        spec_k=args.spec_k, spec_ngram=args.spec_ngram,
        draft_model=draft_model, draft_params=draft_params,
        draft_cache=args.draft_cache, device=device,
    )
    host_pages = (args.host_pages or pages) if args.spill else 0
    if args.scheduler == "slo":
        args.mode = "continuous"
    if args.prefix_cache and args.mode == "static":
        raise UsageError("--prefix-cache needs continuous batching "
                         "(--mode continuous or both; static is the "
                         "sharing-off baseline)")
    modes = (["static", "continuous"] if args.mode == "both"
             else [args.mode])
    workload_kw = dict(
        n=args.requests, vocab=args.vocab, prompt_min=args.prompt_min,
        prompt_max=args.prompt_max, out_min=args.out_min,
        out_max=args.out_max, rate=args.rate, seed=args.seed,
        deadline_s=args.deadline_ms / 1e3, tenants=args.tenants,
        prefix_mix=args.prefix_mix, len_dist=args.len_dist,
        templates=args.templates,
    )

    def build_reqs():
        # Regenerated identically per mode; session tags and multi-turn
        # follow-ups layer on top of the base stream.
        if trace_rows is not None:
            reqs = requests_from_trace(
                trace_rows, vocab=args.vocab, seed=args.seed,
                deadline_s=args.deadline_ms / 1e3)
        else:
            reqs = make_workload(**workload_kw)
        if args.sessions > 0:
            for r in reqs:
                r.session = r.rid % args.sessions
        if args.turns_dist:
            reqs = add_session_turns(
                reqs, turns_dist=args.turns_dist,
                turn_gap_s=args.turn_gap_ms / 1e3, vocab=args.vocab,
                out_min=args.out_min, out_max=args.out_max,
                max_len=max_len, seed=args.seed)
        return reqs

    alert_engine = slo_spec = None
    if args.slo:
        from ..obs.alerts import AlertEngine
        from ..obs.slo import SLOSpec

        try:
            slo_spec = SLOSpec.load(args.slo)
            alert_engine = AlertEngine(slo=slo_spec)
        except (OSError, ValueError) as e:
            raise UsageError(str(e)) from e
    sched_policy = build_sched_policy(args, slo_spec)
    backend = device.type
    device_name = (torch.cuda.get_device_name(device) if backend == "cuda"
                   else "cpu")
    cache_dtype = str(engine.cache_dtype).removeprefix("torch.")
    proposer = engine._draft_proposer
    lines, results, summaries = [], {}, {}
    with MetricsLogger(path=args.metrics_jsonl, echo=False) as metrics:
        if alert_engine is not None:
            # The live fold sees exactly the records the file gets.
            alert_engine.attach(metrics)
        # Warm up on one throwaway request (kernel build and load, CUDA
        # context, allocator) so no mode pays it inside its latencies;
        # a speculative engine warms its verify round too.
        warm_kw = {**workload_kw, "n": 1, "rate": 0.0, "deadline_s": 0.0}
        warm = [engine.run(make_workload(**warm_kw), mode=modes[0])]
        if args.spec != "off":
            warm.append(engine.run(make_workload(**warm_kw),
                                   mode="continuous", spec=True))
        for mode in modes:
            # A fresh injector per mode: both see the same faults.
            faults = (FaultInjector(args.fault_plan) if args.fault_plan
                      else None)
            # One registry per mode; tick records stream to the JSONL
            # (and the alert engine) as they happen.
            registry = MetricsRegistry()
            tick_sink = None
            if metrics.jsonl_enabled or alert_engine is not None:
                def tick_sink(rec, _snap_every=64, _registry=registry):
                    metrics.log("tick", **rec)
                    if (rec["tick"] + 1) % _snap_every == 0:
                        _registry.emit(metrics, mode=rec["mode"])
            before = dict(_kernels.launches)
            draft_before = proposer.forwards if proposer is not None else 0
            result = engine.run(
                build_reqs(), mode=mode, faults=faults, registry=registry,
                tick_sink=tick_sink,
                prefix=args.prefix_cache and mode == "continuous",
                policy=sched_policy if mode == "continuous" else None,
                spec=args.spec != "off" and mode == "continuous",
                host_pages=host_pages if mode == "continuous" else 0,
                max_queue=args.max_queue or None,
                watchdog_s=args.watchdog_ms / 1e3)
            if backend == "cuda":
                torch.cuda.synchronize(device)
            results[mode] = result
            s = result.summary()
            summaries[mode] = s
            registry.set("serve.tokens_per_s", s["tokens_per_s"])
            registry.emit(metrics, mode=mode, final=True)
            for rec in result.request_records():
                metrics.log("request", **rec)
            for ev in result.events:
                metrics.log("fault", **{"mode": mode, **ev})
            metrics.log("serve", **{
                "bench": "serve", "backend": backend,
                "cache_dtype": cache_dtype, "rate": args.rate,
                "attn_kernel": args.attn_kernel,
                "weights_dtype": engine.weights_dtype,
                "spec": args.spec, "spec_k": args.spec_k,
                "slots": args.slots, "page_size": args.page_size,
                "pages": pages, "prefix_cache": bool(args.prefix_cache),
                "host_pages": host_pages, "draft_cache": args.draft_cache,
                "max_len": max_len, **s,
            })
            lines.append({
                "bench": "serve", "backend": backend, "device": device_name,
                "cache_dtype": cache_dtype,
                "attn_kernel": args.attn_kernel,
                "weights_dtype": engine.weights_dtype,
                "spec": args.spec, "spec_k": args.spec_k,
                **s,
                "kernel_launches": {k: _kernels.launches[k] - before[k]
                                    for k in SERVE_KERNELS},
                "draft_forwards": (proposer.forwards - draft_before
                                   if proposer is not None else 0),
                "warmup_forwards": sum(w.decode_ticks + w.prefill_chunks
                                       for w in warm),
            })
    alerts = None
    if alert_engine is not None:
        alerts = {"metric": "serve_alerts_fired",
                  "value": len(alert_engine.alerts),
                  "alerts_crc": alert_engine.crc}
    comparison = None
    if len(summaries) == 2:
        st, ct = summaries["static"], summaries["continuous"]
        comparison = {
            "metric": "serve_tokens_per_s",
            "value": ct["tokens_per_s"],
            "unit": "tokens/s",
            "static_tokens_per_s": st["tokens_per_s"],
            "speedup": round(ct["tokens_per_s"] / max(st["tokens_per_s"],
                                                      1e-9), 3),
            "decode_ticks": {"static": st["decode_ticks"],
                             "continuous": ct["decode_ticks"]},
            "ttft_p99_ms": {"static": st["ttft_p99_ms"],
                            "continuous": ct["ttft_p99_ms"]},
        }
    return {"lines": lines, "results": results, "engine": engine,
            "model": model, "params": params,
            "draft_params": draft_params if args.spec == "draft" else None,
            "args": args, "alerts": alerts, "comparison": comparison}


def serve_bench_main(argv: list[str] | None = None) -> int:
    try:
        out = serve_bench(argv)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in out["lines"]:
        print(json.dumps(line))
    for extra in (out["alerts"], out["comparison"]):
        if extra is not None:
            print(json.dumps(extra))
    return 0


def _fleet_parser() -> argparse.ArgumentParser:
    from ..faults import fault_plan_arg

    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch fleet-bench",
        description="Failure-aware fleet bench: N single-engine "
                    "replicas behind the router under a seeded Poisson "
                    "storm, with optional injected replica crashes / "
                    "joins / leaves (exactly-once re-dispatch).",
    )
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--pools", default=None,
                    help="disaggregated prefill/decode serving: "
                         "'prefill:N,decode:M' splits the fleet by phase; "
                         "arrivals dispatch to the prefill pool, completed "
                         "prefills hand their KV page sets to decode "
                         "replicas (per-page CRCs, per-handoff fences); "
                         "overrides --replicas. An emptied pool degrades "
                         "affected requests to unified serving")
    ap.add_argument("--handoff-ticks", type=int, default=1,
                    help="fleet ticks one KV handoff's copy is in "
                         "flight (the mid-handoff crash window; "
                         "needs --pools)")
    ap.add_argument("--policy", default="least_loaded",
                    choices=["least_loaded", "session", "cache_aware"],
                    help="dispatch policy: least_loaded, session "
                         "(rendezvous-hash affinity), or cache_aware "
                         "(expected prefix-token overlap against each "
                         "replica's device tree + host tier; least-loaded "
                         "tie-break, hash-affinity fallback at zero "
                         "overlap. Needs --prefix-cache)")
    ap.add_argument("--redispatch", default="resume",
                    choices=["resume", "discard"],
                    help="failover semantics for in-flight requests: "
                         "resume re-prefills prompt + committed tokens "
                         "on the new replica; discard restarts from "
                         "the prompt")
    ap.add_argument("--heartbeat-miss", type=int, default=3,
                    help="consecutive missed heartbeat ticks before a "
                         "replica is declared dead")
    ap.add_argument("--transport", action="store_true",
                    help="route the control plane over the simulated "
                         "lossy message bus: sequenced messages with "
                         "retransmission and receiver dedup, leased "
                         "fences; zero-fault runs equal the direct-call "
                         "fleet bit for bit; unlocks the fleet.transport "
                         "fault site")
    ap.add_argument("--lease-ticks", type=int, default=0,
                    help="commit-lease lifetime in fleet ticks "
                         "(--transport; 0 = heartbeat_miss + 2; must "
                         "exceed --heartbeat-miss)")
    ap.add_argument("--rto-base", type=float, default=2.0,
                    help="retransmission-timeout base in fleet ticks "
                         "(--transport; backoff_delay-paced, no jitter)")
    ap.add_argument("--max-flaps", type=int, default=3,
                    help="crashes before a flapping replica's circuit "
                         "opens (it never rejoins)")
    ap.add_argument("--backoff-base", type=float, default=0.05,
                    help="restart backoff base, fleet-clock seconds "
                         "(utils/retry.backoff_delay; 0 = immediate)")
    ap.add_argument("--tick-ms", type=float, default=1.0,
                    help="fleet-clock advance per tick")
    ap.add_argument("--check-every", type=int, default=16,
                    help="page-pool invariant check cadence per replica "
                         "(1 = every step; always checked at exit)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="pages per replica incl. scratch (0 = size for "
                         "slots full-length sequences)")
    ap.add_argument("--prefill-chunk", type=int, default=32)
    ap.add_argument("--max-queue", type=int, default=0,
                    help="per-replica bound on waiting arrivals "
                         "(0 = unbounded)")
    ap.add_argument("--requests", type=int, default=256)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--prompt-min", type=int, default=8)
    ap.add_argument("--prompt-max", type=int, default=96)
    ap.add_argument("--out-min", type=int, default=8)
    ap.add_argument("--out-max", type=int, default=96)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="Poisson arrival rate in fleet-clock req/s "
                         "(0 = everything at t=0)")
    ap.add_argument("--sessions", type=int, default=0,
                    help="session keys for the affinity policy: request "
                         "i belongs to session i %% N (0 = sessionless)")
    ap.add_argument("--turns-dist", default=None,
                    help="multi-turn session conversations: "
                         "'uniform:LO-HI' or 'geometric:P' turns per "
                         "session (needs --sessions)")
    ap.add_argument("--turn-gap-ms", type=float, default=0.0,
                    help="mean think-time between a session's turns in "
                         "fleet-clock ms, exponential (needs "
                         "--turns-dist)")
    ap.add_argument("--diurnal-amp", type=float, default=0.0,
                    help="diurnal arrival modulation depth: the rate "
                         "follows rate*(1 + amp*sin) over "
                         "--diurnal-period; 0 = identity, max 1. Needs "
                         "--rate > 0")
    ap.add_argument("--diurnal-period", type=float, default=10.0,
                    help="diurnal cycle length, fleet-clock seconds "
                         "(--diurnal-amp)")
    ap.add_argument("--autoscale", default=None,
                    help="online goodput autoscaler: queue pressure, SLO "
                         "burn rates (--slo) and the frontier target "
                         "(--autoscale-frontier) drive replica join/leave "
                         "each tick. Grammar: comma-separated key=value "
                         "over min/max/high/low/up/down/cooldown/burn, or "
                         "bare 'on' (serve/autoscale.parse_autoscale)")
    ap.add_argument("--autoscale-frontier", default=None,
                    help="goodput JSONL whose frontier record's "
                         "best_per_chip_rps converts the observed "
                         "dispatch rate into a target replica count "
                         "(needs --autoscale)")
    ap.add_argument("--tenants", type=int, default=0,
                    help="tag requests with a seeded tenant mix over "
                         "t0..t{N-1} (0 = untagged single-tenant)")
    ap.add_argument("--slo", default=None,
                    help="SLO spec JSON (obs/slo.py grammar): run the "
                         "streaming alert engine live; the summary gains "
                         "alerts_fired/alerts_crc either way")
    ap.add_argument("--prefix-mix", type=float, default=0.0,
                    help="fraction of requests sharing seeded template "
                         "prompt prefixes (0 = all-unique)")
    ap.add_argument("--len-dist", default="uniform",
                    choices=["uniform", "lognormal"],
                    help="prompt/output length mix: uniform or heavy-tail "
                         "lognormal")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="per-replica prefix-sharing KV cache "
                         "(restarted incarnations come back cold)")
    ap.add_argument("--templates", type=int, default=0,
                    help="prefix template working-set size (needs "
                         "--prefix-mix > 0)")
    ap.add_argument("--spill", action="store_true",
                    help="per-replica host-tier KV spill of reclaimed "
                         "prefix pages, readmitted on the next hit "
                         "(CRC-sealed; sim compute is accounting-only). "
                         "Needs --prefix-cache")
    ap.add_argument("--host-pages", type=int, default=0,
                    help="host-tier capacity per replica in pages "
                         "(--spill; 0 = match the device pool)")
    ap.add_argument("--spec", default="off", choices=["off", "lookup"],
                    help="per-replica batched speculative decoding: "
                         "lookup = draft-free prompt lookup")
    ap.add_argument("--spec-k", type=int, default=8,
                    help="speculative round width per slot per tick")
    ap.add_argument("--spec-ngram", type=int, default=2,
                    help="prompt-lookup match length (--spec lookup)")
    ap.add_argument("--scheduler", default="fcfs", choices=["fcfs", "slo"],
                    help="per-replica batching policy: fcfs or the "
                         "SLO-aware scheduler")
    ap.add_argument("--tenant-priority", default=None,
                    help="per-tenant priority classes, e.g. 't0=2,t1=0' "
                         "(--scheduler slo)")
    ap.add_argument("--tenant-quota", default=None,
                    help="per-tenant admission quotas, e.g. "
                         "'t0=pages:8/slots:2' (--scheduler slo)")
    ap.add_argument("--deadline-ms", type=float, default=0.0,
                    help="per-request fleet-clock deadline (0 = none)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default=None,
                    help="feed a finished run's metrics JSONL request "
                         "trail back through the fleet; overrides "
                         "--requests, --rate and the length ranges")
    ap.add_argument("--fault-plan", default=None,
                    type=fault_plan_arg("fleet-bench"),
                    help="deterministic replica faults, e.g. "
                         "'replica_crash@fleet.tick:40?replica=1&"
                         "zombie_ticks=3;replica_join@fleet.tick:90' "
                         "(sites checked at parse time)")
    ap.add_argument("--compute", default="sim", choices=["sim", "engine"],
                    help="sim: device-free pure-token replicas; engine: "
                         "one PagedEngine per replica, shared weights "
                         "from --seed")
    ap.add_argument("--dim", type=int, default=64)
    ap.add_argument("--depth", type=int, default=2)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--kv-heads", type=int, default=0)
    ap.add_argument("--cache-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "auto"],
                    help="auto: int8 for GQA/MQA, bfloat16 for MHA")
    ap.add_argument("--attn-kernel", default="gather",
                    choices=["gather", "cuda"],
                    help="paged-attention read per engine replica: "
                         "gather = plain PyTorch, cuda = the hand-written "
                         "kernel (csrc/paged_attention.cu)")
    ap.add_argument("--decode-weights-dtype", default="float32",
                    choices=["float32", "bfloat16", "int8", "auto"],
                    help="decode weights per engine replica; int8 runs "
                         "csrc/int8_gemm.cu on the card; auto = int8 for "
                         "GQA/MQA, float32 for MHA")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the engine replicas' device (--compute engine)")
    ap.add_argument("--metrics-jsonl", default=None,
                    help="append obs records here (fleet/replica/"
                         "request/fault events + registry snapshots)")
    ap.add_argument("--log", default="full", choices=["full", "summary"],
                    help="full: per-tick fleet + per-replica tick + "
                         "per-request records; summary: lifecycle + "
                         "totals only")
    return ap


def _check_fleet_flags(args) -> dict | None:
    """fleet-bench's flag-combination errors, in the reference's order and
    words (UsageError, exit 2). Returns the parsed --pools or None."""
    from .handoff import parse_pools

    pools = None
    if args.pools:
        try:
            pools = parse_pools(args.pools)
        except ValueError as e:
            raise UsageError(str(e)) from e
    elif args.handoff_ticks != 1:
        raise UsageError("--handoff-ticks needs --pools (a unified fleet "
                         "performs no KV handoffs)")
    if args.lease_ticks and not args.transport:
        raise UsageError("--lease-ticks needs --transport (leases pace the "
                         "bus's commit fences; the direct-call fleet has "
                         "no wire to lease against)")
    if args.rto_base != 2.0 and not args.transport:
        raise UsageError("--rto-base needs --transport (there are no "
                         "retransmissions without the bus)")
    if args.spill and not args.prefix_cache:
        raise UsageError("--spill needs --prefix-cache (the host tier "
                         "spills prefix-cache pages; there is nothing to "
                         "spill)")
    if args.host_pages and not args.spill:
        raise UsageError("--host-pages needs --spill (without the tier the "
                         "capacity knob would be silently ignored)")
    if args.templates and not args.prefix_mix > 0:
        raise UsageError("--templates needs --prefix-mix > 0 (no request "
                         "draws a template prefix at mix 0)")
    if args.policy == "cache_aware" and not args.prefix_cache:
        raise UsageError("--policy cache_aware needs --prefix-cache (the "
                         "score is expected prefix-cache overlap; without "
                         "the cache every score is zero and the policy "
                         "silently degrades to its fallback)")
    if args.turns_dist and args.sessions <= 0:
        raise UsageError("--turns-dist needs --sessions > 0 (turns are "
                         "per-session conversations; a sessionless "
                         "workload has no chains to grow)")
    if args.turn_gap_ms and not args.turns_dist:
        raise UsageError("--turn-gap-ms needs --turns-dist (without turns "
                         "there are no gaps to draw)")
    if args.diurnal_amp > 0 and args.rate <= 0:
        raise UsageError("--diurnal-amp needs --rate > 0 (rate 0 puts "
                         "every arrival at t=0; there is no arrival "
                         "process to modulate)")
    if args.diurnal_amp > 1.0:
        raise UsageError(f"diurnal amp must be <= 1 (got "
                         f"{args.diurnal_amp}): past it the intensity goes "
                         "negative at the trough")
    if args.autoscale_frontier and not args.autoscale:
        raise UsageError("--autoscale-frontier needs --autoscale (the "
                         "frontier is the autoscaler's lookup table; "
                         "without the policy it would be silently ignored)")
    if args.turns_dist:
        try:
            parse_turns_dist(args.turns_dist)
        except ValueError as e:
            raise UsageError(str(e)) from e
    return pools


def fleet_bench(argv: list[str] | None = None, *, params=None) -> dict:
    """Run the fleet bench; return {"lines": [the summary line, the metric
    line], "result": FleetResult, "fleet", "args", and under --compute
    engine "model", "params" and "computes" (every replica incarnation's
    EngineCompute, in build order; None, None, [] under sim)}. `params`, the weights an earlier call
    returned for the same model flags and --seed, skip drawing them
    again. Under --compute engine the summary line also carries the
    device, the serving kernels' launches in the run and `forwards`: the
    decode ticks (or verify rounds) and prefill chunks every replica
    incarnation ran, zombies and crashed incarnations included. Raises
    UsageError on a refused flag combination (exit 2), ValueError or
    RuntimeError on a failed run (exit 1)."""
    import time

    from ..faults import FakeClock, FaultInjector
    from ..obs.metrics import MetricsRegistry
    from ..ops import _kernels
    from ..utils.logging import MetricsLogger
    from .fleet import EngineCompute, Fleet, SimCompute, make_fleet_workload
    from .pool import pages_for

    args = _fleet_parser().parse_args(argv)
    pools = _check_fleet_flags(args)
    trace_rows = None
    if args.trace:
        if (args.turns_dist or args.prefix_mix > 0 or args.templates
                or args.diurnal_amp > 0):
            raise UsageError("--trace replaces the generated workload; "
                             "drop --turns-dist/--prefix-mix/--templates/"
                             "--diurnal-amp")
        try:
            trace_rows = load_trace(args.trace)
        except (OSError, ValueError) as e:
            raise UsageError(str(e)) from e
        apply_trace_geometry(args, trace_rows)
    max_len = args.prompt_max + args.out_max
    pages = args.pages or args.slots * pages_for(max_len, args.page_size) + 1
    host_pages = (args.host_pages or pages) if args.spill else 0
    model = device = None
    computes = []  # every EngineCompute the fleet built, in build order
    if args.compute == "engine":
        from .._device import resolve_device
        from ..data import prng
        from ..models.transformer import TransformerLM
        from .engine import PagedEngine

        device = resolve_device(args.device)
        model = TransformerLM(
            vocab=args.vocab, dim=args.dim, heads=args.heads,
            depth=args.depth, max_seq=max_len, kv_heads=args.kv_heads,
        )
        if params is None:
            params = model.init(prng.key(args.seed), device)

        def compute_factory(name):
            # One engine (own page pools) per replica incarnation: a
            # restarted replica comes back with an empty cache. The
            # weights are shared, which is what makes cross-replica
            # re-dispatch output-exact.
            computes.append(EngineCompute(PagedEngine(
                model, params, slots=args.slots, num_pages=pages,
                page_size=args.page_size, prefill_chunk=args.prefill_chunk,
                cache_dtype=args.cache_dtype, max_len=max_len,
                attn_kernel=args.attn_kernel,
                weights_dtype=args.decode_weights_dtype,
                spec=args.spec, spec_k=args.spec_k,
                spec_ngram=args.spec_ngram, device=device,
            )))
            return computes[-1]
    else:
        params = None

        def compute_factory(name):
            return SimCompute(vocab=args.vocab, chunk=args.prefill_chunk,
                              salt=args.seed)

    if trace_rows is not None:
        reqs = requests_from_trace(
            trace_rows, vocab=args.vocab, seed=args.seed,
            deadline_s=args.deadline_ms / 1e3)
        if args.sessions > 0:
            for r in reqs:
                r.session = r.rid % args.sessions
    else:
        reqs = make_fleet_workload(
            n=args.requests, vocab=args.vocab, prompt_min=args.prompt_min,
            prompt_max=args.prompt_max, out_min=args.out_min,
            out_max=args.out_max, rate=args.rate, seed=args.seed,
            sessions=args.sessions, deadline_s=args.deadline_ms / 1e3,
            tenants=args.tenants, prefix_mix=args.prefix_mix,
            len_dist=args.len_dist, templates=args.templates,
            turns_dist=args.turns_dist, turn_gap_s=args.turn_gap_ms / 1e3,
            diurnal_amp=args.diurnal_amp,
            diurnal_period_s=args.diurnal_period,
        )
    alert_engine = slo_spec = None
    if args.slo:
        from ..obs.alerts import AlertEngine
        from ..obs.slo import SLOSpec

        try:
            slo_spec = SLOSpec.load(args.slo)
            alert_engine = AlertEngine(slo=slo_spec)
        except (OSError, ValueError) as e:
            raise UsageError(str(e)) from e
    sched_policy = build_sched_policy(args, slo_spec)
    autoscaler = None
    if args.autoscale:
        from .autoscale import Autoscaler, load_frontier, parse_autoscale

        try:
            pol = parse_autoscale(args.autoscale)
            per_chip = (load_frontier(args.autoscale_frontier)
                        if args.autoscale_frontier else 0.0)
        except (OSError, ValueError) as e:
            raise UsageError(str(e)) from e
        # slo_spec switches the burn-rate feed on: the autoscaler runs
        # the alert engine's windowed Accountant fold over the
        # fence-accepted terminal stream.
        autoscaler = Autoscaler(pol, slo_spec=slo_spec,
                                per_chip_rps=per_chip)
    clock = FakeClock()
    registry = MetricsRegistry(clock=clock)
    faults = FaultInjector(args.fault_plan) if args.fault_plan else None
    with MetricsLogger(path=args.metrics_jsonl, echo=False) as metrics:
        if alert_engine is not None:
            alert_engine.attach(metrics)
        fleet_sink = replica_tick_sink = None
        if metrics.jsonl_enabled and args.log == "full":
            def fleet_sink(rec):
                metrics.log("fleet", **rec)

            def replica_tick_sink(rec):
                metrics.log("tick", **rec)
        elif alert_engine is not None:
            # Summary mode keeps per-tick records out of the JSONL, but
            # the live rule engine still sees them.
            def fleet_sink(rec):
                for a in alert_engine.ingest(rec, event="fleet"):
                    metrics.log("alert", **a)

            def replica_tick_sink(rec):
                for a in alert_engine.ingest(rec, event="tick"):
                    metrics.log("alert", **a)
        fleet = Fleet(
            compute_factory, replicas=args.replicas, slots=args.slots,
            num_pages=pages, page_size=args.page_size, max_len=max_len,
            max_queue=args.max_queue or None, policy=args.policy,
            heartbeat_miss=args.heartbeat_miss,
            backoff_base=args.backoff_base, max_flaps=args.max_flaps,
            redispatch=args.redispatch, tick_s=args.tick_ms / 1e3,
            check_every=args.check_every, faults=faults, clock=clock,
            registry=registry, fleet_sink=fleet_sink,
            replica_tick_sink=replica_tick_sink,
            prefix=args.prefix_cache, sched_policy=sched_policy,
            host_pages=host_pages, spec=args.spec, spec_k=args.spec_k,
            spec_ngram=args.spec_ngram, pools=pools,
            handoff_ticks=args.handoff_ticks, autoscale=autoscaler,
            transport=args.transport, lease_ticks=args.lease_ticks,
            rto_base=args.rto_base, log_handoffs=(args.log == "full"),
        )
        before = dict(_kernels.launches)
        t_wall = time.perf_counter()
        result = fleet.run(reqs)
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        wall_s = time.perf_counter() - t_wall
        s = result.summary()
        s["wall_s"] = round(wall_s, 3)
        s["wall_tokens_per_s"] = round(
            result.output_tokens / max(wall_s, 1e-9), 1)
        registry.set("serve.tokens_per_s", s["tokens_per_s"])
        registry.emit(metrics, mode="fleet", final=True)
        for rec in result.replica_log:
            metrics.log("replica", **rec)
        for rec in result.transport_log:
            metrics.log("transport", **rec)
        for ev in result.events:
            metrics.log("fault", **{"mode": "fleet", **ev})
        if metrics.jsonl_enabled and args.log == "full":
            for rec in result.handoff_log:
                metrics.log("handoff", **rec)
            for rec in result.request_records():
                metrics.log("request", **rec)
        # Alert totals are always stamped (zero and the empty CRC without
        # --slo), over every alert fired before the summary record.
        from ..obs.alerts import alerts_crc

        s["alerts_fired"] = (len(alert_engine.alerts)
                             if alert_engine is not None else 0)
        s["alerts_crc"] = (alert_engine.crc if alert_engine is not None
                           else alerts_crc([]))
        metrics.log("serve", **{
            "bench": "fleet", "policy": args.policy,
            "autoscale": bool(args.autoscale),
            "redispatch": args.redispatch,
            "spec": args.spec, "spec_k": args.spec_k,
            "replicas_initial": (sum(pools.values()) if pools
                                 else args.replicas),
            "rate": args.rate,
            "slots": args.slots, "page_size": args.page_size,
            "pages": pages, "compute": args.compute,
            "prefix_cache": bool(args.prefix_cache),
            "host_pages": host_pages,
            "transport": bool(args.transport),
            "lease_ticks": fleet.lease_ticks, **s,
        })
    line = {"bench": "fleet", "compute": args.compute,
            "policy": args.policy, **s}
    if args.compute == "engine":
        line["device"] = (torch.cuda.get_device_name(device)
                          if device.type == "cuda" else "cpu")
        line["kernel_launches"] = {k: _kernels.launches[k] - before[k]
                                   for k in SERVE_KERNELS}
        line["forwards"] = {
            "replicas": len(computes),
            "decode_ticks": sum(c.decode_ticks for c in computes),
            "prefill_chunks": sum(c.prefill_chunks for c in computes)}
    metric = {
        "metric": "fleet_tokens_per_s", "value": s["tokens_per_s"],
        "unit": "tokens/s (fleet-clock)",
        "wall_s": s["wall_s"],
        "wall_tokens_per_s": s["wall_tokens_per_s"],
        "requests": len(result.requests),
        "replicas": result.replicas_final,
        "redispatches": result.redispatches,
        "trace_crc": result.trace_crc,
    }
    return {"lines": [line, metric], "result": result, "fleet": fleet,
            "args": args, "model": model, "params": params,
            "computes": computes}


def fleet_bench_main(argv: list[str] | None = None) -> int:
    """`python -m mpi_cuda_cnn_tpu_torch fleet-bench`: the multi-replica
    storm harness. Every host-side decision runs on a FakeClock advanced
    --tick-ms per fleet tick, so the schedule is a pure function of the
    workload seed, the fault plan and the fleet's shape; latency and
    throughput are in fleet-clock units unless marked wall_*. Exit codes:
    0 done, 2 a refused flag, 1 a failed run."""
    try:
        out = fleet_bench(argv)
    except UsageError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in out["lines"]:
        print(json.dumps(line))
    return 0
