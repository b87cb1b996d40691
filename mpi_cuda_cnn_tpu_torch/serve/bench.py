"""`python -m mpi_cuda_cnn_tpu_torch serve-bench` — the serving bench
(counterpart of the reference's `serve/bench.py`).

Drives the PagedEngine with a seeded workload of mixed prompt/output
lengths and prints, per mode, one JSON summary line: throughput, TTFT
and per-output-token latency percentiles, decode-tick, prefill-chunk and
preemption counts, the state-digest chain — the reference's line — plus
the device name and the serving kernels' launches in the measured run.
Weights are random, made from --seed.

    python -m mpi_cuda_cnn_tpu_torch serve-bench --device cpu \\
        --requests 8 --mode continuous
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


def make_workload(*, n: int, vocab: int, prompt_min: int, prompt_max: int,
                  out_min: int, out_max: int, rate: float, seed: int,
                  deadline_s: float = 0.0, tenants: int = 0) -> list[Request]:
    """n seeded requests: uniform prompt/output lengths in the given
    ranges, Poisson arrivals at `rate` req/s (rate 0 = everything at
    t=0), an absolute deadline of arrival + deadline_s when > 0, and
    seeded tenant tags "t0".."t{tenants-1}" when tenants > 0. The
    reference's draws in the reference's order, so both packages make
    the same requests bit for bit from the same seed."""
    rng = np.random.default_rng(seed)
    trng = np.random.default_rng([seed, 1])
    t = 0.0
    reqs = []
    for i in range(n):
        if rate > 0:
            t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(prompt_min, prompt_max + 1))
        olen = int(rng.integers(out_min, out_max + 1))
        prompt = rng.integers(0, vocab, (plen,)).astype(np.int32)
        tenant = (f"t{int(trng.integers(0, tenants))}" if tenants > 0
                  else None)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=olen,
                            arrival=t,
                            deadline=t + deadline_s if deadline_s > 0
                            else None, tenant=tenant))
    return reqs


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def serve_bench(argv: list[str] | None = None) -> dict:
    """Run the bench; return {"lines": [summary dict per mode],
    "results": {mode: ServeResult}, "engine", "model", "args"}.
    Raises ValueError on an inconsistent configuration."""
    from .._device import resolve_device
    from ..models.transformer import TransformerLM
    from ..ops import _kernels
    from .engine import PagedEngine
    from .pool import pages_for

    args = _parser().parse_args(argv)
    if args.prompt_max + args.out_max > args.max_seq:
        raise ValueError(f"prompt {args.prompt_max} + out {args.out_max} "
                         f"exceeds --max-seq {args.max_seq}")
    device = resolve_device(args.device)
    model = TransformerLM(vocab=args.vocab, dim=args.dim, heads=args.heads,
                          depth=args.depth, max_seq=args.max_seq,
                          kv_heads=args.kv_heads)
    params = model.init(torch.Generator().manual_seed(args.seed), device)
    max_len = args.prompt_max + args.out_max
    pages = args.pages or args.slots * pages_for(max_len, args.page_size) + 1
    engine = PagedEngine(
        model, params, slots=args.slots, num_pages=pages,
        page_size=args.page_size, prefill_chunk=args.prefill_chunk,
        cache_dtype=args.cache_dtype, max_len=max_len,
        attn_kernel=args.attn_kernel,
        weights_dtype=args.decode_weights_dtype, device=device,
    )
    modes = (["static", "continuous"] if args.mode == "both"
             else [args.mode])
    workload_kw = dict(
        n=args.requests, vocab=args.vocab, prompt_min=args.prompt_min,
        prompt_max=args.prompt_max, out_min=args.out_min,
        out_max=args.out_max, rate=args.rate, seed=args.seed,
    )
    # Warm up on one throwaway request (kernel build and load, CUDA
    # context, allocator) so no mode pays it inside its latencies.
    warm = engine.run(make_workload(**{**workload_kw, "n": 1, "rate": 0.0}),
                      mode=modes[0])
    backend = device.type
    device_name = (torch.cuda.get_device_name(device) if backend == "cuda"
                   else "cpu")
    lines, results = [], {}
    for mode in modes:
        before = dict(_kernels.launches)
        result = engine.run(make_workload(**workload_kw), mode=mode)
        if backend == "cuda":
            torch.cuda.synchronize(device)
        results[mode] = result
        lines.append({
            "bench": "serve", "backend": backend, "device": device_name,
            "cache_dtype": str(engine.cache_dtype).removeprefix("torch."),
            "attn_kernel": args.attn_kernel,
            "weights_dtype": engine.weights_dtype,
            "spec": "off", "spec_k": 8,
            **result.summary(),
            "kernel_launches": {k: _kernels.launches[k] - before[k]
                                for k in SERVE_KERNELS},
            "warmup_forwards": warm.decode_ticks + warm.prefill_chunks,
        })
    return {"lines": lines, "results": results, "engine": engine,
            "model": model, "args": args}


def serve_bench_main(argv: list[str] | None = None) -> int:
    try:
        out = serve_bench(argv)
    except (ValueError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in out["lines"]:
        print(json.dumps(line))
    return 0
