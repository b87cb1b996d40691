#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`mpi_cuda_cnn_tpu_torch`) on
one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. device   the card's name and `nvidia-smi` name and power limit.
2. build    builds every CUDA kernel of the serving path from csrc/
            (one nvcc per source, all started together); seconds taken.
3. kernels  each kernel against its plain PyTorch version on the card
            at the serving shapes (one `kernel_case` line per shape):
            max error against the stated tolerance, median time over
            30 launches (CUDA events), the plain version's time, one
            PyTorch library call's time where one computes the same
            function, and the least time the card could take.
4. serve    the serving bench at the full width of the decode flagship
            (d512 x 8 layers, 8 query / 2 KV heads, vocab 8192; random
            weights from --seed) through both kernels, with the launch
            counts held to the forward count.
5. agree    the first requests replayed through the plain versions on
            the card; where a token differs, the top-2 logit gap at that
            step must show a tie (< 1e-3), not a mismatch.

Then `nvidia-smi`'s name and power limit, the kernels line
({"kernels": [...]}, launches from the serve phase) and, last, the
device line {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, the script fails before any result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the
# float32 rate outside the tensor cores, which is what both kernels
# compute in.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

SERVE_ARGS = [
    "--dim", "512", "--depth", "8", "--heads", "8", "--kv-heads", "2",
    "--vocab", "8192", "--max-seq", "2048", "--cache-dtype", "auto",
    "--attn-kernel", "cuda", "--decode-weights-dtype", "auto",
    "--slots", "8", "--page-size", "16", "--prefill-chunk", "32",
    "--requests", "32", "--prompt-min", "64", "--prompt-max", "1024",
    "--out-min", "16", "--out-max", "256", "--rate", "0",
    "--mode", "continuous", "--seed", "0",
]
AGREE_REQUESTS = 4
TIE_GAP = 1e-3

# Kernel-vs-plain tolerances on the card. float32 and int8 pages: both
# sides sum in float32 in another order, and the kernel's online softmax
# is 1-2 ulp off the exact one. bf16 pages: the plain version rounds the
# probabilities to bf16 before the PV product (as the JAX package does);
# the kernel keeps them in float32. int8 weights: sums of up to 2048
# float32 products in two orders, relative to the output's magnitude.
ATTN_ATOL = {"float32": 1e-4, "bfloat16": 1e-2, "int8": 1e-4}
GEMM_RTOL_OF_MAX = 1e-4

HEADS, KV_HEADS, HEAD_DIM, PAGE, TABLE_PAGES = 8, 2, 64, 16, 80
GEMM_SHAPES = [(512, 512), (512, 256), (512, 2048), (2048, 512), (512, 8192)]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(torch, fn, reps: int = 30) -> float:
    """Median device time of one call of `fn`, from a CUDA event pair
    around each call. A spin kernel of about 5 ms is queued before each
    pair, so the card is still busy while the host enqueues the call and
    host time (up to that long) never shows up as device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(10_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_case(torch, dev, dtype: str, b: int, kk: int, gen) -> dict:
    """One paged-attention call at the serving shapes: a pool of b *
    TABLE_PAGES + 1 pages, distinct random block tables, positions that
    end mid-page."""
    from mpi_cuda_cnn_tpu_torch.models.generate import _quant_kv
    from mpi_cuda_cnn_tpu_torch.ops.attention import repeat_kv
    from mpi_cuda_cnn_tpu_torch.ops.paged_attention import (
        paged_attend,
        paged_attend_plain,
    )

    F = torch.nn.functional
    pool = b * TABLE_PAGES + 1
    L = TABLE_PAGES * PAGE
    shape = (pool, PAGE, KV_HEADS, HEAD_DIM)

    def randn(*s):
        return torch.randn(*s, generator=gen).to(dev)

    if dtype == "int8":
        k8, ks = _quant_kv(randn(*shape))
        v8, vs = _quant_kv(randn(*shape))
        c = {"k": k8, "ks": ks, "v": v8, "vs": vs}
    else:
        tdt = getattr(torch, dtype)
        c = {"k": randn(*shape).to(tdt), "v": randn(*shape).to(tdt)}
    perm = torch.randperm(pool - 1, generator=gen)[: b * TABLE_PAGES] + 1
    table = perm.reshape(b, TABLE_PAGES).to(torch.int32).to(dev)
    last = torch.randint(L // 2, L - 1, (b, 1), generator=gen)
    last = torch.where(last % PAGE == PAGE - 1, last - 1, last)  # mid-page
    positions = (last - kk + 1 + torch.arange(kk)[None, :]).to(torch.int32)
    positions = positions.to(dev)
    q = randn(b, kk, HEADS, HEAD_DIM)

    got = paged_attend(q, c, positions, table, PAGE)
    want = paged_attend_plain(q, c, positions, table, PAGE)
    err = (got - want).abs().max().item()
    tol = ATTN_ATOL[dtype]
    if not err <= tol:
        raise AssertionError(f"paged_attention {dtype} B={b} kk={kk}: "
                             f"max error {err} > {tol}")
    ms = median_ms(torch, lambda: paged_attend(q, c, positions, table, PAGE))
    plain_ms = median_ms(
        torch, lambda: paged_attend_plain(q, c, positions, table, PAGE))
    library_ms = None
    if dtype != "int8":
        # Yardstick only: SDPA over the already gathered, head-repeated
        # rows with the same mask.
        tbl = table.long()
        rows = {n: repeat_kv(c[n][tbl].reshape(b, L, KV_HEADS, HEAD_DIM),
                             HEADS).transpose(1, 2) for n in ("k", "v")}
        mask = (torch.arange(L, device=dev)[None, None, :]
                <= positions[:, :, None].long())[:, None]
        qs = q.to(rows["k"].dtype).transpose(1, 2)
        library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, rows["k"], rows["v"], attn_mask=mask))
    # Bound: q, table, positions and the output once each, plus the
    # pages each slot's rows can see (keys, values, int8 scales); the
    # operations are 4*hd per (query head, visible key).
    elem = c["k"].element_size()
    pos = positions.long().clamp(max=L - 1).cpu()
    pages_read = int(((pos.max(dim=1).values // PAGE) + 1).sum())
    page_bytes = PAGE * KV_HEADS * (2 * HEAD_DIM * elem
                                    + (8 if dtype == "int8" else 0))
    nbytes = (q.numel() * 4 + b * kk * HEADS * HEAD_DIM * 4 + table.numel() * 4
              + positions.numel() * 4 + pages_read * page_bytes)
    flops = 4 * HEAD_DIM * HEADS * int((pos + 1).sum())
    bound_ms, bound_by = bound(nbytes, flops)
    return {"kernel": "paged_attention", "dtype": dtype, "B": b, "kk": kk,
            "L": L, "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def gemm_case(torch, dev, n: int, din: int, dout: int, gen) -> dict:
    from mpi_cuda_cnn_tpu_torch.ops.gemv import (
        int8_gemv,
        int8_gemv_plain,
        quantize_weight,
    )

    w = quantize_weight((torch.randn(din, dout, generator=gen)
                         / din ** 0.5).to(dev))
    x = torch.randn(n, din, generator=gen).to(dev)
    got = int8_gemv(x, w)
    want = int8_gemv_plain(x, w)
    err = (got - want).abs().max().item()
    tol = GEMM_RTOL_OF_MAX * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"int8_gemm N={n} {din}x{dout}: max error "
                             f"{err} > {tol}")
    ms = median_ms(torch, lambda: int8_gemv(x, w))
    plain_ms = median_ms(torch, lambda: int8_gemv_plain(x, w))
    nbytes = n * din * 4 + din * dout + dout * 4 + n * dout * 4
    bound_ms, bound_by = bound(nbytes, 2 * n * din * dout)
    return {"kernel": "int8_gemm", "N": n, "din": din, "dout": dout,
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, "library_ms": None,
            "bound_ms": bound_ms, "bound_by": bound_by}


def phase_kernels(torch, dev) -> list[dict]:
    gen = torch.Generator().manual_seed(0)
    cases = []
    for dtype in ("float32", "bfloat16", "int8"):
        for b, kk in ((8, 1), (1, 32)):
            cases.append(attention_case(torch, dev, dtype, b, kk, gen))
            emit({"phase": "kernel_case", **cases[-1]})
    for n in (8, 32):
        for din, dout in GEMM_SHAPES:
            cases.append(gemm_case(torch, dev, n, din, dout, gen))
            emit({"phase": "kernel_case", **cases[-1]})
    return cases


def last_logits(torch, engine, ctx) -> "torch.Tensor":
    """Logits after `ctx` (a 1-d token array) through `engine`'s model,
    weights, cache dtype and attention read, prefilled chunk by chunk
    into a fresh single-slot paged cache."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.serve.paged_cache import (
        init_paged_cache,
        paged_forward,
    )
    from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for

    dev, chunk, ps = engine.device, engine.prefill_chunk, engine.page_size
    npg = pages_for(len(ctx), ps)
    cache = init_paged_cache(engine.model, slots=1, num_pages=npg + 1,
                             page_size=ps, dtype=engine.cache_dtype,
                             max_len=engine.max_len,
                             kernel=engine.attn_kernel, device=dev)
    cache.block_table[0, :npg] = torch.arange(1, npg + 1, dtype=torch.int32)
    with torch.no_grad():
        for c0 in range(0, len(ctx), chunk):
            n = min(chunk, len(ctx) - c0)
            toks = np.zeros((1, chunk), np.int64)
            toks[0, :n] = ctx[c0:c0 + n]
            pos = (c0 + torch.arange(chunk, dtype=torch.int32,
                                     device=dev))[None]
            valid = (torch.arange(chunk, device=dev) < n)[None]
            logits, cache = paged_forward(engine.model, engine.params,
                                          torch.from_numpy(toks).to(dev),
                                          pos, valid, cache)
    return logits[0, n - 1].float()


def phase_agree(torch, out) -> dict:
    """Replays the first requests through the plain versions on the card
    (gather read, dequantized float32 weights) and compares tokens."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.ops.gemv import dequantize_decode_params
    from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
    from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine

    eng, args = out["engine"], out["args"]
    plain = PagedEngine(
        eng.model, dequantize_decode_params(eng.params), slots=eng.slots,
        num_pages=eng.num_pages, page_size=eng.page_size,
        prefill_chunk=eng.prefill_chunk, cache_dtype=eng.cache_dtype,
        max_len=eng.max_len, attn_kernel="gather", weights_dtype="float32",
        device=eng.device)
    reqs = make_workload(n=args.requests, vocab=args.vocab,
                         prompt_min=args.prompt_min,
                         prompt_max=args.prompt_max, out_min=args.out_min,
                         out_max=args.out_max, rate=0.0,
                         seed=args.seed)[:AGREE_REQUESTS]
    replay = plain.run(reqs, mode="continuous")
    served = {r.rid: r for r in out["results"]["continuous"].requests}
    compared = equal = 0
    diverged = []
    for r in replay.requests:
        k_out = served[r.rid].out
        if len(k_out) != len(r.out):
            raise AssertionError(f"request {r.rid}: {len(k_out)} tokens "
                                 f"served vs {len(r.out)} replayed")
        t = next((i for i, (a, b) in enumerate(zip(k_out, r.out))
                  if a != b), None)
        compared += len(r.out) if t is None else t + 1
        equal += len(r.out) if t is None else t
        if t is None:
            continue
        ctx = np.concatenate([r.prompt, np.asarray(k_out[:t], np.int32)])
        lp = last_logits(torch, plain, ctx)
        lk = last_logits(torch, eng, ctx)
        top2 = torch.topk(lp, 2).values
        gap = float(top2[0] - top2[1])
        diverged.append({"rid": r.rid, "step": t, "served": k_out[t],
                         "plain": r.out[t], "plain_top2_gap": gap,
                         "logit_max_abs_diff":
                             float((lp - lk).abs().max())})
        if gap > TIE_GAP:
            raise AssertionError(f"request {r.rid} step {t}: kernel path "
                                 f"chose {k_out[t]}, plain {r.out[t]}, top-2 "
                                 f"gap {gap} > {TIE_GAP}")
    return {"requests": len(replay.requests), "tokens_compared": compared,
            "tokens_equal": equal, "diverged": diverged,
            "tie_gap": TIE_GAP}


def phase_serve(torch, argv: list[str]):
    """The serving bench through the port's entry point, with the launch
    counts zeroed just before and read just after. Returns (the bench's
    result dict, launches per kernel)."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import serve_bench

    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = serve_bench(argv)
    if out["engine"].device.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    line = out["lines"][0]
    args, model = out["args"], out["model"]
    emit({"phase": "serve", "wall_s": round(wall_s, 3), **line})
    forwards = line["decode_ticks"] + line["prefill_chunks"]
    all_forwards = forwards + line["warmup_forwards"]
    # One paged read per layer; wq, wkv, wo, w1, w2 per layer + the head.
    per_forward = {"paged_attention": model.depth,
                   "int8_gemm": 5 * model.depth + 1}
    for name, k in per_forward.items():
        if line["kernel_launches"][name] != k * forwards:
            raise AssertionError(
                f"{name}: {line['kernel_launches'][name]} launches in the "
                f"measured run, want {k} x {forwards} forwards")
        if launches[name] != k * all_forwards:
            raise AssertionError(
                f"{name}: {launches[name]} launches, want {k} x "
                f"{all_forwards} forwards (warm-up included)")
    if line["statuses"] != {"finished": args.requests}:
        raise AssertionError(f"statuses {line['statuses']}")
    for r in out["results"][args.mode].requests:
        if len(r.out) != r.max_new_tokens or not all(
                0 <= t < args.vocab for t in r.out):
            raise AssertionError(f"request {r.rid}: bad output {r.out[:8]}")
    return out, launches


def kernels_line(cases: list[dict], launches: dict) -> dict:
    """The per-kernel record: launches from the serve phase, the largest
    error over every case, and the times at the main path's decode-tick
    shape (int8 pages at B = slots; the head's 512 x 8192 weight)."""
    summary = []
    for name, src, replaces, rep in (
            ("paged_attention", "mpi_cuda_cnn_tpu_torch/csrc/paged_attention.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_paged_attention.py:86",
             lambda c: c["dtype"] == "int8" and c["kk"] == 1),
            ("int8_gemm", "mpi_cuda_cnn_tpu_torch/csrc/int8_gemm.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_gemv.py:140",
             lambda c: c["N"] == 8 and c["dout"] == 8192)):
        mine = [c for c in cases if c["kernel"] == name]
        r = next(c for c in mine if rep(c))
        summary.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"],
            "shape": {k: r[k] for k in ("dtype", "B", "kk", "L", "N", "din",
                                        "dout") if k in r}})
    return {"kernels": summary}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    try:
        import mpi_cuda_cnn_tpu_torch as pkg
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script: {e}",
              file=sys.stderr)
        return 1
    if Path(pkg.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported {pkg.__file__}, not the checkout "
              f"holding this script", file=sys.stderr)
        return 1
    if "jax" in sys.modules:
        raise AssertionError("jax was imported")
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    built = _kernels.build_all()
    report = {name: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
              for name, log in built["logs"].items()}
    emit({"phase": "build", "seconds": round(built["seconds"], 3),
          "kernels": sorted(_kernels.KERNELS), "ptxas": report})

    cases = phase_kernels(torch, torch.device("cuda"))

    out, launches = phase_serve(torch, SERVE_ARGS)
    emit({"phase": "agree", **phase_agree(torch, out)})
    line = kernels_line(cases, launches)
    print(smi, flush=True)
    emit(line)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main()
    except Exception:
        traceback.print_exc()
        rc = 1
    sys.exit(rc)
