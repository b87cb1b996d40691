"""`python -m mpi_cuda_cnn_tpu_torch lm-bench` — transformer-LM
pretraining throughput (counterpart of the reference's
`scripts/bench_lm.py`).

The reference's flagship: a ~34M-param decoder-only LM (d 512, 8
layers, 8 heads, seq 2048, vocab 8192, batch 8) trained with AdamW on the
real train step (`train/lm.py`). By default the matrix {float32, bf16} x
{oracle, flash} plus bf16 + flash + the chunked cross-entropy at 512
(`--quick`: bf16 + flash only); one `lm_pretrain` JSON line per config,
then the `lm_tokens_per_s` summary line. `--moe-experts E` (with
`--moe-top-k`, `--moe-dispatch-chunk`) benches the MoE model; its rows
carry the dispatch chunk and its summary names `moe{E}k{k}`.
`--grad-accum N` accumulates each step over N interleaved micro-batches
(`parallel/dp.local_grads`), the sum held in `--accum-dtype` (bfloat16;
float32, the default, is the exact sum of the params' type); the rows
carry both, as the reference's do. On the card each row also carries the
step's peak memory (`peak_memory_bytes`).

Timing: after 3 warm-up steps, wall time over `--steps` steps that ends
in `torch.cuda.synchronize` (the loss is read once, at the end). Tokens
and init come from seed 0, as in the reference.
`mfu` uses the analytic model FLOPs (`lm_flops_per_token`) against the
H100 SXM data sheet's dense peaks (`obs/cost.py`'s table): 989 TFLOP/s
for the bf16 rows (tensor cores) and 67 TFLOP/s for the float32 rows
(TF32 is off, so float32 products run outside the tensor cores);
`--peak-tflops` overrides the bf16 peak (float32 scales with it). On the
CPU `mfu` is null.

    python -m mpi_cuda_cnn_tpu_torch lm-bench
    python -m mpi_cuda_cnn_tpu_torch lm-bench --device cpu --dim 32 \\
        --depth 1 --heads 2 --vocab 64 --seq 128 --batch 2 --steps 1
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

WARMUP = 3                 # untimed steps per config (the reference's)
SEED = 0                   # init and token seed (the reference's)


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m mpi_cuda_cnn_tpu_torch lm-bench",
        description="LM pretraining tokens/s and MFU on one device.")
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--depth", type=int, default=8)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=0,
                    help="0 = MHA; < heads = GQA")
    ap.add_argument("--pos", default="learned", choices=["learned", "rope"])
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=20,
                    help="timed steps per config, after 3 warm-up steps")
    ap.add_argument("--peak-tflops", type=float, default=None,
                    help="bf16 peak of the card (MFU denominator; float32 "
                         "rows scale it by 67/989). Default: H100 SXM")
    ap.add_argument("--quick", action="store_true",
                    help="bf16 + flash only (the headline config)")
    ap.add_argument("--ce-chunk", type=int, default=0,
                    help="chunked cross-entropy on every row (S-chunk "
                         "size); 0 = the default matrix")
    ap.add_argument("--remat", action="store_true",
                    help="torch.utils.checkpoint per block")
    ap.add_argument("--moe-experts", type=int, default=0,
                    help="0 = dense MLP; > 0 = MoE blocks")
    ap.add_argument("--moe-top-k", type=int, default=1,
                    help="experts per token (1 = Switch, 2 = GShard); the "
                         "MFU numerator counts k expert MLPs a token")
    ap.add_argument("--moe-dispatch-chunk", type=int, default=0,
                    help="route MoE tokens in chunks of this size; 0 = "
                         "the whole batch")
    ap.add_argument("--grad-accum", type=int, default=1,
                    help="micro-batches accumulated a step (must divide "
                         "--batch)")
    ap.add_argument("--accum-dtype", default=None,
                    choices=["bfloat16", "float32"],
                    help="the gradient sum's type under --grad-accum "
                         "(default: the params' float32, exact)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def bench_config(model, *, batch: int, seq: int, compute_dtype, attn_impl: str,
                 device: torch.device, steps: int = 20, warmup: int = WARMUP,
                 seed: int = SEED, ce_chunk: int = 0,
                 remat: bool = False, moe_dispatch_chunk: int = 0,
                 grad_accum: int = 1,
                 accum_dtype: torch.dtype | None = None
                 ) -> tuple[float, float]:
    """(seconds per step, final loss) of `steps` train steps after
    `warmup`, on one fixed random batch."""
    from .lm import make_lm_state, make_lm_train_step
    from .optimizer import make_optimizer

    opt = make_optimizer(3e-4, opt="adamw", schedule="constant")
    step_fn = make_lm_train_step(model, opt, attn_impl=attn_impl, seq_len=seq,
                                 device=device, compute_dtype=compute_dtype,
                                 remat=remat, ce_chunk=ce_chunk,
                                 moe_dispatch_chunk=moe_dispatch_chunk,
                                 grad_accum=grad_accum,
                                 accum_dtype=accum_dtype)
    state = make_lm_state(model, opt, seed, device=device)
    rng = np.random.default_rng(seed)
    toks = torch.from_numpy(
        rng.integers(0, model.vocab, (batch, seq + 1)).astype(np.int32))
    toks = toks.to(device)
    tokens, targets = toks[:, :-1], toks[:, 1:]

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        state, m = step_fn(state, tokens, targets)
    sync()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, m = step_fn(state, tokens, targets)
    sync()
    dt = (time.perf_counter() - t0) / steps
    return dt, float(m["loss"])


def lm_bench(argv: list[str] | None = None) -> dict:
    """Run the matrix; return {"lines": [per-config dicts], "summary":
    the summary dict}. Raises RuntimeError without a card when the card
    is asked for, NotImplementedError for a refused flag."""
    from .._device import resolve_device
    from ..data import prng
    from ..models.transformer import TransformerLM
    from ..obs.cost import peak_flops
    from ..ops import _kernels
    from .lm import count_params, lm_flops_per_token

    args = _parser().parse_args(argv)
    if args.accum_dtype == "float32":   # the exact sum: no cast round trip
        args.accum_dtype = None
    if args.grad_accum < 1 or args.batch % args.grad_accum:
        raise ValueError(f"batch {args.batch} not divisible by grad_accum "
                         f"{args.grad_accum}")
    if args.steps < 1:
        raise ValueError("--steps must be >= 1")
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    model = TransformerLM(vocab=args.vocab, dim=args.dim, heads=args.heads,
                          depth=args.depth, max_seq=args.seq,
                          kv_heads=args.kv_heads, pos=args.pos,
                          moe_experts=args.moe_experts,
                          moe_top_k=args.moe_top_k)
    peaks = {dt: peak_flops(dt, backend="cuda",
                            override_tflops=args.peak_tflops) / 1e12
             for dt in ("bfloat16", "float32")}
    if args.quick:
        configs = [("bfloat16", "flash", args.ce_chunk)]
    elif args.ce_chunk:
        configs = [(dt, impl, args.ce_chunk) for dt in ("float32", "bfloat16")
                   for impl in ("oracle", "flash")]
    else:
        ce_default = 512 if args.seq % 512 == 0 else args.seq
        configs = [("float32", "oracle", 0), ("float32", "flash", 0),
                   ("bfloat16", "oracle", 0), ("bfloat16", "flash", 0),
                   ("bfloat16", "flash", ce_default)]

    tokens_per_step = args.batch * args.seq
    flops_per_step = lm_flops_per_token(model, args.seq) * tokens_per_step
    nparams = count_params(model.init(prng.key(0), "meta"))  # shapes only
    lines, results = [], {}
    for dtype_name, impl, ce in configs:
        before = dict(_kernels.launches)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        dt, loss = bench_config(
            model, batch=args.batch, seq=args.seq,
            compute_dtype=torch.bfloat16 if dtype_name == "bfloat16" else None,
            attn_impl=impl, device=device, steps=args.steps, ce_chunk=ce,
            remat=args.remat, moe_dispatch_chunk=args.moe_dispatch_chunk,
            grad_accum=args.grad_accum,
            accum_dtype=(getattr(torch, args.accum_dtype)
                         if args.accum_dtype else None))
        launches = {k: _kernels.launches[k] - before[k]
                    for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
        key = f"{dtype_name}+{impl}" + (f"+ce{ce}" if ce else "")
        results[key] = {
            "step_ms": dt * 1e3,
            "tokens_per_s": tokens_per_step / dt,
            "mfu": (flops_per_step / dt / (peaks[dtype_name] * 1e12)
                    if cuda else None),
            "loss": loss,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if cuda else None),
        }
        line = {"bench": "lm_pretrain", "dtype": dtype_name, "attn": impl,
                "ce_chunk": ce, **results[key],
                "kernel_launches": launches}
        if args.moe_dispatch_chunk:
            line["moe_dispatch_chunk"] = args.moe_dispatch_chunk
        if args.grad_accum > 1:
            line["grad_accum"] = args.grad_accum
        if args.accum_dtype:
            line["accum_dtype"] = args.accum_dtype
        if args.remat:
            line["remat"] = True
        lines.append(line)
        if cuda:
            torch.cuda.empty_cache()
    best = max(results.items(), key=lambda kv: kv[1]["tokens_per_s"])
    summary = {
        "metric": "lm_tokens_per_s", "value": best[1]["tokens_per_s"],
        "unit": "tokens/s", "config": best[0], "mfu": best[1]["mfu"],
        "params": nparams,
        "model": f"d{args.dim}x{args.depth} h{args.heads} s{args.seq} "
                 f"v{args.vocab} b{args.batch}"
                 + (f" moe{args.moe_experts}k{args.moe_top_k}"
                    if args.moe_experts else ""),
        "flops_per_step": flops_per_step,
        "peak_tflops": peaks[best[0].split("+")[0]] if cuda else None,
        "device": torch.cuda.get_device_name(device) if cuda else "cpu",
        "note": f"wall time over {args.steps} steps after {WARMUP} "
                "warm-up steps, ending in torch.cuda.synchronize",
    }
    return {"lines": lines, "summary": summary}


def lm_bench_main(argv: list[str] | None = None) -> int:
    try:
        out = lm_bench(argv)
    except (ValueError, NotImplementedError) as e:  # a refused flag
        print(f"error: {e}", file=sys.stderr)
        return 2
    except RuntimeError as e:                        # no card
        print(f"error: {e}", file=sys.stderr)
        return 1
    for line in out["lines"]:
        print(json.dumps(line))
    print(json.dumps(out["summary"]))
    return 0
