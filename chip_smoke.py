#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`mpi_cuda_cnn_tpu_torch`) on
one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. device   the card's name and `nvidia-smi` name and power limit.
2. build    builds every CUDA kernel of the serving, CNN-training and
            LM-training paths from csrc/ (eight sources, one nvcc each,
            all started together); seconds taken, ptxas registers.
3. kernels  each kernel against its plain PyTorch version on the card
            at the shapes its path gives it (one `kernel_case` line per
            shape): max error against the stated tolerance (bf16 flash
            outputs: also a relative L2 error, per row or whole), median time
            over 30 launches (CUDA events), the plain version's time,
            one PyTorch library call's time where one computes the same
            function (TF32 off), and the least time the card could take.
            Serving: paged attention (K1), int8 weight matmul (K2).
            reference_cnn's batch-32 step: the float32 GEMM (K3) at its
            9 products, the direct conv (K4) at both forwards and at
            conv2's input gradient (K4'), the conv weight gradient (K5)
            at both convs. The LM's causal attention: flash forward (K7),
            dq (K8) and dk/dv (K9) at the flagship's B 8, S 2048, H 8,
            D 64 in float32 and bf16, and at a GQA shape (8 query over 2
            kv heads, B 2), with SDPA's forward and forward + backward
            as the yardstick.
4. serve    the serving bench at the full width of the decode flagship
            (d512 x 8 layers, 8 query / 2 KV heads, vocab 8192; random
            weights from --seed) through K1 and K2, with the launch
            counts held to the forward count.
5. agree    the first requests replayed through the plain versions on
            the card; where a token differs, the top-2 logit gap at that
            step must show a tie (< 1e-3), not a mismatch.
6. train    `train-bench --use-kernels`: reference_cnn on 60,000
            synthetic MNIST-shaped samples, batch 32, lr 0.1, the
            device-resident epoch; one warm-up epoch, one measured epoch
            of 1,875 steps, then the 10,000 test samples. The launches
            of K3/K4/K5 are held to 9/3/2 per step and 3/2/0 per eval
            batch; the test accuracy to the JAX package's on the CPU
            (tools/jax_train_reference.py) less a margin. Then one
            measured epoch of the same bench on PyTorch's own ops. Both
            are profiled for 50 steps (device busy time per step).
7. train_agree  50 steps from one init on the kernels and on PyTorch's
            own ops (TF32 off); params within a stated tolerance, eval
            predictions equal or tied (top-2 logit gap < 1e-3).
8. lm       `lm` at the LM flagship's width (d512 x 8 layers, 8 heads,
            seq 2048, batch 8; synthetic corpus, vocab 251) with flash
            attention: 30 steps and the eval, launches of K7/K8/K9 held
            to 8/8/8 per step and 8/0/0 per eval, the loss held to fall
            well below the first step's.
9. lm_bench `lm-bench` at the flagship (vocab 8192): {f32, bf16} x
            {oracle, flash} and bf16 + flash + chunked CE, 10 timed
            steps each; tokens/s and mfu per row, then the summary.
10. lm_profile  torch.profiler over flagship f32 and bf16 flash steps:
            device busy ms per step, idle share, the flash kernels' ms.
11. lm_agree  10 float32 steps from one init with attention on the
            kernels and on the oracle (TF32 off); the first step's
            gradients (per leaf), per-step losses and params within
            stated tolerances.

Then `nvidia-smi`'s name and power limit, the kernels line
({"kernels": [...]}, launches of K1/K2 from the serve phase, of
K3/K4/K5 from the train phase and of K7/K8/K9 from the lm phase) and,
last, the device line {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside it, the script fails before any
result.
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
# float32 rate outside the tensor cores, which is what every kernel here
# computes in (and the bound of float32 work).
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

# CNN kernels against their plain versions on the card. K3 and K4: both
# sides sum up to 1,568 (K3) or 288 (K4) float32 products in other
# orders, relative to the output's magnitude. K5: sums over up to 6,272
# pixels (conv1 at batch 32), relative to max|dW|.
CNN_GEMM_RTOL_OF_MAX = 1e-5
CONV_RTOL_OF_MAX = 1e-5
CONV_DW_RTOL_OF_MAX = 1e-4
# reference_cnn at batch 32: the three FC layers (d_in, d_out) and the
# two convs (h, w, cin, cout) with k3 s2 p1.
CNN_BATCH = 32
FC_SHAPES = [(1568, 200), (200, 200), (200, 10)]
CONV_SHAPES = [(28, 28, 1, 16), (14, 14, 16, 32)]
# The train phase: steps of the measured epoch, launches per training
# step and per eval batch (eval batch 2,048: 5 batches for 10,000).
TRAIN_ARGS = ["--use-kernels", "--num-train", "60000", "--num-test", "10000",
              "--epochs", "1"]
TRAIN_STEPS = 1875
EVAL_BATCHES = 5
PER_STEP = {"gemm_f32": 9, "conv_direct": 3, "conv_dw": 2}
PER_EVAL = {"gemm_f32": 3, "conv_direct": 2, "conv_dw": 0}
# tools/jax_train_reference.py on the CPU, same data, seed and epochs:
# 10,000 of 10,000 test samples. The port draws another init (a torch
# generator), hence the margin.
JAX_CPU_ACCURACY = 1.0
ACCURACY_MARGIN = 0.01
# train_agree: 50 steps from one init on both backends. Sums in other
# orders drift by ulps per step; a pre-activation within a few ulp of 0
# can take the other side of a ReLU in one run, which moves params by
# about 5e-4 (seen between the JAX package's own two XLA paths, and in
# this phase: 1.8e-5 and 4.9e-4 in two runs, as cuDNN's weight gradient
# on the PyTorch side is not the same run to run). A wrong kernel moves
# them by the order of the params themselves (0.1).
AGREE_STEPS = 50
AGREE_PARAM_ATOL = 5e-3

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet): the bound of
# the flash kernels on bf16 inputs, whatever units the kernel itself uses.
BF16_FLOPS = 989e12
# Flash attention (K7-K9) against their plain versions on the card.
# float32: both sides sum up to 2,048 float32 products in other orders,
# and the kernel's online softmax rescales per 64-key tile: 1e-5 of
# max|.|. bf16: the outputs carry 8 bits of mantissa, so the max error
# is only a guard against outliers (2e-2 of max|.|); the sharp checks are
# relative L2 errors. K7's o: per row (query, head), because late rows
# average more keys and are small (|o| ~ sqrt(e / row)), so a norm over
# the whole tensor would hide them. The kernel rounds p to bf16 against a
# running max per 64-key tile where the plain version rounds it against
# the row max, and both round o: each rounding is up to 2^-9 relative,
# a few of them per row make a few 1e-3, so 1e-2. K8, K9: whole-tensor
# L2 (a row of dq can be all cancellation, e.g. the first query's),
# 1e-3: they rebuild p from the same lse and round ds and p^T as their
# plain versions do, and came
# out bitwise equal on the card; 1e-3 leaves room for a bf16 ulp flipped
# by another summation order, and catches a gradient off by 0.1%.
FLASH_RTOL_OF_MAX = {"float32": 1e-5, "bfloat16": 2e-2}
FLASH_BF16_REL_L2 = {"flash_fwd": ("row", 1e-2), "flash_bwd_dq": ("tensor", 1e-3),
                     "flash_bwd_dkv": ("tensor", 1e-3)}
# (dtype, B, S, H, Hkv, D), causal: the LM flagship's attention (d512,
# 8 heads) in both types, and a GQA case (8 query heads over 2 kv heads).
FLASH_SHAPES = [("float32", 8, 2048, 8, 8, 64), ("bfloat16", 8, 2048, 8, 8, 64),
                ("float32", 2, 2048, 8, 2, 64), ("bfloat16", 2, 2048, 8, 2, 64)]
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# The lm phase: the LM flagship's width (scripts/bench_lm.py:101-116:
# d512, 8 layers, 8 heads, seq 2048, batch 8) through `lm` on the
# synthetic corpus (vocab 251) with flash attention: 30 steps, then the
# eval. Per step 8 launches of each kernel (one per layer); per eval 8 of
# K7 (no backward). The loss of the cyclic synthetic stream must fall
# well below the first step's (on the CPU at d128 it halves by step 25).
LM_MODEL_ARGS = ["--corpus", "synthetic", "--dim", "512", "--depth", "8",
                 "--heads", "8", "--seq-len", "2048", "--batch-size", "8",
                 "--lr", "1e-3"]
LM_ARGS = LM_MODEL_ARGS + ["--attn-impl", "flash", "--steps", "30",
                           "--warmup-steps", "5", "--log-every", "10"]
LM_STEPS = 30
LM_PER_STEP = {"flash_fwd": 8, "flash_bwd_dq": 8, "flash_bwd_dkv": 8}
LM_PER_EVAL = {"flash_fwd": 8, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
LM_LOSS_DROP = 0.7      # final loss below 0.7 x the first step's
# lm-bench at the flagship (vocab 8192): the full matrix, 10 timed steps
# after 3 warm-up steps each.
LM_BENCH_ARGS = ["--steps", "10"]
LM_BENCH_STEPS = 13
# lm_agree: 10 float32 steps of the lm phase's configuration from one
# init, attention on the kernels and on the oracle (TF32 off). The two
# attentions differ by float32 summation order (about 1e-6 relative), so
# the per-step losses of 16,384 tokens agree far inside 1e-4. Params:
# Adam divides each update by the root of its second moment, so where a
# gradient is about 0 a rounding difference can flip an update of size
# lr; over 10 steps params can differ by up to 2 x lr x steps there (the
# limit on the max) and by about lr x 1e-6 elsewhere: at most 0.1% of
# the params may end more than 1e-5 apart (the CPU test's 99.9%
# quantile). Adam's update does not see a gradient scaled by a
# constant, so the first step's gradients of the two attentions are
# also compared, leaf by leaf: float32 summation order moves them by
# about 1e-6 relative (L2), a wrong dq, dk or dv by far more than 1e-4.
LM_AGREE_ARGS = LM_MODEL_ARGS + ["--steps", "10", "--warmup-steps", "2",
                                 "--log-every", "1"]
LM_AGREE_LOSS_ATOL = 1e-4
LM_AGREE_APART_SHARE = 1e-3
LM_AGREE_GRAD_REL_L2 = 1e-4


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


def _check_err(name: str, got, want, rtol_of_max: float) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    tol = rtol_of_max * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max error {err} > {tol}")
    return err, tol


def cnn_gemm_case(torch, dev, role: str, d_in: int, d_out: int, gen) -> dict:
    """One of K3's products in a batch-32 step of an FC layer (d_in,
    d_out): the forward x @ W + b, the input gradient g @ W^T, or the
    weight gradient x^T @ g, with the operands as the step has them."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import gemm, gemm_plain

    def randn(*s):
        return torch.randn(*s, generator=gen).to(dev)

    x, w, b = randn(CNN_BATCH, d_in), randn(d_in, d_out) / d_in ** 0.5, randn(d_out)
    g = randn(CNN_BATCH, d_out)
    if role == "forward":
        args, kw, m, n, k = (x, w), {"bias": b}, CNN_BATCH, d_out, d_in
        library = lambda: torch.addmm(b, x, w)  # noqa: E731
    elif role == "input_grad":
        args, kw, m, n, k = (g, w), {"trans_b": True}, CNN_BATCH, d_in, d_out
        library = lambda: torch.mm(g, w.t())  # noqa: E731
    else:
        args, kw, m, n, k = (x, g), {"trans_a": True}, d_in, d_out, CNN_BATCH
        library = lambda: torch.mm(x.t(), g)  # noqa: E731
    got = gemm(*args, **kw)
    want = gemm_plain(*args, **kw)
    err, tol = _check_err(f"gemm_f32 {role} {d_in}x{d_out}", got, want,
                          CNN_GEMM_RTOL_OF_MAX)
    nbytes = 4 * (m * k + k * n + m * n + (n if role == "forward" else 0))
    bound_ms, bound_by = bound(nbytes, 2 * m * n * k)
    return {"kernel": "gemm_f32", "role": role, "M": m, "N": n, "K": k,
            "max_abs_err": err, "tolerance": tol,
            "ms": median_ms(torch, lambda: gemm(*args, **kw)),
            "plain_ms": median_ms(torch, lambda: gemm_plain(*args, **kw)),
            "library_ms": median_ms(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by}


def valid_taps(size_in: int, size_out: int, k: int, stride: int, pad: int,
               dil: int = 1) -> int:
    """(output position, tap) pairs along one axis whose input position
    is a real pixel of the dilated, padded input (not padding, not a
    dilation hole): the work a conv of this geometry needs."""
    total = 0
    for o in range(size_out):
        for t in range(k):
            v = o * stride + t - pad
            total += v >= 0 and v % dil == 0 and v // dil < size_in
    return total


def conv_direct_case(torch, dev, role: str, h: int, w: int, cin: int,
                     cout: int, gen) -> dict:
    """K4 in reference_cnn's step: a k3 s2 p1 forward, or (K4') the
    input gradient of one, a stride-1 conv over the undilated cotangent
    with lhs dilation 2 and flipped, in/out-swapped weights."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import (
        conv_direct,
        conv_direct_plain,
        conv_input_grad_pads,
    )

    F = torch.nn.functional
    oh, ow = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    wt = (torch.randn(3, 3, cin, cout, generator=gen) / (9 * cin) ** 0.5).to(dev)
    w_oihw = wt.permute(3, 2, 0, 1)
    if role == "forward":
        x = torch.rand(CNN_BATCH, h, w, cin, generator=gen).to(dev)
        kw = dict(stride=2, pads=(1, 1, 1, 1))
        x_nchw = x.permute(0, 3, 1, 2)
        library = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)  # noqa: E731
        (n_in, c, o, hin, win, hout, wout) = (CNN_BATCH, cin, cout, h, w, oh, ow)
        taps = (valid_taps(h, oh, 3, 2, 1) * valid_taps(w, ow, 3, 2, 1))
    else:
        x = torch.randn(CNN_BATCH, oh, ow, cout, generator=gen).to(dev)
        kw = dict(stride=1, pads=conv_input_grad_pads(h, w, 3, 3, 2, 1, oh, ow),
                  dil=2, flip=True)
        x_nchw = x.permute(0, 3, 1, 2)
        library = lambda: F.conv_transpose2d(  # noqa: E731
            x_nchw, w_oihw, stride=2, padding=1,
            output_padding=(h + 1) % 2)
        (n_in, c, o, hin, win, hout, wout) = (CNN_BATCH, cout, cin, oh, ow, h, w)
        pt, _, pl, _ = kw["pads"]
        taps = (valid_taps(oh, h, 3, 1, pt, 2) * valid_taps(ow, w, 3, 1, pl, 2))
    got = conv_direct(x, wt, **kw)
    want = conv_direct_plain(x, wt, **kw)
    if tuple(got.shape) != (n_in, hout, wout, o):
        raise AssertionError(f"conv_direct {role}: shape {tuple(got.shape)}")
    err, tol = _check_err(f"conv_direct {role} {h}x{w}x{cin}->{cout}", got,
                          want, CONV_RTOL_OF_MAX)
    lib_out = library()
    if role != "forward" and tuple(lib_out.shape) != (n_in, o, hout, wout):
        raise AssertionError(f"conv_transpose2d shape {tuple(lib_out.shape)}")
    nbytes = 4 * (x.numel() + wt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n_in * taps * c * o)
    return {"kernel": "conv_direct", "role": role, "N": n_in, "H": hin,
            "W": win, "C": c, "O": o, "OH": hout, "OW": wout,
            "max_abs_err": err, "tolerance": tol,
            "ms": median_ms(torch, lambda: conv_direct(x, wt, **kw)),
            "plain_ms": median_ms(torch, lambda: conv_direct_plain(x, wt, **kw)),
            "library_ms": median_ms(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_dw_case(torch, dev, h: int, w: int, cin: int, cout: int,
                 gen) -> dict:
    """K5 in reference_cnn's step: the weight gradient of a k3 s2 p1
    conv over a batch of 32."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import conv_dw, conv_dw_plain

    oh, ow = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    x = torch.rand(CNN_BATCH, h, w, cin, generator=gen).to(dev)
    g = torch.randn(CNN_BATCH, oh, ow, cout, generator=gen).to(dev)
    kw = dict(stride=2, padding=1, kh=3, kw=3)
    got = conv_dw(x, g, **kw)
    want = conv_dw_plain(x, g, **kw)
    err, tol = _check_err(f"conv_dw {h}x{w}x{cin}->{cout}", got, want,
                          CONV_DW_RTOL_OF_MAX)
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    taps = valid_taps(h, oh, 3, 2, 1) * valid_taps(w, ow, 3, 2, 1)
    nbytes = 4 * (x.numel() + g.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * CNN_BATCH * taps * cin * cout)
    return {"kernel": "conv_dw", "role": "weight_grad", "N": CNN_BATCH,
            "H": h, "W": w, "C": cin, "O": cout, "OH": oh, "OW": ow,
            "max_abs_err": err, "tolerance": tol,
            "ms": median_ms(torch, lambda: conv_dw(x, g, **kw)),
            "plain_ms": median_ms(torch, lambda: conv_dw_plain(x, g, **kw)),
            "library_ms": median_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (cout, cin, 3, 3), g_nchw, stride=2, padding=1)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def rel_l2(got, want, *, per_row: bool) -> float:
    """||got - want|| / ||want||: over the whole tensor, or the largest of
    it over the rows (the last dim)."""
    if per_row:
        return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    return ((got - want).norm() / want.norm()).item()


def sdpa_ms(torch, q, k, v, g) -> dict:
    """The yardstick: F.scaled_dot_product_attention (causal, GQA through
    enable_gqa) on the same inputs in its (B, H, S, D) layout, forward
    alone and forward + backward (dq, dk, dv)."""
    F = torch.nn.functional
    gqa = k.shape[2] != q.shape[2]
    qt, kt, vt, gt = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=True,
                                              enable_gqa=gqa)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, gt)

    with torch.no_grad():
        fwd_ms = median_ms(torch, fwd)
    return {"library_fwd_ms": fwd_ms, "library_fwd_bwd_ms": median_ms(torch, fwd_bwd)}


def flash_cases(torch, dev, dtype: str, b: int, s: int, h: int, hkv: int,
                d: int, gen) -> list[dict]:
    """K7, K8 and K9 on one causal attention shape (q (B, S, H, D), k/v
    (B, S, Hkv, D)), each against its plain version on the same inputs;
    the backward kernels take the plain forward's o and lse and a random
    cotangent. Bound: the causal pairs S (S + 1) / 2 per (batch, query
    head) times 2 D flops for each of the kernel's products (K7: q k^T and
    p v; K8: also dO v^T and ds k, less p v; K9: q k^T, dO v^T, p^T dO and
    ds^T q), at the input type's peak; or each input read once and each
    output written once at the HBM rate, if that is longer."""
    from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev).to(tdt)

    q, k, v, g = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d), \
        randn(b, s, h, d)
    o, lse = fa.flash_forward_plain(q, k, v, True)
    dvec = fa.row_dvec(o, g)
    el = q.element_size()
    rows_q, rows_kv, rows = b * s * h * d, b * s * hkv * d, 4 * b * h * s
    runs = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v, True),
                      lambda: fa.flash_forward_plain(q, k, v, True), 2,
                      el * (2 * rows_q + 2 * rows_kv) + rows),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, g, lse, dvec, True),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, dvec,
                                                       True), 3,
                         el * (3 * rows_q + 2 * rows_kv) + 2 * rows),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dvec, True),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                                         dvec, True), 4,
                          el * (2 * rows_q + 4 * rows_kv) + 2 * rows)}
    lib = sdpa_ms(torch, q, k, v, g)
    pairs = s * (s + 1) // 2
    peak = F32_FLOPS if dtype == "float32" else BF16_FLOPS
    out = []
    for name, (run, plain, products, nbytes) in runs.items():
        got, want = run(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = tol = 0.0
        rel = None
        for i, (a, w) in enumerate(zip(got, want)):
            # lse is float32 arithmetic on either input type
            rtol = FLASH_RTOL_OF_MAX["float32" if a.dtype == torch.float32
                                     else dtype]
            what = f"{name} {dtype} B={b} H={h} Hkv={hkv} output {i}"
            e, t = _check_err(what, a.float(), w.float(), rtol)
            err, tol = max(err, e), max(tol, t)
            if a.dtype == torch.bfloat16:
                over, rtol_l2 = FLASH_BF16_REL_L2[name]
                r = rel_l2(a.float(), w.float(), per_row=over == "row")
                if not r <= rtol_l2:
                    raise AssertionError(f"{what}: relative L2 error {r} "
                                         f"(per {over}) > {rtol_l2}")
                rel = {"rel_l2_err": max(r, (rel or {}).get("rel_l2_err", 0.0)),
                       "rel_l2_tolerance": rtol_l2, "rel_l2_per": over}
        flops = 2 * d * products * b * h * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                              else (t_ops, "operations"))
        out.append({"kernel": name, "dtype": dtype, "B": b, "S": s, "H": h,
                    "Hkv": hkv, "D": d, "causal": True,
                    "max_abs_err": err, "tolerance": tol, **(rel or {}),
                    "ms": median_ms(torch, run),
                    "plain_ms": median_ms(torch, plain),
                    "library_ms": (lib["library_fwd_ms"]
                                   if name == "flash_fwd" else None),
                    **lib, "flops": flops, "bound_ms": bound_ms,
                    "bound_by": bound_by})
    return out


def phase_flash_kernels(torch, dev, gen) -> list[dict]:
    cases = []
    for shape in FLASH_SHAPES:
        for case in flash_cases(torch, dev, *shape, gen):
            emit({"phase": "kernel_case", **case})
            cases.append(case)
    return cases


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
    for role in ("forward", "input_grad", "weight_grad"):
        for d_in, d_out in FC_SHAPES:
            cases.append(cnn_gemm_case(torch, dev, role, d_in, d_out, gen))
            emit({"phase": "kernel_case", **cases[-1]})
    for h, w, cin, cout in CONV_SHAPES:
        cases.append(conv_direct_case(torch, dev, "forward", h, w, cin, cout,
                                      gen))
        emit({"phase": "kernel_case", **cases[-1]})
    h, w, cin, cout = CONV_SHAPES[1]   # conv1's input needs no gradient
    cases.append(conv_direct_case(torch, dev, "input_grad", h, w, cin, cout,
                                  gen))
    emit({"phase": "kernel_case", **cases[-1]})
    for h, w, cin, cout in CONV_SHAPES:
        cases.append(conv_dw_case(torch, dev, h, w, cin, cout, gen))
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


def phase_train(torch) -> dict:
    """train-bench's path on the kernels with the launch counts zeroed
    just before and read just after; then one measured epoch of the same
    bench on PyTorch's own ops for comparison. Returns the launches per
    kernel."""
    import math

    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.bench import train_bench

    _kernels.reset_launches()
    out = train_bench(TRAIN_ARGS)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    line = out["line"]
    if line["steps_per_epoch"] != TRAIN_STEPS or line["backend"] != "cuda":
        raise AssertionError(f"train: {line['steps_per_epoch']} steps on "
                             f"{line['backend']}")
    for name in ("paged_attention", "int8_gemm"):
        if launches[name]:
            raise AssertionError(f"train launched {name}")
    for name, k in PER_STEP.items():
        measured = line["kernel_launches"][name]
        evals = line["eval_kernel_launches"][name]
        want_total = 2 * TRAIN_STEPS * k + EVAL_BATCHES * PER_EVAL[name]
        if (measured != TRAIN_STEPS * k
                or evals != EVAL_BATCHES * PER_EVAL[name]
                or launches[name] != want_total):
            raise AssertionError(
                f"{name}: {measured} launches in the measured epoch (want "
                f"{k} x {TRAIN_STEPS}), {evals} in eval (want "
                f"{PER_EVAL[name]} x {EVAL_BATCHES}), {launches[name]} in "
                f"all (want {want_total}, warm-up epoch included)")
    acc = line["ncorrect"] / line["ntests"]
    if line["ntests"] != 10_000 or acc < JAX_CPU_ACCURACY - ACCURACY_MARGIN:
        raise AssertionError(f"train: test accuracy {acc} "
                             f"({line['ncorrect']}/{line['ntests']}) below "
                             f"{JAX_CPU_ACCURACY} - {ACCURACY_MARGIN}")
    if not all(math.isfinite(line[k]) for k in ("loss", "etotal", "acc")):
        raise AssertionError(f"train: non-finite metrics {line}")
    emit({"phase": "train", "epoch_s": line["value"],
          "device_epoch_s": line["device_epoch_s"],
          "step_ms": line["step_ms"], "samples_per_s": line["samples_per_s"],
          "steps": line["steps_per_epoch"], "loss": line["loss"],
          "etotal": line["etotal"], "acc": line["acc"], "ntests": line["ntests"],
          "ncorrect": line["ncorrect"], "launches": launches,
          "measured_epoch_launches": line["kernel_launches"],
          "eval_launches": line["eval_kernel_launches"],
          "reference_accuracy": JAX_CPU_ACCURACY,
          "accuracy_margin": ACCURACY_MARGIN, "bench_line": line})
    prof = profile_steps(torch, out["trainer"])
    if prof["device_busy_ms_per_step"] is not None:
        prof["device_idle_share"] = 1 - prof["device_busy_ms_per_step"] / line["step_ms"]
    emit({"phase": "train_profile", **prof})
    plain_out = train_bench([a for a in TRAIN_ARGS if a != "--use-kernels"])
    plain = plain_out["line"]
    plain_prof = profile_steps(torch, plain_out["trainer"])
    if plain_prof["device_busy_ms_per_step"] is not None:
        plain_prof["device_idle_share"] = (
            1 - plain_prof["device_busy_ms_per_step"] / plain["step_ms"])
    emit({"phase": "train_torch_ops", "epoch_s": plain["value"],
          "device_epoch_s": plain["device_epoch_s"],
          "step_ms": plain["step_ms"], "samples_per_s": plain["samples_per_s"],
          "loss": plain["loss"], "acc": plain["acc"],
          "ntests": plain["ntests"], "ncorrect": plain["ncorrect"],
          "profile": plain_prof})
    return launches


def profile_device(torch, run, steps: int, match: tuple = ()) -> dict:
    """`run()` called `steps` times under torch.profiler: kernel time by
    name, summed, against the window's wall time, and the time of the
    kernels whose names hold one of `match`. The profiler slows the host,
    so an idle share is read against an unprofiled step time by the
    caller."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_type", None) is not None
              and str(e.device_type).endswith("CUDA")]
    dev_us = {e.key: getattr(e, "self_device_time_total",
                             getattr(e, "self_cuda_time_total", 0))
              for e in events}
    total = sum(dev_us.values())
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    out = {"steps": steps, "profiled_wall_ms_per_step": 1e3 * wall / steps,
           "device_busy_ms_per_step": total / 1e3 / steps if total else None,
           "kernels_per_step": sum(e.count for e in events) / steps,
           "top_device_us_per_step": {k: v / steps for k, v in top}}
    if match:
        out["matched_ms_per_step"] = sum(
            v for k, v in dev_us.items() if any(m in k for m in match)
        ) / 1e3 / steps
    return out


def profile_steps(torch, trainer, steps: int = 50) -> dict:
    """Device time of `steps` training steps of the device-resident path
    (the same gather, normalize, one-hot and step as `run_epoch`)."""
    from mpi_cuda_cnn_tpu_torch.data.pipeline import PIXEL_SCALE

    b = trainer.cfg.batch_size
    batches = iter(torch.arange(steps * b, device=trainer.device)
                   .reshape(steps, b))

    def run():
        idx = next(batches)
        x = trainer._dev_images.index_select(0, idx).float() / PIXEL_SCALE
        y = (trainer._dev_labels.index_select(0, idx)[:, None]
             == trainer._classes).float()
        trainer.train_step(x, y)

    return profile_device(torch, run, steps)


def phase_train_agree(torch) -> dict:
    """AGREE_STEPS steps of reference_cnn from one init on the kernels
    and on PyTorch's own ops, on the card with TF32 off."""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.config import Config
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    model = get_model("reference_cnn")
    ds = synthetic_stripes(num_train=AGREE_STEPS * CNN_BATCH, num_test=2048)
    params = model.init(torch.Generator().manual_seed(0),
                        get_initializer("normal"))
    runs = {}
    for use_kernels in (True, False):
        cfg = Config(epochs=1, batch_size=CNN_BATCH, lr=0.1, device="cuda",
                     use_kernels=use_kernels, log_every=0, eval_every=0)
        tr = Trainer(model, ds, cfg, metrics=MetricsLogger(echo=False),
                     params=params)
        em = tr.run_epoch(0)
        x = torch.from_numpy(tr.test_x).to(tr.device)
        runs[use_kernels] = (tr, em, tr.predict(x).float())
    (tk, ek, lk), (tt, et, lt) = runs[True], runs[False]
    diff = max((a - b).abs().max().item() for a, b in
               zip(tree_leaves(tk.params), tree_leaves(tt.params)))
    if not diff <= AGREE_PARAM_ATOL:
        raise AssertionError(f"train_agree: params differ by {diff} > "
                             f"{AGREE_PARAM_ATOL} after {AGREE_STEPS} steps")
    labels = torch.from_numpy(tt.test_labels).to(lt.device).long()
    pk, pt = lk.argmax(-1), lt.argmax(-1)
    top2 = torch.topk(lt, 2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    differ = (pk != pt).nonzero().flatten().tolist()
    gaps = [gap[i].item() for i in differ]
    if any(g > TIE_GAP for g in gaps):
        raise AssertionError(f"train_agree: predictions differ at {differ} "
                             f"with top-2 gaps {gaps} (tie rule {TIE_GAP})")
    return {"steps": ek["steps"], "param_max_abs_diff": diff,
            "tolerance": AGREE_PARAM_ATOL,
            "loss": {"cuda": ek["loss"], "torch": et["loss"]},
            "ncorrect": {"cuda": int((pk == labels).sum()),
                         "torch": int((pt == labels).sum())},
            "ntests": len(labels), "predictions_differ": len(differ),
            "differ_top2_gaps": gaps, "tie_gap": TIE_GAP,
            "logit_max_abs_diff": (lk - lt).abs().max().item()}


class RecordingMetrics:
    """A MetricsLogger that keeps the trainer's records and prints none."""

    def __init__(self):
        self.records = []

    def log(self, event: str, **fields) -> None:
        self.records.append({"event": event, **fields})


def phase_lm(torch) -> dict:
    """`lm` at the flagship width through the flash kernels, with the
    launch counts zeroed just before `train` (the steps and the eval) and
    read just after. Returns the launches per kernel."""
    import math

    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.lm import count_params, get_attn_fn, lm_loss
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    cfg = parse_lm_args(LM_ARGS)
    metrics = RecordingMetrics()
    trainer = LMTrainer(cfg, metrics=metrics)
    if trainer.attn_impl != "flash" or trainer.device.type != "cuda":
        raise AssertionError(f"lm: {trainer.attn_impl} on {trainer.device}")
    # The first step's loss: step 0's batch through the initial params.
    tokens, targets = (trainer._to_device(a) for a in trainer._sample_batch(0))
    with torch.no_grad():
        first = float(lm_loss(trainer.model, trainer.state["params"], tokens,
                              targets, attn_fn=get_attn_fn("flash")))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    for name in _kernels.KERNELS:
        want = (LM_PER_STEP[name] * LM_STEPS + LM_PER_EVAL[name]
                if name in LM_PER_STEP else 0)
        if launches[name] != want:
            raise AssertionError(f"lm: {name} launched {launches[name]} "
                                 f"times, want {want}")
    if not (math.isfinite(result.eval_loss) and math.isfinite(result.final_loss)
            and result.final_loss < LM_LOSS_DROP * first):
        raise AssertionError(f"lm: first loss {first}, final "
                             f"{result.final_loss}, eval {result.eval_loss}")
    tokens_per_step = cfg.batch_size * cfg.seq_len
    emit({"phase": "lm", "steps": result.steps_run, "first_loss": first,
          "logged_losses": {r["step"]: r["loss"] for r in metrics.records},
          "loss": result.final_loss, "eval_loss": result.eval_loss,
          "eval_ppl": result.eval_ppl, "tokens_per_s": result.tokens_per_s,
          "step_ms": 1e3 * tokens_per_step / result.tokens_per_s,
          "wall_s": wall_s, "vocab": trainer.model.vocab,
          "params": count_params(trainer.state["params"]),
          "attn_impl": trainer.attn_impl, "launches": launches,
          "per_step": LM_PER_STEP, "per_eval": LM_PER_EVAL,
          "loss_drop": LM_LOSS_DROP})
    return launches


def phase_lm_bench(torch) -> dict:
    """`lm-bench` at the flagship: the full matrix."""
    import math

    from mpi_cuda_cnn_tpu_torch.train.lm_bench import lm_bench

    out = lm_bench(LM_BENCH_ARGS)
    for line in out["lines"]:
        want = LM_BENCH_STEPS * 8 if line["attn"] == "flash" else 0
        if (set(line["kernel_launches"].values()) != {want}
                or not math.isfinite(line["loss"])):
            raise AssertionError(f"lm_bench: {line}")
        emit({"phase": "lm_bench", **line})
    emit({"phase": "lm_bench", **out["summary"]})
    return out


def phase_lm_profile(torch, steps: int = 3) -> None:
    """torch.profiler over a few flagship steps (vocab 8192, flash), f32
    and bf16: device busy ms per step against the unprofiled step time,
    the flash kernels' share, the top device kernels."""
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.train.lm import make_lm_state, make_lm_train_step
    from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer

    dev = torch.device("cuda")
    model = TransformerLM(vocab=8192, dim=512, heads=8, depth=8, max_seq=2048)
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, model.vocab, (8, 2049), generator=gen).to(dev)
    for dtype in (None, torch.bfloat16):
        opt = make_optimizer(3e-4, opt="adamw", schedule="constant")
        step = make_lm_train_step(model, opt, attn_impl="flash", seq_len=2048,
                                  device=dev, compute_dtype=dtype)
        state = make_lm_state(model, opt, 0, device=dev)

        def run():
            step(state, toks[:, :-1], toks[:, 1:])

        for _ in range(2):
            run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            run()
        torch.cuda.synchronize()
        step_ms = 1e3 * (time.perf_counter() - t0) / steps
        prof = profile_device(torch, run, steps, match=("flash_",))
        busy = prof["device_busy_ms_per_step"]
        emit({"phase": "lm_profile",
              "dtype": "bfloat16" if dtype else "float32", "attn": "flash",
              "step_ms": step_ms,
              "device_idle_share": None if busy is None else 1 - busy / step_ms,
              **prof})
        del state
        torch.cuda.empty_cache()


def first_grads_rel_l2(torch, trainer, get_attn_fn, lm_loss,
                       tree_leaves) -> dict:
    """Relative L2 gap, per param leaf, between the gradients of step 0's
    batch at the trainer's initial params with attention on the kernels
    and on the oracle (the leaves are named by their index)."""
    leaves = tree_leaves(trainer.state["params"])
    tokens, targets = (trainer._to_device(a) for a in trainer._sample_batch(0))
    grads = {impl: torch.autograd.grad(
        lm_loss(trainer.model, trainer.state["params"], tokens, targets,
                attn_fn=get_attn_fn(impl)), leaves)
        for impl in ("flash", "oracle")}
    return {i: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for i, (a, b) in enumerate(zip(grads["flash"], grads["oracle"]))}


def phase_lm_agree(torch) -> dict:
    """LM_AGREE_ARGS' 10 float32 steps from one init, attention on the
    kernels and on the oracle; the first step's gradients, per-step
    losses and final params held to the stated tolerances."""
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.train.lm import get_attn_fn, lm_loss
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    runs, grad_rel = {}, None
    for impl in ("flash", "oracle"):
        cfg = parse_lm_args(LM_AGREE_ARGS + ["--attn-impl", impl])
        metrics = RecordingMetrics()
        trainer = LMTrainer(cfg, metrics=metrics)
        if grad_rel is None:
            grad_rel = first_grads_rel_l2(torch, trainer, get_attn_fn, lm_loss,
                                          tree_leaves)
        result = trainer.train()
        runs[impl] = ([r["loss"] for r in metrics.records], result,
                      [t.detach() for t in tree_leaves(trainer.state["params"])])
        del trainer
        torch.cuda.empty_cache()
    (lf, rf, pf), (lo, ro, po) = runs["flash"], runs["oracle"]
    loss_diff = max(abs(a - b) for a, b in zip(lf, lo))
    param_diff = max((a - b).abs().max().item() for a, b in zip(pf, po))
    moved = sum(int(((a - b).abs() > 1e-5).sum()) for a, b in zip(pf, po))
    total = sum(a.numel() for a in pf)
    lr, steps = cfg.lr, cfg.steps
    worst_grad = max(grad_rel.values())
    if len(lf) != steps or not loss_diff <= LM_AGREE_LOSS_ATOL \
            or not param_diff <= 2 * lr * steps \
            or not moved <= LM_AGREE_APART_SHARE * total \
            or not worst_grad <= LM_AGREE_GRAD_REL_L2:
        raise AssertionError(f"lm_agree: losses {lf} vs {lo} (max diff "
                             f"{loss_diff}), params differ by {param_diff}, "
                             f"{moved} of {total} apart by > 1e-5, first "
                             f"gradients by {grad_rel}")
    return {"steps": steps, "losses": {"flash": lf, "oracle": lo},
            "loss_max_abs_diff": loss_diff, "loss_tolerance": LM_AGREE_LOSS_ATOL,
            "param_max_abs_diff": param_diff, "param_tolerance": 2 * lr * steps,
            "params_apart_1e-5": moved, "params": total,
            "apart_share_tolerance": LM_AGREE_APART_SHARE,
            "first_grad_rel_l2_max": worst_grad,
            "first_grad_rel_l2_tolerance": LM_AGREE_GRAD_REL_L2,
            "eval_loss": {"flash": rf.eval_loss, "oracle": ro.eval_loss}}


def kernels_line(cases: list[dict], launches: dict) -> dict:
    """The per-kernel record: launches from each kernel's own path (serve
    for K1/K2, train for K3/K4/K5, lm for K7/K8/K9), the largest error
    over every case, and the times at one shape of the main path: the
    decode tick (int8 pages at B = slots; the head's 512 x 8192 weight),
    for the CNN kernels fc1's forward, conv2's forward and conv1's weight
    gradient, and for the flash kernels the LM flagship's attention in
    float32."""
    summary = []
    for name, src, replaces, rep in (
            ("paged_attention", "mpi_cuda_cnn_tpu_torch/csrc/paged_attention.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_paged_attention.py:86",
             lambda c: c["dtype"] == "int8" and c["kk"] == 1),
            ("int8_gemm", "mpi_cuda_cnn_tpu_torch/csrc/int8_gemm.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_gemv.py:140",
             lambda c: c["N"] == 8 and c["dout"] == 8192),
            ("gemm_f32", "mpi_cuda_cnn_tpu_torch/csrc/gemm_f32.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:59",
             lambda c: c["role"] == "forward" and c["K"] == 1568),
            ("conv_direct", "mpi_cuda_cnn_tpu_torch/csrc/conv_direct.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:136",
             lambda c: c["role"] == "forward" and c["C"] == 16),
            ("conv_dw", "mpi_cuda_cnn_tpu_torch/csrc/conv_dw.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:264",
             lambda c: c["C"] == 1),
            ("flash_fwd", "mpi_cuda_cnn_tpu_torch/csrc/flash_fwd.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_attention.py:249", _flagship_f32),
            ("flash_bwd_dq", "mpi_cuda_cnn_tpu_torch/csrc/flash_bwd_dq.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_attention.py:434", _flagship_f32),
            ("flash_bwd_dkv", "mpi_cuda_cnn_tpu_torch/csrc/flash_bwd_dkv.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_attention.py:460", _flagship_f32)):
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
                                        "dout", "role", "M", "K", "S", "H",
                                        "Hkv", "D", "W", "C", "O") if k in r}})
    return {"kernels": summary}


def _flagship_f32(case: dict) -> bool:
    return case["dtype"] == "float32" and case["B"] == 8


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
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    disable_tf32()   # the library yardsticks and plain versions in float32
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
    cases += phase_flash_kernels(torch, torch.device("cuda"),
                                 torch.Generator().manual_seed(1))

    out, serve_launches = phase_serve(torch, SERVE_ARGS)
    emit({"phase": "agree", **phase_agree(torch, out)})
    train_launches = phase_train(torch)
    emit({"phase": "train_agree", **phase_train_agree(torch)})
    lm_launches = phase_lm(torch)
    phase_lm_bench(torch)
    phase_lm_profile(torch)
    emit({"phase": "lm_agree", **phase_lm_agree(torch)})
    launches = {**{k: serve_launches[k] for k in ("paged_attention",
                                                  "int8_gemm")},
                **{k: train_launches[k] for k in PER_STEP},
                **{k: lm_launches[k] for k in FLASH_KERNELS}}
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
