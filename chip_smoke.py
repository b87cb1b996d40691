#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`mpi_cuda_cnn_tpu_torch`) on
one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. device   the card's name and `nvidia-smi` name and power limit.
2. build    builds every CUDA kernel of the serving and CNN-training
            paths from csrc/ (one nvcc per source, all started
            together); seconds taken.
3. kernels  each kernel against its plain PyTorch version on the card
            at the shapes its path gives it (one `kernel_case` line per
            shape): max error against the stated tolerance, median time
            over 30 launches (CUDA events), the plain version's time,
            one PyTorch library call's time where one computes the same
            function (TF32 off), and the least time the card could take.
            Serving: paged attention (K1), int8 weight matmul (K2).
            reference_cnn's batch-32 step: the float32 GEMM (K3) at its
            9 products, the direct conv (K4) at both forwards and at
            conv2's input gradient (K4'), the conv weight gradient (K5)
            at both convs.
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

Then `nvidia-smi`'s name and power limit, the kernels line
({"kernels": [...]}, launches of K1/K2 from the serve phase and of
K3/K4/K5 from the train phase) and, last, the device line
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside it, the script fails before any result.
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
# computes in.
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


def profile_steps(torch, trainer, steps: int = 50) -> dict:
    """Device time of `steps` training steps of the device-resident path
    (the same gather, normalize, one-hot and step as `run_epoch`) under
    torch.profiler: kernel time by name, summed, against the window's
    wall time. The profiler slows the host, so the idle share is read
    against the unprofiled step time by the caller."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_cuda_cnn_tpu_torch.data.pipeline import PIXEL_SCALE

    b = trainer.cfg.batch_size
    perm = torch.arange(steps * b, device=trainer.device).reshape(steps, b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for idx in perm:
            x = trainer._dev_images.index_select(0, idx).float() / PIXEL_SCALE
            y = (trainer._dev_labels.index_select(0, idx)[:, None]
                 == trainer._classes).float()
            trainer.train_step(x, y)
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
    return {"steps": steps, "profiled_wall_ms_per_step": 1e3 * wall / steps,
            "device_busy_ms_per_step": total / 1e3 / steps if total else None,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top_device_us_per_step": {k: v / steps for k, v in top}}


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


def kernels_line(cases: list[dict], launches: dict) -> dict:
    """The per-kernel record: launches from each kernel's own path (serve
    for K1/K2, train for K3/K4/K5), the largest error over every case,
    and the times at one shape of the main path: the decode tick (int8
    pages at B = slots; the head's 512 x 8192 weight) and, for the CNN
    kernels, fc1's forward, conv2's forward and conv1's weight gradient."""
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
             lambda c: c["C"] == 1)):
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
                                        "dout", "role", "M", "K", "H", "W",
                                        "C", "O") if k in r}})
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

    out, serve_launches = phase_serve(torch, SERVE_ARGS)
    emit({"phase": "agree", **phase_agree(torch, out)})
    train_launches = phase_train(torch)
    emit({"phase": "train_agree", **phase_train_agree(torch)})
    launches = {**{k: serve_launches[k] for k in ("paged_attention",
                                                  "int8_gemm")},
                **{k: train_launches[k] for k in PER_STEP}}
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
