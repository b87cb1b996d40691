#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`mpi_cuda_cnn_tpu_torch`) on
one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure raises and the script
exits non-zero without the final line:

1. device   the card's name and `nvidia-smi` name and power limit.
2. build    builds every CUDA kernel of the serving, CNN-training,
            conv-bench and LM-training paths from csrc/ (nine sources,
            one nvcc each, all started together); seconds taken, ptxas
            registers, and each library's tensor-core instruction count
            (`HMMA` lines of `cuobjdump -sass`), which must be above 0
            for the mma.sync kernels (gemm, conv_direct, conv_dw,
            conv_gemm, flash_fwd, flash_bwd_dq, flash_bwd_dkv), and
            in each head-dim instance of the float32 flash functions
            themselves (forward and backward, 3xTF32; `build_hmma`
            line); the flash kernels at D 64 in both types (the
            float32 forward: reported at every head dim, registers
            and spill bytes) and every bf16 instance of gemm,
            conv_gemm and conv_dw must show no ptxas spill stores.
3. kernels  each kernel against its plain PyTorch version on the card
            at the shapes its path gives it (one `kernel_case` line per
            shape): max error against the stated tolerance (bf16 flash
            outputs and float32 K8/K9 outputs: also a relative L2
            error, per row or whole), median time
            over 30 launches (CUDA events), the plain version's time,
            one PyTorch library call's time where one computes the same
            function (TF32 off), and the least time the card could take.
            Serving: paged attention (K1) at float32, bf16 and int8
            pages, decode and the prefill chunk, a ragged decode (one
            short slot beside long ones), and the serve phase's int8
            decode and prefill chunk at its own table width (128
            pages), each run twice and held equal bit for bit; int8
            weight matmul (K2, with
            torch._weight_int8pack_mm as the yardstick).
            reference_cnn's batch-32 step, in float32 and bf16: the GEMM
            (K3) at its 9 products and the eval batch's 3 forwards (M
            2,048), run twice at fc1's and fc2's forwards (split over
            K) and held equal bit for bit, the direct conv (K4) at both
            forwards and at conv2's input gradient (K4'), the conv
            weight gradient (K5) at both convs and at conv-bench's four
            stride-1 rows (batch 128: vgg_small's and cifar3conv's
            layers), run twice at conv2 and at the 32x32x64 row and
            held equal bit for bit; K4 also at conv-bench's
            second layer's input gradient (K4' at 128x32x32x64) and at a
            ragged stride-2 forward with one-sided pads. conv-bench's four
            stride-1 shapes, in float32 and bf16: the implicit-GEMM conv
            (K6), with F.conv2d on the same channels-last tensors as the
            yardstick. The LM's causal attention: flash forward (K7),
            dq (K8) and dk/dv (K9) at the flagship's B 8, S 2048, H 8,
            D 64 in float32 and bf16, and at a GQA shape (8 query over 2
            kv heads, B 2), with SDPA's forward, forward + backward
            and backward alone as the yardsticks; in both types also
            at D 32 and D 128 (B 2, S 1024, 4 over 2 heads, causal)
            and non-causal at D 64. float32 K7, K8 and K9 (3xTF32)
            are held to a relative L2 error too, and run twice at the
            flagship and GQA shapes and are held equal bit for bit.
4. serve    the serving bench at the full width of the decode flagship
            (d512 x 8 layers, 8 query / 2 KV heads, vocab 8192; random
            weights from --seed) through K1 and K2, with the launch
            counts held to the forward count.
5. agree    the first requests replayed through the plain versions on
            the card; where a token differs, the top-2 logit gap at that
            step must show a tie (< 1e-3), not a mismatch.
5b. serve_profile  torch.profiler over a few decode ticks of the serve
            phase's engine (every slot live, at positions in the
            bench's range): device ms per forward, K1's and K2's ms
            per forward, launches per forward, the idle share.
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
7b. train_bf16  the `train` command's path (`Trainer`) with bf16
            compute on the kernels: the train phase's data, one epoch,
            the 10,000-sample eval; launches held to 9/3/2 per step and
            3/2/0 per eval batch, the accuracy to the JAX package's bf16
            accuracy on the CPU less the margin, the first step's
            gradients on the kernels and on PyTorch's ops (both bf16)
            to a stated relative L2 per leaf; ms per step.
7c. conv_bench  `conv-bench` at full size (the reference's five shapes,
            float32 then bf16, 200 calls against 400): one line per row;
            K4 launched on every row, K6 on every stride-1 row and not
            on the stride-2 row.
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
            stated tolerances; then the first step's gradients in bf16
            compute, flash against the oracle, per leaf.

Then `nvidia-smi`'s name and power limit, the kernels line
({"kernels": [...]}, each source's C launch function and `__global__`
kernels; launches of K1/K2 from the serve phase, of
K3/K4/K5 from the train phase, of K6 from conv_bench and of K7/K8/K9
from the lm phase) and,
last, the device line {"ok": true, "device": {...}}. Without a CUDA
device, or without the package beside it, the script fails before any
result.
"""

from __future__ import annotations

import json
import math
import re
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
# serve_profile: decode ticks profiled, after warm-up ones.
SERVE_PROFILE_TICKS = 20
# The kernels built on mma.sync: their libraries must hold tensor-core
# instructions (HMMA in the SASS).
TENSOR_CORE_KERNELS = ("gemm", "conv_direct", "conv_dw", "conv_gemm",
                       "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Functions that must hold HMMA themselves, every instance of them
# (library, mangled-name fragment): the float32 flash forward and backward
# (3xTF32), whose libraries would pass the check above on their bf16
# kernels alone.
TENSOR_CORE_FUNCTIONS = (("flash_fwd", "flash_fwd_f32_kernel"),
                         ("flash_bwd_dq", "flash_bwd_dq_f32_kernel"),
                         ("flash_bwd_dkv", "flash_bwd_dkv_f32_kernel"))
# Kernel instances whose ptxas report must show no spill stores: the
# flash backward in both types and the float32 flash forward at the
# flagship's head dim (64), and every bf16 instance of the GEMM, the
# implicit-GEMM conv and the weight gradient. (library, mangled-name
# fragment)
NO_SPILL = (("gemm", "gemm_kernelI13__nv_bfloat16"),
            ("flash_fwd", "flash_fwd_f32_kernelILi64E"),
            ("flash_bwd_dq", "flash_bwd_dq_bf16_kernelILi64E"),
            ("flash_bwd_dkv", "flash_bwd_dkv_bf16_kernelILi64E"),
            ("flash_bwd_dq", "flash_bwd_dq_f32_kernelILi64E"),
            ("flash_bwd_dkv", "flash_bwd_dkv_f32_kernelILi64E"),
            ("conv_gemm", "conv_gemm_kernelI13__nv_bfloat16"),
            ("conv_dw", "conv_dw_kernelI13__nv_bfloat16"))
GEMM_SHAPES = [(512, 512), (512, 256), (512, 2048), (2048, 512), (512, 8192)]

# CNN kernels against their plain versions on the card. K3 and K4: both
# sides sum up to 1,568 (K3) or 288 (K4) float32 products in other
# orders, relative to the output's magnitude. K5: sums over up to 131,072
# pixels (conv-bench's 32 x 32 rows at batch 128; 6,272 at reference_cnn's
# conv1), relative to max|dW|. K6: sums of up to
# 1,152 float32 products (k3 over 128 channels), relative to max|y|.
CNN_GEMM_RTOL_OF_MAX = 1e-5
CONV_RTOL_OF_MAX = 1e-5
CONV_DW_RTOL_OF_MAX = 1e-4
CONV_GEMM_RTOL_OF_MAX = 1e-5
# bf16 (K3-K6): kernel and plain version both sum in float32 and round
# once to bf16 (K3 with a bias: twice, as the JAX package's
# `_matmul(x, w) + b`), so they differ only where a float32 sum in
# another order lands on the other side of a bf16 rounding boundary: by
# one bf16 ulp of that value. Held to a relative L2 error of 1e-2 and a
# max error of one bf16 ulp (2^-7 relative to the leading power of two)
# of the largest value rounded: max|want|, and for K3's forward also
# max|x @ W|, rounded before the bias is added.
BF16_REL_L2 = 1e-2
# reference_cnn at batch 32: the three FC layers (d_in, d_out) and the
# two convs (h, w, cin, cout) with k3 s2 p1.
CNN_BATCH = 32
FC_SHAPES = [(1568, 200), (200, 200), (200, 10)]
# K3 also at the eval batch's three forwards (M = 2,048, the trainer's
# eval batch), and twice at GEMM_REPEAT's step products (role, d_in,
# d_out): fc1's forward (split 17 ways over K = 1,568) and fc2's (K =
# 200, split 7 ways), whose two results must be equal bit for bit (the
# split sum has a fixed order).
EVAL_BATCH = 2048
GEMM_REPEAT = (("forward", 1568, 200), ("forward", 200, 200))
CONV_SHAPES = [(28, 28, 1, 16), (14, 14, 16, 32)]
CNN_DTYPES = ("float32", "bfloat16")
# K4 beyond reference_cnn's step, as (role, n, h, w, c, o, k, stride,
# pads, dil, flip): conv-bench's 128x32x32x64 -> 64 layer's input
# gradient (K4', k3 s1 p1: the transposed conv is a stride-1 conv over
# the cotangent with pads 1, flipped weights), and a ragged stride-2
# forward whose one-sided pads, odd extent and C = 24, O = 40 hit every
# edge mask of the tile.
CONV_EXTRA = [("input_grad", 128, 32, 32, 64, 64, 3, 1, (1, 1, 1, 1), 1, True),
              ("forward", 8, 15, 15, 24, 40, 3, 2, (1, 0, 1, 0), 1, False)]
# K5's weight gradients, (n, h, w, cin, cout, stride, padding), k3:
# reference_cnn's two convs at batch 32 (s2 p1), then conv-bench's four
# stride-1 rows at batch 128, which are vgg_small's and cifar3conv's
# layers (s1 p1). K5 runs twice at DW_REPEAT's shapes, whose two dw must
# be equal bit for bit (the sum over pixel chunks has a fixed order).
DW_SHAPES = ([(CNN_BATCH, h, w, cin, cout, 2, 1)
              for (h, w, cin, cout) in CONV_SHAPES]
             + [(128, 32, 32, 3, 64, 1, 1), (128, 32, 32, 64, 64, 1, 1),
                (128, 16, 16, 64, 128, 1, 1), (128, 8, 8, 128, 256, 1, 1)])
DW_REPEAT = ((CNN_BATCH, 14, 14, 16, 32, 2, 1), (128, 32, 32, 64, 64, 1, 1))
# The train phase: steps of the measured epoch, launches per training
# step and per eval batch (eval batch 2,048: 5 batches for 10,000).
TRAIN_ARGS = ["--use-kernels", "--num-train", "60000", "--num-test", "10000",
              "--epochs", "1"]
TRAIN_STEPS = 1875
EVAL_BATCHES = 5
PER_STEP = {"gemm": 9, "conv_direct": 3, "conv_dw": 2}
PER_EVAL = {"gemm": 3, "conv_direct": 2, "conv_dw": 0}
# tools/jax_train_reference.py on the CPU, same data, seed and epochs:
# 10,000 of 10,000 test samples, in float32 (two epochs) and, with
# --compute-dtype bfloat16, on the Pallas kernels in bf16 (one epoch, as
# the train_bf16 phase). The port draws another init (a torch
# generator), hence the margin.
JAX_CPU_ACCURACY = 1.0
JAX_CPU_BF16_ACCURACY = 1.0
ACCURACY_MARGIN = 0.01
# train_bf16: one epoch of the train phase's configuration with bf16
# compute on the kernels, then the eval. The first step's gradients on
# the kernels and on PyTorch's own ops (both in bf16, TF32 off) from the
# same params and batch, per leaf, relative L2: each side rounds every
# activation and gradient to bf16 (2^-9 relative), and where the two
# sums of a value land on two sides of a rounding boundary the flip
# propagates. 5.1e-4 measured at worst (fc3's weights); a kernel off by
# a factor is off by far more than 1e-2.
TRAIN_BF16_GRAD_REL_L2 = 1e-2
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
# every kernel on bf16 inputs, whatever units the kernel itself uses.
BF16_FLOPS = 989e12
PEAK = {"float32": F32_FLOPS, "bfloat16": BF16_FLOPS}
# The float32 flash kernels (K7, K8, K9) run 3xTF32: three tf32 products
# for each float32 one, at the H100's dense TF32 rate.
TF32_FLOPS = 495e12
TF32X3_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
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
# float32 K7, K8 and K9 run their products as 3xTF32 on the tensor cores
# (csrc/mma.cuh): each operand split into two tf32 values, three products
# summed in float32. Their error is that of float32 arithmetic in another
# order (a numpy emulation of the design gives about 4e-7 relative L2,
# tests/test_torch_flash_tf32x3.py); a whole-tensor relative L2 of 1e-5
# beside the 1e-5-of-max check catches a wrong or plain-tf32 product
# (about 1e-3) while leaving 20x room.
FLASH_F32_REL_L2 = 1e-5
FLASH_BF16_REL_L2 = {"flash_fwd": ("row", 1e-2), "flash_bwd_dq": ("tensor", 1e-3),
                     "flash_bwd_dkv": ("tensor", 1e-3)}
# (dtype, B, S, H, Hkv, D), causal: the LM flagship's attention (d512,
# 8 heads) in both types, and a GQA case (8 query heads over 2 kv heads).
FLASH_SHAPES = [("float32", 8, 2048, 8, 8, 64), ("bfloat16", 8, 2048, 8, 8, 64),
                ("float32", 2, 2048, 8, 2, 64), ("bfloat16", 2, 2048, 8, 2, 64)]
# Beyond the flagship, in both types, (dtype, B, S, H, Hkv, D, causal):
# the other head widths the kernels are built for, and a non-causal case.
FLASH_EXTRA_SHAPES = [(dtype, 2, 1024, 4, 2, d, causal)
                      for dtype in ("float32", "bfloat16")
                      for d, causal in ((32, True), (128, True), (64, False))]
# float32 K7, K8 and K9 run twice at the flagship and GQA shapes, (B, S,
# H, Hkv, D, causal), and are held equal to themselves bit for bit: each
# output element is summed in one fixed order (the GQA group too).
FLASH_REPEAT = [(b, s, h, hkv, d, True) for dtype, b, s, h, hkv, d
                in FLASH_SHAPES if dtype == "float32"]
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
# lm_agree in bf16 compute: the first step's gradients with flash and
# with the oracle, per leaf. Both round q, k, v, p and every activation
# to bf16 (2^-9 relative), but at other places: the oracle rounds p
# against the row max, K7 against a running max per 64-key tile, and
# K8/K9 round ds and p^T where the oracle's autograd rounds other
# intermediates; over 8 layers such flips add up to a few 1e-3. A wrong
# dq, dk or dv moves a leaf by far more than 2e-2.
LM_BF16_GRAD_REL_L2 = 2e-2


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sass_hmma_by_function(kernels, name: str) -> dict[str, int]:
    """HMMA instructions per function (mangled name) of kernel `name`'s
    built library, from the `Function : NAME` sections of `cuobjdump
    -sass`."""
    cuobjdump = Path(kernels._nvcc()).parent / "cuobjdump"
    out = subprocess.run([str(cuobjdump), "-sass", str(kernels._lib_path(name))],
                         capture_output=True, text=True, timeout=120, check=True)
    counts, fn = {}, None
    for ln in out.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn is not None and "HMMA" in ln:
            counts[fn] += 1
    return counts


def registers(log: str) -> dict[str, int]:
    """Registers per kernel (mangled name) in an `nvcc -Xptxas -v` log:
    the "Used N registers" line after each "Function properties for
    NAME"."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


def spill_stores(log: str) -> dict[str, int]:
    """Bytes of spill stores per kernel (mangled name) in an `nvcc
    -Xptxas -v` log: each "Function properties for NAME" line is followed
    by one with "N bytes spill stores"."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores", ln)
        if m and name is not None:
            out[name] = int(m.group(1))
            name = None
    return out


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


def bound(nbytes: float, flops: float,
          peak: float = F32_FLOPS) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_case(torch, dev, dtype: str, b: int, kk: int, gen,
                   ragged: bool = False, pages: int = TABLE_PAGES,
                   last_range: tuple[int, int] | None = None) -> dict:
    """One paged-attention call at the serving shapes: a pool of b *
    pages + 1 pages, distinct random block tables of `pages` pages,
    positions that end mid-page in [last_range) (by default the table's
    second half); `ragged`: slot 0's in its first page instead (one short
    slot beside long ones: most of its splits see no key). The kernel
    runs twice and its two outputs must be equal bit for bit (the splits
    are merged in a fixed order)."""
    from mpi_cuda_cnn_tpu_torch.models.generate import _quant_kv
    from mpi_cuda_cnn_tpu_torch.ops.attention import repeat_kv
    from mpi_cuda_cnn_tpu_torch.ops.paged_attention import (
        paged_attend,
        paged_attend_plain,
    )

    F = torch.nn.functional
    pool = b * pages + 1
    L = pages * PAGE
    lo, hi = last_range or (L // 2, L - 1)
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
    perm = torch.randperm(pool - 1, generator=gen)[: b * pages] + 1
    table = perm.reshape(b, pages).to(torch.int32).to(dev)
    last = torch.randint(lo, hi, (b, 1), generator=gen)
    last = torch.where(last % PAGE == PAGE - 1, last - 1, last)  # mid-page
    if ragged:
        last[0] = PAGE // 2 + kk - 1
    positions = (last - kk + 1 + torch.arange(kk)[None, :]).to(torch.int32)
    positions = positions.to(dev)
    q = randn(b, kk, HEADS, HEAD_DIM)

    got = paged_attend(q, c, positions, table, PAGE)
    want = paged_attend_plain(q, c, positions, table, PAGE)
    err = (got - want).abs().max().item()
    tol = ATTN_ATOL[dtype]
    what = f"paged_attention {dtype} B={b} kk={kk} L={L} ragged={ragged}"
    if not err <= tol:
        raise AssertionError(f"{what}: max error {err} > {tol}")
    again = paged_attend(q, c, positions, table, PAGE)
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two runs differ by "
                             f"{(got - again).abs().max().item()}")
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
            "L": L, "ragged": ragged, "bitwise_repeat": True,
            "max_abs_err": err, "tolerance": tol, "ms": ms,
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
    # Yardstick only: PyTorch's one call for x @ int8 W^T * scale, with the
    # weight laid out [dout, din] as it wants, outside the timed call.
    wt, scales = w.q.t().contiguous(), w.s.reshape(-1).contiguous()
    library = {"library": "torch._weight_int8pack_mm"}
    try:
        lib_y = torch._weight_int8pack_mm(x, wt, scales)
    except (AttributeError, RuntimeError) as e:
        library.update(library_ms=None, library_refused=str(e).splitlines()[0][:300])
    else:
        library.update(library_ms=median_ms(
            torch, lambda: torch._weight_int8pack_mm(x, wt, scales)),
            library_max_abs_err=(lib_y.float() - want).abs().max().item())
    nbytes = n * din * 4 + din * dout + dout * 4 + n * dout * 4
    bound_ms, bound_by = bound(nbytes, 2 * n * din * dout)
    return {"kernel": "int8_gemm", "N": n, "din": din, "dout": dout,
            "max_abs_err": err, "tolerance": tol, "ms": ms,
            "plain_ms": plain_ms, **library,
            "bound_ms": bound_ms, "bound_by": bound_by}


def _check_err(name: str, got, want, rtol_of_max: float) -> tuple[float, float]:
    err = (got - want).abs().max().item()
    tol = rtol_of_max * want.abs().max().item()
    if not err <= tol:
        raise AssertionError(f"{name}: max error {err} > {tol}")
    return err, tol


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at magnitude v: 2^-7 of v's leading power of two."""
    return 2.0 ** (math.floor(math.log2(v)) - 7) if v > 0 else 0.0


def check_case(torch, name: str, got, want, rtol_of_max: float,
               rounded_max: float | None = None) -> dict:
    """Kernel output against its plain version: float32 to `rtol_of_max`
    of max|want|; bf16 (BF16_REL_L2 and one bf16 ulp of the largest
    value rounded, max|want| unless `rounded_max` is larger) after the
    dtype is checked. Returns the error fields of a kernel_case line."""
    if got.dtype != want.dtype or tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{name}: got {got.dtype} {tuple(got.shape)}, "
                             f"want {want.dtype} {tuple(want.shape)}")
    if got.dtype == torch.float32:
        err, tol = _check_err(name, got, want, rtol_of_max)
        return {"max_abs_err": err, "tolerance": tol}
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = bf16_ulp(max(want.abs().max().item(), rounded_max or 0.0))
    rel = rel_l2(got, want, per_row=False)
    if not (err <= tol and rel <= BF16_REL_L2):
        raise AssertionError(f"{name}: max error {err} (limit {tol}), "
                             f"relative L2 {rel} (limit {BF16_REL_L2})")
    return {"max_abs_err": err, "tolerance": tol, "rel_l2_err": rel,
            "rel_l2_tolerance": BF16_REL_L2, "rel_l2_per": "tensor"}


def cnn_gemm_case(torch, dev, role: str, d_in: int, d_out: int, gen,
                  dtype: str) -> dict:
    """One of K3's products in a batch-32 step of an FC layer (d_in,
    d_out): the forward x @ W + b, the input gradient g @ W^T, or the
    weight gradient x^T @ g, with the operands as the step has them; or
    (`eval_forward`) the forward at the eval batch. At GEMM_REPEAT's
    products run twice, the two results held equal bit for bit."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import gemm, gemm_plain

    tdt = getattr(torch, dtype)

    def randn(*s):
        return torch.randn(*s, generator=gen).to(dev).to(tdt)

    rows = EVAL_BATCH if role == "eval_forward" else CNN_BATCH
    x, w, b = randn(rows, d_in), randn(d_in, d_out) / d_in ** 0.5, randn(d_out)
    g = randn(rows, d_out)
    if role in ("forward", "eval_forward"):
        args, kw, m, n, k = (x, w), {"bias": b}, rows, d_out, d_in
        library = lambda: torch.addmm(b, x, w)  # noqa: E731
    elif role == "input_grad":
        args, kw, m, n, k = (g, w), {"trans_b": True}, CNN_BATCH, d_in, d_out
        library = lambda: torch.mm(g, w.t())  # noqa: E731
    else:
        args, kw, m, n, k = (x, g), {"trans_a": True}, d_in, d_out, CNN_BATCH
        library = lambda: torch.mm(x.t(), g)  # noqa: E731
    got = gemm(*args, **kw)
    want = gemm_plain(*args, **kw)
    product = (gemm_plain(*args).float().abs().max().item()
               if "bias" in kw else None)
    errs = check_case(torch, f"gemm {dtype} {role} {d_in}x{d_out}", got,
                      want, CNN_GEMM_RTOL_OF_MAX, product)
    repeat = {}
    if (role, d_in, d_out) in GEMM_REPEAT:
        again = gemm(*args, **kw)
        if not torch.equal(got, again):
            raise AssertionError(f"gemm {dtype} {role} {d_in}x{d_out}: two "
                                 f"runs differ by "
                                 f"{(got.float() - again.float()).abs().max().item()}")
        repeat = {"bitwise_repeat": True}
    nbytes = got.element_size() * (m * k + k * n + m * n
                                   + (n if "bias" in kw else 0))
    bound_ms, bound_by = bound(nbytes, 2 * m * n * k, PEAK[dtype])
    return {"kernel": "gemm", "dtype": dtype, "role": role, "M": m, "N": n,
            "K": k, **errs, **repeat,
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
                     cout: int, gen, dtype: str) -> dict:
    """K4 in reference_cnn's step: a k3 s2 p1 forward, or (K4') the
    input gradient of one, a stride-1 conv over the undilated cotangent
    with lhs dilation 2 and flipped, in/out-swapped weights."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import (
        conv_direct,
        conv_direct_plain,
        conv_input_grad_pads,
    )

    F = torch.nn.functional
    tdt = getattr(torch, dtype)
    oh, ow = (h + 2 - 3) // 2 + 1, (w + 2 - 3) // 2 + 1
    wt = (torch.randn(3, 3, cin, cout, generator=gen) / (9 * cin) ** 0.5).to(dev).to(tdt)
    w_oihw = wt.permute(3, 2, 0, 1)
    if role == "forward":
        x = torch.rand(CNN_BATCH, h, w, cin, generator=gen).to(dev).to(tdt)
        kw = dict(stride=2, pads=(1, 1, 1, 1))
        x_nchw = x.permute(0, 3, 1, 2)
        library = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)  # noqa: E731
        (n_in, c, o, hin, win, hout, wout) = (CNN_BATCH, cin, cout, h, w, oh, ow)
        taps = (valid_taps(h, oh, 3, 2, 1) * valid_taps(w, ow, 3, 2, 1))
    else:
        x = torch.randn(CNN_BATCH, oh, ow, cout, generator=gen).to(dev).to(tdt)
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
    errs = check_case(torch, f"conv_direct {dtype} {role} {h}x{w}x{cin}->{cout}",
                      got, want, CONV_RTOL_OF_MAX)
    lib_out = library()
    if role != "forward" and tuple(lib_out.shape) != (n_in, o, hout, wout):
        raise AssertionError(f"conv_transpose2d shape {tuple(lib_out.shape)}")
    nbytes = got.element_size() * (x.numel() + wt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n_in * taps * c * o, PEAK[dtype])
    return {"kernel": "conv_direct", "dtype": dtype, "role": role, "N": n_in,
            "H": hin, "W": win, "C": c, "O": o, "OH": hout, "OW": wout,
            **errs,
            "ms": median_ms(torch, lambda: conv_direct(x, wt, **kw)),
            "plain_ms": median_ms(torch, lambda: conv_direct_plain(x, wt, **kw)),
            "library_ms": median_ms(torch, library),
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_direct_extra_case(torch, dev, role: str, n: int, h: int, w: int,
                           c: int, o: int, k: int, stride: int, pads: tuple,
                           dil: int, flip: bool, gen, dtype: str) -> dict:
    """K4 at one of CONV_EXTRA's geometries against its plain version,
    with the other K4 rows' tolerances and bound. Yardstick: for K4' the
    forward's transposed conv (F.conv_transpose2d, channels-last); none
    for a forward with one-sided pads, which no single PyTorch call
    computes."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import (
        conv_direct,
        conv_direct_plain,
    )

    F = torch.nn.functional
    tdt = getattr(torch, dtype)
    x = torch.randn(n, h, w, c, generator=gen).to(dev).to(tdt)
    wshape = (k, k, o, c) if flip else (k, k, c, o)
    wt = (torch.randn(*wshape, generator=gen) / (k * k * c) ** 0.5).to(dev).to(tdt)
    kw = dict(stride=stride, pads=pads, dil=dil, flip=flip)
    got = conv_direct(x, wt, **kw)
    want = conv_direct_plain(x, wt, **kw)
    oh, ow = got.shape[1:3]
    errs = check_case(torch, f"conv_direct {dtype} {role} {n}x{h}x{w}x{c}"
                      f"->{o} s{stride} pads {pads}", got, want,
                      CONV_RTOL_OF_MAX)
    library_ms = None
    if flip:
        # the forward conv: k, stride 1, symmetric padding k - 1 - pads
        x_nchw = x.permute(0, 3, 1, 2)
        w_oihw = wt.permute(3, 2, 0, 1)

        def library():
            return F.conv_transpose2d(x_nchw, w_oihw, padding=k - 1 - pads[0])

        if tuple(library().shape) != (n, o, oh, ow):
            raise AssertionError(f"conv_transpose2d shape {tuple(library().shape)}")
        library_ms = median_ms(torch, library)
    taps = (valid_taps(h, oh, k, stride, pads[0], dil)
            * valid_taps(w, ow, k, stride, pads[2], dil))
    nbytes = got.element_size() * (x.numel() + wt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n * taps * c * o, PEAK[dtype])
    return {"kernel": "conv_direct", "dtype": dtype, "role": role, "N": n,
            "H": h, "W": w, "C": c, "O": o, "OH": oh, "OW": ow, "k": k,
            "stride": stride, "pads": list(pads), "dil": dil, "flip": flip,
            **errs,
            "ms": median_ms(torch, lambda: conv_direct(x, wt, **kw)),
            "plain_ms": median_ms(torch, lambda: conv_direct_plain(x, wt, **kw)),
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_dw_case(torch, dev, n: int, h: int, w: int, cin: int, cout: int,
                 stride: int, pad: int, gen, dtype: str) -> dict:
    """K5, the weight gradient of a k3 conv x (n, h, w, cin) -> g (n, oh,
    ow, cout) at the given stride and padding; at DW_REPEAT's shapes run
    twice, the two results held equal bit for bit."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import conv_dw, conv_dw_plain

    tdt = getattr(torch, dtype)
    oh, ow = (h + 2 * pad - 3) // stride + 1, (w + 2 * pad - 3) // stride + 1
    x = torch.rand(n, h, w, cin, generator=gen).to(dev).to(tdt)
    g = torch.randn(n, oh, ow, cout, generator=gen).to(dev).to(tdt)
    kw = dict(stride=stride, padding=pad, kh=3, kw=3)
    got = conv_dw(x, g, **kw)
    want = conv_dw_plain(x, g, **kw)
    errs = check_case(torch, f"conv_dw {dtype} {n}x{h}x{w}x{cin}->{cout} "
                      f"s{stride}", got, want, CONV_DW_RTOL_OF_MAX)
    repeat = {}
    if (n, h, w, cin, cout, stride, pad) in DW_REPEAT:
        again = conv_dw(x, g, **kw)
        if not torch.equal(got, again):
            raise AssertionError(f"conv_dw {dtype} {n}x{h}x{w}x{cin}->{cout}: "
                                 f"two runs differ by "
                                 f"{(got.float() - again.float()).abs().max().item()}")
        repeat = {"bitwise_repeat": True}
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    taps = (valid_taps(h, oh, 3, stride, pad) * valid_taps(w, ow, 3, stride, pad))
    nbytes = got.element_size() * (x.numel() + g.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n * taps * cin * cout, PEAK[dtype])
    return {"kernel": "conv_dw", "dtype": dtype, "role": "weight_grad",
            "N": n, "H": h, "W": w, "C": cin, "O": cout, "OH": oh, "OW": ow,
            "stride": stride, **errs, **repeat,
            "ms": median_ms(torch, lambda: conv_dw(x, g, **kw)),
            "plain_ms": median_ms(torch, lambda: conv_dw_plain(x, g, **kw)),
            "library_ms": median_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (cout, cin, 3, 3), g_nchw, stride=stride,
                padding=pad)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def bench_conv_case(torch, dev, kernel: str, shape: tuple, gen,
                    dtype: str) -> dict:
    """K4 (`conv_direct`) or K6 (`conv_gemm`) forward at one of
    conv-bench's stride-1 shapes (n, h, w, cin, k, cout, 1, padding),
    against its plain version on the same inputs; the yardstick is
    `F.conv2d` on the same channels-last tensors, TF32 off."""
    from mpi_cuda_cnn_tpu_torch.ops import kernel_ops

    F = torch.nn.functional
    tdt = getattr(torch, dtype)
    n, h, w, cin, k, cout, _, p = shape
    if kernel == "conv_gemm":
        run, plain, rtol = (kernel_ops.conv_gemm, kernel_ops.conv_gemm_plain,
                            CONV_GEMM_RTOL_OF_MAX)
        kw = dict(padding=p)
    else:
        run, plain, rtol = (kernel_ops.conv_direct,
                            kernel_ops.conv_direct_plain, CONV_RTOL_OF_MAX)
        kw = dict(stride=1, pads=(p, p, p, p))
    x = torch.randn(n, h, w, cin, generator=gen).to(dev).to(tdt)
    wt = (torch.randn(k, k, cin, cout, generator=gen)
          / (k * k * cin) ** 0.5).to(dev).to(tdt)
    got = run(x, wt, **kw)
    want = plain(x, wt, **kw)
    errs = check_case(torch, f"{kernel} {dtype} {n}x{h}x{w}x{cin}->{cout}",
                      got, want, rtol)
    x_nchw = x.permute(0, 3, 1, 2)     # channels-last memory
    w_oihw = wt.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    oh, ow = got.shape[1:3]
    taps = valid_taps(h, oh, k, 1, p) * valid_taps(w, ow, k, 1, p)
    nbytes = got.element_size() * (x.numel() + wt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n * taps * cin * cout, PEAK[dtype])
    return {"kernel": kernel, "dtype": dtype, "role": "forward", "N": n,
            "H": h, "W": w, "C": cin, "O": cout, "k": k, "padding": p,
            **errs,
            "ms": median_ms(torch, lambda: run(x, wt, **kw)),
            "plain_ms": median_ms(torch, lambda: plain(x, wt, **kw)),
            "library_ms": median_ms(torch, lambda: F.conv2d(x_nchw, w_oihw,
                                                            padding=p)),
            "bound_ms": bound_ms, "bound_by": bound_by}


def rel_l2(got, want, *, per_row: bool) -> float:
    """||got - want|| / ||want||: over the whole tensor, or the largest of
    it over the rows (the last dim)."""
    if per_row:
        return ((got - want).norm(dim=-1) / want.norm(dim=-1)).max().item()
    return ((got - want).norm() / want.norm()).item()


def sdpa_ms(torch, q, k, v, g, causal: bool = True) -> dict:
    """The yardstick: F.scaled_dot_product_attention (GQA through
    enable_gqa) on the same inputs in its (B, H, S, D) layout, forward
    alone, forward + backward (dq, dk, dv), and the backward alone (one
    forward outside the timed calls, its graph kept)."""
    F = torch.nn.functional
    gqa = k.shape[2] != q.shape[2]
    qt, kt, vt, gt = (t.transpose(1, 2).contiguous() for t in (q, k, v, g))
    leaves = [t.detach().requires_grad_() for t in (qt, kt, vt)]

    def fwd():
        return F.scaled_dot_product_attention(*leaves, is_causal=causal,
                                              enable_gqa=gqa)

    def fwd_bwd():
        torch.autograd.grad(fwd(), leaves, gt)

    out = fwd()

    def bwd():
        torch.autograd.grad(out, leaves, gt, retain_graph=True)

    with torch.no_grad():
        fwd_ms = median_ms(torch, fwd)
    return {"library_fwd_ms": fwd_ms, "library_fwd_bwd_ms": median_ms(torch, fwd_bwd),
            "library_bwd_ms": median_ms(torch, bwd)}


def flash_cases(torch, dev, dtype: str, b: int, s: int, h: int, hkv: int,
                d: int, gen, causal: bool = True) -> list[dict]:
    """K7, K8 and K9 on one attention shape (q (B, S, H, D), k/v (B, S,
    Hkv, D)), each against its plain version on the same inputs; the
    backward kernels take the plain forward's o and lse and a random
    cotangent. float32 K7/K8/K9 outputs are also held to
    FLASH_F32_REL_L2, and at FLASH_REPEAT's shapes run twice and held
    equal bit for bit.
    Bound: the pairs (causal: S (S + 1) / 2, else S^2) per (batch, query
    head) times 2 D flops for each of the kernel's products (K7: q k^T and
    p v; K8: also dO v^T and ds k, less p v; K9: q k^T, dO v^T, p^T dO and
    ds^T q), at the input type's peak (float32: three tf32 products
    each at the TF32 peak, `bound_by` "operations (3xTF32)", with the FMA
    figure beside it as `bound_fma_ms`); or each input read once and each
    output written once at the HBM rate, if that is longer."""
    from mpi_cuda_cnn_tpu_torch.ops import flash_attention as fa

    tdt = getattr(torch, dtype)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev).to(tdt)

    q, k, v, g = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d), \
        randn(b, s, h, d)
    o, lse = fa.flash_forward_plain(q, k, v, causal)
    dvec = fa.row_dvec(o, g)
    el = q.element_size()
    rows_q, rows_kv, rows = b * s * h * d, b * s * hkv * d, 4 * b * h * s
    runs = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v, causal),
                      lambda: fa.flash_forward_plain(q, k, v, causal), 2,
                      el * (2 * rows_q + 2 * rows_kv) + rows),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, g, lse, dvec, causal),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, dvec,
                                                       causal), 3,
                         el * (3 * rows_q + 2 * rows_kv) + 2 * rows),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dvec, causal),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                                         dvec, causal), 4,
                          el * (2 * rows_q + 4 * rows_kv) + 2 * rows)}
    lib = sdpa_ms(torch, q, k, v, g, causal)
    pairs = s * (s + 1) // 2 if causal else s * s
    out = []
    for name, (run, plain, products, nbytes) in runs.items():
        tf32x3 = dtype == "float32" and name in TF32X3_KERNELS
        got, want = run(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = tol = 0.0
        rel = None
        what = f"{name} {dtype} B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal}"
        for i, (a, w) in enumerate(zip(got, want)):
            # lse is float32 arithmetic on either input type
            rtol = FLASH_RTOL_OF_MAX["float32" if a.dtype == torch.float32
                                     else dtype]
            e, t = _check_err(f"{what} output {i}", a.float(), w.float(), rtol)
            err, tol = max(err, e), max(tol, t)
            if a.dtype == torch.bfloat16:
                over, rtol_l2 = FLASH_BF16_REL_L2[name]
            elif tf32x3:
                over, rtol_l2 = "tensor", FLASH_F32_REL_L2
            else:
                continue
            r = rel_l2(a.float(), w.float(), per_row=over == "row")
            if not r <= rtol_l2:
                raise AssertionError(f"{what} output {i}: relative L2 error "
                                     f"{r} (per {over}) > {rtol_l2}")
            rel = {"rel_l2_err": max(r, (rel or {}).get("rel_l2_err", 0.0)),
                   "rel_l2_tolerance": rtol_l2, "rel_l2_per": over}
        repeat = {}
        if tf32x3 and (b, s, h, hkv, d, causal) in FLASH_REPEAT:
            again = run()
            again = again if isinstance(again, tuple) else (again,)
            for i, (a, a2) in enumerate(zip(got, again)):
                if not torch.equal(a, a2):
                    raise AssertionError(
                        f"{what} output {i}: two runs differ by "
                        f"{(a - a2).abs().max().item()}")
            repeat = {"bitwise_repeat": True}
        flops = 2 * d * products * b * h * pairs
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = (3 * flops / TF32_FLOPS if tf32x3 else flops / PEAK[dtype]) * 1e3
        bound_ms, bound_by = ((t_bytes, "bytes") if t_bytes >= t_ops else
                              (t_ops, "operations (3xTF32)" if tf32x3
                               else "operations"))
        fma = {"bound_fma_ms": max(t_bytes, flops / F32_FLOPS * 1e3)} if tf32x3 else {}
        out.append({"kernel": name, "dtype": dtype, "B": b, "S": s, "H": h,
                    "Hkv": hkv, "D": d, "causal": causal,
                    "max_abs_err": err, "tolerance": tol, **(rel or {}),
                    **repeat,
                    "ms": median_ms(torch, run),
                    "plain_ms": median_ms(torch, plain),
                    "library_ms": (lib["library_fwd_ms"]
                                   if name == "flash_fwd" else None),
                    **lib, "flops": flops, "bound_ms": bound_ms,
                    "bound_by": bound_by, **fma})
    return out


def phase_flash_kernels(torch, dev, gen) -> list[dict]:
    cases = []
    for *shape, causal in [(*s, True) for s in FLASH_SHAPES] + FLASH_EXTRA_SHAPES:
        for case in flash_cases(torch, dev, *shape, gen, causal):
            emit({"phase": "kernel_case", **case})
            cases.append(case)
    return cases


def phase_kernels(torch, dev) -> list[dict]:
    from mpi_cuda_cnn_tpu_torch.serve import bench as serve_bench
    from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for

    gen = torch.Generator().manual_seed(0)
    cases = []
    for dtype in ("float32", "bfloat16", "int8"):
        for b, kk in ((8, 1), (1, 32)):
            cases.append(attention_case(torch, dev, dtype, b, kk, gen))
            emit({"phase": "kernel_case", **cases[-1]})
    cases.append(attention_case(torch, dev, "int8", 8, 1, gen, ragged=True))
    emit({"phase": "kernel_case", **cases[-1]})
    # The serve phase's own geometry: its int8 pages, its table width
    # (pages_for(max_seq)) and positions in its requests' range; the plan
    # splits this width otherwise than TABLE_PAGES.
    args = serve_bench._parser().parse_args(SERVE_ARGS)
    if (args.page_size, args.heads, args.kv_heads,
            args.dim // args.heads) != (PAGE, HEADS, KV_HEADS, HEAD_DIM):
        raise AssertionError("SERVE_ARGS and the paged-attention cases "
                             "disagree on page or head shapes")
    width = pages_for(args.max_seq, args.page_size)
    span = (args.prompt_min, args.prompt_max + args.out_max)
    for b, kk in ((args.slots, 1), (1, args.prefill_chunk)):
        cases.append(attention_case(torch, dev, "int8", b, kk, gen,
                                    pages=width, last_range=span))
        emit({"phase": "kernel_case", **cases[-1]})
    for n in (8, 32):
        for din, dout in GEMM_SHAPES:
            cases.append(gemm_case(torch, dev, n, din, dout, gen))
            emit({"phase": "kernel_case", **cases[-1]})
    cases.extend(phase_cnn_kernels(torch, dev, gen))
    return cases


def phase_cnn_kernels(torch, dev, gen):
    """K3-K5 at reference_cnn's batch-32 step shapes, and K4 and K6 at
    conv-bench's stride-1 shapes, in float32 and bf16: yields (and
    prints) one kernel_case each."""
    from mpi_cuda_cnn_tpu_torch.bench.conv_shapes import SHAPES

    for dtype in CNN_DTYPES:
        runs = [(cnn_gemm_case, (role, d_in, d_out))
                for role in ("forward", "input_grad", "weight_grad",
                             "eval_forward")
                for d_in, d_out in FC_SHAPES]
        runs += [(conv_direct_case, ("forward", *shape))
                 for shape in CONV_SHAPES]
        # conv1's input needs no gradient
        runs.append((conv_direct_case, ("input_grad", *CONV_SHAPES[1])))
        runs += [(conv_direct_extra_case, geom) for geom in CONV_EXTRA]
        runs += [(conv_dw_case, shape) for shape in DW_SHAPES]
        runs += [(bench_conv_case, (kernel, shape))
                 for kernel in ("conv_direct", "conv_gemm")
                 for shape in SHAPES if shape[6] == 1]
        for fn, args in runs:
            case = fn(torch, dev, *args, gen, dtype)
            emit({"phase": "kernel_case", **case})
            yield case


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


def phase_serve_profile(torch, out) -> dict:
    """torch.profiler over SERVE_PROFILE_TICKS decode ticks of the serve
    phase's engine (the decode flagship at full width), through its own
    `run_decode_tick` with every slot live at positions drawn (seed 0)
    from the bench's range (prompt_min to prompt_max + out_max), each
    slot on pages of its own: device ms per forward, K1's and K2's ms per
    forward, launches per forward (held to the serve phase's 8 and 41),
    and the device's idle share against the unprofiled tick time (the
    tick's host work and its one device-to-host copy included)."""
    from types import SimpleNamespace

    import numpy as np

    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    eng, args, model = out["engine"], out["args"], out["model"]
    rng = np.random.default_rng(0)
    pos = rng.integers(args.prompt_min, args.prompt_max + args.out_max,
                       eng.slots)
    need = pos // eng.page_size + 1
    if need.sum() >= eng.num_pages:
        raise AssertionError(f"serve_profile: {need.sum()} pages wanted of "
                             f"{eng.num_pages}")
    first = 1 + np.concatenate([[0], np.cumsum(need)[:-1]])
    slots = [SimpleNamespace(idx=i, cached=int(p),
                             pages=list(range(f, f + n)),
                             req=SimpleNamespace(out=[int(rng.integers(
                                 0, args.vocab))]))
             for i, (p, f, n) in enumerate(zip(pos, first, need))]

    def run():
        eng.run_decode_tick(slots)

    for _ in range(3):
        run()
    torch.cuda.synchronize()
    _kernels.reset_launches()
    t0 = time.perf_counter()
    for _ in range(SERVE_PROFILE_TICKS):
        run()
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / SERVE_PROFILE_TICKS
    per_forward = {"paged_attention": model.depth,
                   "int8_gemm": 5 * model.depth + 1}
    launches = {k: _kernels.launches[k] / SERVE_PROFILE_TICKS
                for k in per_forward}
    if launches != per_forward:
        raise AssertionError(f"serve_profile: launches per tick {launches}, "
                             f"want {per_forward}")
    prof = profile_device(torch, run, SERVE_PROFILE_TICKS, groups={
        "paged_attention": ("paged_attention_kernel",),
        "int8_gemm": ("int8_gemm_kernel",)})
    busy = prof["device_busy_ms_per_step"]
    group = prof.pop("group_ms_per_step")
    return {"ticks": SERVE_PROFILE_TICKS, "slots": eng.slots,
            "positions": [int(p) for p in pos], "tick_ms": tick_ms,
            "device_ms_per_forward": busy,
            "k1_ms_per_forward": group["paged_attention"],
            "k2_ms_per_forward": group["int8_gemm"],
            "launches_per_forward": launches,
            "device_idle_share": None if busy is None else 1 - busy / tick_ms,
            **prof}


def phase_train(torch) -> dict:
    """train-bench's path on the kernels with the launch counts zeroed
    just before and read just after; then one measured epoch of the same
    bench on PyTorch's own ops for comparison. Returns the launches per
    kernel."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.bench import train_bench

    _kernels.reset_launches()
    out = train_bench(TRAIN_ARGS)
    torch.cuda.synchronize()
    launches = dict(_kernels.launches)
    line = out["line"]
    if line["backend"] != "cuda":
        raise AssertionError(f"train: ran on {line['backend']}")
    check_cnn_epoch("train", line["kernel_launches"],
                    line["eval_kernel_launches"], line["steps_per_epoch"],
                    line["ntests"], line["ncorrect"],
                    {k: line[k] for k in ("loss", "etotal", "acc")},
                    JAX_CPU_ACCURACY)
    for name in _kernels.KERNELS:   # the warm-up epoch is a full epoch
        want = (2 * TRAIN_STEPS * PER_STEP.get(name, 0)
                + EVAL_BATCHES * PER_EVAL.get(name, 0))
        if launches[name] != want:
            raise AssertionError(f"train: {name} launched {launches[name]} "
                                 f"times in all, want {want}")
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
    emit({"phase": "train_profile",
          **profile_steps(torch, out["trainer"], line["step_ms"])})
    plain_out = train_bench([a for a in TRAIN_ARGS if a != "--use-kernels"])
    plain = plain_out["line"]
    emit({"phase": "train_torch_ops", "epoch_s": plain["value"],
          "device_epoch_s": plain["device_epoch_s"],
          "step_ms": plain["step_ms"], "samples_per_s": plain["samples_per_s"],
          "loss": plain["loss"], "acc": plain["acc"],
          "ntests": plain["ntests"], "ncorrect": plain["ncorrect"],
          "profile": profile_steps(torch, plain_out["trainer"],
                                   plain["step_ms"])})
    return launches


def check_cnn_epoch(what: str, epoch_launches: dict, eval_launches: dict,
                    steps: int, ntests: int, ncorrect: int, metrics: dict,
                    reference: float) -> None:
    """The checks the train and train_bf16 phases share: a full epoch of
    TRAIN_STEPS steps with every kernel launched PER_STEP times a step,
    PER_EVAL times an eval batch in the eval, and no other kernel; test
    accuracy on the 10,000 samples at least `reference` less
    ACCURACY_MARGIN; finite epoch metrics."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    if steps != TRAIN_STEPS:
        raise AssertionError(f"{what}: {steps} steps, want {TRAIN_STEPS}")
    for name in _kernels.KERNELS:
        want = (PER_STEP.get(name, 0) * steps,
                PER_EVAL.get(name, 0) * EVAL_BATCHES)
        if (epoch_launches[name], eval_launches[name]) != want:
            raise AssertionError(
                f"{what}: {name} launched {epoch_launches[name]} times in "
                f"the epoch and {eval_launches[name]} in the eval, want "
                f"{want[0]} and {want[1]}")
    acc = ncorrect / ntests
    if ntests != 10_000 or acc < reference - ACCURACY_MARGIN:
        raise AssertionError(f"{what}: test accuracy {acc} ({ncorrect}/"
                             f"{ntests}) below {reference} - "
                             f"{ACCURACY_MARGIN}")
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: non-finite metrics {metrics}")


def profile_device(torch, run, steps: int,
                   groups: dict | None = None) -> dict:
    """`run()` called `steps` times under torch.profiler: kernel time by
    name, summed, against the window's wall time, and per name of
    `groups` the time of the kernels whose names hold one of its name
    fragments. The profiler slows
    the host, so an idle share is read against an unprofiled step time by
    the caller."""
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
    if groups:
        out["group_ms_per_step"] = {
            name: sum(v for k, v in dev_us.items()
                      if any(m in k for m in frags)) / 1e3 / steps
            for name, frags in groups.items()}
    return out


def profile_steps(torch, trainer, step_ms: float, steps: int = 50) -> dict:
    """Device time of `steps` training steps of the device-resident path
    (the same gather, normalize, one-hot and step as `run_epoch`), and
    the device's idle share against the unprofiled `step_ms`."""
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

    prof = profile_device(torch, run, steps)
    busy = prof["device_busy_ms_per_step"]
    prof["device_idle_share"] = None if busy is None else 1 - busy / step_ms
    return prof


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


def first_step_grads_rel_l2(torch, trainer) -> dict:
    """Relative L2 gap, per param leaf (named by index), between the
    gradients of the trainer's first batch at its current params on the
    kernels and on PyTorch's own ops, both in the trainer's compute
    dtype."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.data.pipeline import normalize_images, one_hot
    from mpi_cuda_cnn_tpu_torch.train.trainer import make_loss_fn

    idx = trainer._epoch_order(0)[: trainer.cfg.batch_size]
    x = torch.from_numpy(normalize_images(trainer.ds.train_images[idx]))
    y = torch.from_numpy(one_hot(np.asarray(trainer.ds.train_labels)[idx],
                                 trainer.ds.num_classes))
    x, y = x.to(trainer.device), y.to(trainer.device)
    grads = {}
    for backend in ("cuda", "torch"):
        loss_fn = make_loss_fn(trainer.model, backend=backend,
                               compute_dtype=trainer.compute_dtype)
        loss, _ = loss_fn(trainer.params, x, y)
        grads[backend] = torch.autograd.grad(loss, trainer.leaves)
    return {i: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for i, (a, b) in enumerate(zip(grads["cuda"], grads["torch"]))}


def phase_train_bf16(torch) -> dict:
    """The `train` command's path (`Trainer`) with bf16 compute on the
    kernels: the train phase's data and configuration, one epoch, then
    the 10,000-sample eval, with the launch counts zeroed just before the
    epoch and the eval and read just after each. Before the epoch, the
    first step's gradients on the kernels and on PyTorch's own ops; after
    the eval, torch.profiler over 50 steps (device busy ms per step)."""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.config import Config
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    ds = synthetic_stripes(num_train=60_000, num_test=10_000)
    cfg = Config(model="reference_cnn", epochs=1, batch_size=CNN_BATCH,
                 lr=0.1, seed=0, device="cuda", use_kernels=True,
                 compute_dtype="bfloat16", log_every=0, eval_every=0)
    tr = Trainer(get_model("reference_cnn"), ds, cfg,
                 metrics=MetricsLogger(echo=False))
    grad_rel = first_step_grads_rel_l2(torch, tr)
    worst_grad = max(grad_rel.values())
    if not worst_grad <= TRAIN_BF16_GRAD_REL_L2:
        raise AssertionError(f"train_bf16: first-step gradients of the "
                             f"kernels and PyTorch's ops apart by {grad_rel} "
                             f"(limit {TRAIN_BF16_GRAD_REL_L2})")
    _kernels.reset_launches()
    em = tr.run_epoch(0)
    torch.cuda.synchronize()
    step_launches = dict(_kernels.launches)
    _kernels.reset_launches()
    ntests, ncorrect = tr.evaluate()
    eval_launches = dict(_kernels.launches)
    check_cnn_epoch("train_bf16", step_launches, eval_launches, em["steps"],
                    ntests, ncorrect, {k: em[k] for k in ("loss", "etotal",
                                                          "acc")},
                    JAX_CPU_BF16_ACCURACY)
    step_ms = 1e3 * em["seconds"] / em["steps"]
    prof = profile_steps(torch, tr, step_ms)
    return {"compute_dtype": "bfloat16", "steps": em["steps"],
            "epoch_s": em["seconds"], "step_ms": step_ms,
            "loss": em["loss"], "etotal": em["etotal"], "acc": em["acc"],
            "ntests": ntests, "ncorrect": ncorrect,
            "reference_accuracy": JAX_CPU_BF16_ACCURACY,
            "accuracy_margin": ACCURACY_MARGIN,
            "epoch_launches": step_launches, "eval_launches": eval_launches,
            "first_grad_rel_l2": grad_rel,
            "first_grad_rel_l2_max": worst_grad,
            "first_grad_rel_l2_tolerance": TRAIN_BF16_GRAD_REL_L2,
            "profile": prof}


def phase_conv_bench(torch) -> dict:
    """`conv-bench` at full size through its entry point, with the launch
    counts zeroed just before and read just after: one line per row; K4
    launched on every row, K6 on every stride-1 row and on no other, no
    other kernel. Returns the launches per kernel."""
    import math

    from mpi_cuda_cnn_tpu_torch.bench.conv_shapes import conv_bench
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    out = conv_bench([])
    launches = dict(_kernels.launches)
    for row in out["rows"]:
        kl = row["kernel_launches"]
        stride1 = row["stride"] == 1
        others = {k: v for k, v in kl.items()
                  if k not in ("conv_direct", "conv_gemm") and v}
        if (kl["conv_direct"] < 1 or (kl["conv_gemm"] > 0) != stride1
                or others or not math.isfinite(row["torch_ms"])
                or not math.isfinite(row["cuda_ms"])
                or math.isfinite(row["gemm_ms"]) != stride1):
            raise AssertionError(f"conv_bench: row {row}")
        emit({"phase": "conv_bench", "device": out["device"],
              "iters": out["iters"], **row})
    return launches


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
        prof = profile_device(torch, run, steps,
                              groups={"flash": ("flash_",)})
        busy = prof["device_busy_ms_per_step"]
        flash_ms = prof.pop("group_ms_per_step")["flash"]
        emit({"phase": "lm_profile",
              "dtype": "bfloat16" if dtype else "float32", "attn": "flash",
              "step_ms": step_ms,
              "device_idle_share": None if busy is None else 1 - busy / step_ms,
              "flash_ms_per_step": flash_ms, **prof})
        del state
        torch.cuda.empty_cache()


def first_grads_rel_l2(torch, trainer, get_attn_fn, lm_loss,
                       tree_leaves) -> dict:
    """Relative L2 gap, per param leaf, between the gradients of step 0's
    batch at the trainer's initial params, in its compute dtype, with
    attention on the kernels and on the oracle (the leaves are named by
    their index)."""
    leaves = tree_leaves(trainer.state["params"])
    tokens, targets = (trainer._to_device(a) for a in trainer._sample_batch(0))
    grads = {impl: torch.autograd.grad(
        lm_loss(trainer.model, trainer.state["params"], tokens, targets,
                attn_fn=get_attn_fn(impl),
                compute_dtype=trainer._compute_dtype), leaves)
        for impl in ("flash", "oracle")}
    return {i: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for i, (a, b) in enumerate(zip(grads["flash"], grads["oracle"]))}


def phase_lm_agree(torch) -> dict:
    """LM_AGREE_ARGS' 10 float32 steps from one init, attention on the
    kernels and on the oracle; the first step's gradients, per-step
    losses and final params held to the stated tolerances. Then the
    first step's gradients in bf16 compute, per leaf, flash against the
    oracle from one init."""
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
    trainer = LMTrainer(parse_lm_args(LM_AGREE_ARGS + [
        "--attn-impl", "flash", "--compute-dtype", "bfloat16"]),
        metrics=RecordingMetrics())
    bf16_rel = first_grads_rel_l2(torch, trainer, get_attn_fn, lm_loss,
                                  tree_leaves)
    del trainer
    torch.cuda.empty_cache()
    worst_bf16 = max(bf16_rel.values())
    if not worst_bf16 <= LM_BF16_GRAD_REL_L2:
        raise AssertionError(f"lm_agree: bf16 first-step gradients of flash "
                             f"and the oracle apart by {bf16_rel} (limit "
                             f"{LM_BF16_GRAD_REL_L2})")
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
            "bf16_first_grad_rel_l2": bf16_rel,
            "bf16_first_grad_rel_l2_max": worst_bf16,
            "bf16_first_grad_rel_l2_tolerance": LM_BF16_GRAD_REL_L2,
            "eval_loss": {"flash": rf.eval_loss, "oracle": ro.eval_loss}}


def kernels_line(cases: list[dict], launches: dict) -> dict:
    """The per-kernel record: launches from each kernel's own path (serve
    for K1/K2, train for K3/K4/K5, conv_bench for K6, lm for K7/K8/K9),
    the largest error over every case, and the times at one shape of the
    main path: the decode tick (int8 pages at B = slots; the head's 512 x
    8192 weight), for the CNN kernels fc1's forward, conv2's forward and
    conv1's weight gradient in float32, for K6 conv-bench's 128x32x32x64
    -> 64 row in float32, and for the flash kernels the LM flagship's
    attention in float32."""
    summary = []
    for name, src, replaces, rep in (
            ("paged_attention", "mpi_cuda_cnn_tpu_torch/csrc/paged_attention.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_paged_attention.py:89",
             lambda c: c["dtype"] == "int8" and c["kk"] == 1
             and c["L"] == TABLE_PAGES * PAGE and not c["ragged"]),
            ("int8_gemm", "mpi_cuda_cnn_tpu_torch/csrc/int8_gemm.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_gemv.py:143",
             lambda c: c["N"] == 8 and c["dout"] == 8192),
            ("gemm", "mpi_cuda_cnn_tpu_torch/csrc/gemm.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:77",
             lambda c: _f32(c) and c["role"] == "forward" and c["K"] == 1568),
            ("conv_direct", "mpi_cuda_cnn_tpu_torch/csrc/conv_direct.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:207",
             lambda c: _f32(c) and c["role"] == "forward" and c["C"] == 16),
            ("conv_dw", "mpi_cuda_cnn_tpu_torch/csrc/conv_dw.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_ops.py:300",
             lambda c: _f32(c) and c["C"] == 1),
            ("conv_gemm", "mpi_cuda_cnn_tpu_torch/csrc/conv_gemm.cu",
             "mpi_cuda_cnn_tpu/ops/pallas_conv_gemm.py:123",
             lambda c: _f32(c) and c["H"] == 32 and c["C"] == 64),
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
            "entry_points": entry_points(src),
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(c["max_abs_err"] for c in mine),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            # float32 K7-K9's kernel_case reads "operations (3xTF32)"
            "bound_by": ("operations" if r["bound_by"].startswith("operations")
                         else r["bound_by"]),
            **({"bound_note": "3xTF32: three tf32 products at 495 TF/s",
                "bound_fma_ms": r["bound_fma_ms"]} if "bound_fma_ms" in r else {}),
            "library_ms": r["library_ms"],
            "shape": {k: r[k] for k in ("dtype", "B", "kk", "L", "N", "din",
                                        "dout", "role", "M", "K", "S", "H",
                                        "Hkv", "D", "W", "C", "O") if k in r}})
    return {"kernels": summary}


def entry_points(src: str) -> list[str]:
    """The C launch function and the __global__ kernels of a source."""
    text = (HERE / src).read_text()
    return (re.findall(r'extern "C" int (\w+)\(', text)
            + re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?"
                         r"(\w+)\s*\(", text))


def _f32(case: dict) -> bool:
    return case["dtype"] == "float32"


def _flagship_f32(case: dict) -> bool:
    return _f32(case) and case["B"] == 8


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
    hmma_by_fn = {name: sass_hmma_by_function(_kernels, name)
                  for name in sorted(_kernels.KERNELS)}
    hmma = {name: sum(fns.values()) for name, fns in hmma_by_fn.items()}
    spills = {lib: {fn: n for fn, n in spill_stores(built["logs"][lib]).items()
                    if frag in fn}
              for lib, frag in NO_SPILL}
    fwd_log = built["logs"]["flash_fwd"]
    fwd_f32 = {fn: {"registers": n, "spill_stores": spill_stores(fwd_log)[fn]}
               for fn, n in registers(fwd_log).items()
               if "flash_fwd_f32_kernel" in fn}
    emit({"phase": "build", "seconds": round(built["seconds"], 3),
          "kernels": sorted(_kernels.KERNELS), "hmma": hmma,
          "spill_stores": spills, "flash_fwd_f32": fwd_f32, "ptxas": report})
    for name in TENSOR_CORE_KERNELS:
        if not hmma[name] > 0:
            raise AssertionError(f"build: no HMMA instruction in {name}'s "
                                 f"library: it does not use the tensor cores")
    hmma_fns = {}
    for lib, frag in TENSOR_CORE_FUNCTIONS:
        fns = {fn: n for fn, n in hmma_by_fn[lib].items() if frag in fn}
        hmma_fns.update(fns)
        if len(fns) != 3 or not all(n > 0 for n in fns.values()):
            raise AssertionError(f"build: {frag} in {lib}: HMMA per instance "
                                 f"{fns or 'no such function'}; want all "
                                 f"three head dims on the tensor cores")
    emit({"phase": "build_hmma", "functions": hmma_fns})
    for lib, frag in NO_SPILL:
        if not spills[lib] or any(spills[lib].values()):
            raise AssertionError(f"build: {frag} in {lib}: spill stores "
                                 f"{spills[lib] or 'not reported'}")

    cases = phase_kernels(torch, torch.device("cuda"))
    cases += phase_flash_kernels(torch, torch.device("cuda"),
                                 torch.Generator().manual_seed(1))

    out, serve_launches = phase_serve(torch, SERVE_ARGS)
    emit({"phase": "agree", **phase_agree(torch, out)})
    emit({"phase": "serve_profile", **phase_serve_profile(torch, out)})
    train_launches = phase_train(torch)
    emit({"phase": "train_agree", **phase_train_agree(torch)})
    emit({"phase": "train_bf16", **phase_train_bf16(torch)})
    conv_launches = phase_conv_bench(torch)
    lm_launches = phase_lm(torch)
    phase_lm_bench(torch)
    phase_lm_profile(torch)
    emit({"phase": "lm_agree", **phase_lm_agree(torch)})
    launches = {**{k: serve_launches[k] for k in ("paged_attention",
                                                  "int8_gemm")},
                **{k: train_launches[k] for k in PER_STEP},
                "conv_gemm": conv_launches["conv_gemm"],
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
