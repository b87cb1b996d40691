#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (`mpi_cuda_cnn_tpu_torch`) on
one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each printing one JSON line; any failure, in this process or in
a rank it spawned, raises and the script exits non-zero without the
final line:

1. device   the card's name and `nvidia-smi` name and power limit.
2. build    builds every CUDA kernel of the serving, CNN-training,
            conv-bench and LM-training paths from csrc/ (nine sources,
            one nvcc each, all started together); seconds taken, ptxas
            registers, and each library's tensor-core instruction count
            (`HMMA` lines of `cuobjdump -sass`), which must be above 0
            for the mma.sync kernels (gemm, conv_direct, conv_dw,
            conv_gemm, flash_fwd, flash_bwd_dq, flash_bwd_dkv), and
            in each head-dim instance of the float32 flash functions
            themselves (16, 32, 64, 80, 96, 128 and 256; forward and
            backward, 3xTF32; `build_hmma` line); the flash kernels at
            D 64 in both types and every bf16 instance of gemm,
            conv_gemm and conv_dw must show no ptxas spill stores;
            every flash instance's registers and spill bytes are
            reported (`flash_instances`).
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
            weight matmul (K2) at the serve phase's ten products (N 8
            and 32) and three ragged ones (one slot; ragged N, din and
            dout), each run twice and held equal bit for bit, with
            torch._weight_int8pack_mm as the yardstick.
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
            and non-causal at D 64; at the head dims beyond (D 24 and
            48, which the wrapper pads to 32 and 64, and the instances
            80, 96 and 256; B 2, S 256, 8 heads MHA and over 2 kv heads,
            causal and not, both types, marked `head_dims`), and at the
            flagship's geometry at D 80 and 96 (30 calls, with
            SDPA's times). float32 K7, K8 and K9 (3xTF32)
            are held to a relative L2 error too, and run twice at the
            flagship and GQA shapes and are held equal bit for bit.
            One rank's shapes of the dp phases at world 2, float32: K3
            at M 16, K4/K4' and K5 at reference_cnn's convs at batch 16,
            K7/K8/K9 at the flagship's B 4.
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
5c. serve_features  the single engine's features through serve-bench
            at the serve flagship on 12 requests of template traffic:
            sharing off (the baseline), prefix sharing, lookup k 8, a
            paged and a window draft model, a tight pool spilling to a
            host tier with one corrupted spill, the SLO scheduler over
            two tenants with a squeeze fault, its JSONL records and live
            alerts. Every request finishes with the baseline's tokens
            (or a tie); K1/K2 launches held to the target's and the
            draft's forwards; prefix hits and COW copies, lookup
            acceptance in fewer rounds, spills, readmits and the one
            refusal held; 120 s at most. The kernels phase holds K1 at
            the verify block, over aliased tables and on the draft's
            pools, and K2 at N 64 and the draft's products (marked
            `features`).
5d. fleet    `fleet-bench --compute engine` at the serve flagship's
            width (every replica one PagedEngine on this card, K1 and
            K2 in each), 12 requests of the serve phase's ranges at
            once, four runs: 2 replicas with no fault (the baseline);
            the same with replica 1 crashed mid-storm as a zombie for
            2 ticks (resume re-dispatch, a restarted incarnation);
            a prefill:1,decode:1 pool pair whose handoffs move KV pages
            between engines (adopt_pages, int8 scales included); the
            baseline over the lossy transport with duplicated and
            delayed commits. Every request finishes with the baseline's
            tokens (or a tie); the crash run re-dispatches and
            generates no token twice, the pooled run hands off, the
            transport run's trace_crc is the baseline's; K1/K2 launches
            held to the forwards every incarnation ran (zombies and
            crashed ones included); 90 s at most.
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
7a. dp      the train phase's configuration through parallel/dp.py
            (`Trainer` with a mesh, one process a rank, through the
            `train` command's rank entry `train/ranks.cnn_rank`): world 1
            on a one-rank NCCL group, 50 steps (one epoch of 50 batches,
            as train_agree, device-resident) bit for bit against the
            one-device Trainer, one all-reduce a step; world 2 as two
            gloo ranks on cuda:0 (`run_ranks`): the first step's averaged
            gradients, the 50 steps' params and the test predictions
            against the one-device run, then a full epoch on the
            device-resident route and the eval with the train phase's
            checks on every rank, 1,875 all-reduces and one broadcast;
            with two cards or more also world min(4, cards) over NCCL.
            The shared-card times are a correctness run, not a scaling
            figure.
7b. lm_dp   the lm phase's flagship at world 2 (two gloo ranks on
            cuda:0), 3 steps from one init against 3 one-device
            `LMTrainer` steps: K7/K8/K9 8/8/8 a step on every rank, the
            losses and the first step's averaged gradients within stated
            tolerances.
7c. train_bf16  the `train` command's path (`Trainer`) with bf16
            compute on the kernels: the train phase's data, one epoch,
            the 10,000-sample eval; launches held to 9/3/2 per step and
            3/2/0 per eval batch, the accuracy to the JAX package's bf16
            accuracy on the CPU less the margin, the first step's
            gradients on the kernels and on PyTorch's ops (both bf16)
            to a stated relative L2 per leaf; ms per step.
7d. conv_bench  `conv-bench` at full size (the reference's five shapes,
            float32 then bf16, 200 calls against 400): one line per row;
            K4 launched on every row, K6 on every stride-1 row and not
            on the stride-2 row.
8. lm       `lm` at the LM flagship's width (d512 x 8 layers, 8 heads,
            seq 2048, batch 8; synthetic corpus, vocab 251) with flash
            attention: 30 steps and the eval, launches of K7/K8/K9 held
            to 8/8/8 per step and 8/0/0 per eval, the loss held to fall
            well below the first step's.
8a. lm_head_dims  `lm` with flash attention at the flagship's depth,
            sequence and batch at d 768 over 8 heads, head dim 96
            (Phi-3-mini's), MHA and over 2 kv heads, in float32 and in
            bf16 compute, a few steps and the eval each: K7/K8/K9 held
            to 8/8/8 per step and 8/0/0 per eval, the first step's
            gradients on the kernels and on the oracle within the
            lm_agree limits per leaf (1e-4 float32, 2e-2 bf16), the
            held-out loss below its value before the steps.
8b. lm_moe  the flagship with 8 experts a block, top-2, cf 1.25: (a)
            `lm` in bf16 with flash attention and 512-token routing
            chunks, 30 steps and the eval, K7/K8/K9 held to 8/8/8 per
            step and 8/0/0 per eval, the loss to fall below 0.7 x the
            first step's; step ms, tokens/s, mfu, peak memory; (b)
            float32 chunked: the first step's gradients with flash and
            with the oracle (routed by the flash forward's choices, each
            choice the oracle would take otherwise a tie) per leaf; (c)
            float32 unchunked at the largest batch whose reckoned peak
            fits the card, against a chunked step at that batch (held
            when neither drops a token, else the drop counts); (d)
            `lm-bench --moe-experts 8 --moe-top-k 2` rows at 4 of the
            8 layers (bf16 and float32, chunked and not, peak memory)
            and torch.profiler's
            split of one MoE layer into router build, dispatch einsum,
            expert FFN, combine and backward.
8c. generate  the lm and lm_moe trainers sample 64 tokens greedily
            after a 1,024-token prompt with int8 decode weights: K2 held
            to 33 (dense) and 17 (MoE) launches a token; the tokens held
            to the plain path's (dequantized weights), equal or tied;
            prompt lookup with k 8 against generate (mean accepted
            tokens a round); a temperature-0.8 run against its plain
            twin; then an MoE `PagedEngine` on K1 + K2 (int8 pages and
            weights; 8 and 17 launches a forward) against its plain
            twin, equal or tied. The kernels phase holds K2 at
            generate's products (N 1 and 8) and K1 at the engine's MHA
            pages (marked `generate`).
9. lm_bench `lm-bench` at the flagship (vocab 8192): {f32, bf16} x
            {oracle, flash} and bf16 + flash + chunked CE, 4 timed
            steps each; tokens/s and mfu per row, then the summary.
10. lm_profile  torch.profiler over flagship f32 and bf16 flash steps:
            device busy ms per step, idle share, the flash kernels' ms.
11. lm_agree  5 float32 steps from one init with attention on the
            kernels and on the oracle (TF32 off); the first step's
            gradients (per leaf), per-step losses and params within
            stated tolerances; then the first step's gradients in bf16
            compute, flash against the oracle, per leaf.
12. recover  crash-safe training (`train/checkpoint.py`, `faults.py`),
            in a temporary checkpoint directory. CNN: dp's 50 steps
            (one device-resident epoch of 1,600 samples) through the
            `train` command's rank entry, saving every 10 steps on the
            background writer, then the eval: (a) two uninterrupted
            runs bit for bit; (b) a crash after step 23 under
            --max-restarts 1, resumed at step 20, bit for bit (a); (c) a
            preemption after step 17: exit 75 with ckpt_17, then
            --resume, bit for bit (a); (d) one byte of the newest
            checkpoint flipped: --resume falls back to the one before
            it, bit for bit (a); (e) a NaN batch at step 7 under
            --nan-policy skip: one skip, the params after that step bit
            for bit those before it, the step counter advanced, the run
            finite. In every run the K3/K4/K5 launches are held to
            9/3/2 a step over every attempt's steps (replayed steps
            included) and 3/2/0 in the eval. LM: the flagship in
            float32 with flash attention, 10 steps saving every 4, a
            crash after step 6: per-step losses and the final
            checkpoint's every array bit for bit the uninterrupted
            run's, K7/K8/K9 8/8/8 a step. DP: world 2 (two gloo ranks on
            cuda:0) supervised from this process as the `train` command
            supervises a spawned world (`train.ranks.supervise_world`),
            under --max-restarts 2: a crash after step 23 on both ranks,
            then one in rank 0's save of ckpt_40 (`ckpt.pre_rename`, rank
            0 alone): the world spawned again each time, resumed from
            the checkpoint before (the fired crash not firing again),
            bit for bit the uninterrupted world-2 run, rank 0 the only
            writer, both crashes and restarts in rank 0's run file. Each
            line
            carries the card's name and power limit, the runs' wall
            times and the save (blocking copy, background write) and
            restore times of the CNN and the LM flagship states.
13. train_flags  the trainers' remaining flags (FLAGS_* below), at the
            train phase's configuration and the lm phase's flagship:
            (a) --grad-accum 4, an epoch at 36/12/8 launches a step,
            its first gradients against the batch-32 step's; (b) --remat,
            gradients bit for bit, 12/5/2 a step; (c) bf16 params, an
            epoch in bf16 compute, and float32 compute on the kernels
            with the reference's gradient dtypes; (d) --augment shift,
            the step's batches bit for bit the numpy draws applied on
            the host; (e) --elastic-width 8 at world 1 (NCCL) and 2
            (gloo on cuda:0) and a world-2 run resumed on world 1, bit
            for bit; (f) the LM's --grad-accum 2 and --elastic-width 4;
            (g) --metrics-jsonl and --profile-dir, the epoch timed
            without and with the sink; then each path's ms a step
            against the plain step's. The kernels phase holds K3/K4/K5
            at the micro-batches' shapes (M 8, M 4; marked `micro`).
14. obs_tools  the run-file tools (`report`, `compare`, `explain`,
            `trace`, `health`, `replay` through the port's CLI) over the
            run files the earlier phases wrote (train_flags (g)'s
            float32 CNN run under the profiler, serve_features' slo
            run, the fleet phase's crash run at --log full) and those
            written here: float32 and bf16 CNN runs of FLAGS_TIME_STEPS
            steps, an `lm` run of FLAGS_LM_STEPS steps at the flagship,
            a `serve-bench --requests 12 --seed 0` run (launches zeroed
            just before each and read just after). The CNN (f32, bf16)
            and LM `program` records say backend cuda, and their FLOPs
            equal what the same config counts on the plain path (the
            CNN's on the CPU, the LM's on the meta device); `report`
            gives each an mfu; `explain`, `trace` and `replay` exit 0 on
            the serve and fleet files; `health` gives its verdicts; and
            `compare` of the card's serve run against the CPU's under a
            gate of the schedule metrics and blame_crc at 0%, `equal`,
            finds every one ok. OBS_TOOLS_BUDGET_S at most.
15. tools_search  the last tools and the trainers' string driver, each
            path's launches zeroed just before it and read just after:
            (a) `runtime_abi` from the reference's config JSON ("tpu",
            "use_pallas"): reference_cnn on ABI_TRAIN IDX stripes, one
            epoch, evaluate, save, a fresh init, load, evaluate again
            (the params restored bit for bit, the evals equal, K3/K4/K5
            the epoch's steps x 9/3/2 and 3/2/0 an eval batch); (b) its
            LM at the flagship, ABI_LM_STEPS flash steps and the eval
            (K7/K8/K9 8/8/8 a step, 8/0/0 the eval); (c) `autosize`
            twice, `compare` under ci/autosize_gate.json, and its
            frontier through `fleet-bench --compute engine --autoscale
            on --autoscale-frontier` at FLEET_ARGS (every request ends
            with exactly its budget, K1/K2 depth and 5 depth + 1 a
            forward); (d) `chaos` twice at 8 episodes (no violation,
            `compare` under ci/chaos_gate.json) and the planted
            fence-revoke bug found and shrunk; (e) `lint` of the port,
            exit 0 with no finding. TOOLS_SEARCH_BUDGET_S at most.

Then `nvidia-smi`'s name and power limit, the kernels line
({"kernels": [...]}, each source's C launch function and `__global__`
kernels; launches of K1/K2 from the serve, generate, serve_features,
fleet and tools_search phases, of K3/K4/K5 from the train, cnn_mesh and
tools_search phases, of K6 from conv_bench and of K7/K8/K9 from the lm,
lm_head_dims, lm_moe, lm_sp, lm_mesh and tools_search phases; K7/K8/K9
also with their times at the flagship's geometry at each timed head dim
and the head dims held) and,
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
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

HERE = Path(__file__).resolve().parent

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and the
# float32 rate outside the tensor cores, which is what every kernel here
# computes in (and the bound of float32 work).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
# median_ms's spin before each timed call: 2.5e6 cycles, about 1.25 ms at
# the H100's 1.98 GHz, above any timed call's host enqueue (the plain
# versions' few PyTorch ops take well under 1 ms); each timed call pays
# it in the script's wall time (5e6 before, halved for the script's time
# limit).
SPIN_CYCLES = 2_500_000

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
# serve_profile: decode ticks profiled, after warm-up ones (20 before,
# cut for the script's time limit).
SERVE_PROFILE_TICKS = 10
# serve_features: the serve phase's flagship and requests' ranges, fewer
# requests (for the phase's 120 s), template traffic (--prefix-mix 0.9
# --templates 4), one seed for every run (1: its 12 requests share
# prefixes in the sharing run, three of them copy-on-write); the lookup
# run's verify block, FEATURES_SPEC_K rows a slot; the draft model
# serve-bench makes by default (--draft-dim 0 -> dim / 2, --draft-depth
# 0 -> 1) and its products (wq, wkv, w1, w2, the head; wo is wq's shape).
FEATURES_REQUESTS = 12
FEATURES_SEED = 1
FEATURES_SPEC_K = 8
# The draft runs verify 4 rows a slot: their draft (a second random
# model) accepts next to nothing, and its proposal steps set their time.
FEATURES_DRAFT_K = 4
DRAFT_DIM, DRAFT_DEPTH = 256, 1
GEMM_DRAFT = [(256, 256), (256, 128), (256, 1024), (1024, 256), (256, 8192)]
FEATURES_ARGS = (
    [{"--requests": str(FEATURES_REQUESTS),
      "--seed": str(FEATURES_SEED)}.get(SERVE_ARGS[i - 1], a)
     for i, a in enumerate(SERVE_ARGS)]
    + ["--prefix-mix", "0.9", "--templates", "4"])
# (name, flags): the spec-off and sharing-off baseline first; every run
# is held to its tokens. "{tmp}" is the phase's temporary directory.
# The spill run's pool (140 pages) cannot keep the four templates
# beside the live requests, so reclaimed template pages spill to its
# host tier (256 pages, all of them); later requests look up spills 38
# to 33, and 33, the last, is the one corrupted (the schedule does not
# depend on the weights: rehearsed on the CPU at a small width). The
# slo run's page quota (96) lets a t0 request of the longest prompt in.
FEATURES_TIGHT_PAGES = 140
FEATURES_HOST_PAGES = 256
FEATURES_CORRUPT_SPILL = 33
FEATURES_RUNS = (
    ("base", []),
    ("prefix", ["--prefix-cache"]),
    ("lookup", ["--prefix-cache", "--spec", "lookup",
                "--spec-k", str(FEATURES_SPEC_K)]),
    ("draft_paged", ["--spec", "draft", "--draft-cache", "paged",
                     "--spec-k", str(FEATURES_DRAFT_K)]),
    ("draft_window", ["--spec", "draft", "--draft-cache", "window",
                      "--spec-k", str(FEATURES_DRAFT_K)]),
    ("spill", ["--prefix-cache", "--spill",
               "--pages", str(FEATURES_TIGHT_PAGES),
               "--host-pages", str(FEATURES_HOST_PAGES),
               "--fault-plan",
               f"kv_corrupt@tier.spill:{FEATURES_CORRUPT_SPILL}"]),
    ("slo", ["--scheduler", "slo", "--tenants", "2",
             "--tenant-priority", "t1=2",
             "--tenant-quota", "t0=slots:2/pages:96",
             "--fault-plan", "squeeze@serve.tick:5?pages=64&ticks=20",
             "--slo", "{tmp}/slo.json",
             "--metrics-jsonl", "{tmp}/features.jsonl"]),
)
FEATURES_SLO = {
    "tenants": {"*": {"availability": 0.99,
                      "ttft_ms": {"target": 0.9, "threshold_ms": 2000.0}}},
    "burn": {"windows_s": [[10.0, 1.0]], "max_rate": 10.0},
    "rules": [{"name": "tick-stale", "kind": "absence", "event": "tick",
               "max_gap_s": 1.0}],
}
FEATURES_BUDGET_S = 120.0
# fleet: fleet-bench --compute engine at the serve flagship's width (the
# model, cache, kernel, slot, page and chunk flags and the request ranges
# of SERVE_ARGS; fleet-bench has no --max-seq, its sequences reach
# prompt-max + out-max), FLEET_REQUESTS requests arriving at once, one
# seed. FLEET_RUNS: (name, flags), the baseline first; the crash run
# stops replica 1 at fleet tick FLEET_CRASH_TICK (mid-prefill) as a
# zombie for 2 ticks; the transport run duplicates and delays commit
# messages only (a delayed heartbeat could fail a live replica over and
# change the schedule the run is held to).
FLEET_REQUESTS = 12
FLEET_SEED = 1
FLEET_CRASH_TICK = 40
FLEET_ARGS = ["--compute", "engine", "--requests", str(FLEET_REQUESTS),
              "--seed", str(FLEET_SEED), "--rate", "0", "--log", "summary"]
for _i in range(0, len(SERVE_ARGS), 2):
    if SERVE_ARGS[_i] not in ("--max-seq", "--mode", "--requests", "--seed",
                              "--rate"):
        FLEET_ARGS += SERVE_ARGS[_i:_i + 2]
FLEET_RUNS = (
    ("base", ["--replicas", "2"]),
    ("crash", ["--replicas", "2", "--fault-plan",
               f"replica_crash@fleet.tick:{FLEET_CRASH_TICK}"
               "?replica=1&zombie_ticks=2"]),
    ("disagg", ["--pools", "prefill:1,decode:1", "--handoff-ticks", "2"]),
    ("transport", ["--replicas", "2", "--transport", "--fault-plan",
                   "msg_dup@fleet.transport:5?kind=commit&count=3;"
                   "msg_delay@fleet.transport:30?kind=commit&ticks=3"
                   "&count=2"]),
)
FLEET_BUDGET_S = 90.0
# The kernels built on mma.sync: their libraries must hold tensor-core
# instructions (HMMA in the SASS).
TENSOR_CORE_KERNELS = ("gemm", "conv_direct", "conv_dw", "conv_gemm",
                       "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Functions that must hold HMMA themselves, every instance of them
# (library, mangled-name fragment): the float32 flash forward and backward
# (3xTF32), whose libraries would pass the check above on their bf16
# kernels alone.
# the flash kernels' instances (`flash_attention.HEAD_DIMS`)
FLASH_HEAD_DIMS = (16, 32, 64, 80, 96, 128, 256)
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
# K2 off the serving shapes (N, din, dout): one slot; a ragged N, din and
# dout (8-byte copies of q); an odd dout and a din that is not a multiple
# of 4 (byte copies of q, 4-byte copies of x).
GEMM_RAGGED = [(1, 512, 512), (5, 200, 40), (3, 203, 37)]

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
# One rank's batch in the dp phase's world-2 step, at which K3 (M 16), K4,
# K4' and K5 also run in float32.
RANK_BATCH = CNN_BATCH // 2
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
# dp: the train phase's configuration (reference_cnn, 60,000 samples,
# batch 32, SGD lr 0.1, the kernels) through parallel/dp.py. The
# AGREE_STEPS steps are one epoch of AGREE_STEPS batches (as train_agree
# runs them) on the device-resident route; the CPU tests hold the
# per-batch route to the JAX DP trainer. World 1 on a one-rank NCCL
# group: AGREE_STEPS steps equal to the one-device Trainer's bit for bit
# (a one-rank all-reduce is the identity). World 2
# as two gloo ranks on cuda:0 (NCCL refuses two ranks on one card; gloo
# stages the all-reduce through the host): the first step's averaged
# gradients against the one-device step's, per leaf: the two halves'
# sums and the whole batch's add the same products in another order (a
# few float32 ulp, about 1e-7 relative), a wrong shard or a missing
# divide by the world is off by 1e-1 or more, so 1e-5; after AGREE_STEPS
# steps, params within AGREE_PARAM_ATOL (the ReLU-crossing drift of
# train_agree) and predictions equal or tied; then one epoch of
# DP_EPOCH_TRAIN samples on the device-resident route and the eval of
# the 10,000, held as the train phase is (cut from 60,000 samples in PR
# 20 for the script's time limit: every check kept; train_flags' epochs
# reach 10,000/10,000 at 200 steps too). With
# two cards or more, also world min(4, cards) over NCCL, one rank a card,
# under the same checks. A rank's failure fails the phase.
DP_WORLD = 2
DP_EPOCH_TRAIN = 6_400    # 12,800 before, cut for the time limit
DP_MAX_NCCL_WORLD = 4
DP_GRAD_REL_L2 = 1e-5
DP_RANKS_TIMEOUT_S = 600
DP_NOTE = ("correctness run: the ranks share one card and gloo stages the "
           "all-reduce through the host; not a scaling figure")

# cnn_mesh (after dp): the train phase's configuration (reference_cnn,
# batch 32, SGD lr 0.1, the kernels) on the sharded meshes of
# parallel/tp.py (TP, FSDP) and parallel/pp.py (PP, TP x PP, FSDP x PP),
# as gloo ranks on cuda:0 (NCCL refuses two ranks on one card), each
# mesh AGREE_STEPS steps (one device-resident epoch of AGREE_STEPS
# batches, evaluated on CNN_MESH_AGREE_TEST test samples) against the
# one-device Trainer from the same init: the first
# step's gradients within DP_GRAD_REL_L2 per leaf (the microbatch and
# model-shard sums add the same products in another order), the params
# after the steps within AGREE_PARAM_ATOL and the test predictions equal
# or tied (train_agree's drift); lenet5_relu on pipe:2,model:2 against
# its own one-device run. Every rank's K3/K4/K5 launches and
# collectives a step and an eval batch must be those the mesh's plan
# gives (`mesh_plan_counts`). Then pipe:2 and data:2,model:2 train one
# epoch of CNN_MESH_EPOCH_TRAIN samples (in their world's spawn) and
# evaluate the 10,000 test samples, held to the JAX CPU accuracy. With
# cards for them, each
# world also runs over NCCL, one rank a card. The phase must end within
# CNN_MESH_BUDGET_S; over it, the epochs' samples are cut first.
CNN_MESH_BUDGET_S = 90.0
CNN_MESH_CLIP = {"momentum": 0.9, "grad_clip": 0.05}
CNN_MESH_RUNS = (
    ("reference_cnn", "data:2,model:2", {}),
    ("reference_cnn", "model:4", {}),
    ("reference_cnn", "data:2,model:2", {"fsdp": True}),
    ("reference_cnn", "pipe:2,data:2", {}),
    ("reference_cnn", "pipe:2,model:2", {}),
    ("reference_cnn", "pipe:2,model:2", CNN_MESH_CLIP),
    ("reference_cnn", "pipe:2,data:2", {"fsdp": True}),
    ("reference_cnn", "pipe:2,data:2", {"fsdp": True, **CNN_MESH_CLIP}),
    ("lenet5_relu", "pipe:2,model:2", {}),
    ("reference_cnn", "data:2", {"fsdp": True}),
    ("reference_cnn", "pipe:2", {}),
    ("reference_cnn", "pipe:2", {"num_microbatches": 4}),
    ("reference_cnn", "pipe:2", CNN_MESH_CLIP),
)
CNN_MESH_EPOCHS = (("reference_cnn", "pipe:2", {}),
                   ("reference_cnn", "data:2,model:2", {}))
# The agree runs' test set (one eval batch) and the epochs' train set:
# cut from the 10,000 and the 60,000 to fit the budget, and the two
# worlds' spawns run at once. Every rank's one-card gloo step takes
# 9-80 ms, so a whole epoch of 1,875 steps took 32-71 s a mesh, and the
# phase 220.6 s whole, 99.1 s at 2,048 / 6,400 inside the whole script
# (on an NVIDIA H100 80GB HBM3 at 700.00 W); 100 steps reach 10,000 of
# the 10,000 test samples as the whole epoch does.
CNN_MESH_AGREE_TEST = 512
CNN_MESH_EPOCH_TRAIN = 3_200
CNN_MESH_NOTE = ("correctness run: the ranks share one card and gloo stages "
                 "every collective and send through the host; not a "
                 "scaling figure")
# K3, K4, K4' and K5 at the shapes the cnn_mesh runs and epochs launch
# them (`mesh_kernel_calls`; the kernels phase, float32): each rank's
# layers at its rows of a step (the batch over n_data and the
# microbatches) and of an eval batch, with the features sliced over
# 'model'. Those of reference_cnn's whole layers that the kernels phase
# makes already (a step at 32, 16, 8 and 4 rows; an eval batch of
# EVAL_BATCH) are not made twice. Each time is a median of
# MESH_CASE_REPS calls (30 elsewhere): 87 cases at 30 took 22.0 s; 5,
# since every kernel case but the timed ones is a correctness case and
# the script must fit its time limit on a slow host.
MESH_CASE_REPS = 5
HEAD_DIM_CASE_REPS = 5    # the head-dim cases (FLASH_HEAD_DIM_SHAPES;
                          # 10 before, cut for the time limit)

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
# One rank's share of the flagship in the lm_dp phase (world 2: B 4).
FLASH_RANK_SHAPES = [("float32", 4, 2048, 8, 8, 64)]
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
# Head dim 16, in both types, causal and not, MHA and GQA: (dtype, B, S,
# H, Hkv, D, causal).
FLASH_D16_SHAPES = [(dtype, 2, 1024, 4, hkv, 16, causal)
                    for dtype in ("float32", "bfloat16") for hkv in (4, 2)
                    for causal in (True, False)]
# The float32-output mode on bf16 inputs (K7 `out_f32`, K8/K9
# `grads_f32`) at the lm_sp phase's per-rank blocks (B 8, 1,024 of the
# flagship's 2,048 positions; rank 1 folds a full block and the diagonal),
# and GQA at D 16; held to the bf16 bands of FLASH_RTOL_OF_MAX and
# FLASH_BF16_REL_L2 against the plain versions before their rounding.
# Those bands cannot tell an output rounded to bf16 (about 1e-3 more error)
# from one left unrounded, so each float32 output must also differ from
# its own bf16 rounding on at least F32_OUT_UNROUNDED_MIN of its elements
# (a float32 sum of bf16 products is bf16-representable about once in
# 2^16; a causal o's first row, a single v row, always is).
# Each shape also runs with bf16 outputs, the mode's time beside.
FLASH_F32_OUT_SHAPES = [("bfloat16", 8, 1024, 8, 8, 64, True),
                        ("bfloat16", 8, 1024, 8, 8, 64, False),
                        ("bfloat16", 2, 1024, 4, 2, 16, True)]
F32_OUT_UNROUNDED_MIN = 0.9
FLASH_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# Head dims beyond the ones above, (dtype, B, S, H, Hkv, D, causal) at
# HEAD_DIM_CASE_REPS calls: the instances 80, 96 and
# 256, and D 24 and 48,
# which the wrapper zero-pads to the 32 and 64 instances (`pad_route`);
# both types, causal and not, 8 heads MHA and over 2 kv heads.
FLASH_HEAD_DIM_SHAPES = [(dtype, 2, 256, 8, hkv, d, causal)
                         for d in (24, 48, 80, 96, 256)
                         for dtype in ("float32", "bfloat16")
                         for hkv in (8, 2) for causal in (True, False)]
# The flagship's geometry (B 8, S 2048, 8 heads, causal) at D 80 and 96
# (Phi-2's and Phi-3-mini's head dims, instances), at 30 calls with
# SDPA's times (`tools/flash_head_dims.py --times` adds D 48, padded to
# 64: the padding's cost beside D 64).
FLASH_HEAD_DIM_TIMED = [(dtype, 8, 2048, 8, 8, d) for d in (80, 96)
                        for dtype in ("float32", "bfloat16")]
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
# lm-bench at the flagship (vocab 8192): the full matrix, 4 timed steps
# after 3 warm-up steps each (10 before, cut for the time limit).
LM_BENCH_ARGS = ["--steps", "4"]
LM_BENCH_STEPS = 7
# lm_agree: 5 float32 steps (10 before, cut for the time limit) of the
# lm phase's configuration from one
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
LM_AGREE_ARGS = LM_MODEL_ARGS + ["--steps", "5", "--warmup-steps", "2",
                                 "--log-every", "1"]
LM_AGREE_LOSS_ATOL = 1e-4
LM_AGREE_APART_SHARE = 1e-3
LM_AGREE_GRAD_REL_L2 = 1e-4
# lm_dp: the lm phase's flagship with flash attention at world 2 (two
# gloo ranks on cuda:0, 4 rows each), LM_DP_STEPS steps from one init,
# against as many one-device LMTrainer steps: every rank launches K7/K8/K9
# 8/8/8 a step (and K7 8 times in the eval); the losses within
# LM_AGREE_LOSS_ATOL, the first step's averaged gradients within
# LM_AGREE_GRAD_REL_L2 per leaf (the halves' token means averaged against
# the whole batch's mean: float32 sums in another order).
LM_DP_STEPS = 3   # cut from 5 for the script's time limit
LM_DP_ARGS = LM_MODEL_ARGS + ["--attn-impl", "flash", "--steps",
                              str(LM_DP_STEPS), "--warmup-steps", "2",
                              "--log-every", "1"]
# lm_agree in bf16 compute: the first step's gradients with flash and
# with the oracle, per leaf. Both round q, k, v, p and every activation
# to bf16 (2^-9 relative), but at other places: the oracle rounds p
# against the row max, K7 against a running max per 64-key tile, and
# K8/K9 round ds and p^T where the oracle's autograd rounds other
# intermediates; over 8 layers such flips add up to a few 1e-3. A wrong
# dq, dk or dv moves a leaf by far more than 2e-2.
LM_BF16_GRAD_REL_L2 = 2e-2
# lm_head_dims: the lm phase's flagship at d 768 over 8 heads (head dim
# 96, Phi-3-mini's: 3072 / 32) with flash attention, MHA and GQA 8/2, in
# float32 and bf16 compute (the bf16 run from the float32 run's initial
# params), LM_HEAD_DIM_STEPS steps and the eval each, held as the lm
# phase holds its run (the loss falling: the held-out loss below its
# value before the steps; a few steps cannot halve it, and a step's own
# batch loss can rise while AdamW's first steps at the full rate settle)
# and their first-step gradients as lm_agree's.
LM_HEAD_DIM = 768
LM_HEAD_DIM_ARGS = ([a if LM_MODEL_ARGS[i - 1] != "--dim" else str(LM_HEAD_DIM)
                     for i, a in enumerate(LM_MODEL_ARGS)]
                    + ["--attn-impl", "flash", "--log-every", "1"])
LM_HEAD_DIM_STEPS = 3
LM_HEAD_DIM_KV = ([], ["--kv-heads", "2"])
# lm_sp: the lm phase's flagship, cut to LM_SP_DEPTH layers, at
# --mesh-shape seq:2 as two gloo ranks on cuda:0 (sequence parallelism,
# parallel/sp.py), each holding 1,024 of the 2,048 positions of all 8
# rows. ring_flash (what flash resolves to
# on the card): LM_SP_STEPS float32 steps and the first step's gradients
# in float32 and bf16; ring and ulysses in float32: the first step's
# gradients and LM_SP_OTHER_STEPS steps each. Held against the
# one-device flash LMTrainer from the same seeded init: float32 first
# gradients per leaf within LM_AGREE_GRAD_REL_L2 (the halves' folds and
# sums add the same float32 products in other orders), bf16 within
# LM_BF16_GRAD_REL_L2, the float32 losses within LM_AGREE_LOSS_ATOL. A
# causal step of ring_flash launches K7/K8/K9 depth x (r + 1) times
# on seq rank r: rank 0 folds only its diagonal block, rank 1 a full
# block and its diagonal; the eval runs the whole sequence on K7 (depth
# a rank). Step times are correctness runs (two ranks share the card and
# gloo stages each ring hop through the host), not scaling figures.
LM_SP_WORLD = 2
LM_SP_STEPS = 3
LM_SP_OTHER_STEPS = 1
# The flagship cut to LM_SP_DEPTH layers (for chip_smoke.py's time
# limit, from 4, at which the whole script took up to 1,240 s on a slow
# host; every check as at depth 8): per step each rank launches each
# kernel once a layer a ring hop it folds, per eval K7 once a layer.
LM_SP_DEPTH = 2
LM_SP_ARGS = ([a if LM_MODEL_ARGS[i - 1] != "--depth" else str(LM_SP_DEPTH)
               for i, a in enumerate(LM_MODEL_ARGS)]
              + ["--mesh-shape", "seq:2", "--warmup-steps", "2",
                 "--log-every", "1"])
LM_SP_PER_STEP = [{k: LM_SP_DEPTH * (r + 1)
                   for k in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                  for r in range(LM_SP_WORLD)]
LM_SP_PER_EVAL = {"flash_fwd": LM_SP_DEPTH, "flash_bwd_dq": 0,
                  "flash_bwd_dkv": 0}
LM_SP_NOTE = ("correctness run: the two seq ranks share one card and gloo "
              "stages each ring hop and the all-reduce through the host; "
              "not a scaling figure")
# lm_mesh: the LM trainer's sharded meshes (parallel/lm_shard.py,
# parallel/ep.py, parallel/sp.py) at the flagship's width cut to
# LM_SP_DEPTH layers, as gloo ranks on cuda:0, LM_MESH_STEPS float32
# steps each with flash attention (ring_flash under 'seq'), one spawn a
# world. Each run's first-step gradients are held per leaf within
# LM_AGREE_GRAD_REL_L2 to the one-device flash LMTrainer from the same
# seeded init (every dense mesh computes its function), except where
# the mesh's MoE routing has no one-device twin: expert:2 routes each
# rank's 4 rows by themselves, so its reference is the mean of the
# one-device trainer's gradients of each rank's rows; seq:2 routes each
# rank's half of every sequence, so its reference is the same mesh with
# the plain ring (no kernel). The MoE runs are held to LM_MOE_GRAD_REL_L2,
# as lm_moe's (b) is: the experts' ReLU kinks turn float32 rounding into
# a few 1e-4 upstream of them (5.6e-4 for seq:2 on the card, PR 20).
# The gloo worlds spawn at once, beside the one-device references. Every
# rank's K7/K8/K9 launches a step and
# an eval are held to the plan (`lm_mesh_plan`), and the kernels phase
# holds K7-K9 at every shape the phase launches them (`lm_mesh_shapes`,
# marked `lm_mesh`). The phase stays within LM_MESH_BUDGET_S.
LM_MESH_STEPS = 1   # cut from 2 for the script's time limit
LM_MESH_MOE = ["--moe-experts", "8", "--moe-top-k", "2"]
LM_MESH_RUNS = (("data:2,model:2", []), ("model:2", ["--kv-heads", "2"]),
                ("data:2", ["--fsdp"]), ("pipe:2,data:2", []),
                ("model:2,seq:2", []), ("pipe:2,model:2,seq:2", []),
                ("expert:2", LM_MESH_MOE), ("seq:2", LM_MESH_MOE),
                ("data:2,seq:2", ["--fsdp"]))
# The seq:2 MoE run's reference: the same mesh with the plain ring, its
# first gradients only (one step).
LM_MESH_RING_REF = ("seq:2", LM_MESH_MOE + ["--attn-impl", "ring",
                                            "--steps", "1"])
# The spawns, all at once (indices into LM_MESH_RUNS, the reference as
# "ring"): each world's runs, the MoE ones of world 2 apart, so that no
# spawn runs much longer than the others.
LM_MESH_SPAWNS = ((1, 2, 6), (7, "ring"), (0, 3, 4, 8), (5,))
LM_MESH_BUDGET_S = 150.0
LM_MESH_NOTE = ("correctness run: the ranks share one card and gloo stages "
                "every collective and pipeline hop through the host; not a "
                "scaling figure")
# recover: crash-safe training on the card (`train/checkpoint.py`,
# `faults.py`). CNN: the train configuration at dp's 50 steps (one
# device-resident epoch of 1,600 samples, batch 32, lr 0.1) through the
# `train` command's rank entry, saving every RECOVER_EVERY steps on the
# background writer, then the eval of RECOVER_TEST samples (one eval
# batch). Every run is held bit for bit to the uninterrupted run: the
# kernels sum in a fixed order (K3 and K5 their splits, K9 the GQA
# group), so a resumed step replays the same arithmetic. The launches of
# K3/K4/K5 are held to PER_STEP a step over every attempt's steps (a
# replayed step counts again) and PER_EVAL in the eval. LM: the lm
# phase's flagship in float32 with flash attention, LM_RECOVER_STEPS
# steps saving every LM_RECOVER_EVERY steps, crashed after step
# LM_RECOVER_CRASH and restarted: per-step losses and the final
# checkpoint's every array (params, AdamW's moments and count, the step)
# equal the uninterrupted run's, with LM_PER_STEP launches a step. DP:
# dp's world 2 (two gloo ranks on cuda:0), crashed and restarted, bit
# for bit the uninterrupted world-2 run, rank 0 the only writer.
# train_flags: the CNN trainer's remaining flags on the card, at the
# train phase's configuration (reference_cnn, batch 32, lr 0.1,
# synthetic stripes 6,400 / 10,000, the kernels, the device-resident
# epoch; the 60,000 of PRs 14-18 cut in PR 19 to keep the whole script
# inside its limit, and 12,800 cut again to 6,400 for it: 200 steps
# reach the test accuracy a whole epoch does, and the step times are
# taken apart), and the LM's share at the lm phase's flagship (float32, flash,
# vocab 251). (a) --grad-accum 4: K3/K4/K5 36/12/8 a step (four
# micro-batches of 8), one epoch at >= FLAGS_MIN_CORRECT / 10,000, the
# first step's gradients within ACCUM_GRAD_REL_L2 per leaf of the
# batch-32 step's (the four micro-sums add in another order: about 1e-7
# relative). (b) --remat: the first step's gradients bit for bit the
# plain step's (the recomputed forward is the same kernels on the same
# inputs), 12/5/2 a step (every layer's forward again in the backward).
# (c) bf16 params and bf16 compute: one epoch at >= FLAGS_MIN_CORRECT
# with every param bf16 after it; bf16 params in float32 compute on the
# kernels: the reference's gradient dtypes (MIXED_GRAD_DTYPES) and the
# values within BF16_PARAMS_GRAD_REL_L2 of PyTorch's ops on the upcast
# weights (the conv biases' gradients are rounded to bf16, 2^-9). (d)
# --augment shift: the first FLAGS_AUG_STEPS steps' batches, as the step
# computed on, bit for bit the numpy copy's draws applied on the host,
# 9/3/2 a step, finite losses. (e) --elastic-width 8: world 1 (one NCCL
# rank) and world 2 (two gloo ranks on cuda:0) bit for bit after
# FLAGS_ELASTIC_STEPS steps, 72/24/16 a step at world 1 and 36/12/8 on
# each rank at world 2; a world-2 run preempted at step
# FLAGS_ELASTIC_CUT resumed on world 1 gives the same bits. (f) LM
# --grad-accum 2: 16/16/16 a step, the first step's gradients within
# ACCUM_GRAD_REL_L2; --elastic-width 4 at worlds 1 and 2 bit for bit
# over FLAGS_LM_STEPS steps (losses and eval loss). (g) --metrics-jsonl
# and --profile-dir over FLAGS_TIME_STEPS steps: every record validates,
# the memory records carry a peak, a trace is written; the full epoch
# timed without and with the sink. Each path's step is timed against
# the plain step over FLAGS_TIME_STEPS steps after a warm-up epoch.
FLAGS_ACCUM = 4
FLAGS_ELASTIC = 8
FLAGS_ELASTIC_STEPS = 20
FLAGS_ELASTIC_CUT = 10
FLAGS_AUG_STEPS = 3
FLAGS_LM_ACCUM = 2
FLAGS_LM_ELASTIC = 4
FLAGS_LM_STEPS = 3
FLAGS_TIME_STEPS = 50
FLAGS_TRAIN, FLAGS_TESTS = 6_400, 10_000    # 12,800 before: time limit
FLAGS_MIN_CORRECT = 9_900
ACCUM_GRAD_REL_L2 = 1e-5
BF16_PARAMS_GRAD_REL_L2 = 1e-2
MIXED_GRAD_DTYPES = ["bfloat16", "float32"] * 2 + ["float32"] * 6
ACCUM_PER_STEP = {k: v * FLAGS_ACCUM for k, v in PER_STEP.items()}
REMAT_PER_STEP = {"gemm": 12, "conv_direct": 5, "conv_dw": 2}
ELASTIC_PER_STEP = {k: v * FLAGS_ELASTIC for k, v in PER_STEP.items()}
RECOVER_EVERY = 10
RECOVER_CRASH = 23
RECOVER_CKPT_CRASH = 40   # the dp part's crash in rank 0's save of ckpt_40
RECOVER_PREEMPT = 17
RECOVER_NAN = 7
RECOVER_TEST = 2048
RECOVER_TIMING_REPS = 3   # 5 before, cut for the time limit
LM_RECOVER_STEPS = 10
LM_RECOVER_EVERY = 4
LM_RECOVER_CRASH = 6
LM_RECOVER_TIMING_VOCAB = 8192
LM_RECOVER_ARGS = LM_MODEL_ARGS + [
    "--attn-impl", "flash", "--steps", str(LM_RECOVER_STEPS),
    "--warmup-steps", "2", "--log-every", "1",
    "--checkpoint-every", str(LM_RECOVER_EVERY)]
# lm_moe: the LM flagship with 8 experts a block, top-2, capacity factor
# 1.25 (`scripts/bench_lm.py:108-128`'s MoE flags; 152,093,696 params at
# vocab 8192, 143,962,112 at the synthetic corpus's 251). (a) `lm` in
# bf16 compute with flash attention and chunked routing (512 tokens a
# chunk), LM_MOE_STEPS steps and the eval: K7/K8/K9 8/8/8 a step and
# 8/0/0 an eval, the loss below LM_LOSS_DROP x the first step's; step
# ms, tokens/s, mfu (analytic FLOPs, k experts a token) and the peak
# memory. (b) float32, chunk 512: the first step's gradients with flash
# and with the oracle attention within LM_MOE_GRAD_REL_L2 per leaf.
# (c) float32, unchunked, at the largest batch of LM_MOE_BATCHES whose
# reckoned peak (below) is at most LM_MOE_MEMORY_SHARE of the card: its
# first step's gradients against a chunk-512 step's at the same batch
# within LM_MOE_GRAD_REL_L2 per leaf when neither drops a token;
# otherwise both drop counts are printed (the chunks' capacity differs by
# definition). (d) `lm-bench --moe-experts 8 --moe-top-k 2` at vocab
# 8192, bf16 + flash chunked and unchunked, float32 chunked and
# unchunked (at (c)'s batch), with peak memory; then torch.profiler's
# split of one MoE layer (16,384 tokens) into the reference's stages.
LM_MOE_ARGS = LM_MODEL_ARGS + ["--moe-experts", "8", "--moe-top-k", "2"]
LM_MOE_CHUNK = 512
LM_MOE_STEPS = 30
LM_MOE_TRAIN_ARGS = LM_MOE_ARGS + [
    "--attn-impl", "flash", "--compute-dtype", "bfloat16",
    "--moe-dispatch-chunk", str(LM_MOE_CHUNK), "--steps", str(LM_MOE_STEPS),
    "--warmup-steps", "5", "--log-every", "10"]
LM_MOE_BATCHES = (8, 4, 2)
LM_MOE_MEMORY_SHARE = 0.75
# Unchunked routing's float32 (T, E, C) tensors, in bytes per T^2 at E 8,
# top-2, cf 1.25 (C = 0.3125 T, so T * E * C * 4 = 10 T^2): autograd keeps
# the dispatch and combine tensors of each of the 8 layers (160 T^2), and
# building a layer's dispatch holds three at once (30 T^2).
LM_MOE_ROUTING_BYTES_PER_T2 = 190
# (b) and (c) hold per-leaf gradients to LM_MOE_GRAD_REL_L2, not the
# dense LM's 1e-4: the experts' ReLU has a kink where GELU is smooth, and
# of the 67M expert pre-activations a layer (16,384 tokens x 2 choices x
# 2,048 units) about 1e-6 lie within float32 rounding of 0, so two
# attentions' rounding puts some tens of them on the other side; each
# switches its unit's whole gradient term: sqrt(50 / 67M) ~ 1e-3 of a
# leaf's norm upstream of the kinks (measured on the card: 3e-5 to 5.2e-4
# for w1 and every leaf below it, 1e-6 or less for the last block's w2
# and gate, the head and ln_f). A wrong dq, dk or dv moves a leaf by far
# more than 2e-3.
LM_MOE_GRAD_REL_L2 = 2e-3
# (b)'s routing: flash and the oracle differ by float32 rounding (about
# 1e-6 relative), so a token whose two best experts are that close may
# choose otherwise, and from there its residual stream, the capacity
# queue behind it and every later layer differ (seen on the card: a
# choice 0.14 apart in a later layer). The oracle's forward therefore
# routes by the flash forward's choices, layer by layer (its gates from
# its own probabilities); where its own probabilities would have chosen
# otherwise, the two must be a tie, within MOE_ROUTE_TIE.
MOE_ROUTE_TIE = 1e-5
# An MoE engine's int8 page writes against its plain twin's (`moe_tie`):
# codes one step apart only at values within MOE_CODE_EDGE_TOL code steps
# of the edge between them (float rounding: the two paths' scales were
# seen 1.2e-6 apart, about 1.5e-4 of a step at code 127), and on at most
# MOE_CODE_EDGE_MAX_SHARE of the codes a forward writes.
MOE_CODE_EDGE_TOL = 1e-2
MOE_CODE_EDGE_MAX_SHARE = 1e-4
# (d)'s lm-bench rows at 2 of the flagship's 8 layers (for
# chip_smoke.py's time limit, cut from 4; each row draws its own
# seeded init), 4 timed steps (10 before, cut for the time limit).
LM_MOE_BENCH_ARGS = ["--steps", "4", "--moe-experts", "8",
                     "--moe-top-k", "2", "--depth", "2"]
MOE_SPLIT_STAGES = ("ep.router_build", "ep.dispatch_einsum", "ep.expert_ffn",
                    "ep.combine_einsum")
MOE_SPLIT_RUNS = 2   # 3 before, cut for the time limit
# generate: the lm phase's dense flagship and the lm_moe model (both
# trained, vocab 251, max_seq 2048) sample GEN_TOKENS tokens greedily
# from the eval tail (`LMTrainer.sample`: a 1,024-token prompt) with int8
# decode weights: K2 on every weight product, GEN_K2_PER_TOKEN a token
# (dense: wqkv, wo, w1, w2 of 8 layers and the head; MoE: wqkv and wo,
# the experts stay float32, and the head), counting the prefill as the
# first token's forward. Each run is held against the same run on the
# plain path (`int8_gemv_plain`'s dequantized weights): equal, or at the
# first difference a tie (top-2 gap of the plain path's logits, scaled
# and noised when sampling, below TIE_GAP). Then lookup with k
# GEN_LOOKUP_K against generate (equal or tied; mean accepted tokens a
# round), a temperature-GEN_TEMPERATURE run against its plain twin, and
# an MoE PagedEngine on K1 + K2 against its plain paths (gather read,
# dequantized weights): the serve phase's geometry (8 slots, page 16,
# chunk 32), int8 MHA pages (the serve phase's kind: K1 within 1e-4 of
# the gather read, so the tie rule holds; bf16 pages differ by up to
# 1e-2, ATTN_ATOL, and a top-2 gap of 1.5e-3 was seen there), int8
# weights, GEN_SERVE requests; K1 8 and K2 17 a forward. Where its tokens
# part, the two forwards are held with their discontinuities fixed
# (`moe_tie`): a k/v value on an int8 code's rounding edge is written one
# step apart by the two paths and moves the router by more than float
# rounding (seen on the card from the seed-0 init: 29 writes with such a
# code before a choice 1.9e-3 apart; with the kernel path's codes and
# routes the plain path chose the kernel's token by 5.2e-3), so few such
# codes, each near its edge (MOE_CODE_EDGE_*). ms a token are
# timed on a second, warmed call of each path (the sample's first call
# quantizes the weights).
GEN_TOKENS = 64   # cut from 256, then 128, for the script's time limit
GEN_K2_PER_TOKEN = {"dense": 33, "moe": 17}
GEN_LOOKUP_K = 8
GEN_TEMPERATURE = 0.8
GEN_SEED = 0
GEN_SERVE = dict(n=8, vocab=251, prompt_min=64, prompt_max=512, out_min=16,
                 out_max=64, rate=0.0, seed=0)
# K2 at generate's products, (din, dout), at N 1 (generate, B 1) and N 8
# (the lookup verify block): the dense flagship's wqkv, wo, w1, w2, its
# head at vocab 8192 and at the synthetic corpus's 251.
GEMM_GENERATE = [(512, 1536), (512, 512), (512, 2048), (2048, 512),
                 (512, 8192), (512, 251)]


# obs_tools: the phase's time limit, the serve-bench run compared
# between the card and the CPU (ci/serve_gate.json's command), and the
# summary keys its gate holds equal in each mode.
OBS_TOOLS_BUDGET_S = 60.0
OBS_SERVE_ARGS = ["--requests", "12", "--seed", "0"]
OBS_GATE_KEYS = ("decode_ticks", "prefill_chunks", "preemptions",
                 "output_tokens", "requests", "status.finished",
                 "state_crc", "blame_crc")
# tools_search (phase 15): runtime_abi's CNN on ABI_TRAIN stripes (one
# epoch of batch CNN_BATCH) and ABI_TEST test samples (one eval batch of
# EVAL_BATCH), its LM at the flagship for ABI_LM_STEPS flash steps; the
# capacity search's sweep, whose frontier then drives an autoscaled
# engine fleet at FLEET_ARGS; the fault search's episodes and its
# planted-bug canary; the lint of the port. TOOLS_SEARCH_BUDGET_S at most.
TOOLS_SEARCH_BUDGET_S = 45.0
ABI_TRAIN = 3_200
ABI_TEST = 2_048
ABI_LM_STEPS = 3
AUTOSIZE_ARGS = ["--budget", "2", "--requests", "60", "--rate", "200",
                 "--seed", "0"]
CHAOS_ARGS = ["--episodes", "8", "--seed", "7"]
CHAOS_PLANT_ARGS = ["--episodes", "2", "--seed", "7", "--plant",
                    "skip-revoke"]
# Where the phases keep the run files obs_tools reads (set by main).
KEEP: Path | None = None

_T0 = time.perf_counter()


def keep(path: Path, name: str) -> None:
    """Copy a run file a phase wrote into KEEP (when set) as `name`."""
    if KEEP is not None:
        KEEP.joinpath(name).write_bytes(Path(path).read_bytes())


def emit(obj) -> None:
    """One JSON line; a phase's line also gets the seconds since the
    script started (`t_s`)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - _T0, 1)}
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
    around each call. A spin kernel of about 1.25 ms (SPIN_CYCLES) is
    queued before each pair, so the card is still busy while the host
    enqueues the call and host time (up to that long) never shows up as
    device time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(SPIN_CYCLES)
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
                   last_range: tuple[int, int] | None = None,
                   kv_heads: int = KV_HEADS, head_dim: int = HEAD_DIM,
                   alias: int = 0) -> dict:
    """One paged-attention call at the serving shapes (HEADS query heads
    over `kv_heads`, `head_dim` wide): a pool of b *
    pages + 1 pages, distinct random block tables of `pages` pages,
    positions that end mid-page in [last_range) (by default the table's
    second half); `ragged`: slot 0's in its first page instead (one short
    slot beside long ones: most of its splits see no key); `alias`: slot
    1's first `alias` table entries name slot 0's pages (prefix sharing).
    The kernel runs twice and its two outputs must be equal bit for bit
    (the splits are merged in a fixed order)."""
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
    shape = (pool, PAGE, kv_heads, head_dim)

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
    table = perm.reshape(b, pages).to(torch.int32)
    if alias:
        table[1, :alias] = table[0, :alias]
    table = table.to(dev)
    last = torch.randint(lo, hi, (b, 1), generator=gen)
    last = torch.where(last % PAGE == PAGE - 1, last - 1, last)  # mid-page
    if ragged:
        last[0] = PAGE // 2 + kk - 1
    positions = (last - kk + 1 + torch.arange(kk)[None, :]).to(torch.int32)
    positions = positions.to(dev)
    q = randn(b, kk, HEADS, head_dim)

    got = paged_attend(q, c, positions, table, PAGE)
    want = paged_attend_plain(q, c, positions, table, PAGE)
    err = (got - want).abs().max().item()
    tol = ATTN_ATOL[dtype]
    what = (f"paged_attention {dtype} B={b} kk={kk} L={L} Hkv={kv_heads} "
            f"hd={head_dim} ragged={ragged} alias={alias}")
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
        rows = {n: repeat_kv(c[n][tbl].reshape(b, L, kv_heads, head_dim),
                             HEADS).transpose(1, 2) for n in ("k", "v")}
        mask = (torch.arange(L, device=dev)[None, None, :]
                <= positions[:, :, None].long())[:, None]
        qs = q.to(rows["k"].dtype).transpose(1, 2)
        library_ms = median_ms(torch, lambda: F.scaled_dot_product_attention(
            qs, rows["k"], rows["v"], attn_mask=mask))
    # Bound: q, table, positions and the output once each, plus the
    # distinct pages the slots' rows can see (keys, values, int8 scales;
    # a page two slots share is read once); the operations are 4*hd per
    # (query head, visible key).
    elem = c["k"].element_size()
    pos = positions.long().clamp(max=L - 1).cpu()
    tbl_host = table.cpu()
    pages_read = len({int(p) for i in range(b)
                      for p in tbl_host[i, : int(pos[i].max()) // PAGE + 1]})
    page_bytes = PAGE * kv_heads * (2 * head_dim * elem
                                    + (8 if dtype == "int8" else 0))
    nbytes = (q.numel() * 4 + b * kk * HEADS * head_dim * 4 + table.numel() * 4
              + positions.numel() * 4 + pages_read * page_bytes)
    flops = 4 * head_dim * HEADS * int((pos + 1).sum())
    bound_ms, bound_by = bound(nbytes, flops)
    return {"kernel": "paged_attention", "dtype": dtype, "B": b, "kk": kk,
            "L": L, "Hkv": kv_heads, "D": head_dim, "ragged": ragged,
            "alias": alias, "bitwise_repeat": True,
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
    what = f"int8_gemm N={n} {din}x{dout}"
    if not err <= tol:
        raise AssertionError(f"{what}: max error {err} > {tol}")
    again = int8_gemv(x, w)
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: two runs differ by "
                             f"{(got - again).abs().max().item()}")
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
            "bitwise_repeat": True,
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
                  dtype: str, batch: int = CNN_BATCH, reps: int = 30) -> dict:
    """One of K3's products in a step of an FC layer (d_in, d_out) at
    `batch` rows: the forward x @ W + b, the input gradient g @ W^T, or
    the weight gradient x^T @ g, with the operands as the step has them;
    or (`eval_forward`) the forward at the eval batch. At GEMM_REPEAT's
    batch-32 products run twice, the two results held equal bit for
    bit."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import gemm, gemm_plain

    tdt = getattr(torch, dtype)

    def randn(*s):
        return torch.randn(*s, generator=gen).to(dev).to(tdt)

    rows = EVAL_BATCH if role == "eval_forward" else batch
    x, w, b = randn(rows, d_in), randn(d_in, d_out) / d_in ** 0.5, randn(d_out)
    g = randn(rows, d_out)
    if role in ("forward", "eval_forward"):
        args, kw, m, n, k = (x, w), {"bias": b}, rows, d_out, d_in
        library = lambda: torch.addmm(b, x, w)  # noqa: E731
    elif role == "input_grad":
        args, kw, m, n, k = (g, w), {"trans_b": True}, batch, d_in, d_out
        library = lambda: torch.mm(g, w.t())  # noqa: E731
    else:
        args, kw, m, n, k = (x, g), {"trans_a": True}, d_in, d_out, batch
        library = lambda: torch.mm(x.t(), g)  # noqa: E731
    got = gemm(*args, **kw)
    want = gemm_plain(*args, **kw)
    product = (gemm_plain(*args).float().abs().max().item()
               if "bias" in kw else None)
    errs = check_case(torch, f"gemm {dtype} {role} {d_in}x{d_out}", got,
                      want, CNN_GEMM_RTOL_OF_MAX, product)
    repeat = {}
    if (role, d_in, d_out) in GEMM_REPEAT and batch == CNN_BATCH:
        again = gemm(*args, **kw)
        if not torch.equal(got, again):
            raise AssertionError(f"gemm {dtype} {role} {d_in}x{d_out}: two "
                                 f"runs differ by "
                                 f"{(got.float() - again.float()).abs().max().item()}")
        repeat = {"bitwise_repeat": True}
    nbytes = got.element_size() * (m * k + k * n + m * n
                                   + (n if "bias" in kw else 0))
    bound_ms, bound_by = bound(nbytes, 2 * m * n * k, PEAK[dtype])
    return {"kernel": "gemm", "dtype": dtype, "role": role, "batch": rows,
            "M": m, "N": n, "K": k, **errs, **repeat,
            "ms": median_ms(torch, lambda: gemm(*args, **kw), reps),
            "plain_ms": median_ms(torch, lambda: gemm_plain(*args, **kw),
                                  reps),
            "library_ms": median_ms(torch, library, reps),
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
                     cout: int, gen, dtype: str,
                     batch: int = CNN_BATCH) -> dict:
    """K4 in reference_cnn's step at `batch` images: a k3 s2 p1 forward,
    or (K4') the input gradient of one, a stride-1 conv over the
    undilated cotangent with lhs dilation 2 and flipped, in/out-swapped
    weights."""
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
        x = torch.rand(batch, h, w, cin, generator=gen).to(dev).to(tdt)
        kw = dict(stride=2, pads=(1, 1, 1, 1))
        x_nchw = x.permute(0, 3, 1, 2)
        library = lambda: F.conv2d(x_nchw, w_oihw, stride=2, padding=1)  # noqa: E731
        (n_in, c, o, hin, win, hout, wout) = (batch, cin, cout, h, w, oh, ow)
        taps = (valid_taps(h, oh, 3, 2, 1) * valid_taps(w, ow, 3, 2, 1))
    else:
        x = torch.randn(batch, oh, ow, cout, generator=gen).to(dev).to(tdt)
        kw = dict(stride=1, pads=conv_input_grad_pads(h, w, 3, 3, 2, 1, oh, ow),
                  dil=2, flip=True)
        x_nchw = x.permute(0, 3, 1, 2)
        library = lambda: F.conv_transpose2d(  # noqa: E731
            x_nchw, w_oihw, stride=2, padding=1,
            output_padding=(h + 1) % 2)
        (n_in, c, o, hin, win, hout, wout) = (batch, cout, cin, oh, ow, h, w)
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
                           dil: int, flip: bool, gen, dtype: str,
                           reps: int = 30) -> dict:
    """K4 at a geometry of its own (CONV_EXTRA's, the cnn_mesh phase's)
    against its plain version, with the other K4 rows' tolerances and
    bound. Yardstick: for K4' the forward's transposed conv
    (F.conv_transpose2d at stride dil, channels-last); for a forward with
    even pads F.conv2d; none for one with one-sided pads, which no
    single PyTorch call computes."""
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
    x_nchw = x.permute(0, 3, 1, 2)
    w_oihw = wt.permute(3, 2, 0, 1)
    if flip:
        # the forward conv: k, stride dil, padding k - 1 - pads[0]; the
        # far-side rows it never read come back as output padding
        fwd_pad = k - 1 - pads[0]
        extra = oh - ((h - 1) * dil - 2 * fwd_pad + k)

        def library():
            return F.conv_transpose2d(x_nchw, w_oihw, stride=dil,
                                      padding=fwd_pad, output_padding=extra)
    elif len(set(pads)) == 1 and dil == 1:
        def library():
            return F.conv2d(x_nchw, w_oihw, stride=stride, padding=pads[0])
    else:
        library = None
    if library is not None:
        if tuple(library().shape) != (n, o, oh, ow):
            raise AssertionError(f"library shape {tuple(library().shape)}")
        library_ms = median_ms(torch, library, reps)
    taps = (valid_taps(h, oh, k, stride, pads[0], dil)
            * valid_taps(w, ow, k, stride, pads[2], dil))
    nbytes = got.element_size() * (x.numel() + wt.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n * taps * c * o, PEAK[dtype])
    return {"kernel": "conv_direct", "dtype": dtype, "role": role, "N": n,
            "H": h, "W": w, "C": c, "O": o, "OH": oh, "OW": ow, "k": k,
            "stride": stride, "pads": list(pads), "dil": dil, "flip": flip,
            **errs,
            "ms": median_ms(torch, lambda: conv_direct(x, wt, **kw), reps),
            "plain_ms": median_ms(torch,
                                  lambda: conv_direct_plain(x, wt, **kw), reps),
            "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def conv_dw_case(torch, dev, n: int, h: int, w: int, cin: int, cout: int,
                 stride: int, pad: int, gen, dtype: str, k: int = 3,
                 reps: int = 30) -> dict:
    """K5, the weight gradient of a k x k conv x (n, h, w, cin) -> g (n,
    oh, ow, cout) at the given stride and padding; at DW_REPEAT's shapes
    run twice, the two results held equal bit for bit."""
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import conv_dw, conv_dw_plain

    tdt = getattr(torch, dtype)
    oh, ow = (h + 2 * pad - k) // stride + 1, (w + 2 * pad - k) // stride + 1
    x = torch.rand(n, h, w, cin, generator=gen).to(dev).to(tdt)
    g = torch.randn(n, oh, ow, cout, generator=gen).to(dev).to(tdt)
    kw = dict(stride=stride, padding=pad, kh=k, kw=k)
    got = conv_dw(x, g, **kw)
    want = conv_dw_plain(x, g, **kw)
    errs = check_case(torch, f"conv_dw {dtype} {n}x{h}x{w}x{cin}->{cout} "
                      f"s{stride}", got, want, CONV_DW_RTOL_OF_MAX)
    repeat = {}
    if (n, h, w, cin, cout, stride, pad) in DW_REPEAT and k == 3:
        again = conv_dw(x, g, **kw)
        if not torch.equal(got, again):
            raise AssertionError(f"conv_dw {dtype} {n}x{h}x{w}x{cin}->{cout}: "
                                 f"two runs differ by "
                                 f"{(got.float() - again.float()).abs().max().item()}")
        repeat = {"bitwise_repeat": True}
    x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
    taps = (valid_taps(h, oh, k, stride, pad) * valid_taps(w, ow, k, stride, pad))
    nbytes = got.element_size() * (x.numel() + g.numel() + got.numel())
    bound_ms, bound_by = bound(nbytes, 2 * n * taps * cin * cout, PEAK[dtype])
    return {"kernel": "conv_dw", "dtype": dtype, "role": "weight_grad",
            "N": n, "H": h, "W": w, "C": cin, "O": cout, "OH": oh, "OW": ow,
            "k": k, "stride": stride, **errs, **repeat,
            "ms": median_ms(torch, lambda: conv_dw(x, g, **kw), reps),
            "plain_ms": median_ms(torch, lambda: conv_dw_plain(x, g, **kw),
                                  reps),
            "library_ms": median_ms(torch, lambda: torch.nn.grad.conv2d_weight(
                x_nchw, (cout, cin, k, k), g_nchw, stride=stride,
                padding=pad), reps),
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


def sdpa_ms(torch, q, k, v, g, causal: bool = True, reps: int = 30) -> dict:
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
        fwd_ms = median_ms(torch, fwd, reps)
    return {"library_fwd_ms": fwd_ms,
            "library_fwd_bwd_ms": median_ms(torch, fwd_bwd, reps),
            "library_bwd_ms": median_ms(torch, bwd, reps)}


def flash_cases(torch, dev, dtype: str, b: int, s: int, h: int, hkv: int,
                d: int, gen, causal: bool = True,
                f32_out: bool = False, reps: int = 30,
                library: bool = True) -> list[dict]:
    """K7, K8 and K9 on one attention shape (q (B, S, H, D), k/v (B, S,
    Hkv, D)), each against its plain version on the same inputs; the
    backward kernels take the plain forward's o and lse and a random
    cotangent. float32 K7/K8/K9 outputs are also held to
    FLASH_F32_REL_L2, and at FLASH_REPEAT's shapes run twice and held
    equal bit for bit. `f32_out` (bf16 inputs): K7 with `out_f32` and
    K8/K9 with `grads_f32`, float32 outputs held to the bf16 bands
    against the plain versions' unrounded ones, and unrounded themselves
    (F32_OUT_UNROUNDED_MIN; the rounded copy's relative L2 to the plain
    output is kept beside the kernel's).
    Bound: the pairs (causal: S (S + 1) / 2, else S^2) per (batch, query
    head) times 2 D flops for each of the kernel's products (K7: q k^T and
    p v; K8: also dO v^T and ds k, less p v; K9: q k^T, dO v^T, p^T dO and
    ds^T q), at the input type's peak (float32: three tf32 products
    each at the TF32 peak, `bound_by` "operations (3xTF32)", with the FMA
    figure beside it as `bound_fma_ms`); or each input read once and each
    output written once at the HBM rate, if that is longer. `library`
    False leaves SDPA's times out (None)."""
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
    f32 = dict(out_f32=f32_out)
    g32 = dict(grads_f32=f32_out)
    oel = 4 if f32_out else el      # the outputs' element size
    runs = {
        "flash_fwd": (lambda: fa.flash_forward(q, k, v, causal, **f32),
                      lambda: fa.flash_forward_plain(q, k, v, causal, **f32),
                      2, el * (rows_q + 2 * rows_kv) + oel * rows_q + rows),
        "flash_bwd_dq": (lambda: fa.flash_bwd_dq(q, k, v, g, lse, dvec, causal,
                                                 **g32),
                         lambda: fa.flash_bwd_dq_plain(q, k, v, g, lse, dvec,
                                                       causal, **g32), 3,
                         el * (2 * rows_q + 2 * rows_kv) + oel * rows_q
                         + 2 * rows),
        "flash_bwd_dkv": (lambda: fa.flash_bwd_dkv(q, k, v, g, lse, dvec,
                                                   causal, **g32),
                          lambda: fa.flash_bwd_dkv_plain(q, k, v, g, lse,
                                                         dvec, causal, **g32),
                          4, el * (2 * rows_q + 2 * rows_kv)
                          + oel * 2 * rows_kv + 2 * rows)}
    lib = (sdpa_ms(torch, q, k, v, g, causal, reps) if library else
           dict.fromkeys(("library_fwd_ms", "library_fwd_bwd_ms",
                          "library_bwd_ms")))
    pairs = s * (s + 1) // 2 if causal else s * s
    out = []
    for name, (run, plain, products, nbytes) in runs.items():
        tf32x3 = dtype == "float32" and name in TF32X3_KERNELS
        got, want = run(), plain()
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        err = tol = 0.0
        rel = None
        unrounded = {}
        what = f"{name} {dtype} B={b} S={s} H={h} Hkv={hkv} D={d} causal={causal}"
        for i, (a, w) in enumerate(zip(got, want)):
            lse_out = name == "flash_fwd" and i == 1
            if a.dtype != w.dtype or (f32_out and a.dtype != torch.float32):
                raise AssertionError(f"{what} output {i}: {a.dtype}, plain "
                                     f"{w.dtype}")
            # lse is float32 arithmetic on either input type; f32_out's
            # float32 outputs come from bf16 operands
            band = (dtype if f32_out and not lse_out else
                    "float32" if a.dtype == torch.float32 else dtype)
            rtol = FLASH_RTOL_OF_MAX[band]
            e, t = _check_err(f"{what} output {i}", a.float(), w.float(), rtol)
            err, tol = max(err, e), max(tol, t)
            if f32_out and not lse_out:
                rounded = a.to(torch.bfloat16).float()
                share = (a != rounded).float().mean().item()
                if not share >= F32_OUT_UNROUNDED_MIN:
                    raise AssertionError(
                        f"{what} output {i}: only {share} of the float32 "
                        f"output differs from its bf16 rounding (want >= "
                        f"{F32_OUT_UNROUNDED_MIN})")
                unrounded = {
                    "unrounded_share_min": min(
                        share, unrounded.get("unrounded_share_min", 1.0)),
                    "unrounded_share_limit": F32_OUT_UNROUNDED_MIN,
                    "rounded_rel_l2_err": max(
                        rel_l2(rounded, w.float(),
                               per_row=FLASH_BF16_REL_L2[name][0] == "row"),
                        unrounded.get("rounded_rel_l2_err", 0.0))}
            if band == "bfloat16":
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
                    **({"f32_out": True} if f32_out else {}),
                    "max_abs_err": err, "tolerance": tol, **(rel or {}),
                    **unrounded, **repeat,
                    "ms": median_ms(torch, run, reps),
                    "plain_ms": median_ms(torch, plain, reps),
                    "library_ms": (lib["library_fwd_ms"]
                                   if name == "flash_fwd" else None),
                    **lib, "flops": flops, "bound_ms": bound_ms,
                    "bound_by": bound_by, **fma})
    return out


def phase_flash_kernels(torch, dev, gen) -> list[dict]:
    cases = []
    mesh = [s for s in lm_mesh_shapes()
            if s[:-1] not in FLASH_RANK_SHAPES or not s[-1]]
    for *shape, causal, f32_out in (
            [(*s, True, False) for s in FLASH_SHAPES]
            + [(*s, False) for s in FLASH_EXTRA_SHAPES + FLASH_D16_SHAPES]
            + [(*s, True, False) for s in FLASH_RANK_SHAPES]
            + [(*s, f32_out) for s in FLASH_F32_OUT_SHAPES
               for f32_out in (False, True)]
            + [(*s, False) for s in mesh]
            + [(*s, False) for s in FLASH_HEAD_DIM_SHAPES]
            + [(*s, True, False) for s in FLASH_HEAD_DIM_TIMED]):
        # the flagship's, the GQA shape's and the head dims' flagship
        # geometry's times at 30 calls, the others' (held to the same
        # tolerances) at HEAD_DIM_CASE_REPS or MESH_CASE_REPS
        timed = tuple(shape) in FLASH_SHAPES + FLASH_HEAD_DIM_TIMED
        reps = (30 if timed else HEAD_DIM_CASE_REPS
                if (*shape, causal) in FLASH_HEAD_DIM_SHAPES
                else MESH_CASE_REPS)
        # SDPA's times beside the timed shapes only (the others are
        # correctness cases, and the script has a time limit)
        for case in flash_cases(torch, dev, *shape, gen, causal, f32_out,
                                reps, timed):
            if (*shape, causal) in mesh:
                case["lm_mesh"] = True
            if ((*shape, causal) in FLASH_HEAD_DIM_SHAPES
                    or tuple(shape) in FLASH_HEAD_DIM_TIMED):
                case["head_dims"] = True
            if (tuple(shape) in FLASH_RANK_SHAPES
                    or (*shape, causal) in FLASH_F32_OUT_SHAPES
                    or case.get("lm_mesh")):
                case["per_rank"] = True
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
    for n, din, dout in ([(n, *s) for n in (8, 32) for s in GEMM_SHAPES]
                         + GEMM_RAGGED):
        cases.append(gemm_case(torch, dev, n, din, dout, gen))
        emit({"phase": "kernel_case", **cases[-1]})
    # generate's products (N 1 and the lookup block's N 8), and the MoE
    # engine's MHA pages (8 kv heads, int8) of the generate phase.
    for n, din, dout in [(n, *s) for n in (1, GEN_LOOKUP_K)
                         for s in GEMM_GENERATE]:
        cases.append({**gemm_case(torch, dev, n, din, dout, gen),
                      "generate": True})
        emit({"phase": "kernel_case", **cases[-1]})
    for b, kk in ((args.slots, 1), (1, args.prefill_chunk)):
        cases.append({**attention_case(torch, dev, "int8", b, kk, gen,
                                       pages=width, last_range=(
                                           GEN_SERVE["prompt_min"],
                                           GEN_SERVE["prompt_max"]
                                           + GEN_SERVE["out_max"]),
                                       kv_heads=HEADS), "generate": True})
        emit({"phase": "kernel_case", **cases[-1]})
    cases.extend(features_kernel_cases(torch, dev, gen, args))
    cases.extend(phase_cnn_kernels(torch, dev, gen))
    return cases


def features_kernel_cases(torch, dev, gen, args) -> list[dict]:
    """K1 and K2 at the serve_features phase's shapes (marked `features`):
    K1 int8 at the verify block (slots x FEATURES_SPEC_K rows) and at a
    decode tick whose slots 0 and 1 share their first pages, on the
    engine's table width (pages_for(prompt_max + out_max)) at the
    bench's positions; K2 at the verify block's N (slots x
    FEATURES_SPEC_K) on the five serving products; the draft model's K1
    (its catch-up chunk and proposal step, head dim DRAFT_DIM / HEADS)
    and K2 (its products at a step's N and at the catch-up chunk's and
    window forward's N)."""
    from mpi_cuda_cnn_tpu_torch.serve.pool import pages_for

    width = pages_for(args.prompt_max + args.out_max, args.page_size)
    span = (args.prompt_min, args.prompt_max + args.out_max)
    draft_hd = DRAFT_DIM // args.heads
    chunk_rows = args.slots * args.prefill_chunk
    specs = [
        ("verify", lambda: attention_case(
            torch, dev, "int8", args.slots, FEATURES_SPEC_K, gen,
            pages=width, last_range=span)),
        ("alias", lambda: attention_case(
            torch, dev, "int8", args.slots, 1, gen, pages=width,
            last_range=span, alias=width // 2)),
        ("draft", lambda: attention_case(
            torch, dev, "int8", args.slots, args.prefill_chunk, gen,
            pages=width, last_range=span, head_dim=draft_hd)),
        ("draft", lambda: attention_case(
            torch, dev, "int8", args.slots, 1, gen, pages=width,
            last_range=span, head_dim=draft_hd)),
    ]
    specs += [("verify", lambda s=s: gemm_case(
        torch, dev, args.slots * FEATURES_SPEC_K, *s, gen))
        for s in GEMM_SHAPES]
    specs += [("draft", lambda n=n, s=s: gemm_case(torch, dev, n, *s, gen))
              for n in (args.slots, chunk_rows) for s in GEMM_DRAFT]
    cases = []
    for what, case in specs:
        cases.append({**case(), "features": what})
        emit({"phase": "kernel_case", **cases[-1]})
    return cases


def mesh_kernel_calls() -> list[tuple]:
    """The distinct K3/K4/K4'/K5 calls of CNN_MESH_RUNS and
    CNN_MESH_EPOCHS, as (case function, its arguments, the model,
    n_model, then K3's rows or K5's kernel size): for each run the
    step's rows CNN_BATCH / (n_data M), the eval batch's rows over
    n_data M, and the whole agree test set's over M (its logits).
    A conv launches K4 forward, K4' for its input gradient unless it is
    the first layer, and K5; a dense layer K3's forward, input and
    weight gradients; an eval only the forwards."""
    from mpi_cuda_cnn_tpu_torch.models.layers import Conv, Dense
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.ops.kernel_ops import conv_input_grad_pads
    from mpi_cuda_cnn_tpu_torch.parallel.pp import make_pipeline_plan

    done = {("reference_cnn", 1, r, True)
            for r in (CNN_BATCH, RANK_BATCH, CNN_BATCH // FLAGS_ACCUM,
                      CNN_BATCH // FLAGS_ELASTIC)}
    done.add(("reference_cnn", 1, EVAL_BATCH, False))
    wanted = []
    for runs, test in ((CNN_MESH_RUNS, CNN_MESH_AGREE_TEST),
                       (CNN_MESH_EPOCHS, 10_000)):
        for name, mesh, flags in runs:
            axes = {a: int(n) for a, n in
                    (p.split(":") for p in mesh.split(","))}
            n_data, n_model = axes.get("data", 1), axes.get("model", 1)
            n_pipe = axes.get("pipe", 1)
            m = (flags.get("num_microbatches") or n_pipe) if n_pipe > 1 else 1
            share = n_data * m
            batch = min(EVAL_BATCH, test)
            batch -= batch % share
            rows = [(CNN_BATCH // share, True), (batch // share, False)]
            if test == CNN_MESH_AGREE_TEST:
                rows.append((test // m, False))
            wanted += [(name, n_model, r, step) for r, step in rows]
    calls = []
    for key in dict.fromkeys(wanted):
        if key in done:
            continue
        done.add(key)
        name, n_model, rows, step = key
        model = get_model(name)
        plan = make_pipeline_plan(model, 1, n_model=n_model)
        shapes = plan.layer_in_shapes + ((plan.num_classes,),)
        for i, layer in enumerate(model.layers):
            (shape, out), sliced = shapes[i:i + 2], plan.layer_sliced[i]
            if isinstance(layer, Conv):
                (h, w, cin), (oh, ow, f) = shape, out
                f //= n_model if sliced else 1
                k, st, pad = layer.kernel, layer.stride, layer.padding
                calls.append((conv_direct_extra_case, (
                    "forward", rows, h, w, cin, f, k, st, (pad,) * 4, 1,
                    False), name, n_model))
                if step and i > 0:
                    calls.append((conv_direct_extra_case, (
                        "input_grad", rows, oh, ow, f, cin, k, 1,
                        conv_input_grad_pads(h, w, k, k, st, pad, oh, ow),
                        st, True), name, n_model))
                if step:
                    calls.append((conv_dw_case, (rows, h, w, cin, f, st,
                                                 pad), name, n_model, k))
            elif isinstance(layer, Dense):
                d_in, f = math.prod(shape), out[-1]
                f //= n_model if sliced else 1
                roles = ["forward"] + (["input_grad"] if i > 0 else [])
                for role in roles + ["weight_grad"] if step else ["forward"]:
                    calls.append((cnn_gemm_case, (role, d_in, f), name,
                                  n_model, rows))
    return calls


def mesh_kernel_cases(torch, dev, gen):
    """K3, K4, K4' and K5 at the cnn_mesh phase's shapes
    (`mesh_kernel_calls`), in float32: yields (and prints) one
    kernel_case each, marked `mesh` with the model and n_model."""
    for fn, args, name, n_model, *extra in mesh_kernel_calls():
        kw = {"reps": MESH_CASE_REPS}
        if fn is cnn_gemm_case:
            kw["batch"] = extra[0]
        elif fn is conv_dw_case:
            kw["k"] = extra[0]
        case = fn(torch, dev, *args, gen, "float32", **kw)
        case = {**case, "mesh": {"model": name, "n_model": n_model}}
        emit({"phase": "kernel_case", **case})
        yield case


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
    # One rank's shapes of the dp phase's world-2 step, in float32: K3 at
    # M 16 (fc1-fc3 forward, input and weight gradient), K4 and K4' at
    # both convs' forward and conv2's input gradient, K5 at both convs.
    runs = [(cnn_gemm_case, (role, d_in, d_out), {"batch": RANK_BATCH})
            for role in ("forward", "input_grad", "weight_grad")
            for d_in, d_out in FC_SHAPES]
    runs += [(conv_direct_case, ("forward", *shape), {"batch": RANK_BATCH})
             for shape in CONV_SHAPES]
    runs.append((conv_direct_case, ("input_grad", *CONV_SHAPES[1]),
                 {"batch": RANK_BATCH}))
    runs += [(conv_dw_case, (RANK_BATCH, h, w, cin, cout, 2, 1), {})
             for (h, w, cin, cout) in CONV_SHAPES]
    for fn, args, kw in runs:
        case = {**fn(torch, dev, *args, gen, "float32", **kw),
                "per_rank": True}
        emit({"phase": "kernel_case", **case})
        yield case
    yield from mesh_kernel_cases(torch, dev, gen)
    # The micro-batches of train_flags, in float32: --grad-accum 4 (M 8)
    # and --elastic-width 8 (M 4), at the same products and convs.
    for micro in (CNN_BATCH // FLAGS_ACCUM, CNN_BATCH // FLAGS_ELASTIC):
        runs = [(cnn_gemm_case, (role, d_in, d_out), {"batch": micro})
                for role in ("forward", "input_grad", "weight_grad")
                for d_in, d_out in FC_SHAPES]
        runs += [(conv_direct_case, ("forward", *shape), {"batch": micro})
                 for shape in CONV_SHAPES]
        runs.append((conv_direct_case, ("input_grad", *CONV_SHAPES[1]),
                     {"batch": micro}))
        runs += [(conv_dw_case, (micro, h, w, cin, cout, 2, 1), {})
                 for (h, w, cin, cout) in CONV_SHAPES]
        for fn, args, kw in runs:
            case = {**fn(torch, dev, *args, gen, "float32", **kw),
                    "micro": micro}
            emit({"phase": "kernel_case", **case})
            yield case


def last_logits(torch, engine, ctx, quant=None) -> "torch.Tensor":
    """Logits after `ctx` (a 1-d token array) through `engine`'s model,
    weights, cache dtype and attention read, prefilled chunk by chunk
    into a fresh single-slot paged cache (its int8 pages written through
    `quant`, if given)."""
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
    if quant is not None:
        cache.quant = quant
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


def agree_requests(torch, eng, plain, served: list, replay: list) -> dict:
    """Requests served by `eng` (kernels) against the same requests
    replayed by `plain` (plain versions): equal tokens, or at the first
    difference a tie: the plain path's top-2 logit gap there below
    TIE_GAP, or, for an MoE model, a routing tie (`moe_tie`)."""
    import numpy as np

    served = {r.rid: r for r in served}
    compared = equal = 0
    diverged = []
    for r in replay:
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
        if gap > TIE_GAP and eng.model.moe_experts:
            diverged[-1]["moe_tie"] = moe_tie(torch, eng, plain, ctx,
                                              k_out[t])
        elif gap > TIE_GAP:
            raise AssertionError(f"request {r.rid} step {t}: kernel path "
                                 f"chose {k_out[t]}, plain {r.out[t]}, top-2 "
                                 f"gap {gap} > {TIE_GAP}")
    return {"requests": len(replay), "tokens_compared": compared,
            "tokens_equal": equal, "diverged": diverged,
            "tie_gap": TIE_GAP}


def kv_code_spy(force: list | None = None):
    """A quantizer for the int8 page write (`PagedKVCache.quant`) of one
    forward, with its record. Without `force`: `_quant_kv`, each call's
    codes and scales kept. With `force` (another forward's record): each
    call writes the forced codes and scales instead of its own and keeps
    how far they are apart: the codes that differ (by one step at most,
    else AssertionError), the codes written, the largest distance, in
    code steps, of a differing code's unrounded value from the edge
    between the two codes, and the scales' largest relative gap."""
    from mpi_cuda_cnn_tpu_torch.models.generate import _quant_kv

    rec = []

    def quant(x):
        q, sc = _quant_kv(x)
        if force is None:
            rec.append((q, sc))
            return q, sc
        fq, fsc = force[len(rec)]
        gap = q.int() - fq.int()
        step = int(gap.abs().max())
        if step > 1:
            raise AssertionError(f"MoE engine: int8 codes {step} steps "
                                 "apart between the two paths")
        differ = gap != 0
        # the value _quant_kv rounds, against the edge between the codes
        edge = (x.float() / sc - (q.float() + fq.float()) / 2).abs()
        rec.append({"differ": int(differ.sum()), "codes": q.numel(),
                    "edge_max": float(edge[differ].max()) if differ.any()
                    else 0.0,
                    "scale_rel_gap": float(((sc - fsc).abs() / fsc).max())})
        return fq, fsc

    return quant, rec


def moe_tie(torch, eng, plain, ctx, token: int) -> dict:
    """An MoE engine's choice of `token` after `ctx` where its plain twin
    chose another, explained as lm_moe (b) explains flash against the
    oracle. Two steps of the engines' forward are not continuous: the
    router's top-k, and the int8 page write's rounding. A router choice
    on a tie (two probabilities within MOE_ROUTE_TIE) turns the residual
    stream and every later choice; a value within float rounding of a
    code's edge is written one code step apart, which moves the router's
    probabilities by more than float rounding. So the plain forward of
    `ctx` writes the kernel path's codes (`kv_code_spy`) and is routed by
    the kernel path's choices (`moe_route_spy`), which must differ from
    its own only at ties (`routing_ties`); its own codes may differ from
    the kernel path's only by one step, at values within
    MOE_CODE_EDGE_TOL steps of the edge between the two codes, on at
    most MOE_CODE_EDGE_MAX_SHARE of the codes written, under scales
    within MOE_CODE_EDGE_TOL / 127 of each other; its logits must then
    pick `token` or tie within TIE_GAP. Raises AssertionError
    otherwise."""
    from mpi_cuda_cnn_tpu_torch.parallel import moe

    rec, undo = moe_route_spy(moe)
    kv_quant, kv = kv_code_spy()
    try:
        last_logits(torch, eng, ctx, quant=kv_quant)
    finally:
        undo()
    own, undo = moe_route_spy(moe, force=rec["idx"])
    forced_quant, codes = kv_code_spy(force=kv)
    try:
        lf = last_logits(torch, plain, ctx, quant=forced_quant)
    finally:
        undo()
    differ = sum(c["differ"] for c in codes)
    share = differ / max(1, sum(c["codes"] for c in codes))
    edge = max((c["edge_max"] for c in codes), default=0.0)
    scale_gap = max((c["scale_rel_gap"] for c in codes), default=0.0)
    if not (share <= MOE_CODE_EDGE_MAX_SHARE and edge <= MOE_CODE_EDGE_TOL
            and scale_gap <= MOE_CODE_EDGE_TOL / 127):
        raise AssertionError(
            f"MoE engine: {differ} int8 codes ({share} of those written, "
            f"limit {MOE_CODE_EDGE_MAX_SHARE}) differ between the two "
            f"paths, the farthest {edge} code steps from its edge (limit "
            f"{MOE_CODE_EDGE_TOL}), scales {scale_gap} apart (limit "
            f"{MOE_CODE_EDGE_TOL / 127})")
    ties = routing_ties(own, rec["idx"])
    top2 = torch.topk(lf, 2)
    gap = float(top2.values[0] - top2.values[1])
    if int(top2.indices[0]) != token and gap > TIE_GAP:
        raise AssertionError(f"MoE engine: routed and written as the kernel "
                             f"path, the plain path chose "
                             f"{int(top2.indices[0])}, the kernel path "
                             f"{token}, top-2 gap {gap} > {TIE_GAP}")
    return {**ties, "routed_top2_gap": gap,
            "routed_choice": int(top2.indices[0]),
            "codes_one_step_apart_calls": sum(c["differ"] > 0
                                              for c in codes),
            "codes_one_step_apart": differ, "codes_one_step_apart_share": share,
            "code_edge_distance_max": edge, "scale_rel_gap_max": scale_gap}


def plain_engine(eng):
    """`eng`'s twin on the plain versions: the gather read and the
    dequantized float32 weights."""
    from mpi_cuda_cnn_tpu_torch.ops.gemv import dequantize_decode_params
    from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine

    return PagedEngine(
        eng.model, dequantize_decode_params(eng.params), slots=eng.slots,
        num_pages=eng.num_pages, page_size=eng.page_size,
        prefill_chunk=eng.prefill_chunk, cache_dtype=eng.cache_dtype,
        max_len=eng.max_len, attn_kernel="gather", weights_dtype="float32",
        device=eng.device)


def phase_agree(torch, out) -> dict:
    """Replays the first requests through the plain versions on the card
    (gather read, dequantized float32 weights) and compares tokens."""
    from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload

    eng, args = out["engine"], out["args"]
    reqs = make_workload(n=args.requests, vocab=args.vocab,
                         prompt_min=args.prompt_min,
                         prompt_max=args.prompt_max, out_min=args.out_min,
                         out_max=args.out_max, rate=0.0,
                         seed=args.seed)[:AGREE_REQUESTS]
    plain = plain_engine(eng)
    replay = plain.run(reqs, mode="continuous")
    return agree_requests(torch, eng, plain,
                          out["results"]["continuous"].requests,
                          replay.requests)


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


def phase_serve_features(torch) -> dict:
    """The single engine's serving features through serve-bench at the
    serve phase's flagship (FEATURES_ARGS: template traffic, one seed,
    one draw of the weights for every run): FEATURES_RUNS, each with the
    launch counts zeroed just before and read just after. Every request
    finishes; its tokens equal the baseline run's or tie at the first
    difference (`agree_requests`, the baseline engine's top-2 gap); the
    measured run's K1 launches are depth x target forwards + the draft's
    depth x its paged forwards, K2's (5 depth + 1) x target forwards +
    (5 draft depth + 1) x draft forwards (target forwards: decode ticks,
    verify rounds and prefill chunks); prefix hits and COW copies, lookup
    acceptance in fewer rounds than the spec-off run's ticks, spills,
    readmits and one refusal for the one corrupted spill, and the SLO
    run's JSONL valid with its alerts line. Returns the phase's record and
    the launches per kernel over every run (warm-ups included)."""
    import tempfile

    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records, validate_record
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import SERVE_KERNELS, serve_bench

    t_phase = time.perf_counter()
    params = draft_params = base = None
    runs = {}
    total = {k: 0 for k in SERVE_KERNELS}
    with tempfile.TemporaryDirectory(prefix="features-") as tmp:
        Path(tmp, "slo.json").write_text(json.dumps(FEATURES_SLO))
        for name, flags in FEATURES_RUNS:
            argv = FEATURES_ARGS + [a.replace("{tmp}", tmp) for a in flags]
            _kernels.reset_launches()
            t0 = time.perf_counter()
            out = serve_bench(argv, params=params, draft_params=draft_params)
            eng = out["engine"]
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            for k in SERVE_KERNELS:
                total[k] += _kernels.launches[k]
            params = out["params"]
            draft_params = out["draft_params"] or draft_params
            line, res = out["lines"][0], out["results"]["continuous"]
            args, model = out["args"], out["model"]
            if line["statuses"] != {"finished": args.requests}:
                raise AssertionError(f"serve_features {name}: statuses "
                                     f"{line['statuses']}")
            forwards = line["decode_ticks"] + line["prefill_chunks"]
            dfw = line["draft_forwards"]
            paged_draft = args.spec == "draft" and args.draft_cache == "paged"
            want = {"paged_attention": model.depth * forwards
                    + (DRAFT_DEPTH * dfw if paged_draft else 0),
                    "int8_gemm": (5 * model.depth + 1) * forwards
                    + (5 * DRAFT_DEPTH + 1) * dfw}
            if eng.device.type != "cuda":
                want = {k: 0 for k in want}
            if line["kernel_launches"] != want:
                raise AssertionError(
                    f"serve_features {name}: launches "
                    f"{line['kernel_launches']}, want {want} ({forwards} "
                    f"target forwards, {dfw} draft forwards)")
            rec = {"wall_s": wall_s, "duration_s": line["duration_s"],
                   "tokens_per_s": line["tokens_per_s"],
                   "decode_ticks": line["decode_ticks"],
                   "prefill_chunks": line["prefill_chunks"],
                   "draft_forwards": dfw,
                   "ms_per_forward": 1e3 * line["duration_s"] / forwards,
                   "tokens_per_round": ((line["output_tokens"]
                                         - args.requests)
                                        / max(line["decode_ticks"], 1)),
                   "ttft_p50_ms": line["ttft_p50_ms"],
                   "tpot_p50_ms": line["tpot_p50_ms"],
                   "preemptions": line["preemptions"],
                   "kernel_launches": line["kernel_launches"],
                   **{k: line[k] for k in line
                      if k.startswith(("prefix_", "tier_", "spec_"))}}
            if line["spec_rounds"]:
                rec["mean_accepted"] = (line["spec_accepted"]
                                        / line["spec_rounds"])
            if base is None:
                base = (eng, res)
            else:
                rec["agree"] = agree_requests(torch, eng, base[0],
                                              res.requests, base[1].requests)
            runs[name] = rec
            emit({"phase": "serve_features_run", "run": name, **rec})
            if name == "slo":
                records = load_records(Path(tmp, "features.jsonl"),
                                       strict=True)
                for r in records:
                    validate_record(r)
                events = {r["event"] for r in records}
                if not {"tick", "request", "metrics", "serve",
                        "fault"} <= events:
                    raise AssertionError(f"serve_features slo: JSONL events "
                                         f"{sorted(events)}")
                if out["alerts"] is None or not any(
                        e["kind"] == "injected_squeeze" for e in res.events):
                    raise AssertionError("serve_features slo: no alerts line "
                                         "or no squeeze fired")
                rec["jsonl_records"] = len(records)
                rec["alerts"] = out["alerts"]
                keep(Path(tmp, "features.jsonl"), "serve_slo.jsonl")
                keep(Path(tmp, "slo.json"), "serve_slo.json")
            del out, eng, res
    p, lk, sp = runs["prefix"], runs["lookup"], runs["spill"]
    checks = {
        "prefix_hits": p["prefix_hits"] > 0 and p["prefix_cow"] > 0,
        "lookup_accepts": lk["spec_accepted"] > 0,
        "lookup_fewer_rounds": lk["decode_ticks"] < p["decode_ticks"],
        "draft_forwards": all(runs[n]["draft_forwards"] > 0
                              for n in ("draft_paged", "draft_window")),
        "tier": (sp["tier_spills"] > 0 and sp["tier_readmits"] > 0
                 and sp["tier_refusals"] == 1),
    }
    if not all(checks.values()):
        raise AssertionError(f"serve_features: checks {checks}; runs {runs}")
    phase_s = time.perf_counter() - t_phase
    if phase_s > FEATURES_BUDGET_S:
        raise AssertionError(f"serve_features took {phase_s:.1f} s, over its "
                             f"{FEATURES_BUDGET_S} s budget")
    return {"record": {"requests": FEATURES_REQUESTS, "phase_s": phase_s,
                       "checks": checks, "runs": runs},
            "launches": total}


def phase_fleet(torch) -> dict:
    """The serving fleet through fleet-bench --compute engine at the serve
    flagship (FLEET_ARGS, one draw of the weights for every run):
    FLEET_RUNS, each with the launch counts zeroed just before and read
    just after. Every request finishes; its tokens equal the baseline
    run's or tie at the first difference (`agree_requests`); every
    request holds exactly its budget of tokens (none generated twice);
    the crash run re-dispatches, the pooled run hands off, the transport
    run's trace_crc is the baseline's; K1 launches are depth x the
    forwards every incarnation's engine ran (decode ticks and prefill
    chunks, zombies and crashed incarnations included), K2's (5 depth +
    1) x the same. Returns the phase's record and the launches per kernel
    over every run."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import SERVE_KERNELS, fleet_bench

    t_phase = time.perf_counter()
    params = base = None
    runs = {}
    total = {k: 0 for k in SERVE_KERNELS}
    for name, flags in FLEET_RUNS:
        if name == "crash" and KEEP is not None:   # obs_tools reads it
            flags = flags + ["--log", "full", "--metrics-jsonl",
                             str(KEEP / "fleet.jsonl")]
        _kernels.reset_launches()
        t0 = time.perf_counter()
        out = fleet_bench(FLEET_ARGS + flags, params=params)
        wall_s = time.perf_counter() - t0
        launches = {k: _kernels.launches[k] for k in SERVE_KERNELS}
        for k in SERVE_KERNELS:
            total[k] += launches[k]
        params = out["params"]
        line, metric, res = out["lines"][0], out["lines"][1], out["result"]
        args, model = out["args"], out["model"]
        engines = [c.engine for c in out["computes"]]
        if line["statuses"] != {"finished": args.requests}:
            raise AssertionError(f"fleet {name}: statuses {line['statuses']}")
        for r in res.requests:
            if len(r.out) != r.max_new_tokens or not all(
                    0 <= t < args.vocab for t in r.out):
                raise AssertionError(f"fleet {name}: request {r.rid} holds "
                                     f"{len(r.out)} tokens, budget "
                                     f"{r.max_new_tokens}")
        fw = line["forwards"]
        forwards = fw["decode_ticks"] + fw["prefill_chunks"]
        want = {"paged_attention": model.depth * forwards,
                "int8_gemm": (5 * model.depth + 1) * forwards}
        if engines[0].device.type != "cuda":
            want = {k: 0 for k in want}
        if launches != want or line["kernel_launches"] != want:
            raise AssertionError(
                f"fleet {name}: launches {launches} (line "
                f"{line['kernel_launches']}), want {want} ({forwards} "
                f"forwards over {fw['replicas']} incarnations)")
        rec = {"wall_s": wall_s, "fleet_ticks": line["fleet_ticks"],
               "ms_per_tick": 1e3 * wall_s / line["fleet_ticks"],
               "forwards": fw, "ms_per_forward": 1e3 * wall_s / forwards,
               "kernel_launches": launches,
               "trace_crc": metric["trace_crc"],
               **{k: line[k] for k in (
                   "decode_ticks", "prefill_chunks", "dispatches",
                   "redispatches", "fenced_discards", "crashes",
                   "restarts", "handoffs", "handoff_pages",
                   "handoffs_aborted", "msgs_sent", "msgs_duped",
                   "msgs_delayed", "msgs_deduped", "retransmits",
                   "output_tokens", "state_crc")}}
        if base is None:
            base = (engines[0], res, metric["trace_crc"])
        else:
            rec["agree"] = agree_requests(torch, engines[0], base[0],
                                          res.requests, base[1].requests)
        runs[name] = rec
        emit({"phase": "fleet_run", "run": name, **rec})
        del out, res, engines
    checks = {
        "crash_redispatched": (runs["crash"]["crashes"] == 1
                               and runs["crash"]["redispatches"] > 0),
        "handoffs": runs["disagg"]["handoffs"] > 0,
        "transport_trace": runs["transport"]["trace_crc"] == base[2],
        "transport_faults": (runs["transport"]["msgs_duped"] > 0
                             and runs["transport"]["msgs_delayed"] > 0),
    }
    if not all(checks.values()):
        raise AssertionError(f"fleet: checks {checks}; runs {runs}")
    phase_s = time.perf_counter() - t_phase
    if phase_s > FLEET_BUDGET_S:
        raise AssertionError(f"fleet took {phase_s:.1f} s, over its "
                             f"{FLEET_BUDGET_S} s budget")
    return {"record": {"requests": FLEET_REQUESTS, "phase_s": phase_s,
                       "checks": checks, "runs": runs},
            "launches": total}


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
                    reference: float, want_steps: int = TRAIN_STEPS) -> None:
    """The checks the train, train_bf16 and dp phases share: an epoch of
    `want_steps` steps with every kernel launched PER_STEP times a step,
    PER_EVAL times an eval batch in the eval, and no other kernel; test
    accuracy on the 10,000 samples at least `reference` less
    ACCURACY_MARGIN; finite epoch metrics."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    if steps != want_steps:
        raise AssertionError(f"{what}: {steps} steps, want {want_steps}")
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
    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.models.initializers import get_initializer
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.config import Config
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    model = get_model("reference_cnn")
    ds = synthetic_stripes(num_train=AGREE_STEPS * CNN_BATCH, num_test=2048)
    params = model.init(prng.key(0),
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


def grads_rel_l2(got: list, want: list) -> dict:
    """Relative L2 gap per leaf (numpy arrays, named by index)."""
    import numpy as np

    return {i: float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
            for i, (a, b) in enumerate(zip(got, want, strict=True))}


def check_ties(what: str, logits, want_logits) -> dict:
    """Predictions of `logits` against `want_logits` (numpy, one row a
    test sample): equal, or where they differ the top-2 gap of the
    reference within TIE_GAP."""
    import numpy as np

    top2 = np.sort(want_logits, axis=-1)[:, -2:]
    gap = top2[:, 1] - top2[:, 0]
    differ = np.flatnonzero(logits.argmax(-1) != want_logits.argmax(-1))
    gaps = [float(gap[i]) for i in differ]
    if any(g > TIE_GAP for g in gaps):
        raise AssertionError(f"{what}: predictions differ at "
                             f"{differ.tolist()} with top-2 gaps {gaps} "
                             f"(tie rule {TIE_GAP})")
    return {"predictions_differ": len(gaps), "differ_top2_gaps": gaps}


def dp_world(torch, what: str, devices: list, cfg, agree_data: dict,
             one: dict) -> dict:
    """The dp phase at one world of ranks on `devices`: AGREE_STEPS steps
    from the seeded init, one epoch of `agree_data` on the
    device-resident route (the first step's averaged gradients, the final
    params and the test predictions against the one-device run `one`),
    then a fresh full epoch of the train phase's data and the eval,
    launches and collectives held on every rank."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        pick_backend,
        run_ranks,
    )
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank

    world = len(devices)
    agree = run_ranks(cnn_rank, world, devices=devices,
                      args=(cfg, agree_data),
                      kwargs=dict(grads=True, logits=True),
                      timeout=DP_RANKS_TIMEOUT_S)
    worst_grad, param_diff, ties = 0.0, 0.0, None
    for r, res in enumerate(agree):
        rel = grads_rel_l2(res["grads"], one["grads"])
        worst_grad = max(worst_grad, max(rel.values()))
        param_diff = max(param_diff, max(
            float(np.abs(a - b).max())
            for a, b in zip(res["params"], one["params"], strict=True)))
        ties = check_ties(f"{what} rank {r}", res["logits"], one["logits"])
        coll = res["epoch_counts"]["collectives"]
        # a step's all-reduce, and the preemption flags' at the epoch's
        # one chunk boundary
        if coll != {"all_reduce": AGREE_STEPS + 1, "broadcast": 0} \
                or res["init"]["collectives"]["broadcast"] != 1:
            raise AssertionError(f"{what} rank {r}: collectives {coll}, "
                                 f"init {res['init']['collectives']}")
    if not (worst_grad <= DP_GRAD_REL_L2 and param_diff <= AGREE_PARAM_ATOL):
        raise AssertionError(f"{what}: first-step gradients apart by "
                             f"{worst_grad} (limit {DP_GRAD_REL_L2}), params "
                             f"after {AGREE_STEPS} steps by {param_diff} "
                             f"(limit {AGREE_PARAM_ATOL})")
    epoch = run_ranks(cnn_rank, world, devices=devices,
                      args=(cfg, dict(num_train=DP_EPOCH_TRAIN,
                                      num_test=10_000)),
                      timeout=DP_RANKS_TIMEOUT_S)
    for r, res in enumerate(epoch):
        em, (ntests, ncorrect) = res["epoch"], res["eval"]
        check_cnn_epoch(f"{what} rank {r}", res["epoch_counts"]["launches"],
                        res["eval_counts"]["launches"], em["steps"], ntests,
                        ncorrect, {k: em[k] for k in ("loss", "etotal", "acc")},
                        JAX_CPU_ACCURACY, DP_EPOCH_TRAIN // CNN_BATCH)
        counts = (res["init"]["collectives"], res["epoch_counts"]["collectives"],
                  res["eval_counts"]["collectives"])
        if counts != ({"all_reduce": 0, "broadcast": 1},
                      {"all_reduce": DP_EPOCH_TRAIN // CNN_BATCH + 1,
                       "broadcast": 0},
                      {"all_reduce": 1, "broadcast": 0}):
            raise AssertionError(f"{what} rank {r}: collectives (init, epoch, "
                                 f"eval) {counts}")
    em, (ntests, ncorrect) = epoch[0]["epoch"], epoch[0]["eval"]
    return {"world": world, "backend": pick_backend(devices),
            "devices": [str(d) for d in devices],
            "agree_steps": AGREE_STEPS,
            "first_grad_rel_l2_max": worst_grad,
            "first_grad_rel_l2_tolerance": DP_GRAD_REL_L2,
            "param_max_abs_diff": param_diff,
            "param_tolerance": AGREE_PARAM_ATOL, **ties,
            "epoch_steps": em["steps"], "epoch_s": em["seconds"],
            "step_ms": 1e3 * em["seconds"] / em["steps"],
            "loss": em["loss"], "acc": em["acc"], "ntests": ntests,
            "ncorrect": ncorrect,
            "launches_per_rank": [res["epoch_counts"]["launches"]
                                  for res in epoch],
            "collectives_per_rank": [res["epoch_counts"]["collectives"]
                                     for res in epoch],
            "note": DP_NOTE if pick_backend(devices) == "gloo" else
            "one rank a card over NCCL"}


def phase_dp(torch, dev=None) -> None:
    """The train phase's configuration through parallel/dp.py: world 1 on
    a one-rank NCCL group, AGREE_STEPS steps (one epoch of AGREE_STEPS
    batches, as train_agree runs them, on the device-resident route) bit
    for bit against the one-device Trainer with one all-reduce a step;
    world DP_WORLD as gloo ranks on cuda:0 (dp_world); with two cards or
    more, world min(4, cards) over NCCL, one rank a card. One line per
    world. (`dev` the CPU: the same on gloo, to rehearse the phase.)"""
    import tempfile

    import numpy as np

    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        pick_backend,
        process_group,
    )
    from mpi_cuda_cnn_tpu_torch.parallel.mesh import make_mesh
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank
    from mpi_cuda_cnn_tpu_torch.utils.config import Config

    dev = dev or torch.device("cuda", 0)
    cfg = Config(model="reference_cnn", epochs=1, batch_size=CNN_BATCH,
                 lr=0.1, seed=0, device=str(dev), use_kernels=True,
                 log_every=0, eval_every=0)
    data = dict(num_train=AGREE_STEPS * CNN_BATCH, num_test=10_000)
    one = cnn_rank(None, cfg, data, grads=True, logits=True)
    backend = pick_backend([dev])
    with tempfile.TemporaryDirectory() as tmp, \
            process_group(backend, 0, 1, str(Path(tmp) / "store")):
        w1 = cnn_rank(make_mesh(devices=[dev]), cfg, data, grads=True)
    same = all(np.array_equal(a, b) for a, b in
               zip(w1["params"] + w1["grads"], one["params"] + one["grads"],
                   strict=True))
    coll = w1["epoch_counts"]["collectives"]
    if not same or coll != {"all_reduce": AGREE_STEPS, "broadcast": 0} \
            or w1["init"]["collectives"]["broadcast"] != 1 \
            or w1["epoch"]["loss"] != one["epoch"]["loss"]:
        raise AssertionError(f"dp world 1 ({backend}): bitwise {same}, "
                             f"losses {w1['epoch']['loss']} vs "
                             f"{one['epoch']['loss']}, collectives {coll}")
    emit({"phase": "dp", "world": 1, "backend": backend, "devices": [str(dev)],
          "steps": AGREE_STEPS, "bitwise_equal_one_device": same,
          "collectives": coll, "loss": w1["epoch"]["loss"]})
    worlds = [1]
    emit({"phase": "dp", **dp_world(torch, "dp world 2 (gloo, one card)",
                                    [dev] * DP_WORLD, cfg, data, one)})
    worlds.append(DP_WORLD)
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= 2:
        w = min(DP_MAX_NCCL_WORLD, cards)
        emit({"phase": "dp", **dp_world(
            torch, f"dp world {w} (nccl)",
            [torch.device("cuda", i) for i in range(w)], cfg, data, one)})
        worlds.append(w)
    emit({"phase": "dp_worlds", "worlds": worlds, "cards": cards})


def mesh_plan_counts(model_name: str, axes: dict, flags: dict, rank: int
                     ) -> tuple[dict, dict, dict]:
    """What the plan of `model_name` on the mesh `axes` with `flags` gives
    rank `rank`, per step: (K3/K4/K5 launches, the collectives) and per
    eval batch the launches. A rank runs every layer, or on a pipe axis
    its stage's, `num_microbatches` times a step and an eval batch. Each
    conv launches its forward (K4) and weight gradient (K5), and K4' for
    its input gradient unless it is the model's first layer; each dense
    layer its forward, weight gradient and (the same rule) input gradient
    (K3). A sliced layer makes a gather a pass, and an all-reduce of its
    input gradient unless first; the data mean is an all-reduce (a
    gather and a reduce-scatter under FSDP), the pipeline sums its
    metrics in one more all-reduce and sends and receives a boundary a
    microbatch; the clip sums its norm in one all-reduce."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.models.layers import Conv, Dense
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.parallel.pp import make_pipeline_plan
    from mpi_cuda_cnn_tpu_torch.parallel.tp import tp_sliced

    model = get_model(model_name)
    coord = dict(zip(axes, np.unravel_index(rank, tuple(axes.values()))))
    n_pipe, n_model = axes.get("pipe", 1), axes.get("model", 1)
    n_data = axes.get("data", 1)
    fsdp = bool(flags.get("fsdp")) and n_data > 1
    sliced = tp_sliced(model, n_model)
    layers = range(len(model.layers))
    m = 1
    coll = {"all_reduce": 0, "broadcast": 0}
    if n_pipe > 1:
        s = int(coord["pipe"])
        layers = make_pipeline_plan(model, n_pipe).stage_layers[s]
        m = flags.get("num_microbatches") or n_pipe
        hops = m * ((s < n_pipe - 1) + (s > 0))
        coll.update(send=hops, recv=hops)
        coll["all_reduce"] += 1
    step = {"gemm": 0, "conv_direct": 0, "conv_dw": 0}
    evals = dict(step)
    for i in layers:
        layer = model.layers[i]
        if isinstance(layer, Conv):
            step["conv_direct"] += m * (1 + (i > 0))
            step["conv_dw"] += m
            evals["conv_direct"] += m
        elif isinstance(layer, Dense):
            step["gemm"] += m * (2 + (i > 0))
            evals["gemm"] += m
    tp = [i for i in layers if sliced[i]]
    if tp:
        coll["all_gather"] = m * len(tp)
        coll["all_reduce"] += m * sum(i > 0 for i in tp)
    if fsdp:
        coll["all_gather"] = coll.get("all_gather", 0) + 1
        coll["reduce_scatter"] = 1
    elif n_data > 1:
        coll["all_reduce"] += 1
    if flags.get("grad_clip"):
        coll["all_reduce"] += 1
    return step, coll, evals


def mesh_counts_held(label: str, res: dict, name: str, axes: dict,
                     flags: dict, rank: int, steps: int,
                     eval_batches: int) -> None:
    """One rank's K3/K4/K5 launches over `steps` steps and `eval_batches`
    eval batches, and its collectives over the steps' one chunk, against
    the plan (`mesh_plan_counts`)."""
    step, coll, evals = mesh_plan_counts(name, axes, flags, rank)
    want_l = ({k: v * steps for k, v in step.items()},
              {k: v * eval_batches for k, v in evals.items()})
    got_l = tuple({k: res[c]["launches"][k] for k in step}
                  for c in ("epoch_counts", "eval_counts"))
    got_c = {k: v for k, v in res["epoch_counts"]["collectives"].items() if v}
    want_c = {k: v * steps for k, v in coll.items() if v}
    # and the preemption flags' one all-reduce at the epoch's one chunk
    # boundary (log_every 0; `train/recovery.py`)
    want_c["all_reduce"] = want_c.get("all_reduce", 0) + 1
    if got_l != want_l or got_c != want_c:
        raise AssertionError(f"{label}: launches (steps, eval) {got_l}, want "
                             f"{want_l}; collectives {got_c}, want {want_c}")


def mesh_world(torch, what: str, devices: list, runs: list, ones: dict,
               epochs: list) -> tuple[list[dict], list[dict], dict]:
    """The CNN_MESH_RUNS `runs` of one world on `devices`, then its
    CNN_MESH_EPOCHS `epochs`, in one spawn of the ranks
    (`cnn_rank_each`). Each run is held to its one-device run in `ones`
    (the first gradients, the params after AGREE_STEPS steps, the
    predictions on the CNN_MESH_AGREE_TEST test samples) and each epoch
    of CNN_MESH_EPOCH_TRAIN samples to the JAX CPU accuracy on the
    10,000; both to their plan's counts on every rank
    (`mesh_counts_held`). Returns (a record a run, a record an epoch,
    the K3/K4/K5 launches of every rank's steps and evals)."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        pick_backend,
        run_ranks,
    )
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank_each
    from mpi_cuda_cnn_tpu_torch.utils.config import cnn_axes

    agree = dict(num_train=AGREE_STEPS * CNN_BATCH,
                 num_test=CNN_MESH_AGREE_TEST)
    full = dict(num_train=CNN_MESH_EPOCH_TRAIN, num_test=10_000)
    backend = pick_backend(devices)
    cfgs = ([(mesh_cfg(devices[0], *r), agree, None,
              dict(grads=True, logits=True)) for r in runs]
            + [(mesh_cfg(devices[0], *r), full, None, {}) for r in epochs])
    t0 = time.perf_counter()
    ranks = run_ranks(cnn_rank_each, len(devices), devices=devices,
                      args=(cfgs,), timeout=DP_RANKS_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    launches = {"gemm": 0, "conv_direct": 0, "conv_dw": 0}
    for rk in ranks:
        for res in rk:
            for c in ("epoch_counts", "eval_counts"):
                for k in launches:
                    launches[k] += res[c]["launches"][k]
    records, epoch_records = [], []
    for i, (name, mesh, flags) in enumerate(runs + epochs):
        label = f"{what} {name} {mesh} {flags}"
        axes = cnn_axes(cfgs[i][0], len(devices))
        data = cfgs[i][1]
        steps = data["num_train"] // CNN_BATCH
        evals = math.ceil(data["num_test"] / EVAL_BATCH)
        for r, rk in enumerate(ranks):
            mesh_counts_held(f"{label} rank {r}", rk[i], name, axes, flags,
                             r, steps, evals)
        res0 = ranks[0][i]
        em, (ntests, ncorrect) = res0["epoch"], res0["eval"]
        rec = {"model": name, "mesh": mesh, "flags": flags,
               "world": len(devices), "backend": backend, "steps": steps,
               "step_ms": 1e3 * em["seconds"] / em["steps"],
               "launches_per_step_rank": [mesh_plan_counts(
                   name, axes, flags, r)[0] for r in range(len(devices))],
               "collectives_per_step_rank": [mesh_plan_counts(
                   name, axes, flags, r)[1] for r in range(len(devices))],
               "run_wall_s": res0["wall_s"], "spawn_wall_s": wall_s}
        if i >= len(runs):
            for r, rk in enumerate(ranks):
                e, (nt, nc) = rk[i]["epoch"], rk[i]["eval"]
                if e["steps"] != steps or nt != 10_000 \
                        or nc / nt < JAX_CPU_ACCURACY - ACCURACY_MARGIN \
                        or not all(math.isfinite(e[k])
                                   for k in ("loss", "etotal", "acc")):
                    raise AssertionError(
                        f"{label} epoch rank {r}: {e['steps']} steps, "
                        f"accuracy {nc}/{nt}, metrics {e}")
            epoch_records.append({**rec, "epoch_s": em["seconds"],
                                  "loss": em["loss"], "acc": em["acc"],
                                  "ntests": ntests, "ncorrect": ncorrect,
                                  "reference_accuracy": JAX_CPU_ACCURACY})
            continue
        one = ones[name, bool(flags.get("grad_clip"))]
        worst_grad = param_diff = 0.0
        for r, rk in enumerate(ranks):
            res = rk[i]
            rel = grads_rel_l2(res["grads"], one["grads"])
            worst_grad = max(worst_grad, max(rel.values()))
            param_diff = max(param_diff, max(
                float(np.abs(a - b).max())
                for a, b in zip(res["params"], one["params"], strict=True)))
            ties = check_ties(f"{label} rank {r}", res["logits"],
                              one["logits"])
        if not (worst_grad <= DP_GRAD_REL_L2
                and param_diff <= AGREE_PARAM_ATOL):
            raise AssertionError(
                f"{label}: first-step gradients apart by {worst_grad} "
                f"(limit {DP_GRAD_REL_L2}), params after {AGREE_STEPS} "
                f"steps by {param_diff} (limit {AGREE_PARAM_ATOL})")
        records.append({**rec, "first_grad_rel_l2_max": worst_grad,
                        "param_max_abs_diff": param_diff, **ties})
    return records, epoch_records, launches


def mesh_cfg(dev, name: str, mesh: str, flags: dict):
    """The train phase's configuration of `name` on `mesh` with `flags`."""
    from mpi_cuda_cnn_tpu_torch.utils.config import Config

    return Config(model=name, epochs=1, batch_size=CNN_BATCH, lr=0.1, seed=0,
                  device=str(dev), use_kernels=True, log_every=0,
                  eval_every=0, mesh_shape=mesh, **flags)


def mesh_world_size(mesh: str) -> int:
    return math.prod(int(p.split(":")[1]) for p in mesh.split(","))


def phase_cnn_mesh(torch, dev=None) -> dict:
    """The cnn_mesh phase (see CNN_MESH_RUNS): the one-device runs, then
    each world's CNN_MESH_RUNS and CNN_MESH_EPOCHS as gloo ranks on one
    card in one spawn (and over NCCL, a card a rank, when there are
    cards for it; `mesh_world`). One line per mesh and per epoch;
    returns the phase's record and the K3/K4/K5 launches of every
    rank's steps and evals. (`dev` the CPU: the same on gloo, to
    rehearse the phase.)"""
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    data = dict(num_train=AGREE_STEPS * CNN_BATCH,
                num_test=CNN_MESH_AGREE_TEST)
    ones = {}
    for name, clip in sorted({(n, bool(f.get("grad_clip")))
                              for n, _, f in CNN_MESH_RUNS}):
        flags = CNN_MESH_CLIP if clip else {}
        ones[name, clip] = cnn_rank(None, mesh_cfg(dev, name, "data", flags),
                                    data, grads=True, logits=True)
    launches = {"gemm": 0, "conv_direct": 0, "conv_dw": 0}
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    calls = []
    for world in (4, 2):
        runs = [r for r in CNN_MESH_RUNS if mesh_world_size(r[1]) == world]
        ep = [r for r in CNN_MESH_EPOCHS if mesh_world_size(r[1]) == world]
        calls.append((f"cnn_mesh world {world} (gloo, one card)",
                       [dev] * world, runs, ep))
        if cards >= world:
            calls.append((f"cnn_mesh world {world} (nccl)",
                          [torch.device("cuda", i) for i in range(world)],
                          runs, ep))
    # The gloo worlds share the card, each rank waiting on the host most
    # of a step: their spawns run at once (the NCCL ones after them).
    gloo = [c for c in calls if "gloo" in c[0]]
    with ThreadPoolExecutor(len(gloo)) as pool:
        done = list(pool.map(lambda c: mesh_world(torch, c[0], c[1], c[2],
                                                  ones, c[3]), gloo))
    done += [mesh_world(torch, what, devices, runs, ones, ep)
             for what, devices, runs, ep in calls if "nccl" in what]
    records, epochs = [], []
    for recs, eps, counts in done:
        for rec in recs:
            emit({"phase": "cnn_mesh", **rec, "note": CNN_MESH_NOTE
                  if rec["backend"] == "gloo"
                  else "one rank a card over NCCL"})
        for rec in eps:
            emit({"phase": "cnn_mesh_epoch", **rec, "note": CNN_MESH_NOTE
                  if rec["backend"] == "gloo"
                  else "one rank a card over NCCL"})
        records += recs
        epochs += eps
        for k in launches:
            launches[k] += counts[k]
    phase_s = time.perf_counter() - t_phase
    if phase_s > CNN_MESH_BUDGET_S:
        raise AssertionError(f"cnn_mesh took {phase_s:.1f} s, over its "
                             f"{CNN_MESH_BUDGET_S} s budget")
    return {"record": {"phase_s": phase_s, "budget_s": CNN_MESH_BUDGET_S,
                       "meshes": len(records), "epochs": epochs,
                       "cards": cards},
            "launches": launches}


def phase_lm_dp(torch, dev=None) -> dict:
    """LM_DP_ARGS at world 2 as gloo ranks on cuda:0 against as many
    one-device LMTrainer steps from the same seeded init: launches per
    rank, losses, first-step gradients. (`dev` the CPU: the same, to
    rehearse the phase.)"""
    from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
    from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    dev = dev or torch.device("cuda", 0)
    cfg = parse_lm_args(LM_DP_ARGS + ["--device", str(dev)])
    one = lm_rank(None, cfg, grads=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = run_ranks(lm_rank, DP_WORLD, devices=[dev] * DP_WORLD,
                      args=(cfg,), kwargs=dict(grads=True),
                      timeout=DP_RANKS_TIMEOUT_S)
    worst_loss = worst_grad = 0.0
    for r, res in enumerate(ranks):
        launches = res["counts"]["launches"]
        want = {name: LM_PER_STEP[name] * LM_DP_STEPS + LM_PER_EVAL[name]
                for name in FLASH_KERNELS}
        if {k: launches[k] for k in FLASH_KERNELS} != want \
                or res["counts"]["collectives"] != {
                    "all_reduce": 2 * LM_DP_STEPS, "broadcast": 0}:
            raise AssertionError(f"lm_dp rank {r}: counts {res['counts']}, "
                                 f"want launches {want}")
        if len(res["losses"]) != LM_DP_STEPS:
            raise AssertionError(f"lm_dp rank {r}: losses {res['losses']}")
        worst_loss = max(worst_loss, max(
            abs(a - b) for a, b in zip(res["losses"], one["losses"],
                                       strict=True)))
        worst_grad = max(worst_grad, max(
            grads_rel_l2(res["grads"], one["grads"]).values()))
    if not (worst_loss <= LM_AGREE_LOSS_ATOL
            and worst_grad <= LM_AGREE_GRAD_REL_L2):
        raise AssertionError(f"lm_dp: losses apart by {worst_loss} (limit "
                             f"{LM_AGREE_LOSS_ATOL}), first-step gradients by "
                             f"{worst_grad} (limit {LM_AGREE_GRAD_REL_L2})")
    res = ranks[0]
    return {"world": DP_WORLD, "backend": "gloo", "steps": LM_DP_STEPS,
            "losses": {"dp": res["losses"], "one_device": one["losses"]},
            "loss_max_abs_diff": worst_loss,
            "loss_tolerance": LM_AGREE_LOSS_ATOL,
            "first_grad_rel_l2_max": worst_grad,
            "first_grad_rel_l2_tolerance": LM_AGREE_GRAD_REL_L2,
            "eval_loss": {"dp": res["eval_loss"],
                          "one_device": one["eval_loss"]},
            # LM_DP_STEPS steps and the eval
            "train_s": {"dp": res["seconds"], "one_device": one["seconds"]},
            "launches_per_rank": [r["counts"]["launches"] for r in ranks],
            "note": DP_NOTE}


def phase_lm_sp(torch, dev=None) -> dict:
    """LM_SP_ARGS at seq:2 as two gloo ranks on `dev` (cuda:0), ring_flash
    in float32 and bf16, ring and ulysses in float32, against the
    one-device flash LMTrainer from the same seeded init: first-step
    gradients per leaf, the float32 losses, ring_flash's launches a step
    per rank, each run's step ms; and the seconds of one seeded init of
    the model (drawn on the host, moved to `dev`). (`dev` the CPU: the
    same, to rehearse it.)
    Returns the phase's record and the ring_flash launches of both ranks'
    float32 run (its steps and its eval)."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
    from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank, lm_rank_runs
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    dev = dev or torch.device("cuda", 0)
    flag = dict(zip(LM_SP_ARGS[::2], LM_SP_ARGS[1::2]))
    model = TransformerLM(vocab=256, dim=int(flag["--dim"]),
                          heads=int(flag["--heads"]),
                          depth=int(flag["--depth"]),
                          max_seq=int(flag["--seq-len"]))
    t0 = time.perf_counter()
    params = model.init(prng.key(0), dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in tree_leaves(params))
    del params

    def cfg(impl, dtype, steps, mesh="seq:2"):
        return parse_lm_args(LM_SP_ARGS + [
            "--device", str(dev), "--attn-impl", impl, "--compute-dtype",
            dtype, "--steps", str(steps), "--mesh-shape", mesh])

    runs = {"ring_flash": cfg("flash", "float32", LM_SP_STEPS),
            "ring_flash_bf16": cfg("flash", "bfloat16", LM_SP_OTHER_STEPS),
            "ring": cfg("ring", "float32", LM_SP_OTHER_STEPS),
            "ulysses": cfg("ulysses", "float32", LM_SP_OTHER_STEPS)}
    one = {dtype: lm_rank(None, cfg("flash", dtype, LM_SP_STEPS, "data"),
                          grads=True)
           for dtype in ("float32", "bfloat16")}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ranks = run_ranks(lm_rank_runs, LM_SP_WORLD, devices=[dev] * LM_SP_WORLD,
                      args=([(c, None, {"grads": True})
                             for c in runs.values()],),
                      axes={"data": 1, "seq": LM_SP_WORLD},
                      timeout=DP_RANKS_TIMEOUT_S)
    grad_rel, step_ms, launches = {}, {}, []
    for r, res_r in enumerate(ranks):
        got = dict(zip(runs, res_r))
        for name, res in got.items():
            dtype = "bfloat16" if name.endswith("bf16") else "float32"
            worst = max(grads_rel_l2(res["grads"], one[dtype]["grads"])
                        .values())
            limit = (LM_BF16_GRAD_REL_L2 if dtype == "bfloat16"
                     else LM_AGREE_GRAD_REL_L2)
            if not worst <= limit:
                raise AssertionError(f"lm_sp rank {r} {name}: first-step "
                                     f"gradients apart by {worst} (limit "
                                     f"{limit})")
            grad_rel[name] = max(grad_rel.get(name, 0.0), worst)
            steps = runs[name].steps
            if len(res["losses"]) != steps or not np.isfinite(
                    res["losses"]).all():
                raise AssertionError(f"lm_sp rank {r} {name}: losses "
                                     f"{res['losses']}")
            # a step's all-reduce and the preemption flags' at its end
            if res["counts"]["collectives"]["all_reduce"] != 2 * steps:
                raise AssertionError(f"lm_sp rank {r} {name}: "
                                     f"{res['counts']['collectives']}")
            # steps and the eval in res["seconds"]; the eval is one forward
            step_ms.setdefault(name, []).append(1e3 * res["seconds"] / steps)
        flash = got["ring_flash"]
        want = {k: n * LM_SP_STEPS + LM_SP_PER_EVAL[k]
                for k, n in LM_SP_PER_STEP[r].items()}
        have = {k: flash["counts"]["launches"][k] for k in want}
        if have != want:
            raise AssertionError(f"lm_sp rank {r}: ring_flash launches "
                                 f"{have}, want {want}")
        launches.append(have)
        loss_gap = max(abs(a - b) for a, b in zip(
            flash["losses"], one["float32"]["losses"], strict=True))
        if not loss_gap <= LM_AGREE_LOSS_ATOL:
            raise AssertionError(f"lm_sp rank {r}: ring_flash losses "
                                 f"{flash['losses']} against one device "
                                 f"{one['float32']['losses']}")
    return {"record": {
        "world": LM_SP_WORLD, "mesh": "seq:2", "backend": "gloo",
        "steps": {k: c.steps for k, c in runs.items()},
        "losses": {"ring_flash": ranks[0][0]["losses"],
                   "one_device": one["float32"]["losses"]},
        "first_grad_rel_l2_max": grad_rel,
        "first_grad_rel_l2_tolerance": {"float32": LM_AGREE_GRAD_REL_L2,
                                        "bfloat16": LM_BF16_GRAD_REL_L2},
        "loss_tolerance": LM_AGREE_LOSS_ATOL,
        "ring_flash_launches_per_rank": launches,
        "step_ms_per_rank": step_ms,
        "one_device_step_ms": {d: 1e3 * one[d]["seconds"] / LM_SP_STEPS
                               for d in one},
        "step_ms_note": "train() wall seconds (steps and the eval) over "
                        "the steps",
        "init_s": init_s, "init_params": n_params,
        "init_note": "TransformerLM.init of the model at vocab 256: "
                     "prng.normal on the host, then a copy to the device",
        "note": LM_SP_NOTE},
        "launches": {k: sum(la[k] for la in launches)
                     for k in FLASH_KERNELS}}


def lm_mesh_axes(mesh: str) -> dict:
    axes = {a: int(n) for a, n in (p.split(":") for p in mesh.split(","))}
    return axes if "data" in axes else {"data": 1, **axes}


def lm_mesh_plan(mesh: str, rank: int) -> tuple[dict, dict]:
    """(K7/K8/K9 launches a step, an eval) of `rank` on `mesh` with flash
    attention: a stage's LM_SP_DEPTH / n_pipe layers over M = n_pipe
    microbatches, each folding seq rank s + 1 blocks of the ring
    (causal), one launch a layer a fold; the eval one K7 a layer on the
    whole sequence."""
    from mpi_cuda_cnn_tpu_torch.parallel.mesh import Mesh

    axes = lm_mesh_axes(mesh)
    m = Mesh(shape=axes, rank=rank, world=math.prod(axes.values()),
             device=None, group=None)
    folds = m.index("seq") + 1
    step = {k: LM_SP_DEPTH * folds for k in FLASH_KERNELS}
    return step, dict(LM_SP_PER_EVAL)


def lm_mesh_shapes() -> list[tuple]:
    """The distinct float32 K7/K8/K9 shapes of LM_MESH_RUNS, (dtype, B, S,
    H, Hkv, D, causal), the flagship's (the eval's) left out: a rank's
    rows B / (n_data M) (over data x expert on an expert axis), its S /
    n_seq positions, its H / n_model heads and Hkv / n_model kv heads;
    a ring fold's full blocks non-causal too."""
    flag = dict(zip(LM_MODEL_ARGS[::2], LM_MODEL_ARGS[1::2]))
    b0, s0, h0 = (int(flag[k]) for k in ("--batch-size", "--seq-len",
                                         "--heads"))
    d = int(flag["--dim"]) // h0
    out = []
    for mesh, extra in LM_MESH_RUNS:
        axes = lm_mesh_axes(mesh)
        opt = dict(zip(extra[::2], extra[1::2]))
        kv = int(opt.get("--kv-heads", h0))
        n_m, n_s = axes.get("model", 1), axes.get("seq", 1)
        b = b0 // (axes["data"] * axes.get("expert", 1) * axes.get("pipe", 1))
        shape = (b, s0 // n_s, h0 // n_m, kv // n_m, d)
        for causal in ((True, False) if n_s > 1 else (True,)):
            out.append(("float32", *shape, causal))
    flagship = ("float32", b0, s0, h0, h0, d, True)
    return [s for s in dict.fromkeys(out) if s != flagship]


def phase_lm_mesh(torch, dev=None, nccl: bool = False) -> dict:
    """LM_MESH_RUNS as gloo ranks on `dev` (cuda:0), one spawn a world
    (with `nccl` and cards for it, also over NCCL, a card a rank): the
    first-step gradients against their one-device reference, the float32
    losses finite, every rank's K7/K8/K9 launches held to `lm_mesh_plan`,
    each run's step ms. One line a run; returns the phase's record and
    the launches of every rank's steps and evals. (`dev` the CPU: the
    same, to rehearse it.)"""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.parallel.distributed import run_ranks
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank, lm_rank_runs
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    base = [a if LM_MODEL_ARGS[i - 1] != "--depth" else str(LM_SP_DEPTH)
            for i, a in enumerate(LM_MODEL_ARGS)] + [
        "--device", str(dev), "--attn-impl", "flash", "--steps",
        str(LM_MESH_STEPS), "--warmup-steps", "1", "--log-every", "1"]

    def cfg(mesh, extra):
        return parse_lm_args(base + ["--mesh-shape", mesh, *extra])

    def run(i):
        mesh, extra = LM_MESH_RING_REF if i == "ring" else LM_MESH_RUNS[i]
        return mesh, extra, cfg(mesh, extra)

    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    calls = []
    for spawn_runs in LM_MESH_SPAWNS:
        mine = [run(i) for i in spawn_runs]
        world = math.prod(lm_mesh_axes(mine[0][0]).values())
        calls.append(("gloo", [dev] * world, mine))
        if nccl and 1 < world <= cards:
            calls.append(("nccl", [torch.device("cuda", i)
                                   for i in range(world)], mine))

    def spawn(call):
        backend, devices, mine = call
        t0 = time.perf_counter()
        ranks = run_ranks(lm_rank_runs, len(devices), devices=devices,
                          args=([(c, None, {"grads": True})
                                 for _, _, c in mine],),
                          timeout=DP_RANKS_TIMEOUT_S)
        return ranks, time.perf_counter() - t0

    # The gloo worlds share the card, each rank waiting on the host most
    # of a step: their spawns run at once, beside the one-device
    # references in this process (the NCCL ones after them).
    gloo = [c for c in calls if c[0] == "gloo"]
    with ThreadPoolExecutor(len(gloo)) as pool:
        pending = [pool.submit(spawn, c) for c in gloo]
        # the dense MHA and GQA models' first gradients on one device, and
        # expert:2's mean of the one-device gradients of each rank's rows
        ones = {}
        for extra in ([], ["--kv-heads", "2"]):
            ones[tuple(extra)] = lm_rank(None, cfg("data", extra),
                                         grads=True)["grads"]
        tr = LMTrainer(cfg("data", LM_MESH_MOE))
        tokens, targets = tr._sample_batch(0)
        half = len(tokens) // 2
        ep = [tr.train_step.grads(tr.state,
                                  tr._to_device(tokens[i:i + half]),
                                  tr._to_device(targets[i:i + half]))[0]
              for i in (0, half)]
        ones["expert"] = [((a + b) / 2).float().cpu().numpy()
                          for a, b in zip(*ep)]
        del tr, ep
        done = [p.result() for p in pending]
    done += [spawn(c) for c in calls if c[0] == "nccl"]
    calls = gloo + [c for c in calls if c[0] == "nccl"]
    records, launches = [], {k: 0 for k in FLASH_KERNELS}
    for (backend, devices, mine), (ranks, wall) in zip(calls, done):
        world = len(devices)
        by_run = list(zip(*ranks))
        ring_ref = by_run[-1] if mine[-1][2].attn_impl == "ring" else None
        for (mesh, extra, c), res_r in zip(mine, by_run):
            if c.attn_impl == "ring":
                continue
            if mesh == "expert:2":
                want = [ones["expert"]] * world
            elif c.moe_experts:
                want = [r["grads"] for r in ring_ref]
            else:
                want = [ones[tuple(x for x in extra if x != "--fsdp")]] * world
            worst, have = 0.0, []
            limit = (LM_MOE_GRAD_REL_L2 if c.moe_experts
                     else LM_AGREE_GRAD_REL_L2)
            for r, res in enumerate(res_r):
                gap = max(grads_rel_l2(res["grads"], want[r]).values())
                worst = max(worst, gap)
                if not gap <= limit:
                    raise AssertionError(
                        f"lm_mesh {mesh} {extra} rank {r} ({backend}): "
                        f"first-step gradients apart by {gap} (limit "
                        f"{limit})")
                if len(res["losses"]) != LM_MESH_STEPS or not np.isfinite(
                        res["losses"]).all():
                    raise AssertionError(f"lm_mesh {mesh} rank {r}: losses "
                                         f"{res['losses']}")
                step, ev = lm_mesh_plan(mesh, r)
                plan = {k: step[k] * LM_MESH_STEPS + ev[k]
                        for k in FLASH_KERNELS}
                got = {k: res["counts"]["launches"].get(k, 0)
                       for k in FLASH_KERNELS}
                if dev.type == "cuda" and got != plan:
                    raise AssertionError(f"lm_mesh {mesh} rank {r}: "
                                         f"launches {got}, plan {plan}")
                have.append(got)
                if backend == "gloo":
                    for k in FLASH_KERNELS:
                        launches[k] += got[k]
            rec = {"mesh": mesh, "flags": extra, "world": world,
                   "backend": backend, "steps": LM_MESH_STEPS,
                   "attn": "ring_flash" if "seq" in mesh else "flash",
                   "losses": res_r[0]["losses"],
                   "first_grad_rel_l2_max": worst,
                   "first_grad_rel_l2_tolerance": limit,
                   "first_grad_reference": (
                       "one-device rows of each rank" if mesh == "expert:2"
                       else "the same mesh with the plain ring"
                       if c.moe_experts else "one device"),
                   "launches_per_rank": have,
                   "step_ms_per_rank": [1e3 * r["seconds"] / LM_MESH_STEPS
                                        for r in res_r],
                   "step_ms_note": "train() wall seconds (steps and the "
                                   "eval) over the steps",
                   "note": LM_MESH_NOTE if backend == "gloo"
                   else "one rank a card over NCCL"}
            emit({"phase": "lm_mesh", **rec})
            records.append(rec)
        emit({"phase": "lm_mesh_world", "world": world, "backend": backend,
              "wall_s": wall})
    phase_s = time.perf_counter() - t_phase
    if dev.type == "cuda" and not nccl and phase_s > LM_MESH_BUDGET_S:
        raise AssertionError(f"lm_mesh took {phase_s:.1f} s, over its "
                             f"{LM_MESH_BUDGET_S} s budget")
    return {"record": {"phase_s": phase_s, "budget_s": LM_MESH_BUDGET_S,
                       "runs": len(records), "cards": cards,
                       "grad_rel_l2_tolerance": {
                       "dense": LM_AGREE_GRAD_REL_L2,
                       "moe": LM_MOE_GRAD_REL_L2}},
            "launches": launches}


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


def phase_lm(torch):
    """`lm` at the flagship width through the flash kernels, with the
    launch counts zeroed just before `train` (the steps and the eval) and
    read just after. Returns (the launches per kernel, the trained
    trainer, which the generate phase samples from)."""
    import math

    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.lm import count_params, get_attn_fn, lm_loss
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    cfg = parse_lm_args(LM_ARGS)
    metrics = MetricsLogger(echo=False, capture=True)
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
          "logged_losses": {r["step"]: r["loss"] for r in metrics.rows},
          "loss": result.final_loss, "eval_loss": result.eval_loss,
          "eval_ppl": result.eval_ppl, "tokens_per_s": result.tokens_per_s,
          "step_ms": 1e3 * tokens_per_step / result.tokens_per_s,
          "wall_s": wall_s, "vocab": trainer.model.vocab,
          "params": count_params(trainer.state["params"]),
          "attn_impl": trainer.attn_impl, "launches": launches,
          "per_step": LM_PER_STEP, "per_eval": LM_PER_EVAL,
          "loss_drop": LM_LOSS_DROP})
    return launches, trainer



def phase_lm_head_dims(torch, dev=None) -> dict:
    """`lm` at head dim 96 through the flash kernels (LM_HEAD_DIM_*): for
    each kv-head layout, a float32 run and a bf16 run from its initial
    params; each run's first-step gradients against the oracle's, then
    its steps and eval with the launch counts zeroed just before `train`
    and read just after. Returns the launches of every run summed per
    kernel. (`dev` the CPU: the same with no launch, to rehearse the phase
    at a small LM_HEAD_DIM.)"""
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.ops.gemv import tree_map
    from mpi_cuda_cnn_tpu_torch.train.lm import get_attn_fn, lm_loss
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    dev = dev or torch.device("cuda", 0)
    on_card = dev.type == "cuda"
    where = [] if on_card else ["--device", "cpu"]
    t_phase = time.perf_counter()
    total = {name: 0 for name in FLASH_KERNELS}
    for kv in LM_HEAD_DIM_KV:
        init = None
        for dtype, limit in (("float32", LM_AGREE_GRAD_REL_L2),
                             ("bfloat16", LM_BF16_GRAD_REL_L2)):
            cfg = parse_lm_args(LM_HEAD_DIM_ARGS + kv + where + [
                "--steps", str(LM_HEAD_DIM_STEPS), "--compute-dtype", dtype])
            metrics = MetricsLogger(echo=False, capture=True)
            t0 = time.perf_counter()
            trainer = LMTrainer(cfg, metrics=metrics, params=init)
            init_s = time.perf_counter() - t0
            what = (f"lm_head_dims {dtype} D {trainer.model.head_dim} "
                    f"kv {trainer.model.n_kv}")
            if (trainer.attn_impl != "flash" or trainer.device.type != dev.type
                    or trainer.model.head_dim != LM_HEAD_DIM // 8):
                raise AssertionError(f"{what}: {trainer.attn_impl} on "
                                     f"{trainer.device}")
            if init is None:
                init = tree_map(lambda t: t.detach().clone(),
                                trainer.state["params"])
            grad_rel = first_grads_rel_l2(torch, trainer, get_attn_fn,
                                          lm_loss, tree_leaves)
            worst = max(grad_rel.values())
            if not worst <= limit:
                raise AssertionError(f"{what}: first-step gradients of flash "
                                     f"and the oracle apart by {grad_rel} "
                                     f"(limit {limit})")
            tokens, targets = (trainer._to_device(a)
                               for a in trainer._sample_batch(0))
            with torch.no_grad():
                first = float(lm_loss(
                    trainer.model, trainer.state["params"], tokens, targets,
                    attn_fn=get_attn_fn("flash"),
                    compute_dtype=trainer._compute_dtype))
            eval_before = trainer.evaluate()
            _kernels.reset_launches()
            t0 = time.perf_counter()
            result = trainer.train()
            if on_card:
                torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
            launches = dict(_kernels.launches)
            for name in _kernels.KERNELS:
                want = (LM_PER_STEP[name] * LM_HEAD_DIM_STEPS
                        + LM_PER_EVAL[name]
                        if name in LM_PER_STEP and on_card else 0)
                if launches[name] != want:
                    raise AssertionError(f"{what}: {name} launched "
                                         f"{launches[name]} times, want "
                                         f"{want}")
            if not result.eval_loss < eval_before:
                raise AssertionError(f"{what}: held-out loss {eval_before} "
                                     f"before the steps, {result.eval_loss} "
                                     f"after (first step's loss {first}, "
                                     f"last {result.final_loss})")
            for name in FLASH_KERNELS:
                total[name] += launches[name]
            emit({"phase": "lm_head_dims", "dtype": dtype,
                  "dim": LM_HEAD_DIM, "heads": trainer.model.heads,
                  "kv_heads": trainer.model.n_kv,
                  "head_dim": trainer.model.head_dim,
                  "steps": result.steps_run, "first_loss": first,
                  "logged_losses": {r["step"]: r["loss"] for r in metrics.rows
                                    if r["event"] == "train"},
                  "loss": result.final_loss, "eval_loss": result.eval_loss,
                  "eval_loss_before": eval_before,
                  "step_ms": 1e3 * cfg.batch_size * cfg.seq_len
                  / result.tokens_per_s, "wall_s": wall_s, "init_s": init_s,
                  "first_grad_rel_l2_max": worst,
                  "first_grad_rel_l2_tolerance": limit,
                  "launches": {k: launches[k] for k in FLASH_KERNELS},
                  "per_step": LM_PER_STEP, "per_eval": LM_PER_EVAL})
            del trainer, tokens, targets
            if on_card:
                torch.cuda.empty_cache()
    emit({"phase": "lm_head_dims", "launches": total,
          "seconds": time.perf_counter() - t_phase})
    if on_card:
        torch.cuda.empty_cache()
    return total


def moe_route_spy(moe, force: list | None = None):
    """Wraps `moe.route_probs` and `moe._dispatch` for one forward: per
    MoE layer, the router's probabilities and its own choices, and the
    (token, choice) assignments dropped at capacity. With `force` (the
    choices of an earlier forward's layers, in order) each layer routes
    by those choices instead, its gates taken from its own probabilities
    as `route_probs` takes them. Returns (records, undo)."""
    real_probs, real_dispatch = moe.route_probs, moe._dispatch
    rec = {"probs": [], "idx": [], "drops": []}

    def probs(x, gate_w, k):
        p, idx, gates = real_probs(x, gate_w, k)
        rec["probs"].append(p.detach().reshape(-1, p.shape[-1]))
        rec["idx"].append(idx.reshape(-1, k))
        if force is not None:
            idx = force[len(rec["idx"]) - 1].reshape(idx.shape)
            vals = p.gather(-1, idx)
            gates = vals if k == 1 else vals / vals.sum(-1, keepdim=True)
        return p, idx, gates

    def dispatch(idx, *args, **kw):
        d, g = real_dispatch(idx, *args, **kw)
        rec["drops"].append(idx.numel() - int(d.float().sum().item()))
        return d, g

    moe.route_probs, moe._dispatch = probs, dispatch

    def undo():
        moe.route_probs, moe._dispatch = real_probs, real_dispatch

    return rec, undo


def routing_ties(own: dict, forced: list) -> dict:
    """Where a forward routed by `forced` choices (`moe_route_spy` with
    force) would have chosen otherwise by its own probabilities: each
    such choice must be a tie, the two probabilities within
    MOE_ROUTE_TIE."""
    flips, gaps = 0, []
    for oi, fi, op in zip(own["idx"], forced, own["probs"], strict=True):
        rows, cols = (oi != fi).nonzero(as_tuple=True)
        flips += len(rows)
        for r, c in zip(rows.tolist(), cols.tolist()):
            gap = (op[r, oi[r, c]] - op[r, fi[r, c]]).abs().item()
            gaps.append(gap)
            if gap > MOE_ROUTE_TIE:
                raise AssertionError(f"lm_moe: a routing choice differs "
                                     f"with probabilities {gap} apart")
    return {"choices_differ": flips, "gaps": gaps[:16]}


def cuda_sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(torch, dev):
    """The device's peak allocated bytes since `reset_peak` (None on the
    CPU, where the rehearsals run)."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else None


def moe_grads(torch, trainer, rows: int, chunk: int, attn: str,
              lm_loss, get_attn_fn, tree_leaves, force=None):
    """(gradients, the routers' `moe_route_spy` records, peak bytes) of
    step 0's first `rows` rows at the trainer's params, routed in chunks
    of `chunk` tokens (0: the whole batch at once), by `force`'s choices
    where given."""
    from mpi_cuda_cnn_tpu_torch.parallel import moe

    tokens, targets = (trainer._to_device(a[:rows])
                       for a in trainer._sample_batch(0))
    rec, undo = moe_route_spy(moe, force)
    reset_peak(torch, trainer.device)
    try:
        loss = lm_loss(trainer.model, trainer.state["params"], tokens,
                       targets, attn_fn=get_attn_fn(attn),
                       compute_dtype=trainer._compute_dtype,
                       moe_dispatch_chunk=chunk)
        grads = torch.autograd.grad(loss,
                                    tree_leaves(trainer.state["params"]))
    finally:
        undo()
    cuda_sync(torch, trainer.device)
    return grads, rec, peak_bytes(torch, trainer.device)


def rel_l2_per_leaf(got, want) -> dict:
    return {i: ((a - b).norm() / b.norm().clamp_min(1e-30)).item()
            for i, (a, b) in enumerate(zip(got, want, strict=True))}


def phase_lm_moe(torch, dev=None):
    """LM_MOE's (a)-(d) (see LM_MOE_ARGS) on `dev` (the card; the CPU to
    rehearse, with LM_MODEL_ARGS small and LM_PER_STEP / LM_PER_EVAL
    zeros). Returns (the launches of (a)'s `train`, the trained bf16 MoE
    trainer)."""
    import math

    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.lm import (
        count_params,
        get_attn_fn,
        lm_flops_per_token,
        lm_loss,
    )
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    dev = dev or torch.device("cuda")
    on_card = dev.type == "cuda"
    smi = nvidia_smi() if on_card else "cpu"
    where = ["--device", dev.type]
    # (a) `lm` in bf16, flash, chunked routing.
    cfg = parse_lm_args(LM_MOE_TRAIN_ARGS + where)
    metrics = MetricsLogger(echo=False, capture=True)
    trainer = LMTrainer(cfg, metrics=metrics)
    if trainer.attn_impl != "flash" or trainer.device.type != dev.type:
        raise AssertionError(f"lm_moe: {trainer.attn_impl} on "
                             f"{trainer.device}")
    tokens, targets = (trainer._to_device(a) for a in trainer._sample_batch(0))
    with torch.no_grad():
        first = float(lm_loss(trainer.model, trainer.state["params"], tokens,
                              targets, attn_fn=get_attn_fn("flash"),
                              compute_dtype=trainer._compute_dtype,
                              moe_dispatch_chunk=LM_MOE_CHUNK))
    reset_peak(torch, dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    result = trainer.train()
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    peak = peak_bytes(torch, dev)
    for name in _kernels.KERNELS:
        want = (LM_PER_STEP[name] * LM_MOE_STEPS + LM_PER_EVAL[name]
                if name in LM_PER_STEP else 0)
        if launches[name] != want:
            raise AssertionError(f"lm_moe: {name} launched {launches[name]} "
                                 f"times, want {want}")
    if not (math.isfinite(result.eval_loss)
            and math.isfinite(result.final_loss)
            and result.final_loss < LM_LOSS_DROP * first):
        raise AssertionError(f"lm_moe: first loss {first}, final "
                             f"{result.final_loss}, eval {result.eval_loss}")
    model = trainer.model
    tokens_per_step = cfg.batch_size * cfg.seq_len
    step_s = tokens_per_step / result.tokens_per_s
    flops = lm_flops_per_token(model, cfg.seq_len) * tokens_per_step
    emit({"phase": "lm_moe", "part": "a_train", "nvidia_smi": smi,
          "dtype": "bfloat16", "moe_dispatch_chunk": LM_MOE_CHUNK,
          "steps": result.steps_run, "first_loss": first,
          "logged_losses": {r["step"]: r["loss"] for r in metrics.rows},
          "loss": result.final_loss, "eval_loss": result.eval_loss,
          "tokens_per_s": result.tokens_per_s, "step_ms": 1e3 * step_s,
          "mfu": flops / step_s / BF16_FLOPS, "flops_per_step": flops,
          "peak_memory_bytes": peak, "wall_s": wall_s,
          "vocab": model.vocab, "params": count_params(trainer.state["params"]),
          "launches": launches, "per_step": LM_PER_STEP,
          "per_eval": LM_PER_EVAL, "loss_drop": LM_LOSS_DROP})

    # (b) float32, chunk 512: flash against the oracle, first gradients.
    f32 = LMTrainer(parse_lm_args(LM_MOE_ARGS + where + [
        "--attn-impl", "flash", "--moe-dispatch-chunk", str(LM_MOE_CHUNK)]),
        metrics=MetricsLogger(echo=False))
    batch = f32.cfg.batch_size
    g_flash, r_flash, peak_chunk = moe_grads(
        torch, f32, batch, LM_MOE_CHUNK, "flash", lm_loss, get_attn_fn,
        tree_leaves)
    g_oracle, r_oracle, _ = moe_grads(torch, f32, batch, LM_MOE_CHUNK,
                                      "oracle", lm_loss, get_attn_fn,
                                      tree_leaves, force=r_flash["idx"])
    rel = rel_l2_per_leaf(g_flash, g_oracle)
    ties = routing_ties(r_oracle, r_flash["idx"])
    del g_oracle, r_oracle
    empty_cache(torch, dev)
    if not max(rel.values()) <= LM_MOE_GRAD_REL_L2:
        raise AssertionError(f"lm_moe: float32 chunked first gradients of "
                             f"flash and the oracle apart by {rel}")
    emit({"phase": "lm_moe", "part": "b_f32_flash_vs_oracle",
          "first_grad_rel_l2": rel, "max": max(rel.values()),
          "tolerance": LM_MOE_GRAD_REL_L2, "oracle_routing_ties": ties,
          "dropped": sum(r_flash["drops"]),
          "peak_memory_bytes": peak_chunk})

    # (c) float32, unchunked: the largest batch whose reckoned peak fits.
    # The reckoning: (b)'s measured chunked peak scaled to the batch, plus
    # unchunked routing's (T, E, C) float32 tensors
    # (LM_MOE_ROUTING_BYTES_PER_T2 x T^2, T = batch x seq). At batch 8
    # (T 16,384) those alone are about 51 GB.
    card = (torch.cuda.get_device_properties(dev).total_memory if on_card
            else float("inf"))
    reckoned = {b: (peak_chunk or 0) * b / batch
                + LM_MOE_ROUTING_BYTES_PER_T2 * (b * f32.cfg.seq_len) ** 2
                for b in LM_MOE_BATCHES}
    rows = next(b for b in LM_MOE_BATCHES
                if reckoned[b] <= LM_MOE_MEMORY_SHARE * card)
    g_whole, r_whole, peak_whole = moe_grads(
        torch, f32, rows, 0, "flash", lm_loss, get_attn_fn, tree_leaves)
    g_chunk, r_rows, _ = moe_grads(
        torch, f32, rows, LM_MOE_CHUNK, "flash", lm_loss, get_attn_fn,
        tree_leaves)
    drops_whole, drops_rows = sum(r_whole["drops"]), sum(r_rows["drops"])
    rel = rel_l2_per_leaf(g_whole, g_chunk)
    del g_whole, g_chunk, g_flash, r_flash, r_whole, r_rows
    empty_cache(torch, dev)
    if drops_whole == 0 and drops_rows == 0 \
            and not max(rel.values()) <= LM_MOE_GRAD_REL_L2:
        raise AssertionError(f"lm_moe: nothing dropped, yet unchunked and "
                             f"chunked gradients apart by {rel}")
    emit({"phase": "lm_moe", "part": "c_f32_unchunked", "batch": rows,
          "card_bytes": card, "reckoned_peak_bytes": reckoned,
          "measured_peak_bytes": peak_whole,
          "dropped": {"unchunked": drops_whole, "chunk512": drops_rows},
          "grad_rel_l2_unchunked_vs_chunk512": rel,
          "held": drops_whole == 0 and drops_rows == 0,
          "tolerance": LM_MOE_GRAD_REL_L2})
    del f32
    empty_cache(torch, dev)

    # (d) lm-bench rows and the per-layer split.
    phase_lm_moe_bench(torch, rows, dev)
    phase_moe_split(torch, dev)
    return launches, trainer


def empty_cache(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def phase_lm_moe_bench(torch, f32_rows: int, dev) -> None:
    """`lm-bench --moe-experts 8 --moe-top-k 2`: bf16 + flash, chunked
    (512) and unchunked (`--quick`); float32 + flash chunked at batch 8
    and unchunked at `f32_rows` (the function its rows run). Each row's
    peak memory; K7/K8/K9 13 x 8 a row."""
    import math

    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.lm import lm_flops_per_token
    from mpi_cuda_cnn_tpu_torch.train.lm_bench import bench_config, lm_bench

    want = LM_BENCH_STEPS * lm_bench_args(LM_MOE_BENCH_ARGS).depth
    for chunk in (LM_MOE_CHUNK, 0):
        out = lm_bench(LM_MOE_BENCH_ARGS + [
            "--quick", "--moe-dispatch-chunk", str(chunk),
            "--device", dev.type])
        (line,) = out["lines"]
        if (set(line["kernel_launches"].values()) != {want}
                or not math.isfinite(line["loss"])):
            raise AssertionError(f"lm_moe bench: {line}")
        emit({"phase": "lm_moe", "part": "d_bench", **line,
              "moe_dispatch_chunk": chunk,
              "batch": lm_bench_args(LM_MOE_BENCH_ARGS).batch,
              "model": out["summary"]["model"],
              "params": out["summary"]["params"]})
    args = lm_bench_args(LM_MOE_BENCH_ARGS)
    for chunk, rows in ((LM_MOE_CHUNK, args.batch), (0, f32_rows)):
        model = TransformerLM(vocab=args.vocab, dim=args.dim,
                              heads=args.heads, depth=args.depth,
                              max_seq=args.seq, moe_experts=args.moe_experts,
                              moe_top_k=args.moe_top_k)
        reset_peak(torch, dev)
        _kernels.reset_launches()
        dt, loss = bench_config(model, batch=rows, seq=args.seq,
                                compute_dtype=None, attn_impl="flash",
                                device=dev, steps=args.steps,
                                moe_dispatch_chunk=chunk)
        launches = {k: _kernels.launches[k] for k in FLASH_KERNELS}
        if set(launches.values()) != {want} or not math.isfinite(loss):
            raise AssertionError(f"lm_moe bench f32: {launches}, {loss}")
        flops = lm_flops_per_token(model, args.seq) * rows * args.seq
        emit({"phase": "lm_moe", "part": "d_bench", "bench": "lm_pretrain",
              "dtype": "float32", "attn": "flash", "moe_dispatch_chunk": chunk,
              "batch": rows, "step_ms": dt * 1e3,
              "tokens_per_s": rows * args.seq / dt,
              "mfu": flops / dt / F32_FLOPS, "loss": loss,
              "peak_memory_bytes": peak_bytes(torch, dev),
              "kernel_launches": launches})
        empty_cache(torch, dev)


def lm_bench_args(argv: list[str]):
    from mpi_cuda_cnn_tpu_torch.train import lm_bench

    return lm_bench._parser().parse_args(argv)


def phase_moe_split(torch, dev) -> None:
    """torch.profiler over one MoE layer (the flagship's: 16,384 tokens,
    d 512, 8 experts, top-2), in float32 and bf16, chunked (512) and not:
    a forward alone, whose kernels give each of the reference's stages
    (router build, dispatch einsum, expert FFN, combine: the kernels
    launched inside each named range) and the forward's total, then a
    forward and backward, whose kernels less the forward's are the
    backward's. The named ranges' own rows are left out of the kernel
    sums (the profiler lists each range on the device as well)."""
    from torch.profiler import ProfilerActivity, profile

    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.parallel import moe

    gen = torch.Generator().manual_seed(0)
    args = lm_bench_args(LM_MOE_BENCH_ARGS)
    d, e, t = args.dim, args.moe_experts, args.batch * args.seq
    params0 = moe.init_moe_params(prng.key(0), d, 4 * d, e)
    x0 = torch.randn(t, d, generator=gen)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])

    def device_us(ev, total: bool) -> float:
        name = "device_time_total" if total else "self_device_time_total"
        return getattr(ev, name, getattr(ev, name.replace("device",
                                                          "cuda"), 0))

    def profiled(fn):
        """(kernel us, stage us) of MOE_SPLIT_RUNS calls of fn."""
        with profile(activities=activities) as prof:
            for _ in range(MOE_SPLIT_RUNS):
                fn()
            cuda_sync(torch, dev)
        rows = prof.key_averages()
        kernels = sum(device_us(ev, False) for ev in rows
                      if ev.key not in MOE_SPLIT_STAGES
                      and str(getattr(ev, "device_type", "")).endswith("CUDA"))
        stages = {}
        for ev in rows:
            if ev.key in MOE_SPLIT_STAGES:
                stages[ev.key] = max(stages.get(ev.key, 0.0),
                                     device_us(ev, True))
        return kernels, stages

    for dtype in (torch.float32, torch.bfloat16):
        for chunk in (LM_MOE_CHUNK, 0):
            params = {k: v.to(dev, dtype).requires_grad_(True)
                      for k, v in params0.items()}
            x = x0.to(dev, dtype).requires_grad_(True)

            def forward():
                return moe.moe_mlp(x, params, n_experts=e, top_k=2,
                                   dispatch_chunk=chunk)

            def step():
                y, aux = forward()
                torch.autograd.grad(y.float().square().mean() + aux,
                                    [x, *params.values()])

            for _ in range(2):
                step()
            reset_peak(torch, dev)
            t0 = time.perf_counter()
            for _ in range(MOE_SPLIT_RUNS):
                step()
            cuda_sync(torch, dev)
            step_ms = 1e3 * (time.perf_counter() - t0) / MOE_SPLIT_RUNS
            fwd_us, stage_us = profiled(forward)
            all_us, _ = profiled(step)
            per = 1e3 * MOE_SPLIT_RUNS
            emit({"phase": "lm_moe", "part": "d_split",
                  "dtype": str(dtype).split(".")[-1],
                  "moe_dispatch_chunk": chunk, "tokens": t,
                  "step_ms": step_ms,
                  "stage_device_ms": {k: v / per for k, v in stage_us.items()},
                  "forward_device_ms": fwd_us / per,
                  "backward_device_ms": (all_us - fwd_us) / per,
                  "step_device_ms": all_us / per,
                  "peak_memory_bytes": peak_bytes(torch, dev)})
            del params, x
            empty_cache(torch, dev)


def tokens_agree(torch, what: str, got, want, logits_at) -> dict:
    """Two 1-d token runs: equal, or equal up to a first difference t at
    which logits_at(t) (the plain run's sampling scores there) has its
    top two within TIE_GAP."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    diff = np.flatnonzero(got != want)
    if not len(diff):
        return {"tokens": len(want), "equal": len(want)}
    t = int(diff[0])
    top2 = torch.topk(logits_at(t), 2).values
    gap = float(top2[0] - top2[1])
    if gap > TIE_GAP:
        raise AssertionError(f"{what}: token {t} is {got[t]} against "
                             f"{want[t]}, top-2 gap {gap} > {TIE_GAP}")
    return {"tokens": len(want), "equal": t, "first_difference": t,
            "top2_gap": gap}


def generate_checks(torch, name: str, trainer) -> dict:
    """GEN_TOKENS greedy tokens through `trainer.sample` with int8 decode
    weights (K2 launches held per token), against the plain path; lookup
    with k GEN_LOOKUP_K against generate; a sampled run against its
    plain twin."""
    import dataclasses

    import numpy as np

    from mpi_cuda_cnn_tpu_torch.data import prng
    from mpi_cuda_cnn_tpu_torch.models import generate as gen
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.ops.gemv import (
        dequantize_decode_params,
        quantize_decode_params,
    )

    trainer.cfg = dataclasses.replace(trainer.cfg,
                                      decode_weights_dtype="int8",
                                      decode_cache_dtype="float32")
    model, dev = trainer.model, trainer.device
    cuda_sync(torch, dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    prompt_np, toks = trainer.sample(GEN_TOKENS)
    cuda_sync(torch, dev)
    sample_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    want = {k: 0 for k in _kernels.KERNELS}
    want["int8_gemm"] = GEN_K2_PER_TOKEN[name] * GEN_TOKENS
    if launches != want:
        raise AssertionError(f"generate {name}: launches {launches}, want "
                             f"{want}")
    prompt = torch.from_numpy(prompt_np.astype(np.int64))[None].to(dev)
    q = quantize_decode_params(trainer.state["params"], "int8")
    plain = dequantize_decode_params(q)

    def plain_logits(ctx_tokens):
        ctx = torch.cat([prompt, torch.as_tensor(
            np.asarray(ctx_tokens, np.int64), device=dev)[None]], 1)
        with torch.no_grad():
            return gen.prefill(model, plain, ctx, "float32")[0][0]

    def timed(params):
        """(tokens, ms a token) of a warmed greedy run."""
        gen.generate(model, params, prompt, 2)
        cuda_sync(torch, dev)
        t0 = time.perf_counter()
        out = gen.generate(model, params, prompt, GEN_TOKENS)[0].cpu().numpy()
        return out, 1e3 * (time.perf_counter() - t0) / GEN_TOKENS

    again, greedy_ms = timed(q)
    ref, plain_ms = timed(plain)
    if not np.array_equal(again, toks):
        raise AssertionError(f"generate {name}: two K2 runs differ")
    greedy = tokens_agree(torch, f"generate {name} K2 vs plain", toks, ref,
                          lambda t: plain_logits(ref[:t]))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    look, stats = gen.lookup_speculative_generate(
        model, q, prompt, GEN_TOKENS, k=GEN_LOOKUP_K, return_stats=True)
    cuda_sync(torch, dev)
    lookup_ms = 1e3 * (time.perf_counter() - t0) / GEN_TOKENS
    look_launches = _kernels.launches["int8_gemm"]
    look = look[0].cpu().numpy()
    lookup = tokens_agree(torch, f"lookup {name} vs generate", look, toks,
                          lambda t: plain_logits(toks[:t]))
    key = prng.key(GEN_SEED)
    sampled = gen.generate(model, q, prompt, GEN_TOKENS,
                           temperature=GEN_TEMPERATURE, key=key)
    sampled = sampled[0].cpu().numpy()
    sampled_plain = gen.generate(model, plain, prompt, GEN_TOKENS,
                                 temperature=GEN_TEMPERATURE, key=key)
    sampled_plain = sampled_plain[0].cpu().numpy()
    noise = gen.sample_noise(key, GEN_TOKENS, (1, model.vocab))

    def sampled_scores(t):
        lg = gen.filter_logits(plain_logits(sampled_plain[:t])
                               / GEN_TEMPERATURE)
        return lg + torch.from_numpy(noise[t, 0]).to(dev)

    temp = tokens_agree(torch, f"sampled {name} K2 vs plain", sampled,
                        sampled_plain, sampled_scores)
    return {"model": name, "prompt_tokens": int(prompt.shape[1]),
            "tokens": GEN_TOKENS, "k2_launches": launches["int8_gemm"],
            "k2_per_token": launches["int8_gemm"] / GEN_TOKENS,
            "sample_s": sample_s, "greedy_ms_per_token": greedy_ms,
            "plain_ms_per_token": plain_ms,
            "greedy_vs_plain": greedy,
            "lookup": {"k": GEN_LOOKUP_K, **stats,
                       "ms_per_token": lookup_ms,
                       "k2_launches": look_launches, "vs_generate": lookup},
            "sampled": {"temperature": GEN_TEMPERATURE, "seed": GEN_SEED,
                        "vs_plain": temp},
            "continuation_head": [int(t) for t in toks[:16]]}


def phase_generate(torch, dense, moe_trainer) -> dict:
    """The generate phase (see GEN_TOKENS). Returns the launches of its
    K1 and K2 paths (sampling and the MoE engine)."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import make_workload
    from mpi_cuda_cnn_tpu_torch.serve.engine import PagedEngine

    dev = moe_trainer.device
    smi = nvidia_smi() if dev.type == "cuda" else "cpu"
    k2 = 0
    for name, trainer in (("dense", dense), ("moe", moe_trainer)):
        out = generate_checks(torch, name, trainer)
        k2 += out["k2_launches"] + out["lookup"]["k2_launches"]
        emit({"phase": "generate", "nvidia_smi": smi, **out})
    model = moe_trainer.model
    args = serve_args()
    eng = PagedEngine(model, moe_trainer.state["params"], slots=args.slots,
                      num_pages=args.slots * (args.max_seq // args.page_size)
                      + 1, page_size=args.page_size,
                      prefill_chunk=args.prefill_chunk, cache_dtype="int8",
                      max_len=model.max_seq, attn_kernel="cuda",
                      weights_dtype="int8", device=dev)
    cuda_sync(torch, dev)
    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(make_workload(**GEN_SERVE), mode="continuous")
    cuda_sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    forwards = res.decode_ticks + res.prefill_chunks
    per_forward = {"paged_attention": model.depth,
                   "int8_gemm": 2 * model.depth + 1}
    if dev.type != "cuda":          # the CPU launches no kernel
        per_forward = {k: 0 for k in per_forward}
    for name_, k in per_forward.items():
        if launches[name_] != k * forwards:
            raise AssertionError(f"generate moe engine: {name_} "
                                 f"{launches[name_]} launches, want {k} x "
                                 f"{forwards} forwards")
    plain = plain_engine(eng)
    replay = plain.run(make_workload(**GEN_SERVE), mode="continuous")
    agree = agree_requests(torch, eng, plain, res.requests, replay.requests)
    emit({"phase": "generate", "part": "moe_engine", "nvidia_smi": smi,
          "cache_dtype": str(eng.cache_dtype), "weights_dtype": "int8",
          "requests": len(res.requests), "forwards": forwards,
          "launches": {k: launches[k] for k in per_forward},
          "per_forward": per_forward, "wall_s": wall_s,
          "state_crc": res.state_crc, "agree": agree})
    return {"paged_attention": launches["paged_attention"],
            "int8_gemm": k2 + launches["int8_gemm"]}


def serve_args():
    from mpi_cuda_cnn_tpu_torch.serve import bench as serve_bench

    return serve_bench._parser().parse_args(SERVE_ARGS)


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
    """LM_AGREE_ARGS' 5 float32 steps from one init, attention on the
    kernels and on the oracle; the first step's gradients, per-step
    losses and final params held to the stated tolerances. Then the
    first step's gradients in bf16 compute, per leaf, flash against the
    oracle from one init."""
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.train.lm import get_attn_fn, lm_loss
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    runs, grad_rel = {}, None
    for impl in ("flash", "oracle"):
        cfg = parse_lm_args(LM_AGREE_ARGS + ["--attn-impl", impl])
        metrics = MetricsLogger(echo=False, capture=True)
        trainer = LMTrainer(cfg, metrics=metrics)
        if grad_rel is None:
            grad_rel = first_grads_rel_l2(torch, trainer, get_attn_fn, lm_loss,
                                          tree_leaves)
        result = trainer.train()
        runs[impl] = ([r["loss"] for r in metrics.rows], result,
                      [t.detach() for t in tree_leaves(trainer.state["params"])])
        del trainer
        torch.cuda.empty_cache()
    trainer = LMTrainer(parse_lm_args(LM_AGREE_ARGS + [
        "--attn-impl", "flash", "--compute-dtype", "bfloat16"]),
        metrics=MetricsLogger(echo=False, capture=True))
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


def steps_run(records: list) -> int:
    """The steps a rank entry's records say it ran over all its attempts,
    replayed steps included: each epoch record's steps, and the steps an
    attempt ran before an injected crash or a preemption ended it (from
    0, or from the step it resumed at)."""
    n = pos = 0
    for f in records:
        event = f["event"]
        if event == "ckpt" and f["reason"] == "resume":
            pos = f["step"]
        elif event == "epoch":
            n += f["steps"]
            pos += f["steps"]
        elif event == "fault" and (f["kind"] == "preempt" or (
                f["kind"] == "injected_crash" and f["site"] == "train.step")):
            end = f["step"] if f["kind"] == "preempt" else f["at"]
            n, pos = n + end - pos, end
    return n


def faults_of(records: list) -> list[str]:
    return [f["kind"] for f in records if f["event"] == "fault"]


def check_launches(what: str, launches: dict, steps: int, evals: int,
                   per_step: dict, per_eval: dict) -> dict:
    """Every kernel launched per_step times a step and per_eval times an
    eval batch (the others not at all). Returns the launches."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    for name in _kernels.KERNELS:
        want = (per_step.get(name, 0) * steps + per_eval.get(name, 0) * evals)
        if launches.get(name, 0) != want:
            raise AssertionError(f"{what}: {name} launched "
                                 f"{launches.get(name, 0)} times over "
                                 f"{steps} steps and {evals} eval batches, "
                                 f"want {want}")
    return {k: launches.get(k, 0) for k in _kernels.KERNELS
            if per_step.get(k) or per_eval.get(k)}


def recover_cnn(torch, what: str, cfg, data: dict, *, want_exit: int = 0,
                want_steps: int) -> dict:
    """One run of the train command's rank entry with the launch counts
    zeroed just before and read just after: its exit code, steps (from
    its records) and launches held; returns the result, wall seconds and
    launches."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank

    _kernels.reset_launches()
    t0 = time.perf_counter()
    res = cnn_rank(None, cfg, data)
    if cfg.device != "cpu":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = steps_run(res["records"])
    if res["exit"] != want_exit or steps != want_steps:
        raise AssertionError(f"recover {what}: exit {res['exit']} after "
                             f"{steps} steps, want {want_exit} after "
                             f"{want_steps}; faults "
                             f"{faults_of(res['records'])}")
    launches = check_launches(f"recover {what}", dict(_kernels.launches),
                              steps, int(want_exit == 0), PER_STEP, PER_EVAL)
    return {"res": res, "wall_s": wall, "launches": launches, "steps": steps}


def same_params(what: str, got: list, want: list) -> None:
    import numpy as np

    if not all(np.array_equal(a, b) for a, b in zip(got, want, strict=True)):
        worst = max(float(np.abs(a - b).max()) for a, b in zip(got, want))
        raise AssertionError(f"{what}: params differ from the uninterrupted "
                             f"run by up to {worst}, want bit for bit")


def checkpoint_times(torch, arrays: dict, template_of, install, directory,
                     reps: int) -> dict:
    """Median ms of `reps` saves of `arrays` (a trainer's checkpoint
    arrays) on the background writer: the blocking part (the host copy)
    and the write; then of `restore_latest` (read and verify) and of
    installing what it read (`install`, then a sync)."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.train.checkpoint import (
        AsyncCheckpointer,
        restore_latest,
    )

    save, write, restore, put = [], [], [], []
    ck = AsyncCheckpointer(directory, async_=True)
    for step in range(1, reps + 1):
        ck.save(arrays, step)
        save.append(1e3 * ck.save_s)
        ck.wait()
        write.append(1e3 * ck.write_s)
    ck.close()
    nbytes = sum(int(np.prod(np.shape(v))) * 4 for v in arrays.values())
    for _ in range(reps):
        t0 = time.perf_counter()
        restored, path = restore_latest(directory, template_of())
        restore.append(1e3 * (time.perf_counter() - t0))
        t0 = time.perf_counter()
        install(restored)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        put.append(1e3 * (time.perf_counter() - t0))
    return {"state_bytes": nbytes, "file_bytes": path.stat().st_size,
            "save_blocking_ms": statistics.median(save),
            "write_ms": statistics.median(write),
            "restore_latest_ms": statistics.median(restore),
            "install_ms": statistics.median(put), "reps": reps}


def phase_recover_cnn(torch, dev, smi: str, tmp: Path) -> dict:
    """recover's CNN runs (a)-(e) through the train command's rank
    entry, and the CNN state's save, write and restore times."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.convert import load_checkpoint_arrays
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.train.checkpoint import restore_checkpoint
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.config import Config
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    data = dict(num_train=AGREE_STEPS * CNN_BATCH, num_test=RECOVER_TEST)

    def cfg(name: str, **kw):
        return Config(**{**dict(
            model="reference_cnn", epochs=1, batch_size=CNN_BATCH, lr=0.1,
            seed=0, device=str(dev), use_kernels=True, log_every=0,
            eval_every=0, checkpoint_dir=str(tmp / name),
            checkpoint_every_steps=RECOVER_EVERY), **kw})

    # (a) two uninterrupted runs, bit for bit
    a1 = recover_cnn(torch, "(a) first", cfg("a1"), data,
                     want_steps=AGREE_STEPS)
    a2 = recover_cnn(torch, "(a) second", cfg("a2"), data,
                     want_steps=AGREE_STEPS)
    want = a1["res"]["params"]
    same_params("recover (a)", a2["res"]["params"], want)
    # (b) a crash after step RECOVER_CRASH, one restart from the last save
    b = recover_cnn(torch, "(b)", cfg(
        "b", fault_plan=f"crash@train.step:{RECOVER_CRASH}", max_restarts=1),
        data, want_steps=RECOVER_CRASH + AGREE_STEPS
        - RECOVER_CRASH // RECOVER_EVERY * RECOVER_EVERY)
    resumed_at = [f["step"] for f in b["res"]["records"]
                  if f["event"] == "ckpt"]
    if faults_of(b["res"]["records"]) != ["injected_crash", "restart"] \
            or resumed_at != [RECOVER_CRASH // RECOVER_EVERY * RECOVER_EVERY]:
        raise AssertionError(f"recover (b): faults "
                             f"{faults_of(b['res']['records'])}, resumed at "
                             f"{resumed_at}")
    same_params("recover (b)", b["res"]["params"], want)
    # (c) a preemption: exit 75 with its snapshot, then --resume
    c1 = recover_cnn(torch, "(c) preempted", cfg(
        "c", fault_plan=f"preempt@train.step:{RECOVER_PREEMPT}"), data,
        want_exit=75, want_steps=RECOVER_PREEMPT)
    if not (tmp / "c" / f"ckpt_{RECOVER_PREEMPT}.npz").exists():
        raise AssertionError("recover (c): no snapshot at the preemption")
    c2 = recover_cnn(torch, "(c) resumed", cfg("c", resume=True), data,
                     want_steps=AGREE_STEPS - RECOVER_PREEMPT)
    same_params("recover (c)", c2["res"]["params"], want)
    # (d) one byte of the newest checkpoint flipped: --resume falls back
    newest = tmp / "a2" / f"ckpt_{AGREE_STEPS}.npz"
    raw = bytearray(newest.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    newest.write_bytes(bytes(raw))
    d = recover_cnn(torch, "(d)", cfg("a2", resume=True), data,
                    want_steps=RECOVER_EVERY)
    if faults_of(d["res"]["records"]) != ["ckpt_fallback"]:
        raise AssertionError(f"recover (d): faults "
                             f"{faults_of(d['res']['records'])}")
    same_params("recover (d)", d["res"]["params"], want)
    # (e) a NaN batch under --nan-policy skip: the update is dropped. A
    # preemption one step later keeps the checkpoints either side of it.
    e1 = recover_cnn(torch, "(e) poisoned", cfg(
        "e", nan_policy="skip", checkpoint_every_steps=1,
        fault_plan=(f"nan@train.batch:{RECOVER_NAN};"
                    f"preempt@train.step:{RECOVER_NAN + 1}")), data,
        want_exit=75, want_steps=RECOVER_NAN + 1)
    tr = Trainer(get_model("reference_cnn"), synthetic_stripes(**data),
                 cfg("e"), metrics=MetricsLogger(echo=False))
    before, after = (restore_checkpoint(tmp / "e" / f"ckpt_{s}.npz",
                                        tr.recovery.arrays(tr.state))
                     for s in (RECOVER_NAN, RECOVER_NAN + 1))
    dropped = all(np.array_equal(before[k], after[k]) for k in before
                  if k.startswith("params/"))
    e2 = recover_cnn(torch, "(e) resumed", cfg("e", nan_policy="skip",
                                               resume=True), data,
                     want_steps=AGREE_STEPS - RECOVER_NAN - 1)
    skips = faults_of(e1["res"]["records"]).count("nonfinite_step") + \
        faults_of(e2["res"]["records"]).count("nonfinite_step")
    finite = all(np.isfinite(p).all() for p in e2["res"]["params"])
    if not (dropped and skips == 1 and finite
            and (int(before["step"]), int(after["step"]))
            == (RECOVER_NAN, RECOVER_NAN + 1) and e2["res"]["step"]
            == AGREE_STEPS):
        raise AssertionError(f"recover (e): update dropped {dropped}, "
                             f"steps {int(before['step'])} -> "
                             f"{int(after['step'])}, {skips} skips, final "
                             f"step {e2['res']['step']}, finite {finite}")
    times = checkpoint_times(
        torch, tr.recovery.arrays(tr.state),
        lambda: tr.recovery.arrays(tr.state),
        lambda a: load_checkpoint_arrays(tr.state, a, tr.optimizer),
        tmp / "times_cnn", RECOVER_TIMING_REPS)
    return {"card": smi, "steps": AGREE_STEPS, "every": RECOVER_EVERY,
            "bitwise": True, "wall_s": {
                "a": [a1["wall_s"], a2["wall_s"]], "b_supervised": b["wall_s"],
                "c": [c1["wall_s"], c2["wall_s"]], "d": d["wall_s"],
                "e": [e1["wall_s"], e2["wall_s"]]},
            "steps_run": {"a": a1["steps"], "b": b["steps"],
                          "c": [c1["steps"], c2["steps"]], "d": d["steps"],
                          "e": [e1["steps"], e2["steps"]]},
            "launches": {"a": a1["launches"], "b": b["launches"],
                         "c": [c1["launches"], c2["launches"]],
                         "d": d["launches"],
                         "e": [e1["launches"], e2["launches"]]},
            "per_step": PER_STEP, "per_eval": PER_EVAL,
            "b_resumed_at": resumed_at[0], "e_skips": skips,
            "checkpoint": times}


def phase_recover_lm(torch, dev, smi: str, tmp: Path) -> dict:
    """recover's LM runs: uninterrupted and crashed-and-restarted, per-step
    losses and final checkpoints bit for bit; and the save, write and
    restore times of the flagship's state at LM_RECOVER_TIMING_VOCAB."""
    import shutil

    import numpy as np

    from mpi_cuda_cnn_tpu_torch.convert import (
        checkpoint_arrays,
        load_checkpoint_arrays,
    )
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.train.lm import make_lm_state
    from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
    from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    runs = {}
    for name, extra in (("full", []), ("crash", [
            "--fault-plan", f"crash@train.step:{LM_RECOVER_CRASH}",
            "--max-restarts", "1"])):
        cfg = parse_lm_args(LM_RECOVER_ARGS + extra + [
            "--device", str(dev), "--checkpoint-dir", str(tmp / name)])
        _kernels.reset_launches()
        t0 = time.perf_counter()
        res = lm_rank(None, cfg)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        wall = time.perf_counter() - t0
        losses = [(f["step"], f["loss"]) for f in res["records"]
                  if f["event"] == "train"]
        launches = check_launches(f"recover lm {name}", dict(_kernels.launches),
                                  len(losses), 1, LM_PER_STEP, LM_PER_EVAL)
        runs[name] = {"res": res, "wall_s": wall, "losses": losses,
                      "launches": launches}
    full, crash = runs["full"]["losses"], runs["crash"]["losses"]
    by_step = dict(full)
    resumed = LM_RECOVER_CRASH // LM_RECOVER_EVERY * LM_RECOVER_EVERY
    want_steps = (list(range(1, LM_RECOVER_CRASH + 1))
                  + list(range(resumed + 1, LM_RECOVER_STEPS + 1)))
    if [s for s, _ in crash] != want_steps \
            or any(loss != by_step[s] for s, loss in crash) \
            or faults_of(runs["crash"]["res"]["records"]) \
            != ["injected_crash", "restart"]:
        raise AssertionError(f"recover lm: losses {crash} against {full}, "
                             f"faults "
                             f"{faults_of(runs['crash']['res']['records'])}")
    final = f"ckpt_{LM_RECOVER_STEPS}.npz"
    with np.load(tmp / "full" / final) as fa, \
            np.load(tmp / "crash" / final) as fb:
        if sorted(fa.files) != sorted(fb.files) or not all(
                np.array_equal(fa[k], fb[k]) for k in fa.files):
            raise AssertionError("recover lm: the final checkpoints differ")
        arrays = len(fa.files)
    for name in runs:
        shutil.rmtree(tmp / name)
    # The flagship's state at lm-bench's vocab (8192): params, AdamW's mu
    # and nu (3 x 34,620,416 floats), the counts and the step.
    model = TransformerLM(vocab=LM_RECOVER_TIMING_VOCAB, dim=cfg.dim,
                          heads=cfg.heads, depth=cfg.depth,
                          max_seq=cfg.seq_len)
    opt = make_optimizer(cfg.lr, opt="adamw", schedule=cfg.lr_schedule,
                         total_steps=cfg.steps, warmup_steps=cfg.warmup_steps,
                         weight_decay=cfg.weight_decay)
    state = make_lm_state(model, opt, cfg.seed, device=dev)
    times = {"vocab": LM_RECOVER_TIMING_VOCAB, **checkpoint_times(
        torch, checkpoint_arrays(state, opt),
        lambda: checkpoint_arrays(state, opt),
        lambda a: load_checkpoint_arrays(state, a, opt),
        tmp / "times_lm", RECOVER_TIMING_REPS)}
    del state
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"card": smi, "steps": LM_RECOVER_STEPS,
            "every": LM_RECOVER_EVERY, "crash_at": LM_RECOVER_CRASH,
            "resumed_at": resumed, "losses": crash, "bitwise": True,
            "final_checkpoint_arrays": arrays,
            "wall_s": {"full": runs["full"]["wall_s"],
                       "supervised": runs["crash"]["wall_s"]},
            "launches": {"full": runs["full"]["launches"],
                         "supervised": runs["crash"]["launches"]},
            "per_step": LM_PER_STEP, "checkpoint": times}


def phase_recover_dp(torch, dev, smi: str, tmp: Path) -> dict:
    """recover at world 2 (two gloo ranks on `dev`), the world supervised
    from this process as the `train` command supervises a spawned world
    (`train.ranks.supervise_world`): the uninterrupted run, and one under
    --max-restarts 2 with two planned crashes: after step RECOVER_CRASH
    on both ranks (the second world resumes from the checkpoint before),
    then in rank 0's save of step RECOVER_CKPT_CRASH (`ckpt.pre_rename`:
    rank 0 alone; the third world resumes from the one before that, the
    first crash, fired, not firing again); bit for bit the uninterrupted
    run on every rank, rank 0 the only writer, launches over the last
    world's steps, both crashes and the parent's two restarts in rank 0's
    run file."""
    import json

    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank, supervise_world
    from mpi_cuda_cnn_tpu_torch.utils.config import Config

    data = dict(num_train=AGREE_STEPS * CNN_BATCH, num_test=RECOVER_TEST)
    out = {}
    plan = (f"crash@train.step:{RECOVER_CRASH};"
            f"crash@ckpt.pre_rename:{RECOVER_CKPT_CRASH}")
    for name, kw in (("full", {}),
                     ("crash", dict(fault_plan=plan, max_restarts=2))):
        sink = tmp / f"{name}.jsonl"
        cfg = Config(model="reference_cnn", epochs=1, batch_size=CNN_BATCH,
                     lr=0.1, seed=0, device=str(dev), use_kernels=True,
                     log_every=0, eval_every=0, checkpoint_dir=str(tmp / name),
                     checkpoint_every_steps=RECOVER_EVERY,
                     metrics_jsonl=str(sink), **kw)
        t0 = time.perf_counter()
        ranks = supervise_world(cnn_rank, [dev] * DP_WORLD, (cfg, data))
        wall = time.perf_counter() - t0
        written, launches = [], []
        for r, res in enumerate(ranks):
            parts = [res[p] for p in ("init", "epoch_counts", "eval_counts")]
            written.append(sum(p["checkpoints"]["written"] for p in parts))
            total = {k: sum(p["launches"].get(k, 0) for p in parts)
                     for k in parts[0]["launches"]}
            launches.append(check_launches(
                f"recover dp {name} rank {r}", total,
                steps_run(res["records"]), 1, PER_STEP, PER_EVAL))
        if written[1:] != [0] * (DP_WORLD - 1) or written[0] < 1:
            raise AssertionError(f"recover dp {name}: checkpoint files "
                                 f"written per rank {written}")
        faults = [json.loads(ln)["kind"] for ln in sink.read_text().splitlines()
                  if '"event": "fault"' in ln]
        if faults != ([] if name == "full"
                      else ["injected_crash", "restart"] * 2):
            raise AssertionError(f"recover dp {name}: rank 0's run file "
                                 f"holds the faults {faults}")
        out[name] = {"ranks": ranks, "wall_s": wall, "written": written,
                     "launches": launches}
    for r in range(DP_WORLD):
        same_params(f"recover dp rank {r}", out["crash"]["ranks"][r]["params"],
                    out["full"]["ranks"][r]["params"])
    return {"card": smi, "world": DP_WORLD, "backend": "gloo",
            "crash_at": RECOVER_CRASH,
            "ckpt_crash_at": RECOVER_CKPT_CRASH, "bitwise": True,
            "written_per_rank": {k: v["written"] for k, v in out.items()},
            "wall_s": {"full": out["full"]["wall_s"],
                       "supervised": out["crash"]["wall_s"]},
            "launches_per_rank": {k: v["launches"] for k, v in out.items()},
            "note": DP_NOTE}


def phase_recover(torch, dev=None) -> None:
    """recover: crashed, preempted, corrupted and poisoned runs of the
    CNN, the LM and a world of 2, each held bit for bit to its
    uninterrupted run (RECOVER_* above), in a temporary checkpoint
    directory. One line each. (`dev` the CPU: the same, to rehearse the
    phase.)"""
    import tempfile

    dev = dev or torch.device("cuda", 0)
    smi = nvidia_smi() if dev.type == "cuda" else "cpu"
    with tempfile.TemporaryDirectory(prefix="recover-") as tmp:
        tmp = Path(tmp)
        emit({"phase": "recover", "part": "cnn",
              **phase_recover_cnn(torch, dev, smi, tmp / "cnn")})
        emit({"phase": "recover", "part": "lm",
              **phase_recover_lm(torch, dev, smi, tmp / "lm")})
        emit({"phase": "recover", "part": "dp",
              **phase_recover_dp(torch, dev, smi, tmp / "dp")})


def _np(tensors) -> list:
    return [t.detach().float().cpu().numpy() for t in tensors]


def flags_cfg(dev, **kw):
    """The train phase's configuration on the kernels, with `kw`."""
    from mpi_cuda_cnn_tpu_torch.utils.config import Config

    return Config(**{**dict(model="reference_cnn", epochs=1,
                            batch_size=CNN_BATCH, lr=0.1, seed=0,
                            device=str(dev), use_kernels=True, log_every=0,
                            eval_every=0), **kw})


def flags_trainer(dev, ds, metrics=None, **kw):
    from mpi_cuda_cnn_tpu_torch.models.presets import get_model
    from mpi_cuda_cnn_tpu_torch.train.trainer import Trainer
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    return Trainer(get_model("reference_cnn"), ds, flags_cfg(dev, **kw),
                   metrics=metrics or MetricsLogger(echo=False))


def counted(torch, dev, fn):
    """fn()'s result and the kernel launches it made (counts zeroed just
    before it and read just after it)."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    _kernels.reset_launches()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return out, dict(_kernels.launches)


def want_launches(what: str, got: dict, per: dict, times: int) -> None:
    """Every kernel launched per[name] * times (0 for the others)."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    for name in _kernels.KERNELS:
        if got.get(name, 0) != per.get(name, 0) * times:
            raise AssertionError(f"{what}: {name} launched {got.get(name, 0)}"
                                 f" times, want {per.get(name, 0)} x {times}")


def flags_epoch(torch, dev, what: str, tr, per_step: dict) -> dict:
    """One epoch and the eval: the launches (per_step a step; the eval
    3/2/0 a batch), at least FLAGS_MIN_CORRECT correct, finite metrics."""
    em, ep = counted(torch, dev, lambda: tr.run_epoch(0))
    (ntests, ncorrect), ev = counted(torch, dev, tr.evaluate)
    want_launches(f"{what} epoch", ep, per_step, em["steps"])
    want_launches(f"{what} eval", ev, PER_EVAL, EVAL_BATCHES)
    metrics = {k: em[k] for k in ("loss", "etotal", "acc")}
    if ncorrect < FLAGS_MIN_CORRECT or ntests != FLAGS_TESTS \
            or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"{what}: {ncorrect}/{ntests} correct (want >= "
                             f"{FLAGS_MIN_CORRECT}), metrics {metrics}")
    return {"steps": em["steps"], "epoch_s": em["seconds"],
            "step_ms": 1e3 * em["seconds"] / em["steps"], **metrics,
            "ntests": ntests, "ncorrect": ncorrect, "epoch_launches": ep,
            "eval_launches": ev}


def flags_grads_rel(what: str, got: list, want: list, limit: float) -> float:
    rel = grads_rel_l2(_np(got), _np(want))
    if not max(rel.values()) <= limit:
        raise AssertionError(f"{what}: first-step gradients apart by {rel} "
                             f"(limit {limit})")
    return max(rel.values())


def flags_cnn(torch, dev, ds) -> dict:
    """(a)-(c): grad-accum, remat and bf16 params."""
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.train.trainer import make_loss_fn

    out = {}
    plain = flags_trainer(dev, ds)
    g_plain = plain.first_grads()
    order = plain._epoch_order(0)[:CNN_BATCH]
    # (a)
    tr = flags_trainer(dev, ds, grad_accum=FLAGS_ACCUM)
    out["grad_accum"] = {
        "accum": FLAGS_ACCUM,
        "first_grad_rel_l2_max": flags_grads_rel(
            "(a) grad-accum", tr.first_grads(), g_plain, ACCUM_GRAD_REL_L2),
        "first_grad_rel_l2_tolerance": ACCUM_GRAD_REL_L2,
        **flags_epoch(torch, dev, "(a) grad-accum", tr, ACCUM_PER_STEP)}
    del tr
    # (b)
    tr = flags_trainer(dev, ds, remat=True)
    g = tr.first_grads()
    if not all(torch.equal(a, b) for a, b in zip(g, g_plain, strict=True)):
        raise AssertionError("(b) remat: first-step gradients differ from "
                             "the plain step's, want bit for bit")
    x, y = tr._host_batch(order)
    _, step = counted(torch, dev, lambda: tr.train_step(x, y))
    want_launches("(b) remat step", step, REMAT_PER_STEP, 1)
    out["remat"] = {"first_grads_bitwise": True, "step_launches": step}
    del tr
    # (c) bf16 params, bf16 compute: an epoch
    tr = flags_trainer(dev, ds, param_dtype="bfloat16",
                       compute_dtype="bfloat16")
    ep = flags_epoch(torch, dev, "(c) bf16 params", tr, PER_STEP)
    dtypes = {str(p.dtype) for p in tree_leaves(tr.params)}
    if dtypes != {"torch.bfloat16"}:
        raise AssertionError(f"(c) bf16 params: params {dtypes} after the "
                             "epoch")
    out["bf16_params"] = ep
    del tr
    # (c) bf16 params, float32 compute on the kernels: one step's
    # gradients against PyTorch's ops on the upcast weights
    tr = flags_trainer(dev, ds, param_dtype="bfloat16")
    g = tr.first_grads()
    names = [str(t.dtype).replace("torch.", "") for t in g]
    if names != MIXED_GRAD_DTYPES:
        raise AssertionError(f"(c) bf16 params, float32 compute: gradient "
                             f"dtypes {names}, want {MIXED_GRAD_DTYPES}")
    up = [{k: v.detach().float().requires_grad_(True) for k, v in p.items()}
          for p in tr.params]
    loss, _ = make_loss_fn(tr.model, backend="torch")(up, *tr._host_batch(
        order))
    ref = torch.autograd.grad(loss, tree_leaves(up))
    out["bf16_params_f32_compute"] = {
        "grad_dtypes": names,
        "first_grad_rel_l2_max": flags_grads_rel(
            "(c) bf16 params, float32 compute", g, ref,
            BF16_PARAMS_GRAD_REL_L2),
        "first_grad_rel_l2_tolerance": BF16_PARAMS_GRAD_REL_L2}
    return out


def flags_augment(torch, dev) -> dict:
    """(d): the batches the step computes on, against the draws applied
    on the host."""
    import numpy as np

    from mpi_cuda_cnn_tpu_torch.data.augment import make_augment, step_keys
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.data.pipeline import PIXEL_SCALE
    from mpi_cuda_cnn_tpu_torch.parallel import dp
    from mpi_cuda_cnn_tpu_torch.train.trainer import AUG_SEED_OFFSET

    ds = synthetic_stripes(num_train=FLAGS_AUG_STEPS * CNN_BATCH,
                           num_test=RECOVER_TEST)
    tr = flags_trainer(dev, ds, augment="shift")
    seen, grads = [], dp._grads

    def spy(loss_fn, params, x, y, view=None):
        seen.append(x.cpu().numpy())
        return grads(loss_fn, params, x, y, view)

    dp._grads = spy
    try:
        em, ep = counted(torch, dev, lambda: tr.run_epoch(0))
    finally:
        dp._grads = grads
    want_launches("(d) augment", ep, PER_STEP, FLAGS_AUG_STEPS)
    # The host's copy of each step's batch as the device normalized it
    # (a division by a scalar on the card multiplies by its reciprocal,
    # an ulp from numpy's quotient); then the numpy draws applied to it
    # by numpy indexing.
    order, pad = tr._epoch_order(0), make_augment("shift").pad
    for s in range(FLAGS_AUG_STEPS):
        idx = torch.from_numpy(order[s * CNN_BATCH:(s + 1) * CNN_BATCH]
                               ).to(dev)
        x = (tr._dev_images.index_select(0, idx).float()
             / PIXEL_SCALE).cpu().numpy()
        offsets, _ = make_augment("shift").draw(
            step_keys(AUG_SEED_OFFSET, [s], [0])[0, 0], CNN_BATCH)
        padded = np.pad(x, ((0, 0), (pad, pad), (pad, pad), (0, 0)))
        want = np.stack([padded[i, oy:oy + x.shape[1], ox:ox + x.shape[2]]
                         for i, (oy, ox) in enumerate(offsets)])
        if not np.array_equal(seen[s], want):
            raise AssertionError(f"(d) augment: step {s}'s batch is not the "
                                 "host's draws applied on the host")
    if not all(math.isfinite(em[k]) for k in ("loss", "etotal", "acc")):
        raise AssertionError(f"(d) augment: metrics {em}")
    return {"steps": em["steps"], "batches_bitwise": FLAGS_AUG_STEPS,
            "loss": em["loss"], "epoch_launches": ep}


def flags_elastic(torch, dev, tmp: Path) -> dict:
    """(e): world 1 (one NCCL rank) and world 2 (two gloo ranks on the
    card) bit for bit; a world-2 run preempted and resumed on world 1."""
    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        pick_backend,
        process_group,
        run_ranks,
    )
    from mpi_cuda_cnn_tpu_torch.parallel.mesh import make_mesh
    from mpi_cuda_cnn_tpu_torch.train.ranks import cnn_rank

    data = dict(num_train=FLAGS_ELASTIC_STEPS * CNN_BATCH,
                num_test=RECOVER_TEST)
    cfg = flags_cfg(dev, elastic_width=FLAGS_ELASTIC)
    ck = dict(checkpoint_dir=str(tmp / "ck"),
              checkpoint_every_steps=FLAGS_ELASTIC_CUT)

    def world_1(c, store: str):
        with process_group(pick_backend([dev]), 0, 1, str(tmp / store)):
            return cnn_rank(make_mesh(devices=[dev]), c, data)

    t0 = time.perf_counter()
    w1 = world_1(cfg, "store1")
    want_launches("(e) elastic world 1", w1["epoch_counts"]["launches"],
                  ELASTIC_PER_STEP, FLAGS_ELASTIC_STEPS)
    w2 = run_ranks(cnn_rank, 2, devices=[dev] * 2, args=(cfg, data),
                   timeout=DP_RANKS_TIMEOUT_S)
    for r, res in enumerate(w2):
        want_launches(f"(e) elastic world 2 rank {r}",
                      res["epoch_counts"]["launches"],
                      {k: v // 2 for k, v in ELASTIC_PER_STEP.items()},
                      FLAGS_ELASTIC_STEPS)
        same_params(f"(e) elastic world 2 rank {r}", res["params"],
                    w1["params"])
    cut = run_ranks(cnn_rank, 2, devices=[dev] * 2, args=(flags_cfg(
        dev, elastic_width=FLAGS_ELASTIC,
        fault_plan=f"preempt@train.step:{FLAGS_ELASTIC_CUT}", **ck), data),
        timeout=DP_RANKS_TIMEOUT_S)
    if [r["exit"] for r in cut] != [75, 75]:
        raise AssertionError(f"(e) elastic preempt: exits "
                             f"{[r['exit'] for r in cut]}, want 75 75")
    res = world_1(flags_cfg(dev, elastic_width=FLAGS_ELASTIC, resume=True,
                            **ck), "store2")
    same_params("(e) elastic resume on world 1", res["params"], w1["params"])
    return {"width": FLAGS_ELASTIC, "steps": FLAGS_ELASTIC_STEPS,
            "worlds_bitwise": [1, 2], "resume_world_2_to_1_bitwise": True,
            "cut_at": FLAGS_ELASTIC_CUT, "world_1_launches":
            w1["epoch_counts"]["launches"],
            "world_2_launches": [r["epoch_counts"]["launches"] for r in w2],
            "world_2_collectives": [r["epoch_counts"]["collectives"]
                                    for r in w2],
            "seconds": time.perf_counter() - t0}


def flags_lm(torch, dev, tmp: Path) -> dict:
    """(f): the LM's --grad-accum 2 and --elastic-width 4."""
    from mpi_cuda_cnn_tpu_torch.parallel.distributed import (
        pick_backend,
        process_group,
        run_ranks,
    )
    from mpi_cuda_cnn_tpu_torch.parallel.mesh import make_mesh
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.train.ranks import lm_rank
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    argv = LM_MODEL_ARGS + ["--attn-impl", "flash", "--steps",
                            str(FLAGS_LM_STEPS), "--warmup-steps", "1",
                            "--log-every", "1", "--device", str(dev)]
    out = {}
    plain = LMTrainer(parse_lm_args(argv), metrics=MetricsLogger(echo=False))
    g_plain = _np(plain.first_grads())
    res = plain.train()
    out["plain_step_ms"] = (1e3 * plain.cfg.batch_size * plain.cfg.seq_len
                            / res.tokens_per_s)
    del plain
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    acc = LMTrainer(parse_lm_args(argv + ["--grad-accum",
                                          str(FLAGS_LM_ACCUM)]),
                    metrics=MetricsLogger(echo=False))
    rel = grads_rel_l2(_np(acc.first_grads()), g_plain)
    if not max(rel.values()) <= ACCUM_GRAD_REL_L2:
        raise AssertionError(f"(f) lm grad-accum: first-step gradients "
                             f"apart by {max(rel.values())}")
    res, counts = counted(torch, dev, acc.train)
    want_launches("(f) lm grad-accum", {k: counts[k] - LM_PER_EVAL[k]
                                        for k in FLASH_KERNELS},
                  {k: v * FLAGS_LM_ACCUM for k, v in LM_PER_STEP.items()},
                  FLAGS_LM_STEPS)
    out["grad_accum"] = {
        "accum": FLAGS_LM_ACCUM, "first_grad_rel_l2_max": max(rel.values()),
        "first_grad_rel_l2_tolerance": ACCUM_GRAD_REL_L2, "launches": counts,
        "step_ms": 1e3 * acc.cfg.batch_size * acc.cfg.seq_len
        / res.tokens_per_s}
    del acc
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    cfg = parse_lm_args(argv + ["--elastic-width", str(FLAGS_LM_ELASTIC)])
    with process_group(pick_backend([dev]), 0, 1, str(tmp / "lmstore")):
        w1 = lm_rank(make_mesh(devices=[dev]), cfg)
    per = {k: v * FLAGS_LM_ELASTIC for k, v in LM_PER_STEP.items()}
    want_launches("(f) lm elastic world 1",
                  {k: w1["counts"]["launches"][k] - LM_PER_EVAL[k]
                   for k in FLASH_KERNELS}, per, FLAGS_LM_STEPS)
    torch.cuda.empty_cache() if dev.type == "cuda" else None
    w2 = run_ranks(lm_rank, 2, devices=[dev] * 2, args=(cfg,),
                   timeout=DP_RANKS_TIMEOUT_S)
    for r, res in enumerate(w2):
        if (res["losses"], res["eval_loss"]) != (w1["losses"],
                                                 w1["eval_loss"]):
            raise AssertionError(f"(f) lm elastic world 2 rank {r}: losses "
                                 f"{res['losses']} eval {res['eval_loss']}, "
                                 f"world 1 {w1['losses']} eval "
                                 f"{w1['eval_loss']}: want bit for bit")
    out["elastic"] = {"width": FLAGS_LM_ELASTIC, "steps": FLAGS_LM_STEPS,
                      "losses": w1["losses"], "worlds_bitwise": [1, 2],
                      "world_1_launches": w1["counts"]["launches"],
                      "steps_and_eval_s": w1["seconds"]}
    return out


def flags_sink(torch, dev, ds, tmp: Path) -> dict:
    """(g): the JSONL file and the profiler trace of FLAGS_TIME_STEPS
    steps, then the full epoch without and with the sink."""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    path, prof = tmp / "run.jsonl", tmp / "prof"
    small = synthetic_stripes(num_train=FLAGS_TIME_STEPS * CNN_BATCH,
                              num_test=RECOVER_TEST)
    with MetricsLogger(path, echo=False) as m:
        flags_trainer(dev, small, metrics=m, log_every=10,
                      metrics_jsonl=str(path), profile_dir=str(prof)).train()
    recs = load_records(path, strict=True)
    keep(path, "train_g.jsonl")
    peaks = [e["stats"] and e["stats"]["peak_bytes_in_use"]
             for r in recs if r["event"] == "memory" for e in r["devices"]]
    trace = prof / "trace.json"
    if not peaks or not trace.exists() or (
            dev.type == "cuda" and not all(p and p > 0 for p in peaks)):
        raise AssertionError(f"(g) sink: memory peaks {peaks}, trace "
                             f"{trace.exists()}")
    times = {}
    for sink in (None, tmp / "epoch.jsonl"):
        with MetricsLogger(sink, echo=False) as m:
            tr = flags_trainer(dev, ds, metrics=m, log_every=100,
                               metrics_jsonl=sink and str(sink))
            tr.run_epoch(0)
            times["with_sink" if sink else "without_sink"] = \
                tr.run_epoch(1)["seconds"]
    return {"records": len(recs), "events": sorted({r["event"]
                                                    for r in recs}),
            "memory_peak_bytes": peaks[-1],
            "trace_bytes": trace.stat().st_size,
            "epoch_s": times}


def flags_times(torch, dev) -> dict:
    """ms a step of each path, device-resident, FLAGS_TIME_STEPS steps
    after a warm-up epoch of as many, all in this call."""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes

    ds = synthetic_stripes(num_train=FLAGS_TIME_STEPS * CNN_BATCH,
                           num_test=RECOVER_TEST)
    paths = {"plain": {}, "grad_accum_4": dict(grad_accum=FLAGS_ACCUM),
             "remat": dict(remat=True),
             "bf16_params_bf16_compute": dict(param_dtype="bfloat16",
                                              compute_dtype="bfloat16"),
             "bf16_params_f32_compute": dict(param_dtype="bfloat16"),
             "augment_shift": dict(augment="shift"),
             "elastic_8": dict(elastic_width=FLAGS_ELASTIC)}
    out = {}
    for name, kw in paths.items():
        tr = flags_trainer(dev, ds, **kw)
        tr.run_epoch(0)
        em = tr.run_epoch(1)
        out[name] = 1e3 * em["seconds"] / em["steps"]
    return out


def phase_train_flags(torch, dev=None) -> dict:
    """train_flags (FLAGS_* above): (a)-(g), then the step times. (`dev`
    the CPU: the same on gloo ranks, to rehearse the phase.)"""
    import tempfile

    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes

    dev = dev or torch.device("cuda", 0)
    t0 = time.perf_counter()
    ds = synthetic_stripes(num_train=FLAGS_TRAIN, num_test=FLAGS_TESTS)
    out = flags_cnn(torch, dev, ds)
    out["augment"] = flags_augment(torch, dev)
    with tempfile.TemporaryDirectory(prefix="flags-") as tmp:
        tmp = Path(tmp)
        out["elastic"] = flags_elastic(torch, dev, tmp)
        out["lm"] = flags_lm(torch, dev, tmp)
        out["sink"] = flags_sink(torch, dev, ds, tmp)
    out["step_ms"] = flags_times(torch, dev)
    out["seconds"] = time.perf_counter() - t0
    out["nvidia_smi"] = nvidia_smi() if dev.type == "cuda" else "cpu"
    return out


def obs_tool(argv: list[str]) -> tuple[int, str]:
    """(exit code, stdout) of `python -m mpi_cuda_cnn_tpu_torch <argv>`,
    run in this process."""
    import contextlib
    import io

    from mpi_cuda_cnn_tpu_torch.cli import main as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli(argv)
    return rc, out.getvalue()


def program_of(path: Path) -> dict:
    """The run file's one `program` record."""
    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records

    progs = [r for r in load_records(path, strict=True)
             if r["event"] == "program"]
    if len(progs) != 1:
        raise AssertionError(f"obs_tools: {path.name}: {len(progs)} program "
                             "records, want 1")
    return progs[0]


def report_of(path: Path) -> dict:
    """`report --format json` of the file's last run."""
    rc, out = obs_tool(["report", str(path), "--format", "json"])
    if rc != 0 or not out.strip():
        raise AssertionError(f"obs_tools: report {path.name} exited {rc}")
    return json.loads(out.strip().splitlines()[-1])


def cnn_plain_flops(torch, tmp: Path, dtype: str) -> float:
    """The CNN step's FLOPs as the same config counts them on the CPU's
    plain path (two steps of stripes, the first counted)."""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    path = tmp / f"cpu_{dtype}.jsonl"
    tiny = synthetic_stripes(num_train=2 * CNN_BATCH, num_test=64)
    with MetricsLogger(path, echo=False) as m:
        flags_trainer(torch.device("cpu"), tiny, metrics=m,
                      compute_dtype=dtype, metrics_jsonl=str(path)).train()
    prog = program_of(path)
    if prog["backend"] != "cpu":
        raise AssertionError(f"obs_tools: CPU count on {prog['backend']}")
    return prog["flops"]


def lm_meta_flops(torch, cfg, vocab: int) -> tuple[float, float]:
    """The LM step of `cfg` counted on the meta device (the plain path,
    flash attention's plain versions): (flops, bytes)."""
    from mpi_cuda_cnn_tpu_torch.models.transformer import TransformerLM
    from mpi_cuda_cnn_tpu_torch.obs.cost import count_step
    from mpi_cuda_cnn_tpu_torch.train.lm import (
        make_lm_state,
        make_lm_train_step,
    )
    from mpi_cuda_cnn_tpu_torch.train.optimizer import make_optimizer
    from mpi_cuda_cnn_tpu_torch.utils.config import COMPUTE_DTYPES

    model = TransformerLM(vocab=vocab, dim=cfg.dim, heads=cfg.heads,
                          depth=cfg.depth, max_seq=cfg.seq_len,
                          moe_experts=cfg.moe_experts,
                          moe_top_k=cfg.moe_top_k, kv_heads=cfg.kv_heads,
                          pos=cfg.pos)
    opt = make_optimizer(cfg.lr)
    state = make_lm_state(model, opt, device="meta")
    step = make_lm_train_step(model, opt, attn_impl=cfg.attn_impl,
                              seq_len=cfg.seq_len, device="meta",
                              compute_dtype=COMPUTE_DTYPES[cfg.compute_dtype],
                              remat=cfg.remat, ce_chunk=cfg.ce_chunk)
    tokens = torch.zeros(cfg.batch_size, cfg.seq_len, dtype=torch.long,
                         device="meta")
    with count_step() as count:
        step(state, tokens, tokens)
    return count.flops, count.bytes


def obs_serve_compare(torch, dev, tmp: Path) -> tuple[dict, Path]:
    """serve-bench OBS_SERVE_ARGS on the card and on the CPU, then
    `compare` of the two under a gate of OBS_GATE_KEYS at 0%, equal."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.bench import serve_bench

    card, cpu = tmp / "serve_card.jsonl", tmp / "serve_cpu.jsonl"
    _kernels.reset_launches()
    serve_bench(OBS_SERVE_ARGS + ["--device", dev.type, "--metrics-jsonl",
                                  str(card)])
    cuda_sync(torch, dev)
    launches = {k: _kernels.launches[k]
                for k in ("paged_attention", "int8_gemm")}
    serve_bench(OBS_SERVE_ARGS + ["--device", "cpu", "--metrics-jsonl",
                                  str(cpu)])
    gated = [f"serve.{mode}.{key}" for mode in ("static", "continuous")
             for key in OBS_GATE_KEYS]
    gate = tmp / "gate.json"
    gate.write_text(json.dumps({"metrics": {
        name: {"tol_pct": 0, "direction": "equal"} for name in gated}}))
    rc, out = obs_tool(["compare", str(cpu), str(card), "--gate",
                        str(gate)])
    verdicts = {}
    for line in out.splitlines():
        cells = [c.strip() for c in line.strip("|").split("|")]
        if cells and cells[0] in gated:
            verdicts[cells[0]] = cells[-1]
    if rc != 0 or sorted(verdicts) != sorted(gated) or any(
            v != "ok" for v in verdicts.values()):
        raise AssertionError(f"obs_tools: compare of the card's serve run "
                             f"with the CPU's exited {rc}: {verdicts}")
    return {"gated": len(gated), "verdicts": sorted(set(verdicts.values())),
            "launches": launches}, card


def phase_obs_tools(torch, dev=None) -> dict:
    """obs_tools (phase 14): the run-file tools over the card's run files,
    and the card's `program` counts against the plain path's. (`dev` the
    CPU, with the earlier phases' files in KEEP: a rehearsal.)"""
    from mpi_cuda_cnn_tpu_torch.data.datasets import synthetic_stripes
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.obs.cost import peak_flops
    from mpi_cuda_cnn_tpu_torch.train.lm import lm_flops_per_token
    from mpi_cuda_cnn_tpu_torch.train.lm_trainer import LMTrainer
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args
    from mpi_cuda_cnn_tpu_torch.utils.logging import MetricsLogger

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    tmp = KEEP
    # train_flags (g)'s run (under the profiler), then float32 and bf16
    # runs of as many steps without it, and the lm run
    runs = {"train_g": tmp / "train_g.jsonl",
            "train_float32": tmp / "train_float32.jsonl",
            "train_bfloat16": tmp / "train_bfloat16.jsonl",
            "lm": tmp / "lm.jsonl"}
    launches = {}
    small = synthetic_stripes(num_train=FLAGS_TIME_STEPS * CNN_BATCH,
                              num_test=RECOVER_TEST)
    for dtype in ("float32", "bfloat16"):
        path = runs[f"train_{dtype}"]
        _kernels.reset_launches()
        with MetricsLogger(path, echo=False) as m:
            flags_trainer(dev, small, metrics=m, log_every=10,
                          compute_dtype=dtype,
                          metrics_jsonl=str(path)).train()
        cuda_sync(torch, dev)
        launches[f"train_{dtype}"] = {k: _kernels.launches[k]
                                      for k in PER_STEP}
    # the lm run at the flagship
    cfg = parse_lm_args(LM_MODEL_ARGS + [
        "--attn-impl", "flash", "--steps", str(FLAGS_LM_STEPS),
        "--warmup-steps", "1", "--log-every", "1", "--device", str(dev),
        "--metrics-jsonl", str(runs["lm"])])
    _kernels.reset_launches()
    with MetricsLogger(runs["lm"], echo=False) as m:
        trainer = LMTrainer(cfg, metrics=m)
        trainer.train()
    cuda_sync(torch, dev)
    launches["lm"] = {k: _kernels.launches[k] for k in FLASH_KERNELS}
    model = trainer.model
    del trainer
    empty_cache(torch, dev)
    for name, got in launches.items():
        if dev.type == "cuda" and not all(n > 0 for n in got.values()):
            raise AssertionError(f"obs_tools {name}: launches {got}")
    # the program records against the plain path's counts
    programs = {}
    plain = {"train_float32": cnn_plain_flops(torch, tmp, "float32"),
             "train_bfloat16": cnn_plain_flops(torch, tmp, "bfloat16")}
    plain["train_g"] = plain["train_float32"]
    plain["lm"], lm_meta_bytes = lm_meta_flops(torch, cfg, model.vocab)
    for name, path in runs.items():
        prog, rep = program_of(path), report_of(path)
        (row,) = rep["programs"]
        mfu_known = isinstance(row["mfu"], float) or dev.type != "cuda"
        if prog["backend"] != dev.type or prog["flops"] != plain[name] or \
                not mfu_known:
            raise AssertionError(
                f"obs_tools {name}: program {prog['label']} on "
                f"{prog['backend']}, flops {prog['flops']} (plain path "
                f"{plain[name]}), report mfu {row['mfu']}")
        step_ms = sum(rep["step_phases"]["per_step_ms"].values())
        programs[name] = {
            "label": prog["label"], "counting": prog["counting"],
            "compute_dtype": prog["compute_dtype"],
            "flops": prog["flops"], "plain_flops": plain[name],
            "bytes": prog["bytes"], "collectives": prog["collectives"],
            "step_ms": step_ms, "mfu": row["mfu"]}
    tokens = cfg.batch_size * cfg.seq_len
    analytic = lm_flops_per_token(model, cfg.seq_len) * tokens
    lm = programs["lm"]
    peak = peak_flops(lm["compute_dtype"], backend="cuda")
    lm.update({"meta_bytes": lm_meta_bytes, "analytic_flops": analytic,
               "flops_over_analytic": lm["flops"] / analytic,
               "analytic_mfu": (analytic / (lm["step_ms"] / 1e3) / peak
                                if dev.type == "cuda" else None)})
    # the tools over the serve and fleet files
    files = {"serve_slo": tmp / "serve_slo.jsonl",
             "fleet_crash": tmp / "fleet.jsonl"}
    exits = {}
    for name, path in files.items():
        for tool in ("explain", "trace", "replay"):
            rc, out = obs_tool([tool, str(path)])
            exits[f"{tool} {name}"] = rc
            if rc != 0 or not out:
                raise AssertionError(f"obs_tools: {tool} {path.name} "
                                     f"exited {rc}")
    rc, out = obs_tool(["health", str(files["serve_slo"]), "--slo",
                        str(tmp / "serve_slo.json"), "--format", "json"])
    health = json.loads(out)
    if rc not in (0, 1) or not health["verdicts"]:
        raise AssertionError(f"obs_tools: health exited {rc}: {health}")
    serve, card = obs_serve_compare(torch, dev, tmp)
    for tool in ("explain", "trace", "replay"):
        rc, out = obs_tool([tool, str(card)])
        exits[f"{tool} serve_card"] = rc
        if rc != 0 or not out:
            raise AssertionError(f"obs_tools: {tool} serve_card exited {rc}")
    phase_s = time.perf_counter() - t_phase
    if phase_s > OBS_TOOLS_BUDGET_S:
        raise AssertionError(f"obs_tools took {phase_s:.1f} s, over its "
                             f"{OBS_TOOLS_BUDGET_S} s budget")
    return {"programs": programs, "launches": launches, "exits": exits,
            "health": {"healthy": health["healthy"],
                       "verdicts": len(health["verdicts"]),
                       "alerts_fired": health["alerts_fired"]},
            "serve_compare": serve, "phase_s": phase_s,
            "nvidia_smi": nvidia_smi() if dev.type == "cuda" else "cpu"}


def abi_cnn(torch, dev, tmp: Path) -> dict:
    """(a) of tools_search: runtime_abi's CNN trainer from the reference's
    config JSON (its device and backend names: "tpu", "use_pallas"), one
    epoch, evaluate and save; a fresh init, load and evaluate again. The
    restored params equal the trained ones bit for bit and the second
    eval the first; K3/K4/K5 launch the epoch's steps x PER_STEP and each
    eval's batches x PER_EVAL, and nothing else launches."""
    from mpi_cuda_cnn_tpu_torch import runtime_abi
    from mpi_cuda_cnn_tpu_torch.data.datasets import (
        synthetic_stripes,
        write_synthetic_idx,
    )
    from mpi_cuda_cnn_tpu_torch.models.layers import tree_leaves
    from mpi_cuda_cnn_tpu_torch.ops import _kernels

    paths = write_synthetic_idx(tmp / "idx", synthetic_stripes(
        num_train=ABI_TRAIN, num_test=ABI_TEST))
    cfg = json.dumps({
        "dataset": "idx", **{k: str(v) for k, v in paths.items()},
        "model": "reference_cnn", "epochs": 1, "lr": 0.1,
        "batch_size": CNN_BATCH, "seed": 0, "use_pallas": True,
        "device": "tpu" if dev.type == "cuda" else "jax-cpu",
        "log_every": 1000000000})
    _kernels.reset_launches()
    t0 = time.perf_counter()
    init = json.loads(runtime_abi.init(cfg))
    epoch = json.loads(runtime_abi.train_epoch())
    first = json.loads(runtime_abi.evaluate())
    saved = json.loads(runtime_abi.save(str(tmp / "abi_ckpt")))
    trainer = runtime_abi._trainer()
    trained = [t.detach().clone() for t in tree_leaves(trainer.params)]
    eval_batches = math.ceil(ABI_TEST / trainer._eval_batch)
    runtime_abi.init(cfg)                # a fresh trainer: the seeded init
    restored = json.loads(runtime_abi.load(str(tmp / "abi_ckpt")))
    trainer = runtime_abi._trainer()
    same = all(torch.equal(a, b)
               for a, b in zip(trained, tree_leaves(trainer.params)))
    second = json.loads(runtime_abi.evaluate())
    cuda_sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    steps = epoch["steps"]
    want = {k: (PER_STEP.get(k, 0) * steps
                + 2 * eval_batches * PER_EVAL.get(k, 0)
                if dev.type == "cuda" else 0) for k in _kernels.KERNELS}
    on_device = {t.device.type for t in tree_leaves(trainer.params)}
    if (launches != want or steps != ABI_TRAIN // CNN_BATCH or not same
            or first != second or init["n_params"] != 360_810
            or on_device != {dev.type} or trainer.backend != "cuda"
            or not math.isfinite(epoch["loss"])
            or first["ncorrect"] < (1 - ACCURACY_MARGIN) * ABI_TEST):
        raise AssertionError(
            f"tools_search abi cnn: launches {launches} (want {want}), "
            f"{steps} steps, params restored {same}, evals {first} / "
            f"{second}, init {init}, params on {on_device}, epoch {epoch}")
    del trained
    return {"init": init, "epoch": epoch, "eval": first, "saved": saved,
            "restored": restored, "eval_after_load": second,
            "eval_batches": eval_batches, "launches": {
                k: launches[k] for k in PER_STEP}, "wall_s": wall_s}


def abi_lm(torch, dev) -> dict:
    """(b) of tools_search: runtime_abi's LM at the flagship (LM_MODEL_ARGS
    as the reference's LMConfig JSON, device "tpu"), ABI_LM_STEPS flash
    steps and the eval: K7/K8/K9 launch LM_PER_STEP a step and
    LM_PER_EVAL in the eval."""
    import dataclasses

    from mpi_cuda_cnn_tpu_torch import runtime_abi
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.utils.config import parse_lm_args

    cfg = dataclasses.asdict(parse_lm_args(LM_MODEL_ARGS + [
        "--attn-impl", "flash", "--steps", str(ABI_LM_STEPS),
        "--warmup-steps", "1", "--log-every", "0"]))
    cfg["device"] = "tpu" if dev.type == "cuda" else "jax-cpu"
    _kernels.reset_launches()
    t0 = time.perf_counter()
    init = json.loads(runtime_abi.lm_init(json.dumps(cfg)))
    trainer = runtime_abi._STATE["lm"]
    res = json.loads(runtime_abi.lm_train())
    cuda_sync(torch, dev)
    wall_s = time.perf_counter() - t0
    launches = dict(_kernels.launches)
    want = {k: (LM_PER_STEP.get(k, 0) * ABI_LM_STEPS + LM_PER_EVAL.get(k, 0)
                if dev.type == "cuda" else 0) for k in _kernels.KERNELS}
    if (launches != want or res["steps_run"] != ABI_LM_STEPS
            or (dev.type == "cuda" and trainer.attn_impl != "flash")
            or trainer.device.type != dev.type
            or not all(math.isfinite(res[k])
                       for k in ("final_loss", "eval_loss"))):
        raise AssertionError(
            f"tools_search abi lm: launches {launches} (want {want}), "
            f"{trainer.attn_impl} on {trainer.device}, result {res}")
    return {"init": init, "result": res, "wall_s": wall_s,
            "launches": {k: launches[k] for k in FLASH_KERNELS}}


def autosize_fleet(torch, tmp: Path) -> dict:
    """(c) of tools_search: `autosize` twice (byte-equal stdout and
    records, `compare` under ci/autosize_gate.json exits 0), then its
    frontier record through `fleet-bench --compute engine --autoscale on
    --autoscale-frontier` at FLEET_ARGS on one replica: the autoscaler
    holds the frontier's per-chip rate, every request finishes with
    exactly its budget of tokens, and K1/K2 launch depth and 5 depth + 1
    times each forward of every engine incarnation."""
    from mpi_cuda_cnn_tpu_torch.ops import _kernels
    from mpi_cuda_cnn_tpu_torch.serve.autoscale import load_frontier
    from mpi_cuda_cnn_tpu_torch.serve.bench import SERVE_KERNELS, fleet_bench

    runs = [tmp / "autosize_a.jsonl", tmp / "autosize_b.jsonl"]
    outs = [obs_tool(["autosize", *AUTOSIZE_ARGS, "--metrics-jsonl",
                      str(p)]) for p in runs]
    gate, _ = obs_tool(["compare", *map(str, runs), "--gate",
                        str(HERE / "ci" / "autosize_gate.json")])
    if (outs[0] != outs[1] or outs[0][0] != 0 or gate != 0
            or runs[0].read_bytes() != runs[1].read_bytes()):
        raise AssertionError(f"tools_search autosize: exits "
                             f"{[o[0] for o in outs]}, gate {gate}")
    per_chip = load_frontier(runs[0])
    recommendation = next(line for line in outs[0][1].splitlines()
                          if line.startswith("recommendation: "))
    _kernels.reset_launches()
    t0 = time.perf_counter()
    out = fleet_bench(FLEET_ARGS + ["--replicas", "1", "--autoscale", "on",
                                    "--autoscale-frontier", str(runs[0])])
    wall_s = time.perf_counter() - t0
    launches = {k: _kernels.launches[k] for k in SERVE_KERNELS}
    line, res, args = out["lines"][0], out["result"], out["args"]
    model, engines = out["model"], [c.engine for c in out["computes"]]
    if line["statuses"] != {"finished": args.requests}:
        raise AssertionError(f"tools_search fleet: statuses "
                             f"{line['statuses']}")
    for r in res.requests:
        if len(r.out) != r.max_new_tokens:
            raise AssertionError(f"tools_search fleet: request {r.rid} "
                                 f"holds {len(r.out)} tokens, budget "
                                 f"{r.max_new_tokens}")
    fw = line["forwards"]
    forwards = fw["decode_ticks"] + fw["prefill_chunks"]
    want = {"paged_attention": model.depth * forwards,
            "int8_gemm": (5 * model.depth + 1) * forwards}
    if engines[0].device.type != "cuda":
        want = {k: 0 for k in want}
    if (launches != want or line["kernel_launches"] != want
            or out["fleet"].autoscaler.per_chip_rps != per_chip):
        raise AssertionError(
            f"tools_search fleet: launches {launches} (line "
            f"{line['kernel_launches']}), want {want} ({forwards} forwards "
            f"over {fw['replicas']} incarnations); autoscaler per chip "
            f"{out['fleet'].autoscaler.per_chip_rps}, frontier {per_chip}")
    return {"autosize": recommendation, "frontier_per_chip_rps": per_chip,
            "fleet": {"wall_s": wall_s, "fleet_ticks": line["fleet_ticks"],
                      "forwards": fw, "kernel_launches": launches,
                      **{k: line[k] for k in (
                          "replicas", "scale_ups", "scale_downs",
                          "scale_crc", "joins", "output_tokens",
                          "trace_crc", "state_crc")}},
            "launches": launches}


def chaos_search(tmp: Path) -> dict:
    """(d) of tools_search: `chaos` twice (no violation, byte-equal
    records, `compare` under ci/chaos_gate.json exits 0), then the
    planted fence-revoke bug found (exit 1) and shrunk to at most two
    faults."""
    from mpi_cuda_cnn_tpu_torch.faults import parse_plan
    from mpi_cuda_cnn_tpu_torch.obs.schema import load_records

    runs = [tmp / "chaos_a.jsonl", tmp / "chaos_b.jsonl"]
    outs = [obs_tool(["chaos", *CHAOS_ARGS, "--metrics-jsonl", str(p)])
            for p in runs]
    gate, _ = obs_tool(["compare", *map(str, runs), "--gate",
                        str(HERE / "ci" / "chaos_gate.json")])
    summary = load_records(runs[0])[-1]
    if (outs[0] != outs[1] or outs[0][0] != 0 or gate != 0
            or runs[0].read_bytes() != runs[1].read_bytes()
            or summary["violations"] != 0):
        raise AssertionError(f"tools_search chaos: exits "
                             f"{[o[0] for o in outs]}, gate {gate}, "
                             f"summary {summary}")
    planted = tmp / "chaos_plant.jsonl"
    rc, out = obs_tool(["chaos", *CHAOS_PLANT_ARGS, "--metrics-jsonl",
                        str(planted)])
    plant = load_records(planted)[-1]
    if rc != 1 or not 1 <= len(parse_plan(plant["min_plan"])) <= 2:
        raise AssertionError(f"tools_search chaos plant: exit {rc}, "
                             f"summary {plant}")
    return {"episodes": summary["episodes"],
            "episodes_crc": summary["episodes_crc"],
            "plant": {k: plant[k] for k in ("failed_episode", "min_plan",
                                            "shrink_probes")},
            "repro": next(line for line in out.splitlines()
                          if line.startswith("repro: "))}


def phase_tools_search(torch, dev=None) -> dict:
    """tools_search (phase 15): runtime_abi's two trainers on the card
    (`abi_cnn`, `abi_lm`), the capacity search and its frontier through
    an autoscaled engine fleet (`autosize_fleet`), the fault search
    (`chaos_search`), and `lint` of the port under its manifest and empty
    baseline (exit 0, no finding). (`dev` the CPU: a rehearsal, with
    FLEET_ARGS and LM_MODEL_ARGS small and --device cpu in FLEET_ARGS.)
    Returns the phase's record and the launches per kernel of its
    paths."""
    from mpi_cuda_cnn_tpu_torch import runtime_abi

    t_phase = time.perf_counter()
    dev = dev or torch.device("cuda", 0)
    with tempfile.TemporaryDirectory(prefix="tools-") as name:
        tmp = Path(name)
        cnn = abi_cnn(torch, dev, tmp)
        lm = abi_lm(torch, dev)
        runtime_abi._STATE.clear()
        empty_cache(torch, dev)
        fleet = autosize_fleet(torch, tmp)
        chaos = chaos_search(tmp)
    rc, out = obs_tool(["lint", "--manifest",
                        str(HERE / "ci" / "torch_lint_manifest.json"),
                        "--baseline",
                        str(HERE / "ci" / "torch_lint_baseline.json"),
                        "--format", "json"])
    lint = json.loads(out)
    if rc != 0 or lint["findings"]:
        raise AssertionError(f"tools_search lint: exit {rc}, findings "
                             f"{lint['findings']}")
    phase_s = time.perf_counter() - t_phase
    if phase_s > TOOLS_SEARCH_BUDGET_S:
        raise AssertionError(f"tools_search took {phase_s:.1f} s, over its "
                             f"{TOOLS_SEARCH_BUDGET_S} s budget")
    return {"record": {"abi_cnn": cnn, "abi_lm": lm,
                       "autosize": {k: fleet[k] for k in (
                           "autosize", "frontier_per_chip_rps", "fleet")},
                       "chaos": chaos, "lint": {"exit": rc,
                                                "rules": lint["rules"]},
                       "phase_s": phase_s},
            "launches": {**cnn["launches"], **lm["launches"],
                         **fleet["launches"]}}


def kernels_line(cases: list[dict], launches: dict) -> dict:
    """The per-kernel record: launches from each kernel's own paths (serve
    and generate for K1/K2, train for K3/K4/K5, conv_bench for K6, lm and
    lm_moe for K7/K8/K9),
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
        r = next(c for c in mine if rep(c) and not c.get("per_rank")
                 and not c.get("micro") and not c.get("generate")
                 and not c.get("features") and not c.get("head_dims"))
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
                                        "Hkv", "D", "W", "C", "O") if k in r},
            **(head_dims_fields(mine) if name in FLASH_KERNELS else {})})
    return {"kernels": summary}


def head_dims_fields(mine: list[dict]) -> dict:
    """A flash kernel's head dims held against its plain version, and its
    times at the flagship's geometry (B 8, S 2048, 8 heads, causal) at
    each head dim timed there, both types (the flagship's D 64 too)."""
    timed = {}
    for c in mine:
        if (c["B"], c["S"], c["H"], c["Hkv"], c["causal"]) == (8, 2048, 8, 8,
                                                               True):
            timed.setdefault(f"{c['dtype']} D{c['D']}", {
                k: c[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "library_fwd_bwd_ms",
                                  "library_bwd_ms", "max_abs_err")})
    return {"head_dims_held": sorted({c["D"] for c in mine}),
            "flagship_geometry": timed}


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
    global KEEP
    kept = tempfile.TemporaryDirectory(prefix="runs-")
    KEEP = Path(kept.name)
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "name": kind, "nvidia_smi": smi,
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    built = _kernels.build_all()
    report = {name: [ln.strip() for ln in log.splitlines()
                     if "registers" in ln or "spill" in ln]
              for name, log in built["logs"].items()}
    # cuobjdump once per library, all at once (each is a process).
    with ThreadPoolExecutor() as pool:
        names = sorted(_kernels.KERNELS)
        hmma_by_fn = dict(zip(names, pool.map(
            lambda name: sass_hmma_by_function(_kernels, name), names)))
    hmma = {name: sum(fns.values()) for name, fns in hmma_by_fn.items()}
    spills = {lib: {fn: n for fn, n in spill_stores(built["logs"][lib]).items()
                    if frag in fn}
              for lib, frag in NO_SPILL}
    fwd_log = built["logs"]["flash_fwd"]
    fwd_f32 = {fn: {"registers": n, "spill_stores": spill_stores(fwd_log)[fn]}
               for fn, n in registers(fwd_log).items()
               if "flash_fwd_f32_kernel" in fn}
    flash = {lib: {fn: {"registers": n,
                        "spill_stores": spill_stores(built["logs"][lib])[fn]}
                   for fn, n in registers(built["logs"][lib]).items()}
             for lib in FLASH_KERNELS}
    emit({"phase": "build", "seconds": round(built["seconds"], 3),
          "kernels": sorted(_kernels.KERNELS), "hmma": hmma,
          "spill_stores": spills, "flash_fwd_f32": fwd_f32,
          "flash_instances": flash, "ptxas": report})
    for name in TENSOR_CORE_KERNELS:
        if not hmma[name] > 0:
            raise AssertionError(f"build: no HMMA instruction in {name}'s "
                                 f"library: it does not use the tensor cores")
    hmma_fns = {}
    for lib, frag in TENSOR_CORE_FUNCTIONS:
        fns = {fn: n for fn, n in hmma_by_fn[lib].items() if frag in fn}
        hmma_fns.update(fns)
        if len(fns) != len(FLASH_HEAD_DIMS) or not all(
                n > 0 for n in fns.values()):
            raise AssertionError(f"build: {frag} in {lib}: HMMA per instance "
                                 f"{fns or 'no such function'}; want every "
                                 f"head dim {FLASH_HEAD_DIMS} on the tensor "
                                 "cores")
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
    del out
    features = phase_serve_features(torch)
    emit({"phase": "serve_features", "device": kind, "nvidia_smi": smi,
          **features["record"]})
    fleet = phase_fleet(torch)
    emit({"phase": "fleet", "device": kind, "nvidia_smi": smi,
          **fleet["record"]})
    train_launches = phase_train(torch)
    emit({"phase": "train_agree", **phase_train_agree(torch)})
    phase_dp(torch)
    cnn_mesh = phase_cnn_mesh(torch)
    emit({"phase": "cnn_mesh_summary", "device": kind, "nvidia_smi": smi,
          **cnn_mesh["record"]})
    emit({"phase": "lm_dp", **phase_lm_dp(torch)})
    lm_sp = phase_lm_sp(torch)
    emit({"phase": "lm_sp", "device": kind, "nvidia_smi": smi,
          **lm_sp["record"]})
    lm_mesh = phase_lm_mesh(torch)
    emit({"phase": "lm_mesh_summary", "device": kind, "nvidia_smi": smi,
          **lm_mesh["record"]})
    emit({"phase": "train_bf16", **phase_train_bf16(torch)})
    conv_launches = phase_conv_bench(torch)
    lm_launches, lm_trainer = phase_lm(torch)
    head_dim_launches = phase_lm_head_dims(torch)
    moe_launches, moe_trainer = phase_lm_moe(torch)
    gen_launches = phase_generate(torch, lm_trainer, moe_trainer)
    del lm_trainer, moe_trainer
    torch.cuda.empty_cache()
    phase_lm_bench(torch)
    phase_lm_profile(torch)
    emit({"phase": "lm_agree", **phase_lm_agree(torch)})
    phase_recover(torch)
    emit({"phase": "train_flags", **phase_train_flags(torch)})
    emit({"phase": "obs_tools", **phase_obs_tools(torch)})
    kept.cleanup()
    tools = phase_tools_search(torch)
    emit({"phase": "tools_search", "device": kind, "nvidia_smi": smi,
          **tools["record"]})
    launches = {**{k: serve_launches[k] + gen_launches[k]
                   + features["launches"][k] + fleet["launches"][k]
                   + tools["launches"][k]
                   for k in ("paged_attention", "int8_gemm")},
                **{k: train_launches[k] + cnn_mesh["launches"][k]
                   + tools["launches"][k] for k in PER_STEP},
                "conv_gemm": conv_launches["conv_gemm"],
                **{k: lm_launches[k] + head_dim_launches[k] + moe_launches[k]
                   + lm_sp["launches"][k] + lm_mesh["launches"][k]
                   + tools["launches"][k] for k in FLASH_KERNELS}}
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
