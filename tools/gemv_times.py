#!/usr/bin/env python3
"""Device times of the int8 weight matmul K2 (`int8_gemv`) at the serving
engine's ten products, for the checkout it is run from: it imports that
checkout's `chip_smoke.py` and port, so it times another commit's kernel
when run from an unpacked copy of it.

The products are those of `chip_smoke.py`'s serve phase (d 512, 8 layers,
8 query / 2 KV heads, vocab 8192): wq 512 -> 512, wkv 512 -> 256, wo 512
-> 512 (the same shape as wq), w1 512 -> 2048, w2 2048 -> 512 and the
head 512 -> 8192, at N 8 (a decode tick's slots) and N 32 (a prefill
chunk). First, the time of an empty launch (an in-place add on 4 floats),
the floor under every time here. Then per product the kernel, its plain
version (dequantize, then one `@`) and the one PyTorch call for the same
function (`torch._weight_int8pack_mm`, the weight laid out [dout, din]
outside the timed call), each `chip_smoke.median_ms` (median of 30
launches, CUDA events, one weight reused, so from a warm L2), with the
kernel's largest error against the plain version. Last, per N, a decode
forward's 41 products (8 x (wq, wkv, wo, w1, w2) + the head) over 41
distinct weights, in the forward's order, timed as one sequence (median
of 30): about 25 MB of weights streamed as serving streams them, beside
the sum of the isolated times of the same 41 and the kernels' own device
time per forward under torch.profiler (20 forwards), the figure
`chip_smoke.py`'s serve_profile reads. One line per measurement, tagged.

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/gemv_times.py $t)
    done

Needs a CUDA device; it builds that checkout's K2 on first use.
"""

from __future__ import annotations

import os
import sys

DIM, DEPTH, VOCAB, HEADS, KV_HEADS = 512, 8, 8192, 8, 2
KV = 2 * DIM * KV_HEADS // HEADS
LAYER = {"wq": (DIM, DIM), "wkv": (DIM, KV), "wo": (DIM, DIM),
         "w1": (DIM, 4 * DIM), "w2": (4 * DIM, DIM)}
HEAD = (DIM, VOCAB)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops.gemv import (
        int8_gemv,
        int8_gemv_plain,
        quantize_weight,
    )

    if not torch.cuda.is_available():
        print("gemv_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    z = torch.zeros(4, device=dev)
    print(f"{tag} empty_launch ms {cs.median_ms(torch, lambda: z.add_(0)):.4f}",
          flush=True)

    def weight(din, dout):
        return quantize_weight((torch.randn(din, dout, generator=gen)
                                / din ** 0.5).to(dev))

    shapes = [LAYER[k] for k in ("wq", "wkv", "w1", "w2")] + [HEAD]
    iso = {}
    for n in (8, 32):
        for din, dout in shapes:
            w = weight(din, dout)
            x = torch.randn(n, din, generator=gen).to(dev)
            want = int8_gemv_plain(x, w)
            err = (int8_gemv(x, w) - want).abs().max().item()
            wt, sc = w.q.t().contiguous(), w.s.reshape(-1).contiguous()
            ms = cs.median_ms(torch, lambda: int8_gemv(x, w))
            plain = cs.median_ms(torch, lambda: int8_gemv_plain(x, w))
            lib = cs.median_ms(
                torch, lambda: torch._weight_int8pack_mm(x, wt, sc))
            iso[n, din, dout] = ms
            print(f"{tag} int8_gemm N {n} {din}x{dout} ms {ms:.4f} plain_ms "
                  f"{plain:.4f} library_ms {lib:.4f} max_abs_err {err:.3e} "
                  f"rel {err / want.abs().max().item():.3e}", flush=True)
    order = [LAYER[k] for _ in range(DEPTH)
             for k in ("wq", "wkv", "wo", "w1", "w2")] + [HEAD]
    weights = [weight(din, dout) for din, dout in order]
    for n in (8, 32):
        xs = {din: torch.randn(n, din, generator=gen).to(dev)
              for din in {d for d, _ in order}}

        def forward():
            for w in weights:
                int8_gemv(xs[w.q.shape[0]], w)

        seq = cs.median_ms(torch, forward)
        summed = sum(iso[n, din, dout] for din, dout in order)
        prof = cs.profile_device(torch, forward, 20, groups={
            "int8_gemm": ("int8_gemm_kernel",)})["group_ms_per_step"]
        print(f"{tag} int8_gemm_forward N {n} products {len(order)} "
              f"sequence_ms {seq:.4f} isolated_sum_ms {summed:.4f} "
              f"profiled_kernel_ms {prof['int8_gemm']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
