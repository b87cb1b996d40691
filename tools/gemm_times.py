#!/usr/bin/env python3
"""Device times of the GEMM K3 (`gemm`) at reference_cnn's twelve
products, the batch-32 training step's nine (fc 1568 -> 200 -> 200 -> 10:
forward x @ W + b, input gradient g @ W^T, weight gradient x^T @ g) and
the eval batch's three forwards (M = 2,048), in float32 and bf16, for the
checkout it is run from: it imports that checkout's `chip_smoke.py` and
port, so it times another commit's kernel when run from an unpacked copy
of it. Beside each, the time of the one PyTorch call for the same product
(`torch.addmm` / `torch.mm`, TF32 off). First, the time of an empty
launch (an in-place add on 4 floats), the floor under every time here.
Each time is `chip_smoke.median_ms` (median of 30 launches, CUDA events).
One line per type and product, tagged.

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/gemm_times.py $t)
    done

Needs a CUDA device; it builds that checkout's GEMM on first use.
"""

from __future__ import annotations

import os
import sys

FC = [(1568, 200), (200, 200), (200, 10)]
BATCH, EVAL_BATCH = 32, 2048
ROLES = ("forward", "input_grad", "weight_grad", "eval_forward")


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import kernel_ops as ko

    if not torch.cuda.is_available():
        print("gemm_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    z = torch.zeros(4, device=dev)
    print(f"{tag} empty_launch ms {cs.median_ms(torch, lambda: z.add_(0)):.4f}",
          flush=True)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"

        def randn(*s):
            return torch.randn(*s, generator=gen).to(dev).to(dtype)

        for role in ROLES:
            for d_in, d_out in FC:
                rows = EVAL_BATCH if role == "eval_forward" else BATCH
                x, w, b = randn(rows, d_in), randn(d_in, d_out), randn(d_out)
                g = randn(rows, d_out)
                if role in ("forward", "eval_forward"):
                    run = lambda: ko.gemm(x, w, bias=b)  # noqa: E731
                    lib = lambda: torch.addmm(b, x, w)  # noqa: E731
                    mnk = (rows, d_out, d_in)
                elif role == "input_grad":
                    run = lambda: ko.gemm(g, w, trans_b=True)  # noqa: E731
                    lib = lambda: torch.mm(g, w.t())  # noqa: E731
                    mnk = (rows, d_in, d_out)
                else:
                    run = lambda: ko.gemm(x, g, trans_a=True)  # noqa: E731
                    lib = lambda: torch.mm(x.t(), g)  # noqa: E731
                    mnk = (d_in, d_out, rows)
                ms = cs.median_ms(torch, run)
                lib_ms = cs.median_ms(torch, lib)
                print(f"{tag} gemm {name} {role} {mnk[0]}x{mnk[1]}x{mnk[2]} "
                      f"ms {ms:.4f} library_ms {lib_ms:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
