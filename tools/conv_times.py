#!/usr/bin/env python3
"""Device times of the implicit-GEMM conv K6 (`conv_gemm`) at conv-bench's
four stride-1 rows, and of the conv weight gradient K5 (`conv_dw`) at
reference_cnn's two convs (batch 32, k3 s2 p1) and at the same four rows
(batch 128, k3 s1 p1), in float32 and bf16, for the checkout it is run
from: it imports that checkout's `chip_smoke.py` and port, so it times
another commit's kernels when run from an unpacked copy of it. Each time
is `chip_smoke.median_ms` (median of 30 launches, CUDA events). One line
per kernel, type and shape, tagged.

To compare two commits on one card, in one call, alternating:

    git archive <parent> | tar -x -C build/parent   # and the change in build/change
    for t in parent change change parent; do
      (cd build/$t && python3 ../../tools/conv_times.py $t)
    done

Needs a CUDA device; it builds the two kernels of that checkout on first
use.
"""

from __future__ import annotations

import os
import sys

# conv-bench's stride-1 rows (n, h, w, cin, cout), k3 s1 p1
BENCH_ROWS = [(128, 32, 32, 3, 64), (128, 32, 32, 64, 64),
              (128, 16, 16, 64, 128), (128, 8, 8, 128, 256)]
# K5: (n, h, w, cin, cout, stride), k3 p1
DW_ROWS = ([(32, 28, 28, 1, 16, 2), (32, 14, 14, 16, 32, 2)]
           + [(*r, 1) for r in BENCH_ROWS])


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    import chip_smoke as cs
    from mpi_cuda_cnn_tpu_torch._device import disable_tf32
    from mpi_cuda_cnn_tpu_torch.ops import kernel_ops as ko

    if not torch.cuda.is_available():
        print("conv_times: no CUDA device", file=sys.stderr)
        return 1
    disable_tf32()
    tag = sys.argv[1] if len(sys.argv) > 1 else os.path.basename(os.getcwd())
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        for n, h, w, c, o in BENCH_ROWS:
            x = torch.randn(n, h, w, c, generator=gen).to(dev).to(dtype)
            wt = (torch.randn(3, 3, c, o, generator=gen)
                  / (9 * c) ** 0.5).to(dev).to(dtype)
            ms = cs.median_ms(torch, lambda: ko.conv_gemm(x, wt, padding=1))
            print(f"{tag} conv_gemm {name} {n}x{h}x{w}x{c}->{o} ms {ms:.4f}",
                  flush=True)
        for n, h, w, c, o, s in DW_ROWS:
            oh, ow = (h - 1) // s + 1, (w - 1) // s + 1
            x = torch.rand(n, h, w, c, generator=gen).to(dev).to(dtype)
            g = torch.randn(n, oh, ow, o, generator=gen).to(dev).to(dtype)
            ms = cs.median_ms(torch, lambda: ko.conv_dw(
                x, g, stride=s, padding=1, kh=3, kw=3))
            print(f"{tag} conv_dw {name} {n}x{h}x{w}x{c}->{o} s{s} ms {ms:.4f}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
